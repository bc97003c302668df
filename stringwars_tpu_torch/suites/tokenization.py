"""Tokenization suite: whitespace/newline splits, TR29 segmentation, UAX#14
line breaks and UTF-8 machinery (reference ``tokenization/bench.rs``;
defaults: the whole file as one token, 3 s warm-up + 20 s measure, 128 MB
of ``synthetic:multilingual``).

The port of ``stringwars_tpu.suites.tokenization`` for one device, with its
variant names. Every device row (``swtorch::...<1gpu>``) processes the whole
corpus per call through ``ops/segment.py`` or ``ops/utf8.py``, on the tape as
staged once on the device, and is forced by one ``.item()`` of its count;
``--device cpu`` runs the same rows (``<1cpu>``) on the plain versions. The
TPU's salt-and-roll protocol is not ported: a local card runs every launch.
The segmentation rule maps are pruned to the corpus' codepoint ceiling
(``_cp_ceiling``), as in the JAX suite.

The host rows ``regex-WORD`` and ``regex-\\X`` need the ``regex`` module,
imported inside the row: where it is missing they print the usual SKIPPED
line. The ``tokenize-bpe`` group comes with the BPE slice.

``main`` returns the suite's context; ``ctx.staged`` holds the corpus on the
device (``data``, ``n``, ``max_cp``) and ``counts``, the count each device
row's last call gave.
"""

from __future__ import annotations

from typing import Callable

import torch

from stringwars_tpu_torch.ops import segment as SEG
from stringwars_tpu_torch.ops import utf8 as U8
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.utils.harness import WorkUnits


def _cp_ceiling(max_byte: int) -> int:
    """Corpus codepoint ceiling from the max BYTE (UTF-8 lead ranges): the
    static hint that prunes the segmentation class tables."""
    if max_byte < 0x80:
        return 0x7F
    if max_byte < 0xE0:
        return 0x7FF
    if max_byte < 0xF0:
        return 0xFFFF
    return 0x10FFFF


def device_rows(data: torch.Tensor, n: int, max_cp: int) -> dict[str, Callable[[], torch.Tensor]]:
    """Device row name (without its scope) -> a call that returns the row's
    count as a 0-d tensor on the device."""
    last = max(int(U8.utf8_count(data, n)) - 1, 0)

    def second(fn):
        return lambda: fn(data, n, max_cp=max_cp)[1]

    return {
        "tokenize-whitespace/swtorch::split": lambda: SEG.whitespace_token_count(data, n, max_cp=max_cp),
        "tokenize-newlines/swtorch::split": lambda: SEG.newline_split_count(data, n, max_cp=max_cp),
        "tokenize-words-tr29/swtorch::words": second(SEG.word_boundaries),
        "tokenize-graphemes-tr29/swtorch::graphemes": second(SEG.grapheme_boundaries),
        "tokenize-sentences-tr29/swtorch::sentences": second(SEG.sentence_boundaries),
        "tokenize-lines-uax14/swtorch::linebreaks": second(SEG.linebreak_opportunities),
        "utf8-length/swtorch::count_utf8": lambda: U8.utf8_count(data, n),
        "utf8-iterate/swtorch::decode_utf32": lambda: U8.utf8_decode(data, n)[1],
        "find-nth-utf8/swtorch::find_nth": lambda: U8.utf8_find_nth(data, n, last),
    }


def _regex_word_boundaries():
    import regex

    return lambda text: sum(1 for _ in regex.finditer(r"\b", text, flags=regex.V1 | regex.WORD))


def _regex_graphemes():
    import regex

    return lambda text: len(regex.findall(r"\X", text))


def main(argv: list[str] | None = None) -> SuiteContext:
    ctx = setup_suite(
        "Segmentation + UTF-8 machinery throughput",
        default_tokens="file",
        default_warmup=3.0,
        default_time=20.0,
        default_synthetic="multilingual",
        argv=argv,
    )
    n = ctx.tape.total_bytes
    data = ctx.tape.data[:n]
    max_cp = _cp_ceiling(int(data.max()) if n else 0)
    counts: dict[str, int] = {}
    ctx.staged = {"data": data, "n": n, "max_cp": max_cp, "counts": counts}
    rows = device_rows(data, n, max_cp)
    host: dict[str, object] = {}

    def host_text() -> str:
        if "text" not in host:
            host["bytes"] = data.cpu().numpy().tobytes()
            host["text"] = host["bytes"].decode("utf-8", "ignore")
        return host["text"]

    def device_row(name: str) -> None:
        call = rows[name]
        for scope in ctx.scopes:
            full = f"{name}{scope.name}"

            def routine(full=full) -> WorkUnits:
                counts[full] = int(call().item())
                return WorkUnits(1, n)

            ctx.run(full, "bytes", lambda routine=routine: routine, device=scope.device)

    def host_row(name: str, make) -> None:
        def factory():
            fn = make()
            text = host_text()
            return lambda: (fn(text), WorkUnits(1, n))[1]

        ctx.run(name, "bytes", factory)

    ctx.group("tokenize-whitespace")
    device_row("tokenize-whitespace/swtorch::split")
    host_row("tokenize-whitespace/str.split", lambda: lambda t: len(t.split()))

    ctx.group("tokenize-newlines")
    device_row("tokenize-newlines/swtorch::split")
    host_row("tokenize-newlines/str.splitlines", lambda: lambda t: len(t.splitlines()))

    ctx.group("tokenize-words-tr29")
    device_row("tokenize-words-tr29/swtorch::words")
    host_row("tokenize-words-tr29/regex-WORD", _regex_word_boundaries)

    ctx.group("tokenize-graphemes-tr29")
    device_row("tokenize-graphemes-tr29/swtorch::graphemes")
    host_row("tokenize-graphemes-tr29/regex-\\X", _regex_graphemes)

    ctx.group("tokenize-sentences-tr29")
    device_row("tokenize-sentences-tr29/swtorch::sentences")

    ctx.group("tokenize-lines-uax14")
    device_row("tokenize-lines-uax14/swtorch::linebreaks")

    ctx.group("utf8-length")
    device_row("utf8-length/swtorch::count_utf8")
    host_row("utf8-length/bytes.decode-len", lambda: lambda t: len(host["bytes"].decode("utf-8", "ignore")))

    ctx.group("utf8-iterate")
    device_row("utf8-iterate/swtorch::decode_utf32")

    ctx.group("find-nth-utf8")
    device_row("find-nth-utf8/swtorch::find_nth")
    return ctx


if __name__ == "__main__":
    main()
