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
line.

The ``tokenize-bpe`` group has the JAX group's shape: GPT-2's pre-split
(``unicode/pretokenize.py``, stdlib ``re``: no ``regex`` needed) of the first
4 Mi characters, the pretokens of 1 to 32 bytes, the first 400,000; 512
merges trained on the first 30,000 of them; the batch sorted by length as a
uint8 matrix as wide as the longest. ``swtorch::bpe_encode`` encodes the
whole batch per call (``ops/bpe.py``: the CUDA kernel on a card), forced by
one ``.item()`` of the counts' sum; ``python-bpe`` runs the sequential
oracle over the 2,000 shortest. The group is staged at the first of its rows
that runs; its staging seconds go to stderr.

``main`` returns the suite's context; ``ctx.staged`` holds the corpus on the
device (``data``, ``n``, ``max_cp``), ``counts``, the count each device
row's last call gave, and ``bpe``: the group's batch (``pretokens``, sorted
by length, ``merges``, ``table``, ``data`` and ``lengths`` on the device,
``seconds`` of its staging) and the ``ids`` and ``counts`` of its device
row's last call.
"""

from __future__ import annotations

import sys
import time
from typing import Callable

import numpy as np
import torch

from stringwars_tpu_torch.ops import bpe as BPE
from stringwars_tpu_torch.ops import segment as SEG
from stringwars_tpu_torch.ops import utf8 as U8
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.unicode.pretokenize import gpt2_pretokens
from stringwars_tpu_torch.utils.harness import WorkUnits

# The tokenize-bpe group's shape (the JAX suite's).
BPE_CHARS = 4 << 20  # characters pre-split
BPE_MAX_BYTES = 32  # pretokens kept: 1 to 32 bytes
BPE_ROWS = 400_000  # the first this many kept
BPE_TRAIN = 30_000  # merges trained on the first this many
BPE_MERGES = 512
BPE_SAMPLE = 2_000  # the python-bpe row's pretokens


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


def bpe_rows(text: str, limit: int) -> tuple[list[bytes], list[bytes]]:
    """GPT-2's pretokens of ``text`` in UTF-8, kept where they have 1 to 32
    bytes, the first ``limit``: ``(kept, by_length)``, in text order and
    sorted by length (stable). ``ops.bpe.pack_rows(by_length)`` is the
    group's batch."""
    encoded = list(map(str.encode, gpt2_pretokens(text)))
    sizes = np.fromiter(map(len, encoded), np.int64, len(encoded))
    keep = np.flatnonzero((sizes > 0) & (sizes <= BPE_MAX_BYTES))[:limit]
    return [encoded[i] for i in keep.tolist()], [encoded[i] for i in keep[np.argsort(sizes[keep], kind="stable")].tolist()]


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
    bpe: dict[str, object] = {}
    ctx.staged = {"data": data, "n": n, "max_cp": max_cp, "counts": counts, "bpe": bpe}
    rows = device_rows(data, n, max_cp)
    host: dict[str, object] = {}

    def host_text() -> str:
        if "text" not in host:
            host["bytes"] = data.cpu().numpy().tobytes()
            host["text"] = host["bytes"].decode("utf-8", "ignore")
        return host["text"]

    def device_row(name: str) -> None:
        call, scope = rows[name], ctx.scopes[0]
        full = f"{name}{scope.name}"

        def routine() -> WorkUnits:
            counts[full] = int(call().item())
            return WorkUnits(1, n)

        ctx.run(full, "bytes", lambda: routine, scope=scope)

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

    # Byte-level BPE over GPT-2's pre-split (BASELINE.json configs 1 & 5:
    # "regex-pre-split byte-level tokenization with replicated merge/vocab
    # tables").
    ctx.group("tokenize-bpe")

    def bpe_staged() -> dict[str, object]:
        if not bpe:
            started = time.perf_counter()
            text = host_text()[:BPE_CHARS]
            kept, by_length = bpe_rows(text, BPE_ROWS)
            split = time.perf_counter()
            merges = BPE.train_merges(kept[:BPE_TRAIN], BPE_MERGES)
            trained = time.perf_counter()
            rows, lengths = BPE.pack_rows(by_length)
            bpe.update(
                pretokens=by_length, merges=merges, table=BPE.MergeTable.from_merges(merges),
                data=torch.from_numpy(rows), lengths=torch.from_numpy(lengths),
                seconds={"pre-split": split - started, "train": trained - split},
            )
            print(f"# tokenize-bpe: {len(kept):,} pretokens ({int(lengths.sum()):,} B, width {rows.shape[1]}) from "
                  f"{len(text):,} characters, pre-split in {split - started:.3f} s; {len(merges)} merges trained in "
                  f"{trained - split:.3f} s", file=sys.stderr, flush=True)
        return bpe

    scope = ctx.scopes[0]
    def bpe_device(device=scope.device):
        staged = bpe_staged()
        table = staged["table"]
        rows, lengths = staged["data"].to(device), staged["lengths"].to(device)
        staged.update(data=rows, lengths=lengths)
        units = WorkUnits(rows.shape[0], int(lengths.sum()))

        def routine() -> WorkUnits:
            ids, out_counts = BPE.bpe_encode_fused(rows, lengths, table)
            int(out_counts.sum().item())
            staged.update(ids=ids, counts=out_counts)
            return units

        return routine

    ctx.run(f"tokenize-bpe/swtorch::bpe_encode{scope.name}", "bytes", bpe_device, scope=scope)

    def bpe_host():
        staged = bpe_staged()
        sample, merges = staged["pretokens"][:BPE_SAMPLE], staged["merges"]
        units = WorkUnits(len(sample), sum(map(len, sample)))

        def routine() -> WorkUnits:
            for token in sample:
                BPE.bpe_encode_ref(token, merges)
            return units

        return routine

    ctx.run("tokenize-bpe/python-bpe", "bytes", bpe_host)
    return ctx


if __name__ == "__main__":
    main()
