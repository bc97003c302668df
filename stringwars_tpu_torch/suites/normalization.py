"""Normalization suite: case fold, NFC/NFD/NFKC/NFKD, case-insensitive
compare and find (reference ``normalization/bench.rs``; defaults: the whole
file as one token, 3 s warm-up + 20 s measure, 128 MB of
``synthetic:multilingual``).

The port of ``stringwars_tpu.suites.normalization`` for one device, with its
variant names. Device rows (``swtorch::...<1gpu>``):

- ``case-fold/swtorch::utf8_fold``: ``expand.fold_tokens_fused`` over the
  corpus cut into 32-byte rows (``stream_rows``), pruned to the corpus'
  exact codepoint ceiling; ``swtorch::ascii_fold`` on ASCII corpora only;
- ``normalize-{nfc,nfd,nfkc,nfkd}/swtorch::utf8_norm``: the quick check
  (``rows_nfc_verbatim`` for NFC/NFKC, ``rows_inert`` for NFD/NFKD) over the
  corpus in ``QUICK_WIDTH``-byte rows, then ``ops/normalize.normalize_rows``
  over the codepoints of the rows that fail it, in rows of 64 and a bucket
  of wider rows (``FormStage``). The JAX suite cuts its rows at character
  boundaries, so a row kept verbatim can end before a mark that the next
  row normalizes alone (F13); here every row ends before a safe codepoint
  where the width allows, and ``assemble`` gives ``unicodedata.normalize``
  of the whole corpus. Each form's route and staging seconds go to stderr;
- ``case-insensitive-compare/swtorch::uncased_eq``: ``uncased_equal_batch``
  over the first 1,000 pairs of adjacent non-empty lines;
- ``case-insensitive-find/swtorch::uncased_find``: one of 100 seeded needles
  per call, cycling through all of them as the host row does (the JAX row
  counts one needle, XORed with its salt), over the haystack folded once:
  ``find_count`` over the folded bytes where the folded haystack and the
  needle are ASCII, else ``cp_window_count`` over the folded codepoints.

``--device cpu`` runs the same rows (``<1cpu>``) on the plain versions. The
TPU's salt-and-roll protocol is not ported: a local card runs every launch.
The staging seconds go to stderr.

``main`` returns the suite's context; ``ctx.staged`` holds ``n`` (the
corpus bytes), ``rows`` (the 32-byte ``PaddedTokens``), ``max_cp``, ``fold``
(the last fold call's output and counts), ``normalize`` (``lead`` and
``cps``, the corpus decoded at each byte, and ``forms``: per form its
``stage`` and ``out``, the last call's quick check and outputs), ``pairs``,
``compare_rows`` (their two sides as ``PaddedTokens``), ``equal`` (the last
compare call's booleans), ``haystack`` (the folded codepoints), ``needles``
(their folded codepoints) and ``needle_counts`` (the device count of each
needle, from one pass over all of them before the row is timed).
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
import unicodedata

import numpy as np
import torch

from stringwars_tpu_torch.ops import casefold as CF
from stringwars_tpu_torch.ops import expand as EX
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.ops import normalize as NORM
from stringwars_tpu_torch.ops.utf8 import _codepoints_at
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.tape import PaddedTokens, Tape, _pad_spans
from stringwars_tpu_torch.utils.harness import WorkUnits


def stream_row_starts(data: torch.Tensor, width: int, safe: torch.Tensor | None = None) -> torch.Tensor:
    """Row starts (int64, on the data's device) that cut a UTF-8 byte stream
    into rows of at most ``width`` bytes, never inside a multibyte character:
    a row ends at the last lead byte within ``width`` of its start, or, where
    there is none (a continuation run longer than the width), after ``width``
    bytes (the JAX package's chain of starts, ``ops/normalize.row_starts``).
    With ``safe`` (a bool per byte), a row ends before the last safe lead
    within the width where there is one."""
    lead = (data & 0xC0) != 0x80
    if safe is None:
        return NORM.row_starts(lead, width)
    return NORM.row_starts(lead & safe, width, fallback=lead)


def stream_rows(data_np, width: int = 1024, *, device=None, safe: torch.Tensor | None = None) -> PaddedTokens:
    """The UTF-8 byte stream (a numpy array, or a uint8 tensor) as ``[rows,
    width]`` ``PaddedTokens`` whose rows never split a multibyte character
    (the rows of ``stream_row_starts``), built on ``device`` by one scatter
    of the bytes; ``width`` a multiple of 4, as every ``PaddedTokens`` width
    is."""
    if width % 4:
        raise ValueError(f"the row width must be a multiple of 4, got {width}")
    if isinstance(data_np, torch.Tensor):
        data = data_np.to(device)
    else:
        data = torch.from_numpy(np.array(data_np, dtype=np.uint8)).to(device)
    starts = stream_row_starts(data, width, safe)
    lengths = torch.diff(starts, append=torch.tensor([data.numel()], device=data.device))
    return _pad_spans(data, starts, lengths, width=width, align=4)


def corpus_max_cp(text: str) -> int:
    """``max(map(ord, text))``, 0x7F for an empty text."""
    if not text:
        return 0x7F
    return int(np.frombuffer(text.encode("utf-32-le"), np.uint32).max())


def first_lines(text: str, count: int) -> list[bytes]:
    """``[ln.encode() for ln in text.split("\\n") if ln][:count]``, without
    splitting the whole text."""
    lines, pos = [], 0
    while len(lines) < count and pos <= len(text):
        end = text.find("\n", pos)
        end = len(text) if end < 0 else end
        if end > pos:
            lines.append(text[pos:end].encode())
        pos = end + 1
    return lines


def suite_needles(text: str) -> list[bytes]:
    """The 100 needles of the JAX suite: seeded draws (``default_rng(42)``)
    among the whitespace-separated words of at least 3 bytes."""
    rng = np.random.default_rng(42)
    words = [w for w in text.split() if len(w) >= 3 or len(w.encode()) >= 3]
    return [words[i].encode() for i in rng.integers(0, max(len(words), 1), 100)] if words else []


QUICK_WIDTH = 1024  # bytes a quick-check row holds (the JAX suite's stream_rows)


@dataclasses.dataclass(frozen=True)
class FormStage:
    """One form's staging over the corpus: the quick-check rows (``QUICK_WIDTH``
    bytes, cut before safe codepoints where the width allows), the quick
    check's verdict on each, and the codepoints of the rows that fail it as
    rows cut before safe codepoints (``ops/normalize.segment_rows``; a new
    row at each run of failing rows), with the byte offset of every such
    codepoint in the corpus."""

    form: str
    quick: PaddedTokens
    fast: torch.Tensor  # bool[quick rows]
    buckets: list  # ops/normalize.CodepointRows
    slow_offsets: torch.Tensor  # int64[slow codepoints]
    max_cp: int  # the corpus' codepoint ceiling (the quick check's tables)
    slow_max: int  # the slow codepoints' ceiling (the decomposition's tables)

    @property
    def slow_codepoints(self) -> int:
        return int(self.slow_offsets.numel())

    def routes(self) -> str:
        compat = NORM.is_compat(self.form)
        return " + ".join(f"{b.count:,} rows of {b.width} ({NORM.decompose_route(compat, self.slow_max, b.width)})"
                          for b in self.buckets) or "no slow rows"


def corpus_codepoints(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(is_lead, codepoint decoded at each byte) of UTF-8 bytes, on their
    device (junk at continuation bytes)."""
    b = data.to(torch.int32)
    return (b & 0xC0) != 0x80, _codepoints_at(b, b.numel())


def quick_rows(data: torch.Tensor, compat: bool, lead: torch.Tensor, cps: torch.Tensor) -> PaddedTokens:
    """The corpus as ``QUICK_WIDTH``-byte rows, each ending before the last
    safe codepoint within the width (before the last character where none
    is safe): a row kept verbatim then never meets a neighbour it would
    compose or reorder with."""
    safe = lead & NORM.safe_on(compat, data.device)[cps.to(torch.int64).clamp(0, NORM.tables.MAX_CP - 1)]
    return stream_rows(data, QUICK_WIDTH, device=data.device, safe=safe)


def quick_check(form: str, rows: PaddedTokens, max_cp: int) -> torch.Tensor:
    """bool per row: verbatim its own ``form`` (``rows_nfc_verbatim`` for
    NFC/NFKC, ``rows_inert`` for NFD/NFKD)."""
    check = NORM.rows_nfc_verbatim if form in ("NFC", "NFKC") else NORM.rows_inert
    return check(rows.data, rows.lengths, NORM.is_compat(form), max_cp)


def stage_form(form: str, quick: PaddedTokens, lead: torch.Tensor, cps: torch.Tensor, max_cp: int) -> FormStage:
    """Route the quick-check rows of ``form`` and stage the slow codepoints."""
    fast = quick_check(form, quick, max_cp)
    n = lead.numel()
    byte_slow = torch.repeat_interleave(~fast, quick.lengths.to(torch.int64), output_size=n)
    slow_offsets = torch.nonzero(lead & byte_slow).squeeze(1)
    slow = cps[slow_offsets]
    # A run of slow rows begins after a fast row, at a safe codepoint: cut there.
    forced = (slow_offsets == 0) | ~byte_slow[(slow_offsets - 1).clamp(min=0)]
    buckets = NORM.segment_rows(slow, NORM.is_compat(form), forced)
    slow_max = int(slow.max()) if slow.numel() else 0x7F
    return FormStage(form, quick, fast, buckets, slow_offsets, max_cp, slow_max)


def normalize_call(stage: FormStage) -> tuple[torch.Tensor, list]:
    """One call of a ``normalize-*`` row: the quick check over every
    quick-check row, then the form's row pipeline over the slow rows.
    Returns (the quick check's verdicts, each bucket's (out, counts))."""
    quick = quick_check(stage.form, stage.quick, stage.max_cp)
    outs = [NORM.normalize_rows(b.rows, b.lengths, stage.form, stage.slow_max) for b in stage.buckets]
    return quick, outs


def assemble(stage: FormStage, outputs: list, lead: torch.Tensor, cps: torch.Tensor) -> torch.Tensor:
    """The corpus' normalized codepoints (int32, on the device): the fast
    rows' codepoints as they are and the slow rows' outputs, in corpus order."""
    fast_bytes = torch.repeat_interleave(stage.fast, stage.quick.lengths.to(torch.int64), output_size=lead.numel())
    keep = lead & fast_bytes
    slow_values, slow_keys = NORM.gather_outputs(stage.buckets, outputs)
    values = torch.cat([cps[keep].to(torch.int32), slow_values.to(cps.device)])
    keys = torch.cat([torch.nonzero(keep).squeeze(1), stage.slow_offsets[slow_keys.to(cps.device)]])
    return values[torch.sort(keys, stable=True).indices]


def main(argv: list[str] | None = None) -> SuiteContext:
    ctx = setup_suite(
        "Unicode case folding + caseless compare and search throughput",
        default_tokens="file",
        default_warmup=3.0,
        default_time=20.0,
        default_synthetic="multilingual",
        argv=argv,
    )
    dev = ctx.device
    n = ctx.tape.total_bytes
    data = ctx.tape.data[:n]
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    started = time.perf_counter()
    data_np = data.cpu().numpy()
    host_text = data_np.tobytes().decode("utf-8", "ignore")
    decoded = time.perf_counter()
    max_cp = corpus_max_cp(host_text)
    ceiling = time.perf_counter()
    fold_rows = stream_rows(data_np, 32, device=dev)
    sync()
    cut = time.perf_counter()
    log(f"staged {n:,} B: host decode {decoded - started:.2f} s, codepoint ceiling {max_cp:#x} in "
        f"{ceiling - decoded:.2f} s, {fold_rows.count:,} rows of 32 B in {cut - ceiling:.2f} s")
    staged: dict = {"rows": fold_rows, "max_cp": max_cp, "n": n}
    ctx.staged = staged

    ctx.group("case-fold")
    is_ascii = n == 0 or int(data_np.max(initial=0)) < 0x80
    scope = ctx.scopes[0]

    def fold_call() -> WorkUnits:
        staged["fold"] = EX.fold_tokens_fused(fold_rows, max_cp)
        return WorkUnits(1, n)

    ctx.run(f"case-fold/swtorch::utf8_fold{scope.name}", "bytes", lambda: fold_call, scope=scope)
    if is_ascii:  # the reference's kernels specialize ASCII runs the same way
        ascii_rows = stream_rows(data_np, device=dev)

        def ascii_call() -> WorkUnits:
            staged["ascii_fold"] = CF.fold_tokens_ascii(ascii_rows)
            return WorkUnits(1, n)

        ctx.run(f"case-fold/swtorch::ascii_fold{scope.name}", "bytes", lambda: ascii_call, scope=scope)
    ctx.run("case-fold/str.casefold", "bytes", lambda: lambda: (host_text.casefold(), WorkUnits(1, n))[1])

    lead, cps = corpus_codepoints(data)
    quick_by_compat: dict = {}
    forms: dict = {}
    staged["normalize"] = {"lead": lead, "cps": cps, "forms": forms}
    for form in NORM.FORMS:
        started = time.perf_counter()
        compat = NORM.is_compat(form)
        if compat not in quick_by_compat:
            quick_by_compat[compat] = quick_rows(data, compat, lead, cps)
        stage = stage_form(form, quick_by_compat[compat], lead, cps, max_cp)
        sync()
        slow_rows = int((~stage.fast).sum())
        log(f"{form}: {stage.quick.count:,} quick-check rows of {QUICK_WIDTH} B, {slow_rows:,} slow "
            f"({100 * int(stage.quick.lengths[~stage.fast].sum()) / max(n, 1):.1f}% of the bytes): "
            f"{stage.slow_codepoints:,} codepoints (max {stage.slow_max:#x}) in {stage.routes()}; "
            f"staged in {time.perf_counter() - started:.2f} s")
        forms[form] = {"stage": stage}
        group = f"normalize-{form.lower()}"
        ctx.group(group)

        def norm_call(entry=forms[form]) -> WorkUnits:
            entry["out"] = normalize_call(entry["stage"])
            return WorkUnits(1, n)

        ctx.run(f"{group}/swtorch::utf8_norm{scope.name}", "bytes", lambda call=norm_call: call, scope=scope)
        ctx.run(f"{group}/unicodedata.normalize", "bytes",
                lambda f=form: lambda: (unicodedata.normalize(f, host_text), WorkUnits(1, n))[1])

    ctx.group("case-insensitive-compare")
    # Adjacent line pairs, at most 1,000 (reference normalization/bench.rs:249-254).
    lines = first_lines(host_text, 1001)
    pairs = list(zip(lines, lines[1:]))[:1000]
    pair_bytes = sum(len(a) + len(b) for a, b in pairs)
    a_rows = PaddedTokens.from_tape(Tape.from_tokens([p[0] for p in pairs] or [b"x"], device=dev), align=4)
    b_rows = PaddedTokens.from_tape(Tape.from_tokens([p[1] for p in pairs] or [b"x"], device=dev), align=4)
    staged.update(pairs=pairs, compare_rows=(a_rows, b_rows))

    def compare_call() -> WorkUnits:
        staged["equal"] = CF.uncased_equal_batch(a_rows, b_rows)
        return WorkUnits(len(pairs), pair_bytes)

    ctx.run(f"case-insensitive-compare/swtorch::uncased_eq{scope.name}", "comparisons", lambda: compare_call, scope=scope)

    def host_compare() -> WorkUnits:
        for a, b in pairs:
            a.decode("utf-8", "ignore").casefold() == b.decode("utf-8", "ignore").casefold()  # noqa: B015
        return WorkUnits(len(pairs), pair_bytes)

    ctx.run("case-insensitive-compare/casefold-eq", "comparisons", lambda: host_compare)

    ctx.group("case-insensitive-find")
    started = time.perf_counter()
    needles = suite_needles(host_text)
    drawn = time.perf_counter()
    folded, fold_count = CF.fold_bytes(data if n else torch.zeros(4, dtype=torch.uint8, device=dev))
    hay_n = int(fold_count)
    haystack = folded[:hay_n]
    hay_ascii = hay_n > 0 and int(haystack.max()) < 0x80
    hay_bytes = haystack.to(torch.uint8) if hay_ascii else None
    del folded
    calls = []  # per needle: a call that returns its count as an int
    folded_needles = []
    for needle in needles or [b"xyz"]:
        fn, fm = CF.fold_bytes(np.frombuffer(needle, np.uint8))
        needle_cp = fn[: max(int(fm), 1)].to(dev)
        folded_needles.append(needle_cp)
        if hay_bytes is not None and int(needle_cp.max()) < 0x80:
            # ASCII folds repack to bytes and take the packed-word find.
            batch = F.NeedleBatch.from_needles([F.pack_needle(needle_cp.to(torch.uint8).cpu().numpy().tobytes())], dev)
            calls.append(lambda batch=batch: F.find_count_batch(hay_bytes, batch)[0])
        else:
            calls.append(lambda cp=needle_cp: int(F.cp_window_count(haystack, hay_n, cp).item()))
    staged.update(haystack=haystack, needles=folded_needles, needle_counts=[call() for call in calls])
    sync()
    log(f"staged {len(needles)} needles in {drawn - started:.2f} s; folded haystack: {hay_n:,} codepoints "
        f"({'ASCII: packed-word find' if hay_bytes is not None else 'codepoint-window count'}) in "
        f"{time.perf_counter() - drawn:.2f} s")
    cycle = itertools.cycle(calls)

    def find_call() -> WorkUnits:
        next(cycle)()
        return WorkUnits(1, n)

    ctx.run(f"case-insensitive-find/swtorch::uncased_find{scope.name}", "bytes", lambda: find_call, scope=scope)

    lower_text = host_text.casefold()
    host_cycle = itertools.cycle([nd.decode("utf-8", "ignore").casefold() for nd in (needles or [b"xyz"])])

    def host_find() -> WorkUnits:
        count = lower_text.count(next(host_cycle))
        return WorkUnits(max(count, 1), n)

    ctx.run("case-insensitive-find/casefold-count", "bytes", lambda: host_find)
    return ctx


if __name__ == "__main__":
    main()
