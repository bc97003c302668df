"""Normalization suite: case fold, case-insensitive compare and find
(reference ``normalization/bench.rs``; defaults: the whole file as one
token, 3 s warm-up + 20 s measure, 128 MB of ``synthetic:multilingual``).

The port of ``stringwars_tpu.suites.normalization`` for one device, with its
variant names, less the four ``normalize-{nfc,nfd,nfkc,nfkd}`` groups, which
come with the normalization slice (decomposition and composition). Device
rows (``swtorch::...<1gpu>``):

- ``case-fold/swtorch::utf8_fold``: ``expand.fold_tokens_fused`` over the
  corpus cut into 32-byte rows (``stream_rows``), pruned to the corpus'
  exact codepoint ceiling; ``swtorch::ascii_fold`` on ASCII corpora only;
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
(the last fold call's output and counts), ``pairs``, ``compare_rows`` (their
two sides as ``PaddedTokens``), ``equal`` (the last compare call's
booleans), ``haystack`` (the folded codepoints), ``needles`` (their folded
codepoints) and ``needle_counts`` (the device count of each needle, from
one pass over all of them before the row is timed).
"""

from __future__ import annotations

import itertools
import sys
import time

import numpy as np
import torch

from stringwars_tpu_torch.ops import casefold as CF
from stringwars_tpu_torch.ops import expand as EX
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.tape import PaddedTokens, Tape, _pad_spans
from stringwars_tpu_torch.utils.harness import WorkUnits


def stream_row_starts(data: torch.Tensor, width: int) -> torch.Tensor:
    """Row starts (int64, on the data's device) that cut a UTF-8 byte stream
    into rows of at most ``width`` bytes, never inside a multibyte character:
    a row ends at the last lead byte within ``width`` of its start, or, where
    there is none (a continuation run longer than the width), after ``width``
    bytes. The JAX package walks that chain of starts in Python; here it is
    walked in chunks of ``64 * width`` bytes at once: first from every entry
    a chunk can have (the chain enters each chunk within ``width`` of its
    start), then, once the entries are linked on the host, from the true ones."""
    n = data.numel()
    if not 0 < width < 1 << 16:
        raise ValueError(f"width must lie in [1, 65535], got {width}")
    dev = data.device
    if n <= width:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    pos = torch.arange(n, device=dev)
    lead = (data & 0xC0) != 0x80
    rank = torch.cumsum(lead, 0) - 1  # index among the leads of the last lead at or before p
    leads = torch.nonzero(lead).squeeze(1)
    last_lead = torch.where(rank >= 0, leads[rank.clamp(min=0)] if leads.numel() else rank, -1)
    back = (pos - last_lead).clamp(max=width)  # how far p lies past it, capped at width
    del pos, lead, rank, leads, last_lead

    def step(s: torch.Tensor) -> torch.Tensor:
        """The next start after s (for s + width < n)."""
        e = (s + width).clamp(max=n - 1)
        d = back[e]
        return torch.where(d < width, e - d, e)

    chunk = 64 * width
    chunk_ends = torch.arange(1, -(-n // chunk) + 1, device=dev) * chunk
    cur = (chunk_ends - chunk)[:, None] + torch.arange(width, device=dev)[None, :]
    live = cur + width < n
    while bool(live.any()):
        cur = torch.where(live, step(cur), cur)
        live &= (cur < chunk_ends[:, None]) & (cur + width < n)
    exits = (cur - chunk_ends[:, None]).tolist()  # offset into the next chunk, < 0 where the chain ends
    entries, offset = [], 0
    for k, row in enumerate(exits):
        entries.append(k * chunk + offset)
        offset = row[offset]
        if offset < 0:
            break
    cur = torch.tensor(entries, dtype=torch.int64, device=dev)
    ends = chunk_ends[: cur.numel()]
    visited = [cur]
    live = cur + width < n
    while bool(live.any()):
        cur = torch.where(live, step(cur), cur)
        inside = live & (cur < ends)
        visited.append(torch.where(inside, cur, -1))
        live = inside & (cur + width < n)
    starts = torch.stack(visited, 1).reshape(-1)  # chunk by chunk, each in order
    return starts[starts >= 0]


def stream_rows(data_np: np.ndarray, width: int = 1024, *, device=None) -> PaddedTokens:
    """The UTF-8 byte stream as ``[rows, width]`` ``PaddedTokens`` whose rows
    never split a multibyte character (the rows of ``stream_row_starts``),
    built on ``device`` by one scatter of the bytes; ``width`` a multiple of 4,
    as every ``PaddedTokens`` width is."""
    if width % 4:
        raise ValueError(f"the row width must be a multiple of 4, got {width}")
    data = torch.from_numpy(np.array(data_np, dtype=np.uint8)).to(device)
    starts = stream_row_starts(data, width)
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
    scope_names = [scope.name for scope in ctx.scopes]

    def fold_call() -> WorkUnits:
        staged["fold"] = EX.fold_tokens_fused(fold_rows, max_cp)
        return WorkUnits(1, n)

    for name in scope_names:
        ctx.run(f"case-fold/swtorch::utf8_fold{name}", "bytes", lambda: fold_call, device=dev)
    if is_ascii:  # the reference's kernels specialize ASCII runs the same way
        ascii_rows = stream_rows(data_np, device=dev)

        def ascii_call() -> WorkUnits:
            staged["ascii_fold"] = CF.fold_tokens_ascii(ascii_rows)
            return WorkUnits(1, n)

        for name in scope_names:
            ctx.run(f"case-fold/swtorch::ascii_fold{name}", "bytes", lambda: ascii_call, device=dev)
    ctx.run("case-fold/str.casefold", "bytes", lambda: lambda: (host_text.casefold(), WorkUnits(1, n))[1])

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

    for name in scope_names:
        ctx.run(f"case-insensitive-compare/swtorch::uncased_eq{name}", "comparisons", lambda: compare_call, device=dev)

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

    for name in scope_names:
        ctx.run(f"case-insensitive-find/swtorch::uncased_find{name}", "bytes", lambda: find_call, device=dev)

    lower_text = host_text.casefold()
    host_cycle = itertools.cycle([nd.decode("utf-8", "ignore").casefold() for nd in (needles or [b"xyz"])])

    def host_find() -> WorkUnits:
        count = lower_text.count(next(host_cycle))
        return WorkUnits(max(count, 1), n)

    ctx.run("case-insensitive-find/casefold-count", "bytes", lambda: host_find)
    return ctx


if __name__ == "__main__":
    main()
