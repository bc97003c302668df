"""Find suite: substring-forward / substring-backward / byteset groups
(reference ``find/bench.rs:350``, defaults 3 s + 20 s, words tokens).

The port of ``stringwars_tpu.suites.find`` for one device. Forward variants
count all matches of needles cycled from the token list over the whole
haystack per call (``find/bench.rs:56-93``); backward variants run the
rfind form (count + LAST match offset, ``find/bench.rs:144-219``), one
needle per call; bytesets scan three charsets per call
(``find/bench.rs:226-348``), so byteset work = 3x corpus bytes.

Device rows (``swtorch::...<1gpu>``) go through the hand-written CUDA
kernels of ``ops/find_cuda.py``. With ``--device cpu`` the same rows
(``<1cpu>``) run the plain torch versions; without it, a host with no card
stops with an error.

Needles: every token is a needle (``find/bench.rs:56-93``). The forward row
takes the first 512 tokens of at most 505 B, grouped by the JAX package's
capacity buckets; each call scans the next batch of up to 16 needles of
every bucket, plus the first two tokens longer than 505 B. The needles are
read through the offsets, not by materializing every token.

The ``byteset-forward`` group also counts the three charsets as sets of
one-byte patterns (``swtorch::aho_corasick``, the reference's aho-corasick
rows), routed as the JAX package routes them on its TPU: the Shift-And
kernel of ``ops/shiftand_cuda.py`` for a set that packs into its 64 bits,
else the DFA kernel of ``ops/ahocorasick_cuda.py``.

Under a world of N ranks (torchrun) each device row also runs sharded
(``<Ngpu>``, ``parallel/sharding.py``): every rank holds its 512-byte
aligned chunk of the haystack and a halo of ``8 * cap`` bytes after it (the
JAX rows' halo), counts the window starts it owns (``p < chunk`` and
``lo + p <= n - m``: the find kernel over ``row[:min(chunk + m - 1, n -
lo)]``), and the counts are summed over the ranks; the backward row's last
offset, in global bytes, is reduced by max. These rows run one needle a
call, cycling the first 64 tokens that fit ``cap`` = 16 words (61 B), as
the JAX rows do; the byteset row counts each rank's chunk, and the
``aho_corasick`` row each rank's owned matches (``sharding.owned_count``).
The JAX package's panel form of the same count (``make_sharded_find_pallas``)
is the TPU's layout of this one sharded find.
"""

from __future__ import annotations

import itertools
import re

import numpy as np
import torch

from stringwars_tpu_torch.ops import ahocorasick as AC
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.ops import shiftand as SA
from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.parallel.sharding import owned_count, pmax_scalar, psum_scalar, shard_bytes
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.harness import WorkUnits

BYTESETS = {
    "tabs": b"\n\r\x0b\x0c",
    "html": b"</>&'\"=[]",
    "digits": b"0123456789",
}

CYCLE = 512  # needles cycled per row (reference find/bench.rs:56-93)
BATCH = 16  # needles per capacity bucket per forward call
PANEL_MAX = 4 * 127 - 3  # longest needle of the JAX package's capacity buckets (505 B)
SHARDED_CAP = 16  # the <Ngpu> rows' capacity words: needles of up to 61 B, a halo of 8 * 16 B
SHARDED_CYCLE = 64  # needles the <Ngpu> rows cycle


def _needle_cap(t: bytes) -> int:
    """Capacity bucket, in u32 words: the JAX package's buckets up to 505 B,
    then 64-word-quantized capacities."""
    for cap in (4, 8, 16, 32, 64, 127):
        if len(t) <= 4 * cap - 3:
            return cap
    need = (len(t) + 6) // 4
    return -(-need // 64) * 64


def suite_needles(tape: Tape) -> tuple[list[bytes], list[bytes], list[bytes]]:
    """(cycle, panel, long) needles, read through the tape's offsets.

    ``cycle``: the first 512 non-empty tokens (host loops, backward row);
    ``panel``: the first 512 tokens of 1..505 B (forward buckets);
    ``long``: the first two tokens longer than 505 B (forward, every call).
    """
    offsets = tape.offsets.cpu().numpy()
    data = tape.data.cpu().numpy()
    lengths = np.diff(offsets)

    def take(idx) -> list[bytes]:
        return [data[offsets[i] : offsets[i + 1]].tobytes() for i in idx]

    cycle = take(np.flatnonzero(lengths > 0)[:CYCLE])
    panel = take(np.flatnonzero((lengths > 0) & (lengths <= PANEL_MAX))[:CYCLE])
    long = take(np.flatnonzero(lengths > PANEL_MAX)[:2])
    return cycle, panel, long


def forward_routine(tape: Tape):
    """(routine, results): each call scans the next batch of every capacity
    bucket (and the long needles) over the whole tape on its device, one
    launch a batch and one read-back of all their counts; ``results`` maps
    each scanned needle to its count."""
    _, panel, long = suite_needles(tape)
    by_cap: dict[int, list[bytes]] = {}
    for t in panel:
        by_cap.setdefault(_needle_cap(t), []).append(t)

    def stage(needles: list[bytes]):
        packed = [F.pack_needle(t, _needle_cap(t)) for t in needles]
        return needles, F.NeedleBatch.from_needles(packed, tape.device)

    buckets = [
        [stage(ts[i : i + BATCH]) for i in range(0, len(ts), BATCH)] for ts in by_cap.values()
    ]
    if long:
        buckets.append([stage(long)])
    hay, n = tape.data, tape.total_bytes
    calls = itertools.count()
    results: dict[bytes, int] = {}

    def routine() -> WorkUnits:
        k = next(calls)
        staged = [groups[k % len(groups)] for groups in buckets]
        counts = torch.cat([F.find_counts(hay, batch, n) for _, batch in staged]).tolist()  # one device sync
        results.update(zip((t for needles, _ in staged for t in needles), counts))
        scanned = len(counts)
        return WorkUnits(elements=scanned, bytes=scanned * n)

    return routine, results


def backward_routine(tape: Tape):
    """(routine, results): each call runs the rfind form for the next needle
    of the cycle; ``results`` maps each needle to its (count, last offset)."""
    cycle, _, _ = suite_needles(tape)
    staged = F.NeedleBatch.from_needles([F.pack_needle(t, _needle_cap(t)) for t in cycle], tape.device)
    singles = [(t, staged.row(i)) for i, t in enumerate(cycle)]
    hay, n = tape.data, tape.total_bytes
    order = itertools.cycle(singles)
    results: dict[bytes, tuple[int, int]] = {}

    def routine() -> WorkUnits:
        needle, batch = next(order)
        results[needle] = F.rfind_count_batch(hay, batch, n)[0]
        return WorkUnits(elements=1, bytes=n)

    return routine, results


def byteset_routine(tape: Tape):
    """(routine, results): each call counts the three charsets over the tape;
    ``results`` maps each charset name to its count."""
    tables = [F.pack_byteset(cs, tape.device) for cs in BYTESETS.values()]
    hay, n = tape.data, tape.total_bytes
    results: dict[str, int] = {}

    def routine() -> WorkUnits:
        results.update(zip(BYTESETS, F.byteset_counts(hay, tables, n)))
        return WorkUnits(elements=len(tables), bytes=len(tables) * n)

    return routine, results


def byteset_matcher(charset: bytes) -> SA.ShiftAndSet | AC.Automaton:
    """The JAX package's TPU route for a charset as one-byte patterns:
    Shift-And when the set packs into its words, else the AC DFA."""
    patterns = [bytes([c]) for c in charset]
    if len(patterns) <= SA.MAX_BITS:
        try:
            return SA.ShiftAndSet(patterns)
        except ValueError:  # does not pack into the state words
            pass
    return AC.Automaton(patterns)


def aho_corasick_routine(tape: Tape):
    """(routine, results): each call counts the three charsets over the tape
    as multi-pattern sets; ``results`` maps each charset name to its count.
    The sets and their tables are staged once, before the first call."""
    matchers = [byteset_matcher(cs) for cs in BYTESETS.values()]
    hay, n = tape.data, tape.total_bytes
    for m in matchers:
        m.tables(hay.device)
    results: dict[str, int] = {}

    def count(m) -> torch.Tensor:
        if isinstance(m, SA.ShiftAndSet):
            return SA.shiftand_count_tensor(m, hay, n)
        return AC.ac_count_tensor(m, hay, n)

    def routine() -> WorkUnits:
        results.update(zip(BYTESETS, torch.cat([count(m) for m in matchers]).tolist()))  # one device sync
        return WorkUnits(elements=len(matchers), bytes=len(matchers) * n)

    return routine, results


def make_sharded_find(scope: DeviceScope, tape: Tape, backward: bool = False):
    """The ``<Ngpu>`` count over the ranks of ``scope``: each rank's halo row
    of the tape (``shard_bytes`` with an ``8 * SHARDED_CAP``-byte halo).
    Returns ``step(batch)`` for a batch of one needle of at most
    ``4 * SHARDED_CAP - 3`` bytes: the count over every rank, or with ``backward`` (count, last
    match start in the whole tape or -1), each an int64[1] tensor."""
    row, n, chunk = shard_bytes(scope, tape.data[: tape.total_bytes], overlap=8 * SHARDED_CAP)
    lo = scope.rank * chunk

    def step(batch: F.NeedleBatch):
        if backward:
            counts, lasts = F.rfind_counts_owned(row, batch, chunk, lo, n)
            return psum_scalar(counts, scope), pmax_scalar(lasts, scope)
        return psum_scalar(F.find_counts_owned(row, batch, chunk, lo, n), scope)

    return step


def sharded_needles(tape: Tape) -> list[bytes]:
    """The ``<Ngpu>`` rows' needles: the first 64 of the cycle that fit ``SHARDED_CAP``."""
    cycle, _, _ = suite_needles(tape)
    longest = 4 * SHARDED_CAP - 3
    fitting = [t for t in cycle if len(t) <= longest]
    return fitting[:SHARDED_CYCLE] or [cycle[0][:longest]]


def sharded_substring_routine(tape: Tape, scope: DeviceScope, backward: bool):
    """(routine, results): each call counts the next needle over the ranks;
    ``results`` maps each needle to its count, or (count, last offset)."""
    needles = sharded_needles(tape)
    batches = [F.NeedleBatch.from_needles([F.pack_needle(t, _needle_cap(t))], tape.device) for t in needles]
    step = make_sharded_find(scope, tape, backward=backward)
    order = itertools.cycle(zip(needles, batches))
    n = tape.total_bytes
    results: dict[bytes, int | tuple[int, int]] = {}

    def routine() -> WorkUnits:
        needle, batch = next(order)
        got = step(batch)
        results[needle] = (int(got[0][0]), int(got[1][0])) if backward else int(got[0])
        return WorkUnits(elements=1, bytes=n)

    return routine, results


def sharded_byteset_routine(tape: Tape, scope: DeviceScope):
    """(routine, results): ``byteset_routine`` over the ranks, each counting
    its chunk of the tape."""
    row, n, chunk = shard_bytes(scope, tape.data[: tape.total_bytes])
    tables = [F.pack_byteset(cs, tape.device) for cs in BYTESETS.values()]
    results: dict[str, int] = {}

    def routine() -> WorkUnits:
        counts = F.byteset_counts_bounded(row, tables, chunk, scope.rank * chunk, n)
        results.update(zip(BYTESETS, psum_scalar(counts, scope).tolist()))
        return WorkUnits(elements=len(tables), bytes=len(tables) * n)

    return routine, results


def sharded_aho_corasick_routine(tape: Tape, scope: DeviceScope):
    """(routine, results): ``aho_corasick_routine`` over the ranks, each
    counting the matches that start in its chunk (its halo: the longest
    pattern less one byte)."""
    matchers = [byteset_matcher(cs) for cs in BYTESETS.values()]
    reach = max(m.max_len for m in matchers) - 1
    row, n, chunk = shard_bytes(scope, tape.data[: tape.total_bytes], overlap=reach)
    for m in matchers:
        m.tables(row.device)
    results: dict[str, int] = {}

    def count(m):
        if isinstance(m, SA.ShiftAndSet):
            return lambda hay, k: SA.shiftand_count_tensor(m, hay, k)
        return lambda hay, k: AC.ac_count_tensor(m, hay, k)

    def routine() -> WorkUnits:
        lo = scope.rank * chunk
        owned = [owned_count(count(m), row, chunk, F.owned_extent(chunk, lo, n, m.max_len - 1)) for m in matchers]
        results.update(zip(BYTESETS, psum_scalar(torch.cat(owned), scope).tolist()))
        return WorkUnits(elements=len(matchers), bytes=len(matchers) * n)

    return routine, results


def _host_haystack(ctx: SuiteContext) -> bytes:
    return ctx.tape.data.cpu().numpy().tobytes()


def bench_substring(ctx: SuiteContext, group: str) -> None:
    backward = group == "substring-backward"
    cycle, _, _ = suite_needles(ctx.tape)
    if not cycle:
        return

    # --- device variant, one row per scope ---------------------------------
    make = backward_routine if backward else forward_routine
    op = "rfind_count" if backward else "find_count"
    for scope in ctx.scopes:
        if scope.group is None:
            routine = lambda: make(ctx.tape)[0]  # noqa: E731
        else:
            routine = lambda scope=scope: sharded_substring_routine(ctx.tape, scope, backward)[0]  # noqa: E731
        ctx.run(f"{group}/swtorch::{op}{scope.name}", "bytes", routine, scope=scope)

    # --- host baseline: bytes.find/rfind loop (all matches, one pass) -----
    def host_routine_factory():
        hay_b = _host_haystack(ctx)
        n = len(hay_b)
        needles = itertools.cycle(cycle)

        def host_routine() -> WorkUnits:
            needle = next(needles)
            count = 0
            if backward:
                pos = len(hay_b)
                while True:
                    pos = hay_b.rfind(needle, 0, pos + len(needle) - 1)
                    if pos < 0:
                        break
                    count += 1
            else:
                pos = 0
                while True:
                    pos = hay_b.find(needle, pos)
                    if pos < 0:
                        break
                    count += 1
                    pos += 1
            return WorkUnits(elements=max(count, 1), bytes=n)

        return host_routine

    name = "bytes.rfind-loop" if backward else "bytes.find-loop"
    ctx.run(f"{group}/{name}", "bytes", host_routine_factory)


def bench_byteset(ctx: SuiteContext) -> None:
    for op, one, sharded in (("byteset_count", byteset_routine, sharded_byteset_routine),
                             ("aho_corasick", aho_corasick_routine, sharded_aho_corasick_routine)):
        for scope in ctx.scopes:
            if scope.group is None:
                routine = lambda one=one: one(ctx.tape)[0]  # noqa: E731
            else:
                routine = lambda sharded=sharded, scope=scope: sharded(ctx.tape, scope)[0]  # noqa: E731
            ctx.run(f"byteset-forward/swtorch::{op}{scope.name}", "bytes", routine, scope=scope)

    def re_routine_factory():
        hay_b = _host_haystack(ctx)
        n = len(hay_b)
        regexes = [re.compile(b"[" + re.escape(cs) + b"]") for cs in BYTESETS.values()]

        def re_routine() -> WorkUnits:
            total = sum(len(r.findall(hay_b)) for r in regexes)
            return WorkUnits(elements=max(total, 1), bytes=len(regexes) * n)

        return re_routine

    ctx.run("byteset-forward/re.findall", "bytes", re_routine_factory)


def main(argv: list[str] | None = None) -> SuiteContext:
    """Run the suite; returns its context (the tape stays on its device)."""
    ctx = setup_suite(
        "Substring and byteset search throughput",
        default_tokens="words",
        default_warmup=3.0,
        default_time=20.0,
        argv=argv,
    )
    ctx.group("substring-forward")
    bench_substring(ctx, "substring-forward")
    ctx.group("substring-backward")
    bench_substring(ctx, "substring-backward")
    ctx.group("byteset-forward")
    bench_byteset(ctx)
    return ctx


if __name__ == "__main__":
    main()
