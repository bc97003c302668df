"""Find suite: substring-forward / substring-backward / byteset groups
(reference ``find/bench.rs:350``, defaults 3 s + 20 s, words tokens).

The port of ``stringwars_tpu.suites.find`` for one device. Forward variants
count all matches of needles cycled from the token list over the whole
haystack per call (``find/bench.rs:56-93``); backward variants run the
rfind form (count + LAST match offset, ``find/bench.rs:144-219``), one
needle per call; bytesets scan three charsets per call
(``find/bench.rs:226-348``), so byteset work = 3x corpus bytes.

Device rows (``swtorch::...<1gpu>``) go through the hand-written CUDA
kernels of ``ops/find_cuda.py``; on a machine without a card the same rows
(``<1cpu>``) run the plain torch versions.

Needles: every token is a needle (``find/bench.rs:56-93``). The forward row
takes the first 512 tokens of at most 505 B, grouped by the JAX package's
capacity buckets; each call scans the next batch of up to 16 needles of
every bucket, plus the first two tokens longer than 505 B. The needles are
read through the offsets, not by materializing every token.

Not ported yet: the Aho-Corasick / Shift-And row of ``byteset-forward`` and
the sharded ``<N...>`` rows.
"""

from __future__ import annotations

import itertools
import re

import numpy as np

from stringwars_tpu_torch.ops import find as F
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
    bucket (and the long needles) over the whole tape on its device;
    ``results`` maps each scanned needle to its count."""
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
        scanned = 0
        for groups in buckets:
            needles, batch = groups[k % len(groups)]
            results.update(zip(needles, F.find_count_batch(hay, batch, n)))
            scanned += batch.size
        return WorkUnits(elements=scanned, bytes=scanned * n)

    return routine, results


def backward_routine(tape: Tape):
    """(routine, results): each call runs the rfind form for the next needle
    of the cycle; ``results`` maps each needle to its (count, last offset)."""
    cycle, _, _ = suite_needles(tape)
    staged = F.NeedleBatch.from_needles([F.pack_needle(t, _needle_cap(t)) for t in cycle], tape.device)
    singles = [
        (t, F.NeedleBatch(staged.images[i : i + 1], staged.lengths[i : i + 1], (len(t),)))
        for i, t in enumerate(cycle)
    ]
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
        ctx.run(f"{group}/swtorch::{op}{scope.name}", "bytes", lambda: make(ctx.tape)[0], device=scope.device)

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
    for scope in ctx.scopes:
        ctx.run(
            f"byteset-forward/swtorch::byteset_count{scope.name}",
            "bytes",
            lambda: byteset_routine(ctx.tape)[0],
            device=scope.device,
        )

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
