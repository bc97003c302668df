"""Measurement harness (layer L2): wall-time-budgeted throughput.

The port of ``stringwars_tpu.utils.harness``: run a variant closure under a
warm-up budget (uncounted; the kernels' build and first launches land
there) and then a measured budget, recording per-call latency samples for
p50/p99. Both phases always run at least one call, so ``SWTPU_TIME=0``
still smoke-runs every variant once.

On a CUDA device each measured call is bracketed by a pair of CUDA events
and ends with a synchronize: a call's latency is the device-side span from
its first enqueued kernel to its last, and the variant's elapsed time is the
sum of those spans. Host variants are timed with the host's monotonic clock.

Not ported: the JAX package's chained-loop protocol (``DeviceRoutine``,
``fold_salt``, ``perturb_u8``, ``chained_per_iter``, ``measure_chained``).
It existed because the remote TPU runtime served repeated identical
dispatches from a cache; a local card runs every launch it is given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

import torch
import torch.distributed as dist

from stringwars_tpu_torch.utils.config import get_env_parsed
from stringwars_tpu_torch.utils.report import BenchStats


def now_ns() -> int:
    return time.monotonic_ns()


@dataclasses.dataclass(frozen=True)
class WorkUnits:
    """Work accomplished by one closure call (reference ``utils.rs:524-545``)."""

    elements: int
    bytes: int

    def __add__(self, other: "WorkUnits") -> "WorkUnits":
        return WorkUnits(self.elements + other.elements, self.bytes + other.bytes)


@dataclasses.dataclass(frozen=True)
class BenchBudget:
    """Warm-up + measured seconds, env-overridable per suite."""

    warmup_seconds: float
    time_seconds: float

    @classmethod
    def from_env(cls, default_warmup: float, default_time: float) -> "BenchBudget":
        return cls(
            warmup_seconds=get_env_parsed("WARMUP", float(default_warmup)),
            time_seconds=get_env_parsed("TIME", float(default_time)),
        )

    def with_overrides(self, warmup: float | None, time_limit: float | None) -> "BenchBudget":
        return BenchBudget(
            warmup_seconds=self.warmup_seconds if warmup is None else warmup,
            time_seconds=self.time_seconds if time_limit is None else time_limit,
        )


def _past(deadline_ns: int, group, device) -> bool:
    """Whether the deadline has passed; under a process ``group``, whether
    it has on any of its ranks, so that all stop after the same call."""
    late = now_ns() >= deadline_ns
    if group is None:
        return late
    flag = torch.tensor([int(late)], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def measure_throughput(
    routine: Callable[[], WorkUnits], budget: BenchBudget, *, device: torch.device | None = None, group=None
) -> BenchStats:
    """Run ``routine`` under ``budget`` and collect throughput statistics.

    ``routine`` performs one batch of work and returns the ``WorkUnits``
    accomplished. With a CUDA ``device`` every call is timed by CUDA events
    and synchronized; otherwise by the host clock. Warm-up calls are
    uncounted. Both phases always execute at least one call. Under a
    process ``group`` (``routine`` runs collectives on every rank) the ranks
    agree after each call whether to go on, outside the timed span, and the
    elapsed time is the sum of the calls' spans.
    """
    on_card = device is not None and torch.device(device).type == "cuda"
    warmup_deadline = now_ns() + int(budget.warmup_seconds * 1e9)
    while True:
        routine()
        if on_card:
            torch.cuda.synchronize(device)
        if _past(warmup_deadline, group, device):
            break

    if on_card:
        stream = torch.cuda.current_stream(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    deadline = now_ns() + int(budget.time_seconds * 1e9)
    elements = 0
    total_bytes = 0
    latencies: list[float] = []
    started = now_ns()
    while True:
        if on_card:
            start.record(stream)
            units = routine()
            end.record(stream)
            end.synchronize()
            latencies.append(start.elapsed_time(end) * 1e-3)
        else:
            call_start = now_ns()
            units = routine()
            latencies.append((now_ns() - call_start) * 1e-9)
        elements += units.elements
        total_bytes += units.bytes
        if _past(deadline, group, device):
            break
    elapsed = sum(latencies) if on_card or group is not None else (now_ns() - started) * 1e-9
    return BenchStats(
        elapsed_seconds=elapsed,
        elements=elements,
        bytes=total_bytes,
        latencies_seconds=latencies,
    )


# ---------------------------------------------------------------------------
# Host-side pacing for item-at-a-time loops (Python-kernel parity paths).
#
# The reference's adaptive pacing: the stride starts at 1 and doubles toward
# a 1024 cap while the work between clock reads stays under ~1 ms
# (``utils.rs:588-589``, ``utils.py:103-139``).
# ---------------------------------------------------------------------------

PACING_STRIDE_CAP = 1024
PACING_TARGET_BETWEEN_CHECKS_NS = 1_000_000


class AdaptiveStride:
    """Checkpoint cadence that widens geometrically while cheap.

    ``width`` is how many items to process before the next clock read.
    ``checkpoint()`` records one clock read, widens if the elapsed span was
    under the ~1 ms target, and reports the current time — so one slow item
    keeps the cadence at every-iteration (bounding deadline overshoot by a
    single item) while fine-grained work amortizes up to the cap.
    """

    __slots__ = ("cap", "width", "_mark")

    def __init__(self, cap: int = PACING_STRIDE_CAP):
        self.cap = cap
        self.width = 1
        self._mark = now_ns()

    def checkpoint(self) -> int:
        current = now_ns()
        if current - self._mark < PACING_TARGET_BETWEEN_CHECKS_NS and self.width < self.cap:
            self.width = min(self.width * 2, self.cap)
        self._mark = current
        return current


def paced_items(items: Iterable, deadline_ns: int, step: int = PACING_STRIDE_CAP) -> Iterator:
    """Yield from ``items`` until ``deadline_ns``, checkpointing adaptively."""
    pacer = AdaptiveStride(step)
    remaining = 1
    for item in items:
        yield item
        remaining -= 1
        if remaining == 0:
            if pacer.checkpoint() >= deadline_ns:
                return
            remaining = pacer.width


def clamped_subranges(count: int, stride: int = PACING_STRIDE_CAP) -> Iterator[tuple[int, int]]:
    """(low, high) windows covering [0, count) in stride-sized steps."""
    return ((low, min(low + stride, count)) for low in range(0, count, stride))


def reduce_in_windows(function, *columns, deadline_ns: int, step: int = PACING_STRIDE_CAP, combine=sum):
    """Window-at-a-time map-reduce over zipped columns with deadline pacing.

    Each window is ``combine(map(function, ...))`` so the per-item loop runs
    in C; the deadline is read once per adaptive window. Returns
    ``(total, processed_count)``.
    """
    count = min(map(len, columns), default=0)
    pacer = AdaptiveStride(step)
    total = 0
    done = 0
    while done < count and now_ns() < deadline_ns:
        high = min(done + pacer.width, count)
        total += combine(map(function, *(column[done:high] for column in columns)))
        pacer.checkpoint()
        done = high
    return total, done
