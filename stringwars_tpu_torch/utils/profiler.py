"""The card's own roofline, the card's identity, and a timed-section guard.

``measured_roofline(device)`` is the rate every device row's "% SoL" column
is reported against: the bytesum kernel (``csrc/bytesum.cu``, one read of
every byte) timed on the card over a 256 MB buffer, once per process. It
replaces the JAX package's hard-coded TPU constant.

``PerfSection`` times a region (CUDA events on a CUDA device, the host clock
otherwise) and prints elapsed time and achieved GB/s against that roofline:

    with PerfSection("hash", bytes_moved=corpus_bytes, device=dev):
        kernel(...)

prints ``# perf hash: 12.3 ms, 10.9 GB/s (0.4% of the measured roofline)``.
Set ``SWTPU_TRACE_DIR`` to also write a ``torch.profiler`` Chrome trace of the
region there.
"""

from __future__ import annotations

import functools
import os
import statistics
import subprocess
import sys
import time

import torch

from stringwars_tpu_torch.utils.config import get_env

ROOFLINE_PROBE_BYTES = 256 << 20
ROOFLINE_PROBE_LAUNCHES = 10
ROOFLINE_PROBE_RUNS = 5


def card_identity(device: torch.device) -> str:
    """``name, power.limit`` of the card, as ``nvidia-smi`` reports them."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    proc = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip()


@functools.lru_cache(maxsize=None)
def _roofline_of(device: torch.device) -> float:
    from stringwars_tpu_torch.ops.bytesum import bytesum_cuda

    buf = torch.full((ROOFLINE_PROBE_BYTES,), 0xA5, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device)
    bytesum_cuda(buf)  # warm-up: the first launch also loads the module
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    seconds = []
    for _ in range(ROOFLINE_PROBE_RUNS):
        # Back-to-back launches keep the card busy while the host enqueues the
        # next one, so the span holds kernel time and not the wrapper's.
        start.record(stream)
        for _ in range(ROOFLINE_PROBE_LAUNCHES):
            bytesum_cuda(buf)
        end.record(stream)
        end.synchronize()
        seconds.append(start.elapsed_time(end) * 1e-3 / ROOFLINE_PROBE_LAUNCHES)
    return ROOFLINE_PROBE_BYTES / statistics.median(seconds)


def measured_roofline(device) -> float | None:
    """Bytes/s of the bytesum kernel over 256 MB on ``device``: the median of
    five runs of ten back-to-back launches, measured once per process and
    device. None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _roofline_of(device)


class PerfSection:
    """Context manager printing elapsed time + achieved GB/s vs the roofline."""

    def __init__(self, name: str, *, bytes_moved: int | None = None, device=None, minimal: bool = False):
        self.name = name
        self.bytes_moved = bytes_moved
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.minimal = minimal
        self._trace_dir = get_env("TRACE_DIR")
        self._trace = None

    def __enter__(self):
        if self._trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.__enter__()
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.device.type == "cuda":
            self._events[1].record(self._stream)
            self._events[1].synchronize()
            elapsed = self._events[0].elapsed_time(self._events[1]) * 1e-3
        else:
            elapsed = time.perf_counter() - self._t0
        if self._trace is not None:
            self._trace.__exit__(exc_type, exc, tb)
            os.makedirs(self._trace_dir, exist_ok=True)
            self._trace.export_chrome_trace(os.path.join(self._trace_dir, f"{self.name}.json"))
        if exc_type is not None:
            return False
        parts = [f"{elapsed * 1e3:.2f} ms"]
        if self.bytes_moved and not self.minimal:
            rate = self.bytes_moved / max(elapsed, 1e-12)
            parts.append(f"{rate / 1e9:.2f} GB/s")
            roofline = measured_roofline(self.device)
            if roofline:
                parts.append(f"{100.0 * rate / roofline:.1f}% of the measured {roofline / 1e9:.0f} GB/s roofline")
        print(f"# perf {self.name}: {', '.join(parts)}", file=sys.stderr, flush=True)
        return False
