"""Wrappers of the hand-written CUDA kernels in ``csrc/scanline.cu`` and
``csrc/lbrules.cu``.

``fused_scan_group`` is the group executor of ``ops/scanline.fused_scan``
on a card (the counterpart of the TPU kernel ``scanline._make_kernel``);
``lb_rules`` is the kernel ``elementwise_map`` launches for the UAX#14 rule
set (the counterpart of ``scanline._ew_kernel`` with ``segment._lb_rules``).
Each wrapper checks its tensors, allocates outputs and scratch, launches on
PyTorch's current stream without synchronizing, raises on a CUDA launch
error, and adds one to ``LAUNCHES``. A CPU tensor raises: the plain versions
are ``scanline.scan_group_plain`` and ``segment._lb_rules``.
"""

from __future__ import annotations

import ctypes

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.scanline import MAX_GROUP

# Launches of the kernels since process start (or the last reset).
LAUNCHES = {"fused_scan": 0, "lb_rules": 0}

KIND_CODES = {"sum": 0, "max": 1, "last": 2, "last2": 3, "delay": 4}
DTYPE_CODES = {torch.int32: 0, torch.uint8: 1, torch.bool: 1, torch.int8: 2}
SEGMENT = 2048  # positions per warp segment (kSegment of csrc/scanline.cu)

# The feature streams of the UAX#14 rules, in the order of LbStream in
# csrc/lbrules.cu.
LB_STREAMS = (
    "cls", "lead", "attached", "eff", "prev_raw", "prev", "before_sp", "prev2", "ri_run_prev", "nxt", "lead_ord",
)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _typed(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A stream as the kernel reads it: int32, uint8/bool or int8 as is,
    any other integer type as int32."""
    if t.dtype not in DTYPE_CODES:
        t = t.to(torch.int32)
    return t, DTYPE_CODES[t.dtype]


def fused_scan_group(group, n: int, reverse: bool) -> dict[str, torch.Tensor]:
    """Scan up to ``MAX_GROUP`` built ops ``(op, value, flag)`` over n
    positions in one kernel call; returns their int32 outputs by name."""
    if not 0 < len(group) <= MAX_GROUP:
        raise ValueError(f"fused_scan_group takes 1 to {MAX_GROUP} ops, got {len(group)}")
    device = group[0][1].device
    keep, desc, out = [], [], {}  # keep: converted streams live until the launch is enqueued
    for op, value, flag in group:
        if op.kind not in KIND_CODES:
            raise ValueError(f"fused_scan_group: kind {op.kind!r} has no scan")
        value, vtype = _typed(value)
        _require_cuda(value, f"fused_scan {op.name}")
        ftype, fptr = 0, 0
        if op.kind in ("last", "last2"):
            flag, ftype = _typed(flag)
            _require_cuda(flag, f"fused_scan {op.name} flags")
            fptr = flag.data_ptr()
        if value.shape[0] < n or (flag is not None and flag.shape[0] < n):
            raise ValueError(f"fused_scan {op.name}: streams shorter than n = {n}")
        outs = [torch.empty(n, dtype=torch.int32, device=device) for _ in op.outs]
        out.update(zip(op.outs, outs))
        keep += [value, flag]
        ptrs = [t.data_ptr() for t in outs] + [0] * (2 - len(outs))
        desc += [KIND_CODES[op.kind], int(op.init), vtype, ftype, value.data_ptr(), fptr, *ptrs]
    if n == 0:
        return out
    segs = -(-n // SEGMENT)
    scratch = torch.empty(3 * len(group) * segs, dtype=torch.int32, device=device)
    table = (ctypes.c_int64 * len(desc))(*desc)
    lib = build.library()
    with torch.cuda.device(device):
        code = lib.sw_fused_scan(
            ctypes.addressof(table), len(group), n, int(reverse), scratch.data_ptr(), scratch.numel(),
            build.stream_of(scratch),
        )
    build.check(code, "fused_scan")
    LAUNCHES["fused_scan"] += 1
    return out


def lb_rules(inputs: dict, n: int) -> torch.Tensor:
    """The UAX#14 rules over the feature streams ``LB_STREAMS``: int32[n],
    1 where a line may break before the position."""
    streams = []
    for name in LB_STREAMS:
        t = inputs[name][:n].to(torch.int32).contiguous()
        _require_cuda(t, f"lb_rules {name}")
        streams.append(t)
    out = torch.empty(n, dtype=torch.int32, device=streams[0].device)
    if n == 0:
        return out
    table = (ctypes.c_int64 * len(streams))(*(t.data_ptr() for t in streams))
    lib = build.library()
    with torch.cuda.device(out.device):
        code = lib.sw_lb_rules(ctypes.addressof(table), n, out.data_ptr(), build.stream_of(out))
    build.check(code, "lb_rules")
    LAUNCHES["lb_rules"] += 1
    return out
