"""Wrappers of the hand-written CUDA kernels in ``csrc/scanline.cu`` and
``csrc/lbrules.cu``.

``fused_scan_kernel`` runs a whole scan program in one launch of the kernel
``csrc/scanline.cu`` (the counterpart of the TPU kernel
``scanline._make_kernel``): the program is lowered by
``ops/scanline_ir.lower`` and staged on the card once per (program object,
input dtypes, outputs, device), keyed on the object and holding it. Its
scratch (a status entry per op and tile, and the tile counter) is kept per
(device, stream) and never cleared between calls: each call flags its
entries with a new epoch and draws its tiles after the counter's last.
``lb_rules`` is the kernel ``elementwise_map`` launches for the UAX#14 rule
set (the counterpart of ``scanline._ew_kernel`` with ``segment._lb_rules``).
Each wrapper checks its tensors, allocates outputs, launches on PyTorch's
current stream without synchronizing, raises on a CUDA launch error, and
adds one to ``LAUNCHES``. A CPU tensor raises: the plain versions are
``scanline.fused_scan_plain`` and ``segment._lb_rules``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops import scanline_ir as IR

# Launches of the kernels since process start (or the last reset).
LAUNCHES = {"fused_scan": 0, "lb_rules": 0}

# How the kernel loads an input stream (LoadType of csrc/scanline.cu); any
# other integer type is read as int32.
LOAD_TYPES = {torch.int32: 0, torch.uint8: 1, torch.bool: 1, torch.int8: 2}
_EPOCHS = 1 << 29  # flag words hold the epoch in 29 bits

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


@dataclasses.dataclass
class _Staged:
    ops: tuple  # held, so that its id stays this program's
    lowered: IR.Lowered
    table: torch.Tensor  # the program's int32 words on the card


@dataclasses.dataclass
class _Scratch:
    status: torch.Tensor  # int32, 8 words per (scan op, tile)
    counter: torch.Tensor  # the uint32 tile counter (an int32 tensor)
    base: int = 0  # the counter's value after the last launch
    epoch: int = 1  # the next call's epoch


_STAGED: dict[tuple, _Staged] = {}
_SCRATCH: dict[tuple, _Scratch] = {}


def stage(ops: tuple, dtypes: dict, device: torch.device, outputs=None) -> _Staged:
    """``ops`` lowered for ``dtypes`` and staged on ``device``, once."""
    key = (id(ops), tuple(sorted((k, str(v)) for k, v in dtypes.items())), device,
           None if outputs is None else tuple(sorted(outputs)))
    staged = _STAGED.get(key)
    if staged is None or staged.ops is not ops:
        props = torch.cuda.get_device_properties(device)
        shared = (props.shared_memory_per_multiprocessor, props.shared_memory_per_block_optin)
        lowered = IR.lower(ops, dtypes, outputs, shared)
        if lowered.shared_bytes(lowered.items) > lowered.shared[1]:
            raise IR.LoweringError(
                f"fused_scan: the program holds {lowered.slots} tile streams on chip "
                f"({lowered.shared_bytes(lowered.items)} bytes of shared memory; a block has {lowered.shared[1]})"
            )
        table = torch.from_numpy(lowered.table()).to(device)
        staged = _STAGED[key] = _Staged(ops, lowered, table)
    return staged


def _scratch(device: torch.device, entries: int) -> _Scratch:
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = _SCRATCH.get((device, stream))
    if scratch is None:
        scratch = _SCRATCH[(device, stream)] = _Scratch(
            status=torch.zeros(0, dtype=torch.int32, device=device),
            counter=torch.zeros(1, dtype=torch.int32, device=device),
        )
    if scratch.status.numel() < entries * 8:
        scratch.status = torch.zeros(entries * 8, dtype=torch.int32, device=device)
    if scratch.epoch >= _EPOCHS:
        scratch.status.zero_()
        scratch.epoch = 1
    return scratch


def fused_scan_kernel(inputs: dict, ops: tuple, n: int, reverse: bool, outputs=None) -> dict[str, torch.Tensor]:
    """Run the program ``ops`` over n positions in one kernel launch;
    returns its int32 outputs by name (those named in ``outputs``, if
    given)."""
    tensors = {}
    for name, t in inputs.items():
        _require_cuda(t, f"fused_scan input {name!r}")
        if t.shape[0] < n:
            raise ValueError(f"fused_scan: input {name!r} is shorter than n = {n}")
        tensors[name] = t
    device = next(iter(tensors.values())).device
    staged = stage(ops, {k: t.dtype for k, t in tensors.items()}, device, outputs)
    lowered = staged.lowered
    out = {name: torch.empty(n, dtype=torch.int32, device=device) for name in lowered.outputs}
    if n == 0:
        return out
    streams = []
    for name in lowered.inputs:
        t = tensors[name][:n]
        if t.dtype not in LOAD_TYPES:
            t = t.to(torch.int32)
        if t.device != device:
            raise ValueError(f"fused_scan: input {name!r} on {t.device}, others on {device}")
        streams.append(t)
    tiles = -(-n // lowered.tile)
    scratch = _scratch(device, len(lowered.scans) * tiles)
    words = [x for t in streams for x in (t.data_ptr(), LOAD_TYPES[t.dtype])] + [t.data_ptr() for t in out.values()]
    io = (ctypes.c_int64 * max(1, len(words)))(*words)
    lib = build.library()
    with torch.cuda.device(device):
        code = lib.sw_fused_scan(
            staged.table.data_ptr(), ctypes.addressof(io), len(streams), len(out), n, int(reverse), lowered.items,
            lowered.slots, lowered.byte_slots, lowered.stage_ops, scratch.status.data_ptr(),
            scratch.counter.data_ptr(), scratch.base, scratch.epoch, build.stream_of(scratch.counter),
        )
    build.check(code, "fused_scan")
    scratch.base = (scratch.base + tiles) & 0xFFFFFFFF  # a ticket a tile
    scratch.epoch += 1
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
