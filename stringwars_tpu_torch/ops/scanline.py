"""Fused prefix-scan programs and the elementwise rule evaluator (K9).

The port of ``stringwars_tpu.ops.scanline``. The TR29/UAX#14 boundary
functions need a handful of prefix quantities per stream position: running
counts, running maxima, "value at the last flagged position", the last two
flagged values, and one-position delays. A program is a tuple of ``Op``s,
the JAX package's own form: each op's ``build(env)`` makes its input from
the program's input streams and the outputs of earlier ops.

``fused_scan(inputs, ops, n, reverse=...)`` runs a program. The TPU runs a
whole program in one Pallas pass over a grid that runs in order, carrying
each op's state from tile to tile. On a CUDA tensor so does the kernel
``csrc/scanline.cu``: one launch a call, the builds lowered to its IR
(``ops/scanline_ir.py``) and evaluated inside it, the carries found by a
decoupled look-back (``ops/scanline_cuda.fused_scan_kernel``). On a CPU
tensor the plain executor runs it: ``run_program`` calls the builds as torch
elementwise ops (each in the profiler range ``BUILD_RANGE``) and hands every
group of ops whose builds read no pending output to ``scan_group_plain``
(cumulative sums and maxima, and gathers at the last flagged index).
``fused_scan_plain`` takes the plain executor on any device: it is the
comparison for the kernel on the card.

``elementwise_map(inputs, fn, n)`` evaluates a rule function over named
streams. On the CPU it runs ``fn`` on the whole tensors, as the JAX package
does off the TPU; on a card it launches the CUDA kernel registered for
``fn`` (``register_kernel``) and raises for a function without one. Its one
user is the UAX#14 rule set (``ops/segment._lb_rules``, kernel
``csrc/lbrules.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

KINDS = ("sum", "max", "last", "last2", "delay", "id")
MAX_GROUP = 8  # ops per call of the plain group executor
# The ``torch.profiler`` range around each op's build in the plain executor
# (the kernel evaluates the builds inside its one pass, as the TPU's does).
BUILD_RANGE = "scanline.build"


@dataclasses.dataclass(frozen=True)
class Op:
    """One fused scan.

    ``kind``: "sum" | "max" | "last" | "last2" | "delay" | "id" ("id" is an
    elementwise pass-through with no carry: it computes a derived stream
    once for later ops to read, and is not an output). ``build(env)``
    returns the op's input from ``env``, a mapping of the input streams and
    the outputs of earlier ops (by name): one stream for sum/max/delay, a
    (values, flags) pair for last/last2. A flag is set where it is > 0.
    ``init``: the "no previous value" default (last/last2/delay) or the
    floor of a max (sum always starts at 0). ``outs``: the output names,
    ``(name, name + "2")`` for last2 (the last and the second-to-last).
    """

    kind: str
    name: str
    build: Callable[[dict], object]
    init: int = 0

    @property
    def outs(self) -> tuple[str, ...]:
        if self.kind == "last2":
            return (self.name, self.name + "2")
        if self.kind == "id":
            return ()
        return (self.name,)


class _Pending(Exception):
    """A build read the output of an op whose scan has not run yet."""


class _Env(dict):
    """The streams a build reads; reading a pending op's output raises."""

    def __init__(self, inputs: dict):
        super().__init__(inputs)
        self.pending: set[str] = set()

    def __missing__(self, key):
        if key in self.pending:
            raise _Pending(key)
        raise KeyError(key)


def _as_stream(x, n: int, device) -> torch.Tensor:
    """A build's result as a contiguous stream of n values (a scalar is
    broadcast; a stream of another length raises)."""
    return torch.as_tensor(x, device=device).expand(n).contiguous()


def _build(op: Op, env: _Env, n: int, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The op's (value, flag) streams from ``env`` (flag None but for
    last/last2), inside the profiler range ``BUILD_RANGE``."""
    with torch.profiler.record_function(BUILD_RANGE):
        built = op.build(env)
        if op.kind in ("last", "last2"):
            value, flag = built
            return _as_stream(value, n, device), _as_stream(flag, n, device)
        value = _as_stream(built, n, device)
        return (value.to(torch.int32) if op.kind == "id" else value), None


def run_program(inputs: dict, ops: tuple[Op, ...], n: int, reverse: bool, execute) -> dict[str, torch.Tensor]:
    """Build and scan ``ops`` in order; ``execute(group, n, reverse)`` scans a
    list of (op, value, flag) whose inputs are built and returns their
    outputs by name. An op whose build reads a pending output starts a new
    group."""
    device = next(iter(inputs.values())).device
    env = _Env({k: v[:n] for k, v in inputs.items()})
    group: list[tuple[Op, torch.Tensor, torch.Tensor | None]] = []
    result: dict[str, torch.Tensor] = {}

    def flush():
        if group:
            outs = execute(group, n, reverse)
            env.update(outs)
            result.update(outs)
            group.clear()
            env.pending.clear()

    for op in ops:
        if op.kind not in KINDS:
            raise ValueError(f"unknown scan kind {op.kind!r}")
        try:
            value, flag = _build(op, env, n, device)
        except _Pending:
            flush()
            value, flag = _build(op, env, n, device)
        if op.kind == "id":
            env[op.name] = value
            continue
        group.append((op, value, flag))
        env.pending.update(op.outs)
        if len(group) == MAX_GROUP:
            flush()
    flush()
    return result


# ---------------------------------------------------------------------------
# Plain executor: the CPU path, and the comparison for the kernel
# ---------------------------------------------------------------------------

def last_index(flag: torch.Tensor) -> torch.Tensor:
    """Index of the last position <= i whose flag is > 0, else -1 (int64):
    the flagged positions, picked by the running count of flags (a cumsum
    and a gather; ``torch.cummax`` of the masked indices is the same
    function and some hundred times slower on a card)."""
    flagged = flag > 0
    at = torch.nonzero(flagged).flatten()
    if at.numel() == 0:
        return torch.full(flagged.shape, -1, dtype=torch.int64, device=flag.device)
    rank = torch.cumsum(flagged, 0, dtype=torch.int64)
    return torch.where(rank > 0, at[(rank - 1).clamp(min=0)], -1)


def _gather_or(values: torch.Tensor, idx: torch.Tensor, init: int) -> torch.Tensor:
    return torch.where(idx >= 0, values[idx.clamp(min=0)], init).to(torch.int32)


def _scan_plain(op: Op, value: torch.Tensor, flag: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    v = value.to(torch.int32)
    if op.kind == "sum":  # int32 wrap-around, as the kernel's
        return (torch.cumsum(v.to(torch.int64), 0).to(torch.int32),)
    if op.kind == "max":
        return (torch.cummax(v, 0).values.clamp(min=op.init) if v.numel() else v,)
    if op.kind == "delay":
        return (torch.cat([v.new_full((1,), op.init), v[:-1]]) if v.numel() else v,)
    last = last_index(flag)
    if op.kind == "last":
        return (_gather_or(v, last, op.init),)
    # last2: the flagged position before the last one is the last index
    # strictly before it.
    before = torch.cat([last.new_full((1,), -1), last[:-1]])
    second = torch.where(last >= 0, before[last.clamp(min=0)], -1)
    return _gather_or(v, last, op.init), _gather_or(v, second, op.init)


def scan_group_plain(group, n: int, reverse: bool) -> dict[str, torch.Tensor]:
    """Each op's scan in torch; a reversed scan runs over flipped streams."""
    out = {}
    for op, value, flag in group:
        if reverse:
            value = value.flip(0)
            flag = None if flag is None else flag.flip(0)
        for name, stream in zip(op.outs, _scan_plain(op, value, flag)):
            out[name] = stream.flip(0) if reverse else stream
    return out


def _only(result: dict[str, torch.Tensor], outputs) -> dict[str, torch.Tensor]:
    """The outputs named in ``outputs`` (all of them for None)."""
    if outputs is None:
        return result
    missing = set(outputs) - set(result)
    if missing:
        raise KeyError(f"fused_scan: no op makes the outputs {sorted(missing)}")
    return {name: stream for name, stream in result.items() if name in set(outputs)}


def fused_scan_plain(
    inputs: dict, ops: tuple[Op, ...], n: int, *, reverse: bool = False, outputs=None
) -> dict[str, torch.Tensor]:
    """``fused_scan`` by the plain executor, on any device."""
    return _only(run_program(inputs, ops, n, reverse, scan_group_plain), outputs)


def fused_scan(
    inputs: dict, ops: tuple[Op, ...], n: int, *, reverse: bool = False, outputs=None
) -> dict[str, torch.Tensor]:
    """Run the program ``ops`` over streams of n positions.

    ``inputs``: name -> stream (bool or integer; read up to n). Returns name
    -> int32[n] for every op output, or for those named in ``outputs`` (the
    kernel then writes only those). ``reverse=True`` computes suffix scans
    ("next value"): position n - 1 comes first. On a CUDA tensor the program
    runs in one launch of the kernel ``csrc/scanline.cu``; on a CPU tensor in
    the plain executor.
    """
    device = next(iter(inputs.values())).device
    if device.type == "cuda":
        from stringwars_tpu_torch.ops.scanline_cuda import fused_scan_kernel

        return fused_scan_kernel(inputs, ops, n, reverse, outputs)
    if device.type == "cpu":
        return fused_scan_plain(inputs, ops, n, reverse=reverse, outputs=outputs)
    raise ValueError(f"fused_scan runs on CUDA or CPU tensors, not {device}")


# ---------------------------------------------------------------------------
# Elementwise rule evaluator
# ---------------------------------------------------------------------------

# Rule function -> its CUDA launcher ``(streams, n) -> int32[n]``.
_KERNELS: dict[Callable, Callable] = {}


def register_kernel(fn: Callable, launcher: Callable) -> None:
    """Make ``elementwise_map(..., fn, ...)`` launch ``launcher`` on a card."""
    _KERNELS[fn] = launcher


def elementwise_map(inputs: dict, fn: Callable, n: int) -> torch.Tensor:
    """Evaluate ``fn(env) -> bool/int`` over named streams; returns int32[n].

    On the CPU, ``fn`` runs on the int32 streams; on a card, the kernel
    registered for ``fn`` runs, and a function without one raises."""
    device = next(iter(inputs.values())).device
    if device.type == "cuda":
        launcher = _KERNELS.get(fn)
        if launcher is None:
            raise ValueError(f"elementwise_map: no CUDA kernel is registered for {getattr(fn, '__qualname__', fn)}")
        return launcher(inputs, n)
    if device.type == "cpu":
        env = {k: v[:n].to(torch.int32) for k, v in inputs.items()}
        return _as_stream(fn(env), n, device).to(torch.int32)
    raise ValueError(f"elementwise_map runs on CUDA or CPU tensors, not {device}")
