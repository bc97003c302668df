"""Unicode table maps: step functions and range rules (K9/K10).

The port of ``stringwars_tpu.ops.rulemap``. The host side is the JAX
package's, array for array:

- ``StepRules`` / ``compile_steps`` / ``expand_steps``: a dense class table
  as its run boundaries, ``value(cp) = sum(deltas[starts <= cp])``;
  ``prune(max_cp)`` keeps the boundaries a corpus' codepoint ceiling can
  reach; ``StepRules.from_numpy`` carries the JAX package's rules across.
- ``FoldRules`` / ``compile_fold`` / ``compile_sparse_values``: range rules
  for sparse delta and value maps (case folding and friends);
  ``FoldRules.from_numpy`` carries the JAX package's rules across.

On the TPU, ``step_map`` walks the boundaries in a Pallas kernel or, when the
table is small, takes the lane-gather LUT of ``ops/lut.py``: both avoid
XLA's near-scalar gathers. Here ``step_map`` always expands the rules to the
dense table at the pruned size (the JAX LUT route, ``rulemap.py:288-298``)
and looks it up with ``ops/lut.class_map``: the CUDA kernel
``csrc/classmap.cu`` on a card, a plain gather on the CPU. Codepoints past
the table are clamped, which is exact for a step function (constant past
its last boundary) and is what the TPU kernels do; the JAX package's CPU
gather instead reads a fill value past the end.

``range_map`` evaluates range rules, ``cp * [base == 0] + sum of the deltas
of the rules that match cp``. On the TPU it walks the rules in a Pallas
kernel (``_range_kernel``) or, when the table is small, takes the lane LUT
over the dense delta table (``rulemap.py:326-342``); both avoid slow gathers.
Here it reads the dense table of ``dense_delta_table`` once per codepoint:
the CUDA kernel ``sw_range_map`` of ``csrc/classmap.cu`` on a card (the add
of ``cp`` fused), ``range_map_plain`` (the rule walk of the JAX CPU route,
an oracle independent of the table) on the CPU. The table's last entry
carries no rule, so a codepoint past it reads 0, as the rule walk gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stringwars_tpu_torch.ops.lut import class_map, range_map_cuda, stage_table

MAX_CP = 0x110000


@dataclasses.dataclass(frozen=True)
class StepRules:
    """A dense int table compiled to its step-function boundaries."""

    starts: np.ndarray  # int32 [R] ascending; starts[0] == 0
    deltas: np.ndarray  # int32 [R]; value(cp) = sum(deltas[starts <= cp])

    @classmethod
    def from_numpy(cls, starts, deltas) -> "StepRules":
        """Rules from the JAX package's (or any) starts and deltas arrays."""
        starts = np.asarray(starts, np.int32)
        deltas = np.asarray(deltas, np.int32)
        if starts.shape != deltas.shape or starts.ndim != 1:
            raise ValueError(f"starts and deltas must be 1-D of one length, got {starts.shape} and {deltas.shape}")
        return cls(starts, deltas)

    @property
    def count(self) -> int:
        return int(self.starts.shape[0])

    @property
    def size(self) -> int:
        """Entries of the dense table that reaches the last boundary."""
        return int(self.starts[-1]) + 1 if self.count else 1

    def prune(self, max_cp: int) -> "StepRules":
        """Keep only boundaries reachable by cp <= max_cp (staging-time
        specialization; caller guarantees the bound)."""
        keep = self.starts <= max_cp
        return StepRules(self.starts[keep], self.deltas[keep])


def compile_steps(table: np.ndarray) -> StepRules:
    """Compile a dense cp->value table into step boundaries."""
    t = np.asarray(table, np.int64)
    change = np.flatnonzero(t[1:] != t[:-1]) + 1
    starts = np.concatenate([[0], change]).astype(np.int32)
    values = t[starts]
    deltas = np.diff(values, prepend=0).astype(np.int32)
    return StepRules(starts=starts, deltas=deltas)


def expand_steps(rules: StepRules, size: int = MAX_CP) -> np.ndarray:
    """Reconstruct the dense table over [0, size)."""
    table = np.zeros(size, np.int64)
    keep = rules.starts < size
    table[rules.starts[keep]] = rules.deltas[keep]
    return np.cumsum(table).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class FoldRules:
    """Range rules for a sparse delta map (case folding and friends).

    Rule r adds ``delta_r`` where ``lo_r <= cp <= hi_r`` and
    ``cp & pmask_r == par_r`` (pmask 0 = any parity, 1 = alternating
    blocks that map every second codepoint)."""

    lo: np.ndarray
    hi: np.ndarray
    delta: np.ndarray
    pmask: np.ndarray
    par: np.ndarray
    base: int = 0  # 0: out = cp + acc (delta map); 1: out = acc (value map)
    # The dense table staged per device by ``range_map``; kept on the object,
    # so that it lives exactly as long as the rules.
    staged: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_numpy(cls, lo, hi, delta, pmask, par, base: int = 0) -> "FoldRules":
        """Rules from the JAX package's (or any) five rule arrays and base."""
        arrays = [np.asarray(a, np.int32) for a in (lo, hi, delta, pmask, par)]
        if any(a.ndim != 1 or a.shape != arrays[0].shape for a in arrays):
            raise ValueError(f"expected five 1-D rule arrays of one length, got {[a.shape for a in arrays]}")
        if base not in (0, 1):
            raise ValueError(f"base must be 0 (delta map) or 1 (value map), got {base}")
        return cls(*arrays, base=int(base))

    @property
    def count(self) -> int:
        return int(self.lo.shape[0])

    def prune(self, max_cp: int) -> "FoldRules":
        keep = self.lo <= max_cp
        return FoldRules(
            self.lo[keep], self.hi[keep], self.delta[keep],
            self.pmask[keep], self.par[keep], self.base,
        )


def _i32(values) -> np.ndarray:
    return np.asarray(values, np.int32)


def compile_fold(table: np.ndarray) -> FoldRules:
    """Compile a mostly-identity cp->cp map into range delta rules.

    Detects stride-1 and stride-2 (alternating) constant-delta runs;
    entries with ``table[cp] < 0`` (escape markers) are treated as
    identity here — callers handle them through a separate value map.
    """
    t = np.asarray(table, np.int64)
    cps = np.arange(t.shape[0], dtype=np.int64)
    active = (t >= 0) & (t != cps)
    idx = np.flatnonzero(active)
    delta = (t[idx] - idx).astype(np.int64)
    lo, hi, dv, pm, pr = [], [], [], [], []
    i = 0
    while i < idx.size:
        j = i
        while j + 1 < idx.size and idx[j + 1] == idx[j] + 1 and delta[j + 1] == delta[i]:
            j += 1
        k = i
        while k + 1 < idx.size and idx[k + 1] == idx[k] + 2 and delta[k + 1] == delta[i]:
            k += 1
        if (k - i) > (j - i):
            lo.append(idx[i]); hi.append(idx[k]); dv.append(delta[i])  # noqa: E702
            pm.append(1); pr.append(int(idx[i]) & 1)  # noqa: E702
            i = k + 1
        else:
            lo.append(idx[i]); hi.append(idx[j]); dv.append(delta[i])  # noqa: E702
            pm.append(0); pr.append(0)  # noqa: E702
            i = j + 1
    return FoldRules(_i32(lo), _i32(hi), _i32(dv), _i32(pm), _i32(pr))


def compile_sparse_values(keys: np.ndarray, values: np.ndarray) -> FoldRules:
    """Singleton value map (cp -> value, 0 elsewhere) as equality rules,
    merging consecutive-key constant-value runs."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    order = np.argsort(keys)
    keys, values = keys[order], values[order]
    lo, hi, dv = [], [], []
    i = 0
    while i < keys.size:
        j = i
        while j + 1 < keys.size and keys[j + 1] == keys[j] + 1 and values[j + 1] == values[i]:
            j += 1
        lo.append(keys[i]); hi.append(keys[j]); dv.append(values[i])  # noqa: E702
        i = j + 1
    z = np.zeros(len(lo), np.int32)
    return FoldRules(_i32(lo), _i32(hi), _i32(dv), z, z.copy(), base=1)


def step_map(cps: torch.Tensor, rules: StepRules, table=None) -> torch.Tensor:
    """Evaluate a compiled step table over any-shape int codepoints, int32.

    ``table``: the dense table staged on the codepoints' device
    (``lut.stage_table``), of which the first ``rules.size`` entries are
    read; without it the rules are expanded.
    """
    size = rules.size
    dense = stage_table(expand_steps(rules, size), cps.device) if table is None else table[:size]
    return class_map(cps, dense)


def dense_delta_table(rules: FoldRules) -> np.ndarray:
    """Dense int32 delta (or value) table over ``[0, hi.max() + 2)``: entry
    ``cp`` is the sum of the deltas of the rules that match ``cp``. The last
    entry matches no rule, so a lookup clamped to the table reads 0 past it."""
    if rules.count == 0:
        raise ValueError("a fully pruned rule set has no table")
    size = int(rules.hi.max()) + 2
    t = np.zeros(size, np.int64)
    for r in range(rules.count):
        seg = np.arange(int(rules.lo[r]), int(rules.hi[r]) + 1, dtype=np.int64)
        pm = int(rules.pmask[r])
        if pm:
            seg = seg[(seg & pm) == int(rules.par[r])]
        t[seg] += int(rules.delta[r])
    return t.astype(np.int32)


def range_map_plain(cps: torch.Tensor, rules: FoldRules) -> torch.Tensor:
    """The rules walked over any-shape codepoints, int32 (the JAX package's
    CPU route, ``rulemap.py:316-325``): the oracle for the table. Every rule
    is tested against a slice of the codepoints at once, in slices of about
    16 M (codepoint, rule) pairs, so the walk takes a few large tensor ops
    rather than several per rule."""
    flat = cps.reshape(-1).to(torch.int32)
    acc = torch.zeros_like(flat)
    if rules.count:
        lo, hi, delta, pmask, par = (
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(flat.device)
            for a in (rules.lo, rules.hi, rules.delta, rules.pmask, rules.par)
        )
        step = max(1, (1 << 24) // rules.count)
        for i in range(0, flat.numel(), step):
            x = flat[i : i + step, None]
            ok = (x >= lo) & (x <= hi) & ((x & pmask) == par)
            acc[i : i + step] = torch.where(ok, delta, 0).sum(1, dtype=torch.int32)
    return (flat + acc if rules.base == 0 else acc).view(cps.shape)


def range_map(cps: torch.Tensor, rules: FoldRules) -> torch.Tensor:
    """Evaluate range rules over any-shape codepoints, int32: a delta map
    (``cp`` plus the matching deltas) when ``rules.base == 0``, a sparse value
    map (the deltas alone) when 1. The kernel over the dense table for a CUDA
    tensor, the rule walk for a CPU tensor."""
    if rules.count == 0:  # pruned below every rule: nothing matches
        cps = cps.to(torch.int32)
        return cps.clone() if rules.base == 0 else torch.zeros_like(cps)
    if cps.device.type == "cpu":
        return range_map_plain(cps, rules)
    if cps.device.type != "cuda":
        raise ValueError(f"range_map runs on a CUDA or CPU tensor, not {cps.device}")
    table = rules.staged.get(cps.device)
    if table is None:
        table = torch.from_numpy(dense_delta_table(rules)).to(cps.device)
        rules.staged[cps.device] = table
    return range_map_cuda(cps, table, add_base=rules.base == 0)
