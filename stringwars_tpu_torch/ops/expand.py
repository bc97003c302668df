"""Fused expand-and-compact: case fold (and, later, decomposition) rows (K10).

The port of ``stringwars_tpu.ops.casefold_pallas``. One kernel owns the
"map each element to 1..N outputs and compact" shape shared by the full
case fold and NFD/NFKD decomposition, over rows of ``group`` (32 or 64)
elements:

1. for UTF-8 rows, decode at lead bytes from the next three bytes of the
   row (0 past it); a lead is a non-continuation byte below the row's
   length, and a byte from 0xF0 up decodes as four bytes;
2. the 1 -> N map as two or three table lookups at the codepoint clamped to
   the table: ``T1[cp] = (v0 - cp) & 0xFFFF | length << 16`` (v0: the mapped
   codepoint or the first expansion codepoint), ``T2[cp] = e2 | e3 << 16``,
   ``T3[cp] = e4``;
3. an in-row prefix sum of the lengths;
4. compaction: output slot d of a row holds channel ``d - start`` of the
   element whose span covers d (channel 0 where that exceeds ``max_exp - 1``),
   zeros from the row's total on; ``counts`` holds the totals.

The output is ``[B, max_exp * group]`` int32, slot-major as the JAX kernel's
planes concatenated. On the TPU, step 2 splits the tables into 128-lane
windows with a deduplicated page map, step 4 binary-searches each slot's
source lane: ways around its gathers. Here a table is one dense int32 array
(``ExpandTables``), read through the read-only cache by ``csrc/expand.cu``
(one warp per row, ``ops/expand_cuda.py``); ``expand_compact_rows_plain``
gives the same semantics in torch ops. ``prepare_tables`` keeps the JAX
padding (to a multiple of 128 entries: T1 with the identity ``1 << 16``,
the others with zeros), since a clamped lookup reads it.

``fold_tokens_fused`` folds width-32 ``PaddedTokens`` of a BMP corpus;
other widths and ceilings above 0xFFFF go to ``casefold.fold_tokens``, by
shape, as in the JAX function.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

GROUP = 32  # fold token width = elements per row
MAX_EXP = 4  # outputs per element the kernel holds (UAX#15's NFD maximum)
GROUPS = (32, 64)


@dataclasses.dataclass(frozen=True)
class ExpandTables:
    """T1 and up to two more dense int32 tables, padded to one size."""

    tables: tuple[np.ndarray, ...]
    # The tables staged per device, kept on the object (they live as long as it).
    staged: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(self.tables[0].shape[0])

    def on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The tables as contiguous int32 tensors on ``device``."""
        device = torch.device(device)
        if device not in self.staged:
            self.staged[device] = tuple(torch.from_numpy(t.copy()).to(device) for t in self.tables)
        return self.staged[device]


def prepare_tables(t1: np.ndarray, *more: np.ndarray) -> ExpandTables:
    """Pad dense int32 tables (T1 [, T2 [, T3]]) to a multiple of 128
    entries: T1 with ``1 << 16`` (the identity, length 1), the others with 0."""
    if not 0 <= len(more) <= 2:
        raise ValueError(f"expected T1 and at most two more tables, got {1 + len(more)}")
    size = t1.shape[0]
    if any(t.shape != (size,) for t in more) or t1.ndim != 1 or size == 0:
        raise ValueError(f"expected 1-D tables of one non-zero size, got {[t.shape for t in (t1, *more)]}")
    padded_size = -(-size // 128) * 128
    pad1 = np.full(padded_size, 1 << 16, np.int32)
    pad1[:size] = t1
    padded = [pad1]
    for t in more:
        p = np.zeros(padded_size, np.int32)
        p[:size] = t
        padded.append(p)
    for p in padded:
        p.setflags(write=False)
    return ExpandTables(tuple(padded))


@functools.lru_cache(maxsize=None)
def fold_tables(max_cp: int) -> ExpandTables:
    """The fold's (T1, T2) over ``[0, max_cp]`` (BMP corpora)."""
    from stringwars_tpu_torch.ops.casefold import _fold_arrays

    inline, multi, pool = _fold_arrays()
    size = max_cp + 1
    cps = np.arange(size, dtype=np.int64)
    inl = inline[:size].astype(np.int64)
    mul = multi[:size].astype(np.int64)
    is_multi = inl < 0
    length = np.where(is_multi, mul & 31, 1)
    off = mul >> 5
    e1 = pool[np.clip(off, 0, pool.shape[0] - 1)]
    e2 = np.where(length >= 2, pool[np.clip(off + 1, 0, pool.shape[0] - 1)], 0)
    e3 = np.where(length >= 3, pool[np.clip(off + 2, 0, pool.shape[0] - 1)], 0)
    v0 = np.where(is_multi, e1, inl)
    t1 = (((v0 - cps) & 0xFFFF) | (length << 16)).astype(np.int32)
    t2 = (e2 | (e3 << 16)).astype(np.int32)
    return prepare_tables(t1, t2)


def _check(data: torch.Tensor, lengths: torch.Tensor, tables: ExpandTables, max_exp: int, group: int, utf8: bool) -> None:
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")
    if not 1 <= max_exp <= MAX_EXP:
        raise ValueError(f"max_exp must lie in [1, {MAX_EXP}], got {max_exp}")
    want = torch.uint8 if utf8 else torch.int32
    if data.dim() != 2 or data.shape[1] != group or data.dtype != want:
        raise ValueError(f"expected {want} rows of {group}, got {data.dtype}{tuple(data.shape)}")
    if lengths.shape != (data.shape[0],) or lengths.device != data.device:
        raise ValueError(f"expected {data.shape[0]} lengths on {data.device}, got {tuple(lengths.shape)} on {lengths.device}")
    if not isinstance(tables, ExpandTables):
        raise ValueError(f"expected the ExpandTables of prepare_tables, got {type(tables).__name__}")


def _decode(data: torch.Tensor, lengths: torch.Tensor, utf8: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(cp, is_lead) per element of ``[B, group]`` rows, as the kernel decodes."""
    b = data.to(torch.int32)
    group = b.shape[1]
    valid = torch.arange(group, device=b.device)[None, :] < lengths.to(torch.int32)[:, None]
    if not utf8:
        return b, valid

    def nxt(k):
        return torch.nn.functional.pad(b[:, k:], (0, k)) & 0x3F

    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    is_lead = ((b & 0xC0) != 0x80) & valid
    w2 = (b >= 0xC0) & (b < 0xE0)
    w3 = (b >= 0xE0) & (b < 0xF0)
    w4 = b >= 0xF0
    cp = torch.where(
        w2, ((b & 0x1F) << 6) | b1,
        torch.where(w3, ((b & 0x0F) << 12) | (b1 << 6) | b2, torch.where(w4, ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3, b)),
    )
    return cp, is_lead


def expand_compact_rows_plain(data, lengths, tables: ExpandTables, max_exp: int, group: int, utf8: bool):
    """The kernel's semantics in torch ops: ``(out int32[B, max_exp * group],
    counts int32[B])`` (see the module docstring)."""
    _check(data, lengths, tables, max_exp, group, utf8)
    cp, is_lead = _decode(data, lengths, utf8)
    ts = tables.on(data.device)
    idx = cp.clamp(0, tables.size - 1).to(torch.int64)
    t1 = ts[0][idx]
    t2 = ts[1][idx] if len(ts) >= 2 else torch.zeros_like(t1)
    t3 = ts[2][idx] if len(ts) >= 3 else torch.zeros_like(t1)
    delta = ((t1 & 0xFFFF) ^ 0x8000) - 0x8000  # the low half, sign-extended
    mlen = (t1 >> 16) & 0xFFFF  # the high half, unsigned
    chans = [(cp + delta) & 0xFFFF, t2 & 0xFFFF, (t2 >> 16) & 0xFFFF, t3 & 0xFFFF][:max(max_exp, 1)]
    length = torch.where(is_lead, mlen, 0)
    csum = torch.cumsum(length, 1, dtype=torch.int32)
    starts = csum - length
    total = csum[:, -1]
    B, width = data.shape[0], max_exp * group
    if B == 0:
        return torch.zeros((0, width), dtype=torch.int32, device=data.device), total
    slots = torch.arange(width, dtype=torch.int32, device=data.device).expand(B, width).contiguous()
    # The source element of slot d: the first whose inclusive sum exceeds d.
    src = torch.searchsorted(csum.contiguous(), slots, right=True).clamp(max=group - 1)
    ch = slots - starts.gather(1, src)
    val = chans[0].gather(1, src)
    for c in range(1, max_exp):
        val = torch.where(ch == c, chans[c].gather(1, src), val)
    return torch.where(slots < total[:, None], val, 0), total


def expand_compact_rows(data, lengths, tables: ExpandTables, max_exp: int, group: int, utf8: bool):
    """``(out int32[B, max_exp * group], counts int32[B])`` over ``[B, group]``
    rows (uint8 UTF-8 when ``utf8``, else int32 codepoints) and their lengths
    (each at most ``group``): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if data.device.type == "cuda":
        from stringwars_tpu_torch.ops import expand_cuda

        return expand_cuda.expand_compact_rows(data, lengths, tables, max_exp, group, utf8)
    if data.device.type == "cpu":
        return expand_compact_rows_plain(data, lengths, tables, max_exp, group, utf8)
    raise ValueError(f"expand_compact_rows runs on a CUDA or CPU tensor, not {data.device}")


def fold_tokens_fused(tokens, max_cp: int):
    """Full case fold of width-32 ``PaddedTokens`` of a corpus whose
    codepoints are at most ``max_cp``: ``(folded int32[B, max_exp * 32],
    counts int32[B])``, the contract of ``casefold.fold_tokens``. Other
    widths and ceilings above 0xFFFF take ``fold_tokens``."""
    from stringwars_tpu_torch.ops.casefold import _fold_rules, fold_tokens

    *_, max_exp = _fold_rules(max_cp)
    if tokens.data.shape[1] != GROUP or max_cp > 0xFFFF:
        return fold_tokens(tokens, max_cp=max_cp)
    lengths = tokens.lengths.to(torch.int32)
    return expand_compact_rows(tokens.data, lengths, fold_tables(max_cp), max(max_exp, 1), GROUP, True)
