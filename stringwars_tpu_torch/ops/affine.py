"""Gotoh affine-gap and linear-gap alignment scores (family K5 fast path).

The counterpart of ``stringwars_tpu.ops.affine_pallas``: Needleman-Wunsch
(global) or Smith-Waterman (``local=True``) scores per pair, with the
conventions of ``ops/similarity.py`` (match/mismatch substitution, the
first gap char costs ``gap_open``, each further char ``gap_extend``;
``gap_open == gap_extend`` is the linear model and takes the kernel's
linear body). Reference engines: ``szs::NeedlemanWunschScores`` /
``SmithWatermanScores``, ``similarities/bench.rs:348-362``.

An ``AffineBatch`` keeps the ``PairBatch``: the kernel reads the pairs'
own rows (``int32[B, L]``; a lane group per pair, each lane a strip of
a's rows), and the plain version the same tensors. ``group_shape`` picks
the kernel's lanes per pair and strip height for a batch. A CUDA batch
goes to the kernel ``csrc/affine.cu`` (``ops/affine_cuda.py``); a CPU
batch to the plain version, ``similarity._score_scan`` on the same pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops import similarity as S


# Lanes per pair and strip heights (kRows) the kernel is built for, and the
# warps a batch should give each SM of the card before the group narrows.
# A CPU batch is shaped as for an H100 SXM's 132 SMs.
LANE_GROUPS = (8, 16, 32)
STRIP_ROWS = (8, 16)
WARPS_PER_SM = 12
H100_SMS = 132


def group_shape(max_a: int, pairs: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(lanes per pair, strip height) of the alignment kernel for a batch of
    ``pairs`` pairs whose longest a has ``max_a`` chars, on a card of ``sms``
    SMs: the narrowest group that still gives each SM ``WARPS_PER_SM``
    warps, widened while a lane's strip would pass the tallest strip; then
    the lowest strip that holds a lane's share of the longest a (a longer a
    takes several passes)."""
    group = next((g for g in LANE_GROUPS if pairs * g >= WARPS_PER_SM * sms * 32), LANE_GROUPS[-1])
    while group < LANE_GROUPS[-1] and -(-max_a // group) > STRIP_ROWS[-1]:
        group *= 2
    share = -(-max(max_a, 1) // group)
    return group, next((r for r in STRIP_ROWS if r >= share), STRIP_ROWS[-1])


@dataclasses.dataclass(frozen=True)
class AffineBatch:
    """Pairs staged for the alignment kernel."""

    pairs: S.PairBatch  # a, b: int32[B, L], read by the kernel as they are
    host_a_len: np.ndarray  # int64[B], for the launch shape and work accounting
    host_b_len: np.ndarray

    @property
    def count(self) -> int:
        return self.pairs.a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pairs.device

    def cells(self) -> int:
        return int((self.host_a_len * self.host_b_len).sum())

    def shape(self) -> tuple[int, int]:
        """The kernel's (lanes per pair, strip height) for this batch on its
        card."""
        sms = build.sm_count(self.device) if self.device.type == "cuda" else H100_SMS
        return group_shape(int(self.host_a_len.max(initial=0)), self.count, sms)

    @classmethod
    def from_pairs(cls, pairs: S.PairBatch) -> "AffineBatch":
        return cls(
            pairs=S.PairBatch(pairs.a.contiguous(), pairs.b.contiguous(), pairs.a_len, pairs.b_len),
            host_a_len=pairs.a_len.cpu().numpy().astype(np.int64),
            host_b_len=pairs.b_len.cpu().numpy().astype(np.int64),
        )


def affine_from_tokens(a_tokens: list[bytes], b_tokens: list[bytes], *, device=None) -> AffineBatch:
    """Byte-level staging from token lists."""
    return AffineBatch.from_pairs(S.pack_pairs(a_tokens, b_tokens, device=device))


def affine_scores(
    batch: AffineBatch,
    match: int = 2,
    mismatch: int = -1,
    gap_open: int = -5,
    gap_extend: int = -1,
    *,
    local: bool = False,
) -> torch.Tensor:
    """NW (or SW with ``local=True``) score per pair -> int32[count] on the
    batch's device. Local scores floor at 0 (the empty alignment): both
    routes start their running maximum there."""
    if batch.device.type == "cuda":
        from stringwars_tpu_torch.ops import affine_cuda

        return affine_cuda.align(batch, match, mismatch, gap_open, gap_extend, local=local)
    if batch.device.type == "cpu":
        return S._score_scan(batch.pairs, match, mismatch, gap_open, gap_extend, local=local)
    raise ValueError(f"affine_scores runs on a CUDA or CPU batch, not {batch.device}")
