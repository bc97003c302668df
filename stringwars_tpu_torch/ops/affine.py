"""Gotoh affine-gap and linear-gap alignment scores (family K5 fast path).

The counterpart of ``stringwars_tpu.ops.affine_pallas``: Needleman-Wunsch
(global) or Smith-Waterman (``local=True``) scores per pair, with the
conventions of ``ops/similarity.py`` (match/mismatch substitution, the
first gap char costs ``gap_open``, each further char ``gap_extend``;
``gap_open == gap_extend`` is the linear model and takes the kernel's
linear body). Reference engines: ``szs::NeedlemanWunschScores`` /
``SmithWatermanScores``, ``similarities/bench.rs:348-362``.

An ``AffineBatch`` keeps the ``PairBatch`` (for the plain version) and the
characters transposed to ``int32[L, B]`` (for the kernel, whose threads own
one pair each and read neighbouring pairs' characters together). A CUDA
batch goes to the kernel ``csrc/affine.cu`` (``ops/affine_cuda.py``); a CPU
batch to the plain version, ``similarity._score_scan`` on the same pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stringwars_tpu_torch.ops import similarity as S


@dataclasses.dataclass(frozen=True)
class AffineBatch:
    """Pairs staged for the alignment kernel."""

    pairs: S.PairBatch
    a_cols: torch.Tensor  # int32[L, B]: a_cols[i, p] = a_p[i]
    b_cols: torch.Tensor  # int32[L, B]
    host_a_len: np.ndarray  # int64[B], for work accounting
    host_b_len: np.ndarray

    @property
    def count(self) -> int:
        return self.pairs.a.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pairs.device

    def cells(self) -> int:
        return int((self.host_a_len * self.host_b_len).sum())

    @classmethod
    def from_pairs(cls, pairs: S.PairBatch) -> "AffineBatch":
        return cls(
            pairs=pairs,
            a_cols=pairs.a.t().contiguous(),
            b_cols=pairs.b.t().contiguous(),
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
