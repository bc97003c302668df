"""Wrapper of the hand-written CUDA kernel in ``csrc/affine.cu``.

The counterpart of ``stringwars_tpu.ops.affine_pallas._affine``, with its
two bodies: Gotoh affine (three DP matrices) and linear (one), each global
or local. The wrapper checks the staged batch, allocates the output and the
kernel's scratch rows, launches on PyTorch's current stream without
synchronizing, raises on a CUDA launch error, and adds one to the entry of
``LAUNCHES`` of the body it ran. A CPU batch raises: the plain version is
``ops/similarity._score_scan``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.affine import AffineBatch

# Launches of each body since process start (or the last reset).
LAUNCHES = {"affine": 0, "linear": 0}


def _check(batch: AffineBatch) -> None:
    a_cols, b_cols = batch.a_cols, batch.b_cols
    if a_cols.device.type != "cuda":
        raise ValueError(f"align: the CUDA kernel needs a CUDA tensor, got {a_cols.device}")
    B = batch.count
    for name, t in (("a_cols", a_cols), ("b_cols", b_cols)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != B or not t.is_contiguous():
            raise ValueError(f"align: {name} must be a contiguous int32[L, {B}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("a_len", batch.pairs.a_len), ("b_len", batch.pairs.b_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"align: {name} must be a contiguous int32[{B}] tensor")
    for t in (b_cols, batch.pairs.a_len, batch.pairs.b_len):
        if t.device != a_cols.device:
            raise ValueError(f"align: batch tensors on {t.device} and {a_cols.device}")
    if B and (batch.host_a_len.max() > a_cols.shape[0] or batch.host_b_len.max() > b_cols.shape[0]):
        raise ValueError("align: a pair is longer than its staged columns")


def align(batch: AffineBatch, match: int, mismatch: int, gap_open: int, gap_extend: int, *, local: bool) -> torch.Tensor:
    """NW or SW score per pair by the CUDA kernel -> int32[count] on the
    device; ``gap_open == gap_extend`` runs the linear body."""
    _check(batch)
    B = batch.count
    body = "linear" if gap_open == gap_extend else "affine"
    out = torch.empty(B, dtype=torch.int32, device=batch.device)
    if B == 0:
        return out
    rows = (batch.b_cols.shape[0] + 1) * B
    row_h = torch.empty(rows, dtype=torch.int32, device=batch.device)
    row_v = torch.empty(rows if body == "affine" else 1, dtype=torch.int32, device=batch.device)
    lib = build.library()
    with torch.cuda.device(batch.device):
        code = lib.sw_align(
            batch.a_cols.data_ptr(), batch.b_cols.data_ptr(), batch.pairs.a_len.data_ptr(),
            batch.pairs.b_len.data_ptr(), B, int(match), int(mismatch), int(gap_open), int(gap_extend),
            int(body == "affine"), int(local), row_h.data_ptr(), row_v.data_ptr(), out.data_ptr(),
            build.stream_of(out),
        )
    build.check(code, body)
    LAUNCHES[body] += 1
    return out
