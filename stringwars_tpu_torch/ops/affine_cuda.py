"""Wrapper of the hand-written CUDA kernel in ``csrc/affine.cu``.

The counterpart of ``stringwars_tpu.ops.affine_pallas._affine``, with its
two bodies: Gotoh affine (three DP matrices) and linear (one), each global
or local. The wrapper checks the staged batch, picks the kernel's lanes per
pair and strip height (``AffineBatch.shape``), allocates the output and,
for pairs that take several passes, the scratch row between passes,
launches on PyTorch's current stream without synchronizing, raises on a
CUDA launch error, and adds one to the entry of ``LAUNCHES`` of the body it
ran. A CPU batch raises: the plain version is
``ops/similarity._score_scan``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.affine import AffineBatch

# Launches of each body since process start (or the last reset).
LAUNCHES = {"affine": 0, "linear": 0}


def _check(batch: AffineBatch) -> None:
    a, b = batch.pairs.a, batch.pairs.b
    if a.device.type != "cuda":
        raise ValueError(f"align: the CUDA kernel needs a CUDA tensor, got {a.device}")
    B = batch.count
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != a.shape or not t.is_contiguous():
            raise ValueError(
                f"align: pairs.{name} must be a contiguous int32[{B}, L], got {t.dtype} {tuple(t.shape)}"
            )
    for name, t in (("a_len", batch.pairs.a_len), ("b_len", batch.pairs.b_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"align: {name} must be a contiguous int32[{B}] tensor")
    for t in (b, batch.pairs.a_len, batch.pairs.b_len):
        if t.device != a.device:
            raise ValueError(f"align: batch tensors on {t.device} and {a.device}")
    if B and (batch.host_a_len.max() > a.shape[1] or batch.host_b_len.max() > a.shape[1]):
        raise ValueError("align: a pair is longer than its staged rows")


def align(batch: AffineBatch, match: int, mismatch: int, gap_open: int, gap_extend: int, *, local: bool) -> torch.Tensor:
    """NW or SW score per pair by the CUDA kernel -> int32[count] on the
    device; ``gap_open == gap_extend`` runs the linear body."""
    _check(batch)
    B = batch.count
    body = "linear" if gap_open == gap_extend else "affine"
    out = torch.empty(B, dtype=torch.int32, device=batch.device)
    if B == 0:
        return out
    group, rows = batch.shape()
    width = batch.pairs.a.shape[1]
    scratch = None
    if batch.host_a_len.max() > group * rows:  # several passes: the row between them
        scratch = torch.empty(B * 2 * (width + 1), dtype=torch.int32, device=batch.device)
    lib = build.library()
    with torch.cuda.device(batch.device):
        code = lib.sw_align(
            batch.pairs.a.data_ptr(), batch.pairs.b.data_ptr(), width, batch.pairs.a_len.data_ptr(),
            batch.pairs.b_len.data_ptr(), B, group, rows, int(match), int(mismatch), int(gap_open), int(gap_extend),
            int(body == "affine"), int(local), 0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
            build.stream_of(out),
        )
    build.check(code, body)
    LAUNCHES[body] += 1
    return out
