"""Wrapper of the hand-written CUDA kernel in ``csrc/myers.cu``.

The counterpart of ``stringwars_tpu.ops.myers_pallas._myers``. The wrapper
checks the staged batch, allocates the output and the kernel's carry
scratch, launches on PyTorch's current stream without synchronizing,
raises on a CUDA launch error, and adds one to ``LAUNCHES``. A CPU batch
raises: the plain version is ``ops/myers.myers_plain``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.myers import SUPPORTED_NBITS, WORD, MyersBatch

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"myers": 0}


def _check(batch: MyersBatch) -> None:
    planes, text = batch.planes, batch.text
    if planes.device.type != "cuda":
        raise ValueError(f"myers: the CUDA kernel needs a CUDA tensor, got {planes.device}")
    B = batch.count
    if batch.nbits not in SUPPORTED_NBITS:
        raise ValueError(f"myers: nbits {batch.nbits} not in {SUPPORTED_NBITS}")
    if planes.dtype != torch.int64 or planes.dim() != 3 or planes.shape[1:] != (batch.nbits, B):
        raise ValueError(f"myers: planes must be int64[W, {batch.nbits}, {B}], got {planes.dtype} {tuple(planes.shape)}")
    if text.dtype != torch.int32 or text.dim() != 2 or text.shape[1] != B:
        raise ValueError(f"myers: text must be int32[L, {B}], got {text.dtype} {tuple(text.shape)}")
    for name, t in (("a_len", batch.a_len), ("b_len", batch.b_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"myers: {name} must be a contiguous int32[{B}] tensor")
    for t in (text, batch.a_len, batch.b_len):
        if t.device != planes.device:
            raise ValueError(f"myers: batch tensors on {t.device} and {planes.device}")
    if not (planes.is_contiguous() and text.is_contiguous()):
        raise ValueError("myers: planes and text must be contiguous")
    if B and (batch.host_a_len.max() > WORD * planes.shape[0] or batch.host_b_len.max() > text.shape[0]):
        raise ValueError("myers: a pair is longer than its staged planes or text")


def myers(batch: MyersBatch) -> torch.Tensor:
    """Levenshtein distance per pair by the CUDA kernel -> int32[count] on
    the device. Launches asynchronously on the current stream."""
    _check(batch)
    B = batch.count
    out = torch.empty(B, dtype=torch.int32, device=batch.device)
    if B == 0:
        return out
    groups = -(-batch.text.shape[0] // 32)
    carry = torch.empty(2 * groups * B, dtype=torch.int32, device=batch.device)  # u32 bit words
    lib = build.library()
    with torch.cuda.device(batch.device):
        code = lib.sw_myers(
            batch.planes.data_ptr(), batch.nbits, batch.text.data_ptr(), batch.a_len.data_ptr(),
            batch.b_len.data_ptr(), B, carry.data_ptr(), out.data_ptr(), build.stream_of(out),
        )
    build.check(code, "myers")
    LAUNCHES["myers"] += 1
    return out
