"""Wrappers of the hand-written CUDA kernels in ``csrc/find.cu``.

The counterpart of ``stringwars_tpu.ops.find_pallas`` (its packed-word
count and its codepoint-window count, ``csrc/cpfind.cu``) and of the XLA
byteset count. Each wrapper checks its tensors, allocates the outputs,
launches on PyTorch's current stream without synchronizing, raises on a
CUDA launch error, and adds one to its entry of ``LAUNCHES``. A CPU tensor
raises: the plain versions live in ``ops/find.py``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.find import NeedleBatch, _cp_extent, _extent

# Launches of each kernel since process start (or the last reset).
LAUNCHES = {"find_count": 0, "rfind_count": 0, "byteset_count": 0, "cp_window": 0}


def _check_batch(hay: torch.Tensor, batch: NeedleBatch) -> None:
    images, lengths = batch.images, batch.lengths
    if images.device != hay.device or lengths.device != hay.device:
        raise ValueError(f"needles on {images.device}, haystack on {hay.device}")
    if images.dtype != torch.uint8 or images.dim() != 2 or not images.is_contiguous():
        raise ValueError("needle images must be a contiguous uint8 [B, S] tensor")
    if lengths.dtype != torch.int64 or lengths.shape != (batch.size,) or not lengths.is_contiguous():
        raise ValueError("needle lengths must be a contiguous int64 [B] tensor")
    if not (min(batch.host_lengths) >= 1 and max(batch.host_lengths) <= images.shape[1]):
        raise ValueError(f"needle lengths must lie in [1, {images.shape[1]}]")


def _launch(hay: torch.Tensor, batch: NeedleBatch, n: int | None, with_last: bool):
    build.require_cuda_bytes(hay, "find")
    n = _extent(hay, n)
    hay = build.aligned_bytes(hay, n)
    _check_batch(hay, batch)
    filters = batch.filters(hay.device)
    counts = torch.zeros(batch.size, dtype=torch.int64, device=hay.device)
    lasts = torch.full((batch.size,), -1, dtype=torch.int64, device=hay.device) if with_last else None
    lib = build.library()
    name = "rfind_count" if with_last else "find_count"
    with torch.cuda.device(hay.device):
        code = lib.sw_find_count(
            hay.data_ptr(), n, batch.images.data_ptr(), batch.images.shape[1], batch.size, filters.table.data_ptr(),
            filters.chunks, filters.filters, filters.bitmap_words, counts.data_ptr(),
            lasts.data_ptr() if with_last else None, build.stream_of(hay),
        )
    build.check(code, name)
    LAUNCHES[name] += 1
    return counts, lasts


def find_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> torch.Tensor:
    """int64[B] on the device: all-matches count of each needle in ``hay[:n]``.
    A haystack that does not start 16-byte aligned is copied once
    (``build.aligned_bytes``); the counts are the view's."""
    return _launch(hay, batch, n, with_last=False)[0]


def rfind_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None):
    """(counts, lasts), int64[B] each on the device: counts and the last
    match start of each needle in ``hay[:n]`` (-1 when none), relative to
    the view; an unaligned haystack is copied once, as ``find_count_batch``
    says."""
    return _launch(hay, batch, n, with_last=True)


def byteset_count(hay: torch.Tensor, table: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """int64[1] on the device: members of the set among ``hay[:n]``.
    ``table`` is the uint8[256] membership table of ``pack_byteset``."""
    build.require_cuda_bytes(hay, "byteset_count")
    n = _extent(hay, n)
    build.require_cuda_bytes(table, "byteset_count table")
    if table.shape != (256,) or table.device != hay.device:
        raise ValueError(f"expected a uint8[256] table on {hay.device}, got {tuple(table.shape)} on {table.device}")
    out = torch.zeros(1, dtype=torch.int64, device=hay.device)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(hay.device):
        code = lib.sw_byteset_count(hay.data_ptr(), n, table.data_ptr(), out.data_ptr(), build.stream_of(hay))
    build.check(code, "byteset_count")
    LAUNCHES["byteset_count"] += 1
    return out


def cp_window_count(stream: torch.Tensor, n: int, needle: torch.Tensor) -> torch.Tensor:
    """0-d int64 on the device: all (overlapping) matches of the int32
    ``needle`` in the int32 ``stream[:n]``."""
    if not isinstance(stream, torch.Tensor) or stream.device.type != "cuda":
        raise ValueError(f"cp_window: the CUDA kernel needs a CUDA tensor, got {getattr(stream, 'device', type(stream))}")
    n = _cp_extent(stream, n, needle)
    if not stream.is_contiguous() or not needle.is_contiguous():
        raise ValueError("cp_window: expected a contiguous stream and needle")
    count = torch.zeros(1, dtype=torch.int64, device=stream.device)
    if needle.numel() <= n:
        lib = build.library()
        with torch.cuda.device(stream.device):
            code = lib.sw_cp_window(stream.data_ptr(), n, needle.data_ptr(), needle.numel(), count.data_ptr(),
                                    build.stream_of(stream))
        build.check(code, "cp_window")
        LAUNCHES["cp_window"] += 1
    return count[0]
