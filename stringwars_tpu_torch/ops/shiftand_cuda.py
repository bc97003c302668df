"""Wrapper of the hand-written CUDA kernel in ``csrc/shiftand.cu``.

The counterpart of ``stringwars_tpu.ops.shiftand._sa_scan``. The wrapper
checks its tensors, allocates the output, launches on PyTorch's current
stream without synchronizing, raises on a CUDA launch error, and adds one
to ``LAUNCHES``. A CPU tensor raises: the plain version is
``ops/shiftand.shiftand_count_plain``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.ahocorasick_cuda import check_chunk, kernel_chunk
from stringwars_tpu_torch.ops.find import _extent
from stringwars_tpu_torch.ops.shiftand import ShiftAndSet

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"shiftand": 0}


def shiftand_count(sa: ShiftAndSet, hay: torch.Tensor, n: int | None = None, *, chunk: int | None = None) -> torch.Tensor:
    """int64[1] on the device: occurrences of all patterns in ``hay[:n]``.
    ``chunk`` (see ``ahocorasick_cuda.check_chunk``) defaults to the
    wrapper's own choice. A haystack that does not start 16-byte aligned is
    copied once (``build.aligned_bytes``): the state runs from its first
    byte."""
    build.require_cuda_bytes(hay, "shiftand_count")
    n = _extent(hay, n)
    hay = build.aligned_bytes(hay, n)
    chunk = kernel_chunk(sa.max_len) if chunk is None else check_chunk(chunk, "shiftand_count")
    out = torch.zeros(1, dtype=torch.int64, device=hay.device)
    if n == 0:
        return out
    table, _ = sa.tables(hay.device)
    lib = build.library()
    with torch.cuda.device(hay.device):
        code = lib.sw_shiftand(
            hay.data_ptr(), n, table.data_ptr(), sa.n_words, chunk, sa.max_len - 1, out.data_ptr(), build.stream_of(hay)
        )
    build.check(code, "shiftand")
    LAUNCHES["shiftand"] += 1
    return out
