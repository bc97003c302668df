"""Bytesum: the exact sum of a corpus's bytes, and the card's bandwidth probe.

The port of ``stringwars_tpu.ops.bytesum``. One read of every byte with
almost no arithmetic makes it the speed-of-light row: ``measured_roofline``
(``utils/profiler.py``) times it on the card, and every device row's
"% SoL" column is reported against that rate.

``bytesum_plain`` is the plain torch version; ``bytesum_cuda`` launches the
hand-written kernel ``csrc/bytesum.cu``; ``bytesum`` takes the kernel for a
CUDA tensor and the plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.tape import Tape

# Launches of csrc/bytesum.cu since process start (or the last reset).
LAUNCHES = {"bytesum": 0}


def _extent(data: torch.Tensor, n: int | None) -> int:
    if data.dim() != 1:
        raise ValueError(f"expected a 1-D byte tensor, got shape {tuple(data.shape)}")
    n = data.numel() if n is None else int(n)
    if not 0 <= n <= data.numel():
        raise ValueError(f"n={n} outside a tensor of {data.numel()} bytes")
    return n


def bytesum_plain(data: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Exact sum of ``data[:n]`` as an int64 tensor of one element."""
    n = _extent(data, n)
    return data[:n].sum(dtype=torch.int64).reshape(1)


def bytesum_cuda(data: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Exact sum of ``data[:n]`` by the CUDA kernel, as an int64 tensor of one
    element on the device. Launches asynchronously on the current stream."""
    build.require_cuda_bytes(data, "bytesum")
    n = _extent(data, n)
    out = torch.zeros(1, dtype=torch.int64, device=data.device)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(data.device):
        build.check(lib.sw_bytesum(data.data_ptr(), n, out.data_ptr(), build.stream_of(data)), "bytesum")
    LAUNCHES["bytesum"] += 1
    return out


def bytesum(tape_or_tensor, n: int | None = None) -> int:
    """Exact sum of all corpus bytes, as a Python int."""
    if isinstance(tape_or_tensor, Tape):
        data, n = tape_or_tensor.data, tape_or_tensor.total_bytes
    else:
        data = tape_or_tensor
    if data.device.type == "cuda":
        return int(bytesum_cuda(data, n).item())
    if data.device.type == "cpu":
        return int(bytesum_plain(data, n).item())
    raise ValueError(f"bytesum runs on a CUDA or CPU tensor, not {data.device}")
