"""Memory ops, the LUT part: ``out[i] = lut[data[i]]`` (family K12).

The port of ``stringwars_tpu.ops.memops.lut_translate`` and
``invert_case_lut`` (reference ``memory/bench.rs:110-166``). The JAX
package's select-plane form (``lut_translate_planes``) routes around the
TPU's slow u8 gathers and is not ported: the kernel ``csrc/lut.cu`` looks
the table up in shared memory. The rest of memops (fill, copy, move, PRNG
fill) comes with the memory suite.

``lut_translate_plain`` is the plain torch version; ``lut_translate_cuda``
launches the kernel; ``lut_translate`` takes the kernel for a CUDA tensor
and the plain version for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch import build

# Launches of csrc/lut.cu since process start (or the last reset).
LAUNCHES = {"lut_translate": 0}


def invert_case_lut() -> np.ndarray:
    """The reference's LUT workload: swap ASCII upper/lower case."""
    lut = np.arange(256, dtype=np.uint8)
    lower = (lut >= 97) & (lut <= 122)
    upper = (lut >= 65) & (lut <= 90)
    lut[lower] -= 32
    lut[upper] += 32
    return lut


def _check_lut(data: torch.Tensor, lut: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or lut.dtype != torch.uint8 or lut.shape != (256,):
        raise ValueError(f"expected uint8 data and a uint8[256] table, got {data.dtype} and {lut.dtype}{tuple(lut.shape)}")
    if lut.device != data.device:
        raise ValueError(f"table on {lut.device}, data on {data.device}")


def lut_translate_plain(data: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``lut[data]`` with int64 indices (a uint8 index would be a mask)."""
    _check_lut(data, lut)
    return lut[data.long()]


def lut_translate_cuda(data: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``lut[data]`` by the CUDA kernel, any shape, on the device. The
    output is allocated at the input's offset within 16 bytes so that both
    stream as 16-byte vectors; it may be a view into a slightly larger
    buffer. Launches asynchronously on the current stream."""
    build.require_cuda_bytes(data, "lut_translate")
    build.require_cuda_bytes(lut, "lut_translate table")
    _check_lut(data, lut)
    n = data.numel()
    offset = data.data_ptr() % 16
    buf = torch.empty(n + 16, dtype=torch.uint8, device=data.device)
    shift = (offset - buf.data_ptr() % 16) % 16
    out = buf[shift : shift + n]
    if n:
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_lut_translate(data.data_ptr(), n, lut.data_ptr(), out.data_ptr(), build.stream_of(data))
        build.check(code, "lut_translate")
        LAUNCHES["lut_translate"] += 1
    return out.view(data.shape)


def lut_translate(data: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``out[i] = lut[data[i]]`` for a uint8 tensor and a 256-entry table."""
    if data.device.type == "cuda":
        return lut_translate_cuda(data, lut)
    if data.device.type == "cpu":
        return lut_translate_plain(data, lut)
    raise ValueError(f"lut_translate runs on a CUDA or CPU tensor, not {data.device}")
