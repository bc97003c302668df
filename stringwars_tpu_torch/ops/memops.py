"""Memory ops: LUT translate, fill, copy, move, random fill (family K12).

The port of ``stringwars_tpu.ops.memops`` (reference
``memory/bench.rs:110-396``): ``lut_translate`` and ``invert_case_lut``
(the 256-byte case-invert table), ``fill``, ``copy``, ``move``,
``fill_random_words`` and ``fill_random``. The JAX package's select-plane
form (``lut_translate_planes``) routes around the TPU's slow u8 gathers and
is not ported: the kernel ``csrc/lut.cu`` looks the table up in shared
memory. The random fill is Threefry-2x32, bit for bit the words of
``jax.random.bits(jax.random.PRNGKey(seed), ...)`` (``csrc/threefry.cu``).
``fill``, ``copy`` and ``move`` are torch's ``fill_`` and ``copy_``,
bounded by the bytes they move; ``move`` is the JAX package's, the buffer
shifted down by ``shift`` bytes out of place with a zero tail (``copy_``
refuses a source that partly overlaps its destination).

``*_plain`` are the plain torch versions; ``*_cuda`` launch the kernels;
``lut_translate`` takes the kernel for a CUDA tensor and the plain version
for a CPU tensor, and the fills run on the ``device`` they are given (the
card unless the caller names the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch import build

# Launches of csrc/lut.cu and csrc/threefry.cu since process start (or the last reset).
LAUNCHES = {"lut_translate": 0, "threefry": 0}

_M32 = 0xFFFFFFFF
# Threefry-2x32's rotations, by round group (jax/_src/prng.py).
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


# ---------------------------------------------------------------------------
# Fill, copy, move
# ---------------------------------------------------------------------------

def fill(n: int, value: int, device="cuda", out: torch.Tensor | None = None) -> torch.Tensor:
    """uint8[n] of ``value`` (its low byte): ``out`` (a uint8 tensor of n
    bytes, written in place) or a new buffer on ``device``."""
    if out is None:
        out = torch.empty(n, dtype=torch.uint8, device=device)
    elif out.dtype != torch.uint8 or out.numel() != n:
        raise ValueError(f"fill: out must be a uint8 tensor of {n} bytes, got {out.dtype}{tuple(out.shape)}")
    return out.fill_(int(value) & 0xFF)


def copy(data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """A copy of ``data``, into ``out`` (same shape and type) or a new buffer."""
    if out is None:
        out = torch.empty_like(data)
    return out.copy_(data)


def move(data: torch.Tensor, shift: int = 8, out: torch.Tensor | None = None) -> torch.Tensor:
    """memmove analog: the 1-D ``data`` shifted down by ``shift`` bytes, out
    of place, its last ``shift`` entries zero (reference shift 8, work n -
    8, ``memory/bench.rs:321-396``)."""
    n = data.numel()
    if data.dim() != 1 or not 0 <= shift <= n:
        raise ValueError(f"move: a shift of {shift} over a 1-D buffer of {n}")
    if out is None:
        out = torch.empty_like(data)
    out[: n - shift].copy_(data[shift:])
    out[n - shift :].zero_()
    return out


# ---------------------------------------------------------------------------
# Counter-based random words (Threefry-2x32, as jax.random.bits)
# ---------------------------------------------------------------------------

def threefry_key(seed: int) -> tuple[int, int]:
    """The Threefry key of ``jax.random.PRNGKey(seed)``: the seed's high and
    low 32 bits (a seed below 2^31 has the key (0, seed))."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    return seed >> 32, seed & _M32


def threefry_bits_plain(seed: int, count: int, device="cpu") -> torch.Tensor:
    """uint32[count]: word i is x0 ^ x1 of Threefry-2x32 (20 rounds) under
    ``threefry_key(seed)`` at the counter (i >> 32, i & 0xFFFFFFFF), in int64
    torch ops masked to 32 bits."""
    k0, k1 = threefry_key(seed)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    i = torch.arange(count, dtype=torch.int64, device=device)
    x0 = ((i >> 32) + ks[0]) & _M32
    x1 = ((i & _M32) + ks[1]) & _M32
    for group in range(5):
        for r in _THREEFRY_ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _M32
    return (x0 ^ x1).to(torch.uint32)


def threefry_bits_cuda(seed: int, count: int, device="cuda") -> torch.Tensor:
    """``threefry_bits_plain`` by the CUDA kernel, on the device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits_cuda: the CUDA kernel needs a CUDA device, got {device}")
    k0, k1 = threefry_key(seed)
    out = torch.empty(count, dtype=torch.uint32, device=device)
    if count:
        lib = build.library()
        with torch.cuda.device(device):
            code = lib.sw_threefry_bits(k0, k1, count, out.data_ptr(), build.stream_of(out))
        build.check(code, "threefry")
        LAUNCHES["threefry"] += 1
    return out


def fill_random_words(seed: int, n: int, device="cuda") -> torch.Tensor:
    """Counter-based random uint32 words covering ``n`` bytes: the words of
    ``jax.random.bits(jax.random.PRNGKey(seed), ((n + 3) // 4,), uint32)``."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    device = torch.device(device)
    count = (n + 3) // 4
    if device.type == "cuda":
        return threefry_bits_cuda(seed, count, device)
    if device.type == "cpu":
        return threefry_bits_plain(seed, count, device)
    raise ValueError(f"fill_random runs on a CUDA device or the CPU, not {device}")


def fill_random(seed: int, n: int, device="cuda") -> torch.Tensor:
    """``n`` counter-based random bytes on ``device`` (the AES-CTR keystream
    analog): the little-endian bytes of ``fill_random_words``."""
    return fill_random_words(seed, n, device).view(torch.uint8)[:n]
