"""MinHash fingerprints over multi-scale byte n-grams (kernel family K6).

The port of ``stringwars_tpu.ops.fingerprint``, value for value. Each
document gets NDIM min-hashes spread over byte n-grams of widths
[5, 9, 17, 33] (NDIM/4 dims per width):

1. **Gram hash** ``G_w[p] = sum_t token[p+t] * B^(w-1-t) (mod 2^32)`` with
   odd base B = 0x01000193; bytes past the row's width read as zero.
2. **Per-dimension selection** ``h_d(g) = a_d * g + b_d (mod 2^32)`` with
   ``dim_coefficients``; the min over the valid positions
   ``p <= max(len - w, 0)`` (position 0 always valid), published as
   ``mix32(min)``, and the count of valid positions that reach the min.

Outputs: ``min_hashes uint32[B, ndim]``, ``min_counts int32[B, ndim]`` or
None. A CUDA tensor goes to the kernel ``csrc/fingerprint.cu``
(``fingerprint_cuda``); a CPU tensor to ``fingerprint_plain``, which
computes in int64 (torch's uint32 has almost no CPU arithmetic).

The kernel keeps only the min of each dim and recovers the count from the
argmin: ``a_d`` is odd, so the gram that reaches the min ``m`` is
``a_d^-1 * (m - b_d)`` (``dim_inverses``), and the count is that gram's
multiplicity among the valid positions. ``fingerprint_argmin_plain``
computes the counts that way on the CPU, for the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.tape import PaddedTokens

WINDOW_WIDTHS = (5, 9, 17, 33)
_BASE = 0x01000193  # FNV prime, odd
_M32 = 0xFFFFFFFF
_DIM_CHUNK = 16  # dims per step of the plain version: bounds its [B, W, dims] temporaries

# Launches of csrc/fingerprint.cu since process start (or the last reset).
LAUNCHES = {"fingerprint": 0}


def _splitmix32(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x21F0AAAD)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x735A2D97)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    return x


def dim_coefficients(ndim: int, seed: int = 0x5EED) -> tuple[np.ndarray, np.ndarray]:
    """Per-dimension universal-hash coefficients (a odd, b arbitrary)."""
    idx = np.arange(ndim, dtype=np.uint32)
    a = _splitmix32(idx * np.uint32(2) + np.uint32(seed)) | np.uint32(1)
    b = _splitmix32(idx * np.uint32(2) + np.uint32(1) + np.uint32(seed))
    return a, b


def dim_inverses(a: np.ndarray) -> np.ndarray:
    """The inverses of the odd ``a`` mod 2^32, by Newton's iteration
    ``x <- x * (2 - a * x)``: ``x = a`` is right in the low 3 bits (an odd
    square is 1 mod 8) and each step doubles them."""
    a = np.asarray(a, np.uint32)
    if a.size and not np.all(a & np.uint32(1)):
        raise ValueError("only an odd coefficient has an inverse mod 2^32")
    x = a.copy()
    with np.errstate(over="ignore"):
        for _ in range(4):  # 3 -> 6 -> 12 -> 24 -> 48 bits
            x = (x * (np.uint32(2) - a * x)).astype(np.uint32)
    return x


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The final avalanche on int64 holding u32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _check_ndim(ndim: int, widths) -> None:
    if ndim % len(widths):
        raise ValueError(f"ndim {ndim} not divisible by {len(widths)} widths")


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def gram_hashes_plain(data: torch.Tensor, widths=WINDOW_WIDTHS) -> dict[int, torch.Tensor]:
    """Per-width polynomial window hashes, int64[B, W] of u32 values, by
    log-doubling; bytes past the width read as zero."""
    width = data.shape[1]
    x = data.to(torch.int64)

    def shift_left(arr: torch.Tensor, k: int) -> torch.Tensor:
        k = min(k, width)
        return torch.nn.functional.pad(arr[:, k:], (0, k))

    levels = {1: x}
    k, power = 1, _BASE
    while k < max(widths):
        levels[2 * k] = (levels[k] * power + shift_left(levels[k], k)) & _M32
        power = power * power & _M32
        k *= 2
    out = {}
    for w in widths:
        if w in levels:
            out[w] = levels[w]
            continue
        if w - 1 not in levels:
            raise ValueError(f"width {w} not expressible as 2^k or 2^k+1")
        out[w] = (levels[w - 1] * _BASE + shift_left(x, w - 1)) & _M32
    return out


def fingerprint_plain(
    tokens: PaddedTokens,
    ndim: int = 256,
    widths: tuple[int, ...] = WINDOW_WIDTHS,
    with_counts: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(uint32[B, ndim] min-hashes, int32[B, ndim] counts or None)."""
    _check_ndim(ndim, widths)
    per_width = ndim // len(widths)
    batch, width = tokens.data.shape
    dev = tokens.data.device
    grams = gram_hashes_plain(tokens.data, widths)
    lengths = tokens.lengths.to(torch.int64)[:, None]
    pos = torch.arange(width, device=dev)[None, :]
    a_np, b_np = dim_coefficients(ndim)
    a_all = torch.from_numpy(a_np.astype(np.int64)).to(dev)
    b_all = torch.from_numpy(b_np.astype(np.int64)).to(dev)
    mins, counts = [], []
    for wi, w in enumerate(widths):
        valid = (pos <= (lengths - w).clamp(min=0))[:, :, None]  # position 0 always valid
        g = grams[w][:, :, None]
        for lo in range(wi * per_width, (wi + 1) * per_width, _DIM_CHUNK):
            hi = min(lo + _DIM_CHUNK, (wi + 1) * per_width)
            vals = (g * a_all[lo:hi] + b_all[lo:hi]) & _M32
            vals = torch.where(valid, vals, 1 << 32)  # above every u32
            m = vals.amin(1)
            mins.append(_mix32(m))
            if with_counts:
                counts.append((vals == m[:, None, :]).sum(1))
    min_hashes = torch.cat(mins, 1).to(torch.uint32) if mins else torch.zeros((batch, 0), dtype=torch.uint32, device=dev)
    min_counts = torch.cat(counts, 1).to(torch.int32) if with_counts and counts else None
    return min_hashes, min_counts


def fingerprint_argmin_plain(tokens: PaddedTokens, ndim: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's method on the CPU: per dim only the min ``m`` of
    ``a * g + b`` over the valid positions, then the count of valid positions
    whose gram is ``a^-1 * (m - b)``. Equal to ``fingerprint_plain``."""
    _check_ndim(ndim, WINDOW_WIDTHS)
    per_width = ndim // len(WINDOW_WIDTHS)
    batch, width = tokens.data.shape
    grams = gram_hashes_plain(tokens.data.cpu())
    lengths = tokens.lengths.cpu().to(torch.int64)[:, None]
    a_np, b_np = dim_coefficients(ndim)
    inv = torch.from_numpy(dim_inverses(a_np).astype(np.int64))
    a, b = torch.from_numpy(a_np.astype(np.int64)), torch.from_numpy(b_np.astype(np.int64))
    mins = torch.zeros((batch, ndim), dtype=torch.int64)
    counts = torch.zeros((batch, ndim), dtype=torch.int64)
    pos = torch.arange(width)[None, :]
    for wi, w in enumerate(WINDOW_WIDTHS):
        valid = pos <= (lengths - w).clamp(min=0)
        g = grams[w]
        for d in range(wi * per_width, (wi + 1) * per_width):
            vals = torch.where(valid, (g * a[d] + b[d]) & _M32, 1 << 32)
            m = vals.amin(1)
            argmin_gram = (inv[d] * (m - b[d])) & _M32
            mins[:, d] = m
            counts[:, d] = (valid & (g == argmin_gram[:, None])).sum(1)
    return _mix32(mins).to(torch.uint32), counts.to(torch.int32)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _coefficients_on(ndim: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a, b, a^-1 mod 2^32), uint32[ndim] each on ``device``."""
    a, b = dim_coefficients(ndim)
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, dim_inverses(a)))


def fingerprint_cuda(
    tokens: PaddedTokens, ndim: int = 256, with_counts: bool = True
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """MinHash of every row by the CUDA kernel (widths 5, 9, 17, 33), on the
    device. Launches asynchronously on the current stream. Rows too wide for
    a block's shared memory on the card raise ``build.KernelLaunchError``
    (the kernel sizes its shared memory and refuses the launch)."""
    data, lengths = tokens.data, tokens.lengths
    build.require_cuda_bytes(data, "fingerprint")
    _check_ndim(ndim, WINDOW_WIDTHS)
    if data.dim() != 2 or data.shape[1] != tokens.width or tokens.width % 4:
        raise ValueError(f"fingerprint: expected a [count, width] matrix with width % 4 == 0, got {tuple(data.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (tokens.count,) or lengths.device != data.device:
        raise ValueError(f"fingerprint: lengths must be int32[{tokens.count}] on {data.device}")
    hashes = torch.empty((tokens.count, ndim), dtype=torch.uint32, device=data.device)
    counts = torch.empty((tokens.count, ndim), dtype=torch.int32, device=data.device) if with_counts else None
    if tokens.count == 0 or ndim == 0:
        return hashes, counts
    a, b, inv = _coefficients_on(ndim, data.device)
    lengths = lengths.contiguous()
    lib = build.library()
    with torch.cuda.device(data.device):
        code = lib.sw_fingerprint(
            data.data_ptr(), tokens.count, tokens.width, lengths.data_ptr(), a.data_ptr(), b.data_ptr(), inv.data_ptr(), ndim,
            hashes.data_ptr(), counts.data_ptr() if with_counts else None, build.stream_of(data),
        )
    build.check(code, "fingerprint")
    LAUNCHES["fingerprint"] += 1
    return hashes, counts


def fingerprint(
    tokens: PaddedTokens,
    ndim: int = 256,
    widths: tuple[int, ...] = WINDOW_WIDTHS,
    with_counts: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """MinHash signature of every token: (min_hashes [B, ndim], min_counts)."""
    device = tokens.data.device
    if device.type == "cuda":
        if tuple(widths) != WINDOW_WIDTHS:
            raise ValueError(f"the CUDA kernel computes widths {WINDOW_WIDTHS}, not {tuple(widths)}")
        return fingerprint_cuda(tokens, ndim, with_counts)
    if device.type == "cpu":
        return fingerprint_plain(tokens, ndim, widths, with_counts)
    raise ValueError(f"fingerprint runs on a CUDA or CPU tensor, not {device}")


# ---------------------------------------------------------------------------
# Numpy oracle (spec replay) + quality metrics, host code
# ---------------------------------------------------------------------------

def fingerprint_ref(token: bytes, ndim: int = 256, widths=WINDOW_WIDTHS):
    """Direct numpy replay of the documented spec for one token (u32
    arithmetic wraps, so numpy's overflow warnings are silenced)."""
    with np.errstate(over="ignore"):
        return _fingerprint_ref(token, ndim, widths)


def _fingerprint_ref(token: bytes, ndim: int, widths):
    base = np.uint32(_BASE)
    per_width = ndim // len(widths)
    a_np, b_np = dim_coefficients(ndim)
    data = np.frombuffer(token, np.uint8).astype(np.uint32)
    mins = np.zeros(ndim, np.uint32)
    counts = np.zeros(ndim, np.int64)
    for wi, w in enumerate(widths):
        n_pos = max(len(token) - w, 0) + 1
        padded = np.zeros(n_pos + w, np.uint32)
        padded[: len(data[: n_pos + w])] = data[: n_pos + w]
        ghash = np.zeros(n_pos, np.uint32)
        for p in range(n_pos):
            h = np.uint32(0)
            for t in range(w):
                h = h * base + padded[p + t]
            ghash[p] = h
        for d in range(per_width):
            gd = wi * per_width + d
            vals = (ghash * a_np[gd] + b_np[gd]).astype(np.uint32)
            m = vals.min()
            counts[gd] = int((vals == m).sum())
            m = m ^ (m >> np.uint32(16))
            m = np.uint32(m * np.uint32(0x7FEB352D))
            m = m ^ (m >> np.uint32(15))
            m = np.uint32(m * np.uint32(0x846CA68B))
            mins[gd] = m ^ (m >> np.uint32(16))
    return mins, counts


def bit_entropy(min_hashes: np.ndarray) -> float:
    """Mean per-bit entropy of the signature matrix (reference
    ``fingerprints/bench.rs:92-127`` quality metric; 1.0 = ideal)."""
    bits = ((min_hashes[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1, 32)
    p = bits.mean(axis=0)
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return float(np.mean(-p * np.log2(p) - (1 - p) * np.log2(1 - p)))


def collision_rate(min_hashes: np.ndarray) -> float:
    """Fraction of (doc, dim) hash values that collide with another doc in
    the same dim (reference ``fingerprints/bench.rs:130-149``)."""
    docs, ndim = min_hashes.shape
    if docs < 2:
        return 0.0
    coll = 0
    for d in range(ndim):
        _, counts = np.unique(min_hashes[:, d], return_counts=True)
        coll += int((counts > 1) @ counts)
    return coll / (docs * ndim)
