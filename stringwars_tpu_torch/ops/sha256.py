"""SHA-256 of every token of a padded batch (family K4, the checksum tier).

The port of ``stringwars_tpu.ops.sha256``: ``sha256(tokens)`` gives the
digest of each row of a ``PaddedTokens`` batch as ``uint32[batch, 8]``
big-endian words, the JAX package's shape. The JAX host staging
``prepare_sha256`` (a numpy pass over every byte into a block-major
``[max_blocks, 16, batch]`` layout for the TPU's lanes) is not ported: the
kernel ``csrc/sha256.cu`` reads the rows as they lie, one thread a token,
and pads each block in registers.

``sha256_plain`` is the plain torch version (the padding staged with torch
ops, the compression in int64 masked to 32 bits), ``sha256_cuda`` launches
the kernel, and ``sha256`` takes the kernel for a CUDA tensor and the plain
version for a CPU tensor. ``digest_bytes`` turns digests into the bytes
``hashlib.sha256(token).digest()`` gives.
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.tape import PaddedTokens

# Launches of csrc/sha256.cu since process start (or the last reset).
LAUNCHES = {"sha256": 0}

_M32 = 0xFFFFFFFF

# FIPS 180-4 §4.2.2 round constants.
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

# FIPS 180-4 §5.3.3 initial hash value.
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & _M32


def _message_words(data: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int64[B, max_blocks, 16] padded big-endian message words, int64[B]
    blocks each token takes) of uint8[B, W] rows: the bytes below the
    length, 0x80, zeros, and the 64-bit bit length at the end of the token's
    last block."""
    lengths = lengths.to(torch.int64)
    count, width = data.shape
    max_blocks = (width + 9 + 63) // 64
    col = torch.arange(max_blocks * 64, device=data.device)
    buf = torch.zeros((count, max_blocks * 64), dtype=torch.uint8, device=data.device)
    buf[:, :width] = data
    buf = torch.where(col < lengths[:, None], buf, (col == lengths[:, None]).to(torch.uint8) * 0x80)
    blocks = (lengths + 9 + 63) // 64
    end = blocks * 64  # the bit length's 8 bytes end here
    bits = lengths * 8
    for i in range(8):
        buf.scatter_(1, (end - 8 + i)[:, None], ((bits >> (8 * (7 - i))) & 0xFF).to(torch.uint8)[:, None])
    b4 = buf.view(count, max_blocks, 16, 4).to(torch.int64)
    words = b4[..., 0] << 24 | b4[..., 1] << 16 | b4[..., 2] << 8 | b4[..., 3]
    return words, blocks


def _compress_plain(state: list[torch.Tensor], block: torch.Tensor) -> list[torch.Tensor]:
    """One compression of int64[B, 16] words into the eight int64[B] words."""
    w = [block[:, i] for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        big1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & _M32)
        t1 = (h + big1 + ch + _K[i] + w[i]) & _M32
        big0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + big0 + maj) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


_PLAIN_ROWS = 1 << 20  # rows the plain version stages at once


def sha256_plain(tokens: PaddedTokens) -> torch.Tensor:
    """uint32[B, 8]: SHA-256 of every token, as big-endian words. Rows go
    in slices of ``_PLAIN_ROWS``; block k of a slice's longest message is
    compressed for every row, and a row whose message has ended keeps its
    state."""
    out = torch.empty((tokens.count, 8), dtype=torch.uint32, device=tokens.data.device)
    for lo in range(0, tokens.count, _PLAIN_ROWS):
        words, blocks = _message_words(tokens.data[lo : lo + _PLAIN_ROWS], tokens.lengths[lo : lo + _PLAIN_ROWS])
        state = [torch.full((words.shape[0],), h, dtype=torch.int64, device=words.device) for h in _H0]
        for k in range(int(blocks.max())):
            new = _compress_plain(state, words[:, k])
            live = k < blocks
            state = [torch.where(live, n, s) for n, s in zip(new, state)]
        out[lo : lo + _PLAIN_ROWS] = torch.stack(state, dim=1).to(torch.uint32)
    return out


def _check_tokens(tokens: PaddedTokens) -> None:
    build.require_cuda_bytes(tokens.data, "sha256")
    lengths = tokens.lengths
    if tokens.data.dim() != 2 or tokens.data.shape[1] != tokens.width or tokens.width % 4:
        raise ValueError(f"sha256: expected a [count, width] matrix with width % 4 == 0, got {tuple(tokens.data.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (tokens.count,) or not lengths.is_contiguous():
        raise ValueError(f"sha256: lengths must be a contiguous int32[{tokens.count}] tensor")
    if lengths.device != tokens.data.device:
        raise ValueError(f"sha256: lengths on {lengths.device}, data on {tokens.data.device}")


def sha256_cuda(tokens: PaddedTokens) -> torch.Tensor:
    """``sha256_plain`` by the CUDA kernel, on the device; lengths must not
    exceed the width (``PaddedTokens`` clamps them)."""
    _check_tokens(tokens)
    out = torch.empty((tokens.count, 8), dtype=torch.uint32, device=tokens.data.device)
    if tokens.count:
        lib = build.library()
        with torch.cuda.device(tokens.data.device):
            code = lib.sw_sha256(
                tokens.data.data_ptr(), tokens.count, tokens.width, tokens.lengths.data_ptr(), out.data_ptr(),
                build.stream_of(tokens.data),
            )
        build.check(code, "sha256")
        LAUNCHES["sha256"] += 1
    return out


def sha256(tokens: PaddedTokens) -> torch.Tensor:
    """uint32[B, 8]: SHA-256 of every token, as big-endian words."""
    if tokens.data.device.type == "cuda":
        return sha256_cuda(tokens)
    if tokens.data.device.type == "cpu":
        return sha256_plain(tokens)
    raise ValueError(f"sha256 runs on a CUDA or CPU tensor, not {tokens.data.device}")


def digest_bytes(digests: torch.Tensor) -> np.ndarray:
    """uint8[B, 32] on the host: the digests as ``hashlib`` gives them."""
    return np.ascontiguousarray(digests.cpu().numpy().astype(">u4")).view(np.uint8).reshape(-1, 32)
