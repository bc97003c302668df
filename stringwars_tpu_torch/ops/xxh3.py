"""Exact XXH3-64 of every token of a tape or a padded batch (family K3, the
reference's headline hash).

The port of ``stringwars_tpu.ops.xxh3``, digest for digest: XXH3-64
(xxHash v0.8) with a seed, over the four length paths of the spec (0-16,
17-128, 129-240, and above 240 bytes with 1,024-byte blocks, scrambles and
the overlapping last stripe). The JAX package computes on u32 lane pairs
(``ops/wideint.py``) over a stripe-major layout of padded rows plus a staged
window of each token's last 64 bytes (``prepare3``): both are the TPU's
layout. Here the tokens are read where they lie, at any byte offset, in
native 64-bit arithmetic, and the tape's own spans are an entry of their
own:

- ``secret_words(seed)``: the key words every path reads, derived once per
  seed on the host from the public 192-byte ``KSECRET`` (the short and
  middle paths use ``KSECRET`` with the seed added inline, the long path
  the seeded secret ``secret64[2i] += seed; secret64[2i+1] -= seed``);
- ``xxh3_64_plain`` / ``xxh3_64_spans_plain``: the plain torch version,
  int64 arithmetic (the 64 x 64 -> 128-bit products from 32-bit halves,
  logical shifts masked), each length path over the tokens that take it
  (the spans padded by ``tape._pad_spans``, path by path);
- ``xxh3_64_cuda`` / ``xxh3_64_spans_cuda``: the kernel ``csrc/xxh3.cu``,
  one kernel for both layouts (row ``r`` of a batch at byte ``r * width``):
  a lane a token up to 240 bytes, a warp a longer one;
- ``xxh3_64`` / ``xxh3_hash`` (a ``PaddedTokens`` batch) and
  ``xxh3_64_spans`` (a tape's ``data`` and ``offsets``): the kernel for a
  CUDA tensor, the plain version for a CPU tensor.

Digests are ``uint64``, one a token, as ``ops/hash.py`` returns XXH64's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.tape import PaddedTokens, _pad_spans

# Launches of csrc/xxh3.cu since process start (or the last reset).
LAUNCHES = {"xxh3": 0}

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_P32_1 = 2654435761
_P32_2 = 2246822519
_P32_3 = 3266489917
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_RRMXMX = 0x9FB21C651E98DF25
_AVALANCHE = 0x165667919E3779F9

KSECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
EMPTY_DIGEST = 0x2D06800538D394C2  # XXH3-64 of the empty input, seed 0 (xxHash's own test vector)

# The key words of ``secret_words``, in order: their count per group.
# flips: the empty input's digest under the seed, then the 1..16-byte
# paths' four bitflips; mid: (k[16i] + seed,
# k[16i + 8] - seed) for i < 8; mid3: the same at 16j + 3 for j < 7; last:
# at 119; stripes: the seeded secret's 24 aligned words; tail: its words at
# 121 + 8i (the last stripe); merge: at 11 + 8i (the merge).
KEY_GROUPS = (("flips", 5), ("mid", 16), ("mid3", 14), ("last", 2), ("stripes", 24), ("tail", 8), ("merge", 8))
KEY_WORDS = sum(count for _, count in KEY_GROUPS)


def _le(raw: bytes, offset: int, size: int = 8) -> int:
    return int.from_bytes(raw[offset : offset + size], "little")


def _avalanche_xxh64_int(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


@functools.lru_cache(maxsize=64)
def secret_words(seed: int) -> tuple[int, ...]:
    """The ``KEY_WORDS`` u64 key words of ``seed`` (see ``KEY_GROUPS``)."""
    seed &= _M64
    k = KSECRET
    seeded = bytearray(k)
    if seed:
        for i in range(12):
            lo = (_le(k, 16 * i) + seed) & _M64
            hi = (_le(k, 16 * i + 8) - seed) & _M64
            seeded[16 * i : 16 * i + 16] = lo.to_bytes(8, "little") + hi.to_bytes(8, "little")
    seeded = bytes(seeded)
    swap = int.from_bytes((seed & _M32).to_bytes(4, "little"), "big")
    seed48 = seed ^ (swap << 32)
    flips = [
        _avalanche_xxh64_int(seed ^ _le(k, 56) ^ _le(k, 64)),
        ((_le(k, 0, 4) ^ _le(k, 4, 4)) + seed) & _M64,
        ((_le(k, 8) ^ _le(k, 16)) - seed48) & _M64,
        ((_le(k, 24) ^ _le(k, 32)) + seed) & _M64,
        ((_le(k, 40) ^ _le(k, 48)) - seed) & _M64,
    ]

    def mix_keys(offset: int) -> list[int]:
        return [(_le(k, offset) + seed) & _M64, (_le(k, offset + 8) - seed) & _M64]

    words = flips
    for i in range(8):
        words += mix_keys(16 * i)
    for j in range(7):
        words += mix_keys(16 * j + 3)
    words += mix_keys(119)
    words += [_le(seeded, 8 * i) for i in range(24)]
    words += [_le(seeded, 121 + 8 * i) for i in range(8)]
    words += [_le(seeded, 11 + 8 * i) for i in range(8)]
    assert len(words) == KEY_WORDS
    return tuple(words)


# ---------------------------------------------------------------------------
# Plain torch version (int64 arithmetic)
# ---------------------------------------------------------------------------

def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    value &= _M64
    return value - (1 << 64) if value >> 63 else value


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of the u64 bits in int64 ``x``."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _mul128_fold64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low XOR high 64 bits of the 128-bit product of two u64 (int64 bits),
    from 32-bit halves (xxHash's ``XXH_mult64to128`` scalar path)."""
    a_lo, a_hi = a & _M32, _shr(a, 32)
    b_lo, b_hi = b & _M32, _shr(b, 32)
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    hi_hi = a_hi * b_hi
    cross = _shr(lo_lo, 32) + (hi_lo & _M32) + lo_hi
    upper = _shr(hi_lo, 32) + _shr(cross, 32) + hi_hi
    lower = (cross << 32) | (lo_lo & _M32)
    return lower ^ upper


def _avalanche_xxh64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _s64(_P64_2)
    h = h ^ _shr(h, 29)
    h = h * _s64(_P64_3)
    return h ^ _shr(h, 32)


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 37)
    h = h * _s64(_AVALANCHE)
    return h ^ _shr(h, 32)


def _bswap64(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for i in range(8):
        out = out | ((_shr(x, 8 * i) & 0xFF) << (8 * (7 - i)))
    return out


class _Reader:
    """Little-endian reads at per-token byte offsets of int64 rows."""

    def __init__(self, data: torch.Tensor):
        self.data = data.to(torch.int64)

    def read(self, offset: torch.Tensor, size: int = 8) -> torch.Tensor:
        width = self.data.shape[1]
        idx = offset[:, None] + torch.arange(size, device=offset.device)[None, :]
        b = self.data.gather(1, idx.clamp(0, width - 1))
        value = torch.zeros_like(offset)
        for i in range(size):
            value = value | (b[:, i] << (8 * i))
        return value


def _mix16(reader: _Reader, offset: torch.Tensor, key_lo: int, key_hi: int) -> torch.Tensor:
    lo = reader.read(offset) ^ _s64(key_lo)
    hi = reader.read(offset + 8) ^ _s64(key_hi)
    return _mul128_fold64(lo, hi)


def _len_0to16(reader: _Reader, n: torch.Tensor, key: dict) -> torch.Tensor:
    flips = key["flips"]
    zero = torch.zeros_like(n)
    h0 = torch.full_like(n, _s64(flips[0]))
    # 1..3 bytes
    c1 = reader.read(zero, 1)
    c2 = reader.read(n >> 1, 1)
    c3 = reader.read((n - 1).clamp(min=0), 1)
    combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
    h13 = _avalanche_xxh64(combined ^ _s64(flips[1]))
    # 4..8 bytes
    input64 = reader.read((n - 4).clamp(min=0), 4) + (reader.read(zero, 4) << 32)
    x = input64 ^ _s64(flips[2])
    x = x ^ (_rotl(x, 49) ^ _rotl(x, 24))
    x = x * _s64(_RRMXMX)
    x = x ^ (_shr(x, 35) + n)
    x = x * _s64(_RRMXMX)
    h48 = x ^ _shr(x, 28)
    # 9..16 bytes
    lo = reader.read(zero) ^ _s64(flips[3])
    hi = reader.read((n - 8).clamp(min=0)) ^ _s64(flips[4])
    h916 = _avalanche(n + _bswap64(lo) + hi + _mul128_fold64(lo, hi))
    return torch.where(n > 8, h916, torch.where(n >= 4, h48, torch.where(n > 0, h13, h0)))


def _len_17to128(reader: _Reader, n: torch.Tensor, key: dict) -> torch.Tensor:
    mid = key["mid"]
    acc = n * _s64(_P64_1)
    # Pairs walk inward: (input + f, key 2f/16) and (input + n - f - 16, the
    # next key), gated by n > g (the innermost pair always).
    for f, g in ((48, 96), (32, 64), (16, 32), (0, 0)):
        i = f // 16
        pair = _mix16(reader, torch.full_like(n, f), mid[4 * i], mid[4 * i + 1])
        pair = pair + _mix16(reader, n - f - 16, mid[4 * i + 2], mid[4 * i + 3])
        acc = torch.where(n > g, acc + pair, acc)
    return _avalanche(acc)


def _len_129to240(reader: _Reader, n: torch.Tensor, key: dict) -> torch.Tensor:
    mid, mid3, last = key["mid"], key["mid3"], key["last"]
    acc = n * _s64(_P64_1)
    for i in range(8):
        acc = acc + _mix16(reader, torch.full_like(n, 16 * i), mid[2 * i], mid[2 * i + 1])
    acc = _avalanche(acc)
    rounds = n // 16
    for i in range(8, 15):
        mixed = _mix16(reader, torch.full_like(n, 16 * i), mid3[2 * (i - 8)], mid3[2 * (i - 8) + 1])
        acc = torch.where(i < rounds, acc + mixed, acc)
    acc = acc + _mix16(reader, n - 16, last[0], last[1])
    return _avalanche(acc)


def _accumulate(acc: list, reader: _Reader, offset: torch.Tensor, keys, active=None) -> None:
    for i in range(8):
        value = reader.read(offset + 8 * i)
        mixed = value ^ _s64(keys[i])
        product = (mixed & _M32) * _shr(mixed, 32)
        j = i ^ 1
        if active is None:
            acc[j] = acc[j] + value
            acc[i] = acc[i] + product
        else:
            acc[j] = torch.where(active, acc[j] + value, acc[j])
            acc[i] = torch.where(active, acc[i] + product, acc[i])


def _len_long(reader: _Reader, n: torch.Tensor, key: dict) -> torch.Tensor:
    stripes_key, tail, merge = key["stripes"], key["tail"], key["merge"]
    init = (_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1)
    acc = [torch.full_like(n, _s64(v)) for v in init]
    stripes = (n - 1) // 64  # whole stripes before the overlapping last one
    for s in range(int(stripes.max())):
        active = s < stripes
        _accumulate(acc, reader, torch.full_like(n, 64 * s), stripes_key[s % 16 : s % 16 + 8], active)
        if s % 16 == 15:  # a whole 1,024-byte block: scramble
            for i in range(8):
                scrambled = (acc[i] ^ _shr(acc[i], 47) ^ _s64(stripes_key[16 + i])) * _P32_1
                acc[i] = torch.where(active, scrambled, acc[i])
    _accumulate(acc, reader, n - 64, tail)
    result = n * _s64(_P64_1)
    for i in range(4):
        result = result + _mul128_fold64(acc[2 * i] ^ _s64(merge[2 * i]), acc[2 * i + 1] ^ _s64(merge[2 * i + 1]))
    return _avalanche(result)


def _keys(seed: int) -> dict:
    words, key = secret_words(seed), {}
    at = 0
    for name, count in KEY_GROUPS:
        key[name] = words[at : at + count]
        at += count
    return key


# Each length path: its shortest and longest token (None: no limit), its function.
_PATHS = ((0, 16, _len_0to16), (17, 128, _len_17to128), (129, 240, _len_129to240), (241, None, _len_long))


def _path_tokens(n: torch.Tensor, lo: int, hi: int | None) -> torch.Tensor:
    take = (n >= lo) & (n <= hi) if hi is not None else n >= lo
    return torch.nonzero(take).squeeze(1)


def xxh3_64_plain(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """uint64[B]: XXH3-64 of every token under ``seed``, in torch ops."""
    key = _keys(int(seed))
    n = tokens.lengths.to(torch.int64)
    out = torch.zeros_like(n)
    for lo, hi, fn in _PATHS:
        idx = _path_tokens(n, lo, hi)
        if idx.numel():
            out[idx] = fn(_Reader(tokens.data[idx]), n[idx], key)
    return out.view(torch.uint64)


def xxh3_64_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: XXH3-64 under ``seed`` of every token ``data[offsets[t] :
    offsets[t + 1]]``, in torch ops: each length path's tokens padded to
    that path's longest (``tape._pad_spans``), then ``xxh3_64_plain``'s
    arithmetic."""
    key = _keys(int(seed))
    starts = offsets[:-1].to(torch.int64)
    n = offsets[1:].to(torch.int64) - starts
    out = torch.zeros_like(n)
    for lo, hi, fn in _PATHS:
        idx = _path_tokens(n, lo, hi)
        if idx.numel():
            rows = _pad_spans(data, starts[idx], n[idx], align=8).data
            out[idx] = fn(_Reader(rows), n[idx], key)
    return out.view(torch.uint64)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _check_tokens(tokens: PaddedTokens) -> None:
    build.require_cuda_bytes(tokens.data, "xxh3")
    lengths = tokens.lengths
    if tokens.data.dim() != 2 or tokens.data.shape[1] != tokens.width:
        raise ValueError(f"xxh3: expected a [count, {tokens.width}] matrix, got {tuple(tokens.data.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (tokens.count,) or not lengths.is_contiguous():
        raise ValueError(f"xxh3: lengths must be a contiguous int32[{tokens.count}] tensor")
    if lengths.device != tokens.data.device:
        raise ValueError(f"xxh3: lengths on {lengths.device}, data on {tokens.data.device}")


@functools.lru_cache(maxsize=64)
def _key_array(seed: int):
    return (ctypes.c_uint64 * KEY_WORDS)(*secret_words(seed))


def _launch(data: torch.Tensor, end: int, offsets, lengths, width: int, count: int, seed: int) -> torch.Tensor:
    out = torch.empty(count, dtype=torch.uint64, device=data.device)
    if count:
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_xxh3_64(
                data.data_ptr(), end, offsets.data_ptr() if offsets is not None else None,
                lengths.data_ptr() if lengths is not None else None, width, count, _key_array(int(seed) & _M64), out.data_ptr(),
                build.stream_of(data),
            )
        build.check(code, "xxh3")
        LAUNCHES["xxh3"] += 1
    return out


def xxh3_64_cuda(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """``xxh3_64_plain`` by the CUDA kernel, on the device (row ``r`` read at
    byte ``r * width``); lengths must not exceed the width (``PaddedTokens``
    clamps them)."""
    _check_tokens(tokens)
    return _launch(tokens.data, tokens.data.numel(), None, tokens.lengths, tokens.width, tokens.count, seed)


def xxh3_64_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``xxh3_64_spans_plain`` by the CUDA kernel, on the device, in one
    launch. Contract (the tape's): ``offsets`` nondecreasing, within
    ``[0, data.numel()]``; the kernel reads no byte outside ``data``."""
    build.require_spans(data, offsets, "xxh3")
    return _launch(data, data.numel(), offsets, None, 0, offsets.numel() - 1, seed)


def xxh3_64(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """uint64[B]: exact XXH3-64 of every token under ``seed``."""
    if tokens.data.device.type == "cuda":
        return xxh3_64_cuda(tokens, seed)
    if tokens.data.device.type == "cpu":
        return xxh3_64_plain(tokens, seed)
    raise ValueError(f"xxh3_64 runs on a CUDA or CPU tensor, not {tokens.data.device}")


def xxh3_64_spans(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: exact XXH3-64 under ``seed`` of every token ``data[offsets[t]
    : offsets[t + 1]]`` (a ``Tape``'s ``data`` and ``offsets``), read where it
    lies; an empty token gets the empty input's digest."""
    if data.device.type == "cuda":
        return xxh3_64_spans_cuda(data, offsets, seed)
    if data.device.type == "cpu":
        return xxh3_64_spans_plain(data, offsets, seed)
    raise ValueError(f"xxh3_64_spans runs on a CUDA or CPU tensor, not {data.device}")


def xxh3_hash(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """``xxh3_64``, under the JAX package's name for staging and hashing."""
    return xxh3_64(tokens, seed)
