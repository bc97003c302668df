"""Per-token hashes (xxh32, xxh64, swh64), their multiseed forms, and the
corpus-level tree hash: plain torch versions and the CPU/CUDA dispatch.

The port of ``stringwars_tpu.ops.hash``, digest for digest:

- ``xxh32`` / ``xxh64`` — exact XXH32 / XXH64 of every token of a
  ``PaddedTokens`` batch; ``xxh64_multiseed`` hashes under k seeds at once.
- ``swh64`` — the framework's first-party 64-bit hash: two decorrelated
  XXH32-core lanes over the same words (``swh64_ref`` is the host oracle),
  ``swh64_multiseed`` under k seeds.
- ``tree_hash64`` — XXH64 (seed 0) of every 64 KiB chunk of a buffer, then
  of the little-endian digest tape, until one digest remains.
- ``xxh64_spans`` / ``xxh64_multiseed_spans`` / ``xxh32_spans`` /
  ``swh64_spans`` / ``swh64_multiseed_spans`` — the same digests of a
  tape's tokens where they lie (token ``t`` is ``data[offsets[t] :
  offsets[t + 1]]``), with no padded copy: one launch a call
  (``csrc/hash.cu``'s spans form).

Digests come back as the JAX package shapes them, ``[batch]`` or
``[k, batch]``, but as native tensors: ``uint32`` for xxh32, ``uint64``
where JAX returns its u32-pair ``U64``. ``ops/wideint.py`` and the
stripe-major ``HashLayout`` are not ported: CUDA has 64-bit integers, and
the kernels read token-major rows (``csrc/hash.cu`` says why).

A CUDA tensor goes to the kernels of ``ops/hash_cuda.py``; a CPU tensor to
the plain versions below. The plain versions compute in ``int64``, because
torch's unsigned types have almost no CPU arithmetic: 32-bit values are
masked after every add and multiply, 64-bit ones rely on int64 wrap-around,
and logical right shifts are masked.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from stringwars_tpu_torch.tape import PaddedTokens, _pad_spans

_M32 = 0xFFFFFFFF

_P32_1 = 2654435761
_P32_2 = 2246822519
_P32_3 = 3266489917
_P32_4 = 668265263
_P32_5 = 374761393

_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5

_SWH_XOR = 0x85EBCA77
_SWH_GOLD = 0x9E3779B9

TREE_CHUNK = 64 * 1024


def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >> 63 else value


def _seeds(seeds) -> list[int]:
    """Seeds as a list of u64 Python ints (a scalar, a sequence or an array)."""
    return [int(s) & ((1 << 64) - 1) for s in np.asarray(seeds, dtype=np.uint64).reshape(-1)]


# ---------------------------------------------------------------------------
# Plain torch versions (int64 arithmetic)
# ---------------------------------------------------------------------------

def _words(tokens: PaddedTokens) -> torch.Tensor:
    """int64[B, ceil(W/4)]: the rows as little-endian u32 words, a width
    that is no multiple of 4 zero-padded to one."""
    d = tokens.data.to(torch.int64)
    if d.shape[1] % 4:
        d = torch.nn.functional.pad(d, (0, -d.shape[1] % 4))
    return d[:, 0::4] | d[:, 1::4] << 8 | d[:, 2::4] << 16 | d[:, 3::4] << 24


def _staged_tail(words: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int64[B, 8]: bytes [32*(n//32), n) of each token as zero-padded u32
    words (the JAX layout's ``tail_t``, token-major)."""
    j = torch.arange(8, device=words.device)
    idx = ((n // 32) * 8)[:, None] + j[None, :]
    tail = words.gather(1, idx.clamp(max=max(words.shape[1] - 1, 0)))
    valid = ((n % 32)[:, None] - 4 * j[None, :]).clamp(0, 4)
    return tail & ((torch.ones_like(valid) << (8 * valid)) - 1)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _select(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b]]`` for int64[B, m] and int64[B]."""
    return table.gather(1, idx[:, None]).squeeze(1)


def _xxh32_core_plain(tokens: PaddedTokens, seeds32: list[int], data_xor: int) -> torch.Tensor:
    """int64[k, B] of u32 values: the XXH32 algorithm with every data word
    XORed with ``data_xor`` (0 for XXH32 itself)."""
    words = _words(tokens)
    n = tokens.lengths.to(torch.int64)
    seed = torch.tensor(seeds32, dtype=torch.int64, device=words.device)[:, None]
    shape = (seed.shape[0], n.shape[0])
    acc = [
        ((seed + _P32_1 + _P32_2) & _M32).expand(shape),
        ((seed + _P32_2) & _M32).expand(shape),
        seed.expand(shape),
        ((seed - _P32_1) & _M32).expand(shape),
    ]
    n_stripes = n // 16
    stripes = min(int(n_stripes.max()) if n.numel() else 0, words.shape[1] // 4)
    for s in range(stripes):
        active = s < n_stripes
        for i in range(4):
            lane = words[:, 4 * s + i] ^ data_xor
            new = (_rotl32((acc[i] + lane * _P32_2) & _M32, 13) * _P32_1) & _M32
            acc[i] = torch.where(active, new, acc[i])
    h_long = (_rotl32(acc[0], 1) + _rotl32(acc[1], 7) + _rotl32(acc[2], 12) + _rotl32(acc[3], 18)) & _M32
    h = torch.where(n >= 16, h_long, (seed + _P32_5) & _M32)
    h = (h + n) & _M32

    tail8 = _staged_tail(words, n)
    tail = torch.where(((n % 32) >= 16)[:, None], tail8[:, 4:8], tail8[:, 0:4]) ^ data_xor
    r = n % 16
    n_words = r // 4
    for k in range(3):
        mixed = (_rotl32((h + tail[:, k] * _P32_3) & _M32, 17) * _P32_4) & _M32
        h = torch.where(k < n_words, mixed, h)
    last = _select(tail, n_words)
    for j in range(3):
        byte = (last >> (8 * j)) & 0xFF
        mixed = (_rotl32((h + byte * _P32_5) & _M32, 11) * _P32_1) & _M32
        h = torch.where(j < r % 4, mixed, h)

    h = h ^ (h >> 15)
    h = (h * _P32_2) & _M32
    h = h ^ (h >> 13)
    h = (h * _P32_3) & _M32
    return h ^ (h >> 16)


def _avalanche_swh(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _M32
    return h ^ (h >> 15)


def xxh32_plain(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint32[k, B]: XXH32 of every token under each seed's low 32 bits."""
    return _xxh32_core_plain(tokens, [s & _M32 for s in seeds], 0).to(torch.uint32)


def swh64_plain(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint64[k, B]: swh64 of every token under each seed."""
    lane_l = _xxh32_core_plain(tokens, [s & _M32 for s in seeds], 0)
    lane_h = _xxh32_core_plain(tokens, [((s >> 32) ^ _SWH_GOLD) & _M32 for s in seeds], _SWH_XOR)
    hi = _avalanche_swh((lane_h + _rotl32(lane_l, 16) * _P32_3) & _M32)
    lo = _avalanche_swh(lane_l ^ ((_rotl32(lane_h, 13) * _P32_4) & _M32))
    return (hi << 32 | lo).view(torch.uint64)


def _shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


def _round64(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + lane * _s64(_P64_2), 31) * _s64(_P64_1)


def xxh64_plain(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint64[k, B]: XXH64 of every token under each seed."""
    words = _words(tokens)
    n = tokens.lengths.to(torch.int64)
    seed = torch.tensor([_s64(s) for s in seeds], dtype=torch.int64, device=words.device)[:, None]
    shape = (seed.shape[0], n.shape[0])
    acc = [
        (seed + _s64(_P64_1 + _P64_2)).expand(shape),
        (seed + _s64(_P64_2)).expand(shape),
        seed.expand(shape),
        (seed - _s64(_P64_1)).expand(shape),
    ]
    n_stripes = n // 32
    stripes = min(int(n_stripes.max()) if n.numel() else 0, words.shape[1] // 8)
    for s in range(stripes):
        active = s < n_stripes
        for i in range(4):
            lane = words[:, 8 * s + 2 * i] | words[:, 8 * s + 2 * i + 1] << 32
            acc[i] = torch.where(active, _round64(acc[i], lane), acc[i])

    h_long = _rotl64(acc[0], 1) + _rotl64(acc[1], 7) + _rotl64(acc[2], 12) + _rotl64(acc[3], 18)
    for i in range(4):
        h_long = (h_long ^ _round64(torch.zeros_like(acc[i]), acc[i])) * _s64(_P64_1) + _s64(_P64_4)
    h = torch.where(n >= 32, h_long, seed + _s64(_P64_5))
    h = h + n

    tail = _staged_tail(words, n)
    r = n % 32
    n_words8 = r // 8
    for k in range(3):
        lane = tail[:, 2 * k] | tail[:, 2 * k + 1] << 32
        mixed = _rotl64(h ^ _round64(torch.zeros_like(h), lane), 27) * _s64(_P64_1) + _s64(_P64_4)
        h = torch.where(k < n_words8, mixed, h)
    w32 = _select(tail, 2 * n_words8)
    mixed = _rotl64(h ^ (w32 * _s64(_P64_1)), 23) * _s64(_P64_2) + _s64(_P64_3)
    h = torch.where((r % 8) >= 4, mixed, h)
    byte_word = _select(tail, r // 4)
    for j in range(3):
        byte = (byte_word >> (8 * j)) & 0xFF
        mixed = _rotl64(h ^ (byte * _s64(_P64_5)), 11) * _s64(_P64_1)
        h = torch.where(j < r % 4, mixed, h)

    h = h ^ _shr64(h, 33)
    h = h * _s64(_P64_2)
    h = h ^ _shr64(h, 29)
    h = h * _s64(_P64_3)
    h = h ^ _shr64(h, 32)
    return h.view(torch.uint64)


# Length classes of the spans' plain versions: tokens of (lo, hi] bytes are
# padded to hi together (the last class to its longest token).
_SPAN_CLASSES = (0, 32, 128, 512, 2048)


def _spans_plain(fn, data: torch.Tensor, offsets: torch.Tensor, seeds: list[int], dtype: torch.dtype) -> torch.Tensor:
    """``fn`` (a plain version over ``PaddedTokens``) of every token
    ``data[offsets[t] : offsets[t + 1]]``: [k, T] by token index, each length
    class padded by ``tape._pad_spans`` and hashed as rows."""
    starts = offsets[:-1].to(torch.int64)
    n = offsets[1:].to(torch.int64) - starts
    out = torch.zeros((len(seeds), n.numel()), dtype=torch.int64, device=data.device)
    bounds = list(_SPAN_CLASSES[1:]) + [None]
    for lo, hi in zip(_SPAN_CLASSES, bounds):
        take = (n > lo) & (n <= hi) if hi is not None else n > lo
        if lo == 0:
            take |= n == 0
        idx = torch.nonzero(take).squeeze(1)
        if idx.numel():
            rows = _pad_spans(data, starts[idx], n[idx], width=hi, align=64)
            got = fn(rows, seeds)
            out[:, idx] = got.view(torch.int64) if got.dtype == torch.uint64 else got.to(torch.int64)
    return out.to(dtype) if dtype != torch.uint64 else out.view(torch.uint64)


def xxh64_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: XXH64 under ``seed`` of every token of a tape's spans, in
    torch ops (``xxh64_plain`` over each length class padded)."""
    return _spans_plain(xxh64_plain, data, offsets, _seeds(seed), torch.uint64)[0]


def xxh64_multiseed_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """uint64[k, T]: XXH64 under k seeds of every token of a tape's spans, in
    torch ops."""
    return _spans_plain(xxh64_plain, data, offsets, _seeds(seeds), torch.uint64)


def xxh32_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint32[T]: XXH32 under ``seed``'s low 32 bits of every token of a
    tape's spans, in torch ops."""
    return _spans_plain(xxh32_plain, data, offsets, _seeds(seed), torch.uint32)[0]


def swh64_multiseed_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """uint64[k, T]: swh64 under k seeds of every token of a tape's spans, in
    torch ops."""
    return _spans_plain(swh64_plain, data, offsets, _seeds(seeds), torch.uint64)


def swh64_spans_plain(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: swh64 under ``seed`` of every token of a tape's spans."""
    return swh64_multiseed_spans_plain(data, offsets, [seed])[0]


def _chunks_of(data: torch.Tensor, n: int) -> PaddedTokens:
    """The TREE_CHUNK pieces of ``data[:n]`` as padded rows (a zero-padded
    copy: the plain version's layout; the kernel reads the buffer in place)."""
    chunks = max(1, -(-n // TREE_CHUNK))
    flat = torch.zeros(chunks * TREE_CHUNK, dtype=torch.uint8, device=data.device)
    flat[:n] = data[:n]
    lengths = (n - torch.arange(chunks, device=data.device) * TREE_CHUNK).clamp(0, TREE_CHUNK)
    return PaddedTokens(data=flat.view(chunks, TREE_CHUNK), lengths=lengths.to(torch.int32), width=TREE_CHUNK)


def tree_level_plain(data: torch.Tensor, n: int) -> torch.Tensor:
    """uint64[chunks]: XXH64 (seed 0) of every TREE_CHUNK piece of ``data[:n]``."""
    return xxh64_plain(_chunks_of(data, n), [0])[0]


# ---------------------------------------------------------------------------
# Public functions: the kernel for a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def _on_card(tensor: torch.Tensor) -> bool:
    if tensor.device.type == "cuda":
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"hashing runs on a CUDA or CPU tensor, not {tensor.device}")


def xxh32(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """Exact XXH32 of every token; uint32[batch]."""
    if _on_card(tokens.data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.xxh32(tokens, [seed])[0]
    return xxh32_plain(tokens, [int(seed)])[0]


def xxh64_multiseed(tokens: PaddedTokens, seeds) -> torch.Tensor:
    """XXH64 under k seeds at once: uint64[k, batch]. Each token is read
    once for all seeds (``containers/bench.rs:155-187``)."""
    seeds = _seeds(seeds)
    if _on_card(tokens.data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.xxh64(tokens, seeds)
    return xxh64_plain(tokens, seeds)


def xxh64(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """Exact XXH64 of every token; uint64[batch]."""
    return xxh64_multiseed(tokens, [seed])[0]


def swh64_multiseed(tokens: PaddedTokens, seeds) -> torch.Tensor:
    """swh64 under k seeds at once: uint64[k, batch]."""
    seeds = _seeds(seeds)
    if _on_card(tokens.data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.swh64(tokens, seeds)
    return swh64_plain(tokens, seeds)


def swh64(tokens: PaddedTokens, seed: int = 0) -> torch.Tensor:
    """The first-party fast 64-bit hash of every token; uint64[batch]."""
    return swh64_multiseed(tokens, [seed])[0]


def xxh64_spans(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: exact XXH64 under ``seed`` of every token ``data[offsets[t]
    : offsets[t + 1]]`` (a ``Tape``'s ``data`` and ``offsets``), read where it
    lies; an empty token gets the empty input's digest."""
    if _on_card(data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.xxh64_spans_cuda(data, offsets, seed)
    return xxh64_spans_plain(data, offsets, seed)


def xxh64_multiseed_spans(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """uint64[k, T]: XXH64 under k seeds of every token of a tape's spans,
    each token read once for all seeds (at most 8 a launch)."""
    if _on_card(data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.xxh64_multiseed_spans_cuda(data, offsets, seeds)
    return xxh64_multiseed_spans_plain(data, offsets, seeds)


def xxh32_spans(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint32[T]: exact XXH32 under ``seed`` of every token of a tape's
    spans, read where it lies."""
    if _on_card(data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.xxh32_spans_cuda(data, offsets, seed)
    return xxh32_spans_plain(data, offsets, seed)


def swh64_multiseed_spans(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """uint64[k, T]: swh64 under k seeds of every token of a tape's spans,
    each token read once for all seeds (at most 8 a launch)."""
    if _on_card(data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.swh64_multiseed_spans_cuda(data, offsets, seeds)
    return swh64_multiseed_spans_plain(data, offsets, seeds)


def swh64_spans(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """uint64[T]: swh64 under ``seed`` of every token of a tape's spans."""
    return swh64_multiseed_spans(data, offsets, [seed])[0]


def tree_level(data: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """uint64[chunks]: level 0 of ``tree_hash64`` over ``data[:n]``."""
    n = data.numel() if n is None else int(n)
    if _on_card(data):
        from stringwars_tpu_torch.ops import hash_cuda

        return hash_cuda.tree_level(data, n)
    return tree_level_plain(data, n)


def tree_hash64(data: torch.Tensor, n: int | None = None) -> int:
    """Deterministic chunked-tree digest of a byte buffer (framework spec).

    Level 0: XXH64(seed=0) of each 64 KiB chunk (last chunk short).
    Level k+1: XXH64(seed=0) of the little-endian u64 digest tape of level k.
    Recurse until one digest remains: a buffer of at most one chunk hashes
    to exactly ``XXH64(data)``. On a card every level stays on the device:
    the digests, viewed as bytes, are the next level's tape.
    """
    n = data.numel() if n is None else int(n)
    while True:
        digests = tree_level(data, n)
        if digests.numel() == 1:
            return int(digests.view(torch.int64).item()) & ((1 << 64) - 1)
        data = digests.view(torch.uint8)
        n = data.numel()


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def swh64_ref(token: bytes, seed: int = 0) -> int:
    """Pure-python replay of the swh64 spec (conformance oracle)."""

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF

    def core(data: bytes, seed32: int, xor: int) -> int:
        P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
        n = len(data)
        if n >= 16:
            acc = [
                (seed32 + P1 + P2) & 0xFFFFFFFF,
                (seed32 + P2) & 0xFFFFFFFF,
                seed32 & 0xFFFFFFFF,
                (seed32 - P1) & 0xFFFFFFFF,
            ]
            p = 0
            while p + 16 <= n:
                for i in range(4):
                    lane = int.from_bytes(data[p + 4 * i : p + 4 * i + 4], "little") ^ xor
                    acc[i] = (rotl((acc[i] + lane * P2) & 0xFFFFFFFF, 13) * P1) & 0xFFFFFFFF
                p += 16
            h = (rotl(acc[0], 1) + rotl(acc[1], 7) + rotl(acc[2], 12) + rotl(acc[3], 18)) & 0xFFFFFFFF
        else:
            h = (seed32 + P5) & 0xFFFFFFFF
            p = 0
        h = (h + n) & 0xFFFFFFFF
        # Tail words come from the zero-padded 4-byte words of the input.
        while p + 4 <= n:
            w4 = int.from_bytes(data[p : p + 4], "little") ^ xor
            h = (rotl((h + w4 * P3) & 0xFFFFFFFF, 17) * P4) & 0xFFFFFFFF
            p += 4
        if p < n:
            w4 = int.from_bytes(data[p:n] + bytes(4 - (n - p)), "little") ^ xor
            for j in range(n - p):
                byte = (w4 >> (8 * j)) & 0xFF
                h = (rotl((h + byte * P5) & 0xFFFFFFFF, 11) * P1) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * P2) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * P3) & 0xFFFFFFFF
        h ^= h >> 16
        return h

    def avalanche(h):
        h ^= h >> 15
        h = (h * 0x2C1B3C6D) & 0xFFFFFFFF
        h ^= h >> 12
        h = (h * 0x297A2D39) & 0xFFFFFFFF
        h ^= h >> 15
        return h

    lane_l = core(token, seed & 0xFFFFFFFF, 0)
    lane_h = core(token, ((seed >> 32) ^ 0x9E3779B9) & 0xFFFFFFFF, 0x85EBCA77)
    hi = avalanche((lane_h + rotl(lane_l, 16) * 3266489917) & 0xFFFFFFFF)
    lo = avalanche(lane_l ^ ((rotl(lane_h, 13) * 668265263) & 0xFFFFFFFF))
    return (hi << 32) | lo
