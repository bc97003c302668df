"""Probabilistic membership filters (kernel family K7).

The port of ``stringwars_tpu.ops.filters`` (reference: Bloom and
BinaryFuse8 filters, build and query throughput, FPR on a held-out 20% and
bits a key, ``containers/bench.rs:190-341``):

- **Bloom**: the bit array is a uint32 word tensor on the device; a token's
  k probe positions come from XXH64 under k seeds (``bloom_positions``:
  ``lo ^ hi·0x9E3779B9`` in uint32, mod ``m_bits``). On a card, build and
  query are the kernels of ``csrc/filters.cu``, which hash each token where
  it lies and use the digests at once; no digest is written (build: an
  ``atomicOr`` a probe; query: each answer kept in a register and stored
  once, a lane stopping at its token's first clear bit).
  ``bloom_build_plain`` / ``bloom_query_plain`` are the JAX package's byte
  plane and word gathers in torch.
- **BinaryFuse8**: construction is sequential peeling, on the host in numpy
  (``fuse_build``, ``_peel``, ``_assign``: the port's own copies; the JAX
  package's ``native/`` is never loaded); the fingerprint table goes to the
  device, where a query (``fuse_query_probes``: three gathers, their XOR,
  the compare with the fingerprint) is the ``fuse_query`` kernel on a card.

Tokens are a ``Tape`` (its spans, read where they lie) or ``PaddedTokens``.
A CUDA tensor takes the kernel, a CPU tensor the plain version; each
kernel wrapper adds one to its entry of ``LAUNCHES`` a call.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.tape import PaddedTokens, Tape

# Launches of csrc/filters.cu's kernels since process start (or the last reset).
LAUNCHES = {"bloom_build": 0, "bloom_query": 0, "fuse_query": 0}

_M32 = 0xFFFFFFFF
_MIX = 0x9E3779B9


def _on_card(tensor: torch.Tensor) -> bool:
    if tensor.device.type == "cuda":
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"filters run on a CUDA or CPU tensor, not {tensor.device}")


# ---------------------------------------------------------------------------
# Bloom filter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BloomFilter:
    words: torch.Tensor  # uint32[m_bits / 32]
    seeds: tuple[int, ...]

    @property
    def m_bits(self) -> int:
        return self.words.shape[0] * 32

    def bits_per_key(self, n_keys: int) -> float:
        return self.m_bits / max(n_keys, 1)


def _digests(tokens: PaddedTokens | Tape, seeds, plain: bool = False) -> torch.Tensor:
    """uint64[k, B]: XXH64 of every token under each seed, on its device (by
    the hash kernels on a card, or with ``plain`` by the plain versions)."""
    if isinstance(tokens, Tape):
        fn = H.xxh64_multiseed_spans_plain if plain else H.xxh64_multiseed_spans
        return fn(tokens.data, tokens.offsets, seeds)
    return H.xxh64_plain(tokens, H._seeds(seeds)) if plain else H.xxh64_multiseed(tokens, seeds)


def bloom_positions(tokens: PaddedTokens | Tape, seeds, m_bits: int, plain: bool = False) -> torch.Tensor:
    """int64[k, B]: each token's probe positions in [0, m_bits) from k-seed
    XXH64 digests (by the hash kernels on a card, or with ``plain`` by the
    plain versions): ``lo ^ hi·0x9E3779B9`` in uint32, mod ``m_bits``."""
    d = _digests(tokens, seeds, plain).view(torch.int64)
    lo, hi = d & _M32, (d >> 32) & _M32
    return (lo ^ ((hi * _MIX) & _M32)) % int(m_bits)


def _check_m_bits(m_bits: int) -> None:
    if m_bits <= 0 or m_bits % 32 or m_bits >= 1 << 32:
        raise ValueError(f"m_bits must be a positive multiple of 32 below 2^32, got {m_bits}")


def bloom_build_plain(tokens: PaddedTokens | Tape, seeds, m_bits: int) -> torch.Tensor:
    """uint32[m_bits / 32]: the filter's words, in torch ops (the digests
    too): a byte a bit set at every probe position, packed 32 bits a word,
    bit i of word w for position 32w + i."""
    _check_m_bits(m_bits)
    pos = bloom_positions(tokens, seeds, m_bits, plain=True).reshape(-1)
    dev = pos.device
    plane = torch.zeros(m_bits, dtype=torch.int64, device=dev)
    plane[pos] = 1
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev)
    return (plane.view(-1, 32) * weights).sum(1).to(torch.uint32)


def bloom_query_plain(words: torch.Tensor, tokens: PaddedTokens | Tape, seeds, m_bits: int) -> torch.Tensor:
    """bool[B]: whether every one of each token's probe bits is set, in torch
    ops (the digests, word gathers and bit tests, an AND over the seeds)."""
    pos = bloom_positions(tokens, seeds, m_bits, plain=True)
    word = words.view(torch.int32).to(torch.int64)[pos >> 5] & _M32
    return ((word >> (pos & 31)) & 1).bool().all(0)


def _token_args(tokens: PaddedTokens | Tape, what: str):
    """(data, end, offsets, lengths, width, count) of a kernel launch: a
    tape's spans or padded rows."""
    if isinstance(tokens, Tape):
        build.require_spans(tokens.data, tokens.offsets, what)
        return tokens.data.data_ptr(), tokens.data.numel(), tokens.offsets.data_ptr(), None, 0, tokens.count
    from stringwars_tpu_torch.ops import hash_cuda

    hash_cuda._check_tokens(tokens, what)
    return tokens.data.data_ptr(), tokens.data.numel(), None, tokens.lengths.data_ptr(), tokens.width, tokens.count


@functools.lru_cache(maxsize=None)
def _seed_array(seeds: tuple[int, ...]):
    """The C entry points' uint64 seed array, built once a seed tuple."""
    from stringwars_tpu_torch.ops.hash_cuda import _seed_array as make

    return make(seeds)


def bloom_build_cuda(tokens: PaddedTokens | Tape, seeds, m_bits: int) -> torch.Tensor:
    """``bloom_build_plain`` by the ``bloom_build`` kernel, on the device."""
    _check_m_bits(m_bits)
    data = tokens.data
    words = torch.zeros(m_bits // 32, dtype=torch.uint32, device=data.device)
    args = _token_args(tokens, "bloom_build")
    if args[-1]:
        seeds = tuple(H._seeds(seeds))
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_bloom_build(*args, _seed_array(seeds), len(seeds), m_bits, words.data_ptr(), build.stream_of(data))
        build.check(code, "bloom_build")
        LAUNCHES["bloom_build"] += 1
    return words


def bloom_query_cuda(words: torch.Tensor, tokens: PaddedTokens | Tape, seeds, m_bits: int) -> torch.Tensor:
    """``bloom_query_plain`` by the ``bloom_query`` kernel, on the device: one
    launch a call up to 8 seeds, every answer stored by the kernel."""
    _check_m_bits(m_bits)
    data = tokens.data
    if words.device != data.device or words.dtype != torch.uint32 or words.numel() * 32 != m_bits or not words.is_contiguous():
        raise ValueError(f"bloom_query: expected contiguous uint32[{m_bits // 32}] words on {data.device}")
    args = _token_args(tokens, "bloom_query")
    out = torch.empty(args[-1], dtype=torch.bool, device=data.device)
    if args[-1]:
        seeds = tuple(H._seeds(seeds))
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_bloom_query(*args, _seed_array(seeds), len(seeds), m_bits, words.data_ptr(), out.data_ptr(),
                                      build.stream_of(data))
        build.check(code, "bloom_query")
        LAUNCHES["bloom_query"] += 1
    return out


def bloom_build(tokens: PaddedTokens | Tape, seeds, m_bits: int) -> BloomFilter:
    """A Bloom filter of ``m_bits`` bits (a multiple of 32) holding every
    token, on the tokens' device."""
    seeds = tuple(H._seeds(seeds))
    fn = bloom_build_cuda if _on_card(tokens.data) else bloom_build_plain
    return BloomFilter(words=fn(tokens, seeds, m_bits), seeds=seeds)


def bloom_query(filt: BloomFilter, tokens: PaddedTokens | Tape) -> torch.Tensor:
    """bool[B]: probable membership of each token."""
    fn = bloom_query_cuda if _on_card(tokens.data) else bloom_query_plain
    return fn(filt.words, tokens, filt.seeds, filt.m_bits)


# ---------------------------------------------------------------------------
# BinaryFuse8
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BinaryFuse8:
    fingerprints: torch.Tensor  # uint8[array_len]
    segment_length: int
    segment_count_length: int
    seed: int

    def bits_per_key(self, n_keys: int) -> float:
        return 8.0 * self.fingerprints.shape[0] / max(n_keys, 1)


def fuse_hashes(keys_u64: np.ndarray, seed: int, segment_length: int, segment_count_length: int):
    """3 probe positions (int64[3, n]) and a fingerprint (uint8[n]) per key
    (a splitmix rehash of the key)."""
    x = (keys_u64 + np.uint64(seed)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xFF51AFD7ED558CCD)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xC4CEB9FE1A85EC53)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    fp = (x & np.uint64(0xFF)).astype(np.uint8)
    fp = np.where(fp == 0, np.uint8(0x5A), fp)  # nonzero fingerprints
    sl = np.uint64(segment_length)
    h = np.empty((3, keys_u64.shape[0]), np.int64)
    for i in range(3):
        hv = (x >> np.uint64(21 * i)) & np.uint64((1 << 21) - 1)
        seg = ((x >> np.uint64(48)) * np.uint64(segment_count_length) >> np.uint64(16)) // sl
        h[i] = ((seg + np.uint64(i)) * sl + (hv % sl)).astype(np.int64)
    return h, fp


def fuse_build(keys_u64: np.ndarray, max_attempts: int = 100, device="cuda") -> BinaryFuse8:
    """Host-side peeling construction over the unique u64 keys; the table
    goes to ``device`` (the card unless the caller names the CPU)."""
    keys = np.unique(np.asarray(keys_u64, np.uint64))
    n = keys.shape[0]
    segment_length = 1 << max(int(np.floor(np.log2(max(n, 2)) / 0.58 / 3.33 + 2)), 4)
    segment_length = min(segment_length, 1 << 18)
    capacity = int(max(n * 1.23, 32) + segment_length)
    segment_count_length = max((capacity // segment_length - 2), 1) * segment_length
    array_len = segment_count_length + 2 * segment_length
    for attempt in range(max_attempts):
        seed = 0xA5A5_0000 + attempt * 0x9E37
        h, fp = fuse_hashes(keys, seed, segment_length, segment_count_length)
        order, ok = _peel(h, array_len, n)
        if ok:
            table = _assign(h, fp, order, array_len)
            return BinaryFuse8(
                fingerprints=torch.from_numpy(table).to(device),
                segment_length=segment_length,
                segment_count_length=segment_count_length,
                seed=seed,
            )
    raise RuntimeError("binary fuse construction failed; increase capacity")


def _peel(h: np.ndarray, array_len: int, n: int):
    """Peeling order: repeatedly remove keys that are the sole occupant of
    some slot. Returns (ordered key indices reversed, success)."""
    counts = np.zeros(array_len, np.int32)
    xor_keys = np.zeros(array_len, np.int64)
    for i in range(3):
        np.add.at(counts, h[i], 1)
        np.bitwise_xor.at(xor_keys, h[i], np.arange(n))
    stack = list(np.flatnonzero(counts == 1))
    order = []
    removed = np.zeros(n, bool)
    while stack:
        slot = stack.pop()
        if counts[slot] != 1:
            continue
        key = int(xor_keys[slot])
        if removed[key]:
            continue
        removed[key] = True
        order.append((key, slot))
        for i in range(3):
            s = int(h[i][key])
            counts[s] -= 1
            xor_keys[s] ^= key
            if counts[s] == 1:
                stack.append(s)
    return order, len(order) == n


def _assign(h: np.ndarray, fp: np.ndarray, order, array_len: int) -> np.ndarray:
    table = np.zeros(array_len, np.uint8)
    for key, slot in reversed(order):
        v = fp[key]
        for i in range(3):
            s = int(h[i][key])
            if s != slot:
                v ^= table[s]
        table[slot] = v
    return table


def fuse_stage(filt: BinaryFuse8, keys_u64: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32[3, n] positions, uint8[n] fingerprints) of the probes, hashed on
    the host and put on the table's device."""
    h, fp = fuse_hashes(np.asarray(keys_u64, np.uint64), filt.seed, filt.segment_length, filt.segment_count_length)
    dev = filt.fingerprints.device
    return torch.from_numpy(h.astype(np.int32)).to(dev), torch.from_numpy(fp).to(dev)


def fuse_query_plain(table: torch.Tensor, h: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """bool[n]: ``table[h0] ^ table[h1] ^ table[h2] == fp``, in torch ops, a
    position read as ``jnp.take`` reads it (the JAX ``_fuse_query_dev``): one
    in ``[-len, -1]`` wraps to ``len + p``, and one past either end reads 255."""
    size = table.numel()
    idx = h.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    inside = (idx >= 0) & (idx < size)
    t = torch.where(inside, table[idx.clamp(0, max(size - 1, 0))] if size else 0, 255).to(torch.uint8)
    return (t[0] ^ t[1] ^ t[2]) == fp


def fuse_query_cuda(table: torch.Tensor, h: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``fuse_query_plain`` by the ``fuse_query`` kernel, on the device."""
    build.require_cuda_bytes(table, "fuse_query table")
    build.require_cuda_bytes(fp, "fuse_query fingerprints")
    n = fp.numel()
    if h.dtype != torch.int32 or h.shape != (3, n) or not h.is_contiguous() or h.device != table.device or fp.device != table.device:
        raise ValueError(f"fuse_query: expected contiguous int32[3, {n}] positions on {table.device}, got {h.dtype}{tuple(h.shape)}")
    out = torch.empty(n, dtype=torch.bool, device=table.device)
    if n:
        lib = build.library()
        with torch.cuda.device(table.device):
            code = lib.sw_fuse_query(table.data_ptr(), table.numel(), h.data_ptr(), fp.data_ptr(), n, out.data_ptr(),
                                     build.stream_of(table))
        build.check(code, "fuse_query")
        LAUNCHES["fuse_query"] += 1
    return out


def fuse_query_probes(table: torch.Tensor, h: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """bool[n]: the answer of each staged probe, on the table's device."""
    fn = fuse_query_cuda if _on_card(table) else fuse_query_plain
    return fn(table, h, fp)


def fuse_query(filt: BinaryFuse8, keys_u64: np.ndarray) -> torch.Tensor:
    """bool[B] membership: the probes hashed on the host, then three gathers
    and an XOR compare on the table's device."""
    h, fp = fuse_stage(filt, keys_u64)
    return fuse_query_probes(filt.fingerprints, h, fp)
