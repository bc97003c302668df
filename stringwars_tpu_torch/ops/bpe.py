"""Byte-level BPE tokenization with a replicated merge table (K-BPE).

The port of ``stringwars_tpu.ops.bpe`` and the front half of
``stringwars_tpu.ops.bpe_pallas``: the north-star "regex-pre-split
byte-level tokenization with replicated merge/vocab tables" workload. Each
pretoken is one row of a ``(data uint8[B, W], lengths int32[B])`` batch, of
any width ``W`` (``PaddedTokens`` would round it up to a multiple of 4).

- ``MergeTable``: the merge table as three arrays, pair keys
  ``left << 16 | right`` (u32) sorted for a binary search, the merge rank
  and the new id. ``from_merges`` builds it from a merge list (ids
  ``256 + rank``); ``from_numpy`` takes the JAX table's arrays. Device
  copies are staged once per table and device and kept on the object,
  with the table the CUDA kernel reads: ``build_hashed``'s two-choice
  bucketed cuckoo hash (``HashedTable``), built once per table.
- ``lookup_hashed_plain``: the kernel's lookup in torch ops, bucket for
  bucket; ``_lookup`` is the binary search that ``bpe_encode_plain`` uses.
- ``train_merges``: the JAX package's greedy trainer, merge for merge (the
  most frequent adjacent pair, ties to the smaller pair ids, stop below a
  count of 2), kept incremental: pair counts and the words that hold each
  pair, and each merge recounts only the words that hold its pair.
- ``bpe_encode_ref``: the sequential oracle.
- ``bpe_encode_plain``: ``_encode_impl`` with the binary-search lookup of
  ``_bpe_encode`` in torch ops. Each iteration merges every occurrence of
  each row's minimum-rank pair (overlapping runs left to right by parity);
  merged-away slots become -1 holes; one stable compaction follows the loop.
- ``bpe_encode`` / ``bpe_encode_fused``: the dispatchers, under the JAX
  names. A CUDA batch of width 1..32 takes the CUDA kernel
  (``ops/bpe_cuda.py``, rows in lane groups of a warp); a wider one takes
  ``bpe_encode_plain`` on the card, where the JAX package sends it
  (``bpe_pallas.py:226-227`` -> ``bpe.bpe_encode``): a route by shape. A CPU
  batch takes ``bpe_encode_plain``.

Not ported: ``MergeTable.rule_maps`` and ``_rule_encoder``. They walk the
table as sparse range rules because gathers are slow on a TPU; the card
reads a hashed table directly.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter, defaultdict

import numpy as np
import torch

INF = 0x7FFFFFFF  # rank of a pair that no merge names
KEY_SHIFT = 16  # ids < 2^16: key = left << 16 | right
MAX_MERGES = (1 << 16) - 256
KERNEL_WIDTH = 32  # rows up to this width take the kernel: a lane a slot
_M32 = 0xFFFFFFFF
HASH_SLOTS = 2  # entries a bucket of the hashed table: 16 bytes, one load
EMPTY_VALUE = 0xFFFFFFFF  # an empty entry's value: no rank reaches 0xFFFF
_MAX_KICKS = 256  # entries moved before an insertion gives up on a multiplier pair
_MAX_ATTEMPTS = 64  # multiplier pairs drawn before the build gives up


@dataclasses.dataclass(frozen=True)
class HashedTable:
    """A merge table as a two-choice bucketed cuckoo hash, as
    ``csrc/bpe.cu`` reads it. ``buckets`` is uint32[nb, 2, 2]: each entry
    (key, rank << 16 | new id), an empty one (``empty_key``, EMPTY_VALUE),
    where ``empty_key`` is no merge's key. Key k lies in one of its two
    buckets, ``(k * mults[i] mod 2^32) >> shift``, nb = 2^(32 - shift).
    ``attempts``: the multiplier pairs drawn; ``kicks``: the entries the
    last attempt moved to their other bucket."""

    buckets: np.ndarray
    mults: tuple[int, int]
    shift: int
    empty_key: int
    attempts: int
    kicks: int


def bucket_of(keys: np.ndarray, mult: int, shift: int) -> np.ndarray:
    """int64: the bucket ``(key * mult mod 2^32) >> shift`` of each u32 key."""
    return (((keys.astype(np.uint64) * np.uint64(mult)) & np.uint64(_M32)) >> np.uint64(shift)).astype(np.int64)


def build_hashed(keys, values, seed: int = 0) -> HashedTable:
    """Place each ``keys[i]`` (u32, unique) with ``values[i]`` (u32, never
    EMPTY_VALUE) by cuckoo insertion into nb buckets of 2, nb the smallest
    power of two (at least 2) that keeps the load at or under one half.
    The odd multipliers come from ``numpy.random.default_rng(seed)``, drawn
    again until every key is placed; the kicks' choices too, so a seed
    gives one table."""
    keys = np.asarray(keys).astype(np.uint32)
    values = np.asarray(values).astype(np.uint32)
    if keys.ndim != 1 or values.shape != keys.shape:
        raise ValueError(f"expected keys and values of one length, got {keys.shape}, {values.shape}")
    if np.unique(keys).size != keys.size:
        raise ValueError("duplicate keys")
    if (values == EMPTY_VALUE).any():
        raise ValueError(f"a value may not be {EMPTY_VALUE:#x}, the empty entry's")
    bits = 1
    while (HASH_SLOTS << bits) < 2 * keys.size:
        bits += 1
    nb, shift = 1 << bits, 32 - bits
    empty_key = int(np.setdiff1d(np.arange(keys.size + 1, dtype=np.uint32), keys)[0])  # the smallest u32 that is no key
    rng = np.random.default_rng(seed)
    for attempt in range(1, _MAX_ATTEMPTS + 1):
        mults = tuple(int(m) | 1 for m in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
        homes = np.stack([bucket_of(keys, m, shift) for m in mults], 1).tolist()
        slots = [[] for _ in range(nb)]  # key indices a bucket
        kicks = 0
        placed = True
        for i in range(keys.size):
            item = i
            for _ in range(_MAX_KICKS):
                b1, b2 = homes[item]
                if len(slots[b1]) < HASH_SLOTS:
                    slots[b1].append(item)
                    item = -1
                    break
                if len(slots[b2]) < HASH_SLOTS:
                    slots[b2].append(item)
                    item = -1
                    break
                # Both full: take a random entry's place, and move that entry on.
                b = (b1, b2)[int(rng.integers(2))]
                j = int(rng.integers(HASH_SLOTS))
                slots[b][j], item = item, slots[b][j]
                kicks += 1
            if item >= 0:
                placed = False
                break
        if placed:
            buckets = np.empty((nb, HASH_SLOTS, 2), np.uint32)
            buckets[:, :, 0], buckets[:, :, 1] = empty_key, EMPTY_VALUE
            for b, items in enumerate(slots):
                for j, item in enumerate(items):
                    buckets[b, j] = keys[item], values[item]
            buckets.setflags(write=False)
            return HashedTable(buckets, mults, shift, empty_key, attempt, kicks)
    raise ValueError(f"no multiplier pair placed {keys.size} keys in {nb} buckets after {_MAX_ATTEMPTS} draws")


@dataclasses.dataclass(frozen=True)
class MergeTable:
    """Replicated dense merge table: keys sorted for binary search."""

    sorted_keys: np.ndarray  # uint32 [M]
    ranks: np.ndarray  # int32 [M] (lower merges first)
    new_ids: np.ndarray  # int32 [M]
    vocab_size: int
    # The arrays staged per device, kept on the object (they live as long as it).
    staged: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(self.sorted_keys.shape[0])

    @classmethod
    def from_merges(cls, merges: list[tuple[int, int]]) -> "MergeTable":
        """``merges[r]`` = (left_id, right_id) merged at rank r into id
        ``256 + r`` (byte-level base vocabulary)."""
        if len(merges) > MAX_MERGES:
            raise ValueError("too many merges for 16-bit ids")
        keys = np.array([(left << KEY_SHIFT) | right for left, right in merges], np.uint32)
        if np.unique(keys).shape[0] != keys.shape[0]:
            raise ValueError("duplicate merge pairs")
        ranks = np.arange(len(merges), dtype=np.int32)
        order = np.argsort(keys)
        return cls.from_numpy(keys[order], ranks[order], 256 + ranks[order], 256 + len(merges))

    @classmethod
    def from_numpy(cls, sorted_keys, ranks, new_ids, vocab_size: int) -> "MergeTable":
        """Take a merge table's arrays (the JAX ``MergeTable``'s as numpy):
        keys strictly ascending, ranks and new ids in [0, 2^16)."""
        keys = np.asarray(sorted_keys).astype(np.uint32)
        ranks = np.asarray(ranks).astype(np.int32)
        new_ids = np.asarray(new_ids).astype(np.int32)
        if keys.ndim != 1 or ranks.shape != keys.shape or new_ids.shape != keys.shape:
            raise ValueError(f"expected three arrays of one length, got {keys.shape}, {ranks.shape}, {new_ids.shape}")
        if keys.size > MAX_MERGES:
            raise ValueError("too many merges for 16-bit ids")
        if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
            raise ValueError("keys must be sorted and unique")
        for name, a in (("ranks", ranks), ("new ids", new_ids)):
            if a.size and (a.min() < 0 or a.max() >= 1 << 16):
                raise ValueError(f"{name} must lie in [0, 2^16)")
        for a in (keys, ranks, new_ids):
            a.setflags(write=False)
        return cls(keys, ranks, new_ids, int(vocab_size))

    def hashed(self) -> HashedTable:
        """The table as the kernel reads it (``build_hashed``, seed 0), built
        once: entries ``(key, rank << 16 | new_id)``."""
        if "hashed" not in self.staged:
            values = (self.ranks.astype(np.uint32) << 16) | self.new_ids.astype(np.uint32)
            self.staged["hashed"] = build_hashed(self.sorted_keys, values)
        return self.staged["hashed"]

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(keys int64[M], ranks int32[M], new_ids int32[M], buckets
        int32[nb, 4])`` on ``device``; ``buckets`` holds ``hashed()``'s
        entries as the kernel reads them, key then value (u32 bits)."""
        device = torch.device(device)
        if device not in self.staged:
            buckets = self.hashed().buckets.reshape(-1, 2 * HASH_SLOTS)
            self.staged[device] = (
                torch.from_numpy(self.sorted_keys.astype(np.int64)).to(device),
                torch.from_numpy(self.ranks.copy()).to(device),
                torch.from_numpy(self.new_ids.copy()).to(device),
                torch.from_numpy(buckets.view(np.int32).copy()).to(device),
            )
        return self.staged[device]


def _merge_word(seq: list[int], left: int, right: int, new_id: int) -> list[int]:
    out = []
    i = 0
    while i < len(seq):
        if i + 1 < len(seq) and seq[i] == left and seq[i + 1] == right:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


def train_merges(corpus_tokens: list[bytes], n_merges: int) -> list[tuple[int, int]]:
    """Greedy BPE trainer (host): repeatedly merge the most frequent
    adjacent pair across the (deduplicated, counted) pretokens, the larger
    count first, then the smaller pair ids; stop when no pair occurs twice.

    The JAX trainer recounts every pair for each merge. Here the counts are
    kept: a heap of (-count, left, right), whose stale entries are skipped,
    and for each pair the words that hold it; a merge recounts only those
    words. The merges are the same, one for one."""
    word_counts = Counter(corpus_tokens)
    words = [list(w) for w in word_counts if len(w) > 0]
    freq = [c for w, c in word_counts.items() if len(w) > 0]
    pair_counts: dict[tuple[int, int], int] = defaultdict(int)
    holders: dict[tuple[int, int], set[int]] = defaultdict(set)
    for wi, seq in enumerate(words):
        for pair in zip(seq, seq[1:]):
            pair_counts[pair] += freq[wi]
            holders[pair].add(wi)
    heap = [(-c, a, b) for (a, b), c in pair_counts.items()]
    heapq.heapify(heap)
    merges: list[tuple[int, int]] = []
    while len(merges) < n_merges:
        while heap and pair_counts.get((heap[0][1], heap[0][2]), 0) != -heap[0][0]:
            heapq.heappop(heap)  # stale: the pair's count changed since
        if not heap or -heap[0][0] < 2:
            break
        _, left, right = heap[0]
        new_id = 256 + len(merges)
        merges.append((left, right))
        delta: dict[tuple[int, int], int] = defaultdict(int)
        for wi in holders.pop((left, right)):
            seq, c = words[wi], freq[wi]
            merged = _merge_word(seq, left, right, new_id)
            old_pairs, new_pairs = list(zip(seq, seq[1:])), list(zip(merged, merged[1:]))
            for pair in old_pairs:
                delta[pair] -= c
            for pair in new_pairs:
                delta[pair] += c
            for pair in set(old_pairs) - set(new_pairs) - {(left, right)}:
                holders[pair].discard(wi)
            for pair in set(new_pairs):
                holders[pair].add(wi)
            words[wi] = merged
        for pair, d in delta.items():
            if d:
                count = pair_counts[pair] + d
                if count:
                    pair_counts[pair] = count
                    heapq.heappush(heap, (-count, *pair))
                else:
                    del pair_counts[pair]
    return merges


def bpe_encode_ref(token: bytes, merges: list[tuple[int, int]]) -> list[int]:
    """Scalar oracle: greedy lowest-rank-first, ties merged left-to-right."""
    rank = {pair: r for r, pair in enumerate(merges)}
    seq = list(token)
    while len(seq) > 1:
        best = min((rank.get((a, b), 1 << 30) for a, b in zip(seq, seq[1:])), default=1 << 30)
        if best >= 1 << 30:
            break
        left, right = merges[best]
        seq = _merge_word(seq, left, right, 256 + best)
    return seq


def pack_rows(tokens: list[bytes], width: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """``(data uint8[B, W], lengths int32[B])`` of byte strings, zero-padded;
    ``W`` the longest (at least 1) unless given. Built with numpy, not row
    by row."""
    lengths = np.fromiter(map(len, tokens), np.int64, len(tokens))
    W = max(int(lengths.max(initial=0)), 1) if width is None else int(width)
    if lengths.size and lengths.max() > W:
        raise ValueError(f"a token of {int(lengths.max())} bytes does not fit width {W}")
    flat = np.frombuffer(b"".join(tokens), np.uint8)
    data = np.zeros((len(tokens), W), np.uint8)
    starts = np.cumsum(lengths) - lengths
    data[np.repeat(np.arange(len(tokens)), lengths), np.arange(flat.size) - np.repeat(starts, lengths)] = flat
    return data, lengths.astype(np.int32)


def check_batch(data: torch.Tensor, lengths: torch.Tensor, table: MergeTable) -> None:
    """The checks every encoder makes on its arguments."""
    if not isinstance(table, MergeTable):
        raise ValueError(f"expected a MergeTable, got {type(table).__name__}")
    if not isinstance(data, torch.Tensor) or data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"expected uint8 rows [B, W], got {getattr(data, 'dtype', type(data))}{tuple(getattr(data, 'shape', ()))}")
    if lengths.shape != (data.shape[0],) or lengths.device != data.device:
        raise ValueError(f"expected {data.shape[0]} lengths on {data.device}, got {tuple(lengths.shape)} on {lengths.device}")


def _lookup(keys: torch.Tensor, table: MergeTable) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, new id) of each pair key, (INF, -1) where no merge names it."""
    sorted_keys, ranks, new_ids, _ = table.on(keys.device)
    if table.size == 0:
        return torch.full_like(keys, INF, dtype=torch.int32), torch.full_like(keys, -1, dtype=torch.int32)
    idx = torch.searchsorted(sorted_keys, keys).clamp(max=table.size - 1)
    hit = sorted_keys[idx] == keys
    return torch.where(hit, ranks[idx], INF), torch.where(hit, new_ids[idx], -1)


def lookup_hashed_plain(keys: torch.Tensor, table: MergeTable) -> tuple[torch.Tensor, torch.Tensor]:
    """``_lookup`` as the kernel does it, in torch ops: each u32 key's two
    buckets of ``table.hashed()`` and the value of the entry that holds
    it, EMPTY_VALUE for none (an empty entry's key is no merge's)."""
    hashed = table.hashed()
    buckets = table.on(keys.device)[3].to(torch.int64) & _M32  # [nb, 4]: key, value, key, value
    k = keys.to(torch.int64) & _M32
    value = torch.full_like(k, EMPTY_VALUE)
    for mult in hashed.mults:
        # (k * mult) mod 2^32 from 16-bit halves of mult: no product reaches 2^63.
        low = (k * (mult & 0xFFFF) + (((k * (mult >> 16)) & 0xFFFF) << 16)) & _M32
        entries = buckets[low >> hashed.shift]
        hit = torch.where(entries[..., 0::2] == k[..., None], entries[..., 1::2], EMPTY_VALUE)
        value = torch.minimum(value, hit.min(-1).values)
    found = value != EMPTY_VALUE
    return (torch.where(found, value >> 16, INF).to(torch.int32),
            torch.where(found, value & 0xFFFF, -1).to(torch.int32))


def bpe_encode_plain(data: torch.Tensor, lengths: torch.Tensor, table: MergeTable, *,
                     work: bool = False):
    """Encode every row: ``(ids int32[B, W] with -1 padding, counts
    int32[B])``, in torch ops on the batch's device. Lengths are clamped to
    [0, W]. With ``work``, also what each row's merge loop does, as a dict
    of int32[B]: ``iterations``, its merging rounds and the one that finds
    no pair; ``slots``, its alive slots summed over those iterations;
    ``pairs``, the alive slots with an alive slot to their right (the pairs
    looked up) summed over them."""
    check_batch(data, lengths, table)
    B, W = data.shape
    dev = data.device
    pos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    counts = lengths.to(torch.int32).clamp(0, W)
    ids = torch.where(pos < counts[:, None], data.to(torch.int32), -1)
    rounds = torch.ones(B, dtype=torch.int32, device=dev)
    slots, pairs = torch.zeros_like(rounds), torch.zeros_like(rounds)
    active = torch.ones(B, dtype=torch.bool, device=dev)  # rows that have not found their quiescence
    for _ in range(max(W - 1, 1) if B and W else 0):
        alive = ids >= 0
        # The nearest alive slot strictly right of each slot (W: none).
        at_or_right = torch.where(alive, pos, W).flip(1).cummin(1).values.flip(1)
        nxt_pos = torch.cat([at_or_right[:, 1:], torch.full((B, 1), W, dtype=torch.int32, device=dev)], 1)
        valid = alive & (nxt_pos < W)
        if work:
            slots += torch.where(active, alive.sum(1, dtype=torch.int32), 0)
            pairs += torch.where(active, valid.sum(1, dtype=torch.int32), 0)
        nxt = ids.gather(1, nxt_pos.clamp(max=W - 1).to(torch.int64))
        keys = (ids.to(torch.int64) << KEY_SHIFT) | (nxt.to(torch.int64) & 0xFFFF)
        rank, new = _lookup(keys, table)
        r = torch.where(valid, rank, INF)
        best = r.min(1, keepdim=True).values
        m = (r == best) & (best < INF)
        if not bool(m.any()):
            break
        rounds += (best[:, 0] < INF).to(torch.int32)
        active &= best[:, 0] < INF
        # Left-to-right overlap runs over alive slots: a match extends the
        # run, an alive non-match resets it, a hole leaves it; odd run
        # positions merge ("aaaa" -> aa, aa).
        matched = torch.cumsum((alive & m).to(torch.int32), 1, dtype=torch.int32)
        at_reset = torch.where(alive & ~m, matched, 0).cummax(1).values
        do = m & (((matched - at_reset) & 1) == 1)
        # The merged pair's right partner: the next alive slot after a do.
        at_or_left = torch.where(alive, pos, -1).cummax(1).values
        prev_pos = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev), at_or_left[:, :-1]], 1)
        eaten = alive & (prev_pos >= 0) & do.gather(1, prev_pos.clamp(min=0).to(torch.int64))
        ids = torch.where(eaten, -1, torch.where(do, new, ids))
        counts = counts - do.sum(1, dtype=torch.int32)
    else:
        # The loop ran out: a row still merging has made W - 1 merges, and
        # its last iteration, on the one slot left, finds no pair.
        slots += torch.where(active, (ids >= 0).sum(1, dtype=torch.int32), 0)
    # One stable compaction after the loop (holes sort last), as one sort of
    # (hole-last position << 16 | id): ids fit 16 bits.
    sort_keys = torch.where(ids >= 0, pos, W + pos).to(torch.int64)
    vals = (torch.sort((sort_keys << 16) | (ids.to(torch.int64) & 0xFFFF), 1).values & 0xFFFF).to(torch.int32)
    out = torch.where(pos < counts[:, None], vals, -1)
    if not work:
        return out, counts
    return out, counts, {"iterations": rounds, "slots": slots, "pairs": pairs}


def bpe_encode(data: torch.Tensor, lengths: torch.Tensor, table: MergeTable) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode every pretoken row: ``(ids int32[B, W] with -1 padding, counts
    int32[B])``. The CUDA kernel for a CUDA batch of width 1..32; a wider
    CUDA batch, and any CPU batch, take ``bpe_encode_plain``."""
    if data.device.type == "cuda" and 1 <= data.shape[-1] <= KERNEL_WIDTH:
        from stringwars_tpu_torch.ops import bpe_cuda

        return bpe_cuda.bpe_encode(data, lengths, table)
    if data.device.type in ("cuda", "cpu"):
        return bpe_encode_plain(data, lengths, table)
    raise ValueError(f"bpe_encode runs on a CUDA or CPU tensor, not {data.device}")


# The JAX package's fused-kernel entry point; here the dispatcher above
# already takes the kernel for the widths the fused kernel covers.
bpe_encode_fused = bpe_encode
