"""Exact substring and byteset search: plain torch versions and dispatch.

The port of ``stringwars_tpu.ops.find``. The reference benchmarks
all-matches substring scans (forward find and backward rfind loops,
``find/bench.rs:56-219``) and byteset scans over three charsets
(``find/bench.rs:226-348``):

- ``find_count``: the number of window starts ``p <= n - m`` with
  ``hay[p:p+m] == needle``; overlapping matches count.
- ``rfind_count``: that count and the LAST such ``p`` (-1 when none).
- ``find_count_batch``: one count per needle of a ``NeedleBatch``
  (``find_counts``: the same as a tensor on the device, unwaited).
- ``byteset_count``: how many bytes of ``hay[:n]`` belong to a set
  (``byteset_counts``: several sets, one device sync).
- ``cp_window_count``: the ``find_count`` of an int32 needle in an int32
  codepoint stream (the uncased find over a folded haystack), as a 0-d
  int64 tensor on the stream's device; any needle length.

Each public function takes the hand-written CUDA kernels of
``ops/find_cuda.py`` for a CUDA tensor and the plain torch versions below
for a CPU tensor. Results are Python ints; counts are 64-bit throughout.

Needles are staged as in the JAX package (``pack_needle``: four
offset-shifted little-endian u32 images with byte masks, the same bytes), so
a needle packed there converts one to one (``PackedNeedle.from_numpy``). The
kernels read the offset-0 image, which holds the needle's bytes.

The count kernel scans a batch in one pass: each window's head is probed in
filter tables built here on the host from the batch's needles
(``FilterTable``, staged once per batch and device), and only the needles
whose head it matches are verified. ``filtered_count_plain`` walks the same
tables window by window on the host, for the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Needle capacity buckets, in u32 words (16 B / 64 B / 256 B needles).
NEEDLE_WORD_BUCKETS = (4, 16, 64)

# The count kernel's filter tables (csrc/find.cu, K2).
FILTER_CHUNK = 1024  # needles one block counts in shared memory; larger batches take more blocks a tile
KEY_MUL = 0x9E3779B1  # slot of a head key: (key * KEY_MUL mod 2^32) >> shift
SLOT_BITS = (10, 15)  # a filter's slots: 2^10 to 2^15, 32 for each distinct key
PREFIX = 16  # needle bytes kept beside the pairs, compared as words
RECORD = 10 + 4 * 4  # int32s of a chunk's record: 10, then 4 for each of up to four filters
LAST_PAIR = 0x8000  # flags the last (key, needle) pair of a slot


@dataclasses.dataclass(frozen=True)
class PackedNeedle:
    """A needle staged as in the JAX package's packed-word scan.

    ``words[o, k]`` is the k-th LE u32 of the needle as it appears when the
    window starts at byte offset ``o`` (mod 4) — the needle shifted right by
    ``o`` bytes; ``masks[o, k]`` holds the valid-byte mask. ``length`` is m.
    """

    words: torch.Tensor  # uint32[4, K]
    masks: torch.Tensor  # uint32[4, K]
    length: int

    @property
    def capacity(self) -> int:
        return self.words.shape[1]

    @classmethod
    def from_numpy(cls, words: np.ndarray, masks: np.ndarray, length) -> "PackedNeedle":
        """Take a needle packed by the JAX package (its arrays as numpy)."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        masks = np.ascontiguousarray(masks, dtype=np.uint32)
        if words.ndim != 2 or words.shape[0] != 4 or words.shape != masks.shape:
            raise ValueError(f"expected words and masks of shape [4, K], got {words.shape} and {masks.shape}")
        return cls(words=torch.from_numpy(words.copy()), masks=torch.from_numpy(masks.copy()), length=int(length))

    def needle_bytes(self) -> torch.Tensor:
        """The offset-0 image as bytes: the needle, zero past ``length``."""
        return self.words[0].contiguous().view(torch.uint8)


def pack_needle(needle: bytes, capacity_words: int | None = None) -> PackedNeedle:
    """Host-side staging of a needle (≤ 4*capacity-3 bytes)."""
    m = len(needle)
    if m == 0:
        raise ValueError("empty needle")
    if capacity_words is None:
        need = (m + 3 + 3) // 4  # worst-case offset-3 image
        capacity_words = next((b for b in NEEDLE_WORD_BUCKETS if b >= need), need)
    words = np.zeros((4, capacity_words), dtype=np.uint32)
    masks = np.zeros((4, capacity_words), dtype=np.uint32)
    for o in range(4):
        shifted = bytes(o) + needle  # needle as seen from word-aligned start
        padded = shifted + bytes(-len(shifted) % 4)
        image = np.frombuffer(padded, dtype="<u4")
        k = image.shape[0]
        if k > capacity_words:
            raise ValueError(f"needle of {m} bytes exceeds capacity {capacity_words} words")
        words[o, :k] = image
        mask_bytes = (b"\x00" * o + b"\xff" * m) + bytes(-(o + m) % 4)
        masks[o, :k] = np.frombuffer(mask_bytes, dtype="<u4")
        words[o] &= masks[o]
    return PackedNeedle(words=torch.from_numpy(words), masks=torch.from_numpy(masks), length=m)


@dataclasses.dataclass(frozen=True)
class NeedleBatch:
    """Needles staged on one device for a single batched scan.

    Row ``i`` of ``images`` holds needle ``i``'s bytes, zero past its
    length; ``lengths`` is int64 on the same device, ``host_lengths`` the
    same values on the host (for checks that must not wait on the device).
    """

    images: torch.Tensor  # uint8[B, S]
    lengths: torch.Tensor  # int64[B]
    host_lengths: tuple[int, ...]
    host_images: torch.Tensor | None = None  # the images on the host, where the batch was built there
    # FilterTable by device, staged at the first count on that device.
    staged: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def size(self) -> int:
        return len(self.host_lengths)

    def filters(self, device) -> "FilterTable":
        """The batch's filter tables on ``device``, built once."""
        got = self.staged.get(device)
        if got is None:
            images = self.host_images if self.host_images is not None else self.images.cpu()
            got = self.staged[device] = FilterTable.build(images.numpy(), self.host_lengths, device)
        return got

    @classmethod
    def from_needles(cls, needles: Sequence[PackedNeedle], device=None) -> "NeedleBatch":
        if not needles:
            raise ValueError("empty needle batch")
        width = max(4 * nd.capacity for nd in needles)
        images = torch.zeros((len(needles), width), dtype=torch.uint8)
        for i, nd in enumerate(needles):
            row = nd.needle_bytes()
            images[i, : row.numel()] = row
        lengths = tuple(nd.length for nd in needles)
        return cls(
            images=images.to(device),
            lengths=torch.tensor(lengths, dtype=torch.int64, device=device),
            host_lengths=lengths,
            host_images=images,
        )

    def row(self, i: int) -> "NeedleBatch":
        """Needle ``i`` alone, as a batch of one (a view of this batch's rows)."""
        host = self.host_images[i : i + 1] if self.host_images is not None else None
        return NeedleBatch(self.images[i : i + 1], self.lengths[i : i + 1], self.host_lengths[i : i + 1], host)


@dataclasses.dataclass(frozen=True)
class FilterTable:
    """The count kernel's probe tables for a batch, one int32 array.

    The batch is cut into chunks of ``FILTER_CHUNK`` needles (one block of
    the kernel counts one chunk over one tile). A needle's key is its first
    ``L = min(4, m)`` bytes as a little-endian word; each chunk has one
    filter for each ``L`` present, of 2^bits slots, slot ``(key * KEY_MUL
    mod 2^32) >> (32 - bits)``: a bitmap of the slots its keys take (the
    block's shared memory holds the chunk's bitmaps) and a map of uint16s,
    0 for a free slot, else 1 + the index of the slot's first (key, needle)
    pair. The array holds a record of ``RECORD`` int32s for each chunk
    (first needle, end, longest needle, filters, bitmaps at, bitmap words,
    pairs at, prefixes at, lengths at, its first needle's key (the one key
    where ``filters`` is 0); then for each filter: L, shift, bitmap offset
    (in the chunk's bitmap words), map at), then each chunk's data, every
    part at an index of the array aligned to 16 bytes:

    - the bitmaps of its filters (uint32 words), one after another;
    - the maps (uint16);
    - the pairs, two uint32s each: the key, and the needle's index in the
      chunk with ``LAST_PAIR`` set on a slot's last pair;
    - the first ``PREFIX`` bytes of each needle (zero past its length);
    - each needle's length (int32).
    """

    table: torch.Tensor  # int32, on the device of the count
    chunks: int
    filters: int  # the most filters of a chunk; 0: one chunk of one filter, its needles of one key
    bitmap_words: int  # the largest chunk's bitmaps

    @staticmethod
    def build(images: np.ndarray, lengths: Sequence[int], device=None) -> "FilterTable":
        """The tables of needles ``images[i, :lengths[i]]``, on ``device``."""
        lengths = np.asarray(lengths, np.int64)
        count = lengths.size
        prefix = np.zeros((count, PREFIX), np.uint8)
        prefix[:, : min(PREFIX, images.shape[1])] = images[:, :PREFIX]
        prefix[np.arange(PREFIX)[None, :] >= lengths[:, None]] = 0
        key_len = np.minimum(lengths, 4)
        keys = prefix[:, :4].copy().view("<u4")[:, 0] & key_mask(key_len)
        chunks = -(-count // FILTER_CHUNK)
        records = np.zeros((chunks, RECORD), np.int64)
        parts: list[np.ndarray] = []
        at = -(-chunks * RECORD // 4) * 4  # where the next part begins

        def place(words: np.ndarray) -> int:
            nonlocal at
            words = np.concatenate([words.astype(np.uint32), np.zeros(-words.size % 4, np.uint32)])
            parts.append(words)
            at += words.size
            return at - words.size

        parts.append(np.zeros(at - chunks * RECORD, np.uint32))
        for c in range(chunks):
            lo, hi = c * FILTER_CHUNK, min(count, (c + 1) * FILTER_CHUNK)
            filters = []  # (L, bits, needles in slot order, their slots)
            for L in (1, 2, 3, 4):
                idx = lo + np.flatnonzero(key_len[lo:hi] == L)
                if idx.size:
                    bits = int(np.clip(np.ceil(np.log2(32 * np.unique(keys[idx]).size)), *SLOT_BITS))
                    slots = slot_of(keys[idx], 32 - bits)
                    order = np.argsort(slots, kind="stable")
                    filters.append((L, bits, idx[order], slots[order]))
            bitmaps, maps, pair_rows, offset, pairs_so_far = [], [], [], 0, 0
            for f, (L, bits, idx, slots) in enumerate(filters):
                bitmap = np.zeros((1 << bits) // 32, np.uint32)
                np.bitwise_or.at(bitmap, slots >> 5, np.uint32(1) << (slots & 31).astype(np.uint32))
                first = np.flatnonzero(np.r_[True, slots[1:] != slots[:-1]])
                slot_map = np.zeros(1 << bits, np.uint16)
                slot_map[slots[first]] = 1 + pairs_so_far + first
                tags = (idx - lo).astype(np.uint32)
                tags[np.r_[first[1:] - 1, slots.size - 1]] |= LAST_PAIR
                pair_rows.append(np.stack([keys[idx], tags], 1))
                records[c, 10 + 4 * f : 13 + 4 * f] = (L, 32 - bits, offset)
                bitmaps.append(bitmap)
                maps.append(slot_map)
                offset += bitmap.size
                pairs_so_far += idx.size
            records[c, :6] = (lo, hi, lengths[lo:hi].max(), len(filters), place(np.concatenate(bitmaps)), offset)
            for f, slot_map in enumerate(maps):
                records[c, 13 + 4 * f] = place(slot_map.view(np.uint32))
            records[c, 6] = place(np.concatenate(pair_rows).reshape(-1))
            records[c, 7] = place(prefix[lo:hi].view(np.uint32).reshape(-1))
            records[c, 8] = place(lengths[lo:hi])
            records[c, 9] = keys[lo]
        flat = np.concatenate([records.reshape(-1).astype(np.uint32), *parts])
        table = torch.from_numpy(flat.view(np.int32))
        one_key = chunks == 1 and int(records[0, 3]) == 1 and np.unique(keys).size == 1
        return FilterTable(table=table.to(device), chunks=chunks, filters=0 if one_key else int(records[:, 3].max()),
                           bitmap_words=int(records[:, 5].max()))

    def chunk(self, c: int) -> dict:
        """Chunk ``c``'s record and parts, as arrays on the host: ``lo``,
        ``hi``, ``longest``, ``key`` (its first needle's key); ``filters``, a
        list of (L, shift, bitmap, map); ``pairs`` uint32[n, 2], ``prefix``
        uint8[n, PREFIX], ``lengths``."""
        table = self.table.cpu().numpy().view(np.uint32)
        r = table[c * RECORD : (c + 1) * RECORD].astype(np.int64)
        lo, hi, longest, count = r[0], r[1], r[2], r[1] - r[0]
        filters = []
        for f in range(r[3]):
            L, shift, offset, map_at = r[10 + 4 * f : 14 + 4 * f]
            slots = 1 << (32 - shift)
            bitmap = table[r[4] + offset : r[4] + offset + slots // 32]
            filters.append((int(L), int(shift), bitmap, table[map_at : map_at + slots // 2].view(np.uint16)))
        return {
            "lo": int(lo), "hi": int(hi), "longest": int(longest), "key": int(r[9]), "filters": filters,
            "pairs": table[r[6] : r[6] + 2 * count].reshape(-1, 2),
            "prefix": table[r[7] : r[7] + 4 * count].view(np.uint8).reshape(-1, PREFIX),
            "lengths": table[r[8] : r[8] + count].astype(np.int64),
        }


def key_mask(key_len) -> np.ndarray:
    """uint32 masks of the first ``key_len`` (1..4) bytes of a little-endian word."""
    return ((np.int64(1) << (8 * np.asarray(key_len, np.int64))) - 1).astype(np.uint32)


def slot_of(keys: np.ndarray, shift: int) -> np.ndarray:
    """Filter slots of uint32 keys: ``(key * KEY_MUL mod 2^32) >> shift``."""
    return ((np.asarray(keys, np.uint64) * np.uint64(KEY_MUL)) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)


def filtered_count_plain(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(counts, lasts), int64[B] on the host: the count kernel's walk of the
    batch's ``FilterTable``, window by window (vectorized over the windows):
    each window's head probes every filter of every chunk (with ``filters``
    0, as the kernel's one-key instance does, only the first filter, by
    comparing the head with the chunk's key); a set bit leads through the
    map to the slot's (key, needle) pairs up to the one flagged last; a pair
    whose key equals the head and whose needle fits before ``n`` is verified
    past the head, against the needle's prefix and then its bytes."""
    n = _extent(hay, n)
    tables = batch.filters(torch.device("cpu"))
    images = (batch.host_images if batch.host_images is not None else batch.images.cpu()).numpy()
    padded = np.zeros(n + 4, np.uint8)
    padded[:n] = hay[:n].cpu().numpy()
    heads = sum(padded[b : b + n].astype(np.uint32) << np.uint32(8 * b) for b in range(4))
    counts = np.zeros(batch.size, np.int64)
    lasts = np.full(batch.size, -1, np.int64)
    for c in range(tables.chunks):
        chunk = tables.chunk(c)
        lo, pairs, prefix, lengths = chunk["lo"], chunk["pairs"], chunk["prefix"], chunk["lengths"]
        for L, shift, bitmap, slot_map in chunk["filters"][: 1 if tables.filters == 0 else None]:
            key = heads & key_mask(L)
            slot = slot_of(key, shift).astype(np.int64)
            if tables.filters == 0:
                window = np.flatnonzero(key == chunk["key"])
            else:
                window = np.flatnonzero((bitmap[slot >> 5] >> (slot & 31).astype(np.uint32)) & 1)
            entry = slot_map[slot[window]].astype(np.int64) - 1
            while window.size:  # one pair of each candidate slot a round, up to the last
                tag = pairs[entry, 1]
                needle = (tag & ~np.uint32(LAST_PAIR)).astype(np.int64)
                m = lengths[needle]
                ok = (pairs[entry, 0] == key[window]) & (window <= n - m)
                for b in range(L, int(m[ok].max(initial=L))):
                    live = ok & (b < m)
                    want = prefix[needle[live], b] if b < PREFIX else images[lo + needle[live], b]
                    ok[live] &= padded[window[live] + b] == want
                counts += np.bincount(lo + needle[ok], minlength=batch.size)
                np.maximum.at(lasts, lo + needle[ok], window[ok])
                more = (tag & LAST_PAIR) == 0
                window, entry = window[more], entry[more] + 1
    return counts, lasts


def _extent(hay: torch.Tensor, n: int | None) -> int:
    if hay.dim() != 1 or hay.dtype != torch.uint8:
        raise ValueError(f"expected a 1-D uint8 haystack, got {hay.dtype} of shape {tuple(hay.shape)}")
    n = hay.numel() if n is None else int(n)
    if not 0 <= n <= hay.numel():
        raise ValueError(f"n={n} outside a haystack of {hay.numel()} bytes")
    return n


# ---------------------------------------------------------------------------
# Plain torch versions: the CPU path, and the comparison for the kernels
# ---------------------------------------------------------------------------

def match_starts_plain(hay: torch.Tensor, needle: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted int64 starts of all (overlapping) matches of ``needle`` in ``hay[:n]``.

    Candidates are the positions of the first byte; each further needle
    byte filters them, so the work is one pass plus the survivors.
    """
    m = needle.numel()
    if m == 0 or m > n:
        return torch.zeros(0, dtype=torch.int64, device=hay.device)
    starts = torch.nonzero(hay[: n - m + 1] == needle[0]).squeeze(1)
    for j in range(1, m):
        if starts.numel() == 0:
            break
        starts = starts[hay[starts + j] == needle[j]]
    return starts


def find_count_batch_plain(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> torch.Tensor:
    """int64[B]: per-needle all-matches counts over ``hay[:n]``."""
    n = _extent(hay, n)
    counts = [
        match_starts_plain(hay, batch.images[i, :m], n).numel() for i, m in enumerate(batch.host_lengths)
    ]
    return torch.tensor(counts, dtype=torch.int64, device=hay.device)


def rfind_count_batch_plain(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None):
    """(counts, lasts), both int64[B]: counts and LAST match starts (-1 if none)."""
    n = _extent(hay, n)
    counts, lasts = [], []
    for i, m in enumerate(batch.host_lengths):
        starts = match_starts_plain(hay, batch.images[i, :m], n)
        counts.append(starts.numel())
        lasts.append(int(starts[-1]) if starts.numel() else -1)
    as_tensor = lambda xs: torch.tensor(xs, dtype=torch.int64, device=hay.device)  # noqa: E731
    return as_tensor(counts), as_tensor(lasts)


def _cp_extent(stream: torch.Tensor, n: int, needle: torch.Tensor) -> int:
    if stream.dim() != 1 or stream.dtype != torch.int32 or needle.dim() != 1 or needle.dtype != torch.int32:
        raise ValueError(f"expected 1-D int32 stream and needle, got {stream.dtype}{tuple(stream.shape)} and "
                         f"{needle.dtype}{tuple(needle.shape)}")
    if needle.device != stream.device:
        raise ValueError(f"needle on {needle.device}, stream on {stream.device}")
    if needle.numel() == 0:
        raise ValueError("empty needle")
    n = int(n)
    if not 0 <= n <= stream.numel():
        raise ValueError(f"n={n} outside a stream of {stream.numel()} codepoints")
    return n


def cp_window_count_plain(stream: torch.Tensor, n: int, needle: torch.Tensor) -> torch.Tensor:
    """Number of p <= n - m with ``stream[p:p+m] == needle``, overlapping
    matches included, as a 0-d int64 tensor: candidates at the needle's
    first codepoint, filtered by each further one."""
    n = _cp_extent(stream, n, needle)
    m = needle.numel()
    if m > n:
        return torch.zeros((), dtype=torch.int64, device=stream.device)
    starts = torch.nonzero(stream[: n - m + 1] == needle[0]).squeeze(1)
    for j in range(1, m):
        if starts.numel() == 0:
            break
        starts = starts[stream[starts + j] == needle[j]]
    return torch.tensor(starts.numel(), dtype=torch.int64, device=stream.device)


def byteset_count_plain(hay: torch.Tensor, table: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Members of the set among ``hay[:n]``, as an int64 tensor of one element:
    a 256-bin histogram weighted by the membership table."""
    n = _extent(hay, n)
    hist = torch.bincount(hay[:n], minlength=256)
    return (hist * (table != 0).to(torch.int64)).sum().reshape(1)


# ---------------------------------------------------------------------------
# Public functions: the kernel for a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def _on_card(hay: torch.Tensor) -> bool:
    if hay.device.type == "cuda":
        return True
    if hay.device.type == "cpu":
        return False
    raise ValueError(f"find runs on a CUDA or CPU tensor, not {hay.device}")


def find_counts(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> torch.Tensor:
    """int64[B] on ``hay``'s device: per-needle all-matches counts over
    ``hay[:n]``, one scan for the batch, without waiting for it."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        return find_cuda.find_count_batch(hay, batch, n)
    return find_count_batch_plain(hay, batch, n)


def find_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> list[int]:
    """Per-needle all-matches counts over ``hay[:n]``, one scan for the batch."""
    return find_counts(hay, batch, n).tolist()


def rfind_counts(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, lasts), int64[B] each on ``hay``'s device: per-needle counts
    and last match starts (-1 if none) over ``hay[:n]``, without waiting."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        return find_cuda.rfind_count_batch(hay, batch, n)
    return rfind_count_batch_plain(hay, batch, n)


def rfind_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> list[tuple[int, int]]:
    """Per-needle (count, last match start or -1) over ``hay[:n]``."""
    counts, lasts = rfind_counts(hay, batch, n)
    return [tuple(pair) for pair in torch.stack([counts, lasts], 1).tolist()]  # one device sync


def find_count(hay: torch.Tensor, needle: PackedNeedle, n: int | None = None) -> int:
    """Number of (possibly overlapping) matches of ``needle`` in ``hay[:n]``."""
    return find_count_batch(hay, NeedleBatch.from_needles([needle], hay.device), n)[0]


def rfind_count(hay: torch.Tensor, needle: PackedNeedle, n: int | None = None) -> tuple[int, int]:
    """Backward-search semantics: (all-matches count, LAST match offset or -1)."""
    return rfind_count_batch(hay, NeedleBatch.from_needles([needle], hay.device), n)[0]


# ---------------------------------------------------------------------------
# Owned-start counts of a rank's row of a sharded haystack
# ---------------------------------------------------------------------------

def owned_extent(chunk: int, lo: int, n_glob: int, reach: int) -> int:
    """The bytes of a row at global offset ``lo`` that its owned windows
    read: its chunk and ``reach`` bytes past it, cut at the corpus' end."""
    return max(min(chunk + reach, n_glob - lo), 0)


def find_counts_owned(hay_row: torch.Tensor, batch: NeedleBatch, chunk: int, lo: int, n_glob: int) -> torch.Tensor:
    """int64[1]: matches of the batch's one needle (m bytes) whose start p
    the row owns (``p < chunk``) and whose window lies in the corpus
    (``lo + p <= n_glob - m``), compared across the row's halo: the count
    over ``hay_row[:min(chunk + m - 1, n_glob - lo)]`` (the JAX
    ``_count_from_mask_sharded``)."""
    return find_counts(hay_row, batch, owned_extent(chunk, lo, n_glob, batch.host_lengths[0] - 1))


def rfind_counts_owned(hay_row: torch.Tensor, batch: NeedleBatch, chunk: int, lo: int,
                       n_glob: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, lasts), int64[1] each: ``find_counts_owned`` and the global
    start of the last owned match, -1 if none (the JAX
    ``_count_last_from_mask_sharded``)."""
    counts, lasts = rfind_counts(hay_row, batch, owned_extent(chunk, lo, n_glob, batch.host_lengths[0] - 1))
    return counts, torch.where(lasts >= 0, lasts + lo, -1)


def byteset_counts_bounded(hay_row: torch.Tensor, tables: Sequence[torch.Tensor], chunk: int, lo: int,
                           n_glob: int) -> torch.Tensor:
    """int64[len(tables)]: members of each set among the row's own bytes
    inside the corpus, ``hay_row[:min(chunk, n_glob - lo)]`` (the JAX
    ``byteset_count_bounded``)."""
    return byteset_counts_tensor(hay_row, tables, owned_extent(chunk, lo, n_glob, 0))


def pack_byteset(charset: bytes, device=None) -> torch.Tensor:
    """256-entry uint8 membership table for a byte set."""
    table = np.zeros(256, dtype=np.uint8)
    table[np.frombuffer(charset, dtype=np.uint8)] = 1
    return torch.from_numpy(table).to(device)


def byteset_counts_tensor(hay: torch.Tensor, tables: Sequence[torch.Tensor], n: int | None = None) -> torch.Tensor:
    """int64[len(tables)] on ``hay``'s device: per-set counts of the bytes
    of ``hay[:n]``, one scan per set, without waiting."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        return torch.cat([find_cuda.byteset_count(hay, table, n) for table in tables])
    return torch.cat([byteset_count_plain(hay, table, n) for table in tables])


def byteset_counts(hay: torch.Tensor, tables: Sequence[torch.Tensor], n: int | None = None) -> list[int]:
    """Per-set counts of the bytes of ``hay[:n]``: one scan per set, one
    device sync for all of them."""
    return byteset_counts_tensor(hay, tables, n).tolist()


def byteset_count(hay: torch.Tensor, table: torch.Tensor, n: int | None = None) -> int:
    """Count of bytes of ``hay[:n]`` that belong to the set."""
    return byteset_counts(hay, [table], n)[0]


def cp_window_count(stream: torch.Tensor, n: int, needle: torch.Tensor) -> torch.Tensor:
    """All (overlapping) matches of the int32 ``needle`` in ``stream[:n]``, as
    a 0-d int64 tensor on the stream's device, without waiting for it."""
    if _on_card(stream):
        from stringwars_tpu_torch.ops import find_cuda

        return find_cuda.cp_window_count(stream, n, needle)
    return cp_window_count_plain(stream, n, needle)
