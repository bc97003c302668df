"""Exact substring and byteset search: plain torch versions and dispatch.

The port of ``stringwars_tpu.ops.find``. The reference benchmarks
all-matches substring scans (forward find and backward rfind loops,
``find/bench.rs:56-219``) and byteset scans over three charsets
(``find/bench.rs:226-348``):

- ``find_count``: the number of window starts ``p <= n - m`` with
  ``hay[p:p+m] == needle``; overlapping matches count.
- ``rfind_count``: that count and the LAST such ``p`` (-1 when none).
- ``find_count_batch``: one count per needle of a ``NeedleBatch``.
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
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Needle capacity buckets, in u32 words (16 B / 64 B / 256 B needles).
NEEDLE_WORD_BUCKETS = (4, 16, 64)


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

    @property
    def size(self) -> int:
        return len(self.host_lengths)

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
        )


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


def find_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> list[int]:
    """Per-needle all-matches counts over ``hay[:n]``, one scan for the batch."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        return find_cuda.find_count_batch(hay, batch, n).tolist()
    return find_count_batch_plain(hay, batch, n).tolist()


def rfind_count_batch(hay: torch.Tensor, batch: NeedleBatch, n: int | None = None) -> list[tuple[int, int]]:
    """Per-needle (count, last match start or -1) over ``hay[:n]``."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        counts, lasts = find_cuda.rfind_count_batch(hay, batch, n)
    else:
        counts, lasts = rfind_count_batch_plain(hay, batch, n)
    return [tuple(pair) for pair in torch.stack([counts, lasts], 1).tolist()]  # one device sync


def find_count(hay: torch.Tensor, needle: PackedNeedle, n: int | None = None) -> int:
    """Number of (possibly overlapping) matches of ``needle`` in ``hay[:n]``."""
    return find_count_batch(hay, NeedleBatch.from_needles([needle], hay.device), n)[0]


def rfind_count(hay: torch.Tensor, needle: PackedNeedle, n: int | None = None) -> tuple[int, int]:
    """Backward-search semantics: (all-matches count, LAST match offset or -1)."""
    return rfind_count_batch(hay, NeedleBatch.from_needles([needle], hay.device), n)[0]


def pack_byteset(charset: bytes, device=None) -> torch.Tensor:
    """256-entry uint8 membership table for a byte set."""
    table = np.zeros(256, dtype=np.uint8)
    table[np.frombuffer(charset, dtype=np.uint8)] = 1
    return torch.from_numpy(table).to(device)


def byteset_counts(hay: torch.Tensor, tables: Sequence[torch.Tensor], n: int | None = None) -> list[int]:
    """Per-set counts of the bytes of ``hay[:n]``: one scan per set, one
    device sync for all of them."""
    if _on_card(hay):
        from stringwars_tpu_torch.ops import find_cuda

        counts = [find_cuda.byteset_count(hay, table, n) for table in tables]
    else:
        counts = [byteset_count_plain(hay, table, n) for table in tables]
    return torch.cat(counts).tolist()


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
