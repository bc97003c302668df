"""Multi-pattern Shift-And counting (family K2, small pattern sets).

The port of ``stringwars_tpu.ops.shiftand``. The patterns are packed into
one bit-position space (bit p set in a state: some pattern's first chars
up to p match the bytes ending here), and per byte

    state = ((state << 1) | start_mask) & mask(byte)
    hits += popcount(state & final_mask)

where ``mask(byte)`` has bit p set iff pattern char p equals the byte. The
count is that of Aho-Corasick: every occurrence of every pattern,
overlapping and nested ones included. Up to ``MAX_BITS`` = 64 pattern chars
pack first-fit into two 32-bit words, no pattern across the word boundary.

``ShiftAndSet`` is the JAX package's placement exactly (the same planes,
start, final and occupied masks). ``byte_masks`` adds the 256-entry table
of ``mask(byte)``: on a GPU the mask is one lookup, where the TPU kernel
rebuilt it per byte from eight bitplanes with an XOR trick because its
gathers were slow.

``shiftand_count`` takes the hand-written CUDA kernel of
``ops/shiftand_cuda.py`` for a CUDA tensor and the plain torch column scan
below for a CPU tensor; both use the chunk decomposition of
``ops/ahocorasick.py``. Counts are summed in 64 bits and returned as Python
ints (the JAX function returns int32).
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch.ops.ahocorasick import _device_key, column_scan, stage_rows
from stringwars_tpu_torch.ops.find import _extent

MAX_BITS = 64  # up to two u32 words of pattern positions
_W = 32

# popcount of every 16-bit value, for the plain scan (torch has no popcount)
_POP16 = np.unpackbits(np.arange(1 << 16, dtype="<u2").view(np.uint8).reshape(-1, 2), axis=1).sum(1).astype(np.int64)


class ShiftAndSet:
    """Patterns staged as per-word bitplanes + start/final masks.

    Patterns never straddle the 32-bit word boundary: placement packs
    first-fit into word 0 then word 1 over the patterns sorted by length,
    longest first (a stable sort)."""

    def __init__(self, patterns: list[bytes]):
        if not patterns:
            raise ValueError("need at least one pattern")
        if any(len(p) == 0 for p in patterns):
            raise ValueError("empty patterns not allowed")
        if any(len(p) > _W for p in patterns):
            raise ValueError(f"single pattern longer than {_W} chars")
        total = sum(len(p) for p in patterns)
        if total > MAX_BITS:
            raise ValueError(f"total pattern length {total} exceeds {MAX_BITS}")
        self.patterns = patterns
        self.max_len = max(len(p) for p in patterns)
        # First-fit placement into word-aligned segments.
        chars = np.zeros(2 * _W, np.uint8)
        cursors = [0, _W]
        start_mask = 0
        final_mask = 0
        top = 0
        for p in sorted(patterns, key=len, reverse=True):
            w = 0 if cursors[0] + len(p) <= _W else 1
            start = cursors[w]
            if start + len(p) > (w + 1) * _W:
                raise ValueError("patterns do not pack into two 32-bit words")
            chars[start : start + len(p)] = np.frombuffer(p, np.uint8)
            start_mask |= 1 << start
            final_mask |= 1 << (start + len(p) - 1)
            cursors[w] = start + len(p)
            top = max(top, cursors[w])
        self.n_words = 2 if top > _W else 1
        occupied = 0
        for w in range(self.n_words):
            occupied |= ((1 << (cursors[w] - w * _W)) - 1) << (w * _W)
        # plane[k] bit p = bit k of pattern char p.
        planes = np.zeros((self.n_words, 8), np.uint32)
        for p in range(2 * _W):
            if not (occupied >> p) & 1:
                continue
            for k in range(8):
                if (int(chars[p]) >> k) & 1:
                    planes[p // _W, k] |= np.uint32(1 << (p % _W))
        self.planes = planes
        self.start_mask = start_mask
        self.final_mask = final_mask
        self.occupied = occupied
        self.byte_masks = _byte_masks(planes, occupied)
        self._tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(kernel table, plain word masks) on ``device``, staged once per device.

        The kernel table is uint64[258] as int64: ``mask(byte)`` for the 256
        bytes, then the start and final masks. The plain word masks are
        int64[n_words, 256], word w of each ``mask(byte)``.
        """
        got = self._tables.get(device)  # a tensor's device: the key as staged
        if got is None:
            device = _device_key(device)
            got = self._tables.get(device)
        if got is None:
            table = np.concatenate([self.byte_masks, np.asarray([self.start_mask, self.final_mask], np.uint64)])
            words = np.stack([(self.byte_masks >> np.uint64(_W * w)) & np.uint64(0xFFFFFFFF) for w in range(self.n_words)])
            got = (
                torch.from_numpy(table.view(np.int64)).to(device),
                torch.from_numpy(words.astype(np.int64)).to(device),
            )
            self._tables[device] = got
        return got


def _byte_masks(planes: np.ndarray, occupied: int) -> np.ndarray:
    """uint64[256]: ``mask(byte)`` over both words, as the TPU kernel builds
    it per byte: the AND over bit k of (plane_k XOR (all ones where bit k of
    the byte is clear)), limited to the occupied bits."""
    byte = np.arange(256, dtype=np.uint32)
    masks = np.zeros(256, np.uint64)
    for w in range(planes.shape[0]):
        m = np.full(256, (occupied >> (_W * w)) & 0xFFFFFFFF, np.uint32)
        for k in range(8):
            mn = np.where((byte >> k) & 1 == 1, np.uint32(0), np.uint32(0xFFFFFFFF))
            m &= planes[w, k] ^ mn
        masks |= m.astype(np.uint64) << np.uint64(_W * w)
    return masks


# ---------------------------------------------------------------------------
# Plain torch version: the CPU path, and the comparison for the kernel
# ---------------------------------------------------------------------------

def shiftand_count_plain(sa: ShiftAndSet, hay: torch.Tensor, n: int | None = None, *, chunk: int | None = None) -> torch.Tensor:
    """Occurrences of all patterns in ``hay[:n]`` as an int64[1] tensor:
    the JAX kernel's per-word recurrence (two 32-bit words, no carry
    between them), chunk rows scanned in parallel one column at a time."""
    n = _extent(hay, n)
    _, words = sa.tables(hay.device)
    rows, gpos0, _ = stage_rows(hay, n, sa.max_len, chunk)
    shape = (sa.n_words, 1)
    start = torch.tensor([(sa.start_mask >> (_W * w)) & 0xFFFFFFFF for w in range(sa.n_words)], device=hay.device).reshape(shape)
    final = torch.tensor([(sa.final_mask >> (_W * w)) & 0xFFFFFFFF for w in range(sa.n_words)], device=hay.device).reshape(shape)
    pop16 = torch.from_numpy(_POP16).to(hay.device)

    def hits(state):
        x = state & final
        return (pop16[x & 0xFFFF] + pop16[x >> 16]).sum(0)

    return column_scan(
        rows, gpos0, n, sa.max_len - 1,
        torch.zeros((sa.n_words, rows.shape[0]), dtype=torch.int64, device=hay.device),
        lambda state, byte: ((state << 1) | start) & words[:, byte],
        hits,
    )


# ---------------------------------------------------------------------------
# Public functions: the kernel for a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def shiftand_count_tensor(sa: ShiftAndSet, hay: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Occurrences of all patterns in ``hay[:n]`` as an int64[1] tensor on
    hay's device, without waiting for it."""
    if hay.device.type == "cuda":
        from stringwars_tpu_torch.ops import shiftand_cuda

        return shiftand_cuda.shiftand_count(sa, hay, n)
    if hay.device.type == "cpu":
        return shiftand_count_plain(sa, hay, n)
    raise ValueError(f"shiftand_count runs on a CUDA or CPU tensor, not {hay.device}")


def shiftand_count(sa: ShiftAndSet, hay: torch.Tensor, n: int | None = None) -> int:
    """Total occurrences of all patterns in ``hay[:n]``, a Python int."""
    return int(shiftand_count_tensor(sa, hay, n).item())
