"""Bit-parallel Myers Levenshtein (family K5 uniform fast path).

The counterpart of ``stringwars_tpu.ops.myers_pallas``: Myers' bit-vector
algorithm in Hyyrö's block form (G. Myers, JACM 1999; H. Hyyrö 2003), one
pattern ``a`` against one text ``b`` per pair, 64 DP rows per 64-bit word
(the TPU kernel packs 32 per u32 lane). A column of the DP advances with
about 17 bitwise operations per word; words pass the horizontal delta of
their bottom row up as ``hp_in``/``hn_in`` (word 0 starts with hp_in = 1,
hn_in = 0), not as an add-carry.

Eq (the pattern-vs-char match bitvector) is built from NBITS bitplanes:
``planes[w, k]`` has bit ``r`` set iff pattern char ``64w + r`` has bit
``k`` set; bit ``NBITS-1`` is a sentinel set only on pattern padding, so
padding never matches. Eq of a text char ``c`` is the AND over k of
``plane_k`` (where c has bit k) or ``~plane_k`` (where it has not). The
planes serve every alphabet with one code path: bytes (NBITS 9),
codepoints up to U+10FFFF (NBITS 22), and small joint alphabets compressed
to dense codes at staging (at most 16 symbols, NBITS 2-5; DNA takes 3).

Score tracking: D[|a|][j] moves by the horizontal delta at row |a|, bit
``(|a|-1) % 64`` of the unshifted Ph/Mh of word ``(|a|-1) // 64``, for
columns ``j < |b|``. An empty pattern scores ``|b|``.

Layout on the device: ``planes`` int64[W, NBITS, B] (u64 bit patterns),
``text`` int32[L, B], both pair-minor so that neighbouring pairs are
neighbouring words. A CUDA tensor goes to the kernel ``csrc/myers.cu``
(``ops/myers_cuda.py``); a CPU tensor to ``myers_plain``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BYTE_BITS = 9  # bits 0..7 data + bit 8 pad sentinel
CP_BITS = 22  # bits 0..20 codepoint + bit 21 pad sentinel
WORD = 64  # DP rows per word
SUPPORTED_NBITS = (2, 3, 4, 5, BYTE_BITS, CP_BITS)  # the kernel's instantiations


@dataclasses.dataclass(frozen=True)
class MyersBatch:
    """Pairs staged for the Myers kernel: pattern bitplanes and text columns."""

    planes: torch.Tensor  # int64[W, nbits, B]: bit r of word w = bit k of a[64w + r]
    text: torch.Tensor  # int32[L, B]: text[j, p] = b_p[j] (codes)
    a_len: torch.Tensor  # int32[B]
    b_len: torch.Tensor  # int32[B]
    nbits: int
    host_a_len: np.ndarray  # int64[B], for work accounting
    host_b_len: np.ndarray

    @property
    def count(self) -> int:
        return self.a_len.shape[0]

    @property
    def device(self) -> torch.device:
        return self.planes.device

    def cells(self) -> int:
        return int((self.host_a_len * self.host_b_len).sum())

    @classmethod
    def from_arrays(cls, a, b, a_len, b_len, *, nbits: int = BYTE_BITS, device=None) -> "MyersBatch":
        """Stage int32 [B, A] patterns and [B, L] texts (codes below
        ``1 << (nbits - 1)``) onto ``device``."""
        if nbits not in SUPPORTED_NBITS:
            raise ValueError(f"nbits {nbits} not in {SUPPORTED_NBITS}")
        a = np.asarray(a, np.int32)
        b = np.asarray(b, np.int32)
        a_len = np.asarray(a_len, np.int64)
        b_len = np.asarray(b_len, np.int64)
        B, A = a.shape
        W = max(1, -(-A // WORD))
        pad = 1 << (nbits - 1)
        ap = np.full((B, W * WORD), pad, np.int32)
        ap[:, :A] = a
        ap[np.arange(W * WORD)[None, :] >= a_len[:, None]] = pad
        planes = np.empty((W, nbits, B), np.uint64)
        for bit in range(nbits):
            bits = ((ap >> bit) & 1).astype(np.uint8).reshape(B, W, WORD)
            packed = np.packbits(bits, axis=2, bitorder="little")  # [B, W, 8] bytes of each word
            planes[:, bit, :] = packed.view("<u8")[..., 0].T
        device = torch.device("cpu") if device is None else torch.device(device)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x).astype(dtype, copy=False)).to(device)

        return cls(
            planes=put(planes.view(np.int64), np.int64),
            text=put(b.T, np.int32),
            a_len=put(a_len, np.int32),
            b_len=put(b_len, np.int32),
            nbits=nbits,
            host_a_len=a_len,
            host_b_len=b_len,
        )


def _padded(a_seqs, b_seqs):
    B = len(a_seqs)
    A = max((len(t) for t in a_seqs), default=1)
    L = max((len(t) for t in b_seqs), default=1)
    a = np.zeros((B, max(A, 1)), np.int32)
    b = np.zeros((B, max(L, 1)), np.int32)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for i, (x, y) in enumerate(zip(a_seqs, b_seqs)):
        a[i, : len(x)] = x
        b[i, : len(y)] = y
        a_len[i], b_len[i] = len(x), len(y)
    return a, b, a_len, b_len


def myers_from_tokens(a_tokens: list[bytes], b_tokens: list[bytes], *, device=None) -> MyersBatch:
    """Byte-level staging from token lists.

    Small joint alphabets compress to dense codes at staging time, as the
    JAX package does (``myers_pallas.py:355-362``): with at most 16
    distinct values (the zero padding counts) the codes take
    ``bit_length(size - 1)`` bits plus the sentinel, so Eq of a DNA-class
    corpus is 3 planes instead of 9. Distances are unchanged (the codes are
    a bijection on the observed bytes)."""
    a, b, a_len, b_len = _padded(
        [np.frombuffer(t, np.uint8) for t in a_tokens], [np.frombuffer(t, np.uint8) for t in b_tokens]
    )
    alphabet = np.union1d(np.unique(a), np.unique(b)).astype(np.int64)
    if alphabet.size <= 16:
        code = np.zeros(256, np.int32)
        code[alphabet] = np.arange(alphabet.size, dtype=np.int32)
        nbits = max(int(alphabet.size - 1).bit_length(), 1) + 1
        return MyersBatch.from_arrays(code[a], code[b], a_len, b_len, nbits=nbits, device=device)
    return MyersBatch.from_arrays(a, b, a_len, b_len, nbits=BYTE_BITS, device=device)


def myers_from_codepoints(a_cps: list[np.ndarray], b_cps: list[np.ndarray], *, device=None) -> MyersBatch:
    """Codepoint-level staging (the LevenshteinDistancesUtf8 analog,
    ``similarities/bench.rs:230-247``; CUPS count codepoint cells)."""
    a, b, a_len, b_len = _padded(a_cps, b_cps)
    return MyersBatch.from_arrays(a, b, a_len, b_len, nbits=CP_BITS, device=device)


def myers_plain(batch: MyersBatch) -> torch.Tensor:
    """The same bit-parallel algorithm in plain torch, vectorized over
    pairs: a loop over text columns and, inside it, over words. int64
    holds the u64 words (its adds and left shifts wrap; the right shifts
    are masked to one bit). -> int32[B]."""
    planes, text = batch.planes, batch.text
    W, nbits, B = planes.shape
    a_len = batch.a_len.to(torch.int64)
    b_len = batch.b_len.to(torch.int64)
    last = (a_len - 1).clamp(min=0)
    lastw, lastr = last // WORD, last % WORD
    score = a_len.clone()
    vp = torch.full((W, B), -1, dtype=torch.int64, device=planes.device)
    vn = torch.zeros((W, B), dtype=torch.int64, device=planes.device)
    columns = min(text.shape[0], int(batch.host_b_len.max()) if B else 0)
    for j in range(columns):
        c = text[j].to(torch.int64)
        in_text = j < b_len
        # -1 (all ones) where the char lacks bit k, so plane ^ mask = ~plane;
        # the sentinel plane always inverts: padding never matches.
        masks = [((c >> k) & 1) - 1 for k in range(nbits - 1)] + [torch.full_like(c, -1)]
        hp = torch.ones_like(c)
        hn = torch.zeros_like(c)
        for w in range(W):
            eq = planes[w, 0] ^ masks[0]
            for k in range(1, nbits):
                eq = eq & (planes[w, k] ^ masks[k])
            p, n = vp[w], vn[w]
            xv = eq | n
            eq2 = eq | hn
            xh = (((eq2 & p) + p) ^ p) | eq2
            ph = n | ~(xh | p)
            mh = p & xh
            delta = ((ph >> lastr) & 1) - ((mh >> lastr) & 1)
            score = score + torch.where((lastw == w) & in_text, delta, 0)
            phs = (ph << 1) | hp
            mhs = (mh << 1) | hn
            vp[w] = mhs | ~(xv | phs)
            vn[w] = phs & xv
            hp, hn = (ph >> 63) & 1, (mh >> 63) & 1
    return torch.where(a_len == 0, b_len, score).to(torch.int32)


LANE_ROWS = 32  # DP rows of a lane word of csrc/myers.cu at short batches
LATENCY_THREADS = 1024  # threads an SM below which a batch takes one 32-row word a lane
_M32 = 0xFFFFFFFF


def _pow2(n: int) -> int:
    """The power of two from 1 to 32 at or above n."""
    group = 1
    while group < min(n, 32):
        group *= 2
    return group


def lane_group(max_a: int) -> int:
    """Lanes a pair of csrc/myers.cu for patterns of up to ``max_a`` rows at
    one 32-row word a lane: the words the longest needs, to a power of two
    from 1 to 32."""
    return _pow2(-(-max_a // LANE_ROWS))


def schedule(count: int, max_a: int, nbits: int, sms: int) -> tuple[int, int, int]:
    """(rows of a lane word, words a lane, lanes a pair) of csrc/myers.cu
    for ``count`` pairs whose longest pattern has ``max_a`` rows, on a card
    of ``sms`` SMs. A batch whose 32-row words all fit in ``LATENCY_THREADS``
    threads an SM is latency-bound: one 32-row word a lane, as many lanes as
    the longest pattern has words (``lane_group``). A larger one fills the
    card anyway and is bound by its instructions: 4 64-bit words a lane (2
    at 22 planes, for registers), the fewest instructions a row, and as
    many lanes as the longest pattern needs of those."""
    words32 = -(-max_a // LANE_ROWS)
    if count * words32 <= sms * LATENCY_THREADS:
        return LANE_ROWS, 1, lane_group(max_a)
    per_lane = 2 if nbits == CP_BITS else 4
    return 64, per_lane, _pow2(-(-max_a // (64 * per_lane)))


def myers_lanes_plain(batch: MyersBatch, plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The kernel's own schedule in plain torch, vectorized over pairs and
    lanes. ``plan`` is (rows of a lane word, words a lane, lanes a pair), as
    ``schedule`` gives it (by default for an H100's 132 SMs). Each lane holds
    its words one above the other and advances them one after the other in
    a step; the group's lanes cover a band of words, and bands follow one
    another. At step s, lane w advances column s - w of its words with the
    character and the hp/hn bits that lane w - 1 passed at step s - 1
    (packed as the kernel's shuffle packs them: the character in bits
    0..21, hp in bit 30, hn in bit 31); lane 0 takes the next column's
    character from the text, and hp/hn from 1/0 in the first band or from
    the bits the last lane of the band before left, column by column.
    -> int32[B], equal to ``myers_plain``."""
    planes, text = batch.planes, batch.text
    W64, nbits, B = planes.shape
    dev = planes.device
    a_len = batch.a_len.to(torch.int64)
    b_len = batch.b_len.to(torch.int64)
    L = text.shape[0]
    max_a = int(batch.host_a_len.max()) if B else 0
    rows, per_lane, G = schedule(B, max_a, nbits, 132) if plan is None else plan
    mask = _M32 if rows == 32 else -1  # int64 holds a 64-bit word; its adds and left shifts wrap
    top = rows - 1
    words = (a_len + rows - 1) // rows
    lastw = torch.where(a_len > 0, (a_len - 1) // rows, -1)
    lastr = ((a_len - 1) % rows).clamp(min=0)[:, None]
    lane = torch.arange(G, device=dev)
    bit_k = torch.tensor([*range(nbits - 1), 63], device=dev)[:, None, None]  # bit 63 of a code is 0: the sentinel's mask inverts
    if rows == 32:
        lane_words = torch.stack([planes & _M32, (planes >> 32) & _M32], dim=1).reshape(2 * W64, nbits, B)
    else:
        lane_words = planes
    text64 = torch.cat([text.to(torch.int64), torch.zeros((1, B), dtype=torch.int64, device=dev)])  # a zero past the end
    score = a_len.clone()
    carry_p = carry_n = None  # [B, L] bits of the band above's last lane
    band_words = G * per_lane
    bands = int(((words + band_words - 1) // band_words).max()) if B else 0
    for band in range(bands):
        word0 = band * band_words + lane * per_lane  # [G]
        mine = (words[:, None] - word0[None, :]).clamp(0, per_lane)  # [B, G]
        lanes = ((words - band * band_words + per_lane - 1) // per_lane).clamp(0, G)
        to_next = (lane[None, :] == G - 1) & (words > (band + 1) * band_words)[:, None]
        tw = lastw[:, None] - word0[None, :]
        steps = torch.where((lanes > 0) & (b_len > 0), b_len + lanes - 1, 0)
        pls = [lane_words[(word0 + j).clamp(max=lane_words.shape[0] - 1)].permute(1, 2, 0) for j in range(per_lane)]
        vp = [torch.full((B, G), mask, dtype=torch.int64, device=dev) for _ in range(per_lane)]
        vn = [torch.zeros((B, G), dtype=torch.int64, device=dev) for _ in range(per_lane)]

        def eq_of(pl, c):  # c: [B, G] characters -> AND_k plane_k ^ mask_k, the sentinel plane inverted
            terms = pl ^ (((c[None] >> bit_k) & 1) - 1) & mask
            while terms.shape[0] > 1:
                half = terms.shape[0] // 2
                terms = torch.cat([terms[:half] & terms[half : 2 * half], terms[2 * half :]])
            return terms[0]

        c0 = torch.where(b_len > 0, text64[0], 0)
        pk = torch.zeros((B, G), dtype=torch.int64, device=dev)
        pk[:, 0] = c0
        eq = [eq_of(pl, pk & 0x3FFFFFFF) for pl in pls]
        next_p = torch.zeros((B, L), dtype=torch.int64, device=dev)
        next_n = torch.zeros((B, L), dtype=torch.int64, device=dev)
        for s in range(int(steps.max()) if B else 0):
            got = torch.cat([pk[:, :1], pk[:, :-1]], dim=1)  # __shfl_up_sync by 1 within the group
            col = s - lane[None, :]
            cnext = got & 0x3FFFFFFF
            hp, hn = (got >> 30) & 1, (got >> 31) & 1
            cnext[:, 0] = text64[min(s + 1, L)]
            if band == 0:
                hp[:, 0], hn[:, 0] = 1, 0
            else:
                hp[:, 0] = carry_p[:, s] if s < L else 0
                hn[:, 0] = carry_n[:, s] if s < L else 0
            active = (col >= 0) & (col < b_len[:, None])
            for j in range(per_lane):
                live = active & (j < mine)
                xv = eq[j] | vn[j]
                eq2 = eq[j] | hn
                xh = ((((eq2 & vp[j]) + vp[j]) & mask) ^ vp[j]) | eq2
                ph = vn[j] | (~(xh | vp[j]) & mask)
                mh = vp[j] & xh
                delta = ((ph >> lastr) & 1) - ((mh >> lastr) & 1)
                score = score + torch.where(live & (tw == j), delta, 0).sum(dim=1)
                phs = ((ph << 1) & mask) | hp
                mhs = ((mh << 1) & mask) | hn
                vp[j] = torch.where(live, mhs | (~(xv | phs) & mask), vp[j])
                vn[j] = torch.where(live, phs & xv, vn[j])
                hp, hn = (ph >> top) & 1, (mh >> top) & 1
            sends = active & (mine == per_lane)
            hp_out, hn_out = torch.where(sends, hp, 0), torch.where(sends, hn, 0)
            out = sends & to_next
            if bool(out.any()):
                c = s - (G - 1)
                next_p[:, c] = torch.where(out[:, -1], hp_out[:, -1], next_p[:, c])
                next_n[:, c] = torch.where(out[:, -1], hn_out[:, -1], next_n[:, c])
            pk = cnext | (hp_out << 30) | (hn_out << 31)
            eq = [eq_of(pl, cnext) for pl in pls]
        carry_p, carry_n = next_p, next_n
    return torch.where(a_len == 0, b_len, score).to(torch.int32)


def myers_distances(batch: MyersBatch) -> torch.Tensor:
    """Levenshtein distance per pair -> int32[count], on the batch's device:
    the CUDA kernel for a batch on the card, ``myers_plain`` on the CPU."""
    if batch.device.type == "cuda":
        from stringwars_tpu_torch.ops import myers_cuda

        return myers_cuda.myers(batch)
    if batch.device.type == "cpu":
        return myers_plain(batch)
    raise ValueError(f"myers_distances runs on a CUDA or CPU batch, not {batch.device}")
