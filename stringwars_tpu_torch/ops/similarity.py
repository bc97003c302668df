"""Edit distances and alignment scores by anti-diagonal wavefront DP (K5).

The port of ``stringwars_tpu.ops.similarity``, value for value: batched
Levenshtein (uniform costs), Needleman-Wunsch global and Smith-Waterman
local scores with linear or affine gaps, and the banded Levenshtein of
``SWTPU_ERROR_BOUND``, over pairs padded to a common width ``L``
(reference ``similarities/bench.rs:269-1026``; CUPS = DP cells / second).

Each function runs one Python loop over the 2L anti-diagonals, carrying two
(three for affine) ``[B, L+1]`` int32 diagonals: dense elementwise min/max
algebra over the batch x diagonal plane. Cells beyond a pair's lengths get
free moves in the propagation direction and forbidden (+-BIG) moves
otherwise, so the answer replicates to the corner ``D[L][L]``. The
arithmetic is the JAX package's, in the same int32 order.

These are plain torch on any device. On the card they are the plain
versions beside the kernels of ``ops/myers.py`` (Levenshtein) and
``ops/affine.py`` (the four scores), which the suite's device rows run.
``levenshtein_banded`` has no kernel in either package: it runs as plain
torch on the card too, and only when ``SWTPU_ERROR_BOUND`` is set.

``dp_cells`` counts true ``|a| * |b|`` cells per pair, the reference's
aggregate-CUPS bookkeeping (``similarities/bench.rs:216-224``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1 << 20


@dataclasses.dataclass(frozen=True)
class PairBatch:
    """A batch of sequence pairs, padded to a common width L."""

    a: torch.Tensor  # int32[B, L] (character codes; zeros past a_len)
    b: torch.Tensor  # int32[B, L]
    a_len: torch.Tensor  # int32[B]
    b_len: torch.Tensor  # int32[B]

    @property
    def width(self) -> int:
        return self.a.shape[1]

    @property
    def device(self) -> torch.device:
        return self.a.device

    def dp_cells(self) -> int:
        return int((self.a_len.to(torch.int64) * self.b_len.to(torch.int64)).sum())

    @classmethod
    def from_numpy(cls, a, b, a_len, b_len, *, device=None) -> "PairBatch":
        """Take the arrays of a JAX ``PairBatch`` (as numpy) onto ``device``."""
        a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
        if a.ndim != 2 or a.shape != b.shape:
            raise ValueError(f"a and b must be [B, L] of one shape, got {a.shape} and {b.shape}")
        device = torch.device("cpu") if device is None else torch.device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.int32).copy()).to(device)

        return cls(put(a), put(b), put(a_len), put(b_len))


def decode_codepoints(token: bytes) -> np.ndarray:
    """Host-side UTF-8 decode to int32 codepoints (for codepoint-level DP)."""
    return np.array([ord(c) for c in token.decode("utf-8")], dtype=np.int32)


def _pack(a_seqs, b_seqs, L: int, device) -> PairBatch:
    B = len(a_seqs)
    a = np.zeros((B, L), dtype=np.int32)
    b = np.zeros((B, L), dtype=np.int32)
    a_len = np.zeros(B, dtype=np.int32)
    b_len = np.zeros(B, dtype=np.int32)
    for i, (x, y) in enumerate(zip(a_seqs, b_seqs)):
        a[i, : len(x)] = x
        b[i, : len(y)] = y
        a_len[i], b_len[i] = len(x), len(y)
    return PairBatch.from_numpy(a, b, a_len, b_len, device=device)


def pack_pairs(a_tokens: list[bytes], b_tokens: list[bytes], width: int | None = None, *, device=None) -> PairBatch:
    """Host-side staging of byte-string pairs into a PairBatch on ``device``."""
    if len(a_tokens) != len(b_tokens):
        raise ValueError("pair lists must have equal length")
    L = width or max((max(len(t) for t in a_tokens), max(len(t) for t in b_tokens)), default=1)
    L = max(L, 1)
    as_u8 = [np.frombuffer(t, np.uint8) for t in a_tokens]
    bs_u8 = [np.frombuffer(t, np.uint8) for t in b_tokens]
    return _pack(as_u8, bs_u8, L, device)


def pack_pairs_utf8(a_tokens: list[bytes], b_tokens: list[bytes], width: int | None = None, *, device=None) -> PairBatch:
    """Codepoint-level pairs: the ``LevenshteinDistancesUtf8`` analog
    (distances over decoded codepoints; CUPS counts codepoint cells,
    reference ``similarities/bench.rs:230-247``)."""
    a_cps = [decode_codepoints(t) for t in a_tokens]
    b_cps = [decode_codepoints(t) for t in b_tokens]
    L = width or max((max((len(c) for c in a_cps), default=1), max((len(c) for c in b_cps), default=1)))
    L = max(L, 1)
    return _pack(a_cps, b_cps, L, device)


# ---------------------------------------------------------------------------
# The anti-diagonal wavefronts
# ---------------------------------------------------------------------------

def _diag_frames(pairs: PairBatch):
    """Per-diagonal windows: returns (ap, brp, i_idx, L).

    ``ap[:, i] = a[i-1]`` (the diagonal's a-char at row i); the b-window of
    diagonal d is ``brp[:, 2L-d+i] = b[d-1-i]``, one slice of the
    reversed-b pad buffer.
    """
    L = pairs.a.shape[1]
    ap = F.pad(pairs.a, (1, 0))  # [B, L+1]
    brp = F.pad(pairs.b.flip(1), (L, L + 1))  # width 3L+1; reversed b at offset L
    i_idx = torch.arange(L + 1, dtype=torch.int32, device=pairs.a.device)[None, :]
    return ap, brp, i_idx, L


def _b_window(brp: torch.Tensor, d: int, L: int) -> torch.Tensor:
    """[B, L+1] window w[i] = b[d-1-i] (junk where out of range)."""
    start = 2 * L - d
    return brp[:, start : start + L + 1]


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """An int32 scalar tensor, so ``torch.where`` of two constants stays int32."""
    return torch.tensor(value, dtype=torch.int32, device=like.device)


def _shift(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x moved one row down the diagonal: out[:, i] = x[:, i-1], out[:, 0] = fill."""
    return F.pad(x[:, :-1], (1, 0), value=fill)


def _first_diagonal(pairs: PairBatch, L: int) -> torch.Tensor:
    """Diagonal 1, [D[0][1], D[1][0]] = [min(1, |b|), min(1, |a|)], padded to L+1."""
    d1 = torch.cat([pairs.b_len[:, None].clamp(max=1), pairs.a_len[:, None].clamp(max=1)], dim=1)
    return F.pad(d1, (0, L - 1))


def levenshtein(pairs: PairBatch) -> torch.Tensor:
    """Uniform-cost Levenshtein distance per pair -> int32[B]."""
    ap, brp, i_idx, L = _diag_frames(pairs)
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]
    big = _const(_BIG, ap)
    prev = _first_diagonal(pairs, L)
    prev2 = torch.zeros_like(prev)  # d=0: cell (0,0)=0
    for d in range(2, 2 * L + 1):
        w = _b_window(brp, d, L)
        j_idx = d - i_idx
        in_range = (i_idx >= 1) & (i_idx <= a_len) & (j_idx >= 1) & (j_idx <= b_len)
        sub = torch.where(in_range, (ap != w).to(torch.int32), big)
        del_cost = (i_idx <= a_len).to(torch.int32)
        ins_cost = (j_idx <= b_len).to(torch.int32)
        cur = torch.minimum(
            torch.minimum(prev + ins_cost, _shift(prev, 1 << 19) + del_cost), _shift(prev2, 1 << 19) + sub
        )
        # Boundary closed forms: i=0 -> D[0][d]=min(d,Lb); i=d -> D[d][0]=min(d,La).
        cur = torch.where(i_idx == 0, b_len.clamp(max=d), cur)
        cur = torch.where(i_idx == d, a_len.clamp(max=d), cur)
        prev, prev2 = cur, prev
    return prev[:, L]


def _score_scan(pairs: PairBatch, match, mismatch, gap_open, gap_extend, *, local: bool) -> torch.Tensor:
    """Shared affine-gap Gotoh wavefront for NW (global) / SW (local) scores.

    Linear-gap scoring is the special case gap_open == gap_extend.
    """
    ap, brp, i_idx, L = _diag_frames(pairs)
    B = pairs.a.shape[0]
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]
    go, ge, neg = int(gap_open), int(gap_extend), -_BIG
    c_match, c_mismatch = _const(int(match), ap), _const(int(mismatch), ap)
    c_neg, c_zero, c_go, c_ge = _const(neg, ap), _const(0, ap), _const(go, ap), _const(ge, ap)

    def zone_costs(d):
        """(sub, vo, ve, ho, he) cost planes for diagonal d."""
        j_idx = d - i_idx
        a_in = i_idx <= a_len
        b_in = j_idx <= b_len
        in_range = (i_idx >= 1) & a_in & (j_idx >= 1) & b_in
        w = _b_window(brp, d, L)
        sub = torch.where(in_range, torch.where(ap == w, c_match, c_mismatch), c_neg)
        # Vertical (gap in b, row move): free past a_len, forbidden past b_len.
        past_a, past_b = i_idx > a_len, j_idx > b_len
        vo = torch.where(past_a, c_zero, torch.where(past_b, c_neg, c_go))
        ve = torch.where(past_a, c_zero, torch.where(past_b, c_neg, c_ge))
        # Horizontal (gap in a, column move): mirrored.
        ho = torch.where(past_b, c_zero, torch.where(past_a, c_neg, c_go))
        he = torch.where(past_b, c_zero, torch.where(past_a, c_neg, c_ge))
        return sub, vo, ve, ho, he

    floor = 0 if local else neg

    def boundary(h, d):
        """Closed forms for row 0 / column 0 of the padded grid (the JAX
        package's assignments, ``row0`` twice, kept as they are)."""
        row0 = (go + ge * (b_len.clamp(max=d) - 1)).clamp(min=floor)
        row0 = torch.where(b_len >= 1, row0, c_zero)
        col0 = (go + ge * (a_len.clamp(max=d) - 1)).clamp(min=floor)
        row0 = torch.where(b_len.clamp(max=d) >= 1, row0, c_zero)
        col0 = torch.where(a_len.clamp(max=d) >= 1, col0, c_zero)
        h = torch.where(i_idx == 0, row0, h)
        h = torch.where(i_idx == d, col0, h)
        return h

    dev = pairs.a.device
    # H (best), V (gap-in-b ending), Z (gap-in-a ending): H for diagonals
    # d-1 and d-2, V and Z for d-1 only.
    h_prev2 = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)  # d=0: H[0][0] = 0
    h_prev = boundary(torch.full((B, L + 1), neg, dtype=torch.int32, device=dev), 1)
    v_prev = torch.where(i_idx == 1, h_prev, c_neg)
    z_prev = torch.where(i_idx == 0, h_prev, c_neg)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(2, 2 * L + 1):
        sub, vo, ve, ho, he = zone_costs(d)
        v_cur = torch.maximum(_shift(h_prev, neg) + vo, _shift(v_prev, neg) + ve)
        z_cur = torch.maximum(h_prev + ho, z_prev + he)
        m_cur = _shift(h_prev2, neg) + sub
        h_cur = torch.maximum(torch.maximum(v_cur, z_cur), m_cur)
        if local:
            h_cur = h_cur.clamp(min=0)
        h_cur = boundary(h_cur, d)
        v_cur = torch.where(i_idx == d, h_cur, v_cur)  # column-0 gap state
        z_cur = torch.where(i_idx == 0, h_cur, z_cur)  # row-0 gap state
        if local:
            j_idx = d - i_idx
            in_range = (i_idx <= a_len) & (j_idx >= 0) & (j_idx <= b_len)
            best = torch.maximum(best, torch.where(in_range, h_cur, c_zero).amax(1))
        h_prev, h_prev2, v_prev, z_prev = h_cur, h_prev, v_cur, z_cur
    return best if local else h_prev[:, L]


def nw_score_linear(pairs: PairBatch, match=2, mismatch=-1, gap=-2) -> torch.Tensor:
    """Needleman-Wunsch global score, linear gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap, gap, local=False)


def sw_score_linear(pairs: PairBatch, match=2, mismatch=-1, gap=-2) -> torch.Tensor:
    """Smith-Waterman local score, linear gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap, gap, local=True)


def nw_score_affine(pairs: PairBatch, match=2, mismatch=-1, gap_open=-5, gap_extend=-1) -> torch.Tensor:
    """NW global score, affine gaps (first gap char costs gap_open,
    each further char gap_extend) -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap_open, gap_extend, local=False)


def sw_score_affine(pairs: PairBatch, match=2, mismatch=-1, gap_open=-5, gap_extend=-1) -> torch.Tensor:
    """SW local score, affine gaps -> int32[B]."""
    return _score_scan(pairs, match, mismatch, gap_open, gap_extend, local=True)


def levenshtein_banded(pairs: PairBatch, band: int) -> torch.Tensor:
    """Levenshtein distance clamped to a diagonal band of half-width ``band``
    (the reference's ``STRINGWARS_ERROR_BOUND``; distances that would exceed
    the bound are reported as >= band + |len_a - len_b| saturation).

    The same anti-diagonal scan, with cells outside the band reading BIG.
    No kernel in either package: on the card this plain torch scan is the
    row's engine, run only when ``SWTPU_ERROR_BOUND`` is set.
    """
    ap, brp, i_idx, L = _diag_frames(pairs)
    a_len = pairs.a_len[:, None]
    b_len = pairs.b_len[:, None]
    big, one = _const(_BIG, ap), _const(1, ap)
    prev = _first_diagonal(pairs, L)
    prev2 = torch.zeros_like(prev)
    for d in range(2, 2 * L + 1):
        w = _b_window(brp, d, L)
        j_idx = d - i_idx
        in_range = (i_idx >= 1) & (i_idx <= a_len) & (j_idx >= 1) & (j_idx <= b_len)
        in_band = (i_idx - j_idx).abs() <= band
        sub = torch.where(in_range & in_band, (ap != w).to(torch.int32), big)
        del_cost = torch.where((i_idx <= a_len) & in_band, one, big)
        ins_cost = torch.where((j_idx <= b_len) & in_band, one, big)
        prev_shift = _shift(prev, 1 << 19)
        cur = torch.minimum(torch.minimum(prev + ins_cost, prev_shift + del_cost), _shift(prev2, 1 << 19) + sub)
        cur = torch.where(i_idx == 0, b_len.clamp(max=d), cur)
        cur = torch.where(i_idx == d, a_len.clamp(max=d), cur)
        # Out-of-range frozen propagation (same zones as the full scan).
        cur = torch.where(i_idx > a_len, torch.minimum(cur, prev_shift), cur)
        cur = torch.where((j_idx > b_len) & (i_idx <= a_len), torch.minimum(cur, prev), cur)
        prev, prev2 = cur, prev
    return prev[:, L].clamp(max=_BIG)


# ---------------------------------------------------------------------------
# Brute-force references (conformance oracles; O(B * L^2) on host)
# ---------------------------------------------------------------------------

def levenshtein_ref(a, b) -> int:
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[len(b)]


def _gotoh_ref(a, b, match, mismatch, go, ge, local):
    neg = -(10**9)
    La, Lb = len(a), len(b)
    H = [[0] * (Lb + 1) for _ in range(La + 1)]
    V = [[neg] * (Lb + 1) for _ in range(La + 1)]
    Z = [[neg] * (Lb + 1) for _ in range(La + 1)]
    best = 0
    for i in range(1, La + 1):
        V[i][0] = max(H[i - 1][0] + go, V[i - 1][0] + ge)
        H[i][0] = V[i][0] if not local else max(V[i][0], 0)
    for j in range(1, Lb + 1):
        Z[0][j] = max(H[0][j - 1] + go, Z[0][j - 1] + ge)
        H[0][j] = Z[0][j] if not local else max(Z[0][j], 0)
    for i in range(1, La + 1):
        for j in range(1, Lb + 1):
            V[i][j] = max(H[i - 1][j] + go, V[i - 1][j] + ge)
            Z[i][j] = max(H[i][j - 1] + go, Z[i][j - 1] + ge)
            s = match if a[i - 1] == b[j - 1] else mismatch
            H[i][j] = max(V[i][j], Z[i][j], H[i - 1][j - 1] + s)
            if local:
                H[i][j] = max(H[i][j], 0)
                best = max(best, H[i][j])
    return best if local else H[La][Lb]


def nw_ref(a, b, match=2, mismatch=-1, go=-2, ge=-2) -> int:
    return _gotoh_ref(a, b, match, mismatch, go, ge, local=False)


def sw_ref(a, b, match=2, mismatch=-1, go=-2, ge=-2) -> int:
    return _gotoh_ref(a, b, match, mismatch, go, ge, local=True)
