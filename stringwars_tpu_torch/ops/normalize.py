"""Canonical and compatibility normalization: NFC, NFD, NFKC, NFKD (K10).

The port of ``stringwars_tpu.ops.normalize`` (reference rows
``sz::utf8_norm``, ``normalization/bench.rs:113-141``), from the tables of
``unicode/tables.py``. The normalization runs on codepoint ROWS, each cut
before a *safe* codepoint (``safe_table``), so that every row normalizes on
its own:

- **decompose** (``decompose_rows``): the 1 -> N map of each codepoint to
  its full decomposition, compacted in the row. Where the JAX function takes
  its fused Pallas route (rows of 32 or 64, a BMP corpus, expansions of at
  most 4: NFD), the port takes the same route, row 16's expand kernel
  (``ops/expand.py``); elsewhere (NFKD, whose expansions reach 7 at the
  corpus ceilings of text and 18 in all, and rows of other widths) the JAX
  function maps with ``range_map`` and compacts with one ``lax.sort`` a row,
  a way around the TPU's scatters: here the kernel ``nf_decompose``
  (``csrc/normalize.cu``) reads the pooled tables and compacts by a prefix
  sum in the row;
- **reorder** (``reorder_rows_``): the canonical ordering of UAX#15 D109,
  a stable sort of each run of nonzero-ccc codepoints by ccc. The JAX
  function runs odd-even transposition passes and, past 64 passes, two
  stable argsorts; both give that sort. Here ``nf_reorder`` looks at each
  row with one warp, four codepoints a lane, and leaves a row in order as
  it is (no write); a row out of order is sorted in registers by the same
  odd-even passes where it holds at most 128 codepoints, else by the lane
  at each run's first codepoint, by insertion;
- **compose** (``compose_rows_``): the UAX#15 composition walk of
  ``_compose_scan`` (a carried starter and the ccc of the last kept
  codepoint, Hangul L+V and LV+T by arithmetic, primary composites through
  the dense rank table of ``_pair_tables``), with each starter slot resolved
  to its final value and the row compacted: ``nf_compose``, one thread a row.

A codepoint is safe when its full decomposition begins with a codepoint of
ccc 0 that is no combiner of a primary composite and no Hangul V/T jamo: the
composition walk's state is then the same whatever came before, and
reordering never crosses it. ``segment_rows`` cuts a codepoint stream into
rows of at most ``ROW`` codepoints before safe codepoints; a stretch longer
than that with no safe codepoint becomes a row of its own in a bucket of
wider rows, which the same kernels take (the JAX package falls back to its
flat route there).

The quick checks ``rows_inert`` (NFD/NFKD: every codepoint decomposes to
itself, has ccc 0 and composes with nothing) and ``rows_nfc_verbatim``
(NFC/NFKC: every codepoint is quick-check Yes with ccc 0) decode UTF-8 rows
(``casefold._decode_rows``) and map the codepoints through the class table
(``rulemap.step_map``: row 12's kernel on a card), pruned to the corpus'
codepoint ceiling as the JAX package prunes them; ``rows_inert_host`` and
``rows_nfc_verbatim_host`` are their numpy twins.

Each kernel wrapper takes the kernel for a CUDA tensor and its plain torch
version for a CPU tensor, and adds one to its entry of ``LAUNCHES`` where it
launches. ``decompose`` is the JAX package's flat decomposition as a plain
torch version (for the parity tests); ``normalize`` / ``normalize_text``
run the row pipeline on a device. Contract: codepoints at most ``max_cp``
where a function takes one, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops import expand, rulemap
from stringwars_tpu_torch.ops.lut import stage_table
from stringwars_tpu_torch.unicode import tables

# Launches of csrc/normalize.cu since process start (or the last reset).
LAUNCHES = {"nf_decompose": 0, "nf_reorder": 0, "nf_compose": 0}

FORMS = ("NFC", "NFD", "NFKC", "NFKD")
ROW = 64  # codepoints a row of the slow stream holds

# Hangul constants (UAX#15 §3.12)
_SBASE, _LBASE, _VBASE, _TBASE = 0xAC00, 0x1100, 0x1161, 0x11A7
_LCOUNT, _VCOUNT, _TCOUNT = 19, 21, 28
_SCOUNT = 11172


def is_compat(form: str) -> bool:
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return form in ("NFKC", "NFKD")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decomp_arrays(compat: bool):
    inline, multi, pool = tables.decomposition_tables(compat)
    return inline, multi.astype(np.int64), pool


@functools.lru_cache(maxsize=None)
def _ccc_np() -> np.ndarray:
    return tables.ccc_table().astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair_tables():
    """Dense composition lookup: rank maps + [n_s, n_c] composed table."""
    starters, combiners, composed = tables.composition_pairs()
    s_unique = np.unique(starters)
    c_unique = np.unique(combiners)
    s_rank = np.zeros(tables.MAX_CP, np.int32)
    c_rank = np.zeros(tables.MAX_CP, np.int32)
    s_rank[s_unique] = np.arange(1, s_unique.size + 1)
    c_rank[c_unique] = np.arange(1, c_unique.size + 1)
    dense = np.zeros((s_unique.size + 1) * (c_unique.size + 1), np.int32)
    dense[s_rank[starters] * (c_unique.size + 1) + c_rank[combiners]] = composed
    return s_rank, c_rank, dense, c_unique.size + 1


def _jamo(cps: np.ndarray, l: bool = True) -> np.ndarray:
    """The Hangul V and T jamo (and the L jamo with ``l``) among ``cps``."""
    vt = ((cps >= _VBASE) & (cps < _VBASE + _VCOUNT)) | ((cps > _TBASE) & (cps < _TBASE + _TCOUNT))
    return vt | ((cps >= _LBASE) & (cps < _LBASE + _LCOUNT)) if l else vt


@functools.lru_cache(maxsize=None)
def _inert_np(compat: bool) -> np.ndarray:
    """True for codepoints that can't interact with composition at all."""
    inline, multi, _ = _decomp_arrays(compat)
    _, c_rank, _, _ = _pair_tables()
    cps = np.arange(tables.MAX_CP)
    inert = (inline == cps) & (multi == 0) & (_ccc_np() == 0) & (c_rank == 0)
    return inert & ~_jamo(cps)


@functools.lru_cache(maxsize=None)
def safe_table(compat: bool) -> np.ndarray:
    """bool[0x110000]: a row may begin at the codepoint. Its full
    decomposition (NFKD with ``compat``, else NFD) begins with a codepoint
    of ccc 0 that no primary composite takes as its second codepoint and
    that is no Hangul V/T jamo: the composition walk resets there, and
    canonical reordering never moves anything across it."""
    inline, multi, pool = _decomp_arrays(compat)
    first = np.where(inline >= 0, inline, pool[np.clip(multi >> 5, 0, pool.shape[0] - 1)]).astype(np.int64)
    _, c_rank, _, _ = _pair_tables()
    safe = (_ccc_np()[first] == 0) & (c_rank[first] == 0) & ~_jamo(first, l=False)
    safe.setflags(write=False)
    return safe


@functools.lru_cache(maxsize=None)
def safe_on(compat: bool, device: torch.device) -> torch.Tensor:
    """``safe_table`` as a bool tensor on ``device``, staged once."""
    return torch.from_numpy(np.array(safe_table(compat))).to(device)


@functools.lru_cache(maxsize=None)
def _ccc_on(device: torch.device) -> torch.Tensor:
    """``tables.ccc_table`` as a uint8 tensor on ``device``, staged once."""
    return torch.from_numpy(np.array(tables.ccc_table())).to(device)


# ---------------------------------------------------------------------------
# Quick checks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inert_steps(compat: bool, max_cp: int | None = None):
    """The inert table as step rules, pruned to ``max_cp``, and the table."""
    table = _inert_np(compat).astype(np.int32)
    rules = rulemap.compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


@functools.lru_cache(maxsize=None)
def _nfc_fast_steps(compat: bool, max_cp: int | None = None):
    table = tables.nfc_fast_table(compat).astype(np.int32)
    rules = rulemap.compile_steps(table)
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return rules, table


@functools.lru_cache(maxsize=None)
def _class_table(kind: str, compat: bool, max_cp: int | None, device: torch.device) -> torch.Tensor:
    """The dense class table of the pruned rules, staged on ``device`` once."""
    rules, _ = (_inert_steps if kind == "inert" else _nfc_fast_steps)(compat, max_cp)
    return stage_table(rulemap.expand_steps(rules, rules.size), device)


def _rows_all_in_class(data: torch.Tensor, lengths: torch.Tensor, kind: str, compat: bool, max_cp) -> torch.Tensor:
    """bool[B]: every codepoint of each UTF-8 row lies in the class."""
    from stringwars_tpu_torch.ops.casefold import _decode_rows

    rules, _ = (_inert_steps if kind == "inert" else _nfc_fast_steps)(compat, max_cp)
    cp, is_lead = _decode_rows(data.to(torch.int32), lengths.to(data.device))
    ok = rulemap.step_map(cp, rules, _class_table(kind, compat, max_cp, data.device)).to(torch.bool)
    return (ok | ~is_lead).all(1)


def rows_inert(data: torch.Tensor, lengths: torch.Tensor, compat: bool = False, max_cp: int | None = None) -> torch.Tensor:
    """bool[B]: each UTF-8 row of ``[B, W]`` bytes is normalization-inert
    (its own NFD and NFC: identity decompositions, ccc 0, no combiner): the
    NFD/NFKD quick check."""
    return _rows_all_in_class(data, lengths, "inert", compat, max_cp)


def rows_nfc_verbatim(data: torch.Tensor, lengths: torch.Tensor, compat: bool = False,
                      max_cp: int | None = None) -> torch.Tensor:
    """bool[B]: each UTF-8 row is verbatim its own NFC (NFKC with
    ``compat``): the UAX#15 quick check (QC=Yes and ccc 0 per codepoint)."""
    return _rows_all_in_class(data, lengths, "fast", compat, max_cp)


def rows_nfc_verbatim_host(data_np: np.ndarray, lengths_np: np.ndarray, compat: bool = False) -> np.ndarray:
    """Staging-time (numpy) twin of ``rows_nfc_verbatim``."""
    return _rows_check_host(data_np, lengths_np, _nfc_fast_steps(compat)[1])


def rows_inert_host(data_np: np.ndarray, lengths_np: np.ndarray, compat: bool = False) -> np.ndarray:
    """Staging-time (numpy) twin of ``rows_inert``."""
    return _rows_check_host(data_np, lengths_np, _inert_steps(compat)[1])


def _rows_check_host(data_np: np.ndarray, lengths_np: np.ndarray, table: np.ndarray) -> np.ndarray:
    B, W = data_np.shape
    b = data_np.astype(np.int64)
    is_lead = (b & 0xC0) != 0x80
    valid = np.arange(W)[None, :] < lengths_np[:, None]

    def nxt(k):
        return np.pad(b, ((0, 0), (0, k)))[:, k:] & 0x3F

    width = np.select([b < 0x80, b < 0xC0, b < 0xE0, b < 0xF0, b < 0xF8], [1, 0, 2, 3, 4], 0)
    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp = np.select(
        [width == 1, width == 2, width == 3],
        [b, ((b & 0x1F) << 6) | b1, ((b & 0x0F) << 12) | (b1 << 6) | b2],
        ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
    )
    ok = table[np.clip(cp, 0, table.shape[0] - 1)].astype(bool)
    return np.all(ok | ~(is_lead & valid), axis=1)


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecompTables:
    """The decomposition pruned to ``[0, size)``: ``packed[cp]`` is the one
    codepoint of a one-codepoint decomposition, or ``~(offset << 5 |
    length)`` (negative) of a longer one, whose codepoints follow one
    another in ``pool``; ``max_exp`` is the longest expansion in range."""

    packed: np.ndarray
    pool: np.ndarray
    max_exp: int
    staged: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(self.packed.shape[0])

    def on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        if device not in self.staged:
            self.staged[device] = tuple(torch.from_numpy(a.copy()).to(device) for a in (self.packed, self.pool))
        return self.staged[device]


@functools.lru_cache(maxsize=None)
def decomp_tables(compat: bool, max_cp: int | None = None) -> DecompTables:
    """The decomposition tables over ``[0, max_cp]`` (all of Unicode without
    a ceiling); ``max_exp`` is the JAX package's: the longest expansion of a
    codepoint in range, 1 where none expands (4 for NFD over all of Unicode,
    18 for NFKD)."""
    inline, multi, pool = _decomp_arrays(compat)
    size = tables.MAX_CP if max_cp is None else int(max_cp) + 1
    inl, mul = inline[:size], multi[:size]
    is_multi = inl < 0
    lengths = mul[is_multi] & 31
    packed = np.where(is_multi, ~mul, inl).astype(np.int32)
    packed.setflags(write=False)
    return DecompTables(packed, pool, int(lengths.max()) if lengths.size else 1)


@functools.lru_cache(maxsize=None)
def _decomp_fused_tables(compat: bool, max_cp: int):
    """(``expand.ExpandTables``, max_exp) of the fused expand-and-compact
    route over ``[0, max_cp]``, or None where the corpus leaves its envelope
    (an expansion longer than 4, or an output above the BMP)."""
    inline, multi, pool = _decomp_arrays(compat)
    S = max_cp + 1
    cps = np.arange(S, dtype=np.int64)
    inl = inline[:S].astype(np.int64)
    mul = multi[:S].astype(np.int64)
    is_multi = inl < 0
    length = np.where(is_multi, mul & 31, 1)
    max_exp = int(length.max())
    if max_exp > expand.MAX_EXP:
        return None
    off = mul >> 5
    e1 = pool[np.clip(off, 0, pool.shape[0] - 1)].astype(np.int64)
    exps = [
        np.where(length >= k, pool[np.clip(off + k - 1, 0, pool.shape[0] - 1)], 0)
        for k in range(2, max(max_exp, 2) + 1)
    ]
    v0 = np.where(is_multi, e1, inl)
    if max(int(v0.max()), *(int(e.max()) for e in exps)) > 0xFFFF:
        return None
    t1 = (((v0 - cps) & 0xFFFF) | (length << 16)).astype(np.int32)
    e2 = exps[0]
    e3 = exps[1] if len(exps) >= 2 else np.zeros_like(e2)
    t2 = (e2 | (e3 << 16)).astype(np.int32)
    if max_exp <= 3:
        return expand.prepare_tables(t1, t2), max_exp
    return expand.prepare_tables(t1, t2, exps[2].astype(np.int32)), max_exp


def decompose_route(compat: bool, max_cp: int | None, width: int) -> str:
    """``"expand"`` where ``decompose_rows`` takes row 16's fused kernel for
    rows of ``width``, else ``"decompose"``: the JAX function's routing."""
    if max_cp is not None and width in expand.GROUPS and max_cp <= 0xFFFF:
        if _decomp_fused_tables(compat, int(max_cp)) is not None:
            return "expand"
    return "decompose"


def _check_rows(cps: torch.Tensor, lengths: torch.Tensor, what: str) -> None:
    if cps.dim() != 2 or cps.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 [rows, width] codepoints, got {cps.dtype}{tuple(cps.shape)}")
    if lengths.shape != (cps.shape[0],) or lengths.dtype != torch.int32 or lengths.device != cps.device:
        raise ValueError(f"{what}: expected int32[{cps.shape[0]}] lengths on {cps.device}")


def decompose_rows_plain(cps: torch.Tensor, lengths: torch.Tensor, tabs: DecompTables):
    """The decomposition kernel's semantics in torch ops: ``(out int32[R,
    max_exp * C], counts int32[R])``, each row's decompositions in order
    from its front, zeros past its count; not reordered."""
    _check_rows(cps, lengths, "nf_decompose")
    packed, pool = tabs.on(cps.device)
    R, C = cps.shape
    width = tabs.max_exp * C
    valid = torch.arange(C, device=cps.device)[None, :] < lengths[:, None]
    t = packed[cps.to(torch.int64).clamp(0, tabs.size - 1)]
    is_multi = t < 0
    m = ~t
    length = torch.where(valid, torch.where(is_multi, m & 31, 1), 0)
    off = (m >> 5).to(torch.int64)
    starts = torch.cumsum(length, 1, dtype=torch.int64) - length
    out = torch.zeros((R, width + 1), dtype=torch.int32, device=cps.device)  # column `width` takes dropped writes
    for k in range(int(length.max()) if length.numel() else 0):
        val = pool[(off + k).clamp(0, pool.numel() - 1)]
        if k == 0:
            val = torch.where(is_multi, val, t)
        dst = torch.where(length > k, (starts + k).clamp(max=width), width)
        out.scatter_(1, dst, val)
    return out[:, :width].contiguous(), length.sum(1, dtype=torch.int32)


def decompose_rows_cuda(cps: torch.Tensor, lengths: torch.Tensor, tabs: DecompTables):
    """``decompose_rows_plain`` by the CUDA kernel, on the device."""
    if cps.device.type != "cuda":
        raise ValueError(f"nf_decompose: the CUDA kernel needs a CUDA tensor, got {cps.device}")
    _check_rows(cps, lengths, "nf_decompose")
    cps, lengths = cps.contiguous(), lengths.contiguous()
    packed, pool = tabs.on(cps.device)
    R, C = cps.shape
    out = torch.empty((R, tabs.max_exp * C), dtype=torch.int32, device=cps.device)
    counts = torch.empty(R, dtype=torch.int32, device=cps.device)
    if R:
        lib = build.library()
        with torch.cuda.device(cps.device):
            code = lib.sw_nf_decompose_rows(
                cps.data_ptr(), lengths.data_ptr(), R, C, packed.data_ptr(), tabs.size, pool.data_ptr(), pool.numel(),
                tabs.max_exp, out.data_ptr(), counts.data_ptr(), build.stream_of(cps),
            )
        build.check(code, "nf_decompose")
        LAUNCHES["nf_decompose"] += 1
    return out, counts


def _decompose_only(cps, lengths, tabs: DecompTables):
    if cps.device.type == "cuda":
        return decompose_rows_cuda(cps, lengths, tabs)
    if cps.device.type == "cpu":
        return decompose_rows_plain(cps, lengths, tabs)
    raise ValueError(f"decompose_rows runs on a CUDA or CPU tensor, not {cps.device}")


def decompose_rows(cps: torch.Tensor, lengths: torch.Tensor, compat: bool = False, max_cp: int | None = None):
    """NFD (NFKD with ``compat``) of codepoint rows cut before safe
    codepoints: ``(out int32[R, C * max_exp], counts int32[R])``, the JAX
    function's outputs. Rows of 32 or 64 of a BMP corpus whose expansions
    fit 4 take row 16's expand kernel, the rest the decomposition kernel;
    both are reordered in place by ``reorder_rows_``."""
    cps = cps.to(torch.int32)
    lengths = lengths.to(device=cps.device, dtype=torch.int32)
    if decompose_route(compat, max_cp, cps.shape[1]) == "expand":
        staged, max_exp = _decomp_fused_tables(compat, int(max_cp))
        out, counts = expand.expand_compact_rows(cps.contiguous(), lengths.contiguous(), staged, max_exp,
                                                 int(cps.shape[1]), False)
    else:
        out, counts = _decompose_only(cps, lengths, decomp_tables(compat, max_cp))
    return reorder_rows_(out, counts), counts


# ---------------------------------------------------------------------------
# Canonical reordering
# ---------------------------------------------------------------------------

def reorder_rows_plain_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Canonical reordering of each row in place, in torch ops: two stable
    sorts, by ccc and then by the run of starters each codepoint follows
    (the JAX package's argsort fallback). Returns ``rows``."""
    ccc = _ccc_on(rows.device)
    live = torch.arange(rows.shape[1], device=rows.device)[None, :] < counts[:, None]
    c = torch.where(live, ccc[rows.to(torch.int64).clamp(0, ccc.numel() - 1)].to(torch.int64), 0)
    run = torch.cumsum((c == 0).to(torch.int64), 1)
    order = torch.sort(c, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(run.gather(1, order), dim=1, stable=True).indices)
    rows.copy_(rows.gather(1, order))
    return rows


def reorder_rows_cuda_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``reorder_rows_plain_`` by the CUDA kernel, on the device."""
    if rows.device.type != "cuda" or not rows.is_contiguous():
        raise ValueError(f"nf_reorder: the CUDA kernel needs a contiguous CUDA tensor, got {rows.device}")
    _check_rows(rows, counts, "nf_reorder")
    ccc = _ccc_on(rows.device)
    if rows.shape[0]:
        lib = build.library()
        with torch.cuda.device(rows.device):
            code = lib.sw_nf_reorder_rows(rows.data_ptr(), counts.contiguous().data_ptr(), rows.shape[0], rows.shape[1],
                                          ccc.data_ptr(), ccc.numel(), build.stream_of(rows))
        build.check(code, "nf_reorder")
        LAUNCHES["nf_reorder"] += 1
    return rows


def reorder_rows_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """UAX#15 D109 canonical reordering of the first ``counts[r]`` codepoints
    of each row (zeros past them), in place; returns ``rows``. A row must not
    split a run of nonzero-ccc codepoints."""
    if rows.device.type == "cuda":
        return reorder_rows_cuda_(rows, counts)
    if rows.device.type == "cpu":
        return reorder_rows_plain_(rows, counts)
    raise ValueError(f"reorder_rows_ runs on a CUDA or CPU tensor, not {rows.device}")


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _compose_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(s_rank, c_rank, dense, n_c) on ``device``; the rank maps cut after
    their last nonzero entry plus one zero, which a clamped lookup reads
    past them."""
    s_rank, c_rank, dense, n_c = _pair_tables()

    def cut(rank):
        return np.ascontiguousarray(rank[: int(np.flatnonzero(rank).max()) + 2])

    return tuple(torch.from_numpy(a).to(device) for a in (cut(s_rank), cut(c_rank), dense)) + (int(n_c),)


COMBINER = 255  # compose_classes' mark of a class-0 second element (no ccc is 255)


@functools.lru_cache(maxsize=None)
def compose_classes() -> np.ndarray:
    """uint8[0x110000]: the ccc table with every class-0 second element of a
    primary composite (the Hangul V and T jamo, and the others the dense
    table holds: 24 in Unicode 15) marked ``COMBINER``. The composition
    kernel's classes: its walk resets at every other class-0 codepoint."""
    ccc = np.array(tables.ccc_table(), dtype=np.uint8)
    if int(ccc.max()) >= COMBINER:
        raise ValueError(f"a canonical combining class of {int(ccc.max())} collides with the combiner mark")
    _, c_rank, _, _ = _pair_tables()
    cps = np.arange(ccc.size)
    ccc[((ccc == 0) & (c_rank != 0)) | _jamo(cps, l=False)] = COMBINER
    ccc.setflags(write=False)
    return ccc


@functools.lru_cache(maxsize=None)
def _compose_classes_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(compose_classes())).to(device)


def compose_rows_plain_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The composition kernel's walk in torch ops, a column at a time over
    every row: ``rows`` (reordered decompositions) composed in place, zeros
    past each row's new count; returns the counts (int32[R])."""
    _check_rows(rows, counts, "nf_compose")
    dev = rows.device
    ccc = _ccc_on(dev)
    s_rank, c_rank, dense, n_c = _compose_tables(dev)
    R, W = rows.shape
    out = torch.zeros((R, W + 1), dtype=torch.int32, device=dev)  # column W takes dropped writes
    starter = torch.full((R,), -1, dtype=torch.int64, device=dev)
    last_cc = torch.zeros(R, dtype=torch.int64, device=dev)
    spos = torch.full((R,), W, dtype=torch.int64, device=dev)
    kept = torch.zeros(R, dtype=torch.int64, device=dev)
    counts64 = counts.to(torch.int64)
    for i in range(int(counts.max()) if R else 0):
        live = i < counts64
        cp = rows[:, i].to(torch.int64)
        c = ccc[cp.clamp(0, ccc.numel() - 1)].to(torch.int64)
        lv = _SBASE + ((starter - _LBASE) * _VCOUNT + (cp - _VBASE)) * _TCOUNT
        is_l = (starter >= _LBASE) & (starter < _LBASE + _LCOUNT)
        is_v = (cp >= _VBASE) & (cp < _VBASE + _VCOUNT)
        is_lv = (starter >= _SBASE) & (starter < _SBASE + _SCOUNT) & ((starter - _SBASE) % _TCOUNT == 0)
        is_t = (cp > _TBASE) & (cp < _TBASE + _TCOUNT)
        sr = s_rank[starter.clamp(0, s_rank.numel() - 1)].to(torch.int64)
        cr = c_rank[cp.clamp(0, c_rank.numel() - 1)].to(torch.int64)
        pair = dense[sr * n_c + cr].to(torch.int64)
        composed = torch.where(is_l & is_v, lv, torch.where(is_lv & is_t, starter + (cp - _TBASE), torch.where(pair > 0, pair, -1)))
        do = live & (starter >= 0) & (composed >= 0) & ((last_cc == 0) | (last_cc < c))
        emit = live & ~do
        is_starter = emit & (c == 0)
        dst = torch.where(do, spos, torch.where(emit, kept, W))
        out.scatter_(1, dst[:, None], torch.where(do, composed, cp).to(torch.int32)[:, None])
        spos = torch.where(is_starter, kept, spos)
        starter = torch.where(do, composed, torch.where(is_starter, cp, starter))
        last_cc = torch.where(is_starter, 0, torch.where(emit, c, last_cc))
        kept = kept + emit.to(torch.int64)
    rows.copy_(out[:, :W])
    return kept.to(torch.int32)


def compose_rows_cuda_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``compose_rows_plain_`` by the CUDA kernel, on the device."""
    if rows.device.type != "cuda" or not rows.is_contiguous():
        raise ValueError(f"nf_compose: the CUDA kernel needs a contiguous CUDA tensor, got {rows.device}")
    _check_rows(rows, counts, "nf_compose")
    classes = _compose_classes_on(rows.device)
    s_rank, c_rank, dense, n_c = _compose_tables(rows.device)
    kept = torch.empty_like(counts)
    if rows.shape[0]:
        lib = build.library()
        with torch.cuda.device(rows.device):
            code = lib.sw_nf_compose_rows(
                rows.data_ptr(), counts.contiguous().data_ptr(), kept.data_ptr(), rows.shape[0], rows.shape[1],
                classes.data_ptr(), classes.numel(), s_rank.data_ptr(), s_rank.numel(), c_rank.data_ptr(), c_rank.numel(),
                dense.data_ptr(), n_c, build.stream_of(rows),
            )
        build.check(code, "nf_compose")
        LAUNCHES["nf_compose"] += 1
    return kept


def compose_rows_(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """UAX#15 canonical composition of each reordered row (rows cut before
    safe codepoints), in place: each row's composed codepoints from its
    front, zeros past them. Returns the new counts, int32[R]."""
    if rows.device.type == "cuda":
        return compose_rows_cuda_(rows, counts)
    if rows.device.type == "cpu":
        return compose_rows_plain_(rows, counts)
    raise ValueError(f"compose_rows_ runs on a CUDA or CPU tensor, not {rows.device}")


def normalize_rows(cps: torch.Tensor, lengths: torch.Tensor, form: str, max_cp: int | None = None):
    """``form`` of each codepoint row (cut before safe codepoints):
    ``(out int32[R, C * max_exp], counts int32[R])``. NFD/NFKD decompose
    and reorder; NFC/NFKC compose that in place."""
    out, counts = decompose_rows(cps, lengths, is_compat(form), max_cp)
    if form in ("NFC", "NFKC"):
        counts = compose_rows_(out, counts)
    return out, counts


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

def row_starts(allowed: torch.Tensor, width: int, fallback: torch.Tensor | None = None) -> torch.Tensor:
    """Starts (int64, on the mask's device) that cut positions ``[0, n)``
    into rows of at most ``width``, greedily from 0: a row ends before the
    last ``allowed`` position within ``width`` of its start, or, where there
    is none, before the last ``fallback`` position (when given), or else
    after ``width`` positions.

    The chain of starts is walked in chunks of ``64 * width`` positions at
    once: first from every entry a chunk can have (the chain enters each
    chunk within ``width`` of its start), then, once the entries are linked
    on the host, from the true ones."""
    n = allowed.numel()
    if not 0 < width < 1 << 16:
        raise ValueError(f"width must lie in [1, 65535], got {width}")
    dev = allowed.device
    if n <= width:
        return torch.zeros(1, dtype=torch.int64, device=dev)

    def distance_back(mask: torch.Tensor) -> torch.Tensor:
        """How far each position lies past the last marked one at or before
        it, capped at ``width``."""
        pos = torch.arange(n, device=dev)
        rank = torch.cumsum(mask, 0) - 1  # index among the marked of the last one at or before p
        marked = torch.nonzero(mask).squeeze(1)
        last = torch.where(rank >= 0, marked[rank.clamp(min=0)] if marked.numel() else rank, -1)
        return (pos - last).clamp(max=width)

    back = distance_back(allowed)
    back_fallback = distance_back(fallback) if fallback is not None else None

    def step(s: torch.Tensor) -> torch.Tensor:
        """The next start after s (for s + width < n)."""
        e = (s + width).clamp(max=n - 1)
        d = back[e]
        nxt = torch.where(d < width, e - d, e)
        if back_fallback is not None:
            d2 = back_fallback[e]
            nxt = torch.where(d < width, nxt, torch.where(d2 < width, e - d2, e))
        return nxt

    chunk = 64 * width
    chunk_ends = torch.arange(1, -(-n // chunk) + 1, device=dev) * chunk
    cur = (chunk_ends - chunk)[:, None] + torch.arange(width, device=dev)[None, :]
    live = cur + width < n
    while bool(live.any()):
        cur = torch.where(live, step(cur), cur)
        live &= (cur < chunk_ends[:, None]) & (cur + width < n)
    exits = (cur - chunk_ends[:, None]).tolist()  # offset into the next chunk, < 0 where the chain ends
    entries, offset = [], 0
    for k, row in enumerate(exits):
        entries.append(k * chunk + offset)
        offset = row[offset]
        if offset < 0:
            break
    cur = torch.tensor(entries, dtype=torch.int64, device=dev)
    ends = chunk_ends[: cur.numel()]
    visited = [cur]
    live = cur + width < n
    while bool(live.any()):
        cur = torch.where(live, step(cur), cur)
        inside = live & (cur < ends)
        visited.append(torch.where(inside, cur, -1))
        live = inside & (cur + width < n)
    starts = torch.stack(visited, 1).reshape(-1)  # chunk by chunk, each in order
    return starts[starts >= 0]


@dataclasses.dataclass(frozen=True)
class CodepointRows:
    """Rows of a codepoint stream: ``rows`` int32[R, width] zero-padded,
    ``lengths`` int32[R], and ``first`` int64[R], the stream index of each
    row's first codepoint."""

    rows: torch.Tensor
    lengths: torch.Tensor
    first: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.rows.shape[0])

    @property
    def width(self) -> int:
        return int(self.rows.shape[1])


def _gather_rows(cps: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, width: int) -> CodepointRows:
    count = starts.numel()
    mat = torch.zeros((count, width), dtype=torch.int32, device=cps.device)
    total = int(lengths.sum()) if count else 0
    if total:
        row = torch.repeat_interleave(torch.arange(count, device=cps.device), lengths, output_size=total)
        intra = torch.arange(total, device=cps.device) - (torch.cumsum(lengths, 0) - lengths)[row]
        mat.view(-1)[row * width + intra] = cps[starts[row] + intra].to(torch.int32)
    return CodepointRows(mat, lengths.to(torch.int32), starts)


def segment_rows(cps: torch.Tensor, compat: bool, forced: torch.Tensor | None = None) -> list[CodepointRows]:
    """A codepoint stream as rows cut only before safe codepoints (and at
    every ``forced`` position, which must be safe): rows of ``ROW`` holding
    at most ``ROW`` codepoints each, greedily filled, and, where a stretch
    longer than ``ROW`` holds no safe codepoint, a bucket of wider rows (a
    multiple of ``ROW``) holding those stretches. Each bucket is present
    only when it holds a row; an empty stream has none."""
    n = cps.numel()
    if n == 0:
        return []
    safe = safe_on(compat, cps.device)[cps.to(torch.int64).clamp(0, tables.MAX_CP - 1)]
    if forced is not None:
        safe = safe | forced
    starts = row_starts(safe, ROW)
    starts = starts[safe[starts] | (starts == 0)]  # the greedy walk cuts after ROW where no cut is safe: undo those
    if forced is not None:
        starts = torch.unique(torch.cat([starts, torch.nonzero(forced).squeeze(1)]))
    lengths = torch.diff(starts, append=torch.tensor([n], device=cps.device))
    buckets = []
    narrow = lengths <= ROW
    if bool(narrow.any()):
        buckets.append(_gather_rows(cps, starts[narrow], lengths[narrow], ROW))
    if not bool(narrow.all()):
        wide = ~narrow
        width = -(-int(lengths[wide].max()) // ROW) * ROW
        buckets.append(_gather_rows(cps, starts[wide], lengths[wide], width))
    return buckets


def gather_outputs(buckets: list[CodepointRows], outputs: list[tuple[torch.Tensor, torch.Tensor]]):
    """(values int32, keys int64): every bucket's output codepoints, each
    keyed by its row's ``first``, in row order within a row."""
    values, keys = [], []
    for bucket, (out, counts) in zip(buckets, outputs):
        live = torch.arange(out.shape[1], device=out.device)[None, :] < counts[:, None]
        values.append(out[live])
        keys.append(torch.repeat_interleave(bucket.first, counts.to(torch.int64)))
    if not values:
        return torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int64)
    return torch.cat(values), torch.cat(keys)


# ---------------------------------------------------------------------------
# Flat stream and host wrappers
# ---------------------------------------------------------------------------

def decompose(cps: torch.Tensor, n: int, compat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """NFD (NFKD) of a zero-padded codepoint stream in torch ops: ``(out
    int32[n * max_exp], count)``, reordered, zeros past the count (the JAX
    package's flat ``decompose``: 4 outputs a codepoint for NFD, 18 for
    NFKD). The plain flat version, for the parity tests."""
    tabs = decomp_tables(compat)
    rows = cps[:n].to(torch.int32).reshape(1, -1)
    out, count = decompose_rows_plain(rows, torch.tensor([n], dtype=torch.int32, device=cps.device), tabs)
    return reorder_rows_plain_(out, count)[0], count[0]


def normalize(text_cps: np.ndarray, form: str = "NFC", device="cuda") -> np.ndarray:
    """``form`` (NFD, NFKD, NFC or NFKC) of a host codepoint array, through
    the row pipeline on ``device``; returns the normalized array."""
    compat = is_compat(form)
    cps = torch.from_numpy(np.asarray(text_cps, np.int32).copy()).to(device)
    if cps.numel() == 0:
        return np.zeros(0, np.int32)
    max_cp = int(cps.max())
    buckets = segment_rows(cps, compat)
    outputs = [normalize_rows(b.rows, b.lengths, form, max_cp) for b in buckets]
    values, keys = gather_outputs(buckets, outputs)
    return values[torch.sort(keys, stable=True).indices].cpu().numpy()


def normalize_text(text: str, form: str = "NFC", device="cuda") -> str:
    cps = np.frombuffer(text.encode("utf-32-le"), np.int32) if text else np.zeros(0, np.int32)
    return "".join(map(chr, normalize(cps, form, device).tolist()))
