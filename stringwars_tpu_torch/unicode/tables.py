"""Unicode class tables for segmentation (UCD 15.0), dense over [0, 0x110000).

The port of the segmentation part of ``stringwars_tpu.unicode.tables``:

- ``whitespace_table`` / ``newline_table``: from ``str.isspace`` and the
  seven newline functions, computed at first use;
- the break-property tables (``grapheme_break_table``, ``word_break_table``,
  ``sentence_break_table``, ``extended_pictographic_table``,
  ``line_break_table``, ``incb_table``): loaded from data in this package,
  ``data/breaks-ucd15.0.0.npz``, which holds each table as run-length arrays
  (``<name>_starts``, ``<name>_values``, int32). The JAX package scans the
  ``regex`` module's ``\\p{...}`` classes at first use; the port must run
  where ``regex`` is not installed, so the scan is done once by
  ``python -m stringwars_tpu_torch.unicode.gen_tables`` (which needs
  ``regex``) and its output is committed. Nothing is read from or written
  to a cache outside the package.

- ``casefold_tables``: full case folding (C+F) as ``(inline, multi, pool)``,
  from ``str.casefold`` of every codepoint, computed at first use and kept
  in memory only. The tables follow the UCD of
  the running Python, ``unicodedata.unidata_version`` (``UNIDATA_VERSION``:
  15.0.0 under Python 3.12, the version of the committed break tables).

- ``decomposition_tables`` (NFD, or NFKD with ``compat``), ``ccc_table``,
  ``composition_pairs`` and ``nfc_fast_table`` (NFC, or NFKC): the
  normalization tables, from ``unicodedata`` at first use and kept in memory
  only, element for element the JAX package's (the same ``_pooled`` layout,
  primary composites by the NFC round trip, the Hangul V/T jamo marked
  QC=Maybe). Only the codepoints that have a decomposition mapping (and the
  Hangul syllables) are normalized one by one; every other codepoint is its
  own decomposition.

The value tuples number the classes exactly as the JAX package does, so a
class id means the same in both packages.
"""

from __future__ import annotations

import functools
import unicodedata
from pathlib import Path

import numpy as np

MAX_CP = 0x110000
UCD_VERSION = "15.0.0"  # of the committed break tables
UNIDATA_VERSION = unicodedata.unidata_version  # of str.casefold, hence of casefold_tables
DATA_PATH = Path(__file__).resolve().parent / "data" / f"breaks-ucd{UCD_VERSION}.npz"

NEWLINE_CPS = (0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029)

GCB_VALUES = (
    "Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
    "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT",
)
WB_VALUES = (
    "Other", "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator",
    "Format", "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote",
    "Double_Quote", "MidNumLet", "MidLetter", "MidNum", "Numeric",
    "ExtendNumLet", "WSegSpace",
)
SB_VALUES = (
    "Other", "CR", "LF", "Extend", "Sep", "Format", "Sp", "Lower", "Upper",
    "OLetter", "Numeric", "ATerm", "STerm", "Close", "SContinue",
)
LB_VALUES = (
    "XX", "BK", "CR", "LF", "NL", "SP", "ZW", "WJ", "GL", "BA", "BB",
    "B2", "HY", "CB", "CL", "CP", "EX", "IN", "NS", "OP", "QU", "IS",
    "NU", "PO", "PR", "SY", "AI", "AL", "CJ", "EB", "EM", "H2", "H3",
    "HL", "ID", "JL", "JT", "JV", "RI", "SA", "CM", "ZWJ",
)
INCB_VALUES = ("None", "Extend", "Linker", "Consonant")

# Table name in the data file -> (UCD property, its values; None for the
# binary Extended_Pictographic).
BREAK_PROPERTIES = {
    "gcb": ("Grapheme_Cluster_Break", GCB_VALUES),
    "wb": ("Word_Break", WB_VALUES),
    "sb": ("Sentence_Break", SB_VALUES),
    "extpict": ("Extended_Pictographic", None),
    "lb": ("Line_Break", LB_VALUES),
    "incb": ("InCB", INCB_VALUES),
}


def run_lengths(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, values) int32: the table's runs of equal values."""
    t = np.asarray(table).astype(np.int64)
    starts = np.concatenate([[0], np.flatnonzero(t[1:] != t[:-1]) + 1])
    return starts.astype(np.int32), t[starts].astype(np.int32)


def expand_runs(starts: np.ndarray, values: np.ndarray, size: int = MAX_CP) -> np.ndarray:
    """The dense int64 table of ``run_lengths``' arrays."""
    lengths = np.diff(np.append(starts.astype(np.int64), size))
    return np.repeat(values.astype(np.int64), lengths)


@functools.lru_cache(maxsize=None)
def _runs() -> dict[str, np.ndarray]:
    if not DATA_PATH.exists():
        raise FileNotFoundError(
            f"{DATA_PATH} is missing: regenerate it with python -m stringwars_tpu_torch.unicode.gen_tables"
        )
    with np.load(DATA_PATH) as z:
        return {key: z[key] for key in z.files}


def _break_table(name: str, dtype) -> np.ndarray:
    runs = _runs()
    table = expand_runs(runs[f"{name}_starts"], runs[f"{name}_values"]).astype(dtype)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def whitespace_table() -> np.ndarray:
    ws = np.zeros(MAX_CP, dtype=bool)
    # str.isspace: 29 codepoints, the 25 of UCD White_Space plus the
    # separators U+001C-U+001F; all lie below 0x4000.
    for cp in range(0x4000):
        if chr(cp).isspace():
            ws[cp] = True
    ws.setflags(write=False)
    return ws


def _pooled(mapping: dict[int, list[int]]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode cp -> sequence as (inline, multi, pool): ``inline[cp]`` is the
    mapped cp when the sequence has one codepoint, else -1; ``multi[cp]``
    packs ``pool_offset << 5 | length`` for longer sequences, whose
    codepoints follow one another in ``pool``."""
    inline = np.arange(MAX_CP, dtype=np.int32)
    multi = np.zeros(MAX_CP, dtype=np.int64)
    pool: list[int] = []
    for cp, seq in mapping.items():
        if len(seq) == 1:
            inline[cp] = seq[0]
        else:
            if len(seq) >= 32:
                raise ValueError(f"U+{cp:04X} maps to {len(seq)} codepoints, more than 5 bits hold")
            multi[cp] = (len(pool) << 5) | len(seq)
            inline[cp] = -1
            pool.extend(seq)
    return inline, multi, np.array(pool or [0], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def casefold_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inline int32, multi int64, pool int32) over [0, 0x110000): full case
    folding of each codepoint by ``str.casefold`` (surrogates map to
    themselves). Read-only arrays; the same values as the JAX package's."""
    mapping: dict[int, list[int]] = {}
    for cp in range(MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        folded = chr(cp).casefold()
        if folded != chr(cp):
            mapping[cp] = [ord(c) for c in folded]
    tables = _pooled(mapping)
    for t in tables:
        t.setflags(write=False)
    return tables


def _read_only(*arrays: np.ndarray):
    for a in arrays:
        a.setflags(write=False)
    return arrays if len(arrays) > 1 else arrays[0]


_SBASE, _SCOUNT = 0xAC00, 11172  # the Hangul syllables (UAX#15 §3.12)


@functools.lru_cache(maxsize=None)
def _with_decomposition() -> np.ndarray:
    """int64: the codepoints whose NFD or NFKD can differ from themselves:
    those with a decomposition mapping, and the Hangul syllables."""
    cps = [cp for cp in range(MAX_CP) if not 0xD800 <= cp <= 0xDFFF and unicodedata.decomposition(chr(cp))]
    return np.union1d(np.asarray(cps, np.int64), np.arange(_SBASE, _SBASE + _SCOUNT, dtype=np.int64))



@functools.lru_cache(maxsize=None)
def decomposition_tables(compat: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inline int32, multi int64, pool int32) over [0, 0x110000): the full
    NFD (NFKD with ``compat``) of each codepoint, in ``_pooled``'s layout.
    Read-only arrays; the same values as the JAX package's."""
    form = "NFKD" if compat else "NFD"
    mapping: dict[int, list[int]] = {}
    for cp in _with_decomposition().tolist():
        expanded = unicodedata.normalize(form, chr(cp))
        if expanded != chr(cp):
            mapping[cp] = [ord(c) for c in expanded]
    return _read_only(*_pooled(mapping))


@functools.lru_cache(maxsize=None)
def ccc_table() -> np.ndarray:
    """uint8[0x110000]: the canonical combining class of each codepoint."""
    ccc = np.frombuffer(bytes(unicodedata.combining(chr(cp)) for cp in range(MAX_CP)), np.uint8).copy()
    ccc[0xD800:0xE000] = 0
    return _read_only(ccc)


@functools.lru_cache(maxsize=None)
def composition_pairs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starters, combiners, composed) int32: the primary composites, by
    the NFC round trip of each canonical two-codepoint decomposition whose
    first codepoint has ccc 0, so that the exclusions hold. The Hangul
    syllables compose by arithmetic and are left out."""
    ccc = ccc_table()
    starters, combiners, composed = [], [], []
    for cp in _with_decomposition().tolist():
        if _SBASE <= cp < _SBASE + _SCOUNT:
            continue
        raw = unicodedata.decomposition(chr(cp))
        if raw.startswith("<"):
            continue
        parts = [int(p, 16) for p in raw.split()]
        if len(parts) != 2 or ccc[parts[0]] != 0:
            continue
        if unicodedata.normalize("NFC", chr(parts[0]) + chr(parts[1])) == chr(cp):
            starters.append(parts[0])
            combiners.append(parts[1])
            composed.append(cp)
    return _read_only(np.array(starters, np.int32), np.array(combiners, np.int32), np.array(composed, np.int32))


@functools.lru_cache(maxsize=None)
def nfc_fast_table(compat: bool) -> np.ndarray:
    """bool[0x110000]: the codepoint is UAX#15 quick-check Yes for NFC (NFKC
    with ``compat``) and has ccc 0, so a run of such codepoints is its own
    NFC. QC=No where the form rewrites the lone codepoint; QC=Maybe for the
    primary combiners and the Hangul V/T jamo. Surrogates are not fast."""
    form = "NFKC" if compat else "NFC"
    fast = ccc_table() == 0
    fast[0xD800:0xE000] = False
    for cp in _with_decomposition().tolist():
        c = chr(cp)
        if unicodedata.normalize(form, c) != c:
            fast[cp] = False
    _, combiners, _ = composition_pairs()
    fast[combiners] = False
    fast[0x1161:0x1176] = False  # Hangul V jamo (QC=Maybe)
    fast[0x11A8:0x11C3] = False  # Hangul T jamo (QC=Maybe)
    return _read_only(fast)


@functools.lru_cache(maxsize=None)
def newline_table() -> np.ndarray:
    nl = np.zeros(MAX_CP, dtype=bool)
    nl[list(NEWLINE_CPS)] = True
    nl.setflags(write=False)
    return nl


@functools.lru_cache(maxsize=None)
def grapheme_break_table() -> np.ndarray:
    return _break_table("gcb", np.uint8)


@functools.lru_cache(maxsize=None)
def word_break_table() -> np.ndarray:
    return _break_table("wb", np.uint8)


@functools.lru_cache(maxsize=None)
def sentence_break_table() -> np.ndarray:
    return _break_table("sb", np.uint8)


@functools.lru_cache(maxsize=None)
def extended_pictographic_table() -> np.ndarray:
    return _break_table("extpict", bool)


@functools.lru_cache(maxsize=None)
def line_break_table() -> tuple[np.ndarray, tuple[str, ...]]:
    """UAX#14 line-break classes (numbered by ``LB_VALUES``) and the values."""
    return _break_table("lb", np.uint8), LB_VALUES


@functools.lru_cache(maxsize=None)
def incb_table() -> np.ndarray:
    """Indic_Conjunct_Break: 0=None, 1=Extend, 2=Linker, 3=Consonant (GB9c)."""
    return _break_table("incb", np.uint8)
