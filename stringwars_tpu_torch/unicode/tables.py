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

The value tuples number the classes exactly as the JAX package does, so a
class id means the same in both packages. Case folding, decompositions,
combining classes and compositions come with the normalization slice.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

MAX_CP = 0x110000
UCD_VERSION = "15.0.0"
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
    for cp in range(0x4000):  # all UCD White_Space cps are < 0x4000
        if chr(cp).isspace():
            ws[cp] = True
    ws.setflags(write=False)
    return ws


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
