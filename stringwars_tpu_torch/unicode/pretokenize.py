"""GPT-2's pre-tokenization split, on the standard library's ``re``.

The counterpart of the inline pre-split of the JAX tokenization suite's
``tokenize-bpe`` group (``stringwars_tpu/suites/tokenization.py``), which
compiles GPT-2's public pattern (Radford et al. 2019) with the ``regex``
module::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

The card's machine has no ``regex``, and stdlib ``re`` has no ``\\p{...}``.
So ``gpt2_pretokens`` writes ``\\p{L}``, ``\\p{N}`` and ``\\s`` out as
explicit classes of codepoint ranges and ``(?!\\S)`` as a negative lookahead
of the complement of the explicit ``\\s`` class. The ranges are the
``regex`` module's own, committed as run-length data in
``data/pretokenize-regex<REGEX_VERSION>.npz`` (``letter``, ``number`` and
``space``: ``<name>_starts``, ``<name>_values``) and regenerated by
``python -m stringwars_tpu_torch.unicode.gen_tables``, which needs
``regex``. Two things make these classes, and not ones built from the
standard library, the ones that give ``regex.findall``'s list:

- ``regex``'s ``\\s`` is Unicode White_Space, 25 codepoints; stdlib
  ``re``'s ``\\s`` is ``str.isspace``, 29 (U+001C-U+001F more);
- ``regex`` carries its own Unicode data, newer than ``unicodedata``'s, so
  its ``\\p{L}`` and ``\\p{N}`` hold codepoints that ``unicodedata`` calls
  unassigned.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np

from stringwars_tpu_torch.unicode import tables

REGEX_VERSION = "2026.7.19"  # of the regex module that wrote the committed classes
DATA_PATH = Path(__file__).resolve().parent / "data" / f"pretokenize-regex{REGEX_VERSION}.npz"
# Class name in the data file -> the regex module's class it holds.
CLASSES = {"letter": r"\p{L}", "number": r"\p{N}", "space": r"\s"}


@functools.lru_cache(maxsize=None)
def class_ranges() -> dict[str, list[tuple[int, int]]]:
    """Each class as its inclusive codepoint ranges, from the committed data."""
    if not DATA_PATH.exists():
        raise FileNotFoundError(f"{DATA_PATH} is missing: regenerate it with python -m stringwars_tpu_torch.unicode.gen_tables")
    out = {}
    with np.load(DATA_PATH) as z:
        for name in CLASSES:
            starts, values = z[f"{name}_starts"].astype(np.int64), z[f"{name}_values"]
            ends = np.append(starts[1:], tables.MAX_CP) - 1
            out[name] = [(int(lo), int(hi)) for lo, hi, v in zip(starts, ends, values) if v]
    return out


def _class_body(ranges: list[tuple[int, int]]) -> str:
    return "".join(rf"\U{lo:08X}" if lo == hi else rf"\U{lo:08X}-\U{hi:08X}" for lo, hi in ranges)


@functools.lru_cache(maxsize=None)
def gpt2_pattern() -> re.Pattern:
    """GPT-2's pattern with the three classes written out, for stdlib ``re``."""
    ranges = class_ranges()
    letter, number, space = (_class_body(ranges[name]) for name in CLASSES)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+| ?[^{space}{letter}{number}]+"
        rf"|[{space}]+(?![^{space}])|[{space}]+"
    )


def gpt2_pretokens(text: str) -> list[str]:
    """``regex.findall`` of GPT-2's pattern over ``text``, without ``regex``."""
    return gpt2_pattern().findall(text)
