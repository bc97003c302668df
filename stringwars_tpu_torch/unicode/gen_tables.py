"""Regenerate the break-property data of ``unicode/tables.py`` and the
pre-split classes of ``unicode/pretokenize.py``.

    python -m stringwars_tpu_torch.unicode.gen_tables

Classifies every codepoint by the ``regex`` module's ``\\p{Property=Value}``
classes, as the JAX package's ``unicode.tables._scan_property`` does, and
writes each table as run-length arrays to ``tables.DATA_PATH``. It needs
``regex``; the port itself only reads the files it writes. Run it where the
``regex`` module's Unicode data is the version in the file's name.

It also scans ``regex``'s ``\\p{L}``, ``\\p{N}`` and ``\\s`` (GPT-2's
pre-split classes) into ``pretokenize-regex<version>.npz``, named after the
running ``regex``; ``pretokenize.REGEX_VERSION`` names the file the port reads.
"""

from __future__ import annotations

import sys

import numpy as np

from stringwars_tpu_torch.unicode import tables


def _codepoints() -> tuple[str, np.ndarray]:
    cps = np.array([c for c in range(tables.MAX_CP) if not (0xD800 <= c <= 0xDFFF)], dtype=np.int64)
    return "".join(map(chr, cps.tolist())), cps


def scan_property(prop: str, values: tuple[str, ...] | None) -> np.ndarray:
    """Class of every codepoint: the index of its value in ``values``
    (0 = ``values[0]``, the default), or 0/1 for a binary property."""
    import regex

    text, cp_of_index = _codepoints()
    table = np.zeros(tables.MAX_CP, dtype=np.uint8)
    classes = [(1, rf"[\p{{{prop}}}]+")] if values is None else [
        (vi, rf"[\p{{{prop}={value}}}]+") for vi, value in enumerate(values[1:], start=1)
    ]
    for vi, pattern in classes:
        for m in regex.compile(pattern, regex.V1).finditer(text):
            table[cp_of_index[m.start() : m.end()]] = vi
    return table


def scan_class(pattern: str) -> np.ndarray:
    """1 where the ``regex`` module's class ``pattern`` (one codepoint)
    matches, else 0; surrogates are 0."""
    import regex

    text, cp_of_index = _codepoints()
    table = np.zeros(tables.MAX_CP, dtype=np.uint8)
    for m in regex.compile(f"(?:{pattern})+").finditer(text):
        table[cp_of_index[m.start() : m.end()]] = 1
    return table


def _save(path, arrays: dict[str, np.ndarray]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({path.stat().st_size} bytes)", file=sys.stderr)


def main() -> None:
    import regex

    from stringwars_tpu_torch.unicode import pretokenize

    arrays = {}
    for name, (prop, values) in tables.BREAK_PROPERTIES.items():
        starts, vals = tables.run_lengths(scan_property(prop, values))
        arrays[f"{name}_starts"], arrays[f"{name}_values"] = starts, vals
        print(f"{name}: {starts.size} runs", file=sys.stderr)
    _save(tables.DATA_PATH, arrays)
    # GPT-2's pre-split classes, named after the regex version that made them.
    arrays = {}
    for name, pattern in pretokenize.CLASSES.items():
        starts, vals = tables.run_lengths(scan_class(pattern))
        arrays[f"{name}_starts"], arrays[f"{name}_values"] = starts, vals
        print(f"{name} ({pattern}): {int(vals.sum())} runs of members", file=sys.stderr)
    path = pretokenize.DATA_PATH.with_name(f"pretokenize-regex{regex.__version__}.npz")
    _save(path, arrays)
    if path != pretokenize.DATA_PATH:
        print(f"set pretokenize.REGEX_VERSION to {regex.__version__!r} to read it", file=sys.stderr)


if __name__ == "__main__":
    main()
