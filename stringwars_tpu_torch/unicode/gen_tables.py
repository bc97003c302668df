"""Regenerate the break-property data of ``unicode/tables.py``.

    python -m stringwars_tpu_torch.unicode.gen_tables

Classifies every codepoint by the ``regex`` module's ``\\p{Property=Value}``
classes, as the JAX package's ``unicode.tables._scan_property`` does, and
writes each table as run-length arrays to ``tables.DATA_PATH``. It needs
``regex``; the port itself only reads the file it writes. Run it where the
``regex`` module's Unicode data is the version in the file's name.
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


def main() -> None:
    arrays = {}
    for name, (prop, values) in tables.BREAK_PROPERTIES.items():
        starts, vals = tables.run_lengths(scan_property(prop, values))
        arrays[f"{name}_starts"], arrays[f"{name}_values"] = starts, vals
        print(f"{name}: {starts.size} runs", file=sys.stderr)
    tables.DATA_PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(tables.DATA_PATH, **arrays)
    print(f"wrote {tables.DATA_PATH} ({tables.DATA_PATH.stat().st_size} bytes)", file=sys.stderr)


if __name__ == "__main__":
    main()
