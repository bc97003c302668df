"""The port's Unicode class tables against the JAX package's.

The port loads the break-property tables from run-length data committed in
the package (``stringwars_tpu_torch/unicode/data``), since the machine with
the card has no ``regex`` module; each expanded table must equal the JAX
package's, which scans ``regex``'s property classes. Whitespace and newline
come from ``str.isspace`` and the newline list in both packages.
"""

import re

import numpy as np
import pytest

from stringwars_tpu.unicode import tables as J
from stringwars_tpu_torch.unicode import gen_tables
from stringwars_tpu_torch.unicode import tables as P

TABLES = [
    "grapheme_break_table",
    "word_break_table",
    "sentence_break_table",
    "extended_pictographic_table",
    "line_break_table",
    "incb_table",
    "whitespace_table",
    "newline_table",
]


def _dense(module, name):
    table = getattr(module, name)()
    return table[0] if isinstance(table, tuple) else table


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_jax(name):
    want = np.asarray(_dense(J, name))
    got = _dense(P, name)
    assert got.shape == (P.MAX_CP,) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_value_tuples_equal_jax():
    assert P.GCB_VALUES == J.GCB_VALUES
    assert P.WB_VALUES == J.WB_VALUES
    assert P.SB_VALUES == J.SB_VALUES
    assert P.line_break_table()[1] == J.line_break_table()[1] == P.LB_VALUES
    assert P.NEWLINE_CPS == J.NEWLINE_CPS


def test_data_file_holds_run_lengths():
    """One compressed file, named with its UCD version, of int32 run
    arrays whose expansion is each table; a few tens of KB."""
    assert P.DATA_PATH.name == f"breaks-ucd{P.UCD_VERSION}.npz"
    assert P.DATA_PATH.stat().st_size < 200_000
    with np.load(P.DATA_PATH) as z:
        assert sorted(z.files) == sorted(f"{k}_{part}" for k in P.BREAK_PROPERTIES for part in ("starts", "values"))
        runs = sum(z[f"{k}_starts"].size for k in P.BREAK_PROPERTIES)
        for key in z.files:
            assert z[key].dtype == np.int32
    assert 5_000 < runs < 40_000


def test_run_lengths_roundtrip(rng):
    table = np.repeat(rng.integers(0, 9, 300), rng.integers(1, 50, 300)).astype(np.uint8)
    starts, values = P.run_lengths(table)
    assert starts[0] == 0 and np.all(np.diff(starts) > 0) and np.all(values[1:] != values[:-1])
    np.testing.assert_array_equal(P.expand_runs(starts, values, table.size), table)


def test_loaders_read_only_the_package(monkeypatch, tmp_path):
    """No cache outside the package is read or written."""
    monkeypatch.setenv("HOME", str(tmp_path))
    P._runs.cache_clear()
    P.grapheme_break_table.cache_clear()
    try:
        P.grapheme_break_table()
    finally:
        P._runs.cache_clear()
        P.grapheme_break_table.cache_clear()
    assert list(tmp_path.iterdir()) == []


def test_generator_reproduces_committed_incb():
    """The generator's scan of one property equals the committed table
    (``python -m stringwars_tpu_torch.unicode.gen_tables`` rewrites all)."""
    _, values = P.BREAK_PROPERTIES["incb"]
    np.testing.assert_array_equal(gen_tables.scan_property("InCB", values), P.incb_table())


def test_tables_module_imports_no_regex():
    source = open(P.__file__).read()
    assert not re.search(r"^\s*(import|from)\s+regex", source, re.M)
