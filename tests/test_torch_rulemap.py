"""The port's step rules, ``step_map``, ``lut_map`` and ``class_map``
against the JAX package.

``compile_steps`` / ``prune`` must give the JAX package's starts and deltas
for every segmentation table; ``step_map`` and ``lut_map`` (on the CPU, the
plain gather of ``ops/lut.class_map``, which the CUDA kernel
``csrc/classmap.cu`` is held against on the card) must equal the JAX Pallas
kernels run in interpret mode. Lookups are integers: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import lut as JL
from stringwars_tpu.ops import rulemap as JR
from stringwars_tpu.unicode import tables as JT
from stringwars_tpu_torch.ops import lut as L
from stringwars_tpu_torch.ops import rulemap as R
from stringwars_tpu_torch.ops import segment as SEG
from stringwars_tpu_torch.unicode import tables as T
from _torch_threads import one_thread  # noqa: F401


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


def _table(name):
    t = getattr(T, name)()
    return np.asarray(t[0] if isinstance(t, tuple) else t)


def _jax_table(name):
    t = getattr(JT, name)()
    return np.asarray(t[0] if isinstance(t, tuple) else t)


@pytest.mark.parametrize("name", TABLES)
def test_compile_and_prune_equal_jax(name):
    want_full = JR.compile_steps(_jax_table(name))
    got_full = R.compile_steps(_table(name))
    for max_cp in (None, 0x7F, 0x7FF, 0xFFFF):
        want = want_full if max_cp is None else want_full.prune(max_cp)
        got = got_full if max_cp is None else got_full.prune(max_cp)
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.deltas, want.deltas)
        assert got.starts.dtype == want.starts.dtype == np.int32
        np.testing.assert_array_equal(R.expand_steps(got, got.size), JR.expand_steps(want, got.size))


def _cps(rng, rules, count=4000):
    return np.concatenate(
        [
            rng.integers(0, 0x600, count),
            rng.integers(0, 0x110000, count // 4),
            rules.starts[rng.integers(0, rules.count, count // 8)],  # exact boundaries
            rules.starts[rng.integers(0, rules.count, count // 8)] - 1,
        ]
    ).clip(0).astype(np.int32)


@pytest.mark.parametrize("name,max_cp", [("word_break_table", None), ("line_break_table", None), ("grapheme_break_table", 0x7F), ("sentence_break_table", 0x7F)])
def test_step_map_equals_jax_kernel(name, max_cp, rng):
    """Unpruned tables take the TPU's boundary walk, tables pruned to ASCII
    its lane-gather LUT; the port's dense lookup equals both."""
    rules = R.compile_steps(_table(name))
    jrules = JR.StepRules(rules.starts, rules.deltas)
    if max_cp is not None:
        rules, jrules = rules.prune(max_cp), jrules.prune(max_cp)
    cps = _cps(rng, rules)
    if max_cp is not None:
        cps = cps[cps <= max_cp]
    want = np.asarray(JR.step_map(jnp.asarray(cps), jrules, interpret=True))
    got = R.step_map(torch.from_numpy(cps), rules)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    staged = L.stage_table(_table(name), "cpu")
    np.testing.assert_array_equal(R.step_map(torch.from_numpy(cps), rules, staged).numpy(), want)


def test_step_rules_from_numpy():
    jrules = JR.compile_steps(_jax_table("incb_table")).prune(0xFFFF)
    rules = R.StepRules.from_numpy(jrules.starts, jrules.deltas)
    assert rules == R.StepRules(rules.starts, rules.deltas) and rules.count == jrules.count
    with pytest.raises(ValueError):
        R.StepRules.from_numpy(jrules.starts, jrules.deltas[:-1])


@pytest.mark.parametrize("size", [1, 100, 128, 300, 1280])
def test_lut_map_equals_jax_kernel(size):
    rng = np.random.default_rng(size)
    table = rng.integers(-(2**30), 2**30, size).astype(np.int32)
    idx = rng.integers(0, size, 70_000).astype(np.int32)
    want = np.asarray(JL.lut_map(jnp.asarray(idx), table, interpret=True))
    got = L.lut_map(torch.from_numpy(idx), table)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_map_shapes_preserved():
    table = np.arange(256, dtype=np.int32) * 3
    idx = np.arange(2 * 5 * 7, dtype=np.int32).reshape(2, 5, 7) % 256
    want = np.asarray(JL.lut_map(jnp.asarray(idx), table, interpret=True))
    got = L.lut_map(torch.from_numpy(idx), table)
    assert tuple(got.shape) == (2, 5, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stage_table_narrows_when_values_fit():
    assert L.stage_table(np.array([0, 255, 3]), "cpu").dtype == torch.uint8
    assert L.stage_table(np.array([True, False]), "cpu").dtype == torch.uint8
    assert L.stage_table(np.array([0, 256]), "cpu").dtype == torch.int32
    assert L.stage_table(np.array([-1, 3]), "cpu").dtype == torch.int32


def test_class_map_clamps_past_the_table():
    """Fault F6 of the JAX package: the invalid lead bytes 0xF5-0xFF decode
    above 0x10FFFF; its CPU gather reads a fill value past the table, its TPU
    kernels clamp. The port clamps on every route."""
    raw = bytes(b for lead in range(0xF5, 0x100) for b in (lead, 0xBF, 0xBF, 0xBF))
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    cp, is_lead, _ = SEG._byte_space(data, len(raw))
    assert int(cp[is_lead].max()) > 0x10FFFF
    for name in ("grapheme_break_table", "line_break_table"):
        table = _table(name)
        for max_cp in (None, 0x10FFFF):
            size = R.compile_steps(table).prune(max_cp or 0x10FFFF).size
            got = SEG._class_of(cp, name, max_cp)
            want = table[np.clip(cp.numpy(), 0, size - 1)]
            np.testing.assert_array_equal(got.numpy(), want)
    # Segmentation runs over such bytes without error on both routes.
    for fn in (SEG.grapheme_boundaries, SEG.linebreak_opportunities):
        a, b = fn(data, len(raw), scanline=True), fn(data, len(raw), scanline=False)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


def test_class_map_plain_rejects_mismatched_tables():
    cps = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        L.class_map_plain(cps, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        L.class_map_plain(cps.float(), torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        L.class_map_cuda(cps, torch.zeros(4, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# Range rules (the case-fold maps): FoldRules, dense tables, range_map
# ---------------------------------------------------------------------------

def _fold_rule_sets():
    """The JAX package's four fold rule sets, whole and pruned at 0x4FF."""
    from stringwars_tpu.ops import casefold as JC

    whole = JC._fold_rules(None)[:4]
    return {"simple": whole[0], "mlen": whole[1], "e12": whole[2], "e3": whole[3],
            "simple-0x4ff": JC._fold_rules(0x4FF)[0], "e12-0x4ff": JC._fold_rules(0x4FF)[2]}


def _port_rules(jrules):
    return R.FoldRules.from_numpy(jrules.lo, jrules.hi, jrules.delta, jrules.pmask, jrules.par, jrules.base)


def test_fold_rules_from_numpy():
    jrules = _fold_rule_sets()["simple"]
    rules = _port_rules(jrules)
    assert rules.count == jrules.count and rules.base == 0
    for field in ("lo", "hi", "delta", "pmask", "par"):
        np.testing.assert_array_equal(getattr(rules, field), getattr(jrules, field))
        assert getattr(rules, field).dtype == np.int32
    assert rules.prune(0x7F).count == jrules.prune(0x7F).count
    with pytest.raises(ValueError):
        R.FoldRules.from_numpy(jrules.lo, jrules.hi[:-1], jrules.delta, jrules.pmask, jrules.par)
    with pytest.raises(ValueError):
        R.FoldRules.from_numpy(jrules.lo, jrules.hi, jrules.delta, jrules.pmask, jrules.par, base=2)


@pytest.mark.parametrize("name", ["simple", "mlen", "e12", "e3", "simple-0x4ff"])
def test_dense_delta_table_equals_jax(name):
    jrules = _fold_rule_sets()[name]
    got = R.dense_delta_table(_port_rules(jrules))
    want = JR._dense_delta_table(jrules)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0  # the rule-free last entry


def _range_cps(rng, rules, count=3000):
    """Random BMP and astral codepoints, every rule's ends and their
    neighbours, negatives and codepoints past the dense table."""
    ends = np.concatenate([rules.lo, rules.hi, rules.lo - 1, rules.hi + 1])
    return np.concatenate([
        rng.integers(0, 0x600, count), rng.integers(0, 0x110000, count // 4), ends,
        [-5, -1, 0, int(rules.hi.max()) + 1, int(rules.hi.max()) + 2, 0x10FFFF, 0x110000, 0x7FFFFFF],
    ]).astype(np.int32)


@pytest.mark.parametrize("name", ["simple", "e12", "e3", "simple-0x4ff", "e12-0x4ff"])
def test_range_map_equals_jax_kernel_and_xla(name, rng):
    """Base 0 (simple fold) and base 1 (value maps), whole and pruned: the
    port's rule walk, and the dense table the CUDA kernel reads, equal the
    JAX Pallas route (rule walk or lane LUT, in interpret mode) and its
    XLA route."""
    jrules = _fold_rule_sets()[name]
    rules = _port_rules(jrules)
    cps = _range_cps(rng, rules)
    got = R.range_map(torch.from_numpy(cps), rules)
    assert got.dtype == torch.int32
    want_xla = np.asarray(JR.range_map(jnp.asarray(cps), jrules))
    np.testing.assert_array_equal(got.numpy(), want_xla)
    some = np.concatenate([cps[:1024], cps[-(4 * rules.count + 8):]])  # the rule ends and the values past the table
    want_kernel = np.asarray(JR.range_map(jnp.asarray(some), jrules, interpret=True))
    np.testing.assert_array_equal(R.range_map(torch.from_numpy(some), rules).numpy(), want_kernel)
    # The kernel's form: (cp if base == 0) + dense[clamp(cp)], wrapping.
    dense = torch.from_numpy(R.dense_delta_table(rules))
    table_form = L.class_map_plain(torch.from_numpy(cps), dense) + (torch.from_numpy(cps) if rules.base == 0 else 0)
    np.testing.assert_array_equal(table_form.to(torch.int32).numpy(), got.numpy())


def test_range_map_fully_pruned_and_shapes():
    jrules = _fold_rule_sets()["e3"]
    rules = _port_rules(jrules).prune(0x7F)  # e3 has no key below 0x390
    assert rules.count == 0 and jrules.prune(0x7F).count == 0
    cps = np.arange(-3, 300, dtype=np.int32).reshape(3, 101)
    for base in (0, 1):
        pruned = R.FoldRules.from_numpy(rules.lo, rules.hi, rules.delta, rules.pmask, rules.par, base)
        jpruned = JR.FoldRules(jrules.lo[:0], jrules.hi[:0], jrules.delta[:0], jrules.pmask[:0], jrules.par[:0], base)
        got = R.range_map(torch.from_numpy(cps), pruned)
        assert tuple(got.shape) == (3, 101)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JR.range_map(jnp.asarray(cps), jpruned, interpret=True)))
    with pytest.raises(ValueError):
        R.dense_delta_table(rules)
    with pytest.raises(ValueError):
        L.range_map_cuda(torch.from_numpy(cps), torch.zeros(4, dtype=torch.int32), True)
