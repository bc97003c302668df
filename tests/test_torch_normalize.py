"""The port's normalization (``unicode/tables.py``'s normalization tables and
``ops/normalize.py``) on the CPU, against the JAX package on the same
numpy-seeded inputs and against ``unicodedata.normalize``. Integers: exact.

``decompose_rows`` at the ceiling 0x4FF takes the JAX package's fused Pallas
route (in interpret mode) for NFD and NFKD; at 0xACFF its NFKD takes the
unfused route, run here without jit (the same function op by op, which
spares its compile). ``test_torch_normalize_fused.py`` holds NFD at 0xACFF.
"""

import unicodedata

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stringwars_tpu.ops import normalize as JN
from stringwars_tpu.unicode import tables as JT
from stringwars_tpu_torch.ops import normalize as N
from stringwars_tpu_torch.unicode import tables as T
from _jax_unicode_cache import private_jax_unicode_cache  # noqa: F401
from _torch_threads import one_thread  # noqa: F401

FORMS = ["NFC", "NFD", "NFKC", "NFKD"]
# Codepoints that decompose, reorder, compose (Hangul too) or expand under
# NFKD, among plain letters and CJK.
POOL = np.array([
    0x41, 0x61, 0x7A, 0x20, 0xE9, 0xC5, 0xBD, 0x1C4, 0x1C5, 0x390, 0x3B1, 0x3D3, 0x301, 0x316, 0x308, 0x323, 0x345,
    0x344, 0x4E9, 0x1E0B, 0x1E69, 0x1F82, 0x2126, 0x212B, 0x2460, 0x2167, 0x321D, 0x3300, 0x4E00, 0x0F73, 0x0F71,
    0x1100, 0x1161, 0x11A8, 0xAC00, 0xAC01, 0xACFF,
], np.int32)
SHORT = [
    "café résumé naïve", "café résumé", "á̧", "á̧", "ḍ̇", "한국어", "한", "ﬁﬂ ﬀ", "①②③ ½", "Ω Å",
    "q̣̇", "ཷ", "ﷺ", "ṩ", "ཱཱིི̈́", "ǅ ΐ ẛ̣",
]


@pytest.mark.parametrize("name", ["nfd", "nfkd", "ccc", "pairs", "nfc_fast", "nfkc_fast"])
def test_tables_equal_jax(name):
    got, want = {
        "nfd": (T.decomposition_tables(False), JT.decomposition_tables(False)),
        "nfkd": (T.decomposition_tables(True), JT.decomposition_tables(True)),
        "ccc": ((T.ccc_table(),), (JT.ccc_table(),)),
        "pairs": (T.composition_pairs(), JT.composition_pairs()),
        "nfc_fast": ((T.nfc_fast_table(False),), (JT.nfc_fast_table(False),)),
        "nfkc_fast": ((T.nfc_fast_table(True),), (JT.nfc_fast_table(True),)),
    }[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_module_tables_equal_jax():
    for compat in (False, True):
        np.testing.assert_array_equal(N._inert_np(compat), JN._inert_np(compat))
        for max_cp in (None, 0x4FF, 0xACFF):
            for mine, theirs in ((N._inert_steps, JN._inert_steps), (N._nfc_fast_steps, JN._nfc_fast_steps)):
                (rules, table), (j_rules, j_table) = mine(compat, max_cp), theirs(compat, max_cp)
                np.testing.assert_array_equal(rules.starts, j_rules.starts)
                np.testing.assert_array_equal(rules.deltas, j_rules.deltas)
                np.testing.assert_array_equal(table, j_table)
    for g, w in zip(N._pair_tables(), JN._pair_tables()):
        np.testing.assert_array_equal(g, w)


def _byte_rows(texts):
    rows = [t.encode() for t in texts]
    width = -(-max(len(r) for r in rows) // 4) * 4
    buf = np.zeros((len(rows), width), np.uint8)
    lengths = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r, np.uint8)
    return buf, lengths


@pytest.mark.parametrize("compat", [False, True])
def test_quick_checks_equal_jax(compat):
    texts = ["plain ascii text", "schon längst übliche Wörter", "Привет мир", "étude", "Å test", "가힣",
             "ﬁ ligature", "①", "ä", "가", "xཱི", ""]
    buf, lengths = _byte_rows(texts)
    max_cp = max(ord(c) for t in texts for c in t)
    for ceiling in (None, max_cp):
        got = N.rows_inert(torch.from_numpy(buf), torch.from_numpy(lengths), compat, ceiling).numpy()
        np.testing.assert_array_equal(got, np.asarray(JN.rows_inert(jnp.asarray(buf), jnp.asarray(lengths), compat, ceiling)))
        got = N.rows_nfc_verbatim(torch.from_numpy(buf), torch.from_numpy(lengths), compat, ceiling).numpy()
        want = np.asarray(JN.rows_nfc_verbatim(jnp.asarray(buf), jnp.asarray(lengths), compat, ceiling))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(N.rows_inert_host(buf, lengths, compat), JN.rows_inert_host(buf, lengths, compat))
    np.testing.assert_array_equal(N.rows_nfc_verbatim_host(buf, lengths, compat),
                                  JN.rows_nfc_verbatim_host(buf, lengths, compat))


def _rows(seed: int, max_cp: int, width: int, count: int = 6):
    rng = np.random.default_rng(seed)
    pool = POOL[POOL <= max_cp]
    rows = rng.choice(pool, (count, width)).astype(np.int32)
    lengths = rng.integers(0, width + 1, count).astype(np.int32)
    lengths[0] = width
    rows[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return rows, lengths


def _jax_decompose_rows(rows, lengths, compat, max_cp):
    out, counts = JN.decompose_rows(jnp.asarray(rows), jnp.asarray(lengths), compat, max_cp=max_cp)
    return np.asarray(out), np.asarray(counts)


@pytest.mark.parametrize("compat", [False, True], ids=["nfd", "nfkd"])
@pytest.mark.parametrize("width", [32, 64])
def test_decompose_rows_at_0x4ff_equal_jax(compat, width):
    """Both forms take the fused route below 0x4FF, in JAX and here."""
    rows, lengths = _rows(width + compat, 0x4FF, width)
    assert N.decompose_route(compat, 0x4FF, width) == "expand"
    got, got_counts = N.decompose_rows(torch.from_numpy(rows), torch.from_numpy(lengths), compat, 0x4FF)
    want, want_counts = _jax_decompose_rows(rows, lengths, compat, 0x4FF)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)


@pytest.mark.parametrize("width", [32, 64])
def test_nfkd_rows_at_0xacff_equal_jax(width):
    """NFKD at the multilingual corpus' ceiling expands to 7: the decompose
    kernel's route here, range maps and a sort a row in JAX."""
    rows, lengths = _rows(width, 0xACFF, width)
    assert N.decompose_route(True, 0xACFF, width) == "decompose"
    assert N.decomp_tables(True, 0xACFF).max_exp == 7
    got, got_counts = N.decompose_rows(torch.from_numpy(rows), torch.from_numpy(lengths), True, 0xACFF)
    with jax.disable_jit():
        want, want_counts = _jax_decompose_rows(rows, lengths, True, 0xACFF)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)


@pytest.mark.parametrize("compat", [False, True])
def test_flat_decompose_equals_jax(compat):
    cps = np.array([ord(c) for c in "".join(SHORT)], np.int32)
    got, count = N.decompose(torch.from_numpy(cps), cps.size, compat)
    want, want_count = JN.decompose(jnp.asarray(cps), cps.size, compat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(count) == int(want_count)


@pytest.mark.parametrize("form", FORMS)
def test_normalize_equals_jax(form):
    text = " ".join(SHORT)
    cps = np.array([ord(c) for c in text], np.int32)
    got = N.normalize(cps, form, device="cpu")
    np.testing.assert_array_equal(got, JN.normalize(cps, form))
    assert "".join(map(chr, got.tolist())) == unicodedata.normalize(form, text)
    assert N.normalize_text(text, form, device="cpu") == unicodedata.normalize(form, text)


@pytest.fixture(scope="module")
def block_samples():
    """Up to 8 assigned codepoints of every 128-codepoint block below
    0x30000 (a stand-in for the UCD's blocks), drawn with a fixed seed."""
    rng = np.random.default_rng(2026)
    samples = []
    for base in range(0, 0x30000, 128):
        assigned = [cp for cp in range(base, base + 128)
                    if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(chr(cp)) != "Cn"]
        if assigned:
            samples += rng.choice(assigned, min(8, len(assigned)), replace=False).tolist()
    return np.array(samples, np.int32)


@pytest.mark.parametrize("form", FORMS)
def test_fuzz_every_block_equals_unicodedata(block_samples, form):
    """Seeded streams over every block's samples, with runs of marks."""
    rng = np.random.default_rng(FORMS.index(form))
    marks = np.array([0x300, 0x301, 0x308, 0x316, 0x323, 0x327, 0x345, 0x0F71, 0x0F72, 0x05B0, 0x1161, 0x11A8], np.int32)
    stream = np.where(rng.random(20_000) < 0.25, rng.choice(marks, 20_000), rng.choice(block_samples, 20_000))
    text = "".join(map(chr, stream.tolist()))
    assert N.normalize_text(text, form, device="cpu") == unicodedata.normalize(form, text)


@pytest.mark.parametrize("compat", [False, True], ids=["canonical", "compat"])
def test_safe_cut_keeps_every_form(compat):
    """For every codepoint at most 0xFFFF that the rule calls safe, cutting
    before it changes no form of its own (NFD/NFC, or NFKD/NFKC), whatever
    comes before and after it: ``normalize(before + c + after)`` equals
    ``normalize(before) + normalize(c + after)``. Checked a context at a time
    over all such codepoints at once, one per line."""
    safe = N.safe_table(compat)
    befores = ["a", "a̖", "é", "ᄀ", "가", "ཱ", "ơ", "େ", "Å"]
    afters = ["", "́", "̖", "̣̈", "ᅡ", "ᆨ", "ི", "ା", "゙"]
    chars = [chr(cp) for cp in range(0x10000) if safe[cp] and not 0xD800 <= cp <= 0xDFFF]
    assert len(chars) > 60_000
    for form in ("NFKD", "NFKC") if compat else ("NFD", "NFC"):
        for after in afters:
            tails = [unicodedata.normalize(form, c + after) for c in chars]
            for before in befores:
                head = unicodedata.normalize(form, before)
                whole = "\n".join(before + c + after for c in chars)
                if unicodedata.normalize(form, whole) != "\n".join(head + t for t in tails):
                    bad = [c for c, t in zip(chars, tails) if unicodedata.normalize(form, before + c + after) != head + t]
                    raise AssertionError(f"{form}: a cut before {[hex(ord(c)) for c in bad[:8]]} after {before!r} "
                                         f"changes the form")


def test_safe_table_spot_checks():
    safe = N.safe_table(False)
    assert safe[ord("a")] and safe[0xAC00] and safe[0x1100] and safe[0x4E00]
    assert not safe[0x301] and not safe[0x1161] and not safe[0x11A8]  # a mark, V and T jamo
    assert not safe[0x0F73]  # ccc 0, but its decomposition starts with U+0F71 (ccc 129)
    assert not safe[0x0B3E]  # ccc 0, composes with U+0B47


def _walk(allowed: np.ndarray, width: int, fallback=None) -> list[int]:
    starts, n = [0], allowed.size
    while starts[-1] + width < n:
        s = starts[-1]
        e = s + width
        cut = next((p for p in range(e, s, -1) if allowed[p]), None)
        if cut is None and fallback is not None:
            cut = next((p for p in range(e, s, -1) if fallback[p]), None)
        starts.append(cut if cut is not None else e)
    return starts


@pytest.mark.parametrize("width", [1, 5, 64])
def test_row_starts_equal_the_greedy_walk(width):
    rng = np.random.default_rng(width)
    for density in (0.0, 0.02, 0.3, 1.0):
        allowed = rng.random(64 * width * 3 + 37) < density
        fallback = allowed | (rng.random(allowed.size) < 0.5)
        for fb in (None, fallback):
            got = N.row_starts(torch.from_numpy(allowed), width, None if fb is None else torch.from_numpy(fb))
            assert got.tolist() == _walk(allowed, width, fb)


def test_segment_rows_cut_before_safe_codepoints():
    rng = np.random.default_rng(4)
    text = "".join(rng.choice(list("aé가ﬃ") + ["́", "̖", "ᅡ"], 5000)) + "x" + "́" * 300 + "y"
    cps = torch.tensor([ord(c) for c in text], dtype=torch.int32)
    buckets = N.segment_rows(cps, False)
    assert [b.width for b in buckets] == [64, 320]
    safe = N.safe_table(False)
    firsts = torch.cat([b.first for b in buckets]).sort().values
    lengths = torch.cat([b.lengths for b in buckets])[torch.cat([b.first for b in buckets]).argsort()]
    assert firsts[0] == 0 and int(lengths.sum()) == cps.numel()
    assert torch.equal(firsts[1:], torch.cumsum(lengths, 0)[:-1])
    assert all(safe[int(cps[f])] for f in firsts[1:].tolist())
    assert int(buckets[0].lengths.max()) <= 64 and int(buckets[1].lengths.min()) > 64
    for b in buckets:
        for row, length, first in zip(b.rows, b.lengths, b.first):
            assert torch.equal(row[:length], cps[first : first + length]) and not row[length:].any()


@pytest.mark.parametrize("compat", [False, True], ids=["nfd", "nfkd"])
def test_reorder_across_passes_equals_jax(compat):
    """The chip check's reordering texts (``chip_smoke.reorder_texts``): runs
    of marks out of order across positions 31|32 and 63|64 of a decomposed
    row, a run of 70 marks (a row of the wide bucket) and a seeded marks
    stream. The plain reordering of the decomposed rows equals the JAX
    ``_canonical_reorder_rows`` on the same rows (run without jit), and the
    rows assembled equal ``unicodedata``."""
    from chip_smoke import reorder_texts

    form = "NFKD" if compat else "NFD"
    late_at = []
    for text in reorder_texts():
        cps = torch.tensor([ord(c) for c in text], dtype=torch.int32)
        max_cp = int(cps.max())
        ccc_rules = JN._decomp_rules(compat, max_cp)[4]
        buckets = N.segment_rows(cps, compat)
        outputs = []
        for b in buckets:
            out, counts = N.decompose_rows_plain(b.rows, b.lengths, N.decomp_tables(compat, max_cp))
            c = N._ccc_on(out.device)[out.to(torch.int64)].to(torch.int32)
            late = (c[:, 1:] > 0) & (c[:, :-1] > c[:, 1:])
            late_at.append(set((torch.nonzero(late)[:, 1] + 1).tolist()))
            with jax.disable_jit():
                want = np.asarray(JN._canonical_reorder_rows(jnp.asarray(out.numpy()), ccc_rules))
            got = N.reorder_rows_plain_(out.clone(), counts)
            np.testing.assert_array_equal(got.numpy(), want)
            outputs.append((got, counts))
        values, keys = N.gather_outputs(buckets, outputs)
        assert "".join(map(chr, values[torch.sort(keys, stable=True).indices].tolist())) == unicodedata.normalize(form, text)
    assert 32 in late_at[0] and 64 in late_at[1] and max(late_at[2]) > 64


def test_cuda_wrappers_need_a_card_tensor():
    rows = torch.zeros((2, 64), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: N.decompose_rows_cuda(rows, counts, N.decomp_tables(False, 0xFF)),
                 lambda: N.reorder_rows_cuda_(rows, counts), lambda: N.compose_rows_cuda_(rows, counts)):
        with pytest.raises(ValueError):
            call()
