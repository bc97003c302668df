"""Canonical composition at its edges on the CPU: the port's
``compose_rows_plain_`` (the composition kernel's plain version) and
``normalize_rows(..., "NFC" / "NFKC")`` against the JAX package's
composition (``_compose_scan`` with ``_nfc_padded``'s compaction, and
``normalize``) and ``unicodedata.normalize``, on texts where segments
interact: Hangul L V T chains, each class-0 second element of a primary
composite after its first element, chains through composites, blocking by
marks, rows that begin with a mark and rows full to their width. The same
texts are in ``chip_smoke.compose_texts``, which holds the kernel to the
plain version on the card.
"""

import unicodedata

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import compose_texts
from stringwars_tpu.ops import normalize as JN
from stringwars_tpu_torch.ops import normalize as N
from _jax_unicode_cache import private_jax_unicode_cache  # noqa: F401
from _torch_threads import one_thread  # noqa: F401

WIDTH = 512  # the JAX composition runs on each row padded to this many codepoints

# The class-0 second elements of primary composites besides the Hangul V
# and T jamo (Unicode 15).
COMBINERS = [0x09BE, 0x09D7, 0x0B3E, 0x0B56, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E, 0x0D57, 0x0DCF,
             0x0DDF, 0x102E, 0x1B35, 0x11127, 0x1133E, 0x11357, 0x114B0, 0x114BA, 0x114BD, 0x115AF, 0x11930]


@pytest.fixture(scope="module")
def jax_compose():
    """The JAX package's composition of one reordered row (zeros past its
    count, which compose with nothing): its kept codepoints, in order."""
    scan = jax.jit(JN._compose_scan)

    def compose(row: np.ndarray, count: int) -> np.ndarray:
        padded = np.zeros(WIDTH, np.int32)
        padded[:count] = row[:count]
        vals = np.asarray(scan(jnp.asarray(padded)))[:count]
        return vals[vals >= 0]

    return compose


def _rows_of(text: str, compat: bool):
    cps = torch.tensor([ord(c) for c in text], dtype=torch.int32)
    return cps, N.segment_rows(cps, compat)


@pytest.mark.parametrize("form", ["NFC", "NFKC"])
def test_compose_rows_equal_jax_and_unicodedata(form, jax_compose):
    """Each text's rows, decomposed and reordered, composed by the plain
    version: every row equals the JAX composition of the same row, and the
    rows assembled equal ``unicodedata``."""
    compat = form == "NFKC"
    for name, text in compose_texts().items():
        cps, buckets = _rows_of(text, compat)
        outputs = []
        for b in buckets:
            out, counts = N.decompose_rows(b.rows, b.lengths, compat, int(cps.max()))
            assert int(counts.max()) <= WIDTH
            composed = out.clone()
            kept = N.compose_rows_plain_(composed, counts)
            for r in range(out.shape[0]):
                want = jax_compose(out[r].numpy(), int(counts[r]))
                np.testing.assert_array_equal(composed[r, : int(kept[r])].numpy(), want, err_msg=f"{name}, row {r}")
                assert not composed[r, int(kept[r]) : int(counts[r])].any()
            outputs.append((composed, kept))
        values, keys = N.gather_outputs(buckets, outputs)
        got = "".join(map(chr, values[torch.sort(keys, stable=True).indices].tolist()))
        assert got == unicodedata.normalize(form, text), name


@pytest.mark.parametrize("form", ["NFC", "NFKC"])
def test_normalize_rows_equal_jax(form):
    """``normalize_rows`` over every text's rows, assembled, equals the JAX
    package's ``normalize`` of the whole text and ``unicodedata``."""
    texts = compose_texts()
    joined = "".join(texts.values())
    cps, buckets = _rows_of(joined, form == "NFKC")
    outputs = [N.normalize_rows(b.rows, b.lengths, form, int(cps.max())) for b in buckets]
    values, keys = N.gather_outputs(buckets, outputs)
    got = values[torch.sort(keys, stable=True).indices].numpy()
    np.testing.assert_array_equal(got, JN.normalize(cps.numpy(), form))
    assert "".join(map(chr, got.tolist())) == unicodedata.normalize(form, joined)


def test_rows_full_to_their_width(jax_compose):
    """Rows whose count is their width (no zero after the last codepoint):
    chains of L V T, of U+0CC6 U+0CC2 U+0CD5 and marks, cut at the width."""
    rng = np.random.default_rng(29)
    pool = [0x1100, 0x1161, 0x11A8, 0x0CC6, 0x0CC2, 0x0CD5, 0x61, 0x301, 0x334, 0x316, 0x0DD9, 0x0DCF, 0x0DCA]
    for width in (64, 256, 130):
        rows = torch.from_numpy(rng.choice(pool, size=(6, width)).astype(np.int32))
        rows = N.reorder_rows_plain_(rows, torch.full((6,), width, dtype=torch.int32))
        composed = rows.clone()
        kept = N.compose_rows_plain_(composed, torch.full((6,), width, dtype=torch.int32))
        for r in range(6):
            np.testing.assert_array_equal(composed[r, : int(kept[r])].numpy(), jax_compose(rows[r].numpy(), width))
            assert not composed[r, int(kept[r]) :].any()


def test_compose_classes_mark_the_class_zero_second_elements():
    """The kernel's class table: the ccc table with the Hangul V and T jamo
    and the 24 others marked, nothing else changed."""
    classes = N.compose_classes()
    ccc = N._ccc_np()
    marked = np.flatnonzero(classes == N.COMBINER)
    want = sorted(set(range(0x1161, 0x1176)) | set(range(0x11A8, 0x11C3)) | set(COMBINERS))
    assert marked.tolist() == want
    rest = np.ones(classes.size, bool)
    rest[marked] = False
    np.testing.assert_array_equal(classes[rest], ccc[rest])
    assert (ccc[marked] == 0).all()


def test_texts_cover_the_edges():
    texts = compose_texts()
    joined = "".join(texts.values())
    assert all(chr(c) in joined for c in COMBINERS)
    assert "ೋ" in unicodedata.normalize("NFD", joined)
    assert any(unicodedata.combining(t[0]) for t in texts.values())  # a row that begins with a mark
