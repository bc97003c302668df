"""The port's case folding (``ops/casefold.py``, ``unicode/tables.casefold_tables``)
against the JAX package and ``str.casefold``.

Every output is an integer, a string or a boolean: equality is exact. The
JAX side runs its XLA functions as its own tests run them on the CPU; the
port's ``range_map`` takes its plain rule walk on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import casefold as JC
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu.unicode import tables as JT
from stringwars_tpu_torch.ops import casefold as C
from stringwars_tpu_torch.ops import rulemap as R
from stringwars_tpu_torch.tape import PaddedTokens
from stringwars_tpu_torch.unicode import tables as T
from _torch_threads import one_thread  # noqa: F401


# The JAX package's own samples (tests/test_casefold.py) and a few with
# 3-codepoint folds, final sigma, titlecase digraphs and astral letters.
SAMPLES = [
    "Hello World",
    "STRASSE straße ẞ",
    "İstanbul ı I i",
    "ΣΊΣΥΦΟΣ σίσυφος",
    "ПРИВЕТ привет",
    "ﬁre ﬂow ﬃ",
    "한국어 普通话",
    "emoji 🎉 stays",
    "ΐ ΰ ᾳ ǅ Ǆ ǆ Ⅻ ﬆ",
    "𐐀𐐨 \U0001E900 \U00010C80",
]
RULE_FIELDS = ("lo", "hi", "delta", "pmask", "par")


def _jax_tokens(tokens: PaddedTokens) -> JaxPaddedTokens:
    return JaxPaddedTokens(data=jnp.asarray(tokens.data.numpy()), lengths=jnp.asarray(tokens.lengths.numpy()),
                           width=tokens.width)


def _rows(rng, alphabet: str, count: int, width: int) -> PaddedTokens:
    """``count`` random strings over ``alphabet`` of at most ``width`` bytes."""
    data = np.zeros((count, width), np.uint8)
    lengths = np.zeros(count, np.int32)
    chars = list(alphabet)
    for i in range(count):
        raw = b""
        for c in rng.choice(chars, int(rng.integers(0, width + 1))):
            if len(raw) + len(c.encode()) > width:
                break
            raw += c.encode()
        data[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lengths[i] = len(raw)
    return PaddedTokens.from_numpy(data, lengths)


def test_casefold_tables_equal_jax():
    got, want = T.casefold_tables(), JT.casefold_tables()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].dtype == np.int32 and got[2].dtype == np.int32
    assert T.UNIDATA_VERSION == __import__("unicodedata").unidata_version


@pytest.mark.parametrize("max_cp", [None, 0xFF, 0x4FF, 0xFFFF])
def test_fold_rules_equal_jax(max_cp):
    got, want = C._fold_rules(max_cp), JC._fold_rules(max_cp)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.base == w.base
        for field in RULE_FIELDS:
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert getattr(g, field).dtype == np.int32


def test_packed_expansions_unpack_for_every_pool_codepoint():
    """``e1 | e2 << 16`` narrowed to int32 unpacks to the expansion pair for
    every key of the full table (no pool codepoint reaches 0x8000)."""
    inline, multi, pool = C._fold_arrays()
    _, mlen, e12, e3, _ = C._fold_rules(None)
    keys = np.flatnonzero(inline < 0)
    cps = torch.from_numpy(keys.astype(np.int32))
    packed = R.range_map_plain(cps, e12).numpy()
    lengths = R.range_map_plain(cps, mlen).numpy()
    off = multi[keys] >> 5
    np.testing.assert_array_equal(lengths, multi[keys] & 31)
    np.testing.assert_array_equal(packed & 0xFFFF, pool[off])
    np.testing.assert_array_equal(packed >> 16, np.where(lengths >= 2, pool[np.minimum(off + 1, pool.size - 1)], 0))
    third = R.range_map_plain(cps, e3).numpy()
    np.testing.assert_array_equal(third, np.where(lengths >= 3, pool[np.minimum(off + 2, pool.size - 1)], 0))


@pytest.mark.parametrize("text", SAMPLES)
def test_fold_text_equals_python_and_jax(text):
    assert C.fold_text(text) == text.casefold() == JC.fold_text(text)


def test_fold_bytes_equals_jax_on_fuzz_and_invalid_bytes(rng):
    cps = rng.integers(1, 0x2FFF, 1500)
    text = "".join(chr(c) for c in cps if not 0xD800 <= c <= 0xDFFF)
    assert C.fold_text(text) == text.casefold()
    raw = text.encode()[:700] + bytes(rng.integers(0, 256, 300, dtype=np.uint8)) + bytes([0xF4, 0x90, 0x80, 0x80, 0xFF])
    for data in (np.frombuffer(text.encode(), np.uint8), np.frombuffer(raw, np.uint8)):
        want, want_count = JC.fold_bytes(data)
        got, got_count = C.fold_bytes(data)
        assert int(got_count) == int(want_count)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uncased_equal_and_count_equal_jax():
    pairs = [("Straße", "STRASSE"), ("Hello", "hELLO"), ("Hello", "World"), ("ΣΊΣΥΦΟΣ", "σίσυφοσ"), ("ΐ", "ΐ"), ("", "")]
    for a, b in pairs:
        assert C.uncased_equal(a.encode(), b.encode()) == JC.uncased_equal(a.encode(), b.encode())
    hay = "Die Straße heißt STRASSE, die strasse! ssss ΐΐ".encode()
    got_fold = C.fold_bytes(np.frombuffer(hay, np.uint8))
    want_fold = JC.fold_bytes(np.frombuffer(hay, np.uint8))
    for needle in ("strasse", "SS", "s", "ΐ", "Die", "nowhere", "ß"):
        assert C.uncased_count(got_fold, needle.encode()) == JC.uncased_count(want_fold, needle.encode())


@pytest.mark.parametrize(
    "max_cp,width,alphabet",
    [
        (None, 32, "aAbBßẞΣσςΐΰﬃİıǅǄ Ⅻ𐐀\U0001E900xyzÉÀ日本한Ωω"),  # astral codepoints, unpruned rules
        (0xFF, 32, "aAbB ßxyzÉÀÿ"),
        (0xFFFF, 40, "aAßẞΣσςΐΰﬃİǅ Ⅻ日本한ω"),
    ],
)
def test_fold_tokens_equals_jax(max_cp, width, alphabet, rng):
    tokens = _rows(rng, alphabet, 160, width)
    want, want_counts = JC.fold_tokens(_jax_tokens(tokens), max_cp=max_cp)
    got, got_counts = C.fold_tokens(tokens, max_cp=max_cp)
    assert got.dtype == torch.int32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    # Each row is the row's text folded by Python.
    for i in range(tokens.count):
        text = tokens.data[i, : int(tokens.lengths[i])].numpy().tobytes().decode()
        assert "".join(map(chr, got[i, : int(got_counts[i])].tolist())) == text.casefold()


def test_uncased_equal_batch_equals_jax(rng):
    a = _rows(rng, "aAbBßsSΣσςΐ", 200, 24)
    b_data = a.data.clone()
    swap = torch.from_numpy(rng.random(a.data.shape) < 0.3)
    upper = (b_data >= 97) & (b_data <= 122) & swap
    b_data[upper] -= 32  # flip the case of some ASCII letters: still equal
    b_data[:40, 0] = 120  # and change a few rows outright
    b = PaddedTokens(b_data, a.lengths.clone(), a.width)
    wide = _rows(rng, "aAbBßsS", 200, 36)  # pairs of different widths
    for x, y in ((a, b), (a, wide)):
        want = np.asarray(JC.uncased_equal_batch(_jax_tokens(x), _jax_tokens(y)))
        got = C.uncased_equal_batch(x, y)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(C.uncased_equal_batch(a, b).sum()) < a.count


def test_fold_tokens_ascii_and_auto_equal_jax(rng):
    ascii_rows = _rows(rng, "aZbY09 ,.Q", 64, 16)
    want, want_counts = JC.fold_tokens_ascii(_jax_tokens(ascii_rows))
    got, got_counts = C.fold_tokens_ascii(ascii_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert C.fold_tokens_auto(ascii_rows)[2] is True
    mixed = _rows(rng, "aZß", 64, 16)
    folded, counts, is_ascii = C.fold_tokens_auto(mixed, mixed.data.numpy())
    assert is_ascii is False
    want, want_counts = JC.fold_tokens(_jax_tokens(mixed))
    np.testing.assert_array_equal(folded.numpy(), np.asarray(want))
