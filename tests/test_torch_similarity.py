"""The port's anti-diagonal wavefronts against the JAX package, on the CPU.

The same pairs, made from a numpy seed, go through the JAX functions of
``stringwars_tpu.ops.similarity`` and the port's, by way of
``PairBatch.from_numpy``; distances and scores are integers, so every
comparison is exact. The brute-force oracles close the loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import similarity as JS
from stringwars_tpu_torch.ops import similarity as S
from _torch_threads import one_thread  # noqa: F401


SCORES = ["levenshtein", "nw_score_linear", "sw_score_linear", "nw_score_affine", "sw_score_affine"]


def _random_pairs(seed: int, B: int, L: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi, (B, L)).astype(np.int32)
    b = rng.integers(lo, hi, (B, L)).astype(np.int32)
    a_len = rng.integers(0, L + 1, B).astype(np.int32)
    b_len = rng.integers(0, L + 1, B).astype(np.int32)
    a_len[:4] = [0, 0, L, 1]
    b_len[:4] = [0, L, 0, 1]
    for arr, n in ((a, a_len), (b, b_len)):
        arr[np.arange(L)[None, :] >= n[:, None]] = 0
    return a, b, a_len, b_len


@pytest.fixture(scope="module")
def pairs():
    arrays = _random_pairs(11, 48, 24, 65, 69)
    return arrays, JS.PairBatch(*map(jnp.asarray, arrays)), S.PairBatch.from_numpy(*arrays)


def _oracle(name, x, y):
    if name == "levenshtein":
        return S.levenshtein_ref(x, y)
    go, ge = (-2, -2) if "linear" in name else (-5, -1)
    ref = S.sw_ref if name.startswith("sw") else S.nw_ref
    return ref(x, y, 2, -1, go, ge)


@pytest.mark.parametrize("name", SCORES)
def test_wavefront_matches_jax_and_oracle(pairs, name):
    (a, b, a_len, b_len), ref, port = pairs
    got = getattr(S, name)(port)
    assert got.dtype == torch.int32 and got.shape == (a.shape[0],)
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(JS, name)(ref)))
    want = [_oracle(name, a[i, : a_len[i]].tolist(), b[i, : b_len[i]].tolist()) for i in range(a.shape[0])]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("local", [False, True])
def test_custom_scores_match_jax(local):
    arrays = _random_pairs(5, 32, 17, 0, 6)
    ref, port = JS.PairBatch(*map(jnp.asarray, arrays)), S.PairBatch.from_numpy(*arrays)
    got = S._score_scan(port, 3, -2, -4, -2, local=local).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS._score_scan(ref, 3, -2, -4, -2, local=local)))


@pytest.mark.parametrize("band", [2, 8])
def test_banded_matches_jax(pairs, band):
    _, ref, port = pairs
    got = S.levenshtein_banded(port, band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS.levenshtein_banded(ref, band)))


def test_wide_band_is_the_full_distance(pairs):
    """A band as wide as the pairs is the full distance."""
    _, _, port = pairs
    np.testing.assert_array_equal(S.levenshtein_banded(port, port.width).numpy(), S.levenshtein(port).numpy())


def _same_batch(port: S.PairBatch, ref: JS.PairBatch):
    for field in ("a", "b", "a_len", "b_len"):
        got, want = getattr(port, field), np.asarray(getattr(ref, field))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert port.width == ref.width and port.dp_cells() == ref.dp_cells()


@pytest.mark.parametrize("width", [None, 40])
def test_pack_pairs_matches_jax(width):
    rng = np.random.default_rng(2)
    a_tok = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (0, 1, 9, 30, 33)]
    b_tok = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (5, 0, 31, 2, 17)]
    _same_batch(S.pack_pairs(a_tok, b_tok, width), JS.pack_pairs(a_tok, b_tok, width))
    with pytest.raises(ValueError):
        S.pack_pairs(a_tok, b_tok[:2])


def test_pack_pairs_utf8_matches_jax():
    a_tok = ["héllo".encode(), "\U00010400a".encode(), "\U0001F600\U0001F601".encode(), b"", "日本語".encode()]
    b_tok = ["hallo".encode(), "\U00010400b".encode(), "\U0001F600".encode(), "x".encode(), "日本".encode()]
    port = S.pack_pairs_utf8(a_tok, b_tok)
    _same_batch(port, JS.pack_pairs_utf8(a_tok, b_tok))
    assert S.decode_codepoints("\U0001F600é".encode()).tolist() == [0x1F600, 0xE9]
    np.testing.assert_array_equal(S.levenshtein(port).numpy(), [1, 1, 1, 1, 1])


def test_from_numpy_takes_jax_state_and_checks_shapes(pairs):
    (a, b, a_len, b_len), ref, _ = pairs
    got = S.PairBatch.from_numpy(np.asarray(ref.a), np.asarray(ref.b), np.asarray(ref.a_len), np.asarray(ref.b_len))
    _same_batch(got, ref)
    assert got.device == torch.device("cpu")
    with pytest.raises(ValueError):
        S.PairBatch.from_numpy(a, b[:, :5], a_len, b_len)


def test_oracles_match_jax_oracles():
    rng = np.random.default_rng(9)
    for _ in range(20):
        x = rng.integers(0, 4, int(rng.integers(0, 12))).tolist()
        y = rng.integers(0, 4, int(rng.integers(0, 12))).tolist()
        assert S.levenshtein_ref(x, y) == JS.levenshtein_ref(x, y)
        for go, ge in ((-2, -2), (-5, -1)):
            assert S.nw_ref(x, y, 2, -1, go, ge) == JS.nw_ref(x, y, 2, -1, go, ge)
            assert S.sw_ref(x, y, 2, -1, go, ge) == JS.sw_ref(x, y, 2, -1, go, ge)
