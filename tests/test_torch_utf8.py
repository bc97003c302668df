"""The port's UTF-8 machinery (torch ops) against the JAX package's, on the
samples of ``tests/test_utf8.py`` and on fuzzed byte soup."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import utf8 as J
from stringwars_tpu_torch.ops import utf8 as P
from _torch_threads import one_thread  # noqa: F401


SAMPLES = [
    b"",
    b"plain ascii",
    "héllo wörld".encode(),
    "普通话 한국어 عربى".encode(),
    "🎉🎊 emoji \U0010ffff".encode(),
    "mixed ß ẞ ́ combining".encode(),
]

INVALID = [
    b"\x80", b"\xc3", b"\xe2\x82", b"\xf0\x9f\x8e", b"\xc0\xaf", b"\xc1\xbf", b"\xe0\x80\xaf",
    b"\xed\xa0\x80", b"\xf4\x90\x80\x80", b"\xf8\x88\x80\x80\x80", b"ok\x80stray", b"\xe2\x41\xac",
]


def _pair(data: bytes):
    arr = np.frombuffer(data + b"\x00" * 8, np.uint8)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _check(data: bytes):
    """Every function of the port equals the JAX one on ``data``."""
    n = len(data)
    j, t = _pair(data)
    assert int(P.utf8_count(t, n)) == int(J.utf8_count(j, n))
    assert bool(P.utf8_validate(t, n)) == bool(J.utf8_validate(j, n))
    got_cp, got_count = P.utf8_decode(t, n)
    want_cp, want_count = J.utf8_decode(j, n)
    assert int(got_count) == int(want_count) and got_cp.dtype == torch.int32
    count = int(want_count)
    np.testing.assert_array_equal(got_cp.numpy(), np.asarray(want_cp))  # invalid input too
    np.testing.assert_array_equal(
        P._codepoints_at(t[:n].to(torch.int32), n).numpy(), np.asarray(J._codepoints_at(j[:n].astype(jnp.int32), n))
    )
    if n == 0:  # the JAX function takes the argmax of an empty stream and raises
        assert int(P.utf8_find_nth(t, 0, 0)) == 0
        return
    for k in sorted({0, 1, count // 2, max(count - 1, 0), count, count + 3}):
        assert int(P.utf8_find_nth(t, n, k)) == int(J.utf8_find_nth(j, n, k)), k


@pytest.mark.parametrize("sample", SAMPLES + INVALID)
def test_utf8_equals_jax(sample):
    _check(sample)


def test_utf8_fuzz_equals_jax():
    """Byte soup of a few lengths (each length is one JAX compile), valid
    and invalid mixed; the validator also against CPython's decoder."""
    rng = np.random.default_rng(7)
    pool = np.frombuffer("aé漢🎉z\n".encode() + bytes([0x80, 0xC3, 0xE2, 0xF0, 0xF5, 0xFF]), np.uint8)
    for n in (5, 17, 31):
        for _ in range(8):
            data = bytes(pool[rng.integers(0, pool.size, n)])
            _check(data)
            try:
                data.decode("utf-8")
                valid = True
            except UnicodeDecodeError:
                valid = False
            assert bool(P.utf8_validate(torch.frombuffer(bytearray(data), dtype=torch.uint8), n)) == valid


def test_utf8_multilingual_slice_equals_jax():
    from stringwars_tpu_torch import datasets

    data = datasets.synthesize("multilingual", 20_000)
    _check(data)
    text = data.decode()
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    cps, count = P.utf8_decode(t, len(data))
    assert int(count) == len(text) == int(P.utf8_count(t, len(data)))
    np.testing.assert_array_equal(cps.numpy()[: len(text)], [ord(c) for c in text])


def test_decode_codepoints():
    np.testing.assert_array_equal(P.decode_codepoints("aé🎉".encode()), J.decode_codepoints("aé🎉".encode()))
