"""The port's ChaCha20, Poly1305 and (X)ChaCha20-Poly1305 against the JAX
package and the ``cryptography`` library, on the CPU.

The same seeded numpy inputs go through the JAX functions, ``cryptography``
(OpenSSL) and the port's plain torch versions; every output is bytes, so
every comparison is exact. The port's host oracles (``chacha20_block_ref``,
``poly1305_ref``, ``aead_ref``), which ``chip_smoke.py`` holds the kernels
to on the card, are held to ``cryptography`` here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.poly1305 import Poly1305

from stringwars_tpu.ops import chacha as JC
from stringwars_tpu_torch.ops import chacha as C
from _torch_threads import one_thread  # noqa: F401


# Bytes: around the 16- and 64-byte blocks, and one size past a 4,096-block
# chunk of the JAX MAC (and past the port's one-launch MAC span) with a tail.
SIZES = [0, 1, 15, 16, 17, 63, 64, 65, 1000, 65536, 200_000, 4096 * 16 + 4096 + 7]

RFC_KEY = bytes(range(32))
RFC_NONCE = bytes.fromhex("000000000000004a00000000")
SUNSCREEN = (
    b"Ladies and Gentlemen of the class of '99: If I could offer you "
    b"only one tip for the future, sunscreen would be it."
)
# Poly1305's worst case: r at its largest once clamped, s = 2^128 - 1.
ADVERSARIAL_KEY = bytes([0xFF] * 32)


def _t(data: bytes) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8)


def _inputs(size: int, seed: int = 0):
    rng = np.random.default_rng(seed + size)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return key, nonce, data


def _ossl_chacha(key: bytes, nonce: bytes, data: bytes, counter: int) -> bytes:
    encryptor = Cipher(algorithms.ChaCha20(key, counter.to_bytes(4, "little") + nonce), None).encryptor()
    return encryptor.update(data)


def test_rfc8439_keystream_vector():
    got = C.chacha20_xor(RFC_KEY, RFC_NONCE, _t(SUNSCREEN), counter=1)
    assert got.numpy().tobytes().hex() == (
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
        "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
        "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
        "5af90bbf74a35be6b40b8eedf2785e42874d"
    )
    assert C.chacha20_xor_ref(RFC_KEY, RFC_NONCE, SUNSCREEN, 1) == got.numpy().tobytes()


def test_rfc8439_poly1305_vector():
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    msg = b"Cryptographic Forum Research Group"
    want = bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
    assert C.poly1305_tag(key, _t(msg)) == want
    assert C.poly1305_ref(key, msg) == want


@pytest.mark.parametrize("size", SIZES)
def test_chacha20_xor_matches_jax_and_openssl(size):
    key, nonce, data = _inputs(size)
    got = C.chacha20_xor(key, nonce, _t(data), counter=1).numpy().tobytes()
    assert got == np.asarray(JC.chacha20_xor(key, nonce, np.frombuffer(data, np.uint8), counter=1)).tobytes()
    assert got == _ossl_chacha(key, nonce, data, 1)


@pytest.mark.parametrize("counter", [0, 1, 0xFFFFFFF0])
def test_keystream_matches_jax_across_the_counter_wrap(counter):
    key, nonce, _ = _inputs(7)
    got = C.keystream_plain(key, nonce, counter, 32).numpy()
    want = np.asarray(JC._keystream(JC._key_words(key), jnp.asarray(np.frombuffer(nonce, "<u4")), jnp.uint32(counter), 32))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for b in (0, 15, 31):
        block = b"".join(int(w).to_bytes(4, "little") for w in got[b])
        assert block == C.chacha20_block_ref(key, (counter + b) & 0xFFFFFFFF, nonce)


@pytest.mark.parametrize("size", SIZES)
def test_poly1305_matches_jax_and_openssl(size):
    key, _, data = _inputs(size, seed=1)
    got = C.poly1305_tag(key, _t(data))
    assert got == JC.poly1305_tag(key, data)
    assert got == Poly1305.generate_tag(key, data)
    if size <= 65536:
        assert C.poly1305_ref(key, data) == got


@pytest.mark.parametrize("size", [16, 17, 160, 4096 * 16 + 3])
def test_poly1305_adversarial_key_reduces_fully(size):
    data = b"\xff" * size
    want = Poly1305.generate_tag(ADVERSARIAL_KEY, data)
    assert C.poly1305_tag(ADVERSARIAL_KEY, _t(data)) == want
    assert C.poly1305_ref(ADVERSARIAL_KEY, data) == want
    assert JC.poly1305_tag(ADVERSARIAL_KEY, data) == want


@pytest.mark.parametrize("size", SIZES)
def test_aead_matches_jax_and_openssl(size):
    key, nonce, data = _inputs(size, seed=2)
    aad = b"header" if size % 2 else b""
    ct, tag = C.aead_encrypt(key, nonce, _t(data), aad)
    want_ct, want_tag = JC.aead_encrypt(key, nonce, data, aad)
    assert ct.numpy().tobytes() == want_ct.tobytes() and tag == want_tag
    assert ct.numpy().tobytes() + tag == ChaCha20Poly1305(key).encrypt(nonce, data, aad or None)
    assert C.aead_decrypt(key, nonce, ct, tag, aad).numpy().tobytes() == data
    assert np.asarray(JC.aead_decrypt(key, nonce, ct.numpy(), tag, aad)).tobytes() == data


@pytest.mark.parametrize("size", [0, 1, 64, 1000])
def test_aead_ref_matches_openssl(size):
    key, nonce, data = _inputs(size, seed=3)
    ct, tag = C.aead_ref(key, nonce, data, b"aad")
    assert ct + tag == ChaCha20Poly1305(key).encrypt(nonce, data, b"aad")


def test_tampering_raises():
    key, nonce, data = _inputs(1000, seed=4)
    ct, tag = C.aead_encrypt(key, nonce, _t(data), b"aad")
    bad_tag = bytes([tag[0] ^ 1]) + tag[1:]
    bad_ct = ct.clone()
    bad_ct[500] ^= 0x80
    for args in ((ct, bad_tag, b"aad"), (bad_ct, tag, b"aad"), (ct, tag, b"aae")):
        with pytest.raises(ValueError, match="tag mismatch"):
            C.aead_decrypt(key, nonce, *args)
    with pytest.raises(ValueError, match="tag mismatch"):
        C.xchacha_aead_decrypt(key, bytes(24), ct, tag)


def test_hchacha20_matches_jax():
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f")
    nonce16 = bytes.fromhex("000000090000004a0000000031415927")
    want = bytes.fromhex("82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")
    assert C._hchacha20(key, nonce16) == JC._hchacha20(key, nonce16) == want
    rng = np.random.default_rng(5)
    for _ in range(4):
        k, n = rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        assert C._hchacha20(k, n) == JC._hchacha20(k, n)


def test_xchacha_draft_vector_and_jax():
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    key = bytes.fromhex("808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f")
    nonce24 = bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657")
    ct, tag = C.xchacha_aead_encrypt(key, nonce24, _t(SUNSCREEN), aad)
    assert ct.numpy().tobytes().hex() == (
        "bd6d179d3e83d43b9576579493c0e939572a1700252bfaccbed2902c21396cbb"
        "731c7f1b0b4aa6440bf3a82f4eda7e39ae64c6708c54c216cb96b72e1213b452"
        "2f8c9ba40db5d945b11b69b982c1bb9e3f3fac2bc369488f76b2383565d3fff9"
        "21f9664c97637da9768812f615c68b13b52e"
    )
    assert tag == bytes.fromhex("c0875924c1c7987947deafd8780acf49")
    assert C.xchacha_aead_decrypt(key, nonce24, ct, tag, aad).numpy().tobytes() == SUNSCREEN
    for size in (0, 100, 5000):
        k, _, data = _inputs(size, seed=6)
        n24 = bytes(range(24))
        got_ct, got_tag = C.xchacha_aead_encrypt(k, n24, _t(data))
        want_ct, want_tag = JC.xchacha_aead_encrypt(k, n24, data)
        assert got_ct.numpy().tobytes() == want_ct.tobytes() and got_tag == want_tag


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="32 bytes"):
        C.chacha20_xor(bytes(31), bytes(12), _t(b"x"))
    with pytest.raises(ValueError, match="counter"):
        C.chacha20_xor(bytes(32), bytes(12), _t(b"x"), counter=1 << 32)
    with pytest.raises(ValueError, match="1-D uint8"):
        C.chacha20_xor(bytes(32), bytes(12), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="nonce 24 bytes"):
        C.xchacha_aead_encrypt(bytes(32), bytes(12), _t(b"x"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch on a CUDA tensor or raise: never the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.chacha20_xor_cuda(bytes(32), bytes(12), _t(b"abc"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        C.poly1305_cuda(torch.zeros(32, dtype=torch.uint8), _t(b"abc"))


# The MAC kernel's schedule (csrc/chacha.cu, C.poly1305_lanes_ref under
# C.poly_geometry): around a block, a warp's group of 32 blocks (512 B), a
# block of 8 warps' groups (4 KiB), the one-launch span (16 KiB), twice it
# (a grid and a fold) and 33 times it (33 partials at 132 SMs: fold lanes
# with two each; at 2 SMs, the grid's cap of 6 blocks with a longer span).
POLY_SPANS = [16, 512, 4096, C.POLY_ONE_LAUNCH * 16, 2 * C.POLY_ONE_LAUNCH * 16, 33 * C.POLY_ONE_LAUNCH * 16]


@pytest.mark.parametrize("mode", ["raw", "aead"])
@pytest.mark.parametrize("span", POLY_SPANS)
def test_lane_interleaved_poly1305_matches_jax_and_ref(span, mode):
    rng = np.random.default_rng(span + (mode == "aead"))
    for n in (span - 1, span, span + 1):
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        if mode == "raw":
            mac = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:  # the AEAD's MAC input around the span: pad16(aad) || pad16(ciphertext) || the lengths
            aad = b"header" if span > 16 else b""
            ciphertext = rng.integers(0, 256, max(0, n - 16 - len(C._pad16(aad))), dtype=np.uint8).tobytes()
            mac = C._mac_data(aad, ciphertext)
        want = JC.poly1305_tag(key, mac)
        blocks = -(-len(mac) // 16)
        assert C.poly1305_ref(key, mac) == want
        for sms in (132, 2):
            geometry = C.poly_geometry(blocks, sms)
            assert C.poly1305_lanes_ref(key, mac, geometry) == want, (n, sms, geometry)


def test_poly_geometry_covers_the_input():
    """Up to POLY_ONE_LAUNCH blocks: one block of just enough warps; past
    it, 8-warp blocks, at most POLY_BLOCKS_PER_SM an SM, each warp's span as
    short as covers the input."""
    for sms in (1, 2, 132):
        for blocks in [0, 1, 31, 32, 33, 256, 257, 1023, 1024, 1025, 2048, 4097, 33 * 1024 + 5, 8_388_608]:
            grid, warps, q = C.poly_geometry(blocks, sms)
            covered = grid * warps * 32 * q
            assert covered >= blocks and q >= 1 and 1 <= warps <= C.POLY_WARPS
            if blocks <= C.POLY_ONE_LAUNCH:
                assert grid == 1 and warps == max(1, min(C.POLY_WARPS, -(-blocks // 32)))
            else:
                assert warps == C.POLY_WARPS and 1 < grid <= max(2, sms * C.POLY_BLOCKS_PER_SM)
                assert grid * warps * 32 * (q - 1) < blocks
    assert C.poly_geometry(8_388_608, 132) == (396, 8, 83)  # the 128 MiB corpus on an H100
