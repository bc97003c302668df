"""The port's SHA-256 against the JAX package and ``hashlib``, on the CPU.

The JAX package's tests' cases (the padding boundaries, two and three
blocks, random lengths), with junk 0xAB past every token's length, at each
width the hash suite's buckets take; digests are compared exactly.
"""

import hashlib

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops.sha256 import prepare_sha256, sha256_digest_bytes
from stringwars_tpu_torch import tape
from stringwars_tpu_torch.ops import sha256 as S
from stringwars_tpu_torch.suites import hash as hash_suite
from _torch_threads import one_thread  # noqa: F401


BOUNDARY = [0, 1, 3, 55, 56, 63, 64, 65, 119, 120, 128, 129, 191, 192]


def _tokens(lengths, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _junk_rows(tokens: list[bytes], width: int) -> tuple[np.ndarray, np.ndarray]:
    data = np.full((len(tokens), width), 0xAB, np.uint8)
    for i, t in enumerate(tokens):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
    return data, np.array([len(t) for t in tokens], np.int32)


def _check(tokens: list[bytes], width: int) -> None:
    data, lengths = _junk_rows(tokens, width)
    got = S.digest_bytes(S.sha256(tape.PaddedTokens.from_numpy(data, lengths)))
    want = sha256_digest_bytes(prepare_sha256(jax_tape.PaddedTokens(data=data, lengths=lengths, width=width)))
    np.testing.assert_array_equal(got, want)
    for i, t in enumerate(tokens):
        assert got[i].tobytes() == hashlib.sha256(t).digest(), f"token {i} ({len(t)} B)"


# Each bucket's width in the hash suite (64-byte rows up to 4,096 B), a
# 4-byte-aligned width, and the catch bucket's past 4,096 B.
@pytest.mark.parametrize("width", [4, 64, 196, 256, 1024, 4096, 4160])
def test_boundary_lengths_with_junk(width):
    _check(_tokens([n for n in BOUNDARY if n <= width] + [width], seed=width), width)


# Every length 0..130 that fits, with junk past it: one to three blocks,
# and the rows the kernel reads as one 16-byte vector (widths 16, 64, 128)
# or as 4-byte words (width 4).
@pytest.mark.parametrize("width", [4, 16, 64, 128])
def test_every_length_with_junk(width):
    _check(_tokens(list(range(min(130, width) + 1)), seed=width + 1), width)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_mixed_lengths(seed):
    rng = np.random.default_rng(seed)
    _check(_tokens(rng.integers(0, 300, 40).tolist(), seed), 320)


def test_known_vector():
    got = S.digest_bytes(S.sha256(tape.PaddedTokens.from_numpy(*_junk_rows([b"abc"], 64))))
    assert got[0].tobytes().hex() == "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"


def test_buckets_of_the_hash_suite():
    """Tokens of 1..5,000 B bucketed as the hash suite buckets them: every
    digest equals hashlib's, and the JAX package's over its own buckets."""
    rng = np.random.default_rng(9)
    tokens = _tokens(rng.integers(1, 5000, 200).tolist(), 9)
    port_tape = tape.Tape.from_tokens(tokens)
    ref_buckets = jax_tape.bucket_by_length(jax_tape.Tape.from_tokens(tokens), hash_suite.BUCKET_EDGES)
    for (padded, idx), ref in zip(tape.bucket_spans(port_tape, hash_suite.BUCKET_EDGES), ref_buckets):
        got = S.digest_bytes(S.sha256(padded))
        np.testing.assert_array_equal(got, sha256_digest_bytes(prepare_sha256(ref)))
        for row, i in enumerate(idx.tolist()):
            assert got[row].tobytes() == hashlib.sha256(tokens[i]).digest()


def test_plain_version_in_slices(monkeypatch):
    """Row slices of the plain version (its memory bound on the card) give
    the digests of one pass."""
    tokens = _tokens([5, 70, 0, 130, 64, 1], 11)
    padded = tape.PaddedTokens.from_numpy(*_junk_rows(tokens, 192))
    whole = S.sha256_plain(padded)
    monkeypatch.setattr(S, "_PLAIN_ROWS", 4)
    assert torch.equal(S.sha256_plain(padded), whole)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        S.sha256_cuda(tape.PaddedTokens.from_numpy(*_junk_rows([b"abc"], 64)))
