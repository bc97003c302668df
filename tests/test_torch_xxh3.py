"""The port's XXH3-64 (``ops/xxh3.py``) on the CPU: its plain version against
the ``xxhash`` wheel and the JAX package's ``xxh3_hash`` (run without jit:
the same function, op by op, which spares its minutes-long compile of the
unrolled stripe loop) at every length 0..2,100, seeds 0 and nonzero, over
padded rows and over a tape's spans (``xxh3_64_spans``) at offsets 0..7."""

import numpy as np
import pytest
import torch
import xxhash

import jax
import jax.numpy as jnp

from stringwars_tpu.ops import xxh3 as JX
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu_torch.ops import xxh3 as X
from stringwars_tpu_torch.tape import PaddedTokens
from _torch_threads import one_thread  # noqa: F401

LONGEST = 2100
SEEDS = [0, 0x9E3779B97F4A7C15]


@pytest.fixture(scope="module")
def every_length():
    """Rows of random bytes, row i of length i, junk past each length."""
    rng = np.random.default_rng(15)
    width = LONGEST + 4
    data = rng.integers(0, 256, (LONGEST + 1, width), dtype=np.uint8)
    return data, np.arange(LONGEST + 1, dtype=np.int32), width


def _wheel(data, lengths, seed):
    return np.array([xxhash.xxh3_64_intdigest(data[i, : lengths[i]].tobytes(), seed) for i in range(len(lengths))],
                    dtype=np.uint64)


@pytest.fixture(scope="module")
def jax_digests(every_length):
    """seed -> the JAX package's digests of ``every_length``'s rows."""
    data, lengths, width = every_length
    out = {}
    with jax.disable_jit():
        for seed in SEEDS:
            tokens = JaxPaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=width)
            out[seed] = JX.xxh3_hash(tokens, seed).to_numpy().astype(np.uint64)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_every_length_equals_wheel_and_jax(every_length, jax_digests, seed):
    data, lengths, width = every_length
    tokens = PaddedTokens.from_numpy(data, lengths, width)
    got = X.xxh3_64(tokens, seed).numpy()
    np.testing.assert_array_equal(got, _wheel(data, lengths, seed))
    np.testing.assert_array_equal(got, jax_digests[seed])


def spans_tape(data: np.ndarray, lengths: np.ndarray, offset: int, seed: int = 16):
    """(tape bytes, int64 offsets, row of each token): the tokens of rows
    ``data[i, :lengths[i]]`` laid end to end after ``offset`` junk bytes, an
    empty token after every seventh, shuffled; the last token ends at the
    buffer's last byte (the longest, so that it is never empty)."""
    rng = np.random.default_rng(seed + offset)
    order = rng.permutation(lengths.size)
    order = np.concatenate([order[order != lengths.argmax()], [lengths.argmax()]])
    rows = []
    for k, i in enumerate(order):
        rows.append(int(i))
        if k % 7 == 6 and k != order.size - 1:
            rows.append(-1)
    rows = np.array(rows)
    sizes = np.where(rows >= 0, lengths[np.maximum(rows, 0)], 0).astype(np.int64)
    offsets = offset + np.concatenate([[0], np.cumsum(sizes)])
    tape = [rng.integers(0, 256, offset, dtype=np.uint8)]
    tape += [data[i, : lengths[i]] for i in rows if i >= 0]
    return np.concatenate(tape), offsets, rows


@pytest.mark.parametrize("offset", range(8))
def test_spans_equal_wheel_and_jax(every_length, jax_digests, offset):
    """The tape's own form, tokens read where they lie: every length
    0..2,100 with empty tokens among them, at tape offsets 0..7."""
    data, lengths, _ = every_length
    tape, offsets, rows = spans_tape(data, lengths, offset)
    assert offsets[-1] == tape.size and (rows == -1).any()
    tokens = [data[i, : lengths[i]].tobytes() if i >= 0 else b"" for i in rows]
    for seed in SEEDS:
        got = X.xxh3_64_spans(torch.from_numpy(tape), torch.from_numpy(offsets), seed).numpy()
        np.testing.assert_array_equal(got, np.array([xxhash.xxh3_64_intdigest(t, seed) for t in tokens], np.uint64))
        np.testing.assert_array_equal(got, jax_digests[seed][np.where(rows >= 0, rows, 0)])


@pytest.mark.parametrize("offset", range(16))
def test_views_at_base_offsets(offset):
    """Rows of a view whose first byte lies ``offset`` bytes into its buffer,
    at lengths around each path's edges."""
    rng = np.random.default_rng(offset)
    lengths = np.array([0, 1, 3, 4, 8, 9, 16, 17, 100, 128, 129, 240, 241, 1023, 1024, 1025, 2048, 2049], np.int32)
    width = 2052
    buffer = torch.from_numpy(rng.integers(0, 256, offset + lengths.size * width, dtype=np.uint8))
    view = buffer[offset:].view(lengths.size, width)
    tokens = PaddedTokens(data=view, lengths=torch.from_numpy(lengths), width=width)
    for seed in SEEDS:
        np.testing.assert_array_equal(X.xxh3_64(tokens, seed).numpy(), _wheel(view.numpy(), lengths, seed))


def test_empty_input_gives_published_digest():
    empty = PaddedTokens.from_numpy(np.zeros((1, 4), np.uint8), np.zeros(1, np.int32))
    assert int(X.xxh3_64(empty)[0]) == X.EMPTY_DIGEST == xxhash.xxh3_64_intdigest(b"")


def test_secret_words():
    """The port's kSecret is the JAX package's; seed 0's long-path words are
    kSecret's own, and a seed changes them as the spec derives them."""
    assert X.KSECRET == JX.KSECRET
    words = dict(zip([name for name, _ in X.KEY_GROUPS], np.split(np.array(X.secret_words(0), dtype=np.uint64),
                                                                   np.cumsum([c for _, c in X.KEY_GROUPS])[:-1])))
    np.testing.assert_array_equal(words["stripes"], np.frombuffer(X.KSECRET, "<u8"))
    seeded = np.array(X.secret_words(5), dtype=np.uint64)[37:61]
    np.testing.assert_array_equal(seeded, JX._secret_words(5))
    assert len(X.secret_words(1)) == X.KEY_WORDS


def test_plain_mul128_fold64():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 63, 200, dtype=np.uint64) * 2 + rng.integers(0, 2, 200, dtype=np.uint64)
    b = rng.integers(0, 1 << 63, 200, dtype=np.uint64) * 2 + 1
    got = X._mul128_fold64(torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))).numpy().view(np.uint64)
    want = [((int(x) * int(y)) ^ ((int(x) * int(y)) >> 64)) & ((1 << 64) - 1) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))


def test_cuda_wrapper_needs_a_card_tensor():
    tokens = PaddedTokens.from_numpy(np.zeros((2, 8), np.uint8), np.array([1, 2], np.int32))
    with pytest.raises(ValueError):
        X.xxh3_64_cuda(tokens)
    with pytest.raises(ValueError):
        X.xxh3_64(PaddedTokens(data=tokens.data.to("meta"), lengths=tokens.lengths.to("meta"), width=8))


def test_spans_cuda_wrapper_needs_a_card_tensor():
    data, offsets = torch.zeros(8, dtype=torch.uint8), torch.tensor([0, 3, 8])
    with pytest.raises(ValueError):
        X.xxh3_64_spans_cuda(data, offsets)
    with pytest.raises(ValueError):
        X.xxh3_64_spans(data.to("meta"), offsets.to("meta"))
