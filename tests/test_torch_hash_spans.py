"""The per-token hashes over a tape's spans (``ops/hash.py``'s
``xxh64_spans``, ``xxh32_spans``, ``swh64_spans``, ``swh64_multiseed_spans``)
on the CPU, against the JAX package's ``xxh64``, ``xxh32``, ``swh64`` and
``swh64_multiseed`` and the port's padded calls, token by token.

The tokens are laid end to end on a tape after 0..7 junk bytes, empty tokens
among them, shuffled, the last ending at the buffer's last byte: lengths
0..300 and a few over 1,000, across XXH32's 16-byte and XXH64's 32-byte
stripes. Digests are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import hash as JH
from stringwars_tpu_torch import tape
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops import hash_cuda
from _torch_threads import one_thread  # noqa: F401

LENGTHS = list(range(301)) + [1000, 1024, 1031, 1536]
SEEDS = [0, 0x9E3779B9, 0xDEADBEEFCAFEBABE]  # 0, a 32-bit seed, a full 64-bit seed
MULTISEEDS = [0, 7, 2**63 + 5, 2**64 - 1, 3, 4, 5, 6]


@pytest.fixture(scope="module")
def tokens():
    """Token i of ``LENGTHS[i]`` seeded bytes, with the empty token last."""
    rng = np.random.default_rng(17)
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in LENGTHS] + [b""]


@pytest.fixture(scope="module")
def jax_digests(tokens):
    """name -> the JAX package's digests of ``tokens`` (rows of one padded
    batch), under each seed."""
    ref = jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=4)
    out = {}
    for seed in SEEDS:
        out["xxh64", seed] = JH.xxh64(ref, seed).to_numpy().astype(np.uint64)
        out["xxh32", seed] = np.asarray(JH.xxh32(ref, seed & 0xFFFFFFFF)).astype(np.uint32)
        out["swh64", seed] = JH.swh64(ref, seed).to_numpy().astype(np.uint64)
    out["swh64_multiseed"] = JH.swh64_multiseed(ref, np.array(MULTISEEDS, np.uint64)).to_numpy().astype(np.uint64)
    return out


def spans_tape(tokens: list[bytes], offset: int):
    """(tape bytes, int64 offsets, the token of each span): ``tokens`` end to
    end after ``offset`` junk bytes, shuffled, an empty token after every
    seventh, the longest last so that the tape ends at its last byte."""
    rng = np.random.default_rng(100 + offset)
    longest = max(range(len(tokens)), key=lambda i: len(tokens[i]))
    order = [int(i) for i in rng.permutation(len(tokens)) if i != longest] + [longest]
    rows = []
    for k, i in enumerate(order):
        rows.append(i)
        if k % 7 == 6 and k != len(order) - 1:
            rows.append(len(tokens) - 1)  # the empty token
    sizes = [len(tokens[i]) for i in rows]
    offsets = offset + np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    data = rng.integers(0, 256, offset, dtype=np.uint8).tobytes() + b"".join(tokens[i] for i in rows)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8), torch.from_numpy(offsets), np.array(rows)


@pytest.mark.parametrize("offset", range(8))
def test_spans_equal_jax_and_padded(tokens, jax_digests, offset):
    """Each spans digest equals the JAX package's and the padded call's of
    the same token, by token index, under each seed."""
    data, offsets, rows = spans_tape(tokens, offset)
    assert int(offsets[-1]) == data.numel() and len(tokens[rows[-1]]) == max(LENGTHS)
    assert (rows == len(tokens) - 1).any()
    padded = tape.PaddedTokens.from_tape(tape.Tape.from_tokens([tokens[i] for i in rows]), align=4)
    for seed in SEEDS:
        for name, spans, rows_call in (("xxh64", H.xxh64_spans, H.xxh64), ("xxh32", H.xxh32_spans, H.xxh32),
                                       ("swh64", H.swh64_spans, H.swh64)):
            got = spans(data, offsets, seed)
            assert got.shape == (rows.size,) and got.dtype == rows_call(padded, seed).dtype
            np.testing.assert_array_equal(got.numpy(), jax_digests[name, seed][rows], err_msg=f"{name}, seed {seed:#x}")
            np.testing.assert_array_equal(got.numpy(), rows_call(padded, seed).numpy())


@pytest.mark.parametrize("offset", [0, 3, 7])
def test_multiseed_spans_equal_jax_and_padded(tokens, jax_digests, offset):
    """swh64 under 8 seeds in one pass: [k, T] by token index."""
    data, offsets, rows = spans_tape(tokens, offset)
    got = H.swh64_multiseed_spans(data, offsets, MULTISEEDS)
    assert got.shape == (len(MULTISEEDS), rows.size) and got.dtype == torch.uint64
    np.testing.assert_array_equal(got.numpy(), jax_digests["swh64_multiseed"][:, rows])
    padded = tape.PaddedTokens.from_tape(tape.Tape.from_tokens([tokens[i] for i in rows]), align=4)
    np.testing.assert_array_equal(got.numpy(), H.swh64_multiseed(padded, MULTISEEDS).numpy())


def test_spans_of_a_tape_equal_its_buckets():
    """A ``Tape``'s own data and offsets: the spans digests equal the bucketed
    padded calls' by token index (the hash suite's two routes)."""
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8)) for n in rng.integers(0, 40, 500)]
    t = tape.Tape.from_tokens(words)
    for idx_padded in tape.bucket_spans(t, [16, 64]):
        padded, idx = idx_padded
        np.testing.assert_array_equal(H.xxh64_spans(t.data, t.offsets)[idx].numpy(), H.xxh64(padded).numpy())
        np.testing.assert_array_equal(H.xxh32_spans(t.data, t.offsets, 5)[idx].numpy(), H.xxh32(padded, 5).numpy())
        np.testing.assert_array_equal(H.swh64_spans(t.data, t.offsets, 9)[idx].numpy(), H.swh64(padded, 9).numpy())


@pytest.mark.parametrize("width", [1, 2, 3, 5, 6, 7, 13, 130])
def test_padded_rows_of_any_width_equal_spans(width):
    """Padded rows whose width is no multiple of 4 (the rows form of the
    kernels reads them at every byte offset): each row's digest equals the
    spans digest of the same token, held to JAX above."""
    rng = np.random.default_rng(width)
    t = tape.Tape.from_tokens([bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in range(width + 1)])
    padded = tape.PaddedTokens.from_tape(t, align=1)
    assert padded.width == width
    for seed in SEEDS:
        np.testing.assert_array_equal(H.xxh64(padded, seed).numpy(), H.xxh64_spans(t.data, t.offsets, seed).numpy())
        np.testing.assert_array_equal(H.xxh32(padded, seed).numpy(), H.xxh32_spans(t.data, t.offsets, seed).numpy())
        np.testing.assert_array_equal(H.swh64(padded, seed).numpy(), H.swh64_spans(t.data, t.offsets, seed).numpy())
    np.testing.assert_array_equal(H.swh64_multiseed(padded, MULTISEEDS).numpy(),
                                  H.swh64_multiseed_spans(t.data, t.offsets, MULTISEEDS).numpy())


def test_empty_tape_and_empty_tokens():
    data, offsets = torch.zeros(0, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64)
    assert H.xxh64_spans(data, offsets).shape == (0,) and H.swh64_multiseed_spans(data, offsets, [1, 2]).shape == (2, 0)
    offsets = torch.zeros(3, dtype=torch.int64)
    assert (H.xxh64_spans(data, offsets).view(torch.int64) == torch.tensor(0xEF46DB3751D8E999 - 2**64)).all()
    assert (H.xxh32_spans(data, offsets).to(torch.int64) == 0x02CC5D05).all()


def test_spans_cuda_wrappers_need_a_card_tensor():
    data, offsets = torch.zeros(8, dtype=torch.uint8), torch.tensor([0, 3, 8])
    for call in (hash_cuda.xxh64_spans_cuda, hash_cuda.xxh32_spans_cuda, hash_cuda.swh64_spans_cuda,
                 lambda d, o: hash_cuda.swh64_multiseed_spans_cuda(d, o, [0, 1])):
        with pytest.raises(ValueError):
            call(data, offsets)
    with pytest.raises(ValueError):
        H.xxh64_spans(data.to("meta"), offsets.to("meta"))
