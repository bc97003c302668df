"""The port's hash slice against the JAX package, on the CPU.

The same tokens, made from a numpy seed, go through the JAX functions and
the port's plain torch versions; digests are integers, so every comparison
is exact. xxh32 and xxh64 are also held against the ``xxhash`` wheel, and
swh64 against its host oracle ``swh64_ref``.
"""

import numpy as np
import pytest
import torch
import xxhash

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import hash as JH
from stringwars_tpu_torch import tape
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops import hash_cuda
from _torch_threads import one_thread  # noqa: F401


# Lengths 0..130 and every bucket edge of the hash suite (and one past).
LENGTHS = list(range(131)) + [255, 256, 257, 1023, 1024, 1025]


@pytest.fixture(scope="module")
def sweep():
    rng = np.random.default_rng(7)
    tokens = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in LENGTHS]
    ref = jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=4)
    port = tape.PaddedTokens.from_tape(tape.Tape.from_tokens(tokens), align=4)
    return tokens, ref, port


def _u64(jax_digests) -> np.ndarray:
    return jax_digests.to_numpy().astype(np.uint64)


def test_padded_tokens_match_jax(sweep):
    _, ref, port = sweep
    assert port.width == ref.width and port.data.dtype == torch.uint8 and port.lengths.dtype == torch.int32
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.lengths.numpy(), np.asarray(ref.lengths))


@pytest.mark.parametrize("align,max_width", [(64, None), (4, None), (64, 128), (4, 33)])
def test_from_tape_widths_and_truncation_match_jax(align, max_width):
    rng = np.random.default_rng(3)
    tokens = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (0, 1, 5, 63, 64, 65, 200, 300)]
    ref = jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=align, max_width=max_width)
    port = tape.PaddedTokens.from_tape(tape.Tape.from_tokens(tokens), align=align, max_width=max_width)
    assert port.width == ref.width
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.lengths.numpy(), np.asarray(ref.lengths))


def test_padded_tokens_from_numpy_takes_jax_state(sweep):
    _, ref, _ = sweep
    got = tape.PaddedTokens.from_numpy(np.asarray(ref.data), np.asarray(ref.lengths), ref.width, device="cpu")
    assert got.width == ref.width and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    with pytest.raises(ValueError):
        tape.PaddedTokens.from_numpy(np.zeros((2, 6), np.uint8), np.zeros(2, np.int32))


def test_bucket_by_length_matches_jax():
    rng = np.random.default_rng(5)
    lengths = list(rng.integers(0, 40, 300)) + [0, 16, 17, 64, 65, 256, 257, 1024, 1025, 4096, 4097, 5000]
    tokens = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in lengths]
    edges = [16, 64, 256, 1024, 4096]
    ref = jax_tape.bucket_by_length(jax_tape.Tape.from_tokens(tokens), edges)
    port = tape.bucket_by_length(tape.Tape.from_tokens(tokens), edges)
    assert [b.width for b in port] == [b.width for b in ref]
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_subtape_matches_jax():
    tokens = [b"alpha", b"", b"beta", b"gamma", b"d" * 70]
    ref = jax_tape.Tape.from_tokens(tokens).subtape(1, 4)
    got = tape.Tape.from_tokens(tokens).subtape(1, 4)
    assert got.to_list() == ref.to_list() == tokens[1:4]
    assert (got.count, got.total_bytes) == (ref.count, ref.total_bytes)


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_xxh32_matches_jax_and_xxhash(sweep, seed):
    tokens, ref, port = sweep
    got = H.xxh32(port, seed)
    assert got.dtype == torch.uint32 and got.shape == (len(tokens),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JH.xxh32(ref, seed)))
    np.testing.assert_array_equal(got.numpy(), np.array([xxhash.xxh32_intdigest(t, seed) for t in tokens], np.uint32))


@pytest.mark.parametrize("seed", [0, 12345, 0xDEADBEEFCAFEBABE])
def test_xxh64_matches_jax_and_xxhash(sweep, seed):
    tokens, ref, port = sweep
    got = H.xxh64(port, seed)
    assert got.dtype == torch.uint64 and got.shape == (len(tokens),)
    np.testing.assert_array_equal(got.numpy(), _u64(JH.xxh64(ref, seed)))
    np.testing.assert_array_equal(got.numpy(), np.array([xxhash.xxh64_intdigest(t, seed) for t in tokens], np.uint64))


def test_known_empty_digests():
    empty = tape.PaddedTokens.from_tape(tape.Tape.from_tokens([b""]))
    assert int(H.xxh64(empty).view(torch.int64)) & (2**64 - 1) == 0xEF46DB3751D8E999
    assert int(H.xxh32(empty).to(torch.int64)) == 0x02CC5D05


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEFCAFEBABE])
def test_swh64_matches_jax_and_ref(sweep, seed):
    tokens, ref, port = sweep
    got = H.swh64(port, seed).numpy()
    np.testing.assert_array_equal(got, _u64(JH.swh64(ref, seed)))
    np.testing.assert_array_equal(got, np.array([H.swh64_ref(t, seed) for t in tokens], np.uint64))
    assert [H.swh64_ref(t, seed) for t in tokens[:40]] == [JH.swh64_ref(t, seed) for t in tokens[:40]]


def test_multiseeds_match_jax(sweep):
    _, ref, port = sweep
    seeds = np.array([0, 7, 42, 2**63 + 5, 2**64 - 1, 3, 4, 5, 6, 9], dtype=np.uint64)
    got = H.xxh64_multiseed(port, seeds)
    assert got.shape == (len(seeds), port.count)
    np.testing.assert_array_equal(got.numpy(), _u64(JH.xxh64_multiseed(ref, seeds)))
    np.testing.assert_array_equal(H.swh64_multiseed(port, seeds).numpy(), _u64(JH.swh64_multiseed(ref, seeds)))
    for i, s in enumerate(seeds[:3]):
        np.testing.assert_array_equal(got[i].numpy(), H.xxh64(port, int(s)).numpy())


def test_kernel_module_plain_matches_the_pallas_kernel():
    """The xxh64 kernel's plain counterpart against JAX ``xxh64_pallas`` in
    interpret mode, on few short tokens (interpret cost grows with the lane
    tile), as ``tests/test_hash.py`` runs it."""
    rng = np.random.default_rng(42)
    tokens = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (0, 3, 31, 32, 33, 64, 95, 100)]
    ref = jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=4)
    port = tape.PaddedTokens.from_tape(tape.Tape.from_tokens(tokens), align=4)
    for seed in (0, 12345):
        want = _u64(JH.xxh64_pallas(ref, seed=seed, interpret=True))
        np.testing.assert_array_equal(H.xxh64_plain(port, [seed])[0].numpy(), want)


@pytest.mark.parametrize("n", [0, 1, H.TREE_CHUNK, H.TREE_CHUNK + 1, 300 * 1024 + 7])
def test_tree_hash64_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = H.tree_hash64(torch.from_numpy(data))
    assert got == JH.tree_hash64(data)
    if n <= H.TREE_CHUNK:
        assert got == xxhash.xxh64_intdigest(data.tobytes())


# Extents at the edges of the 16-byte units, of a chunk and of the
# kernel's shared-memory slices (hash_cuda.TREE_SLICE).
TREE_SMALL = [0, 1, 15, 16, 17]
TREE_LARGE = [H.TREE_CHUNK + d for d in (-1, 0, 1)] + [H.TREE_CHUNK + hash_cuda.TREE_SLICE + d for d in (-1, 0, 1)]


@pytest.fixture(scope="module")
def tree_buffer():
    return np.random.default_rng(16).integers(0, 256, H.TREE_CHUNK + hash_cuda.TREE_SLICE + 32, dtype=np.uint8)


@pytest.mark.parametrize("offset", range(16))
def test_tree_hash64_at_base_offsets_matches_jax(tree_buffer, offset):
    """Views at every offset within a 16-byte unit (the CUDA kernel copies
    the whole units and reads the rest with plain loads) hash as the JAX
    tree_hash64 hashes the same bytes: the short extents at every offset,
    and the extents around a chunk and a slice past it, one an offset (a
    chunk's plain hash is the slow part on the CPU), each at 2-3 offsets."""
    view = torch.from_numpy(tree_buffer)[offset:]
    for n in TREE_SMALL + [TREE_LARGE[offset % len(TREE_LARGE)]]:
        assert H.tree_hash64(view, n) == JH.tree_hash64(tree_buffer[offset : offset + n]), n


def test_tree_level_reads_only_n_bytes():
    data = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 3 * H.TREE_CHUNK, dtype=np.uint8))
    n = 2 * H.TREE_CHUNK + 5
    np.testing.assert_array_equal(H.tree_level(data, n).numpy(), H.tree_level(data[:n].clone()).numpy())


def test_cuda_wrappers_refuse_cpu_tensors(sweep):
    _, _, port = sweep
    before = dict(hash_cuda.LAUNCHES)
    for call in (
        lambda: hash_cuda.xxh64(port, [0]),
        lambda: hash_cuda.swh64(port, [0]),
        lambda: hash_cuda.xxh32(port, [0]),
        lambda: hash_cuda.tree_level(port.data.view(-1), 10),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert hash_cuda.LAUNCHES == before
