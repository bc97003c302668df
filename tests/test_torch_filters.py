"""The port's membership filters (``stringwars_tpu_torch.ops.filters``)
against the JAX package's (``stringwars_tpu.ops.filters``) on the same
numpy-seeded tokens, exactly: the Bloom positions, words and query bits
(tokens as a tape's spans and as padded rows), and the BinaryFuse8 table,
seed, segment parameters and answers."""

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import filters as JF
from stringwars_tpu.ops import hash as JH
from stringwars_tpu_torch.ops import filters as F
from stringwars_tpu_torch.tape import PaddedTokens, Tape
from _torch_threads import one_thread  # noqa: F401


def _tokens(seed: int, count: int, long_every: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    tokens = [bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8)) for _ in range(count)]
    if long_every:
        tokens[::long_every] = [bytes(rng.integers(0, 256, 1024, dtype=np.uint8)) for _ in tokens[::long_every]]
    return tokens + [b""]


def _layout(tokens):
    return JH.prepare(jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=4))


@pytest.fixture(scope="module")
def split():
    inserted = list(dict.fromkeys(_tokens(11, 1500, long_every=97)))
    held_out = [t for t in _tokens(12, 600) if t not in set(inserted)]
    return inserted, held_out


@pytest.mark.parametrize("seeds, m_bits", [((5,), 1 << 14), (tuple(range(1, 8)), 32 * 1001), (tuple(range(1, 17)), 1 << 15)])
def test_bloom_equals_jax(split, seeds, m_bits):
    inserted, held_out = split
    jins, jout = _layout(inserted), _layout(held_out)
    tape = Tape.from_tokens(inserted)
    rows = PaddedTokens.from_tape(tape, align=4)
    np.testing.assert_array_equal(
        F.bloom_positions(tape, seeds, m_bits).numpy(), np.asarray(JF.bloom_positions(jins, seeds, m_bits)))
    want_words = np.asarray(JF._bloom_build(jins, seeds, m_bits))
    for tokens in (tape, rows):
        filt = F.bloom_build(tokens, seeds, m_bits)
        assert filt.m_bits == m_bits and filt.seeds == seeds
        np.testing.assert_array_equal(filt.words.numpy(), want_words)
    filt = F.bloom_build(tape, seeds, m_bits)
    for probe, jprobe in ((tape, jins), (Tape.from_tokens(held_out), jout)):
        want = np.asarray(JF._bloom_query(JF._bloom_build(jins, seeds, m_bits), jprobe, seeds, m_bits))
        np.testing.assert_array_equal(F.bloom_query(filt, probe).numpy(), want)
        np.testing.assert_array_equal(F.bloom_query(filt, PaddedTokens.from_tape(probe, align=4)).numpy(), want)


def test_bloom_has_no_false_negatives(split):
    inserted, held_out = split
    filt = F.bloom_build(Tape.from_tokens(inserted), tuple(range(1, 8)), 1 << 15)
    assert F.bloom_query(filt, Tape.from_tokens(inserted)).all()
    assert F.bloom_query(filt, Tape.from_tokens(held_out)).float().mean() < 0.25
    assert filt.bits_per_key(len(inserted)) > 8
    with pytest.raises(ValueError):
        F.bloom_build(Tape.from_tokens(inserted), (1,), 1000)


def test_fuse_equals_jax():
    rng = np.random.default_rng(42)
    words = list({bytes(rng.integers(97, 123, rng.integers(4, 20), dtype=np.uint8)) for _ in range(3000)})
    inserted, held_out = words[:2400], words[2400:]
    ins_keys = JH.xxh64(_layout(inserted)).to_numpy()
    out_keys = np.setdiff1d(JH.xxh64(_layout(held_out)).to_numpy(), ins_keys)
    want = JF.fuse_build(ins_keys)
    got = F.fuse_build(ins_keys, device="cpu")
    assert (got.seed, got.segment_length, got.segment_count_length) == (want.seed, want.segment_length, want.segment_count_length)
    np.testing.assert_array_equal(got.fingerprints.numpy(), np.asarray(want.fingerprints))
    assert got.bits_per_key(ins_keys.size) == want.bits_per_key(ins_keys.size)
    for keys in (ins_keys, out_keys, np.zeros(0, np.uint64)):
        np.testing.assert_array_equal(F.fuse_query(got, keys).numpy(), np.asarray(JF.fuse_query(want, keys)))
    assert F.fuse_query(got, ins_keys).all()
    h, fp = JF._fuse_hashes(out_keys, want.seed, want.segment_length, want.segment_count_length)
    sh, sfp = F.fuse_stage(got, out_keys)
    np.testing.assert_array_equal(sh.numpy(), h)
    np.testing.assert_array_equal(sfp.numpy(), fp)
    # The plain query reads a position as jnp.take does, as the kernel does:
    # -5 wraps to len - 5, and a position past the end reads 255.
    table = got.fingerprints
    wild = torch.tensor([[-5, 0], [1 << 30, 1], [2, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(
        F.fuse_query_plain(table, wild, torch.tensor([0, 0], dtype=torch.uint8)).numpy(),
        (table[[table.numel() - 5, 0]] ^ torch.tensor([255, int(table[1])], dtype=torch.uint8) ^ table[[2, 2]]).numpy()
        == 0)


@pytest.mark.parametrize("size", [1, 10, 4099])
def test_fuse_query_positions_out_of_range_equal_jax(size):
    """Positions in and past both ends of the table (wrapped from -len to -1,
    255 below -len and from len up, the int32 extremes among them): the plain
    query equals the JAX ``_fuse_query_dev`` (``jnp.take``'s fill mode)."""
    rng = np.random.default_rng(size)
    table = rng.integers(0, 256, size, dtype=np.uint8)
    edges = np.array([-(1 << 31), -size - 7, -size - 1, -size, -size + 1, -1, 0, 1, size - 1, size, size + 1,
                      size + 12, (1 << 31) - 1], np.int64)
    h = np.concatenate([np.stack(np.meshgrid(edges, edges, edges)).reshape(3, -1),
                        rng.integers(-2 * size - 3, 2 * size + 3, (3, 500))], axis=1).astype(np.int32)
    fp = rng.integers(0, 256, h.shape[1], dtype=np.uint8)
    fp[::3] = table[0] ^ table[-1] ^ 255  # answers that hold somewhere among the edges
    want = np.asarray(JF._fuse_query_dev(table, h[0], h[1], h[2], fp))
    got = F.fuse_query_plain(torch.from_numpy(table), torch.from_numpy(h), torch.from_numpy(fp)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
