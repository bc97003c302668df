"""The Bloom kernels' walks replayed on the CPU (``ops/filters.py``,
``csrc/filters.cu``): the build's launches of up to 8 seeds, each an
atomicOr a probe into the words, and the query's seed groups that stop at a
token's first clear bit (a long token's group of four lanes four seeds at a
time, a later launch skipping what an earlier one decided), replayed with
numpy over the plain probe positions and held to ``bloom_build_plain`` /
``bloom_query_plain`` and to the JAX package's ``_bloom_build`` /
``_bloom_query``, exactly."""

import numpy as np
import pytest

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import filters as JF
from stringwars_tpu.ops import hash as JH
from stringwars_tpu_torch.ops import filters as F
from stringwars_tpu_torch.tape import PaddedTokens, Tape
from _torch_threads import one_thread  # noqa: F401

SEED_SETS = [tuple(range(1, k + 1)) for k in (1, 7, 8, 9, 16)]
M_BITS = (2048, 32 * 1001, 1 << 15)  # a filter nearly full, one not a power of two, the suite's ~14 bits a key
QUERY_GROUP = 2  # the seeds a short token takes between its tests in the package's launch (kQueryGroup)


def _layout(tokens):
    return JH.prepare(jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens), align=4))


@pytest.fixture(scope="module")
def split():
    """(inserted, held-out) token lists: a tenth of the inserted 32-200 B
    (the long path), the held-out 1-59 B, none inserted."""
    rng = np.random.default_rng(20)
    lengths = np.where(rng.random(1600) < 0.1, rng.integers(32, 200, 1600), rng.integers(0, 32, 1600))
    inserted = list(dict.fromkeys(bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in lengths))
    seen = set(inserted)
    held = [t for t in (bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in rng.integers(1, 60, 700)) if t not in seen]
    return inserted, held


@pytest.fixture(scope="module")
def digests(split):
    """(token set, k) -> uint64[k, B] plain XXH64 digests, hashed once."""
    inserted, held = split
    cache = {}

    def get(which: str, seeds) -> np.ndarray:
        key = (which, len(seeds))
        if key not in cache:
            tokens = inserted if which == "inserted" else held
            cache[key] = F._digests(Tape.from_tokens(tokens), seeds, plain=True).numpy()
        return cache[key]

    return get


@pytest.fixture(scope="module")
def plain(split):
    """(k, m_bits) -> (the plain words over the inserted tokens, {token set:
    the plain answers}), each computed once; the padded rows' answers held to
    the spans' on the way."""
    inserted, held = split
    cache = {}

    def get(seeds, m_bits):
        key = (len(seeds), m_bits)
        if key not in cache:
            words = F.bloom_build_plain(Tape.from_tokens(inserted), seeds, m_bits)
            answers = {}
            for which, probe in (("inserted", inserted), ("held", held)):
                tape = Tape.from_tokens(probe)
                answers[which] = F.bloom_query_plain(words, tape, seeds, m_bits).numpy()
                padded = F.bloom_query_plain(words, PaddedTokens.from_tape(tape, align=4), seeds, m_bits).numpy()
                np.testing.assert_array_equal(padded, answers[which])
            cache[key] = words.numpy(), answers
        return cache[key]

    return get


def positions(d: np.ndarray, m_bits: int) -> np.ndarray:
    """int64[k, B]: ``bloom_positions`` from the digests."""
    lo, hi = d & np.uint64(0xFFFFFFFF), d >> np.uint64(32)
    return ((lo ^ ((hi * np.uint64(0x9E3779B9)) & np.uint64(0xFFFFFFFF))) % np.uint64(m_bits)).astype(np.int64)


def replay_build(pos: np.ndarray, m_bits: int) -> np.ndarray:
    """The words ``sw_bloom_build`` leaves: launches of up to 8 seeds, each
    probe an atomicOr of its bit into the zeroed words."""
    words = np.zeros(m_bits // 32, np.uint32)
    for first in range(0, pos.shape[0], 8):
        part = pos[first : first + 8]
        np.bitwise_or.at(words, part >> 5, np.left_shift(np.uint32(1), (part & 31).astype(np.uint32)))
    return words


def replay_query(pos: np.ndarray, lengths: np.ndarray, words: np.ndarray, group: int) -> tuple[np.ndarray, int]:
    """(answers, finishes) of ``sw_bloom_query``: each launch of up to 8
    seeds skips a token an earlier one decided; a short token (under 32 B)
    takes its seeds ``group`` at a time (0: all of the launch's), a long one
    four at a time (a finish a lane of its group), and stops after the
    first group with a clear bit. ``finishes``: the seeds hashed in all."""
    bit = ((words[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1).astype(bool)
    answers = np.ones(pos.shape[1], bool)
    finishes = 0
    for first in range(0, pos.shape[0], 8):
        launch = bit[first : first + 8]
        width = launch.shape[0]
        size = np.where(lengths < 32, width if group == 0 else min(group, width), 4)
        clear = np.where((~launch).any(0), (~launch).argmax(0), width)  # the launch's first clear seed
        open_ = answers.copy()  # a later launch skips what an earlier one decided
        finishes += int(np.minimum(width, (clear // size + 1) * size)[open_].sum())
        answers &= ~(open_ & (clear < width))
    return answers, finishes


@pytest.mark.parametrize("m_bits", M_BITS)
@pytest.mark.parametrize("seeds", SEED_SETS, ids=lambda s: f"k{len(s)}")
def test_build_replay_equals_plain_and_jax(split, digests, plain, seeds, m_bits):
    inserted, _ = split
    want = plain(seeds, m_bits)[0]
    np.testing.assert_array_equal(replay_build(positions(digests("inserted", seeds), m_bits), m_bits), want)
    if m_bits == M_BITS[-1]:
        np.testing.assert_array_equal(np.asarray(JF._bloom_build(_layout(inserted), seeds, m_bits)), want)


@pytest.mark.parametrize("group", [1, QUERY_GROUP, 0], ids=["a-seed-a-test", "the-package's", "all"])
@pytest.mark.parametrize("m_bits", M_BITS[::2])
@pytest.mark.parametrize("seeds", SEED_SETS, ids=lambda s: f"k{len(s)}")
def test_grouped_query_replay_equals_plain_and_jax(split, digests, plain, seeds, m_bits, group):
    inserted, held = split
    k = len(seeds)
    words, answers = plain(seeds, m_bits)
    for which, probe in (("inserted", inserted), ("held", held)):
        want = answers[which]
        if group == QUERY_GROUP and m_bits == M_BITS[-1] and which == "held":  # the inserted: all true, below
            jax_words = JF._bloom_build(_layout(inserted), seeds, m_bits)
            np.testing.assert_array_equal(np.asarray(JF._bloom_query(jax_words, _layout(probe), seeds, m_bits)), want)
        lengths = np.array([len(t) for t in probe])
        got, finishes = replay_query(positions(digests(which, seeds), m_bits), lengths, words, group)
        np.testing.assert_array_equal(got, want)
        if which == "inserted":  # every probe of every inserted token: no false negative, nothing skipped
            assert want.all() and finishes == k * len(probe)
        else:
            assert finishes <= k * len(probe)


@pytest.mark.parametrize("seeds", SEED_SETS[1:], ids=lambda s: f"k{len(s)}")
def test_query_stops_at_the_first_clear_bit(split, digests, plain, seeds):
    """Held out against the suite's ~14 bits a key: a seed a test hashes
    fewer seeds than two, two fewer than all; an all-zero filter decides
    every token by its first group, and a later launch hashes none."""
    _, held = split
    m_bits = M_BITS[-1]
    lengths = np.array([len(t) for t in held])
    pos = positions(digests("held", seeds), m_bits)
    words = plain(seeds, m_bits)[0]
    hashed = {group: replay_query(pos, lengths, words, group)[1] for group in (1, 2, 0)}
    assert hashed[1] < hashed[2] < hashed[0] <= len(seeds) * len(held)
    got, finishes = replay_query(pos, lengths, np.zeros(m_bits // 32, np.uint32), QUERY_GROUP)
    assert not got.any() and finishes == int(np.where(lengths < 32, QUERY_GROUP, 4).sum())


def test_seed_array_is_built_once_a_seed_tuple():
    first = F._seed_array((1, 2, 3))
    assert F._seed_array((1, 2, 3)) is first and list(first) == [1, 2, 3]
    assert list(F._seed_array((2**64 - 1,))) == [2**64 - 1]
