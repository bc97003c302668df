"""The port's bit-parallel Myers Levenshtein against the JAX Pallas kernel.

The same pairs go through the JAX staging and ``myers_distances(...,
interpret=True)`` and through the port's staging and ``myers_plain`` (the
plain version of the CUDA kernel in ``csrc/myers.cu``). Distances are
integers: every comparison is exact. Interpret mode costs 10-25 s per
distinct shape, so each alphabet is one staged batch, computed once.
"""

import numpy as np
import pytest
import torch

from stringwars_tpu.ops import myers_pallas as JM
from stringwars_tpu_torch.ops import myers as M
from stringwars_tpu_torch.ops import myers_cuda
from stringwars_tpu_torch.ops import similarity as S


def _byte_pairs():
    """The cases of tests/test_myers.py plus the 32- and 64-row word edges
    and empty sides."""
    rng = np.random.default_rng(42)
    a_tokens = [b"kitten", b"flaw", b"abc", b"", b"same", b"a", b""]
    b_tokens = [b"sitting", b"lawn", b"abc", b"xyz", b"same", b"", b""]
    pool = np.frombuffer(b"abcd", np.uint8)
    for m in [1, 31, 32, 33, 63, 64, 65, 100, 129]:
        for n in (0, 1, int(rng.integers(2, 49))):
            a_tokens.append(rng.choice(pool, m).tobytes())
            b_tokens.append(rng.choice(pool, n).tobytes())
    for _ in range(24):
        a_tokens.append(bytes(rng.integers(0, 256, int(rng.integers(0, 101)), dtype=np.uint8)))
        b_tokens.append(bytes(rng.integers(0, 256, int(rng.integers(0, 49)), dtype=np.uint8)))
    return a_tokens, b_tokens


def _codepoint_pairs():
    rng = np.random.default_rng(3)
    a = [np.array([ord(c) for c in s], np.int32) for s in ("héllo", "\U00010400a", "\U0001F600\U0001F601\U0001F602", "")]
    b = [np.array([ord(c) for c in s], np.int32) for s in ("hallo", "\U00010400b", "\U0001F600\U0001F602", "xy")]
    for m in (1, 40, 70):
        x = rng.integers(0, 0x110000, m).astype(np.int32)
        y = np.concatenate([x[: m // 2], rng.integers(0x1F600, 0x1F604, 9)]).astype(np.int32)
        a.append(x)
        b.append(y)
    return a, b


def _dna_pairs():
    """More than 1024 short pairs: the compressed path over more than one
    JAX tile (tests/test_myers.py:52-57)."""
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = [acgt[rng.integers(0, 4, 9)].tobytes() for _ in range(1100)]
    b = [acgt[rng.integers(0, 4, int(rng.integers(0, 12)))].tobytes() for _ in range(1100)]
    return a, b


@pytest.fixture(scope="module")
def staged():
    """(name, tokens, JAX batch, port batch, JAX distances) per alphabet."""
    out = {}
    a, b = _byte_pairs()
    out["bytes"] = (a, b, JM.myers_from_tokens(a, b), M.myers_from_tokens(a, b))
    a, b = _codepoint_pairs()
    out["codepoints"] = (a, b, JM.myers_from_codepoints(a, b), M.myers_from_codepoints(a, b))
    a, b = _dna_pairs()
    out["dna"] = (a, b, JM.myers_from_tokens(a, b), M.myers_from_tokens(a, b))
    return {k: (*v, JM.myers_distances(v[2], interpret=True)) for k, v in out.items()}


@pytest.mark.parametrize("alphabet", ["bytes", "codepoints", "dna"])
def test_plain_matches_pallas_kernel_and_oracle(staged, alphabet):
    a, b, _, port, want = staged[alphabet]
    got = M.myers_plain(port)
    assert got.dtype == torch.int32 and got.shape == (len(a),)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(M.myers_distances(port).numpy(), want)
    oracle = [S.levenshtein_ref(list(x), list(y)) for x, y in zip(a[:200], b[:200])]
    np.testing.assert_array_equal(got.numpy()[:200], oracle)


@pytest.mark.parametrize("alphabet", ["bytes", "codepoints", "dna"])
def test_staging_matches_jax_bitplanes(staged, alphabet):
    """The port's 64-bit words hold the JAX package's pairs of 32-bit words
    (the high half past the JAX words is padding: sentinel plane only), and
    its text columns are the JAX ones."""
    a, _, ref, port, _ = staged[alphabet]
    B = len(a)
    assert port.nbits == ref.nbits and port.count == B
    n_bt, nbits, w32 = ref.bp.shape[:3]
    jw = np.asarray(ref.bp).reshape(n_bt, nbits, w32, JM.TILE).transpose(0, 3, 1, 2).reshape(-1, nbits, w32)[:B]
    words = port.planes.numpy().view(np.uint64).transpose(2, 1, 0)  # [B, nbits, W64]
    assert words.shape[2] == -(-w32 // 2)
    low = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    high = (words >> np.uint64(32)).astype(np.uint32)
    np.testing.assert_array_equal(low, jw[:, :, 0::2])
    np.testing.assert_array_equal(high[:, :, : w32 // 2], jw[:, :, 1::2])
    if w32 % 2:
        pad = np.zeros(nbits, np.uint32)
        pad[-1] = 0xFFFFFFFF
        np.testing.assert_array_equal(high[:, :, -1], np.broadcast_to(pad, (B, nbits)))
    lp = ref.b_cols.shape[1]
    cols = np.asarray(ref.b_cols).reshape(n_bt, lp, JM.TILE).transpose(1, 0, 2).reshape(lp, -1)
    np.testing.assert_array_equal(port.text.numpy(), cols[: port.text.shape[0], :B])
    np.testing.assert_array_equal(port.a_len.numpy(), ref._np_alen)
    np.testing.assert_array_equal(port.b_len.numpy(), ref._np_blen)
    assert port.cells() == ref.cells()


def test_small_alphabets_compress(staged):
    assert staged["dna"][3].nbits == 4  # A, C, G, T and the zero padding of b
    assert staged["bytes"][3].nbits == M.BYTE_BITS
    assert staged["codepoints"][3].nbits == M.CP_BITS
    uniform = M.myers_from_tokens([b"ACGT" * 20] * 3, [b"TGCA" * 20] * 3)
    assert uniform.nbits == 3  # four symbols, no padding
    np.testing.assert_array_equal(M.myers_plain(uniform).numpy(), [S.levenshtein_ref(b"ACGT" * 20, b"TGCA" * 20)] * 3)


def test_plain_matches_the_wavefront_on_long_patterns():
    """Patterns past 256 rows (several 64-bit words, more than one of the
    kernel's bands) against the port's anti-diagonal levenshtein."""
    rng = np.random.default_rng(1)
    a = [bytes(rng.integers(97, 101, m, dtype=np.uint8)) for m in (255, 256, 257, 300, 130)]
    b = [bytes(rng.integers(97, 101, n, dtype=np.uint8)) for n in (40, 256, 3, 301, 0)]
    got = M.myers_plain(M.myers_from_tokens(a, b)).numpy()
    np.testing.assert_array_equal(got, S.levenshtein(S.pack_pairs(a, b)).numpy())


def test_cuda_wrapper_refuses_cpu_batches(staged):
    port = staged["dna"][3]
    before = dict(myers_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        myers_cuda.myers(port)
    assert myers_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        M.MyersBatch.from_arrays(np.zeros((1, 1)), np.zeros((1, 1)), [1], [1], nbits=7)


# The lane-group kernel's schedules (csrc/myers.cu, M.schedule,
# M.myers_lanes_plain): lanes of 32-bit words or of several 64-bit words, a
# skewed wavefront, hp/hn passed lane to lane, bands past a group's rows.
EDGES = (0, 1, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257, 1023, 1024, 1025)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the schedule's emulation runs
    thousands of small steps, and under the parallel test run a step split
    over every core's threads waits on all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def edges():
    """alphabet -> (tokens, port batch, JAX distances) over every pair of
    lengths |a|, |b| in EDGES."""
    rng = np.random.default_rng(11)
    pairs = [(m, n) for m in EDGES for n in EDGES]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    cps_a = [rng.integers(0, 0x110000, m).astype(np.int32) for m, _ in pairs]
    sets = {
        "bytes": ([bytes(rng.integers(0, 256, m, dtype=np.uint8)) for m, _ in pairs],
                  [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for _, n in pairs]),
        "dna": ([acgt[rng.integers(0, 4, m)].tobytes() for m, _ in pairs],
                [acgt[rng.integers(0, 4, n)].tobytes() for _, n in pairs]),
        "codepoints": (cps_a, [np.concatenate([x[: n // 2], rng.integers(0x1F600, 0x1F604, n)])[:n].astype(np.int32)
                               for x, (_, n) in zip(cps_a, pairs)]),
    }
    out = {}
    for name, (a, b) in sets.items():
        stage_jax = JM.myers_from_codepoints if name == "codepoints" else JM.myers_from_tokens
        out[name] = (a, b, _stage(name, a, b), JM.myers_distances(stage_jax(a, b), interpret=True))
    return pairs, out


def _stage(alphabet, a, b):
    return (M.myers_from_codepoints if alphabet == "codepoints" else M.myers_from_tokens)(a, b)


def _short(edges, alphabet, rows=257):
    """The port batch of the edge pairs of up to ``rows`` rows and 257
    columns, and their JAX distances."""
    pairs, sets = edges
    a, b, _, want = sets[alphabet]
    keep = [i for i, (m, n) in enumerate(pairs) if m <= rows and n <= 257]
    return _stage(alphabet, [a[i] for i in keep], [b[i] for i in keep]), want[keep]


@pytest.mark.parametrize("alphabet", ["bytes", "dna", "codepoints"])
def test_lanes_schedule_matches_pallas_and_plain_at_lane_and_band_edges(edges, alphabet):
    """A warp of 32-bit lanes a pair (the longest pattern, 1,025 rows, takes
    33 words: a second band), pairs of every edge length sharing groups,
    against the JAX kernel; and, with ``myers_plain``, the pairs of up to
    257 rows and columns (``myers_plain`` at 1,025 x 1,025 alone would take
    as long as the rest of the file)."""
    _, sets = edges
    _, _, port, want = sets[alphabet]
    assert M.schedule(port.count, int(port.host_a_len.max()), port.nbits, 132) == (32, 1, 32)
    got = M.myers_lanes_plain(port)
    assert got.dtype == torch.int32 and got.shape == (port.count,)
    np.testing.assert_array_equal(got.numpy(), want)
    short, short_want = _short(edges, alphabet)
    plain = M.myers_plain(short).numpy()
    np.testing.assert_array_equal(plain, short_want)
    np.testing.assert_array_equal(M.myers_lanes_plain(short, (32, 1, 8)).numpy(), plain)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_lanes_schedule_at_each_group_size(edges, group):
    """32-bit lanes in groups narrower than the patterns' words go on in
    bands (1 lane: a band a word), on the byte pairs of up to 100 rows."""
    port, want = _short(edges, "bytes", rows=100)
    np.testing.assert_array_equal(M.myers_lanes_plain(port, (32, 1, group)).numpy(), want)


@pytest.mark.parametrize("alphabet,plan", [("bytes", (64, 4, 1)), ("dna", (64, 4, 2)), ("codepoints", (64, 2, 1))])
def test_lanes_schedule_with_words_a_lane(edges, alphabet, plan):
    """The schedule of batches that fill the card: 64-bit lane words, 4 a
    lane (2 at codepoints), lanes whose words a pattern fills only in part,
    and bands of 1 or 2 lanes (257 rows: 5 words)."""
    port, want = _short(edges, alphabet)
    np.testing.assert_array_equal(M.myers_lanes_plain(port, plan).numpy(), want)


def test_schedule_follows_the_batch():
    """One 32-bit word a lane while the batch's words fit 1,024 threads an
    SM (the similarities suite's 4,096 pairs of 100 B), else 64-bit words,
    4 a lane (2 at codepoints): the published shapes' plans on an H100."""
    cases = {0: 1, 1: 1, 32: 1, 33: 2, 64: 2, 65: 4, 100: 4, 128: 4, 129: 8, 256: 8, 257: 16, 512: 16, 513: 32,
             1024: 32, 1025: 32, 5000: 32}
    assert {m: M.lane_group(m) for m in cases} == cases
    assert M.schedule(4096, 100, 3, 132) == (32, 1, 4)
    assert M.schedule(4096, 100, M.CP_BITS, 132) == (32, 1, 4)
    assert M.schedule(65536, 256, M.BYTE_BITS, 132) == (64, 4, 1)
    assert M.schedule(33856, 1023, 3, 132) == (64, 4, 4)
    assert M.schedule(33856, 1023, M.CP_BITS, 132) == (64, 2, 8)
    assert M.schedule(132 * 1024 // 4, 100, 3, 132) == (32, 1, 4)
    assert M.schedule(132 * 1024 // 4 + 1, 100, 3, 132) == (64, 4, 1)
