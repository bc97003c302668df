"""The port's sample sort and batch-sharded rows on a world of 4 gloo ranks
on the CPU: ``argsort_sharded`` against ``argsort_tape`` and the JAX
``argsort_sharded`` on the 8-device CPU mesh (stability on duplicates, the
skewed fallback, ties past the 96-byte prefix), the similarities suite's
sharded scorer against the one-device scores and the JAX sharded scorer, a
sharded row whose staging fails on one rank (every rank skips it), and the
hash, fingerprints and memory suites' shares against their one-device calls
and the hash and fingerprints rows against the JAX rows' sharded calls.

The ranks run in ``_torch_dist_worker`` processes, which never import jax.
"""

import re

import numpy as np
import pytest
import torch
from _torch_dist_worker import World
from _torch_threads import one_thread  # noqa: F401
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JaxSpec

import jax
from stringwars_tpu.ops import fingerprint as JFP
from stringwars_tpu.ops import hash as JH
from stringwars_tpu.ops import similarity as JS
from stringwars_tpu.ops.sort import argsort_sharded as jax_argsort_sharded
from stringwars_tpu.parallel.mesh import DeviceScope as JaxScope
from stringwars_tpu.suites import hash as JHS
from stringwars_tpu.suites.similarities import make_sharded_scorer as jax_sharded_scorer
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu.tape import Tape as JaxTape
from stringwars_tpu_torch.ops import affine as A
from stringwars_tpu_torch.ops import fingerprint as FP
from stringwars_tpu_torch.ops import memops as M
from stringwars_tpu_torch.ops import myers as MY
from stringwars_tpu_torch.ops import similarity as S
from stringwars_tpu_torch.ops.sort import argsort_tape
from stringwars_tpu_torch.suites import hash as HS
from stringwars_tpu_torch.tape import PaddedTokens, Tape


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


def _words(rng, n: int) -> list[bytes]:
    words = [bytes(rng.integers(97, 110, rng.integers(1, 12), dtype=np.uint8)) for _ in range(n)]
    # Duplicates (stability) and long tokens that tie on the prefix (refinement).
    words[5] = words[17] = words[31] = b"dup"
    words[7] = b"z" * 200
    words[9] = b"z" * 200 + b"a"
    return words


def _jax_scope(ranks: int) -> JaxScope:
    return JaxScope(mesh=Mesh(np.array(jax.devices()[:ranks]), ("shard",)), chips=ranks)


def _jax_order(words: list[bytes], ranks: int) -> np.ndarray:
    return np.asarray(jax_argsort_sharded(JaxTape.from_tokens(words), _jax_scope(ranks)))


@pytest.mark.parametrize("ranks, n_tokens", [(2, 50), (3, 4096), (4, 50), (4, 4096)])
def test_argsort_sharded_matches_one_device_and_jax(world, ranks, n_tokens):
    words = _words(np.random.default_rng(n_tokens + ranks), n_tokens)
    results = world.run("sort", words, ranks=ranks)
    want = argsort_tape(Tape.from_tokens(words))
    for order, fell_back in results:
        np.testing.assert_array_equal(order, want)
        assert not fell_back
    np.testing.assert_array_equal(results[0][0], _jax_order(words, ranks))


def test_argsort_sharded_skewed_keys_fall_back_exact(world):
    """Every token shares its first three bytes (the first key column):
    every key goes to the last rank, its slots overflow on every rank, and
    the sort falls back, still exact."""
    rng = np.random.default_rng(44)
    words = [b"abc" + bytes(rng.integers(97, 123, 6, dtype=np.uint8)) for _ in range(2048)]
    results = world.run("sort", words)
    want = argsort_tape(Tape.from_tokens(words))
    for order, fell_back in results:
        np.testing.assert_array_equal(order, want)
        assert fell_back
    np.testing.assert_array_equal(results[0][0], _jax_order(words, 4))


def test_argsort_sharded_ties_past_the_prefix(world):
    """Tokens over 96 B that share their first 96 bytes, and one of exactly
    96 B, interleaved with short words: the host refinement orders them."""
    rng = np.random.default_rng(96)
    stem = bytes(rng.integers(97, 100, 96, dtype=np.uint8))
    long = [stem + bytes(rng.integers(97, 100, int(k), dtype=np.uint8)) for k in rng.integers(0, 40, 300)]
    words = long + [bytes(rng.integers(97, 100, int(k), dtype=np.uint8)) for k in rng.integers(1, 120, 700)]
    words = [words[i] for i in rng.permutation(len(words))]
    results = world.run("sort", words)
    want = np.asarray(sorted(range(len(words)), key=words.__getitem__))
    np.testing.assert_array_equal(argsort_tape(Tape.from_tokens(words)), want)
    for order, fell_back in results:
        np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(results[0][0], _jax_order(words, 4))


def _pairs(rng, n: int, lo: int, hi: int) -> list[bytes]:
    return [bytes(rng.integers(97, 103, int(rng.integers(lo, hi)), dtype=np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("n_pairs", [40, 41])
def test_sharded_scorer_matches_one_device(world, n_pairs):
    """Myers and Gotoh (global and local) scores over 2 ranks, the batch
    padded with empty pairs where it does not split evenly."""
    rng = np.random.default_rng(n_pairs)
    ta, tb = _pairs(rng, n_pairs, 1, 13), _pairs(rng, n_pairs, 0, 70)
    got = world.run("scores", ta, tb, ranks=2)
    np.testing.assert_array_equal(got[0]["myers"], got[1]["myers"])
    np.testing.assert_array_equal(got[0]["myers"], MY.myers_distances(MY.myers_from_tokens(ta, tb)).numpy())
    aligned = A.AffineBatch.from_pairs(S.pack_pairs(ta, tb))
    for key, local in (("nw", False), ("sw", True)):
        want = A.affine_scores(aligned, 2, -1, -5, -1, local=local).numpy()
        np.testing.assert_array_equal(got[0][key], want)
        np.testing.assert_array_equal(got[1][key], want)
    for i in range(min(n_pairs, 8)):
        assert got[0]["nw"][i] == S.nw_ref(list(ta[i]), list(tb[i]), match=2, mismatch=-1, go=-5, ge=-1)


@pytest.mark.parametrize("ranks", [3, 4])
def test_batch_sharded_rows_match_one_device(world, ranks):
    """The hash suite's stateless digests, the fingerprints suite's
    min-hashes and the memory suite's LUT and copy, rank by rank, put
    together in rank order, equal the one-device calls."""
    rng = np.random.default_rng(ranks)
    tokens = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in rng.integers(0, 90, 203)]
    data = rng.integers(0, 256, 5_003, dtype=np.uint8)
    shares = world.run("shares", tokens, data, ranks=ranks)
    tape = Tape.from_tokens(tokens)
    for op in HS.SPANS_ROWS:
        got = np.concatenate([s[op] for s in shares], axis=-1)
        np.testing.assert_array_equal(got, HS.spans_call(tape, op).numpy(), err_msg=op)
    padded = PaddedTokens.from_tape(tape)
    got = np.concatenate([s["minhash"] for s in shares])[: tape.count]
    np.testing.assert_array_equal(got, FP.fingerprint(padded, ndim=64)[0].numpy())
    lut = M.lut_translate(torch.from_numpy(data), torch.from_numpy(M.invert_case_lut())).numpy()
    np.testing.assert_array_equal(np.concatenate([s["lut"] for s in shares])[: data.size], lut)
    np.testing.assert_array_equal(np.concatenate([s["copy"] for s in shares])[: data.size], data)


@pytest.mark.parametrize("n_pairs", [40, 41])
def test_sharded_scorer_matches_jax_sharded_scorer(world, n_pairs):
    """The scores gathered over 2 ranks equal the JAX ``make_sharded_scorer``
    over a 2-device mesh: Levenshtein, and the Gotoh global and local
    scores (2/-1, open -5, extend -1), the batch padded to the mesh."""
    rng = np.random.default_rng(n_pairs)
    ta, tb = _pairs(rng, n_pairs, 1, 13), _pairs(rng, n_pairs, 0, 70)
    got = world.run("scores", ta, tb, ranks=2)[0]
    batch = JS.pack_pairs(ta, tb)
    for key, fn in (("myers", JS.levenshtein), ("nw", JS.nw_score_affine), ("sw", JS.sw_score_affine)):
        want = np.asarray(jax_sharded_scorer(_jax_scope(2), batch, fn)())[:n_pairs]
        np.testing.assert_array_equal(got[key], want, err_msg=key)


@pytest.mark.parametrize("failing_rank", [0, 1])
def test_sharded_row_skips_on_every_rank_when_one_cannot_stage(world, failing_rank):
    """One rank's staging of a sharded similarities row raises: every rank
    returns (none waits in the row's all-gather), rank 0 reports the row
    SKIPPED and records no scores, and the next sharded row scores on every
    rank."""
    rng = np.random.default_rng(7)
    ta, tb = _pairs(rng, 10, 1, 13), _pairs(rng, 10, 0, 30)
    results = world.run("stage_failure", ta, tb, failing_rank, ranks=2)
    lead = results[0][0]
    assert re.search(r"^uniform/swtorch::levenshtein<2cpu>\s+SKIPPED \(", lead, re.M), lead
    assert not re.search(r"levenshtein-after<2cpu>\s+SKIPPED", lead), lead
    assert results[1][0] == ""  # rank 0 alone reports
    want = MY.myers_distances(MY.myers_from_tokens(ta, tb)).numpy()
    for _, scores in results:
        assert set(scores) == {"after<2cpu>"}
        np.testing.assert_array_equal(scores["after<2cpu>"], want)


def _unsigned(digests: np.ndarray) -> np.ndarray:
    return digests.view(np.uint64) if digests.dtype == np.int64 else digests.astype(np.uint64)


@pytest.mark.parametrize("ranks", [3, 4])
def test_batch_sharded_rows_match_jax_sharded_rows(world, ranks):
    """The hash suite's swh64, xxh64 and xxh32 shares and the fingerprints
    suite's min-hashes (ndim 64), put together in rank order, equal the JAX
    rows' calls over a mesh of as many devices: the hash suite's
    ``build_layouts`` (length buckets padded to the mesh and sharded), and
    ``fingerprint`` over the token rows padded to the mesh and sharded on
    the leading axis."""
    rng = np.random.default_rng(ranks)
    tokens = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in rng.integers(0, 90, 203)]
    data = rng.integers(0, 256, 5_003, dtype=np.uint8)
    shares = world.run("shares", tokens, data, ranks=ranks)
    scope = _jax_scope(ranks)
    lengths = np.array([len(t) for t in tokens])
    nonempty = np.flatnonzero(lengths)
    bucket_order = nonempty[np.argsort(np.searchsorted(JHS.BUCKET_EDGES, lengths[nonempty]), kind="stable")]
    layouts = JHS.build_layouts(JaxTape.from_tokens(tokens), scope)
    for op, fn in (("swh64", lambda l: JH.swh64(l, 0)), ("xxh64", JH.xxh64), ("xxh32", JH.xxh32)):
        outs = [fn(layout) for layout, _, _ in layouts]
        want = np.concatenate([(o.to_numpy() if hasattr(o, "to_numpy") else np.asarray(o))[:count]
                               for o, (_, count, _) in zip(outs, layouts)])
        got = np.concatenate([s[op] for s in shares])[bucket_order]
        np.testing.assert_array_equal(_unsigned(got), want.astype(np.uint64), err_msg=op)
    padded = JaxPaddedTokens.from_tape(JaxTape.from_tokens(tokens))
    rows = -(-len(tokens) // ranks) * ranks
    pad = rows - len(tokens)
    sharded = JaxPaddedTokens(
        data=jax.device_put(np.pad(np.asarray(padded.data), ((0, pad), (0, 0))),
                            NamedSharding(scope.mesh, JaxSpec("shard", None))),
        lengths=jax.device_put(np.pad(np.asarray(padded.lengths), (0, pad)), NamedSharding(scope.mesh, JaxSpec("shard"))),
        width=padded.width,
    )
    want = np.asarray(jax.jit(lambda t: JFP.fingerprint(t, ndim=64))(sharded)[0])
    np.testing.assert_array_equal(np.concatenate([s["minhash"] for s in shares]), want)
