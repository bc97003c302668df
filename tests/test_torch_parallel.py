"""The port's parallel layer on a world of 4 gloo ranks on the CPU: the
sharded pipeline step against the JAX ``make_sharded_step`` on the 8-device
CPU mesh and against the port's one-device step, bit for bit; the seams of
the sharded find, byteset and Aho-Corasick counts; the find suite's
``<Ngpu>`` rows; scope naming; and the scaling suite in the world.

The ranks run in ``_torch_dist_worker`` processes, which never import jax;
the JAX side and the one-device side run here.
"""

import re

import numpy as np
import pytest
import torch
from _torch_dist_worker import World
from _torch_threads import one_thread  # noqa: F401
from jax.sharding import Mesh

import jax
from stringwars_tpu.parallel.pipeline import _pipeline_inputs, make_sharded_step as jax_step
from stringwars_tpu.parallel.pipeline import demo_inputs as jax_demo_inputs
from stringwars_tpu.ops import ahocorasick as JAC
from stringwars_tpu_torch.ops import ahocorasick as AC
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.parallel import distributed
from stringwars_tpu_torch.parallel import pipeline as P
from stringwars_tpu_torch.parallel.mesh import DeviceScope, scope_variants
from stringwars_tpu_torch.suites import find as FS
from stringwars_tpu_torch.tape import Tape

CPU = torch.device("cpu")
ONE = DeviceScope(CPU)
SHARDED = ("digests_lo", "minhash", "bpe_ids", "translated")
REDUCED = ("matches", "ac_matches", "digest_checksum", "bpe_tokens")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def fresh_reference_cache():
    """The JAX package caches an automaton's rules and LUTs by ``id()`` (F2):
    each test starts with that cache empty."""
    JAC._flat_rules_cache().clear()


def _gathered(results) -> dict:
    """The ranks' step outputs: the reduced counts (equal on every rank,
    checked) and the sharded outputs concatenated in rank order."""
    outs = [r[0] if isinstance(r, tuple) else r for r in results]
    for key in REDUCED:
        assert len({int(o[key]) for o in outs}) == 1, key
    merged = {key: int(outs[0][key]) for key in REDUCED}
    merged.update({key: np.concatenate([o[key] for o in outs]) for key in SHARDED})
    return merged


def _assert_equal_outputs(got: dict, want: dict) -> None:
    for key in REDUCED:
        assert int(got[key]) == int(want[key]), key
    for key in SHARDED:
        np.testing.assert_array_equal(np.asarray(got[key]).astype(np.int64), np.asarray(want[key]).astype(np.int64),
                                      err_msg=key)


def _one_device(inputs) -> dict:
    out = P.make_sharded_step(ONE)(inputs)
    return {k: (int(v) if v.dim() == 0 else v.numpy()) for k, v in out.items()}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_step_matches_jax_and_one_device(world, ranks):
    got = _gathered(world.run("step", ranks=ranks))
    mesh = Mesh(np.array(jax.devices()[:ranks]), ("shard",))
    inputs, ac_n, ac_chunk = jax_demo_inputs(mesh)
    want = jax.block_until_ready(jax_step(mesh, ac_n=ac_n, ac_chunk=ac_chunk)(*inputs))
    _assert_equal_outputs(got, {k: np.asarray(v) for k, v in want.items()})
    _assert_equal_outputs(got, _one_device(P.demo_inputs(ONE, ranks)))
    assert got["matches"] > 0 and got["ac_matches"] > 0 and got["bpe_tokens"] > 0


def test_sharded_step_counts_across_seams(world):
    """Matches of the needle and of AC patterns of 2..5 bytes placed across
    every seam of the AC corpus' shards (its length not a multiple of 512),
    one lying wholly in the bytes a rank reads past its chunk, and of the
    needle across each haystack row's chunk and halo: the step's counts
    equal the JAX step's and a host count of the whole corpus."""
    ranks = 4
    rng = np.random.default_rng(11)
    patterns = (b"ab", b"bca", b"cabc", b"abcab")
    n = 4 * 1024 + 1000  # shards of 1,536 B: seams at 1,536, 3,072, 4,608
    data = rng.choice(np.frombuffer(b"abc", np.uint8), n)
    for seam in (1536, 3072, 4608):
        for k, p in enumerate(patterns):
            at = seam - 1 - k % (len(p) - 1)
            data[at : at + len(p)] = np.frombuffer(p, np.uint8)
        data[seam - 2 : seam + 3] = np.frombuffer(b"abcab", np.uint8)  # "ab" at seam + 1: in the next rank's chunk
    chunk, pad = 1024, 4 * P.NEEDLE_CAP + 8
    buf = np.zeros(ranks * chunk + pad, np.uint8)
    buf[: ranks * chunk] = data[: ranks * chunk]
    for r in range(1, ranks):
        buf[r * chunk - 2 : r * chunk + 2] = np.frombuffer(b"abab", np.uint8)
    hay = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(buf, chunk + pad)[::chunk][:ranks])
    tokens = rng.integers(97, 123, (ranks * 4, 32), dtype=np.uint8)
    lengths = rng.integers(1, 32, ranks * 4, dtype=np.int32)
    got = _gathered(world.run("step_arrays", hay, data, tokens, lengths, b"abab", patterns, ranks=ranks))
    mesh = Mesh(np.array(jax.devices()[:ranks]), ("shard",))
    inputs, _, ac_n, ac_chunk = _pipeline_inputs(mesh, data, tokens, lengths, needle=b"abab", ac_patterns=patterns)
    want = jax_step(mesh, ac_n=ac_n, ac_chunk=ac_chunk)(jax.device_put(hay), *inputs)
    _assert_equal_outputs(got, {k: np.asarray(v) for k, v in want.items()})
    assert got["matches"] == len(re.findall(b"(?=abab)", buf[: ranks * chunk].tobytes()))
    assert got["ac_matches"] == AC.Automaton(list(patterns)).count_host(data)


def test_dryrun_multichip(world):
    counts = world.run("dryrun")
    assert all(c == counts[0] for c in counts)
    assert counts[0]["matches"] > 0 and counts[0]["ac_matches"] > 0


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_find_byteset_and_ac_exact_across_seams(world, ranks):
    """A corpus of 10,007 B (not a multiple of 512); needles of 2, 8 and 61
    B and AC patterns of 1..9 B cut from it across every seam of its shards
    (a pattern also wholly in the bytes a rank reads past its chunk, and a
    needle at the corpus' end): the sharded counts and last offsets equal
    the one-device ones."""
    rng = np.random.default_rng(ranks)
    n = 10_007
    chunk = (-(-n // ranks) + 511) // 512 * 512
    data = rng.choice(np.frombuffer(b"abcd", np.uint8), n)
    seams = [r * chunk for r in range(1, ranks) if r * chunk < n]
    cut = lambda lo, hi: data[lo:hi].tobytes()  # noqa: E731
    needles = list(dict.fromkeys([cut(s - a, s + b) for s in seams for a, b in ((1, 1), (3, 5), (60, 1))] + [cut(n - 2, n)]))
    patterns = tuple(dict.fromkeys(cut(s + a, s + b) for s in seams for a, b in ((0, 1), (-1, 1), (-2, 3), (1, 3), (-4, 5))))
    finds, counts, bytesets = world.run("seam_counts", data, needles, patterns, ranks=ranks)[0]
    hay = torch.from_numpy(data)
    for needle, (count, rcount, last) in zip(needles, finds):
        batch = F.NeedleBatch.from_needles([F.pack_needle(needle, FS.SHARDED_CAP)])
        want_count, want_last = F.rfind_count_batch(hay, batch)[0]
        assert (count, rcount, last) == (want_count, want_count, want_last), needle
        assert want_count == len(re.findall(b"(?=" + re.escape(needle) + b")", data.tobytes()))
    one = [AC.Automaton(list(patterns)).count_host(data)]
    one += [len(re.findall(b"(?=" + re.escape(p) + b")", data.tobytes())) for p in patterns]
    assert counts == one
    assert bytesets == dict(zip(FS.BYTESETS, F.byteset_counts(hay, [F.pack_byteset(cs) for cs in FS.BYTESETS.values()])))


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_owned_counts_equal_jax(ranks):
    """Each rank's row of a corpus not a multiple of 512 (shard_bytes, an
    8 * cap halo): the owned-start count, last global offset and bounded
    byteset count equal the JAX ``_count_from_mask_sharded``,
    ``_count_last_from_mask_sharded`` and ``byteset_count_bounded``."""
    import jax.numpy as jnp
    from stringwars_tpu.ops import find as JF

    from stringwars_tpu_torch.parallel.sharding import shard_bytes

    rng = np.random.default_rng(30 + ranks)
    cap, n = 4, 5_003
    data = rng.choice(np.frombuffer(b"ab", np.uint8), n)
    table = F.pack_byteset(b"a")
    for needle in (b"ab", b"abab", b"babbabbabbaba"):
        packed = F.pack_needle(needle, cap)
        batch = F.NeedleBatch.from_needles([packed])
        jneedle = JF.pack_needle(needle, cap)
        for rank in range(ranks):
            row, _, chunk = shard_bytes(DeviceScope(CPU, gpus=ranks, rank=rank), data, overlap=8 * cap)
            lo, n_cmp = rank * chunk, row.numel() - (4 * cap - 3) + 1
            args = (jnp.asarray(row.numpy()), jneedle, n_cmp, jnp.int32(chunk), jnp.int32(lo), jnp.int32(n))
            want_count, want_last = JF._count_last_from_mask_sharded(*args)
            assert int(F.find_counts_owned(row, batch, chunk, lo, n)[0]) == int(JF._count_from_mask_sharded(*args))
            counts, lasts = F.rfind_counts_owned(row, batch, chunk, lo, n)
            assert (int(counts[0]), int(lasts[0])) == (int(want_count), int(want_last)), (needle, rank)
            want = JF.byteset_count_bounded(jnp.asarray(row.numpy()), jnp.asarray(table.numpy()), chunk, jnp.int32(lo),
                                            jnp.int32(n))
            assert int(F.byteset_counts_bounded(row, [table], chunk, lo, n)[0]) == int(want)


def test_find_suite_sharded_rows(world):
    """The find suite's <4cpu> routines (forward and backward counts, last
    offsets, byteset and aho_corasick) equal its one-device routines."""
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 101, int(k), dtype=np.uint8)) for k in rng.integers(1, 9, 3000)]
    words[5] = b"x" * 70  # longer than the sharded rows' cap: not among their needles
    words += [b"<a href='x'>", b"\t\n", b"0123"] * 20
    forward, backward, bytesets, multi = world.run("find_rows", words)[0]
    tape = Tape.from_tokens(words)
    assert set(forward) == set(FS.sharded_needles(tape)) and b"x" * 70 not in forward
    for needle, count in forward.items():
        batch = F.NeedleBatch.from_needles([F.pack_needle(needle, FS._needle_cap(needle))])
        assert count == F.find_count_batch(tape.data, batch)[0]
        assert backward[needle] == F.rfind_count_batch(tape.data, batch)[0]
    routine, want = FS.byteset_routine(tape)
    routine()
    assert bytesets == want
    routine, want = FS.aho_corasick_routine(tape)
    routine()
    assert multi == want


def test_scope_variants_and_names(world):
    for names, own in world.run("scopes"):
        assert names == ["<1cpu>", "<4cpu>"] and own == "<4cpu>"
    assert [names for names, _ in world.run("scopes", ranks=2)] == [["<1cpu>", "<4cpu>"]] * 2
    assert [s.name for s in scope_variants(CPU)] == ["<1cpu>"]
    assert DeviceScope(torch.device("cuda", 0), gpus=4).name == "<4gpu>"
    assert DeviceScope(torch.device("cuda", 0), gpus=8, hosts=2).name == "<2host>"
    assert DeviceScope(CPU, gpus=2).name == "<2cpu>"


def test_rank_without_card_raises(monkeypatch):
    """A rank asked for the card on a host without one raises, and joins no
    group: nothing carries on over gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("cuda", init_method="file:///nonexistent/store", rank=0, world_size=1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.maybe_initialize("cuda")
    assert not torch.distributed.is_initialized()


def test_scaling_suite_in_the_world(world):
    """``suites.scaling`` under 4 ranks: rank 0 reports the <1cpu> row and
    the <4cpu> row; the others print nothing."""
    argv = ["--device", "cpu", "--dataset-limit", "256kb", "--warmup", "0", "--time-limit", "0"]
    results = world.run("suite", "scaling", argv)
    lines = results[0][0]
    assert "pipeline/swtorch::sharded_step<1cpu>" in lines and "pipeline/swtorch::sharded_step<4cpu>" in lines
    assert "SKIPPED" not in lines
    assert results[0][1] == ["<1cpu>", "<4cpu>"] and set(results[0][2]) == {1, 4}
    assert all(out == "" and staged == {} for out, _, staged in results[1:])
