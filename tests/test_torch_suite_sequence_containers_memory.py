"""The port's sequence, containers and memory suites end to end on the CPU
(``--device cpu --dataset-limit 1mb``, zero time), their rows read back and
their results held to the JAX package and the host on the same corpus."""

import contextlib
import io

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import filters as JF
from stringwars_tpu.ops import hash as JH
from stringwars_tpu.ops import sort as JS
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.ops import memops as M
from stringwars_tpu_torch.suites import containers as containers_suite
from stringwars_tpu_torch.suites import memory as memory_suite
from stringwars_tpu_torch.suites import sequence as sequence_suite
from _torch_threads import one_thread  # noqa: F401

SEQUENCE_ROWS = [
    "argsort/swtorch::argsort<1cpu>", "argsort/sorted-key", "argsort/numpy.argsort",
    "argsort-uncased/swtorch::argsort_uncased<1cpu>", "argsort-uncased/sorted-casefold",
]
CONTAINERS_ROWS = [
    *[f"multihash/{bits}bit/{row}" for bits in (128, 256, 512, 1024)
      for row in ("swtorch::xxh64_multiseed<1cpu>", "xxhash.xxh3_128-per-seed")],
    "filters/swtorch::bloom-build<1cpu>", "filters/swtorch::bloom-query<1cpu>", "filters/swtorch::fuse8-build(host)",
    "filters/swtorch::fuse8-query<1cpu>",
]
MEMORY_ROWS = [
    "lookup-table/swtorch::lut_translate<1cpu>", "lookup-table/bytes.translate", "lookup-table/numpy.take",
    "generate-random/swtorch::fill_random<1cpu>", "generate-random/numpy.PCG64", "memset/swtorch::fill<1cpu>",
    "memcpy/swtorch::copy<1cpu>", "memmove/swtorch::move<1cpu>",
]


def _row(lines: list[str], row: str) -> str:
    hits = [line for line in lines if line.startswith(row + " ")]
    assert len(hits) == 1, (row, lines)
    assert "SKIPPED" not in hits[0] and "/s" in hits[0], hits[0]
    return hits[0]


def _run(main, corpus):
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = main(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "1mb"])
    mp.undo()
    return ctx, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def words_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "english-words.txt"
    path.write_bytes(datasets.synthesize("english-words", 1 << 20))
    return path


def test_sequence_suite(words_corpus):
    ctx, lines = _run(sequence_suite.main, words_corpus)
    for row in SEQUENCE_ROWS:
        _row(lines, row)
    assert [line for line in lines if line.startswith("# ")] == ["# argsort", "# argsort-uncased"]
    tokens = ctx.tape.to_list()
    order = ctx.staged["order"]
    assert order.tolist() == sorted(range(len(tokens)), key=tokens.__getitem__)
    jtape = jax_tape.Tape.from_tokens(tokens)
    np.testing.assert_array_equal(order, np.asarray(JS.argsort_tape(jtape)))
    jcols = JS._byte_columns(*(lambda p: (p.data, p.lengths))(jax_tape.PaddedTokens.from_tape(jtape, align=4, max_width=96)))
    np.testing.assert_array_equal(ctx.staged["columns"].numpy().astype(np.int64), np.asarray(jcols).astype(np.int64))
    data, key_lengths, n_cols, pack3 = ctx.staged["uncased"]
    assert pack3 and n_cols == -(-max(map(len, tokens)) // 3)  # ASCII words: three codepoints a column
    assert key_lengths.tolist() == list(map(len, tokens)) and data.shape[0] == len(tokens)
    uncased = ctx.staged["uncased_order"].tolist()
    assert uncased == sorted(range(len(tokens)), key=lambda i: tokens[i].decode().casefold())


def test_containers_suite(words_corpus, capfd):
    ctx, lines = _run(containers_suite.main, words_corpus)
    err = capfd.readouterr().err
    for row in CONTAINERS_ROWS:
        _row(lines, row)
    assert "conformance: multiseed == per-seed for 8 seeds" in err
    assert "bloom quality: FPR" in err and "FN 0.000%" in err and "binary-fuse quality: FPR" in err
    staged = ctx.staged
    tokens = staged["tape"].to_list()
    assert len(tokens) == len(set(tokens)) == len(set(ctx.tape.to_list()))
    cut = staged["inserted"].count
    assert cut == int(len(tokens) * 0.8)
    jins = JH.prepare(jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(tokens[:cut]), align=4))
    bloom = staged["bloom"]
    assert bloom.m_bits == containers_suite.bloom_bits(cut)
    np.testing.assert_array_equal(bloom.words.numpy(), np.asarray(JF._bloom_build(jins, bloom.seeds, bloom.m_bits)))
    np.testing.assert_array_equal(staged["ins_keys"], JH.xxh64(jins).to_numpy())
    fuse = JF.fuse_build(staged["ins_keys"])
    np.testing.assert_array_equal(staged["fuse"].fingerprints.numpy(), np.asarray(fuse.fingerprints))
    h, fp = staged["probes"]
    want = np.asarray(JF.fuse_query(fuse, staged["out_keys"]))
    from stringwars_tpu_torch.ops import filters as F

    np.testing.assert_array_equal(F.fuse_query_probes(staged["fuse"].fingerprints, h, fp).numpy(), want)
    assert staged["quality"]["fuse"] == int(want.sum()) / want.size


def test_memory_suite(tmp_path):
    path = tmp_path / "long-lines.txt"
    path.write_bytes(datasets.synthesize("long-lines", 1 << 20))
    ctx, lines = _run(memory_suite.main, path)
    for row in MEMORY_ROWS:
        _row(lines, row)
    assert not any("lut_planes" in line for line in lines)
    staged = ctx.staged
    data = staged["data"]
    assert data.numel() == ctx.tape.total_bytes > 1 << 19
    assert torch.equal(staged["copy"], data)
    assert torch.equal(staged["move"], M.move(data, memory_suite.SHIFT))
    assert torch.equal(staged["move"][:-8], data[8:]) and not staged["move"][-8:].any()
    assert bool((staged["fill"] == staged["fill_value"]).all())
    assert staged["lut"].numpy().tobytes() == data.numpy().tobytes().swapcase()
