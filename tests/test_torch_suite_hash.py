"""The port's hash and fingerprints suites end to end on the CPU
(``--device cpu``), against the JAX package on the same corpus file."""

import hashlib

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import fingerprint as JF
from stringwars_tpu.ops import hash as JH
from stringwars_tpu.ops import xxh3 as JX
from stringwars_tpu.ops.sha256 import prepare_sha256, sha256_digest_bytes
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops import sha256 as SHA
from stringwars_tpu_torch.ops import xxh3 as X3
from stringwars_tpu_torch.suites import fingerprints as fp_suite
from stringwars_tpu_torch.suites import hash as hash_suite
from _torch_threads import one_thread  # noqa: F401


HASH_ROWS = [
    "stateless/swtorch::swh64<1cpu>",
    "stateless/swtorch::xxh64<1cpu>",
    "stateless/swtorch::xxh32<1cpu>",
    "stateless/swtorch::swh64_multiseed8<1cpu>",
    "stateless/swtorch::xxh3_64<1cpu>",
    "stateless/xxhash.xxh3_64",
    "stateless/xxhash.xxh64",
    "stateless/builtins.hash",
    "stateful/swtorch::tree_hash64<1cpu>",
    "stateful/xxhash.xxh64_stream",
    "checksum/swtorch::bytesum<1cpu>",
    "checksum/swtorch::sha256<1cpu>",
    "checksum/zlib.crc32",
    "checksum/hashlib.sha256",
]


def _row(lines: list[str], row: str) -> str:
    hits = [line for line in lines if line.startswith(row + " ")]
    assert len(hits) == 1, (row, lines)
    assert "SKIPPED" not in hits[0] and "/s" in hits[0], hits[0]
    return hits[0]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "english-words.txt"
    path.write_bytes(datasets.synthesize("english-words", 256 << 10))
    return path


@pytest.fixture(scope="module")
def hash_run(corpus):
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = hash_suite.main(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "256kb"])
    mp.undo()
    return ctx, out.getvalue().splitlines()


def test_hash_suite_prints_every_row(hash_run):
    _, lines = hash_run
    for row in HASH_ROWS:
        _row(lines, row)
    assert [line for line in lines if line.startswith("# ")] == ["# stateless", "# stateful", "# checksum"]


def test_hash_suite_buckets_give_jax_digests(hash_run, corpus):
    ctx, _ = hash_run
    staged = ctx.staged
    ref_tape = jax_tape.Tape.from_buffer(corpus.read_bytes(), "words")
    ref = jax_tape.bucket_by_length(ref_tape, hash_suite.BUCKET_EDGES)
    assert [b.width for b in staged.buckets] == [b.width for b in ref]
    assert staged.tokens == ctx.tape.count and staged.token_bytes == ctx.tape.total_bytes
    first = ref_tape.to_list()[:64]
    first_tape = jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(first))
    idx, swh = staged.digests(H.swh64)
    assert list(idx[:64]) == list(range(64))
    np.testing.assert_array_equal(swh[:64], JH.swh64(first_tape, 0).to_numpy().astype(np.uint64))
    _, xxh = staged.digests(H.xxh64)
    np.testing.assert_array_equal(xxh[:64], JH.xxh64(first_tape).to_numpy().astype(np.uint64))


def test_hash_suite_spans_rows_give_jax_digests(hash_run, corpus):
    """The four stateless rows hash the tape's tokens where they lie: each
    row's digests, by token index, equal the JAX package's over its own
    buckets of the same corpus (swh64_multiseed8: its 8 seeds)."""
    ctx, _ = hash_run
    ref = jax_tape.bucket_by_length(jax_tape.Tape.from_buffer(corpus.read_bytes(), "words"), hash_suite.BUCKET_EDGES)
    want = {
        "swh64": lambda b: JH.swh64(b, 0).to_numpy().astype(np.uint64),
        "xxh64": lambda b: JH.xxh64(b).to_numpy().astype(np.uint64),
        "xxh32": lambda b: np.asarray(JH.xxh32(b)).astype(np.uint32),
        "swh64_multiseed8": lambda b: JH.swh64_multiseed(b, np.array(hash_suite.MULTISEEDS, np.uint64)).to_numpy().astype(np.uint64),
    }
    for op, jax_fn in want.items():
        row = hash_suite.spans_call(ctx.tape, op).numpy()
        assert row.shape[-1] == ctx.tape.count
        for idx, bucket in zip(ctx.staged.indices, ref):
            np.testing.assert_array_equal(row[..., idx.numpy()], jax_fn(bucket), err_msg=op)


def test_hash_suite_tree_row_matches_jax(hash_run, corpus):
    ctx, _ = hash_run
    raw = np.frombuffer(corpus.read_bytes(), np.uint8)
    ref_tape = jax_tape.Tape.from_buffer(raw.tobytes(), "words")
    hay = np.asarray(ref_tape.data)[: ref_tape.total_bytes]
    assert H.tree_hash64(ctx.tape.data, ctx.tape.total_bytes) == JH.tree_hash64(hay)


def test_hash_suite_sha256_row_matches_hashlib_and_jax(hash_run, corpus):
    """The sha256 row's buckets: every token's digest equals hashlib's, and
    the first bucket's the JAX package's over its own bucket."""
    ctx, _ = hash_run
    idx, digests = ctx.staged.digests(SHA.sha256)
    tokens = ctx.tape.to_list()
    assert list(idx) == list(range(len(tokens)))
    got = SHA.digest_bytes(torch.from_numpy(digests))
    for i in range(0, len(tokens), 7):
        assert got[i].tobytes() == hashlib.sha256(tokens[i]).digest()
    ref = jax_tape.bucket_by_length(jax_tape.Tape.from_buffer(corpus.read_bytes(), "words"), hash_suite.BUCKET_EDGES)[0]
    np.testing.assert_array_equal(SHA.digest_bytes(SHA.sha256(ctx.staged.buckets[0])), sha256_digest_bytes(prepare_sha256(ref)))


def test_hash_suite_xxh3_row_matches_wheel_and_jax(hash_run, corpus):
    """The xxh3_64 row hashes the tape's tokens where they lie: every
    token's digest, by token index, equals the xxhash wheel's and the
    bucketed call's, and the first bucket's tokens the JAX package's over
    its own bucket (run without jit: the same function op by op)."""
    import jax
    import xxhash

    ctx, _ = hash_run
    row = hash_suite.spans_call(ctx.tape, "xxh3_64").numpy()
    tokens = ctx.tape.to_list()
    np.testing.assert_array_equal(row, np.array([xxhash.xxh3_64_intdigest(t) for t in tokens], dtype=np.uint64))
    idx, digests = ctx.staged.digests(X3.xxh3_64)
    assert list(idx) == list(range(len(tokens)))
    np.testing.assert_array_equal(row[idx], digests)
    ref = jax_tape.bucket_by_length(jax_tape.Tape.from_buffer(corpus.read_bytes(), "words"), hash_suite.BUCKET_EDGES)[0]
    with jax.disable_jit():
        want = JX.xxh3_hash(ref).to_numpy().astype(np.uint64)
    np.testing.assert_array_equal(row[ctx.staged.indices[0].numpy()], want)


def test_collision_audit(corpus, monkeypatch, capsys):
    monkeypatch.setenv("SWTPU_TIME", "0")
    monkeypatch.setenv("SWTPU_WARMUP", "0")
    monkeypatch.setenv("SWTPU_COLLISIONS", "1")
    monkeypatch.setenv("SWTPU_FILTER", "checksum/zlib")
    hash_suite.main(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "64kb"])
    err = capsys.readouterr().err
    assert "collisions: 0 over " in err


def test_fingerprints_suite_prints_every_row(monkeypatch, capsys, tmp_path):
    path = tmp_path / "long-lines.txt"
    path.write_bytes(datasets.synthesize("long-lines", 64 << 10))
    monkeypatch.setenv("SWTPU_TIME", "0")
    monkeypatch.setenv("SWTPU_WARMUP", "0")
    monkeypatch.setenv("SWTPU_NDIM_SCALES", "16,64")
    monkeypatch.setenv("SWTPU_BATCH_PER_CORE", "24")
    ctx = fp_suite.main(["--device", "cpu", "--dataset", str(path), "--dataset-limit", "64kb"])
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    for ndim in (16, 64):
        _row(lines, f"minhash/ndim_{ndim}/swtorch::fingerprint<1cpu>")
        _row(lines, f"minhash/ndim_{ndim}/numpy-replay")
        assert f"quality ndim_{ndim}: bit-entropy " in captured.err
    tokens = ctx.staged["tokens"]
    assert tokens.count == min(24, ctx.tape.count)
    ref = jax_tape.PaddedTokens.from_tape(
        jax_tape.Tape.from_buffer(path.read_bytes(), "lines").subtape(0, tokens.count), max_width=4096
    )
    want, _ = JF.fingerprint_xla(ref, ndim=64)
    np.testing.assert_array_equal(ctx.staged["min_hashes"][64], np.asarray(want))
    entropy, collisions = ctx.staged["quality"][64]
    assert entropy == JF.bit_entropy(np.asarray(want)) and collisions == JF.collision_rate(np.asarray(want))


@pytest.mark.parametrize("suite", [hash_suite, fp_suite], ids=["hash", "fingerprints"])
def test_suite_main_without_a_card_stops(suite, corpus, capsys):
    """Without ``--device cpu`` a suite runs on the card, and a host with no
    card stops with an error instead of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as stop:
        suite.main(["--dataset", str(corpus), "--dataset-limit", "64kb"])
    assert stop.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
