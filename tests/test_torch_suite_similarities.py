"""The port's similarities suite end to end on the CPU (``--device cpu``),
against the JAX package on the same corpus file.

Both sides read one corpus file, so they build the same cross-product. The
scores the suite's rows computed (kept in ``ctx.staged``) must equal the
JAX functions on the same pairs; they are integers, so exactly.
"""

import contextlib
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import similarity as JS
from stringwars_tpu.suites import similarities as jax_suite
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.suites import similarities as suite
from _torch_threads import one_thread  # noqa: F401


BAND = 4
ROWS = [
    "uniform/swtorch::levenshtein<1cpu>",
    "uniform-utf8/swtorch::levenshtein<1cpu>",
    f"uniform-banded{BAND}/swtorch::levenshtein<1cpu>",
    "uniform/python-dp-diagonal",
    "linear/swtorch::needleman_wunsch<1cpu>",
    "linear/swtorch::smith_waterman<1cpu>",
    "affine/swtorch::needleman_wunsch<1cpu>",
    "affine/swtorch::smith_waterman<1cpu>",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "dna-100b.txt"
    path.write_bytes(datasets.synthesize("dna-100b", 32 << 10))
    return path


@pytest.fixture(scope="module")
def run(corpus):
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    mp.setenv("SWTPU_ERROR_BOUND", str(BAND))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = suite.main(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "32kb"])
    mp.undo()
    return ctx, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_pairs(corpus):
    """The JAX suite's cross-product of the same file, as JAX ``PairBatch``es."""
    ctx = types.SimpleNamespace(tape=jax_tape.Tape.from_buffer(corpus.read_bytes(), "lines"))
    batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b = jax_suite.build_crossproduct(ctx)
    return batch, cells, total_bytes, pairs_a, pairs_b


def test_suite_main_prints_every_row(run):
    _, lines = run
    for row in ROWS:
        hits = [line for line in lines if line.startswith(row + " ")]
        assert len(hits) == 1, (row, lines)
        assert "SKIPPED" not in hits[0] and "CUPS" in hits[0], hits[0]
    assert [line for line in lines if line.startswith("# ")] == ["# uniform", "# linear", "# affine"]


def test_crossproduct_matches_jax(run, jax_pairs):
    ctx, _ = run
    ref, cells, total_bytes, pairs_a, pairs_b = jax_pairs
    batch, got_cells, got_bytes, queries, candidates, got_a, got_b = suite.build_crossproduct(ctx)
    assert (got_a, got_b) == (pairs_a, pairs_b)
    assert (got_cells, got_bytes) == (cells, total_bytes)
    assert len(queries) == len(candidates) and len(got_a) == len(queries) ** 2 > 1
    for field in ("a", "b", "a_len", "b_len"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(), np.asarray(getattr(ref, field)))
    assert batch.device == torch.device("cpu") and batch.dp_cells() == ref.dp_cells()
    assert ctx.staged["pairs_a"] == pairs_a and ctx.staged["pairs_b"] == pairs_b


@pytest.mark.parametrize(
    "key",
    ["levenshtein", "levenshtein_utf8", "levenshtein_banded", "nw_linear", "sw_linear", "nw_affine", "sw_affine"],
)
def test_suite_scores_match_jax(run, jax_pairs, key):
    ctx, _ = run
    ref, _, _, pairs_a, pairs_b = jax_pairs
    want = {
        "levenshtein": lambda: JS.levenshtein(ref),
        "levenshtein_utf8": lambda: JS.levenshtein(JS.pack_pairs_utf8(pairs_a, pairs_b)),
        "levenshtein_banded": lambda: JS.levenshtein_banded(ref, BAND),
        "nw_linear": lambda: JS.nw_score_linear(ref),
        "sw_linear": lambda: JS.sw_score_linear(ref),
        "nw_affine": lambda: JS.nw_score_affine(ref),
        "sw_affine": lambda: JS.sw_score_affine(ref),
    }[key]()
    got = ctx.staged["scores"][key]
    assert got.dtype == np.int32 and got.shape == (len(pairs_a),)
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(want)))


def test_suite_main_without_a_card_stops(corpus, capsys):
    """Without ``--device cpu`` the suite runs on the card, and a host with
    no card stops with an error instead of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as stop:
        suite.main(["--dataset", str(corpus), "--dataset-limit", "32kb"])
    assert stop.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
