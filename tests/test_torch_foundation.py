"""The port's foundation against the JAX package: tape, datasets, config, report."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stringwars_tpu import datasets as jax_datasets
from stringwars_tpu import tape as jax_tape
from stringwars_tpu.utils import report as jax_report
from stringwars_tpu_torch import datasets, tape
from stringwars_tpu_torch.parallel.mesh import DeviceScope, scope_variants
from stringwars_tpu_torch.utils import config, report
from stringwars_tpu_torch.utils.harness import BenchBudget, WorkUnits, measure_throughput
from stringwars_tpu_torch.utils.profiler import measured_roofline
from _torch_threads import one_thread  # noqa: F401


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _buffers():
    rng = np.random.default_rng(11)
    return {
        "english": jax_datasets._CORPORA["english-words"](20_000, rng),
        "naughty": jax_datasets._CORPORA["naughty"](20_000, rng),
        "edges": b"\n\nab  cd\t\x0b\x0c\r\nef\n \n",
        "empty": b"",
    }


@pytest.mark.parametrize("mode", ["lines", "words", "file"])
@pytest.mark.parametrize("max_tokens,unique", [(None, False), (None, True), (7, False), (7, True)])
def test_tape_from_buffer_matches_jax(mode, max_tokens, unique):
    for name, buf in _buffers().items():
        want = jax_tape.Tape.from_buffer(buf, mode, max_tokens=max_tokens, unique=unique)
        got = tape.Tape.from_buffer(buf, mode, max_tokens=max_tokens, unique=unique)
        want_offsets = np.asarray(want.offsets).astype(np.int64)
        assert got.offsets.dtype == torch.int64 and got.data.dtype == torch.uint8
        np.testing.assert_array_equal(got.offsets.numpy(), want_offsets, err_msg=name)
        assert (got.count, got.total_bytes) == (want.count, want.total_bytes), name
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data)[: want.total_bytes], err_msg=name)
        assert got.to_list() == want.to_list(), name


def test_tape_from_numpy_takes_jax_state():
    buf = _buffers()["naughty"]
    want = jax_tape.Tape.from_buffer(buf, "lines")
    got = tape.Tape.from_numpy(np.asarray(want.data), np.asarray(want.offsets), device="cpu")
    assert got.device == torch.device("cpu")
    assert got.to_list() == want.to_list()
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))


def test_tape_from_tokens_and_pack_u32_match_jax():
    tokens = [b"", b"a", b"bcd", bytes(range(250, 256)), b"\x00" * 9]
    want = jax_tape.Tape.from_tokens(tokens)
    got = tape.Tape.from_tokens(tokens)
    assert got.to_list() == want.to_list() == tokens
    raw = np.random.default_rng(1).integers(0, 256, (3, 64), dtype=np.uint8)
    np.testing.assert_array_equal(
        tape.pack_u32(torch.from_numpy(raw)).numpy(), np.asarray(jax_tape.pack_u32(raw))
    )


def test_tape_from_numpy_rejects_short_data():
    with pytest.raises(ValueError):
        tape.Tape.from_numpy(np.zeros(3, np.uint8), np.array([0, 5]))


@pytest.mark.parametrize("name", sorted(jax_datasets._CORPORA))
def test_generators_match_jax(name):
    assert datasets.corpus_names() == jax_datasets.corpus_names()
    sizes = (0, 1, 1000, 150_001) + ((700_001,) if name in ("english-words", "long-lines") else ())
    for size in sizes:
        for seed in (0, 42):
            want = jax_datasets._CORPORA[name](size, np.random.default_rng([seed, 5]))
            got = datasets._CORPORA[name](size, np.random.default_rng([seed, 5]))
            assert got == want, (name, size, seed)


def test_synthetic_corpus_is_stable_across_processes():
    """The seed does not depend on Python's per-process str hash."""
    code = (
        "import hashlib; from stringwars_tpu_torch import datasets as d; "
        "print(hashlib.sha256(d.synthesize('english-words', 50_000)).hexdigest())"
    )
    digests = set()
    for hash_seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": hash_seed}
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO, capture_output=True, text=True, check=True)
        digests.add(out.stdout.strip())
    assert digests == {hashlib.sha256(datasets.synthesize("english-words", 50_000)).hexdigest()}


def test_load_tape_reads_the_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"alpha beta\ngamma  delta\n" * 10)
    got = datasets.load_tape(str(path), tokens_mode="words", size_limit="100b")
    assert got.to_list() == (b"alpha beta\ngamma  delta\n" * 10)[:100].split()


_REPORT_CASES = [
    ("substring-forward/swtorch::find_count<1gpu>", "bytes", 1.5, 10, 3_000_000_000, [0.1, 0.2, 0.3], 3.3e12),
    ("x", "bytes", 0.0, 0, 0, None, None),
    ("hash/xxh64", "hashes", 2.0, 5_000_000, 64_000_000, [1e-7, 2e-4, 5e-2, 3.0], None),
    ("cups-row", "cups", 0.5, 7_000_000_000_000, 0, [0.5], None),
    ("bits", "bits", 1e-3, 999, 10, [5e-10], 1e9),
    ("a-name-longer-than-the-forty-two-column-width-of-the-report", "keys", 1.0, 1500, 1500, [], 2e9),
    ("cmp", "comparisons", 3.0, 3_000, 1, [0.001, 0.002], None),
]


@pytest.mark.parametrize("case", _REPORT_CASES)
def test_format_report_line_matches_jax(case):
    name, unit, elapsed, elements, nbytes, latencies, roofline = case
    args = (name, unit, elapsed, elements, nbytes, latencies)
    assert report.format_report_line(*args, roofline_bytes_per_second=roofline) == jax_report.format_report_line(
        *args, roofline_bytes_per_second=roofline
    )


def test_report_rejects_unknown_unit_and_skip_line(capsys):
    with pytest.raises(ValueError):
        report.format_report_line("x", "parsecs", 1.0, 1, 1)
    report.report_skip("byteset-forward/swtorch::byteset_count<1gpu>", "boom")
    jax_report.report_skip("byteset-forward/swtorch::byteset_count<1gpu>", "boom")
    ours, theirs = capsys.readouterr().out.splitlines()
    assert ours == theirs


def test_config_matches_jax(monkeypatch):
    from stringwars_tpu.utils import config as jax_config

    for text in ("128mb", "1gb", "500kb", "12", "1.5MB", " 3 b"):
        assert config.parse_size(text) == jax_config.parse_size(text)
    for bad in ("", "12 parsecs"):
        with pytest.raises(ValueError):
            config.parse_size(bad)
    assert config.compile_filter("[bad").search("x[bad") and config.compile_filter(None) is None
    monkeypatch.setenv("STRINGWARS_TOKENS", "lines")
    assert config.resolve_tokens(None, "words") == "lines" == jax_config.resolve_tokens(None, "words")
    monkeypatch.setenv("SWTPU_TIME", "nope")
    with pytest.raises(ValueError):
        config.get_env_parsed("TIME", 1.0)


def test_measure_throughput_smoke_contract():
    """SWTPU_TIME=0: one warm-up call and one measured call, host-timed on CPU."""
    calls = []

    def routine():
        calls.append(1)
        return WorkUnits(elements=3, bytes=100)

    stats = measure_throughput(routine, BenchBudget(0.0, 0.0), device=torch.device("cpu"))
    assert len(calls) == 2
    assert (stats.elements, stats.bytes, len(stats.latencies_seconds)) == (3, 100, 1)


def test_scopes_and_roofline_off_the_card():
    cpu = torch.device("cpu")
    assert [s.name for s in scope_variants(cpu)] == ["<1cpu>"]
    assert DeviceScope(torch.device("cuda", 0)).name == "<1gpu>"
    assert measured_roofline(cpu) is None


def test_port_imports_no_jax():
    code = (
        "import sys, stringwars_tpu_torch.suites.find, stringwars_tpu_torch.ops.find_cuda, "
        "stringwars_tpu_torch.ops.bytesum, stringwars_tpu_torch.utils.profiler; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'stringwars_tpu' or m.startswith('stringwars_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_pacing_helpers_match_jax():
    from stringwars_tpu.utils import harness as jax_harness
    from stringwars_tpu_torch.utils import harness

    far = harness.now_ns() + 10**12
    assert list(harness.clamped_subranges(2500, 1024)) == list(jax_harness.clamped_subranges(2500, 1024))
    assert list(harness.paced_items(range(3000), far)) == list(range(3000))
    assert list(harness.paced_items(range(3000), 0)) == [0]  # the first clock read stops it
    columns = (list(range(5000)), list(range(5000, 10000)))
    want = jax_harness.reduce_in_windows(lambda a, b: a * b, *columns, deadline_ns=far)
    assert harness.reduce_in_windows(lambda a, b: a * b, *columns, deadline_ns=far) == want
    assert harness.reduce_in_windows(len, [b"ab"] * 9, deadline_ns=0) == (0, 0)


def test_perf_section_on_cpu_prints_and_traces(tmp_path, monkeypatch, capsys):
    from stringwars_tpu_torch.utils.profiler import PerfSection

    monkeypatch.setenv("SWTPU_TRACE_DIR", str(tmp_path))
    with PerfSection("sum", bytes_moved=1 << 20):
        torch.ones(1 << 18).sum()
    line = capsys.readouterr().err.strip()
    assert line.startswith("# perf sum: ") and "GB/s" in line and "roofline" not in line
    assert (tmp_path / "sum.json").stat().st_size > 0
