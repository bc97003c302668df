"""The port's normalization suite (its case-fold, normalize, compare and
find groups) end to end on the CPU (``--device cpu``), against the JAX
package's functions on the same corpus file and against ``unicodedata``."""

import contextlib
import io
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import casefold as JC
from stringwars_tpu.ops import normalize as JNORM
from stringwars_tpu.suites import normalization as JN
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu.tape import Tape as JaxTape
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.suites import normalization as suite
from _jax_unicode_cache import private_jax_unicode_cache  # noqa: F401
from _torch_threads import one_thread  # noqa: F401


FORMS = ["nfc", "nfd", "nfkc", "nfkd"]
DEVICE_ROWS = [
    "case-fold/swtorch::utf8_fold<1cpu>",
    *[f"normalize-{form}/swtorch::utf8_norm<1cpu>" for form in FORMS],
    "case-insensitive-compare/swtorch::uncased_eq<1cpu>",
    "case-insensitive-find/swtorch::uncased_find<1cpu>",
]
HOST_ROWS = ["case-fold/str.casefold", *[f"normalize-{form}/unicodedata.normalize" for form in FORMS],
             "case-insensitive-compare/casefold-eq", "case-insensitive-find/casefold-count"]
GROUPS = ["# case-fold", *[f"# normalize-{form}" for form in FORMS], "# case-insensitive-compare",
          "# case-insensitive-find"]


def _run(argv):
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ctx = suite.main(argv)
    finally:
        mp.undo()
    return ctx, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """64 KB of ``synthetic:multilingual`` with lines that differ only in
    case (equal pairs) and 3-codepoint folds."""
    path = tmp_path_factory.mktemp("corpus") / "multilingual.txt"
    extra = "\nStraße ΐ\nSTRASSE ΐ\nΣίσυφος\nΣΊΣΥΦΟΣ\nﬃ ΰ\n".encode()
    path.write_bytes(datasets.synthesize("multilingual", 64 << 10) + extra)
    return path


@pytest.fixture(scope="module")
def suite_run(corpus):
    return _run(["--device", "cpu", "--dataset", str(corpus)])


def _row(lines, row):
    hits = [line for line in lines if line.startswith(row + " ")]
    assert len(hits) == 1, (row, lines)
    assert "SKIPPED" not in hits[0] and "/s" in hits[0], hits[0]
    return hits[0]


def test_suite_prints_every_row(suite_run):
    _, lines = suite_run
    for row in DEVICE_ROWS + HOST_ROWS:
        _row(lines, row)
    assert [line for line in lines if line.startswith("# ")] == GROUPS
    assert not any("ascii_fold" in line for line in lines)  # not an ASCII corpus


def test_stream_rows_equal_jax(corpus):
    raw = np.frombuffer(corpus.read_bytes(), np.uint8)
    # A continuation run longer than the width, stray continuations first.
    weird = np.frombuffer(b"\x80\xbf" + b"ab" + b"\x80" * 100 + "ßx".encode() * 30 + b"\xbf" * 40, np.uint8)
    for data, widths in ((raw, (32, 1024)), (weird, (8, 32, 64, 200))):
        for width in widths:
            want = JN.stream_rows(data, width)
            got = suite.stream_rows(data, width)
            assert got.width == want.width == width
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
            np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert suite.stream_row_starts(torch.from_numpy(raw[:10].copy()), 32).tolist() == [0]
    with pytest.raises(ValueError):
        suite.stream_rows(raw, 30)


def _starts_reference(data: bytes, width: int) -> list[int]:
    """The JAX suite's start chain (``stream_rows``), walked byte by byte."""
    starts = [0]
    while starts[-1] + width < len(data):
        e = starts[-1] + width
        while e > starts[-1] and (data[e] & 0xC0) == 0x80:
            e -= 1
        starts.append(e if e > starts[-1] else starts[-1] + width)
    return starts


@pytest.mark.parametrize("width", [1, 3, 8, 32, 100])
def test_stream_row_starts_across_chunks(width, rng):
    """Streams longer than the walk's chunks (64 * width bytes): text, every
    byte value, long continuation runs and all-continuation input."""
    parts = [datasets.synthesize("multilingual", 3 * 64 * width + 17), bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
             b"\x80" * (2 * 64 * width + 5), "日本ß".encode() * 700, b"abc"]
    for data in parts + [b"".join(parts)]:
        got = suite.stream_row_starts(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), width)
        assert got.tolist() == _starts_reference(data, width)


def test_fold_row_equals_jax(suite_run, corpus):
    ctx, _ = suite_run
    staged = ctx.staged
    text = corpus.read_bytes().decode()
    assert staged["max_cp"] == max(map(ord, text))
    rows = staged["rows"]
    jax_rows = JaxPaddedTokens(data=jnp.asarray(rows.data.numpy()), lengths=jnp.asarray(rows.lengths.numpy()), width=32)
    want, want_counts = JC.fold_tokens(jax_rows, max_cp=staged["max_cp"])
    got, got_counts = staged["fold"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert int(got_counts.sum()) == len(text.casefold())
    assert got.shape[1] == 3 * 32  # the corpus has 3-codepoint folds


def test_compare_row_equals_jax(suite_run, corpus):
    ctx, _ = suite_run
    pairs = ctx.staged["pairs"]
    text = corpus.read_bytes().decode("utf-8", "ignore")
    lines = [ln.encode() for ln in text.split("\n") if ln][:1001]
    assert pairs == list(zip(lines, lines[1:]))[:1000]
    a = JaxPaddedTokens.from_tape(JaxTape.from_tokens([p[0] for p in pairs]), align=4)
    b = JaxPaddedTokens.from_tape(JaxTape.from_tokens([p[1] for p in pairs]), align=4)
    want = np.asarray(JC.uncased_equal_batch(a, b))
    got = ctx.staged["equal"].numpy()
    np.testing.assert_array_equal(got, want)
    host = [x.decode().casefold() == y.decode().casefold() for x, y in pairs]
    np.testing.assert_array_equal(got, host)
    assert got.sum() >= 2


def test_find_row_equals_jax(suite_run, corpus):
    ctx, _ = suite_run
    raw = corpus.read_bytes()
    text = raw.decode("utf-8", "ignore")
    rng = np.random.default_rng(42)  # the JAX suite's draw
    words = [w for w in text.split() if len(w.encode()) >= 3]
    needles = [words[i].encode() for i in rng.integers(0, max(len(words), 1), 100)]
    assert suite.suite_needles(text) == needles
    folded = JC.fold_bytes(np.frombuffer(raw, np.uint8))
    want_hay, want_n = folded
    np.testing.assert_array_equal(ctx.staged["haystack"].numpy(), np.asarray(want_hay)[: int(want_n)])
    assert len(ctx.staged["needles"]) == 100
    for needle, folded_needle, count in zip(needles, ctx.staged["needles"], ctx.staged["needle_counts"]):
        fn, fm = JC.fold_bytes(np.frombuffer(needle, np.uint8))
        np.testing.assert_array_equal(folded_needle.numpy(), np.asarray(fn)[: int(fm)])
        assert count == JC.uncased_count(folded, needle)


def _overlapping(text: str, needle: str) -> int:
    count, pos = 0, text.find(needle)
    while pos >= 0:
        count, pos = count + 1, text.find(needle, pos + 1)
    return count


def test_ascii_corpus_takes_the_ascii_rows(tmp_path):
    """An ASCII corpus adds the ASCII fold row, and its find row takes the
    packed-word find over the folded bytes."""
    path = tmp_path / "ascii.txt"
    text = "Hello World\nhello world\nThe QUICK brown fox jumps; aaaaa AAAA\n" * 40
    path.write_text(text)
    ctx, lines = _run(["--device", "cpu", "--dataset", str(path)])
    _row(lines, "case-fold/swtorch::ascii_fold<1cpu>")
    folded, counts = ctx.staged["ascii_fold"]
    got = b"".join(bytes(row[: int(k)].tolist()) for row, k in zip(folded, counts))
    assert got.decode() == text.casefold()
    needles = suite.suite_needles(text)
    assert ctx.staged["needle_counts"] == [_overlapping(text.casefold(), w.decode().casefold()) for w in needles]


def test_suite_without_a_card_exits_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        suite.main([])
    assert exit_info.value.code == 2


@pytest.fixture(scope="module")
def marked_corpus(tmp_path_factory):
    """1 MB of ``synthetic:multilingual`` and a tail that takes every slow
    route: combining marks in and out of order, conjoining jamo, compat
    characters, a run of 300 marks (the wide rows) and a row seam before a
    mark."""
    rng = np.random.default_rng(13)
    pieces = ["ä", "á̧", "ḍ̇", "각", "ﬃ", "①", "Å", "ǅ", "ཱི", "ȩ́", "x", "ﷺ", "가", " "]
    tail = "".join(pieces[i] for i in rng.integers(0, len(pieces), 4000))
    path = tmp_path_factory.mktemp("corpus") / "marked.txt"
    path.write_bytes(datasets.synthesize("multilingual", 1 << 20) + ("\n" + "́" * 300 + "y\n" + tail).encode())
    return path


@pytest.fixture(scope="module")
def normalize_run(marked_corpus):
    return _run(["--device", "cpu", "--dataset", str(marked_corpus), "--filter", "normalize-"])


def test_normalize_rows_print(normalize_run):
    _, lines = normalize_run
    for form in FORMS:
        _row(lines, f"normalize-{form}/swtorch::utf8_norm<1cpu>")
        _row(lines, f"normalize-{form}/unicodedata.normalize")


@pytest.mark.parametrize("form", ["NFC", "NFD", "NFKC", "NFKD"])
def test_normalize_row_assembles_to_unicodedata(normalize_run, marked_corpus, form):
    """The last call's outputs, fast rows kept verbatim and the slow rows'
    outputs in corpus order, equal ``unicodedata.normalize`` of the whole
    corpus; the call's quick check is the staging's routing."""
    ctx, _ = normalize_run
    staged = ctx.staged["normalize"]
    entry = staged["forms"][form]
    stage, (quick, outputs) = entry["stage"], entry["out"]
    assert torch.equal(quick, stage.fast)
    assert stage.slow_codepoints and len(stage.buckets) == 2  # rows of 64 and the wide bucket
    got = suite.assemble(stage, outputs, staged["lead"], staged["cps"])
    text = marked_corpus.read_bytes().decode()
    assert "".join(map(chr, got.tolist())) == unicodedata.normalize(form, text)


def test_quick_rows_equal_jax_rows_where_every_cut_is_safe(normalize_run, marked_corpus):
    """On the synthetic corpus every character boundary is safe: the
    quick-check rows are the JAX suite's 1 KB rows there."""
    ctx, _ = normalize_run
    stage = ctx.staged["normalize"]["forms"]["NFC"]["stage"]
    raw = np.frombuffer(marked_corpus.read_bytes(), np.uint8)
    cut = len(datasets.synthesize("multilingual", 1 << 20))
    want = JN.stream_rows(raw[:cut])
    rows = int(np.asarray(want.lengths).size) - 1  # the last JAX row ends at the cut, the port's runs on
    np.testing.assert_array_equal(stage.quick.lengths[:rows].numpy(), np.asarray(want.lengths)[:rows])
    np.testing.assert_array_equal(stage.quick.data[:rows].numpy(), np.asarray(want.data)[:rows])


def test_f13_row_seams(tmp_path):
    """F13: the JAX routine cuts its 1 KB quick-check rows at character
    boundaries, so a row ending in ``a`` passes the NFC quick check and is
    kept verbatim while the next row, starting with U+0308, is normalized
    alone: the routine's output is not the NFC of its corpus. The port cuts
    before safe codepoints, and its output is."""
    text = "x" * 1022 + "a\u0308b" + "y" * 200
    raw = np.frombuffer(text.encode(), np.uint8)
    # The JAX routine's routing (suites/normalization.py _normalize_routine).
    toks = JN.stream_rows(raw)
    rows_np, lengths_np = np.asarray(toks.data), np.asarray(toks.lengths)
    fast = JNORM.rows_nfc_verbatim_host(rows_np, lengths_np, False)
    assert fast[0] and not fast[1]
    slow = bytes(rows_np[1, : lengths_np[1]]).decode()
    jax_out = rows_np[0, : lengths_np[0]].tobytes().decode() + "".join(
        map(chr, JNORM.normalize(np.array([ord(c) for c in slow], np.int32), "NFC")))
    assert jax_out != unicodedata.normalize("NFC", text)
    # The port's suite on the same corpus.
    path = tmp_path / "seam.txt"
    path.write_text(text)
    ctx, _ = _run(["--device", "cpu", "--dataset", str(path), "--filter", "normalize-nfc/"])
    staged = ctx.staged["normalize"]
    stage = staged["forms"]["NFC"]["stage"]
    assert int(stage.quick.lengths[0]) == 1022  # the row ends before the a
    got = suite.assemble(stage, staged["forms"]["NFC"]["out"][1], staged["lead"], staged["cps"])
    assert "".join(map(chr, got.tolist())) == unicodedata.normalize("NFC", text)
