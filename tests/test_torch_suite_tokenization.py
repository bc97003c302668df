"""The port's tokenization suite end to end on the CPU (``--device cpu``),
against the JAX package's functions on the same corpus file."""

import contextlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import bpe as JB
from stringwars_tpu.ops import segment as JS
from stringwars_tpu.ops import utf8 as JU
from stringwars_tpu.suites.tokenization import _cp_ceiling as jax_cp_ceiling
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.suites import tokenization as suite
from _torch_threads import one_thread  # noqa: F401


DEVICE_ROWS = [
    "tokenize-whitespace/swtorch::split<1cpu>",
    "tokenize-newlines/swtorch::split<1cpu>",
    "tokenize-words-tr29/swtorch::words<1cpu>",
    "tokenize-graphemes-tr29/swtorch::graphemes<1cpu>",
    "tokenize-sentences-tr29/swtorch::sentences<1cpu>",
    "tokenize-lines-uax14/swtorch::linebreaks<1cpu>",
    "utf8-length/swtorch::count_utf8<1cpu>",
    "utf8-iterate/swtorch::decode_utf32<1cpu>",
    "find-nth-utf8/swtorch::find_nth<1cpu>",
    "tokenize-bpe/swtorch::bpe_encode<1cpu>",
]
HOST_ROWS = [
    "tokenize-whitespace/str.split",
    "tokenize-newlines/str.splitlines",
    "tokenize-words-tr29/regex-WORD",
    "tokenize-graphemes-tr29/regex-\\X",
    "utf8-length/bytes.decode-len",
    "tokenize-bpe/python-bpe",
]
GROUPS = [
    "# tokenize-whitespace", "# tokenize-newlines", "# tokenize-words-tr29", "# tokenize-graphemes-tr29",
    "# tokenize-sentences-tr29", "# tokenize-lines-uax14", "# utf8-length", "# utf8-iterate", "# find-nth-utf8",
    "# tokenize-bpe",
]


def _run(argv, **env):
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    for key, value in env.items():
        mp.setenv(key, value)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ctx = suite.main(argv)
    finally:
        mp.undo()
    return ctx, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "multilingual.txt"
    path.write_bytes(datasets.synthesize("multilingual", 48 << 10) + "\U0001F1FA\U0001F1F8 x́. Y".encode())
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


def test_suite_counts_equal_jax(suite_run, corpus):
    ctx, _ = suite_run
    raw = corpus.read_bytes()
    n = len(raw)
    arr = jnp.asarray(np.frombuffer(raw, np.uint8))
    mcp = jax_cp_ceiling(max(raw))
    assert ctx.staged["n"] == n and ctx.staged["max_cp"] == mcp == 0x10FFFF
    counts = ctx.staged["counts"]
    total = int(JU.utf8_count(arr, n))
    want = {
        "tokenize-whitespace/swtorch::split<1cpu>": int(JS.whitespace_token_count(arr, n, max_cp=mcp)),
        "tokenize-newlines/swtorch::split<1cpu>": int(JS.newline_split_count(arr, n, max_cp=mcp)),
        "tokenize-words-tr29/swtorch::words<1cpu>": int(JS.word_boundaries(arr, n, max_cp=mcp)[1]),
        "tokenize-graphemes-tr29/swtorch::graphemes<1cpu>": int(JS.grapheme_boundaries(arr, n, max_cp=mcp)[1]),
        "tokenize-sentences-tr29/swtorch::sentences<1cpu>": int(JS.sentence_boundaries(arr, n, max_cp=mcp)[1]),
        "tokenize-lines-uax14/swtorch::linebreaks<1cpu>": int(JS.linebreak_opportunities(arr, n, max_cp=mcp)[1]),
        "utf8-length/swtorch::count_utf8<1cpu>": total,
        "utf8-iterate/swtorch::decode_utf32<1cpu>": int(JU.utf8_decode(arr, n)[1]),
        "find-nth-utf8/swtorch::find_nth<1cpu>": int(JU.utf8_find_nth(arr, n, total - 1)),
    }
    assert counts == want
    text = raw.decode()
    assert counts["utf8-length/swtorch::count_utf8<1cpu>"] == len(text)
    assert counts["tokenize-whitespace/swtorch::split<1cpu>"] == len(text.split())


def test_suite_bpe_equals_jax(suite_run, corpus):
    """The tokenize-bpe group has the JAX group's shape, and its device row's
    last ids and counts equal the JAX encoder on the same pretokens and
    merges. The JAX group's pre-split needs ``regex``; the other tests of
    this file do not."""
    import regex

    ctx, _ = suite_run
    bpe = ctx.staged["bpe"]
    text = corpus.read_bytes().decode("utf-8", "ignore")
    gpt2 = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    kept = [p.encode() for p in gpt2.findall(text[: 4 << 20])]
    kept = [p for p in kept if 0 < len(p) <= 32][:400_000]
    assert bpe["pretokens"] == sorted(kept, key=len) and len(kept) > 3_000
    assert len(bpe["merges"]) == 512  # trained on kept[:30_000]: test_torch_bpe holds the trainer to JAX's
    data, lengths = bpe["data"].numpy(), bpe["lengths"].numpy()
    assert data.shape == (len(kept), max(map(len, kept))) and data.dtype == np.uint8
    want = JB.bpe_encode(JaxPaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=data.shape[1]),
                         JB.MergeTable.from_merges(bpe["merges"]))
    np.testing.assert_array_equal(bpe["ids"].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(bpe["counts"].numpy(), np.asarray(want[1]))
    assert set(bpe["seconds"]) == {"pre-split", "train"}


def test_bpe_rows_run_without_regex(corpus, monkeypatch):
    """The card has no ``regex``: the BPE group runs all the same."""
    monkeypatch.setitem(sys.modules, "regex", None)
    _, lines = _run(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "8kb"], SWTPU_FILTER="bpe")
    _row(lines, "tokenize-bpe/swtorch::bpe_encode<1cpu>")
    _row(lines, "tokenize-bpe/python-bpe")


def test_cp_ceiling_equals_jax():
    for b in (0, 0x41, 0x7F, 0x80, 0xC3, 0xDF, 0xE0, 0xEF, 0xF0, 0xFF):
        assert suite._cp_ceiling(b) == jax_cp_ceiling(b)


def test_regex_rows_skip_without_regex(corpus, monkeypatch):
    """The card has no ``regex``: its two host rows SKIP, the rest run."""
    monkeypatch.setitem(sys.modules, "regex", None)
    _, lines = _run(["--device", "cpu", "--dataset", str(corpus), "--dataset-limit", "8kb"],
                    SWTPU_FILTER="regex|whitespace")
    for row in ("tokenize-words-tr29/regex-WORD", "tokenize-graphemes-tr29/regex-\\X"):
        hits = [line for line in lines if line.startswith(row + " ")]
        assert len(hits) == 1 and "SKIPPED (ModuleNotFoundError" in hits[0], hits
    _row(lines, "tokenize-whitespace/swtorch::split<1cpu>")


def test_suite_main_without_a_card_stops(corpus, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as stop:
        suite.main(["--dataset", str(corpus), "--dataset-limit", "8kb"])
    assert stop.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
