"""The port's segmentation functions against the JAX package's, on both of
the port's feature routes.

Every boundary mask and count must equal the JAX package's (its XLA route,
the conformance oracle its own tests hold to regex and hand-derived
fixtures). The texts: the curated samples of ``tests/test_segment.py``,
``test_sentence.py`` and ``test_linebreak.py`` joined into one text, fuzz
soups (``tests/test_scanline._fuzz_text``), a slice of
``synthetic:multilingual`` and a stream whose combining run crosses the JAX
kernel's 32,768-position tile. Each text is padded with spaces to one length,
so that the JAX functions (jitted per length) compile once each. The host
APIs are also held to the JAX tests' fixtures sample by sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from stringwars_tpu.ops import segment as JS
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.ops import segment as PS
from test_scanline import _fuzz_text
from test_segment import GRAPHEME_SAMPLES, WORD_SAMPLES, _regex_words
from _torch_threads import one_thread  # noqa: F401


# (text, segments) of tests/test_sentence.py
SENTENCE_SAMPLES = [
    ("Hello world. How are you? Fine!", ["Hello world. ", "How are you? ", "Fine!"]),
    ("Pi is 3.14 roughly. Next.", ["Pi is 3.14 roughly. ", "Next."]),
    ("The U.S. Government acted. Then.", ["The U.S. ", "Government acted. ", "Then."]),
    ("U.S.A. rocks", ["U.S.A. rocks"]),
    ("We bought apples, pears, etc. and left. Done.", ["We bought apples, pears, etc. and left. ", "Done."]),
    ('He said "Stop!" Then silence.', ['He said "Stop!" ', "Then silence."]),
    ("One\nTwo", ["One\n", "Two"]),
    ("A\r\nB", ["A\r\n", "B"]),
    ("Wait... What?! Yes.", ["Wait... ", "What?! ", "Yes."]),
    ("no terminator here at all", ["no terminator here at all"]),
    ("", []),
]

# (text, break positions) of tests/test_linebreak.py
LINEBREAK_SAMPLES = [
    ("hello world foo", [6, 12]),
    ("foo-bar baz", [4, 8]),
    ("a\nb c", [2, 4]),
    ("(word) x", [7]),
    ("3.14 ok", [5]),
    ("$1,234.56 x", [10]),
    ("a b c", [4]),
    ("ab​cd", [3]),
    ("漢字文", [1, 2]),
    ("", []),
    ("x", []),
]

LENGTH = 72_000

FUNCTIONS = {
    "whitespace": ("whitespace_token_count", False),
    "graphemes": ("grapheme_boundaries", True),
    "words": ("word_boundaries", True),
    "sentences": ("sentence_boundaries", True),
    "linebreaks": ("linebreak_opportunities", True),
}


def _padded(raw: bytes) -> bytes:
    assert len(raw) <= LENGTH
    return raw + b" " * (LENGTH - len(raw))


def _multilingual() -> bytes:
    raw = datasets.synthesize("multilingual", LENGTH)
    return raw


TEXTS = {
    "curated": lambda: _padded(
        "\n".join(GRAPHEME_SAMPLES + WORD_SAMPLES + [t for t, _ in SENTENCE_SAMPLES + LINEBREAK_SAMPLES]).encode()
    ),
    "fuzz": lambda: _padded((_fuzz_text(0, 6000) + _fuzz_text(1, 6000))[: LENGTH - 16].decode("utf-8", "ignore").encode()),
    "multilingual": lambda: _padded(_multilingual()),
    "tile-seam": lambda: _padded(("a" * 32765 + "é́x lorem. Ipsum\r\n" + "b" * 9000 + "\U0001F1FA\U0001F1F8 (1.5) ").encode()),
}


@pytest.mark.parametrize("text", sorted(TEXTS))
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_segmentation_equals_jax(name, text):
    fn_name, has_mask = FUNCTIONS[name]
    raw = TEXTS[text]()
    assert len(raw) == LENGTH
    arr = np.frombuffer(raw, np.uint8)
    want = getattr(JS, fn_name)(jnp.asarray(arr), LENGTH, scanline=False)
    for scanline in (False, True):
        got = getattr(PS, fn_name)(torch.from_numpy(arr.copy()), LENGTH, scanline=scanline)
        if has_mask:
            assert got[0].dtype == torch.bool and got[0].shape == (LENGTH,)
            mism = np.flatnonzero(got[0].numpy() != np.asarray(want[0]))
            assert mism.size == 0, f"scanline={scanline}: first mask mismatches at {mism[:10]}"
            assert int(got[1]) == int(want[1])
        else:
            assert int(got) == int(want)


def test_pruned_tables_equal_jax():
    """``max_cp`` prunes the class tables as the JAX package prunes its rules."""
    arr = np.frombuffer(_padded(_multilingual()), np.uint8)
    for fn_name in ("grapheme_boundaries", "linebreak_opportunities"):
        want = getattr(JS, fn_name)(jnp.asarray(arr), LENGTH, max_cp=0xFFFF, scanline=False)
        got = getattr(PS, fn_name)(torch.from_numpy(arr.copy()), LENGTH, max_cp=0xFFFF, scanline=True)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])) and int(got[1]) == int(want[1])


def test_newline_count_equals_jax():
    raw = _padded("a\nb\r\nc\rd e\u2028f\x85g\r".encode())
    arr = np.frombuffer(raw, np.uint8)
    want = int(JS.newline_split_count(jnp.asarray(arr), LENGTH))
    assert int(PS.newline_split_count(torch.from_numpy(arr.copy()), LENGTH)) == want == 7


@pytest.mark.parametrize("text", GRAPHEME_SAMPLES)
def test_grapheme_clusters_match_regex(text):
    assert PS.grapheme_clusters(text, "cpu") == regex.findall(r"\X", text)


@pytest.mark.parametrize("text", WORD_SAMPLES)
def test_word_segments_match_regex(text):
    assert PS.word_segments(text, "cpu") == _regex_words(text)


def test_word_segments_strict_tr29():
    assert PS.word_segments("'Oak", "cpu") == ["'", "Oak"]
    assert PS.word_segments("́ab", "cpu") == ["́", "ab"]
    assert PS.word_segments("don't", "cpu") == ["don't"]
    assert PS.word_segments("1,234,", "cpu") == ["1,234", ","]


@pytest.mark.parametrize("text,segments", SENTENCE_SAMPLES)
def test_sentence_segments(text, segments):
    assert PS.sentence_segments(text, "cpu") == segments


@pytest.mark.parametrize("text,positions", LINEBREAK_SAMPLES)
def test_line_break_positions(text, positions):
    assert PS.line_break_positions(text, "cpu") == positions


def test_whitespace_and_newline_counts():
    text = "  hello\tworld\u00a0x \u2003y "
    raw = text.encode()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    for scanline in (False, True):
        assert int(PS.whitespace_token_count(data, len(raw), scanline=scanline)) == len(text.split())
    nl = "a\nb\r\nc\rd\u2028e".encode()
    assert int(PS.newline_split_count(torch.frombuffer(bytearray(nl), dtype=torch.uint8), len(nl))) == 5


def test_host_apis_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.grapheme_clusters("abc")
