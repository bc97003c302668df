"""The port's GPT-2 pre-split (``unicode/pretokenize.py``, stdlib ``re`` with
committed classes) against ``regex.findall`` of GPT-2's pattern, the JAX
tokenization suite's pre-split. The test imports ``regex``; the port does
not."""

import numpy as np
import pytest
import regex

from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.unicode import gen_tables, tables
from stringwars_tpu_torch.unicode import pretokenize as P

GPT2 = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


@pytest.mark.parametrize("name", ["multilingual", "naughty", "english-words"])
def test_corpus_equals_regex(name):
    text = datasets.synthesize(name, 1 << 20).decode("utf-8", "ignore")
    got = P.gpt2_pretokens(text)
    assert got == GPT2.findall(text)
    assert len(got) > 10_000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_codepoints_equal_regex(seed):
    """Codepoints from every plane, assigned or not (surrogates excluded),
    mixed with the ones the pattern turns on: apostrophe contractions,
    spaces, U+001C-U+001F (str.isspace but not White_Space), NEL, NBSP."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 17, 60_000) << 16
    cps = planes + rng.integers(0, 0x10000, planes.size)
    cps = cps[(cps < 0xD800) | (cps > 0xDFFF)]
    special = np.array([0x1C, 0x1D, 0x1E, 0x1F, 0x20, 0x20, 0x27, 0x73, 0x74, 0x6C, 0x0A, 0x85, 0xA0, 0x3000, 0x31, 0x41])
    cps = np.concatenate([cps, rng.choice(special, 40_000)])
    rng.shuffle(cps)
    text = "".join(map(chr, cps.tolist()))
    assert P.gpt2_pretokens(text) == GPT2.findall(text)


def test_edge_strings_equal_regex():
    for text in ["", " ", "  ", "a  b", "it's 'll 'S x'd", "\x1c\x1d a\x1e\x1fb", "\u0085 x", "12 ３４ ½", "a\n\n b\t"]:
        assert P.gpt2_pretokens(text) == GPT2.findall(text), repr(text)


def test_committed_classes_are_the_regex_modules():
    """The committed data is the scan ``gen_tables`` makes from ``regex``:
    ``\\s`` is White_Space (25 codepoints), not ``str.isspace`` (29)."""
    assert regex.__version__ == P.REGEX_VERSION
    ranges = P.class_ranges()
    for name, pattern in P.CLASSES.items():
        starts, values = tables.run_lengths(gen_tables.scan_class(pattern))
        members = [(int(lo), int(hi)) for lo, hi, v in zip(starts, np.append(starts[1:], tables.MAX_CP) - 1, values) if v]
        assert ranges[name] == members, name
    assert sum(hi - lo + 1 for lo, hi in ranges["space"]) == 25
    assert not any(lo <= 0x1C <= hi for lo, hi in ranges["space"])
