"""The port's find suite end to end on the CPU, against the JAX package.

Both sides read one corpus file, so they see identical bytes. The suite's
own routines (the ones its device rows measure) must give, for the first 64
needles, exactly the counts, last offsets and byteset counts of the JAX
package's XLA functions.
"""

import numpy as np
import pytest

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import find as JF
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.suites import find as suite

ROWS = [
    "substring-forward/swtorch::find_count<1cpu>",
    "substring-forward/bytes.find-loop",
    "substring-backward/swtorch::rfind_count<1cpu>",
    "substring-backward/bytes.rfind-loop",
    "byteset-forward/swtorch::byteset_count<1cpu>",
    "byteset-forward/re.findall",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "english-words.txt"
    path.write_bytes(datasets.synthesize("english-words", 256 << 10))
    return path


@pytest.fixture(scope="module")
def tapes(corpus):
    raw = corpus.read_bytes()
    port = datasets.load_tape(str(corpus), tokens_mode="words", size_limit="256kb", device="cpu")
    ref = jax_tape.Tape.from_buffer(raw, "words")
    hay = np.asarray(ref.data)[: ref.total_bytes]
    assert port.data.numpy().tobytes() == hay.tobytes()
    return port, hay


def test_suite_main_prints_every_row(corpus, monkeypatch, capsys):
    monkeypatch.setenv("SWTPU_TIME", "0")
    monkeypatch.setenv("SWTPU_WARMUP", "0")
    suite.main(["--dataset", str(corpus), "--dataset-limit", "256kb"])
    lines = capsys.readouterr().out.splitlines()
    for row in ROWS:
        hits = [line for line in lines if line.startswith(row + " ") or line.startswith(row + "\t")]
        assert len(hits) == 1, (row, lines)
        assert "SKIPPED" not in hits[0] and "B/s" in hits[0], hits[0]
    assert [line for line in lines if line.startswith("# ")] == [
        "# substring-forward",
        "# substring-backward",
        "# byteset-forward",
    ]


def test_forward_routine_counts_match_jax(tapes):
    port, hay = tapes
    routine, results = suite.forward_routine(port)
    _, panel, _ = suite.suite_needles(port)
    first = panel[:64]
    for _ in range(64):
        units = routine()
        assert units.bytes == units.elements * port.total_bytes
        if all(t in results for t in first):
            break
    for t in first:
        want = int(JF.find_count(hay, JF.pack_needle(t, suite._needle_cap(t)), hay.size))
        assert results[t] == want, t


def test_backward_routine_matches_jax(tapes):
    port, hay = tapes
    routine, results = suite.backward_routine(port)
    cycle, _, _ = suite.suite_needles(port)
    for _ in range(64):
        routine()
    assert len(results) == len(set(cycle[:64]))
    for t in cycle[:64]:
        count, last = JF.rfind_count(hay, JF.pack_needle(t, suite._needle_cap(t)), hay.size)
        assert results[t] == (int(count), int(last)), t


def test_byteset_routine_matches_jax(tapes):
    port, hay = tapes
    routine, results = suite.byteset_routine(port)
    units = routine()
    assert units.bytes == 3 * port.total_bytes
    for name, charset in suite.BYTESETS.items():
        assert results[name] == int(JF.byteset_count(hay, JF.pack_byteset(charset), hay.size)), name


def test_long_needles_join_the_forward_batch():
    """Tokens over 505 B are scanned every call, by the same kernel path."""
    from stringwars_tpu_torch.tape import Tape

    words = [b"x" * 600, b"ab", b"y" * 700, b"x" * 600, b"cd"]
    t = Tape.from_buffer(b" ".join(words), "words")
    cycle, panel, long = suite.suite_needles(t)
    assert (cycle, panel, long) == (words, [b"ab", b"cd"], [b"x" * 600, b"y" * 700])
    routine, results = suite.forward_routine(t)
    units = routine()
    assert units.elements == 4
    assert results == {b"ab": 1, b"cd": 1, b"x" * 600: 2, b"y" * 700: 1}
