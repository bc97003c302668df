"""Two simulated hosts: a world of 2 gloo ranks on the CPU, one rank a
"host" (the JAX package's ``SWTPU_*`` convention), the analogue of
``tests/test_multihost.py``. Each rank loads only its ``host_byte_range`` of
a corpus and builds its row with ``shard_bytes_local``; the sharded count
equals the one-process count. The dry run and the suites' ``<2host>`` rows
run in the same world.

The ranks run in ``_torch_dist_worker`` processes, which never import jax.
"""

import re

import numpy as np
import pytest
import torch
from _torch_dist_worker import World
from _torch_threads import one_thread  # noqa: F401

from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.parallel import distributed
from stringwars_tpu_torch.parallel.mesh import DeviceScope

N = 1 << 20
OVERLAP = 8 * 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("hosts"), local_world_size=1)
    yield w
    w.close()


@pytest.mark.parametrize("needle", [b"abra", b"ab", b"babababababab"])
def test_two_hosts_find_count(world, needle):
    results = world.run("hosts", N, needle)
    corpus = np.random.default_rng(7).integers(97, 99, N, dtype=np.uint8)
    want = F.find_count(torch.from_numpy(corpus), F.pack_needle(needle, 4))
    assert want == len(re.findall(b"(?=" + re.escape(needle) + b")", corpus.tobytes()))
    for count, name, loaded in results:
        assert (count, name) == (want, "<2host>")
        assert loaded <= N // 2 + OVERLAP  # a host reads its half and the halo, never the whole corpus


def test_host_byte_range_covers_the_corpus():
    """The ranges of every rank tile the corpus, each with its halo, and the
    local rows equal ``shard_bytes``' rows of the whole corpus."""
    from stringwars_tpu_torch.parallel.sharding import shard_bytes

    corpus = np.random.default_rng(3).integers(0, 256, 10_007, dtype=np.uint8)
    for ranks in (1, 2, 3, 4):
        ends = []
        for rank in range(ranks):
            scope = DeviceScope(torch.device("cpu"), gpus=ranks, rank=rank)
            offset, length, chunk = distributed.host_byte_range(corpus.size, scope, overlap=OVERLAP)
            row, n, got_chunk = distributed.shard_bytes_local(scope, corpus[offset : offset + length], corpus.size,
                                                              overlap=OVERLAP)
            want_row, _, want_chunk = shard_bytes(scope, corpus, overlap=OVERLAP)
            assert (n, got_chunk, chunk) == (corpus.size, want_chunk, want_chunk) and chunk % 512 == 0
            torch.testing.assert_close(row, want_row, rtol=0, atol=0)
            ends.append(min(offset + chunk, corpus.size))
        assert ends[-1] == corpus.size


def test_dryrun_multichip_two_hosts(world):
    counts = world.run("dryrun")
    assert counts[0] == counts[1] and counts[0]["bpe_tokens"] > 0


SUITE_ROWS = {
    "find": ("substring-forward/swtorch::find_count", "substring-backward/swtorch::rfind_count",
             "byteset-forward/swtorch::byteset_count", "byteset-forward/swtorch::aho_corasick"),
    "sequence": ("argsort/swtorch::argsort",),
    "similarities": ("uniform/swtorch::levenshtein", "affine/swtorch::needleman_wunsch"),
    "hash": ("stateless/swtorch::xxh64", "stateless/swtorch::xxh3_64"),
    "fingerprints": ("minhash/ndim_64/swtorch::fingerprint",),
    "memory": ("lookup-table/swtorch::lut_translate", "memcpy/swtorch::copy"),
}


@pytest.mark.parametrize("suite", list(SUITE_ROWS))
def test_suite_world_rows(world, suite):
    """A suite's ``main`` in the world: rank 0 reports each sharded row at
    ``<1cpu>`` and ``<2host>`` (measured, not skipped); rank 1 prints nothing."""
    argv = ["--device", "cpu", "--dataset-limit", "64kb", "--warmup", "0", "--time-limit", "0", "-k",
            "|".join(re.escape(row) for row in SUITE_ROWS[suite])]
    results = world.run("suite", suite, argv)
    lines = results[0][0].splitlines()
    assert results[0][1] == ["<1cpu>", "<2host>"]
    for row in SUITE_ROWS[suite]:
        for scope in ("<1cpu>", "<2host>"):
            line = next((x for x in lines if x.startswith(row + scope + " ")), None)
            assert line is not None and "SKIPPED" not in line, (row + scope, lines)
    assert results[1][0] == ""
