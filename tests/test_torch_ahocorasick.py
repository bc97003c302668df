"""The port's Aho-Corasick DFA and plain scan against the JAX package.

``build_dfa`` must equal the JAX package's native ``ac_build`` element for
element; the port's plain count (the CPU path of ``ac_count``, and the
comparison for the CUDA kernel in ``csrc/ahocorasick.cu``) must equal the
JAX XLA scan, both Pallas kernels in interpret mode (the lane-LUT kernel
and the flat-key rule walk), the native sequential count and brute force.
Counts are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stringwars_tpu.ops import ahocorasick as JA
from stringwars_tpu_torch.ops import ahocorasick as A
from stringwars_tpu_torch.ops import ahocorasick_cuda
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_reference_cache():
    """The JAX package caches an automaton's rules and LUTs by ``id()``
    (ROADMAP F2): an automaton made at the address of one that an earlier
    test let die would read that one's rules. Each test starts empty."""
    JA._flat_rules_cache().clear()


def brute_count(hay: bytes, patterns: list[bytes]) -> int:
    total = 0
    for p in patterns:
        pos = hay.find(p)
        while pos >= 0:
            total += 1
            pos = hay.find(p, pos + 1)
    return total


def _random_set(seed: int, letters: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return list({bytes(rng.integers(97, 97 + letters, int(rng.integers(1, 7)), dtype=np.uint8)) for _ in range(24)})


SETS = {
    "classic": [b"he", b"she", b"his", b"hers"],
    "nested": [b"a", b"aa", b"aaa"],
    "tabs": [bytes([c]) for c in b"\n\r\x0b\x0c"],
    "html": [bytes([c]) for c in b"</>&'\"=[]"],
    "digits": [bytes([c]) for c in b"0123456789"],
    "random3": _random_set(1, 3),
    "random4": _random_set(2, 4),
    "random6": _random_set(3, 6),
    "zero-ff": [b"\x00", b"a\x00a", b"\x00\x00", b"\xff\xfe", b"ab"],
    "duplicates": [b"ab", b"ab", b"b", b"abab"],
}


def _hay(patterns: list[bytes], size: int, seed: int) -> np.ndarray:
    """Bytes drawn from the patterns' own alphabet (dense matches), with
    some patterns planted whole."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(bytes(sorted(set(b"".join(patterns)))), np.uint8)
    hay = rng.choice(alphabet, size)
    for i in range(0, size - 64, 97):
        p = patterns[i % len(patterns)]
        hay[i : i + len(p)] = np.frombuffer(p, np.uint8)
    return hay


@pytest.mark.parametrize("name", sorted(SETS))
def test_build_dfa_matches_native_ac_build(name):
    patterns = SETS[name]
    want = JA.Automaton(patterns)
    delta, out_count = A.build_dfa(patterns)
    assert delta.dtype == np.int32 and out_count.dtype == np.int32
    np.testing.assert_array_equal(delta.reshape(-1), np.asarray(want.delta_flat))
    np.testing.assert_array_equal(out_count, np.asarray(want.out_count))
    port = A.Automaton(patterns)
    assert (port.states, port.max_len) == (want.states, want.max_len)


@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_count_matches_jax_xla_host_and_brute(name):
    patterns = SETS[name]
    hay = _hay(patterns, 12_001, seed=len(name))
    want = brute_count(hay.tobytes(), patterns)
    jax_auto = JA.Automaton(patterns)
    port = A.Automaton(patterns)
    assert want > 0
    assert A.ac_count(port, torch.from_numpy(hay)) == want
    assert int(JA.ac_count(jax_auto, hay)) == want
    assert port.count_host(hay) == jax_auto.count_host(hay) == want


@pytest.mark.parametrize("k", range(1, 16))
def test_unaligned_views_match_jax(k):
    """A view ``hay[k:]`` (not 16-byte aligned: the CUDA wrapper copies it
    once) counts as the JAX function counts the same bytes."""
    patterns = SETS["classic"]
    hay = _hay(patterns, 4_200, seed=k)
    n = 4_099
    view = torch.from_numpy(hay.copy())[k:]
    want = int(JA.ac_count(JA.Automaton(patterns), hay[k : k + n]))
    assert want == brute_count(hay[k : k + n].tobytes(), patterns) > 0
    assert A.ac_count(A.Automaton(patterns), view, n) == want


def test_from_numpy_takes_the_jax_tables():
    patterns = SETS["random4"]
    jax_auto = JA.Automaton(patterns)
    port = A.Automaton.from_numpy(np.asarray(jax_auto.delta_flat), np.asarray(jax_auto.out_count), patterns)
    np.testing.assert_array_equal(port.delta, A.Automaton(patterns).delta)
    hay = _hay(patterns, 9_000, seed=5)
    assert A.ac_count(port, torch.from_numpy(hay)) == int(JA.ac_count(jax_auto, hay)) == brute_count(hay.tobytes(), patterns)
    with pytest.raises(ValueError, match="entries"):
        A.Automaton.from_numpy(np.zeros(300, np.int32), np.zeros(2, np.int32), patterns)
    with pytest.raises(ValueError, match="states"):
        A.Automaton.from_numpy(np.full(512, 2, np.int32), np.zeros(2, np.int32), patterns)


def test_plain_count_matches_pallas_lut_kernel():
    """The lane-LUT Pallas kernel (the TPU's production route), interpret mode."""
    hay = np.random.default_rng(11).integers(97, 103, 20_000, dtype=np.uint8)
    patterns = [b"ab", b"bca", b"aaaa", b"cb", b"abcabc"]
    jax_auto = JA.Automaton(patterns)
    assert JA.automaton_luts(jax_auto)[0] is not None  # this automaton takes the LUT kernel
    want = JA.ac_count_pallas(jax_auto, hay, interpret=True)
    assert A.ac_count(A.Automaton(patterns), torch.from_numpy(hay)) == want == brute_count(hay.tobytes(), patterns)


def test_plain_count_matches_pallas_rule_walk_kernel():
    """The flat-key rule-walk Pallas kernel, called as tests/test_ahocorasick.py does."""
    import jax.numpy as jnp

    hay = np.random.default_rng(12).integers(97, 103, 20_000, dtype=np.uint8)
    patterns = [b"ab", b"bc", b"abc", b"aa", b"f"]
    jax_auto = JA.Automaton(patterns)
    n = hay.shape[0]
    cols, gpos0, overlap, limit = JA.stage_cols(hay, n, jax_auto.max_len)
    key_rules, oc_rules = JA.automaton_rules(jax_auto)
    want = int(
        JA._ac_scan_pallas(
            jnp.asarray(key_rules.starts), jnp.asarray(key_rules.deltas),
            jnp.asarray(oc_rules.starts), jnp.asarray(oc_rules.deltas),
            jnp.asarray([n, limit], jnp.int32), cols, gpos0, key_rules.count, oc_rules.count, overlap, True,
        )
    )
    assert A.ac_count(A.Automaton(patterns), torch.from_numpy(hay)) == want == brute_count(hay.tobytes(), patterns)


@pytest.mark.parametrize("chunk", [1, 2, 5, 16, 256, 4096])
def test_seams_count_once(chunk):
    """Matches straddling chunk seams, with chunks shorter than the overlap."""
    patterns = [b"abcabc", b"cab", b"bc", b"c"]
    hay = np.random.default_rng(7).choice(np.frombuffer(b"abc", np.uint8), 20_000)
    want = brute_count(hay.tobytes(), patterns)
    port = A.Automaton(patterns)
    assert A.ac_count_plain(port, torch.from_numpy(hay), chunk=chunk).item() == want == port.count_host(hay)


def test_extent_edges():
    """n < len(hay) (bytes past n never match, though they would), patterns
    longer than the haystack, and the empty haystack."""
    patterns = [b"\x00", b"ab\x00", b"abab"]
    port = A.Automaton(patterns)
    hay = np.frombuffer(b"ab\x00abab" * 300 + b"\x00" * 50, np.uint8)
    hay_t = torch.from_numpy(hay.copy())
    for n in (hay.size, hay.size - 50, 2101, 7, 3, 1, 0):
        want = brute_count(hay[:n].tobytes(), patterns)
        assert A.ac_count(port, hay_t, n) == want == int(JA.ac_count(JA.Automaton(patterns), hay, n)), n
        assert A.ac_count_plain(port, hay_t, n, chunk=3).item() == want
    long = A.Automaton([b"x" * 64, b"yx" * 40])
    assert A.ac_count(long, torch.from_numpy(np.frombuffer(b"x" * 63, np.uint8).copy())) == 0
    assert A.ac_count(port, torch.zeros(0, dtype=torch.uint8)) == 0
    with pytest.raises(ValueError):
        A.ac_count(port, hay_t, hay.size + 1)


def test_stage_rows_matches_jax():
    hay = np.random.default_rng(4).integers(0, 256, 5_003, dtype=np.uint8)
    for max_len, chunk in ((1, 256), (5, 100), (40, 16)):
        rows, gpos0, got_chunk = A.stage_rows(torch.from_numpy(hay), 5_000, max_len, chunk)
        want_rows, want_gpos0, want_chunk = JA.stage_rows(hay, 5_000, max_len, chunk, False)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
        np.testing.assert_array_equal(gpos0.numpy(), np.asarray(want_gpos0))
        assert got_chunk == want_chunk


def test_validation_matches_jax():
    for bad, message in (([], "need at least one pattern"), ([b"a", b""], "empty patterns not allowed")):
        with pytest.raises(ValueError, match=message):
            JA.Automaton(bad)
        with pytest.raises(ValueError, match=message):
            A.Automaton(bad)


def test_tables_are_staged_once_per_automaton():
    """Device tables live on the automaton (no id()-keyed cache): the same
    object on the second call; another automaton gets its own."""
    first = A.Automaton([b"ab", b"b"])
    tables = first.tables("cpu")
    assert first.tables(torch.device("cpu")) is tables
    second = A.Automaton([b"xy"])
    assert second.tables("cpu") is not tables
    packed = tables.packed.numpy().view(np.uint32)
    flat = first.delta.reshape(-1)
    np.testing.assert_array_equal(packed >> 8, flat)
    np.testing.assert_array_equal(packed & 0xFF, np.minimum(first.out_count[flat], 255))


def test_kernel_regime_and_chunk_choice():
    def regime(auto, shared=A.SHARED_BYTES):
        return auto.layout(shared).regime

    assert regime(A.Automaton([b"the", b"and", b"tion", b"abcd"])) == "shared"
    words = [bytes(np.random.default_rng(i).integers(97, 123, 8, dtype=np.uint8)) for i in range(40)]
    assert regime(A.Automaton(words)) == "shared"
    assert regime(A.Automaton(words), 1024) == "split"
    every_byte = [bytes([b]) for b in range(256)]  # 256 classes: they do not shrink the table
    assert regime(A.Automaton(every_byte)) == "shared"
    assert regime(A.Automaton(every_byte), 64 << 10) == "global"
    assert regime(A.Automaton(every_byte + [b"a"] * 300)) == "wide"  # 32-bit entries, 263 KB: a count over 255
    assert regime(A.Automaton([b"a"] * 300)) == "shared"  # a 16-bit entry holds the count of 300
    assert ahocorasick_cuda.kernel_chunk(1) == ahocorasick_cuda.kernel_chunk(65) == 256
    assert ahocorasick_cuda.kernel_chunk(300) == 1216
    assert ahocorasick_cuda.check_chunk(32, "x") == 32
    for bad in (16, 200, 1 << 25):
        with pytest.raises(ValueError, match="chunk"):
            ahocorasick_cuda.check_chunk(bad, "x")
    assert A.ac_count(A.Automaton([b"a"] * 300), torch.from_numpy(np.frombuffer(b"aab", np.uint8).copy())) == 600


# The kernel's class tables (ops/ahocorasick.class_layout), walked by
# ac_count_classes_plain as csrc/ahocorasick.cu walks them.
def _grams(letters: int, threes: int, dups: int = 1) -> list[bytes]:
    """Every two-letter word over ``letters`` letters, then ``threes``
    three-letter words (one state each), the second two-letter word
    ``dups`` times (no three-letter word ends with it): 1 + letters +
    letters^2 + threes states, output counts up to max(dups, 2)."""
    alphabet = bytes(range(33, 33 + letters))
    two = [bytes([a, b]) for a in alphabet for b in alphabet]
    return two + [two[i] + alphabet[:1] for i in range(threes)] + [two[1]] * (dups - 1)


def _one_class():
    """An automaton whose 256 columns are one: a single state that counts
    every byte (no pattern set builds it), as the port's and the JAX
    package's tables."""
    import jax.numpy as jnp

    port = A.Automaton.from_numpy(np.zeros(256, np.int32), np.ones(1, np.int32), [b"x"])
    jax_auto = JA.Automaton.__new__(JA.Automaton)
    jax_auto.max_len, jax_auto.states = 1, 1
    jax_auto.delta_flat, jax_auto.out_count = jnp.zeros(256, jnp.int32), jnp.ones(1, jnp.int32)
    return port, jax_auto


# name -> (patterns, shared bytes, entry bytes (None: the layout's own), the
# layout wanted: (regime, entry bytes)), the Pallas kernel held beside
# the XLA scan where the automaton is small.
CLASS_CASES = {
    "4095 states": (_grams(63, 62), A.SHARED_BYTES, None, ("split", 2)),
    "4096 states": (_grams(63, 63), A.SHARED_BYTES, None, ("split", 2)),
    "4097 states": (_grams(63, 64), A.SHARED_BYTES, None, ("split", 2)),
    "4097 states, a count of 8": (_grams(63, 64, 8), A.SHARED_BYTES, None, ("split", 4)),
    "max_out 3 at 14 state bits": (_grams(90, 3, 3), A.SHARED_BYTES, None, ("split", 2)),
    "max_out 4 at 14 state bits": (_grams(90, 3, 4), A.SHARED_BYTES, None, ("split", 4)),
    "256 classes": ([bytes([b]) for b in range(256)] + [b"\x00\xff", b"ab"], A.SHARED_BYTES, None, ("shared", 2)),
    "max_out 255": ([b"ab"] * 255 + [b"b"], A.SHARED_BYTES, None, ("shared", 2)),
    "max_out 256, 32-bit entries": ([b"ab"] * 256 + [b"b"], A.SHARED_BYTES, 4, ("shared", 4)),
    "wide": ([b"a"] * 300 + [b"ab"], A.SHARED_BYTES, None, ("shared", 2)),
    "random300": ([bytes(np.random.default_rng(8).choice(np.frombuffer(b"abc", np.uint8), m)) for m in (1, 2, 3, 7, 40, 150, 299, 300)],
                  A.SHARED_BYTES, None, ("shared", 2)),
    "classic, two rows on chip": (SETS["classic"], A.MAP_BYTES + 32, None, ("split", 2)),
    "zero-ff, 32-bit, one row on chip": (SETS["zero-ff"], A.MAP_BYTES + 32, 4, ("split", 4)),
}
PALLAS_CASES = {"wide", "classic, two rows on chip", "zero-ff, 32-bit, one row on chip"}


def _class_hay(patterns: list[bytes], seed: int) -> np.ndarray:
    """4 KB over the patterns' bytes and 1 KB of every byte value, some
    patterns planted, the first also at the very end."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(bytes(sorted(set(b"".join(patterns))))[:96], np.uint8)
    hay = np.concatenate([rng.choice(alphabet, 4096), rng.integers(0, 256, 1024, dtype=np.uint8)])
    for i, at in enumerate(rng.integers(0, hay.size - 320, 24)):
        p = patterns[(i * 7919) % len(patterns)]
        hay[at : at + len(p)] = np.frombuffer(p, np.uint8)
    hay[hay.size - len(patterns[0]) :] = np.frombuffer(patterns[0], np.uint8)
    return hay


def test_classes_are_the_distinct_columns_of_delta():
    """Bytes share a class exactly where their columns of ``delta`` are
    equal; classes are numbered by their first byte; the breadth-first
    order keeps the root first and never goes back up a level."""
    for patterns in [*SETS.values(), CLASS_CASES["256 classes"][0], CLASS_CASES["random300"][0]]:
        auto = A.Automaton(patterns)
        class_of, first = A.byte_classes(auto.delta)
        cols = auto.delta.T
        same = (cols[:, None, :] == cols[None, :, :]).all(-1)
        np.testing.assert_array_equal(same, class_of[:, None] == class_of[None, :])
        np.testing.assert_array_equal(class_of[first], np.arange(first.size))
        assert (np.diff(first) > 0).all() and all(class_of[b] <= class_of[first[-1]] for b in range(256))
        order = A.bfs_order(auto.delta)
        assert order[0] == 0 and sorted(order.tolist()) == list(range(auto.states))
        layout = auto.layout()
        same = layout.class_of[:, None] == layout.class_of[None, :]  # the layout's numbering: the same classes
        np.testing.assert_array_equal(same, class_of[:, None] == class_of[None, :])
        if layout.range_lo >= 0:  # the class the kernel computes from the byte range is the map's
            t = (np.arange(256) - layout.range_lo) % (1 << 32)
            np.testing.assert_array_equal(np.minimum(t, first.size - 1), layout.class_of)
    assert A.Automaton(SETS["nested"]).layout().range_lo == ord("a")
    assert A.Automaton([bytes([b]) for b in range(256)]).layout().range_lo == 1
    assert A.Automaton(SETS["html"]).layout().range_lo == A.Automaton(SETS["zero-ff"]).layout().range_lo == -1
    auto = A.Automaton(SETS["html"])  # nine one-byte patterns: their bytes, and one class for the rest
    class_of, first = A.byte_classes(auto.delta)
    assert first.size == 10 and len({class_of[b] for b in range(256) if bytes([b]) not in SETS["html"]}) == 1


@pytest.mark.parametrize("name", sorted(CLASS_CASES))
def test_class_tables_count_as_jax(name):
    """The kernel's lookup (byte -> class -> entry of the next state and its
    count, 16- or 32-bit, rows on chip and off) counts what the JAX XLA
    scan, the Pallas kernel in interpret mode (small automata), the port's
    plain scan and the sequential scan count, at the kernel's chunk and at
    32-byte chunks (the seams, and overlaps longer than a chunk)."""
    patterns, shared, entry_bytes, want_layout = CLASS_CASES[name]
    auto = A.Automaton(patterns)
    layout = A.class_layout(auto.delta, auto.out_count, shared, entry_bytes)
    assert (layout.regime, layout.entry_bytes) == want_layout
    assert layout.table.dtype == (np.uint16 if layout.entry_bytes == 2 else np.uint32)
    rows, class_map = A.class_tensors(layout, "cpu")  # as the kernel reads them: the map's row offsets or classes
    np.testing.assert_array_equal(class_map.numpy(), layout.class_of * (layout.entry_bytes if layout.scaled else 1))
    assert layout.scaled == (layout.classes * layout.entry_bytes <= 256)
    assert rows.numel() % 16 == 0 and rows.numpy()[: layout.table.nbytes].tobytes() == layout.table.tobytes()
    if layout.regime == "split":
        assert 0 < layout.hot < auto.states
    hay = _class_hay(patterns, len(name))
    jax_auto = JA.Automaton(patterns)
    want = int(JA.ac_count(jax_auto, hay))
    assert want == auto.count_host(hay) > 0
    if name in PALLAS_CASES:
        assert JA.ac_count_pallas(jax_auto, hay, interpret=True) == want
    hay_t = torch.from_numpy(hay)
    for chunk in (ahocorasick_cuda.kernel_chunk(auto.max_len), 32):
        assert A.ac_count_classes_plain(layout, hay_t, chunk=chunk, max_len=auto.max_len).item() == want
    assert A.ac_count_plain(auto, hay_t, hay.size - 3).item() == A.ac_count_classes_plain(
        layout, hay_t, hay.size - 3, max_len=auto.max_len).item()


def test_one_class_counts_as_jax():
    """An automaton of one class (every column equal) reads one entry a row."""
    port, jax_auto = _one_class()
    layout = port.layout()
    assert (layout.classes, layout.regime, layout.entry_bytes) == (1, "shared", 2)
    hay = np.random.default_rng(3).integers(0, 256, 3001, dtype=np.uint8)
    want = int(JA.ac_count(jax_auto, hay))
    assert want == 3001 == port.count_host(hay)
    assert A.ac_count_classes_plain(layout, torch.from_numpy(hay), chunk=32).item() == want


def test_cuda_wrapper_refuses_cpu_tensors():
    before = dict(ahocorasick_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ahocorasick_cuda.ac_count(A.Automaton([b"ab"]), torch.zeros(4096, dtype=torch.uint8))
    assert ahocorasick_cuda.LAUNCHES == before
