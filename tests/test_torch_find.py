"""The port's substring and byteset search against the JAX package.

The port's plain torch versions (the CPU path of every public function) are
held exactly equal to the JAX package's XLA functions and to its Pallas
kernel run in interpret mode, on the same haystacks and the same
JAX-packed needles. The CUDA kernels themselves run only on a card
(``chip_smoke.py``); here their wrappers must refuse CPU tensors.
"""

import numpy as np
import pytest
import torch

from stringwars_tpu.ops import find as JF
from stringwars_tpu.ops import find_pallas as JP
from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.ops import find_cuda
from _torch_threads import one_thread  # noqa: F401


N = 300_001  # not a multiple of 4
LENGTHS = [1, 2, 3, 4, 5, 8, 13, 16, 29, 505, 506, 600]
RUN = (1000, 1700)  # a run of b"a": dense overlapping matches for a*m


def _capacity(m: int) -> int:
    # One shared capacity per length class keeps the JAX programs few.
    return 4 if m <= 13 else (8 if m <= 29 else 151)


@pytest.fixture(scope="module")
def hay() -> np.ndarray:
    h = np.random.default_rng(7).integers(0, 3, N, dtype=np.uint8) + 97  # a-c: dense matches
    h[RUN[0] : RUN[1]] = ord("a")
    return h


def _needles(hay: np.ndarray, m: int) -> list[bytes]:
    """Matches at p = 0 and p = n - m, an overlapping run, and no match."""
    b = hay.tobytes()
    return [b[:m], b[N - m :], b"a" * m, b"d" * m]


def _port(packed) -> F.PackedNeedle:
    return F.PackedNeedle.from_numpy(np.asarray(packed.words), np.asarray(packed.masks), int(packed.length))


def _brute(hay: bytes, needle: bytes) -> list[int]:
    out, pos = [], hay.find(needle)
    while pos >= 0:
        out.append(pos)
        pos = hay.find(needle, pos + 1)
    return out


@pytest.mark.parametrize("m", LENGTHS)
def test_pack_needle_matches_jax(m):
    needle = bytes(range(1, 256)) * 3
    for cap in (None, _capacity(m)):
        want = JF.pack_needle(needle[:m], cap)
        got = F.pack_needle(needle[:m], cap)
        np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
        np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
        assert got.length == int(want.length) == m
        assert got.needle_bytes().numpy().tobytes()[:m] == needle[:m]


@pytest.mark.parametrize("m", LENGTHS)
def test_find_and_rfind_match_jax_xla(hay, m):
    hay_t = torch.from_numpy(hay)
    for needle in _needles(hay, m):
        packed = JF.pack_needle(needle, _capacity(m))
        port = _port(packed)
        want = _brute(hay.tobytes(), needle)
        count = F.find_count(hay_t, port)
        assert count == int(JF.find_count(hay, packed)) == len(want), (m, needle[:8])
        want_count, want_last = JF.rfind_count(hay, packed)
        assert F.rfind_count(hay_t, port) == (int(want_count), int(want_last)) == (len(want), want[-1] if want else -1)


def test_find_count_batch_and_short_extent_match_jax(hay):
    hay_t = torch.from_numpy(hay)
    needles = [nd for m in (1, 3, 5, 8, 13) for nd in _needles(hay, m)]
    packed = [JF.pack_needle(nd, 4) for nd in needles]
    batch = F.NeedleBatch.from_needles([_port(p) for p in packed])
    for n in (N, N - 3, 4099, 5, 0):
        want = [int(JF.find_count(hay[: max(n, 1)], p, n)) for p in packed]
        assert F.find_count_batch(hay_t, batch, n) == want, n
        assert [c for c, _ in F.rfind_count_batch(hay_t, batch, n)] == want, n


@pytest.mark.parametrize("k", range(1, 16))
def test_unaligned_views_match_jax(hay, k):
    """A view ``hay[k:]`` (not 16-byte aligned: the CUDA wrappers copy it
    once) counts, and finds the last match, relative to the view, as the
    JAX functions do on the same bytes."""
    n = 4099
    sub = hay[k : k + n]
    needles = [nd for m in (1, 3, 8) for nd in (sub[:m].tobytes(), sub[n - m :].tobytes(), b"a" * m, b"d" * m)]
    packed = [JF.pack_needle(nd, 4) for nd in needles]
    batch = F.NeedleBatch.from_needles([_port(p) for p in packed])
    view = torch.from_numpy(hay)[k:]
    want = [(int(c), int(last)) for c, last in (JF.rfind_count(sub, p) for p in packed)]
    assert F.find_count_batch(view, batch, n) == [int(JF.find_count(sub, p)) for p in packed] == [c for c, _ in want]
    assert F.rfind_count_batch(view, batch, n) == want
    assert want[0] == (len(_brute(sub.tobytes(), needles[0])), _brute(sub.tobytes(), needles[0])[-1])


def test_aligned_bytes_copies_only_a_misaligned_view():
    """The CUDA wrappers' guard: a view off a 16-byte boundary becomes a
    fresh aligned copy of its first n bytes; an aligned one (or n = 0) is
    passed as it is."""
    base = torch.arange(1024, dtype=torch.int64).to(torch.uint8)
    assert base.data_ptr() % 16 == 0
    assert build.aligned_bytes(base, base.numel()) is base
    view = base[16:]
    assert build.aligned_bytes(view, 100) is view
    for k in range(1, 16):
        view = base[k:]
        got = build.aligned_bytes(view, 100)
        assert view.data_ptr() % 16 and got.data_ptr() % 16 == 0
        assert torch.equal(got, view[:100]) and got.numel() == 100
        assert build.aligned_bytes(view, 0) is view


@pytest.fixture(scope="module")
def staged(hay):
    return JP.StagedHaystack(hay[: 256 << 10])


@pytest.mark.parametrize("cap,lengths", [(4, (1, 2, 3, 4, 5, 8, 13)), (8, (16, 29)), (127, (505,))])
def test_batch_matches_pallas_interpret(hay, staged, cap, lengths):
    """find_count_batch against the Pallas kernel's one-dispatch batch."""
    n = staged.n
    needles = [hay[:n].tobytes()[:m] for m in lengths] + [hay[:n].tobytes()[n - m :] for m in lengths] + [
        b"a" * m for m in lengths
    ] + [b"d" * lengths[0]]
    packed = [JF.pack_needle(nd, cap) for nd in needles]
    want = np.asarray(JP.find_count_cycle(staged, JP.NeedleBatch(staged, packed), interpret=True)).tolist()
    batch = F.NeedleBatch.from_needles([_port(p) for p in packed])
    assert F.find_count_batch(torch.from_numpy(hay), batch, n) == want
    assert want == [len(_brute(hay[:n].tobytes(), nd)) for nd in needles]


@pytest.mark.parametrize("cap,m", [(4, 5), (127, 505)])
def test_rfind_matches_pallas_interpret(hay, staged, cap, m):
    n = staged.n
    hay_t = torch.from_numpy(hay)
    for needle in (hay[:n].tobytes()[n - m :], b"d" * m):
        packed = JF.pack_needle(needle, cap)
        assert F.rfind_count(hay_t, _port(packed), n) == JP.rfind_pallas(staged, packed, interpret=True)
        if cap == 4:  # the batch test already holds the counts of the 505 B bucket
            assert F.find_count(hay_t, _port(packed), n) == JP.find_count_pallas(staged, packed, interpret=True)


def _filter_batches(hay: bytes) -> dict[str, list[bytes]]:
    """The count kernel's batches, needles cut from ``hay`` (a match each)
    or not in it: 1 to 4 B mixed with longer ones, duplicates, needles that
    share a head or are prefixes of one another, and 1, 16, 64 and 1,100
    needles (1,100: more than one block's counters, two chunks)."""
    rng = np.random.default_rng(5)

    def cut(m: int) -> bytes:
        p = int(rng.integers(0, len(hay) - m))
        return hay[p : p + m]

    x, y, head = cut(8), cut(12), cut(12)
    return {
        "short-and-long": [b"a", b"ab", b"cab", b"abca", cut(5), cut(9), cut(13), cut(29), b"c", cut(2), b"d"],
        "duplicates": [x, x, y, b"a", b"a", y, x],
        "shared-heads": [head, head[:4] + b"dddd", head[:6], head[:4], head + b"d", head[:5], head[:1], head[:2], head[:3]],
        "one": [cut(8)],
        "16": [cut(int(m)) for m in rng.integers(1, 14, 16)],
        "64": [cut(8) for _ in range(64)],
        "1100": [cut(int(m)) for m in rng.integers(1, 14, 1100)],
    }


@pytest.mark.parametrize("name", ["short-and-long", "duplicates", "shared-heads", "one", "16", "64", "1100"])
def test_filter_walk_matches_plain_and_pallas(hay, staged, name):
    """The filter tables, walked window by window as the kernel probes them
    (``filtered_count_plain``), count what ``find_count_batch_plain`` and the
    Pallas kernel count, and find the last match the plain rfind finds."""
    n = staged.n
    needles = _filter_batches(hay[:n].tobytes())[name]
    cap = max(4 if len(t) <= 13 else 8 for t in needles)
    packed = [JF.pack_needle(t, cap) for t in needles]
    batch = F.NeedleBatch.from_needles([_port(p) for p in packed])
    hay_t = torch.from_numpy(hay)
    counts, lasts = F.filtered_count_plain(hay_t, batch, n)
    want = np.asarray(JP.find_count_cycle(staged, JP.NeedleBatch(staged, packed), interpret=True))
    np.testing.assert_array_equal(counts, want)
    for extent in (n, n - 3):
        counts, lasts = F.filtered_count_plain(hay_t, batch, extent)
        want_counts, want_lasts = F.rfind_count_batch_plain(hay_t, batch, extent)
        np.testing.assert_array_equal(counts, want_counts.numpy())
        np.testing.assert_array_equal(lasts, want_lasts.numpy())


_NUL_BATCHES = {  # needles, and the filters the kernel is built for on their table
    "one word, three lengths": ([b"a", b"a\0", b"\0", b"\0\0b"], 3),
    "a and a-nul": ([b"a", b"a\0"], 2),
    "nul and two nuls": ([b"\0", b"\0\0"], 2),
    "one nul": ([b"\0"], 0),
    "one key, two lengths past it": ([b"a\0\0\0\0", b"a\0\0\0"], 0),
}


@pytest.mark.parametrize("name", sorted(_NUL_BATCHES))
def test_filter_walk_of_needles_with_nul_bytes(name):
    """Needles whose keys are equal as words but of different lengths
    (b"a" and b"a\\0") take one filter each, so the kernel's one-key
    instance (``filters`` 0) is kept for a batch of one key length and one
    key; the walk, which takes that instance where the kernel does, counts
    what a byte-by-byte search counts."""
    needles, want_filters = _NUL_BATCHES[name]
    rng = np.random.default_rng(9)
    hay = np.frombuffer(b"\0ab", np.uint8)[rng.integers(0, 3, 20_003)]
    hay[rng.integers(0, hay.size - 5, 40)] = 0  # runs of NULs
    batch = F.NeedleBatch.from_needles([F.pack_needle(t) for t in needles])
    assert batch.filters(torch.device("cpu")).filters == want_filters
    hay_t = torch.from_numpy(hay.copy())
    for extent in (hay.size, hay.size - 3):
        counts, lasts = F.filtered_count_plain(hay_t, batch, extent)
        want_counts, want_lasts = F.rfind_count_batch_plain(hay_t, batch, extent)
        np.testing.assert_array_equal(counts, want_counts.numpy())
        np.testing.assert_array_equal(lasts, want_lasts.numpy())
        brute = [_brute(hay[:extent].tobytes(), t) for t in needles]
        assert counts.tolist() == [len(x) for x in brute] and min(counts) > 0


def test_filter_walk_of_needles_past_the_halo(hay):
    """Needles longer than the kernel's 1 KiB staged halo: the walk reads
    them past it, as the kernel reads them from global memory."""
    b = hay.tobytes()
    needles = [b[5000:6100], b[N - 2000 :], b"a" * 600, b"a" * 700, b"a" * 701, b"d" * 1500, b[:1030]]
    batch = F.NeedleBatch.from_needles([F.pack_needle(t) for t in needles])
    hay_t = torch.from_numpy(hay)
    for extent in (N, N - 1):
        counts, lasts = F.filtered_count_plain(hay_t, batch, extent)
        want_counts, want_lasts = F.rfind_count_batch_plain(hay_t, batch, extent)
        np.testing.assert_array_equal(counts, want_counts.numpy())
        np.testing.assert_array_equal(lasts, want_lasts.numpy())
        brute = [_brute(b[:extent], t) for t in needles]
        assert counts.tolist() == [len(x) for x in brute] and lasts.tolist() == [x[-1] if x else -1 for x in brute]


def test_filter_table_layout():
    """Two chunks for 1,100 needles; one filter a key length present, of 32
    slots a distinct key (2^10 to 2^15); the bitmap holds exactly the slots
    of its keys, and a slot's map entry leads to the pairs of exactly the
    needles whose key takes it, the last one flagged; each needle's first
    16 bytes and its length beside them."""
    rng = np.random.default_rng(8)
    needles = [bytes(rng.integers(97, 100, int(m), dtype=np.uint8)) for m in rng.integers(1, 21, 1100)]
    batch = F.NeedleBatch.from_needles([F.pack_needle(t) for t in needles])
    tables = batch.filters(torch.device("cpu"))
    assert tables.chunks == 2 and tables.filters == 4
    seen = []
    for c in range(2):
        chunk = tables.chunk(c)
        lo, hi = chunk["lo"], chunk["hi"]
        assert (lo, hi) == (1024 * c, min(1100, 1024 * (c + 1))) and chunk["longest"] == max(map(len, needles[lo:hi]))
        assert chunk["lengths"].tolist() == [len(t) for t in needles[lo:hi]]
        assert [row.tobytes() for row in chunk["prefix"]] == [t[:16].ljust(16, b"\0") for t in needles[lo:hi]]
        key_lengths = sorted({min(4, len(t)) for t in needles[lo:hi]})
        assert [L for L, *_ in chunk["filters"]] == key_lengths
        for L, shift, bitmap, slot_map in chunk["filters"]:
            mine = [i for i in range(lo, hi) if min(4, len(needles[i])) == L]
            keys = np.array([int.from_bytes(needles[i][:L], "little") for i in mine], np.uint32)
            bits = 32 - shift
            assert bits == max(10, min(15, int(np.ceil(np.log2(32 * len(set(keys.tolist())))))))
            slots = F.slot_of(keys, shift).tolist()
            bits_set = {w * 32 + b for w in range(bitmap.size) for b in range(32) if bitmap[w] >> b & 1}
            assert bits_set == set(np.flatnonzero(slot_map).tolist()) == set(slots)
            for slot in set(slots):
                entry, got = int(slot_map[slot]) - 1, []
                while True:
                    key, tag = (int(x) for x in chunk["pairs"][entry])
                    got.append(lo + (tag & ~F.LAST_PAIR))
                    assert key == int.from_bytes(needles[got[-1]][:L], "little")
                    if tag & F.LAST_PAIR:
                        break
                    entry += 1
                assert sorted(got) == sorted(i for i, k in zip(mine, slots) if k == slot)
            seen += mine
    assert sorted(seen) == list(range(1100))


def test_batches_built_from_device_rows_build_the_same_filters():
    """A batch built directly from another's rows (as the backward row and
    ``chip_smoke.py`` do) reads its needles back for its tables."""
    batch = F.NeedleBatch.from_needles([F.pack_needle(t) for t in (b"abc", b"hello", b"x")])
    direct = F.NeedleBatch(batch.images[1:2], batch.lengths[1:2], batch.host_lengths[1:2])
    cpu = torch.device("cpu")
    for single in (direct, batch.row(1), F.NeedleBatch.from_needles([F.pack_needle(b"hello")])):
        assert torch.equal(single.filters(cpu).table, batch.row(1).filters(cpu).table)
    assert batch.row(1).host_images is not None and direct.host_images is None


_SETS = {
    "tabs": b"\n\r\x0b\x0c",
    "html": b"</>&'\"=[]",
    "digits": b"0123456789",
    "all": bytes(range(256)),
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(_SETS))
def test_byteset_count_matches_jax(name):
    rng = np.random.default_rng(3)
    hay = rng.integers(0, 256, 100_003, dtype=np.uint8)
    hay[:300] = np.frombuffer(b"<a href=\"x\">\t12\n" * 18 + b"0" * 12, np.uint8)
    hay_t = torch.from_numpy(hay)
    charset = _SETS[name]
    table = F.pack_byteset(charset)
    np.testing.assert_array_equal(table.numpy(), np.asarray(JF.pack_byteset(charset)))
    for n in (hay.size, 301, 0):
        want = int(JF.byteset_count(hay, JF.pack_byteset(charset), n))
        assert F.byteset_count(hay_t, table, n) == want == int(np.isin(hay[:n], np.frombuffer(charset, np.uint8)).sum())


def test_public_functions_reject_bad_extent():
    hay = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError):
        F.find_count(hay, F.pack_needle(b"a"), 11)
    with pytest.raises(ValueError):
        F.byteset_count(hay.to(torch.int32), F.pack_byteset(b"a"))
    with pytest.raises(ValueError):
        F.pack_needle(b"")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points raise on a CPU tensor: they never compute there."""
    before = dict(find_cuda.LAUNCHES)
    hay = torch.zeros(4096, dtype=torch.uint8)
    batch = F.NeedleBatch.from_needles([F.pack_needle(b"ab")])
    with pytest.raises(ValueError, match="CUDA"):
        find_cuda.find_count_batch(hay, batch)
    with pytest.raises(ValueError, match="CUDA"):
        find_cuda.rfind_count_batch(hay, batch)
    with pytest.raises(ValueError, match="CUDA"):
        find_cuda.byteset_count(hay, F.pack_byteset(b"a"))
    assert find_cuda.LAUNCHES == before


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: a clear error, and no fallback to the plain versions."""
    monkeypatch.setattr(build.shutil, "which", lambda *args, **kwargs: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.library.cache_clear()
    try:
        with pytest.raises(build.KernelBuildError, match="nvcc"):
            build.library()
    finally:
        build.library.cache_clear()
    assert not list(tmp_path.iterdir())
