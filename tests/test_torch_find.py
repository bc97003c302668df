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
