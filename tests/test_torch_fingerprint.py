"""The port's MinHash fingerprints and LUT translate against the JAX package,
on the CPU. Values and counts are integers: every comparison is exact."""

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import fingerprint as JF
from stringwars_tpu.ops import memops as JM
from stringwars_tpu_torch import tape
from stringwars_tpu_torch.ops import fingerprint as F
from stringwars_tpu_torch.ops import memops as M
from _torch_threads import one_thread  # noqa: F401


def _docs(seed: int = 42) -> list[bytes]:
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(32, 127, rng.integers(1, 90), dtype=np.uint8)) for _ in range(30)]
    return docs + [b"", b"x", b"abcd", b"y" * 32, b"z" * 33, b"ab" * 40, bytes(range(256))]


def _both(docs, **kw):
    return (
        jax_tape.PaddedTokens.from_tape(jax_tape.Tape.from_tokens(docs), **kw),
        tape.PaddedTokens.from_tape(tape.Tape.from_tokens(docs), **kw),
    )


@pytest.mark.parametrize("align", [4, 64])
@pytest.mark.parametrize("ndim,with_counts", [(64, True), (32, False), (8, True)])
def test_fingerprint_matches_fingerprint_xla(align, ndim, with_counts):
    ref, port = _both(_docs(), align=align)
    want_h, want_c = JF.fingerprint_xla(ref, ndim=ndim, with_counts=with_counts)
    got_h, got_c = F.fingerprint(port, ndim=ndim, with_counts=with_counts)
    assert got_h.dtype == torch.uint32 and got_h.shape == (port.count, ndim)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    if with_counts:
        assert got_c.dtype == torch.int32
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    else:
        assert got_c is None and want_c is None


def test_rows_read_their_own_bytes_past_the_length():
    """Bytes past a token's length but inside its row enter the position-0
    gram (as in JAX's padded inputs of ``__graft_entry__``); bytes past the
    row's width read as zero, never as the next row's."""
    rng = np.random.default_rng(0)
    data = rng.integers(32, 127, (16, 12), dtype=np.uint8)
    lengths = rng.integers(1, 12, 16, dtype=np.int32)
    ref = jax_tape.PaddedTokens(data=data, lengths=lengths, width=12)
    port = tape.PaddedTokens.from_numpy(data, lengths, 12)
    want_h, want_c = JF.fingerprint_xla(ref, ndim=16)
    got_h, got_c = F.fingerprint(port, ndim=16)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_fingerprint_matches_the_pallas_kernel():
    """Once, against JAX ``fingerprint(..., interpret=True)`` (the Pallas
    kernel that ``csrc/fingerprint.cu`` replaces), as
    ``tests/test_fingerprint.py`` runs it."""
    docs = [t or b"\x00" for t in _docs(7)]
    ref, port = _both(docs, align=4)
    want_h, want_c = JF.fingerprint(ref, ndim=64, interpret=True)
    got_h, got_c = F.fingerprint_plain(port, ndim=64)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_fingerprint_matches_the_spec_replay():
    docs = [b"hello world, this is a document about fingerprinting", b"tiny", b"x" * 40]
    _, port = _both(docs)
    got_h, got_c = F.fingerprint(port, ndim=16)
    for i, doc in enumerate(docs):
        want_h, want_c = F.fingerprint_ref(doc, ndim=16)
        np.testing.assert_array_equal(got_h[i].numpy(), want_h)
        np.testing.assert_array_equal(got_c[i].numpy(), want_c)
        jax_h, jax_c = JF.fingerprint_ref(doc, ndim=16)
        np.testing.assert_array_equal(want_h, jax_h)
        np.testing.assert_array_equal(want_c, jax_c)


def _periodic_docs() -> list[bytes]:
    """Documents whose grams repeat (counts far above 1), and documents of
    0 to 40 B of a-c, shorter and longer than each width (5, 9, 17, 33)."""
    rng = np.random.default_rng(4)
    periodic = [b"ab" * 600, b"z" * 1280, (b"the same line again\n" * 64)[:1280], b"abc" * 400, b"ab" * 3, b"z" * 40]
    return periodic + [bytes(rng.integers(97, 100, k, dtype=np.uint8)) for k in range(41)]


@pytest.mark.parametrize("ndim", [4, 8, 64, 256])
def test_counts_from_the_argmin_match_plain_and_jax(ndim):
    """The kernel's count method (only the min a dim, then the multiplicity
    of the gram a^-1 * (m - b) among the valid positions) equals the count
    of positions that reach the min, here and in the JAX package."""
    ref, port = _both(_periodic_docs(), align=4)
    got_h, got_c = F.fingerprint_argmin_plain(port, ndim)
    want_h, want_c = F.fingerprint_plain(port, ndim)
    np.testing.assert_array_equal(got_h.numpy(), want_h.numpy())
    np.testing.assert_array_equal(got_c.numpy(), want_c.numpy())
    jax_h, jax_c = JF.fingerprint_xla(ref, ndim=ndim, with_counts=True)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(jax_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jax_c))
    assert int(got_c.max()) > 600  # b"z" * 1280: 1276 positions share each gram


def test_counts_from_the_argmin_match_the_pallas_kernel():
    docs = [t or b"\x00" for t in _periodic_docs()]
    ref, port = _both(docs, align=64)
    want_h, want_c = JF.fingerprint(ref, ndim=16, with_counts=True, interpret=True)
    got_h, got_c = F.fingerprint_argmin_plain(port, 16)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_dim_inverses():
    """a * a^-1 = 1 (mod 2^32) for every coefficient the kernel takes, and
    for odd numbers at the edges; an even number has no inverse."""
    for ndim in (4, 64, 512, 4096):
        a, _ = F.dim_coefficients(ndim)
        assert np.all((a.astype(np.uint64) * F.dim_inverses(a) & 0xFFFFFFFF) == 1)
    edges = np.array([1, 3, 0xFFFFFFFF, 0x80000001, 0x9E3779B9], np.uint32)
    assert np.all((edges.astype(np.uint64) * F.dim_inverses(edges) & 0xFFFFFFFF) == 1)
    with pytest.raises(ValueError):
        F.dim_inverses(np.array([2], np.uint32))


def test_dim_coefficients_and_ndim_check():
    for ndim in (4, 64, 512):
        for got, want in zip(F.dim_coefficients(ndim), JF.dim_coefficients(ndim)):
            np.testing.assert_array_equal(got, want)
    _, port = _both([b"abc"])
    with pytest.raises(ValueError):
        F.fingerprint(port, ndim=10)


def test_quality_metrics_match_jax():
    rng = np.random.default_rng(3)
    mh = rng.integers(0, 2**32, (40, 32), dtype=np.uint64).astype(np.uint32)
    mh[:5, :4] = 7  # some collisions
    assert F.bit_entropy(mh) == JF.bit_entropy(mh)
    assert F.collision_rate(mh) == JF.collision_rate(mh)
    assert F.collision_rate(mh[:1]) == 0.0


@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (64, 64)])
def test_lut_translate_matches_gather(shape):
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    for lut in (M.invert_case_lut(), np.arange(256, dtype=np.uint8)[::-1].copy()):
        want = np.asarray(JM.lut_translate_gather(data, lut))
        got = M.lut_translate(torch.from_numpy(data), torch.from_numpy(lut))
        assert got.dtype == torch.uint8 and got.shape == data.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(M.invert_case_lut(), JM.invert_case_lut())


def test_cuda_wrappers_refuse_cpu_tensors():
    _, port = _both([b"abc"])
    before = (dict(F.LAUNCHES), dict(M.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA tensor"):
        F.fingerprint_cuda(port, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        M.lut_translate_cuda(port.data, torch.from_numpy(M.invert_case_lut()))
    assert (F.LAUNCHES, M.LAUNCHES) == before
