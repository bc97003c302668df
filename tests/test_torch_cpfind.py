"""The port's codepoint-window count (``ops/find.cp_window_count``) against
the JAX Pallas kernel (``find_pallas.cp_window_count`` over
``stage_cp_rows``, interpret mode) and the JAX XLA window count.

The JAX kernel takes needles of at most ``CP_HALO + 1`` = 129 codepoints
(fault F3); longer needles are held to ``casefold._window_count`` alone.
The port has no such limit. Counts are integers: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import casefold as JC
from stringwars_tpu.ops import find_pallas as JFP
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.ops import find_cuda as FC
from _torch_threads import one_thread  # noqa: F401


def _stream(rng, n):
    """Codepoints from a small alphabet (many matches), one long run of a
    single codepoint (overlapping matches), and astral values."""
    s = rng.choice(np.array([0x61, 0x62, 0x3C3, 0xDF, 0x1F389], np.int32), n)
    s[n // 3 : n // 3 + 400] = 0x61
    return s


def _jax_kernel_count(stream, n, needle):
    rows, chunk = JFP.stage_cp_rows(stream, n)
    meta = jnp.asarray([n, chunk], jnp.int32)
    return int(JFP.cp_window_count(jnp.asarray(rows), jnp.asarray(needle), meta, needle.size, interpret=True))


def _jax_xla_count(stream, n, needle):
    return int(JC._window_count(jnp.asarray(stream), jnp.asarray(needle), jnp.int32(n), needle.size))


@pytest.mark.parametrize("m", [1, 2, 3, 8, 129])
def test_cp_window_count_equals_jax_kernel(m, rng):
    n = 20_000
    stream = _stream(rng, n)
    needles = [stream[p : p + m].copy() for p in (0, 777, n - m, n // 3 + 5)]
    needles.append(np.full(m, 0x61, np.int32))
    for needle in needles:
        for extent in (n, n - 1, m):
            got = F.cp_window_count(torch.from_numpy(stream), extent, torch.from_numpy(needle))
            assert got.dtype == torch.int64 and got.dim() == 0
            assert int(got) == _jax_kernel_count(stream, extent, needle)


@pytest.mark.parametrize("m", [130, 300])
def test_cp_window_count_past_the_jax_kernels_limit(m, rng):
    n = 5_000
    stream = _stream(rng, n)
    for needle in (stream[100 : 100 + m].copy(), np.full(m, 0x61, np.int32), stream[n - m :].copy()):
        want = _jax_xla_count(stream, n, needle)
        assert int(F.cp_window_count(torch.from_numpy(stream), n, torch.from_numpy(needle))) == want
        # Brute force, overlapping windows included.
        brute = sum(np.array_equal(stream[p : p + m], needle) for p in range(n - m + 1))
        assert want == brute


def test_cp_window_count_edges():
    stream = torch.tensor([5, 5, 5, 5], dtype=torch.int32)
    assert int(F.cp_window_count(stream, 4, torch.tensor([5, 5], dtype=torch.int32))) == 3
    assert int(F.cp_window_count(stream, 1, torch.tensor([5, 5], dtype=torch.int32))) == 0  # m > n
    assert int(F.cp_window_count(stream, 0, torch.tensor([5], dtype=torch.int32))) == 0
    with pytest.raises(ValueError):
        F.cp_window_count(stream, 4, torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError):
        F.cp_window_count(stream, 5, torch.tensor([5], dtype=torch.int32))
    with pytest.raises(ValueError):
        F.cp_window_count(stream.to(torch.int64), 4, torch.tensor([5], dtype=torch.int32))
    with pytest.raises(ValueError):
        FC.cp_window_count(stream, 4, torch.tensor([5], dtype=torch.int32))  # the kernel needs the card
