"""The port's counter-based random fill against ``jax.random.bits``, on the CPU.

``fill_random`` is Threefry-2x32 bit for bit with the JAX package's
``memops.fill_random`` (``jax_threefry_partitionable``: word i under the
key (0, seed) at the counter (i >> 32, i & 0xFFFFFFFF)). ``chip_smoke.py``
pins JAX's words as constants, since the machine with the card has no JAX;
they are held to ``jax.random.bits`` here.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import memops as JM
from stringwars_tpu_torch.ops import memops as M
from _torch_threads import one_thread  # noqa: F401


SEEDS = [0, 1, 2, 77, 2**31 - 1]
SIZES = [0, 1, 3, 4, 5, 1000, 65539]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_fill_random_matches_jax(seed, n):
    got = M.fill_random(seed, n, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (n,)
    assert got.numpy().tobytes() == np.asarray(JM.fill_random(seed, n)).tobytes()


@pytest.mark.parametrize("seed", [1, 77])
def test_fill_random_words_match_jax(seed):
    got = M.fill_random_words(seed, 4099, "cpu")
    assert got.dtype == torch.uint32 and got.shape == (1025,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.fill_random_words(seed, 4099)))


def test_pinned_words_of_chip_smoke_match_jax():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.THREEFRY_PINS
    for seed, (count, at, words) in smoke.THREEFRY_PINS.items():
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (count,), dtype=jnp.uint32))
        assert list(words) == want[at : at + len(words)].tolist()
        assert M.threefry_bits_plain(seed, count)[at : at + len(words)].tolist() == list(words)


def test_key_of_a_seed():
    assert M.threefry_key(77) == (0, 77)
    assert M.threefry_key((5 << 32) | 9) == (5, 9)
    with pytest.raises(ValueError):
        M.threefry_key(-1)
    with pytest.raises(ValueError):
        M.fill_random(1, -1, "cpu")


def test_kernel_wrapper_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        M.threefry_bits_cuda(1, 8, "cpu")
