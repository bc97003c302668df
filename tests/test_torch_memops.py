"""The port's fill, copy and move (``stringwars_tpu_torch.ops.memops``)
against the JAX package's (``stringwars_tpu/ops/memops.py:86-100``) on the
same numpy-seeded buffers, exactly."""

import numpy as np
import pytest
import torch

from stringwars_tpu.ops import memops as JM
from stringwars_tpu_torch.ops import memops as M
from _torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("n, value", [(0, 7), (1, 0), (100, 7), (4099, 0x1FF)])
def test_fill_equals_jax(n, value):
    got = M.fill(n, value, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.fill(n, value & 0xFF)))
    out = torch.full((n,), 3, dtype=torch.uint8)
    assert M.fill(n, value, out=out) is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(JM.fill(n, value & 0xFF)))
    with pytest.raises(ValueError):
        M.fill(n + 1, value, out=out)


@pytest.mark.parametrize("n", [0, 1, 100, 65537])
def test_copy_equals_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    src = torch.from_numpy(data)
    got = M.copy(src)
    assert got.data_ptr() != src.data_ptr() or n == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.copy(data)))
    out = torch.empty(n, dtype=torch.uint8)
    assert M.copy(src, out=out) is out
    np.testing.assert_array_equal(out.numpy(), data)


@pytest.mark.parametrize("n, shift", [(8, 8), (9, 8), (100, 8), (65537, 8), (100, 1), (100, 0)])
def test_move_equals_jax(n, shift):
    data = np.random.default_rng(n + shift).integers(0, 256, n, dtype=np.uint8)
    got = M.move(torch.from_numpy(data), shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.move(data, shift)))
    np.testing.assert_array_equal(got.numpy()[: n - shift], data[shift:])
    assert not got.numpy()[n - shift :].any()
    out = torch.full((n,), 0xAA, dtype=torch.uint8)
    assert M.move(torch.from_numpy(data), shift, out=out) is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(JM.move(data, shift)))
    with pytest.raises(ValueError):
        M.move(torch.from_numpy(data), n + 1)
