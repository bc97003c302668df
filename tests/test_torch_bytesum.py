"""The port's bytesum against the JAX package (XLA and Pallas interpret)."""

import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import bytesum as JB
from stringwars_tpu_torch import tape
from stringwars_tpu_torch.ops import bytesum as B
from _torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("n", [0, 1, 3, 4095, (1 << 20) + 7])
def test_bytesum_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    padded = np.zeros(-(-n // 4) * 4, np.uint8)
    padded[:n] = data
    want = JB.bytesum(data)
    assert want == JB.bytesum_words_pallas(padded.view("<u4"), n, interpret=True)
    assert B.bytesum(torch.from_numpy(data)) == want == int(data.sum(dtype=np.int64))
    assert B.bytesum_plain(torch.from_numpy(data)).dtype == torch.int64


def test_bytesum_all_ff_past_the_i32_tier():
    n = 17 << 20  # 255 * n > 2^31: past the JAX package's first i32 tier (~8.4 MB)
    data = np.full(n, 0xFF, np.uint8)
    assert B.bytesum(torch.from_numpy(data)) == JB.bytesum(data) == 255 * n


def test_bytesum_of_a_tape_and_an_extent():
    tokens = [bytes(np.random.default_rng(5).integers(0, 256, k, dtype=np.uint8)) for k in (5, 100, 3000)]
    assert B.bytesum(tape.Tape.from_tokens(tokens)) == JB.bytesum(jax_tape.Tape.from_tokens(tokens))
    data = torch.arange(10, dtype=torch.uint8)
    assert B.bytesum(data, 4) == 6
    with pytest.raises(ValueError):
        B.bytesum(data, 11)


def test_bytesum_kernel_refuses_cpu_tensors():
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        B.bytesum_cuda(torch.zeros(64, dtype=torch.uint8))
    assert B.LAUNCHES == before
