"""The port's BPE encoder at every batch width the CUDA kernel takes (1 to
32 slots a row), rows of length 0 included, against the JAX XLA encoder and
the fused Pallas kernel in interpret mode (one JAX compile of each per
width). The kernel is held to the same plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest

from test_torch_bpe import assert_encoders_equal_jax, words


@pytest.fixture(scope="module")
def merges():
    from stringwars_tpu.ops import bpe as JB

    rng = np.random.default_rng(32)
    return JB.train_merges(words(rng, b"abcd", 1, 32, 600), 60)


@pytest.mark.parametrize("width", range(1, 33))
def test_width_equals_jax(width, merges):
    rng = np.random.default_rng(width)
    rows = words(rng, b"abcd", 0, width, 48) + [b"", b"a" * width, b"ab" * (width // 2)]
    assert_encoders_equal_jax(rows, merges, width)
