"""NFD rows at the multilingual corpus' ceiling (0xACFF) on the CPU: the
port's ``decompose_rows`` takes row 16's fused expand route there, as the JAX
function does; held to the JAX function with its Pallas kernel in interpret
mode (about 20 s of tracing and compiling a width), and to ``unicodedata``."""

import unicodedata

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stringwars_tpu.ops import normalize as JN
from stringwars_tpu_torch.ops import normalize as N
from _jax_unicode_cache import private_jax_unicode_cache  # noqa: F401
from _torch_threads import one_thread  # noqa: F401

MAX_CP = 0xACFF


@pytest.mark.parametrize("width", [32, 64])
def test_nfd_rows_at_0xacff_equal_jax(width):
    rng = np.random.default_rng(width)
    text = "".join(rng.choice(list("aé가각갂ᾂΐ ṩ") + ["q̣̇", "Å", "ẍ̧", "ḍ̇", "ǅ", "ཱི"], 20 * width))
    cps = torch.tensor([ord(c) for c in text], dtype=torch.int32)
    assert int(cps.max()) <= MAX_CP and N.decompose_route(False, MAX_CP, width) == "expand"
    rows = N.segment_rows(cps, False)
    assert len(rows) == 1 and rows[0].width == 64
    data, lengths = rows[0].rows[:, :width].contiguous(), rows[0].lengths.clamp(max=width)
    got, counts = N.decompose_rows(data, lengths, False, MAX_CP)
    want, want_counts = JN.decompose_rows(jnp.asarray(data.numpy()), jnp.asarray(lengths.numpy()), False, max_cp=MAX_CP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    if width == 64:  # whole rows: their outputs in order are the NFD of the text
        out = "".join("".join(map(chr, row[:k].tolist())) for row, k in zip(got, counts))
        assert out == unicodedata.normalize("NFD", text)
