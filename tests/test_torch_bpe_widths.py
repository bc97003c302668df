"""The port's BPE encoder at every batch width the CUDA kernel takes (1 to
32 slots a row), rows of length 0 included, against the JAX XLA encoder and
the fused Pallas kernel in interpret mode. The JAX side encodes every
width's rows once, at width 32 (one compile of each): a row's ids do not
depend on the width it is padded to, so each width's rows are held to
their slice of that batch, and the ids past the width must be the fill.
The kernel is held to the same plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import bpe as JB
from stringwars_tpu.ops import bpe_pallas as JP
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu_torch.ops import bpe as B
from test_torch_bpe import carried, words

WIDTHS = range(1, 33)


def width_rows(width: int) -> list[bytes]:
    rng = np.random.default_rng(width)
    return words(rng, b"abcd", 0, width, 48) + [b"", b"a" * width, b"ab" * (width // 2)]


@pytest.fixture(scope="module")
def merges():
    rng = np.random.default_rng(32)
    return JB.train_merges(words(rng, b"abcd", 1, 32, 600), 60)


@pytest.fixture(scope="module")
def jax_encoded(merges):
    """width -> [(ids, counts)] of the JAX XLA encoder and the fused Pallas
    kernel (interpret mode) for that width's rows, from one batch of every
    width's rows at width 32."""
    jt, _ = carried(merges)
    rows = [r for w in WIDTHS for r in width_rows(w)]
    data, lengths = B.pack_rows(rows, max(WIDTHS))
    jax_tokens = JaxPaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=data.shape[1])
    wants = [JB.bpe_encode(jax_tokens, jt), JP.bpe_encode_fused(jax_tokens, jt, interpret=True)]
    wants = [(np.asarray(ids), np.asarray(counts)) for ids, counts in wants]
    out, first = {}, 0
    for w in WIDTHS:
        count = len(width_rows(w))
        out[w] = [(ids[first : first + count], counts[first : first + count]) for ids, counts in wants]
        first += count
    return out


@pytest.mark.parametrize("width", WIDTHS)
def test_width_equals_jax(width, merges, jax_encoded):
    _, table = carried(merges)
    data, lengths = B.pack_rows(width_rows(width), width)
    assert data.shape[1] == width
    d, l = torch.from_numpy(data), torch.from_numpy(lengths)
    for got in (B.bpe_encode_plain(d, l, table), B.bpe_encode(d, l, table), B.bpe_encode_fused(d, l, table)):
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        for ids, counts in jax_encoded[width]:
            assert (ids[:, width:] == -1).all()
            np.testing.assert_array_equal(got[0].numpy(), ids[:, :width])
            np.testing.assert_array_equal(got[1].numpy(), counts)
