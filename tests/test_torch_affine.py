"""The port's alignment scores against the JAX Gotoh Pallas kernel.

The same pairs go through the JAX ``affine_scores(..., interpret=True)`` and
the XLA ``similarity`` functions, and through the port's staging and
``affine_scores`` on the CPU (its plain route, the wavefront that the CUDA
kernel ``csrc/affine.cu`` is held against on the card). The host side of
the kernel's launch, the staged rows and the lanes per pair and strip
height (``group_shape``), is tested here. Scores are integers: every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import affine_pallas as JA
from stringwars_tpu.ops import similarity as JS
from stringwars_tpu_torch.ops import affine as A
from stringwars_tpu_torch.ops import affine_cuda
from stringwars_tpu_torch.ops import similarity as S
from _torch_threads import one_thread  # noqa: F401


# (gap_open, gap_extend, local) -> the JAX XLA function of the same score.
MODELS = {
    (-5, -1, False): JS.nw_score_affine,
    (-5, -1, True): JS.sw_score_affine,
    (-2, -2, False): JS.nw_score_linear,
    (-2, -2, True): JS.sw_score_linear,
}


def _tokens(rng, n, lo, hi):
    return [bytes(rng.integers(65, 69, int(rng.integers(lo, hi)), dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def mixed():
    """Mixed lengths with empty sides on either end."""
    rng = np.random.default_rng(42)
    a = [b"", b"abc", b"", b"A", b""] + _tokens(rng, 40, 1, 40)
    b = [b"xy", b"", b"", b"", b"A"] + _tokens(rng, 40, 1, 40)
    return a, b, JA.affine_from_tokens(a, b), A.affine_from_tokens(a, b)


@pytest.mark.parametrize("go,ge,local", list(MODELS), ids=["nw-affine", "sw-affine", "nw-linear", "sw-linear"])
def test_scores_match_pallas_kernel_xla_and_oracle(mixed, go, ge, local):
    a, b, ref, port = mixed
    got = A.affine_scores(port, 2, -1, go, ge, local=local)
    assert got.dtype == torch.int32 and got.shape == (len(a),)
    np.testing.assert_array_equal(got.numpy(), JA.affine_scores(ref, 2, -1, go, ge, local=local, interpret=True))
    pairs = port.pairs
    xla = MODELS[(go, ge, local)](JS.PairBatch(*(jnp.asarray(t.numpy()) for t in (pairs.a, pairs.b, pairs.a_len, pairs.b_len))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    oracle = S.sw_ref if local else S.nw_ref
    np.testing.assert_array_equal(got.numpy(), [oracle(list(x), list(y), 2, -1, go, ge) for x, y in zip(a, b)])


def test_empty_and_edge():
    port = A.affine_from_tokens([b"", b"abc", b""], [b"xy", b"", b""])
    # all-gap alignments: open + (n-1) * extend
    assert A.affine_scores(port).tolist() == [-5 + -1 * 1, -5 + -1 * 2, 0]
    assert A.affine_scores(port, local=True).tolist() == [0, 0, 0]


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_uniform_full_batch(local, linear):
    """Every pair fills its rectangle (the JAX kernel's slab-extraction path)."""
    rng = np.random.default_rng(5)
    a = [bytes(rng.integers(65, 69, 17, dtype=np.uint8)) for _ in range(19)]
    b = [bytes(rng.integers(65, 69, 23, dtype=np.uint8)) for _ in range(19)]
    ref = JA.affine_from_tokens(a, b)
    assert ref.uniform_full
    go, ge = (-2, -2) if linear else (-5, -1)
    got = A.affine_scores(A.affine_from_tokens(a, b), 2, -1, go, ge, local=local)
    np.testing.assert_array_equal(got.numpy(), JA.affine_scores(ref, 2, -1, go, ge, local=local, interpret=True))


def test_staging_transposes_the_pairs(mixed):
    """The staged batch is the pairs' own rows, which the kernel reads as
    they are: its lanes own strips of a pair's rows. The name dates from the
    kernel of one thread a pair, which read transposed columns; the check
    of the staged layout kept it."""
    a, b, _, port = mixed
    width = max(len(t) for t in a + b)
    for tokens, rows in ((a, port.pairs.a), (b, port.pairs.b)):
        assert rows.dtype == torch.int32 and rows.shape == (len(a), width) and rows.is_contiguous()
        for i, t in enumerate(tokens):
            assert rows[i, : len(t)].tolist() == list(t) and not rows[i, len(t):].any()
    assert port.count == len(a) and port.cells() == sum(len(x) * len(y) for x, y in zip(a, b))
    assert port.cells() == port.pairs.dp_cells()
    assert port.shape() == A.group_shape(max(len(t) for t in a), len(a))


@pytest.mark.parametrize(
    "max_a,pairs,shape",
    [
        (100, 4096, (16, 8)),  # the similarities suite: 16 lanes a pair fill the card
        (256, 65536, (16, 16)),  # many pairs: the narrowest group, widened to hold 256 rows in one pass
        (1000, 33856, (32, 16)),  # the reference's 1 KB cell: two passes of 512 rows
        (7, 100000, (8, 8)),
        (0, 10, (32, 8)),
        (3000, 40, (32, 16)),
        (129, 1584, (32, 8)),
        (129, 12672, (16, 16)),
    ],
)
def test_group_shape(max_a, pairs, shape):
    """Lanes per pair and strip height: the narrowest group that gives the
    card WARPS_PER_SM warps an SM, widened while a strip would pass the tallest; the
    lowest strip that holds a lane's share of the longest a."""
    group, rows = A.group_shape(max_a, pairs)
    assert (group, rows) == shape
    assert group in A.LANE_GROUPS and rows in A.STRIP_ROWS
    if group * rows < max_a:  # several passes only where even the widest group's tallest strip is too short
        assert (group, rows) == (A.LANE_GROUPS[-1], A.STRIP_ROWS[-1])
    narrower = [g for g in A.LANE_GROUPS if g < group]
    assert all(pairs * g < A.WARPS_PER_SM * A.H100_SMS * 32 or -(-max_a // g) > A.STRIP_ROWS[-1] for g in narrower)


@pytest.mark.parametrize("max_a,pairs,sms,shape", [(100, 6000, 132, (16, 8)), (100, 6000, 114, (8, 16)), (100, 4096, 66, (8, 16))])
def test_group_shape_follows_the_card(max_a, pairs, sms, shape):
    """A card of fewer SMs fills at a narrower group: 6,000 pairs give an
    H100 SXM's 132 SMs too few warps at 8 lanes a pair, 114 SMs enough."""
    assert A.group_shape(max_a, pairs, sms) == shape
    assert A.group_shape(max_a, pairs) == A.group_shape(max_a, pairs, A.H100_SMS)


def test_cuda_wrapper_refuses_cpu_batches(mixed):
    port = mixed[3]
    before = dict(affine_cuda.LAUNCHES)
    for go, ge in ((-5, -1), (-2, -2)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            affine_cuda.align(port, 2, -1, go, ge, local=False)
    assert affine_cuda.LAUNCHES == before
