"""The port's fused expand-and-compact (``ops/expand.py``) against the JAX
Pallas kernel (``casefold_pallas``, interpret mode) and the JAX staged fold.

On the CPU the port runs ``expand_compact_rows_plain``, the semantics the
CUDA kernel ``csrc/expand.cu`` is held to on the card. Outputs are
integers: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import casefold as JC
from stringwars_tpu.ops import casefold_pallas as JP
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu_torch.ops import casefold as C
from stringwars_tpu_torch.ops import expand as E
from stringwars_tpu_torch.ops import expand_cuda as EC
from stringwars_tpu_torch.tape import PaddedTokens
from _torch_threads import one_thread  # noqa: F401


def _jax_tokens(tokens: PaddedTokens) -> JaxPaddedTokens:
    return JaxPaddedTokens(data=jnp.asarray(tokens.data.numpy()), lengths=jnp.asarray(tokens.lengths.numpy()),
                           width=tokens.width)


def _rows(rng, alphabet: str, count: int, width: int) -> PaddedTokens:
    data = np.zeros((count, width), np.uint8)
    lengths = np.zeros(count, np.int32)
    chars = list(alphabet)
    for i in range(count):
        raw = b""
        for c in rng.choice(chars, int(rng.integers(0, width + 1))):
            if len(raw) + len(c.encode()) > width:
                break
            raw += c.encode()
        data[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lengths[i] = len(raw)
    return PaddedTokens.from_numpy(data, lengths)


def _equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def test_prepare_tables_padding_equals_jax(rng):
    for size in (1, 127, 128, 300, 3000):
        t1 = rng.integers(-(2**31), 2**31, size).astype(np.int32)
        t2 = rng.integers(-(2**31), 2**31, size).astype(np.int32)
        got = E.prepare_tables(t1, t2)
        mode, n_entries, _, arrays = JP.prepare_tables(t1, t2)
        assert got.size == n_entries == -(-size // 128) * 128
        if mode == "direct":
            for g, w in zip(got.tables, arrays):
                np.testing.assert_array_equal(g, w)
        assert (got.tables[0][size:] == 1 << 16).all() and (got.tables[1][size:] == 0).all()
    with pytest.raises(ValueError):
        E.prepare_tables(t1, t2, t2, t2)


@pytest.mark.parametrize("max_cp", [0xFF, 0xFFFF])
def test_fold_tables_equal_jax(max_cp):
    got = E.fold_tables(max_cp)
    mode, n_entries, _, arrays = JP._fold_tables(max_cp)
    assert got.size == n_entries
    if mode == "direct":
        for g, w in zip(got.tables, arrays):
            np.testing.assert_array_equal(g, w)
    else:  # the paged form: page map + deduplicated pages; expand it
        pm, *pages = arrays
        for k, g in enumerate(got.tables):
            dense = np.asarray(pages[k]).reshape(-1, 128)[pm[: n_entries // 128]].reshape(-1)
            np.testing.assert_array_equal(g, dense)


@pytest.mark.parametrize(
    "max_cp,alphabet,max_exp",
    [
        (0xFF, "aAbB ßxyzÉÀÿ", 2),  # 2-output regime (ß)
        (0xFFFF, "aAßẞΣσςΐΰﬃİǅ Ⅻ日本한ω", 3),  # 3-output regime (ΐ, ΰ, ﬃ)
    ],
)
def test_fold_tokens_fused_equals_jax_kernel(max_cp, alphabet, max_exp, rng):
    tokens = _rows(rng, alphabet, 200, 32)
    assert C._fold_rules(max_cp)[4] == max_exp
    want = JP.fold_tokens_fused(_jax_tokens(tokens), max_cp, interpret=True)
    got = E.fold_tokens_fused(tokens, max_cp)
    assert tuple(got[0].shape) == (200, 32 * max_exp)
    _equal(got, want)
    # The same matrix as the staged fold of the port.
    staged = C.fold_tokens(tokens, max_cp=max_cp)
    assert torch.equal(got[0], staged[0]) and torch.equal(got[1], staged[1])


def test_expand_invalid_utf8_equals_jax_kernel(rng):
    """Random bytes (invalid leads 0xF8-0xFF, truncated sequences, stray
    continuations), lengths 0..32, the unpruned BMP fold tables at max_exp 3."""
    data = rng.integers(0, 256, (160, 32)).astype(np.uint8)
    data[:20] = rng.choice(np.array([0xC3, 0x9F, 0xCE, 0x90, 0xF8, 0xFF, 0x80, 0x41], np.uint8), (20, 32))
    lengths = rng.integers(0, 33, 160).astype(np.int32)
    want = JP.expand_compact_rows(jnp.asarray(data), jnp.asarray(lengths), JP._fold_tables(0xFFFF), 3, 32, True, True)
    got = E.expand_compact_rows(torch.from_numpy(data), torch.from_numpy(lengths), E.fold_tables(0xFFFF), 3, 32, True)
    _equal(got, want)


def test_expand_group64_int32_three_tables_equals_jax_kernel(rng):
    """Codepoint rows of 64, a synthetic 3-table set with lengths 0..4 (and a
    few longer, cut at the row's width), max_exp 4; codepoints below 0 and
    past the table clamp."""
    size = 3000
    length = rng.integers(0, 5, size)
    length[:5] = 9
    t1 = ((rng.integers(-300, 300, size) & 0xFFFF) | (length << 16)).astype(np.int32)
    t2 = rng.integers(-(2**31), 2**31, size).astype(np.int32)
    t3 = rng.integers(-(2**31), 2**31, size).astype(np.int32)
    data = rng.integers(-5, size + 200, (160, 64)).astype(np.int32)
    data[:4, :8] = np.arange(5)[rng.integers(0, 5, (4, 8))]
    lengths = rng.integers(0, 65, 160).astype(np.int32)
    want = JP.expand_compact_rows(jnp.asarray(data), jnp.asarray(lengths), JP.prepare_tables(t1, t2, t3), 4, 64, False, True)
    got = E.expand_compact_rows(torch.from_numpy(data), torch.from_numpy(lengths), E.prepare_tables(t1, t2, t3), 4, 64, False)
    _equal(got, want)


def test_fold_tokens_fused_dispatches_by_shape(rng):
    """Widths other than 32 and ceilings above 0xFFFF take the staged fold,
    as in the JAX function."""
    wide = _rows(rng, "aAßΐΣ", 64, 40)  # BMP: within the ceiling
    for max_cp, tokens in ((0xFFFF, wide), (0x10FFFF, _rows(rng, "aAßΐ𐐀", 64, 32))):
        want = JC.fold_tokens(_jax_tokens(tokens), max_cp=max_cp)
        _equal(E.fold_tokens_fused(tokens, max_cp), want)


def test_expand_rejects_what_the_kernel_does_not_take():
    tables = E.fold_tables(0xFF)
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    lengths = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        E.expand_compact_rows(rows, lengths, tables, 5, 32, True)
    with pytest.raises(ValueError):
        E.expand_compact_rows(rows, lengths, tables, 2, 48, True)
    with pytest.raises(ValueError):
        E.expand_compact_rows(rows, lengths, tables, 2, 32, False)  # uint8 rows as codepoints
    with pytest.raises(ValueError):
        EC.expand_compact_rows(rows, lengths, tables, 2, 32, True)  # the kernel needs the card
