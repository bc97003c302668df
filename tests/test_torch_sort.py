"""The port's stable argsort (``stringwars_tpu_torch.ops.sort``) against the
JAX package's (``stringwars_tpu.ops.sort``) on the same numpy-seeded
inputs, exactly: the key columns, both JAX sort paths (one multi-key sort
up to 8 columns, LSD passes past that), the host tie refinement, the
``out=`` buffer and the case-folded order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import sort as JS
from stringwars_tpu_torch.ops import sort as S
from stringwars_tpu_torch.tape import Tape
from _radix_plan import digit_plan
from _torch_threads import one_thread  # noqa: F401


def _both(tokens):
    return Tape.from_tokens(tokens), jax_tape.Tape.from_tokens(tokens)


def _casefold_key(token: bytes) -> str:
    return token.decode("utf-8", "ignore").casefold()


@pytest.mark.parametrize("width", [9, 24, 30, 48])  # 3 and 8 columns: JAX's multi-key sort; 10 and 16: its LSD passes
def test_columns_and_order_equal_jax(width):
    rng = np.random.default_rng(width)
    B = 3000
    data = rng.integers(97, 101, (B, width), dtype=np.uint8)  # few values: ties everywhere
    lengths = rng.integers(0, width + 1, B).astype(np.int32)
    jcols = JS._byte_columns(jnp.asarray(data), jnp.asarray(lengths))
    cols = S.byte_columns(torch.from_numpy(data), torch.from_numpy(lengths))
    np.testing.assert_array_equal(cols.numpy().astype(np.int64), np.asarray(jcols).astype(np.int64))
    assert (jcols.shape[0] <= JS._MULTIKEY_MAX_COLS) == (width <= 24)
    want = np.asarray(JS._lsd_argsort(jcols))
    np.testing.assert_array_equal(S.lsd_argsort(cols).numpy(), want)
    keys = [data[i, : lengths[i]].tobytes() for i in range(B)]
    assert want.tolist() == sorted(range(B), key=keys.__getitem__)


def test_binary_bytes_stability_and_prefixes():
    rng = np.random.default_rng(1)
    tokens = [bytes(rng.integers(0, 256, rng.integers(0, 12), dtype=np.uint8)) for _ in range(1500)]
    tokens += [b"\x00", b"\x00\x00", b"", b"\xff", b"\xff\xff", b"\xff\x00", b"\x00\xff", b"ab", b"a", b"abc", b""]
    tokens += [tokens[i] for i in rng.integers(0, len(tokens), 300)]  # duplicates: stability
    tape, jtape = _both(tokens)
    got = S.argsort_tape(tape)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_tape(jtape)))
    assert got.tolist() == sorted(range(len(tokens)), key=tokens.__getitem__)
    assert S.argsort_tape(Tape.from_tokens([b"b", b"a", b"b", b"a", b"a"])).tolist() == [1, 3, 4, 0, 2]


@pytest.mark.parametrize("prefix_width", [4, 8, 12])
def test_tie_refinement_at_a_small_prefix(prefix_width):
    rng = np.random.default_rng(prefix_width)
    stem = b"x" * prefix_width
    tokens = [stem, stem + b"a", stem + b"\x00", stem[:-1], stem + b"a" * 50, b"m", stem + b"b", stem]
    tokens += [stem[: rng.integers(0, prefix_width + 1)] + bytes(rng.integers(97, 100, rng.integers(0, 6), dtype=np.uint8))
               for _ in range(400)]
    tape, jtape = _both(tokens)
    got = S.argsort_tape(tape, prefix_width=prefix_width)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_tape(jtape, prefix_width=prefix_width)))
    assert got.tolist() == sorted(range(len(tokens)), key=tokens.__getitem__)


def test_out_buffer():
    tokens = [b"c", b"a", b"b"]
    out = np.empty(3, dtype=np.intp)
    res = S.argsort_tape(Tape.from_tokens(tokens), out=out)
    assert res is out
    assert out.tolist() == [1, 2, 0] == list(JS.argsort_tape(jax_tape.Tape.from_tokens(tokens), out=np.empty(3, np.intp)))
    out = np.full(3, -1, dtype=np.intp)
    assert S.argsort_uncased(Tape.from_tokens([b"B", b"a", b"C"]), out=out) is out
    assert out.tolist() == [1, 0, 2]


def test_f14_words_follow_argsort_uncased_and_casefold():
    words = ["b", "aω", "aя", "ab", "c"]
    tokens = [w.encode() for w in words]
    tape, jtape = _both(tokens)
    got = S.argsort_uncased(tape)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_uncased(jtape)))
    assert [words[i] for i in got] == sorted(words, key=str.casefold) == ["ab", "aω", "aя", "b", "c"]


def test_uncased_unpacked_batch_and_a_fold_that_outgrows_its_bytes():
    rng = np.random.default_rng(3)
    alphabet = list("aAbBßẞΣσςΐİıЯяω€") + ["ΐ", "ǰ", "ﬃ", "Ω", "K"]
    words = ["".join(rng.choice(alphabet, rng.integers(0, 7))) for _ in range(600)]
    words += ["ΐ", "ΐa", "ΐ", "STRASSE", "straße", "ǰ", "J̌"]
    tokens = [w.encode() for w in words]
    tape, jtape = _both(tokens)
    rows, key_lengths, _ = S.stage_uncased(tape)
    n_cols, pack3 = S.uncased_plan(rows.data, key_lengths)
    assert not pack3 and n_cols > (rows.width + 2) // 3  # a codepoint a column; the folds outgrow the bytes
    got = S.argsort_uncased(tape)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_uncased(jtape)))
    assert got.tolist() == sorted(range(len(words)), key=lambda i: [ord(c) for c in words[i].casefold()])
    jorder, _ = JS._uncased_order(jnp.asarray(rows.data.numpy()), jnp.asarray(key_lengths.numpy()), n_cols, False)
    np.testing.assert_array_equal(S.uncased_order(rows.data, key_lengths, n_cols, False).numpy(), np.asarray(jorder))


def test_uncased_long_multibyte_tails_refine():
    base = "é" * 60
    words = [base + "Z", base + "a", "É", "e", "X" * 96, "x" * 96 + "a", "x" * 96]
    tokens = [w.encode() for w in words]
    tape, jtape = _both(tokens)
    got = S.argsort_uncased(tape)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_uncased(jtape)))
    assert [_casefold_key(tokens[i]) for i in got] == sorted(_casefold_key(t) for t in tokens)


def test_plain_sort_is_the_packed_column_order():
    rng = np.random.default_rng(4)
    n_cols, n = 5, 2000
    cols = rng.integers(0, 4, (n_cols, n), dtype=np.int64) << rng.integers(0, 31, (n_cols, 1))
    cols[1, ::7] = 0xFFFFFFFF  # uint32 values past 2^31: unsigned order
    cols[3, ::5] = 0x80000000
    as_i32 = torch.from_numpy(np.where(cols >= 1 << 31, cols - (1 << 32), cols)).to(torch.int32)
    want = sorted(range(n), key=lambda i: tuple(cols[:, i]))
    assert S.lsd_argsort_plain(as_i32).tolist() == want
    assert S.lsd_argsort_plain(torch.zeros((3, 0), dtype=torch.int32)).numel() == 0


@pytest.mark.parametrize("case", ["random", "ten-values", "equal", "wide", "last-keys"])
def test_kernel_pass_plan_gives_the_plain_order(case):
    """The radix kernel's passes (``_radix_plan.digit_plan``: a stable pass a
    9-bit digit that varies, least significant first), replayed with stable
    torch sorts of the digits, give the plain order; a constant digit is
    skipped."""
    rng = np.random.default_rng(5)
    n = 3000
    if case == "random":
        cols = rng.integers(0, 1 << 27, (4, n))
    elif case == "ten-values":
        cols = rng.integers(0, 10, (3, n)) << 9  # only the second digit varies
    elif case == "equal":
        cols = np.full((2, n), 77)
    elif case == "wide":
        cols = rng.integers(0, 1 << 32, (2, n))
    else:  # only the second column's second-to-last key varies
        cols = np.zeros((2, n), np.int64)
        cols[1, n - 2] = 1
    cols32 = torch.from_numpy(np.where(cols >= 1 << 31, cols - (1 << 32), cols)).to(torch.int32)
    passes = digit_plan(cols)
    order = torch.arange(n)
    for c, shift in passes:
        digit = (torch.from_numpy(cols[c])[order] >> shift) & 511
        order = order[torch.argsort(digit, stable=True)]
    assert order.tolist() == S.lsd_argsort_plain(cols32).tolist()
    if case == "equal":
        assert passes == []
    if case == "ten-values":
        assert passes == [(2, 9), (1, 9), (0, 9)]
    if case == "last-keys":
        assert passes == [(1, 0)] and order.tolist()[-2:] == [n - 1, n - 2]
