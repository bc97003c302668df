"""The port's uncased sort keys and its one-sweep radix plan, on the CPU.

- ``uncased_keys_plain`` and ``uncased_plan`` against the JAX package's fold
  (``stringwars_tpu.ops.casefold.fold_tokens``) and packing
  (``stringwars_tpu/ops/sort.py:166-174``) on numpy-seeded batches, exactly,
  and the order against ``_uncased_order``;
- the uncased keys kernel's walk (``csrc/uncased_keys.cu``: the decode, the
  dense fold table of ``sort_cuda.uncased_table`` and the packing) replayed
  in Python on the same batches, and the table against the fold's range maps;
- ``argsort_uncased``'s tie check on the packed columns, on tokens that reach
  the prefix width;
- the radix kernel's one-sweep passes (``csrc/radixsort.cu``: the digit
  counts of the whole batch, each tile's counts, the look-back's prefix over
  the tiles, the tile staged in digit order and stored run by run) replayed
  with numpy, against the plain order;
- the keys the radix kernel's spread and digit count read of a column (a
  head of single keys up to a 16-byte boundary, 16-byte vectors, a tail of
  single keys), replayed thread by thread: each key once, at every
  alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu import tape as jax_tape
from stringwars_tpu.ops import casefold as JC
from stringwars_tpu.ops import sort as JS
from stringwars_tpu_torch.ops import rulemap as R
from stringwars_tpu_torch.ops import sort as S
from stringwars_tpu_torch.ops import sort_cuda as SC
from stringwars_tpu_torch.ops.casefold import _fold_rules
from stringwars_tpu_torch.tape import Tape
from _radix_plan import digit_plan
from _torch_threads import one_thread  # noqa: F401

ROWS = 192  # one row count for every batch: the JAX fold compiles once a width

ALPHABETS = {
    "ascii": "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-'",
    "multilingual": "aZéÉπΠжЖ日本語한국어ßẞΣσςİıǅΩω€֐אئ",
    "expansions": "aAßẞΐΰﬃﬆİǰᾀᾈxX",
    "deseret": "\U00010400\U00010428\U0001E900a\U00010C80",
}


def _text_rows(rng, alphabet: str, width: int) -> tuple[np.ndarray, np.ndarray]:
    """ROWS random strings over ``alphabet`` of at most ``width`` bytes, some
    empty; key lengths the whole string."""
    data = np.zeros((ROWS, width), np.uint8)
    lengths = np.zeros(ROWS, np.int32)
    chars = list(alphabet)
    for i in range(ROWS):
        raw = b""
        for c in rng.choice(chars, int(rng.integers(0, width + 1))):
            if len(raw) + len(c.encode()) > width:
                break
            raw += c.encode()
        data[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lengths[i] = len(raw)
    lengths[::17] = 0  # empty rows
    return data, lengths


def _batch(name: str):
    """(uint8 [ROWS, W] rows, int32 key lengths, n_cols or None for the plan's)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ascii-w20":
        return (*_text_rows(rng, ALPHABETS["ascii"], 20), None)
    if name == "multilingual-w96":
        return (*_text_rows(rng, ALPHABETS["multilingual"], 96), None)
    if name == "expansions-w20":
        return (*_text_rows(rng, ALPHABETS["expansions"], 20), None)
    if name == "deseret-w20":
        return (*_text_rows(rng, ALPHABETS["deseret"], 20), None)
    if name == "invalid-w20":  # any bytes: stray continuations, truncated leads, 0xF8 and up
        data = rng.integers(0, 256, (ROWS, 20), dtype=np.uint8)
        data[::3, 5:9] = [0xF0, 0x90, 0x80, 0xFF]
        data[1::3, -2:] = [0xE2, 0x82]  # a lead whose continuation lies past the row
        return data, rng.integers(0, 21, ROWS).astype(np.int32), None
    if name == "cut-keys-w4":  # key lengths that end inside a character, and empty rows
        data, _ = _text_rows(rng, ALPHABETS["multilingual"] + ALPHABETS["deseret"], 4)
        return data, rng.integers(-1, 6, ROWS).astype(np.int32), None
    if name == "few-columns-w20":  # fewer columns than the plan's: the first n_cols kept
        data, lengths = _text_rows(rng, ALPHABETS["expansions"] + "abc", 20)
        return data, lengths, 2
    raise KeyError(name)


BATCHES = ["ascii-w20", "multilingual-w96", "expansions-w20", "deseret-w20", "invalid-w20", "cut-keys-w4",
           "few-columns-w20"]


def _jax_fold(data: np.ndarray, lengths: np.ndarray):
    tokens = jax_tape.PaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=data.shape[1])
    folded, counts = JC.fold_tokens(tokens)
    return np.asarray(folded), np.asarray(counts)


def _jax_plan(folded: np.ndarray, counts: np.ndarray) -> tuple[int, bool]:
    """The packing plan as ``stringwars_tpu.ops.sort.argsort_uncased`` makes it."""
    max_count = int(counts.max()) if counts.shape[0] else 1
    max_cp = int(folded.max()) if counts.shape[0] else 0
    pack3 = max_cp <= 509
    return max(1, (-(-max_count // 3)) if pack3 else max_count), pack3


def _jax_columns(folded: np.ndarray, counts: np.ndarray, n_cols: int, pack3: bool) -> np.ndarray:
    """``stringwars_tpu/ops/sort.py:166-174``: the packed columns, uint32 [n_cols, B]."""
    folded_j, counts_j = jnp.asarray(folded), jnp.asarray(counts)
    pos = jnp.arange(folded_j.shape[1], dtype=jnp.int32)[None, :]
    vals = jnp.where(pos < counts_j[:, None], folded_j.astype(jnp.uint32) + 1, 0)
    vals = vals[:, : n_cols * (3 if pack3 else 1)]
    if pack3:
        vals = jnp.pad(vals, ((0, 0), (0, 3 * n_cols - vals.shape[1])))
        groups = vals.reshape(vals.shape[0], n_cols, 3)
        cols = (groups[:, :, 0] << 18) | (groups[:, :, 1] << 9) | groups[:, :, 2]
    else:
        cols = jnp.pad(vals, ((0, 0), (0, n_cols - vals.shape[1])))
    return np.asarray(cols.T).astype(np.uint32)


def _kernel_walk(data: np.ndarray, lengths: np.ndarray, n_cols: int, pack3: bool, table: np.ndarray):
    """``csrc/uncased_keys.cu`` replayed a row at a time: (uint32 [n_cols, B]
    columns, largest folded count, largest folded codepoint)."""
    B, W = data.shape
    size = table.shape[0]
    entries = table.view(np.uint32)
    cols = np.zeros((n_cols, B), np.uint32)
    top_count = top_cp = 0
    for t in range(B):
        row = data[t].astype(np.uint32)
        limit = min(max(int(lengths[t]), 0), W)
        vals, pos = [], 0
        while pos < limit:
            b = int(row[pos])
            pos += 1
            if b & 0xC0 == 0x80:
                continue
            b1, b2, b3 = (int(row[pos + k]) & 0x3F if pos + k < W else 0 for k in range(3))
            if b < 0x80:
                cp = b
            elif b < 0xE0:
                cp = ((b & 0x1F) << 6) | b1
            elif b < 0xF0:
                cp = ((b & 0x0F) << 12) | (b1 << 6) | b2
            else:
                cp = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
            if cp < size:
                x, y = int(entries[cp, 0]), int(entries[cp, 1])
                vals += [x & 0xFFFFFF, y & 0xFFFF, y >> 16][: x >> 24]
            else:
                vals.append(cp)
        top_count = max(top_count, len(vals))
        top_cp = max([top_cp, *vals])
        taken = [v + 1 for v in vals] + [0] * (3 * n_cols)
        for c in range(n_cols):
            if pack3:
                cols[c, t] = ((taken[3 * c] << 18) | (taken[3 * c + 1] << 9) | taken[3 * c + 2]) & 0xFFFFFFFF
            else:
                cols[c, t] = taken[c]
    return cols, top_count, top_cp


@pytest.mark.parametrize("name", BATCHES)
def test_uncased_keys_equal_jax_and_the_kernel_walk(name):
    data, lengths, n_cols = _batch(name)
    folded, counts = _jax_fold(data, lengths)
    plan = _jax_plan(folded, counts)
    data_t, lengths_t = torch.from_numpy(data), torch.from_numpy(lengths)
    assert S.uncased_plan(data_t, lengths_t) == plan
    n_cols = plan[0] if n_cols is None else n_cols
    pack3 = plan[1]
    want = _jax_columns(folded, counts, n_cols, pack3)
    got = S.uncased_keys_plain(data_t, lengths_t, n_cols, pack3)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_cols, ROWS)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(S.uncased_keys(data_t, lengths_t, n_cols, pack3).numpy().view(np.uint32), want)
    walked, top_count, top_cp = _kernel_walk(data, lengths, n_cols, pack3, SC.uncased_table())
    np.testing.assert_array_equal(walked, want)
    assert (top_count, top_cp) == (int(counts.max()), int(folded.max()))
    jorder, _ = JS._uncased_order(jnp.asarray(data), jnp.asarray(lengths), n_cols, pack3)
    np.testing.assert_array_equal(S.uncased_order(data_t, lengths_t, n_cols, pack3).numpy(), np.asarray(jorder))


def test_batches_cover_both_packings_and_the_cut():
    """The batches above reach both packings and an n_cols below the plan's."""
    plans = {name: S.uncased_plan(*map(torch.from_numpy, _batch(name)[:2])) for name in BATCHES}
    assert plans["ascii-w20"][1] and plans["expansions-w20"][1] is False
    assert not plans["multilingual-w96"][1] and not plans["deseret-w20"][1] and not plans["invalid-w20"][1]
    assert _batch("few-columns-w20")[2] < plans["few-columns-w20"][0]
    assert S.uncased_plan(torch.zeros((0, 8), dtype=torch.uint8), torch.zeros(0, dtype=torch.int32)) == (1, True)
    assert S.uncased_plan(torch.zeros((3, 8), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32)) == (1, True)


def test_fold_table_equals_the_range_maps():
    """Every entry of the kernel's table is the fold's range maps at that
    codepoint, as ``fold_tokens`` reads them; past the table (astral
    codepoints and the decode's values above U+10FFFF) the maps fold a
    codepoint to itself."""
    simple, mlen_rules, e12_rules, e3_rules, _ = _fold_rules(None)
    table = SC.uncased_table()
    size = table.shape[0]
    cps = torch.arange(size, dtype=torch.int32)
    folded, mlen, e12, e3 = (R.range_map_plain(cps, r).numpy() for r in (simple, mlen_rules, e12_rules, e3_rules))
    x, y = table[:, 0].view(np.uint32), table[:, 1].view(np.uint32)
    np.testing.assert_array_equal(x >> 24, np.where(mlen > 0, mlen, 1))
    np.testing.assert_array_equal(x & 0xFFFFFF, np.where(mlen > 0, e12 & 0xFFFF, folded))
    np.testing.assert_array_equal(y & 0xFFFF, e12 >> 16)
    np.testing.assert_array_equal(y >> 16, e3)
    past = torch.tensor([size, size + 1, 0x1FFFF, 0x10FFFF, 0x110000, 0x1FFFFF], dtype=torch.int32)
    assert R.range_map_plain(past, simple).tolist() == past.tolist()
    for rules in (mlen_rules, e12_rules, e3_rules):
        assert R.range_map_plain(past, rules).tolist() == [0] * past.numel()


def test_kernel_wrappers_refuse_a_cpu_tensor():
    data, lengths = torch.zeros((2, 4), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        SC.uncased_keys(data, lengths, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        SC.uncased_extent(data, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        SC.radix_argsort(torch.zeros((1, 5), dtype=torch.int32))


@pytest.mark.parametrize("prefix_width", [8, 12])
def test_argsort_uncased_ties_on_the_packed_columns(prefix_width):
    """Tokens past the prefix width whose folded prefixes are equal (in
    different cases and spellings) tie on the packed columns and refine on
    the host: the order is the JAX package's and ``str.casefold``'s. (Each
    word's prefix folds to as many codepoints as it has bytes, or to half as
    many for the Greek words: a prefix that folds shorter or is cut before a
    character orders by its fold, in both packages, which need not be the
    whole words' order.)"""
    rng = np.random.default_rng(prefix_width)
    latin = [s + "".join(rng.choice(list("aAbB"), int(rng.integers(0, 8))))
             for s in ("strasse", "STRASSE", "straße", "STRAßE", "Strasse") for _ in range(20)]
    greek = [s + "".join(rng.choice(list("αΑβΒ"), int(rng.integers(0, 5))))
             for s in ("σίσυφος", "ΣΊΣΥΦΟΣ", "Σίσυφος") for _ in range(20)]
    words = latin + greek + ["x" * prefix_width, "X" * prefix_width + "a", "x" * (prefix_width - 1), ""]
    tokens = [w.encode() for w in words]
    got = S.argsort_uncased(Tape.from_tokens(tokens), prefix_width=prefix_width)
    np.testing.assert_array_equal(got, np.asarray(JS.argsort_uncased(jax_tape.Tape.from_tokens(tokens),
                                                                     prefix_width=prefix_width)))
    assert got.tolist() == sorted(range(len(words)), key=lambda i: words[i].casefold())


def _sweep_replay(cols: np.ndarray, tile: int) -> np.ndarray:
    """The radix kernel's passes replayed with numpy, over tiles of ``tile``
    positions (the kernel's are ``sort_cuda.TILE``) and warps of a 16th of
    a tile, as ``csrc/radixsort.cu`` computes each position."""
    n_cols, n = cols.shape
    passes = digit_plan(cols)
    order, keys = np.arange(n), None
    warp_span = tile // 8
    for k, (c, shift) in enumerate(passes):
        key = keys if k and passes[k - 1][0] == c else cols[c][order]
        digit = (key >> shift) & 511
        hist = np.bincount((cols[c] >> shift) & 511, minlength=512)  # the digit count: the column as it lies
        base = np.cumsum(hist) - hist
        tiles = -(-n // tile)
        counts = np.stack([np.bincount(digit[t * tile : (t + 1) * tile], minlength=512) for t in range(tiles)])
        before = np.cumsum(counts, 0) - counts  # what the look-back adds up
        out_order, out_keys = np.empty(n, np.int64), np.empty(n, cols.dtype)
        for t in range(tiles):
            d = digit[t * tile : (t + 1) * tile]
            local_start = np.cumsum(counts[t]) - counts[t]
            local = np.empty(d.size, np.int64)
            seen = np.zeros(512, np.int64)  # the warps' counts so far, in warp order
            for w in range(0, d.size, warp_span):
                wd = d[w : w + warp_span]
                rank = np.zeros(wd.size, np.int64)
                running = np.zeros(512, np.int64)
                for i, v in enumerate(wd):  # rounds of 32 lanes, in position order
                    rank[i] = running[v]
                    running[v] += 1
                local[w : w + warp_span] = local_start[wd] + seen[wd] + rank
                seen += running
            staged = np.empty(d.size, np.int64)
            staged[local] = np.arange(d.size)  # the tile in digit order
            sd = d[staged]
            pos = base[sd] + before[t, sd] - local_start[sd] + np.arange(d.size)
            out_order[pos] = order[t * tile : (t + 1) * tile][staged]
            out_keys[pos] = key[t * tile : (t + 1) * tile][staged]
        order, keys = out_order, out_keys
    return order


@pytest.mark.parametrize("case", ["random", "ten-values", "equal", "wide", "one-tile"])
def test_sweep_passes_give_the_plain_order(case):
    rng = np.random.default_rng(6)
    n, tile = 2500, 256
    if case == "random":
        cols = rng.integers(0, 1 << 27, (4, n))
    elif case == "ten-values":
        cols = rng.integers(0, 10, (3, n)) << 9
    elif case == "equal":
        cols = np.full((2, n), 77)
    elif case == "wide":
        cols = rng.integers(0, 1 << 32, (2, n))
    else:
        cols, tile = rng.integers(0, 1 << 20, (3, n)), SC.TILE
    cols32 = torch.from_numpy(np.where(cols >= 1 << 31, cols - (1 << 32), cols)).to(torch.int32)
    assert _sweep_replay(cols.astype(np.uint32), tile).tolist() == S.lsd_argsort_plain(cols32).tolist()


def _split16(offset: int, n: int) -> tuple[int, int, int]:
    """``split16`` of ``csrc/radixsort.cu``: (head, vecs, tail) of a column
    of ``n`` keys at byte ``offset`` past a 16-byte boundary."""
    head = min(n, ((16 - (offset & 15)) & 15) >> 2)
    vecs = (n - head) >> 2
    return head, vecs, head + 4 * vecs


def _spread_reads(offset: int, n: int, blocks: int, threads: int = 256) -> list[int]:
    """The keys ``radix_spread_kernel``'s threads read, thread by thread."""
    head, vecs, tail = _split16(offset, n)
    reads = []
    for start in range(blocks * threads):
        for v in range(start, vecs, blocks * threads):
            reads += range(head + 4 * v, head + 4 * v + 4)
        if start < head or start - head < n - tail:
            reads.append(start if start < head else tail + (start - head))
    return reads


def _digit_count_reads(offset: int, n: int, blocks: int, threads: int = 256) -> list[int]:
    """The keys ``radix_digits_kernel``'s threads count, thread by thread."""
    head, vecs, tail = _split16(offset, n)
    reads = []
    for b in range(blocks):
        for base in range(b * threads, vecs, blocks * threads):
            for t in range(threads):
                if base + t < vecs:
                    reads += range(head + 4 * (base + t), head + 4 * (base + t) + 4)
    for t in range(threads):  # block 0's single keys
        i = t if t < head else tail + t - head
        if i < n:
            reads.append(i)
    return reads


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("walk", ["spread", "digit count"])
def test_radix_column_walk_reads_each_key_once(walk, offset):
    """Column c of an ``[n_cols, n]`` matrix starts ``4 c n`` bytes in: at
    n % 4 of 1, 2 or 3 the columns past the first are off a 16-byte
    boundary, by 4, 8 or 12 bytes."""
    reads_of = _spread_reads if walk == "spread" else _digit_count_reads
    for n in [*range(0, 41), 4095, 4097, 100_003]:
        for blocks in (1, 3):
            reads = reads_of(offset, n, blocks)
            assert sorted(reads) == list(range(n)), (walk, offset, n, blocks)
