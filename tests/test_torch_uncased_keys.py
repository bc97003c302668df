"""The port's uncased sort keys and its one-sweep radix plan, on the CPU.

- ``uncased_keys_plain`` and ``uncased_plan`` against the JAX package's fold
  (``stringwars_tpu.ops.casefold.fold_tokens``) and packing
  (``stringwars_tpu/ops/sort.py:166-174``) on numpy-seeded batches, exactly,
  and the order against ``_uncased_order``;
- the uncased keys kernel (``csrc/uncased_keys.cu``: the staging, each
  row's path, ASCII rows by word arithmetic, the other rows listed by
  length class and walked four bytes a step through the dense fold table of
  ``sort_cuda.uncased_table``, a tile of columns at a time) replayed in
  Python on the same batches, among them warps that mix the two paths, and
  the table against the fold's range maps;
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
KERNEL_ROWS = 128  # csrc/uncased_keys.cu kUncasedRows: rows a block stages
KERNEL_TILE = 16  # csrc/uncased_keys.cu kUncasedTile: columns a block makes at a time in shared memory

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
    if name.startswith("mixed-"):  # warps of ASCII rows with the other path's rows in them
        data, lengths = _text_rows(rng, ALPHABETS["ascii"], 20)
        other, other_lengths = _text_rows(rng, "éÉàÀßäÖñÑ", 20)  # folded within 509: three codepoints a column
        at = _mixed_rows(name)
        if name == "mixed-lanes-0-31-w20":  # a non-ASCII row at lane 0 and at lane 31 of each warp
            data[at], lengths[at] = other[at], other_lengths[at]
            data[at, 0], lengths[at] = 0xC3, np.maximum(lengths[at], 2)  # a two-byte lead first, whatever the row
            data[at, 1] = 0x89
        elif name == "mixed-high-past-key-w20":  # the row's only bytes from 0x80 up lie past its key length
            lengths[at] = np.minimum(lengths[at], 17)
            data[at, lengths[at]] = 0xC3
            data[at, np.minimum(lengths[at] + 1, 19)] = 0x89
        else:  # "mixed-lead-at-key-end-w20": a lead byte at the key length's last position, its tail past it
            lengths[at] = np.clip(lengths[at], 1, 16)
            leads = np.array([0xC3, 0xE2, 0xF0, 0xF8, 0xFF], np.uint8)[np.arange(at.size) % 5]
            data[at, lengths[at] - 1] = leads
            data[at, lengths[at]] = 0x89
            data[at, lengths[at] + 1] = 0x9F
            data[at, lengths[at] + 2] = 0x80
        return data, lengths, None
    raise KeyError(name)


def _mixed_rows(name: str) -> np.ndarray:
    """The rows of a mixed batch that hold bytes from 0x80 up: lanes 0 and
    31 of each warp, or every fifth row for the cut keys."""
    rows = np.arange(ROWS)
    return rows[(rows % 32 == 0) | (rows % 32 == 31)] if name == "mixed-lanes-0-31-w20" else rows[rows % 5 == 2]


BATCHES = ["ascii-w20", "multilingual-w96", "expansions-w20", "deseret-w20", "invalid-w20", "cut-keys-w4",
           "few-columns-w20", "mixed-lanes-0-31-w20", "mixed-high-past-key-w20", "mixed-lead-at-key-end-w20"]


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


def _row_of(i: np.ndarray, unit: int) -> np.ndarray:
    """The kernel's ``row_of``: i // unit by a multiply-high with
    ceil(2^32 / unit)."""
    magic = ((1 << 32) + unit - 1) // unit
    return ((i.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)).astype(np.int64)


def _staged(data: np.ndarray, rows_a_block: int) -> np.ndarray:
    """The rows as the kernel stages them, block by block: as 4-byte words
    when the width is a multiple of 4, else byte by byte, each unit's row
    found by ``_row_of``."""
    B, W = data.shape
    words = W % 4 == 0
    flat = data.reshape(-1).view(np.uint32) if words else data.reshape(-1)
    unit = W // 4 if words else W
    staged = np.zeros((B, unit), flat.dtype)
    for row0 in range(0, B, rows_a_block):
        here = min(rows_a_block, B - row0)
        i = np.arange(here * unit)
        r = _row_of(i, unit)
        staged[row0 + r, i - r * unit] = flat[row0 * unit : (row0 + here) * unit]
    return staged.view(np.uint8).reshape(B, W)


def _bytes_below(k: int) -> int:
    return 0 if k <= 0 else 0xFFFFFFFF if k >= 4 else (1 << (8 * k)) - 1


def _lower4(x: int) -> int:
    x &= 0x7F7F7F7F
    upper = (x + 0x3F3F3F3F) & ~(x + 0x25252525) & 0x80808080
    return x | (upper >> 2)


def _byte_perm(x: int, y: int, selector: int) -> int:
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(src[(selector >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _spread3(z: int) -> int:
    return (z & 0xFF) | ((z << 1) & 0x1FE00) | ((z << 2) & 0x3FC0000)


def _ascii_columns(words: list[int], limit: int, n_cols: int, pack3: bool) -> tuple[list[int], int]:
    """An ASCII row's columns by the kernel's word arithmetic, and its
    largest lowercased byte (the plan's)."""
    keys = [(_lower4(w) + 0x01010101) & _bytes_below(limit - 4 * k) if 4 * k < limit else 0 for k, w in enumerate(words)]
    keys += [0] * (3 * n_cols)
    cols = []
    for c in range(0, n_cols, 4):
        if pack3:
            y0, y1, y2 = keys[3 * (c >> 2) : 3 * (c >> 2) + 3]
            four = [_spread3(_byte_perm(y0, 0, 0x0012)), _spread3(_byte_perm(y0, y1, 0x0345)),
                    _spread3(_byte_perm(y1, y2, 0x0234)), _spread3(_byte_perm(y2, 0, 0x0123))]
        else:
            four = [(keys[c >> 2] >> (8 * e)) & 0xFF for e in range(4)]
        cols += four
    top = max([(_lower4(w) & _bytes_below(limit - 4 * k)) >> (8 * e) & 0xFF for k, w in enumerate(words) if 4 * k < limit
               for e in range(4)], default=0)
    return cols[:n_cols], top


def _byte_fold(row: np.ndarray, p: int, table: np.ndarray) -> list[int]:
    """The outputs + 1 of byte ``p`` below the key length (none for a
    continuation byte): the JAX decode, then the fold (ASCII by arithmetic,
    the rest by the table, past it the codepoint itself)."""
    W = row.shape[0]
    b = int(row[p])
    if b & 0xC0 == 0x80:
        return []
    b1, b2, b3 = (int(row[p + k]) & 0x3F if p + k < W else 0 for k in (1, 2, 3))
    if b < 0x80:
        cp = b
    elif b < 0xE0:
        cp = ((b & 0x1F) << 6) | b1
    elif b < 0xF0:
        cp = ((b & 0x0F) << 12) | (b1 << 6) | b2
    else:
        cp = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    if cp < 0x80:
        return [(cp + 0x20 if 0x41 <= cp <= 0x5A else cp) + 1]
    if cp >= table.shape[0]:
        return [cp + 1]
    x, y = int(table[cp, 0]), int(table[cp, 1])
    return [(x & 0xFFFFFF) + 1, (y & 0xFFFF) + 1, (y >> 16) + 1][: x >> 24]


def _length_class(limit: int, walked: bool) -> int:
    """The kernel's class of a listed row: 0 for an ASCII row, else by key
    length (1-48 by 4 bytes, then by 32, the last from 145 up)."""
    return 0 if not walked else 1 + ((limit - 1) >> 2 if limit <= 48 else min(15, 12 + ((limit - 49) >> 5)))


def _row_walk(row: np.ndarray, limit: int, lo: int, hi: int, pack3: bool, table: np.ndarray):
    """A listed row walked as its thread walks it: four bytes a step, each
    byte's outputs (``_byte_fold``: its next three bytes read from the row,
    0 past W) at the row's count so far, those whose index lies in [lo, hi)
    placed, the walk stopped once the count reaches hi. ({column: value}
    relative to lo // per, the count reached, the largest folded codepoint)."""
    per = 3 if pack3 else 1
    placed: dict[int, int] = {}
    q = p = top = 0
    while p < limit and q < hi:
        for e in range(4):
            for v in (_byte_fold(row, p + e, table) if p + e < limit else []):
                top = max(top, v - 1)
                if lo <= q < hi:
                    at = q - lo
                    placed[at // per] = placed.get(at // per, 0) | ((v << (9 * (2 - at % 3))) & 0xFFFFFFFF if pack3 else v)
                q += 1
        p += 4
    return placed, q, top


def _kernel_walk(data: np.ndarray, lengths: np.ndarray, n_cols: int, pack3: bool, table: np.ndarray,
                 tile: int = KERNEL_TILE, rows_a_block: int = KERNEL_ROWS):
    """``csrc/uncased_keys.cu`` replayed: the rows staged as the kernel
    stages them, each row's path (a byte from 0x80 up below its key length,
    tested on its words), ASCII rows by word arithmetic, the rest listed a
    block at a time by length class (after the block's ASCII rows, which
    its first threads take) and each walked by one thread, once for each
    tile of ``tile`` columns. (uint32 [n_cols, B] columns, largest folded
    count, largest folded codepoint, bool [B]: the rows that took the
    walk)."""
    B, W = data.shape
    staged = _staged(data, rows_a_block)
    np.testing.assert_array_equal(staged, data)
    padded = np.zeros((B, -(-W // 4) * 4), np.uint8)
    padded[:, :W] = staged
    words = padded.view("<u4")
    per = 3 if pack3 else 1
    cols = np.zeros((n_cols, B), np.uint32)
    walked = np.zeros(B, bool)
    limits = np.minimum(np.maximum(lengths.astype(np.int64), 0), W)
    top_count = top_cp = 0
    for t in range(B):
        limit = int(limits[t])
        row_words = [int(w) for w in words[t]]
        high = 0
        for k in range(-(-limit // 4)):
            high |= row_words[k] & _bytes_below(limit - 4 * k)
        walked[t] = high & 0x80808080 != 0
        if not walked[t]:
            cols[:, t], top = _ascii_columns(row_words, limit, n_cols, pack3)
            top_count, top_cp = max(top_count, limit), max(top_cp, top)
    for row0 in range(0, B, rows_a_block):
        block = range(row0, min(row0 + rows_a_block, B))
        if not walked[block].any():
            continue  # every row ASCII: each thread stores its own row's columns
        listed = sorted(block, key=lambda t: _length_class(int(limits[t]), walked[t]))
        for t in listed[len(block) - int(walked[block].sum()) :]:  # after the ASCII rows: the others, by class
            for c0 in range(0, n_cols, tile):
                placed, _, _ = _row_walk(staged[t], int(limits[t]), c0 * per, min(c0 + tile, n_cols) * per, pack3, table)
                for c, v in placed.items():
                    cols[c0 + c, t] = v
            _, count, top = _row_walk(staged[t], int(limits[t]), 0, 1 << 62, pack3, table)  # the plan: the whole row
            top_count, top_cp = max(top_count, count), max(top_cp, top)
    return cols, top_count, top_cp, walked


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
    table = SC.uncased_table()
    # The kernel's tile, then tiles of 4 columns: a row walked once a tile.
    for tile in (KERNEL_TILE, 4):
        replayed, top_count, top_cp, _ = _kernel_walk(data, lengths, n_cols, pack3, table, tile)
        np.testing.assert_array_equal(replayed, want)
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


def test_mixed_batches_mix_the_paths_in_a_warp():
    """The mixed batches put rows of both paths into warps: the walk takes
    exactly lanes 0 and 31 of each warp, no row whose only high bytes
    lie past its key length, and every row whose key ends on a lead byte."""
    table = SC.uncased_table()
    for name in ("mixed-lanes-0-31-w20", "mixed-high-past-key-w20", "mixed-lead-at-key-end-w20"):
        data, lengths, _ = _batch(name)
        walked = _kernel_walk(data, lengths, 1, True, table)[3]
        want = np.zeros(ROWS, bool)
        if name != "mixed-high-past-key-w20":
            want[_mixed_rows(name)] = True
        np.testing.assert_array_equal(walked, want, err_msg=name)
        if name == "mixed-high-past-key-w20":
            assert (data >= 0x80).any(1).sum() >= ROWS // 5


def test_staging_rows_by_multiply_high():
    """The kernel finds a staged unit's row by a multiply-high with
    ceil(2^32 / unit): exact wherever a block stages (its rows of every
    unit up to the widest rows' bytes)."""
    for unit in range(1, SC.MAX_UNCASED_WIDTH + 1):
        i = np.arange(KERNEL_ROWS * unit)
        np.testing.assert_array_equal(_row_of(i, unit), i // unit)


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
