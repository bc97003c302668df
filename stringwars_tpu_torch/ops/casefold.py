"""Case folding, uncased compare and uncased search (K10).

The port of ``stringwars_tpu.ops.casefold`` (reference rows
``sz::utf8_uncased_fold``, ``utf8_uncased_order`` and
``utf8_uncased_search``, ``normalization/bench.rs``): full Unicode case
folding (ß → ss), from the tables of ``unicode/tables.casefold_tables``.

- ``fold_codepoints`` / ``fold_bytes`` / ``fold_text``: a stream folded as
  torch index ops (the staging work the JAX package leaves to XLA): a table
  gather per codepoint, then a scatter of up to three outputs each to their
  prefix-sum destinations. Codepoints past the tables (undecodable bytes)
  read the JAX gather's fill value and so fold to nothing, as there.
- ``uncased_equal`` / ``uncased_count``: caseless equality of two byte
  strings, and all (overlapping) matches of a folded needle in a folded
  haystack (``ops/find.cp_window_count``).
- ``fold_tokens``: a row-wise fold of ``PaddedTokens`` into an int32
  ``[B, max_exp * W]`` matrix and counts. The simple fold, the expansion
  lengths and the expansion codepoints are the range maps of ``_fold_rules``
  (``ops/rulemap.range_map``: the CUDA kernel on a card). The JAX function
  compacts each row with ``lax.sort`` by destination, a way around the
  TPU's serial scatters; here the outputs are scattered straight to their
  destinations, which gives the same matrix.
- ``fold_tokens_ascii`` / ``fold_tokens_auto``: the bytewise ASCII fold and
  the dispatch to it when a batch is pure ASCII.
- ``uncased_equal_batch``: caseless equality of token pairs.

``fold_tokens`` with ``max_cp`` takes the rules pruned to that ceiling; a
codepoint above it is outside the contract, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stringwars_tpu_torch.ops import rulemap
from stringwars_tpu_torch.ops.utf8 import utf8_decode
from stringwars_tpu_torch.unicode import tables

_MAX_EXPANSION = 3  # full case folding expands a codepoint to at most 3
_FILL = -(2**31)  # what the JAX package's gather reads past a table (int32 min)


@functools.lru_cache(maxsize=None)
def _fold_arrays() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inline int32, multi int32, pool int32), as the JAX package casts them."""
    inline, multi, pool = tables.casefold_tables()
    return inline, multi.astype(np.int32), pool


@functools.lru_cache(maxsize=None)
def _fold_tensors(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in _fold_arrays())


@functools.lru_cache(maxsize=None)
def _fold_rules(max_cp: int | None = None):
    """(simple-fold delta rules, expansion-length value map, packed
    ``e1 | e2 << 16`` value map, e3 value map, max_exp), pruned to ``max_cp``
    when given; ``max_exp`` is then the longest expansion at or below it."""
    inline, multi, pool = _fold_arrays()
    simple = rulemap.compile_fold(inline)
    keys = np.flatnonzero(inline < 0)
    m = multi[keys]
    lengths = (m & 31).astype(np.int64)
    off = (m >> 5).astype(np.int64)
    if int(pool.max()) > 0xFFFF:
        raise ValueError("an expansion codepoint exceeds 16 bits")
    e1 = pool[off]
    e2 = np.where(lengths >= 2, pool[np.minimum(off + 1, pool.shape[0] - 1)], 0)
    e3 = np.where(lengths >= 3, pool[np.minimum(off + 2, pool.shape[0] - 1)], 0)
    mlen_rules = rulemap.compile_sparse_values(keys, lengths)
    e12_rules = rulemap.compile_sparse_values(keys, (e1 | (e2 << 16)).astype(np.int64))
    e3_keys = keys[e3 > 0]
    e3_rules = rulemap.compile_sparse_values(
        e3_keys if e3_keys.size else np.asarray([0x10FFFF]),
        e3[e3 > 0] if e3_keys.size else np.asarray([0]),
    )
    if max_cp is not None:
        simple, mlen_rules, e12_rules, e3_rules = (r.prune(max_cp) for r in (simple, mlen_rules, e12_rules, e3_rules))
        in_range = keys <= max_cp
        max_exp = int(lengths[in_range].max()) if in_range.any() else 1
    else:
        max_exp = _MAX_EXPANSION
    return simple, mlen_rules, e12_rules, e3_rules, max_exp


def fold_codepoints(cps: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full case fold of ``cps[:n]``: (folded int32[3n], count as a 0-d int32
    tensor). Slots past the count are zero."""
    inline, multi, pool = _fold_tensors(cps.device)
    cp = cps[:n].to(torch.int64)
    inside = (cp >= 0) & (cp < inline.numel())
    idx = cp.clamp(0, inline.numel() - 1)
    f = torch.where(inside, inline[idx], _FILL)
    m = torch.where(inside, multi[idx], _FILL)
    is_multi = f < 0
    length = torch.where(is_multi, m & 31, 1)
    pool_off = (m >> 5).to(torch.int64)
    out_n = n * _MAX_EXPANSION
    starts = torch.cumsum(length, 0, dtype=torch.int64) - length
    out = torch.zeros(out_n + 1, dtype=torch.int32, device=cps.device)  # the last slot takes dropped writes
    for k in range(_MAX_EXPANSION):
        val = torch.where(is_multi, pool[(pool_off + k).clamp(0, pool.numel() - 1)], f)
        dst = torch.where(k < length, starts + k, out_n)
        out.index_put_((dst,), val)
    return out[:out_n], length.sum(dtype=torch.int32)


def fold_bytes(data, n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """UTF-8 bytes (a uint8 tensor, or anything numpy takes) -> (folded
    int32[3n], count as a 0-d int32 tensor), decoded and folded on the
    tensor's device."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data, dtype=np.uint8).reshape(-1))
    n = int(data.shape[0]) if n is None else int(n)
    cps, count = utf8_decode(data, n)
    # The decode pads with zeros past its count; each folds to one zero slot.
    folded, fcount = fold_codepoints(cps, cps.shape[0])
    return folded, fcount - (cps.shape[0] - count)


def fold_text(text: str) -> str:
    """Full case fold of a string through the tables (equals ``str.casefold``)."""
    folded, count = fold_bytes(np.frombuffer(text.encode(), np.uint8))
    return "".join(map(chr, folded[: int(count)].tolist()))


# ---------------------------------------------------------------------------
# Uncased compare / search
# ---------------------------------------------------------------------------

def uncased_equal(a: bytes, b: bytes) -> bool:
    """Full-fold caseless equality of two UTF-8 byte strings."""
    fa, ca = fold_bytes(np.frombuffer(a, np.uint8))
    fb, cb = fold_bytes(np.frombuffer(b, np.uint8))
    ca, cb = int(ca), int(cb)
    return ca == cb and torch.equal(fa[:ca], fb[:cb])


def uncased_count(haystack_folded: tuple[torch.Tensor, torch.Tensor], needle: bytes) -> int:
    """All caseless (overlapping) matches of ``needle`` in a haystack folded
    by ``fold_bytes``, counted in folded-codepoint space."""
    from stringwars_tpu_torch.ops.find import cp_window_count

    folded, count = haystack_folded
    fn, fm = fold_bytes(np.frombuffer(needle, np.uint8))
    fm = int(fm)
    if fm == 0:
        return 0
    return int(cp_window_count(folded, int(count), fn[:fm].to(folded.device)))


# ---------------------------------------------------------------------------
# Batched per-token fold + caseless equality
# ---------------------------------------------------------------------------

def _decode_rows(data: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise UTF-8 decode of int32 ``[B, W]`` bytes without compaction:
    each codepoint stays at its lead byte. Returns (cp, is_lead)."""
    W = data.shape[1]
    valid = torch.arange(W, device=data.device)[None, :] < lengths[:, None]

    def nxt(k):
        return torch.nn.functional.pad(data[:, k:], (0, k)) & 0x3F

    width = torch.where(
        data < 0x80, 1,
        torch.where(data < 0xC0, 0, torch.where(data < 0xE0, 2, torch.where(data < 0xF0, 3, torch.where(data < 0xF8, 4, 0)))),
    )
    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp = torch.where(
        width == 1, data,
        torch.where(
            width == 2, ((data & 0x1F) << 6) | b1,
            torch.where(
                width == 3, ((data & 0x0F) << 12) | (b1 << 6) | b2,
                ((data & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
            ),
        ),
    )
    is_lead = ((data & 0xC0) != 0x80) & valid
    return cp, is_lead


def fold_tokens(tokens, max_cp: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise full case fold of a ``PaddedTokens`` batch: (folded int32
    ``[B, max_exp * W]``, counts int32 ``[B]``). Row i holds the folded
    codepoints of token i from its front, zeros past ``counts[i]``."""
    data = tokens.data.to(torch.int32)
    B, W = data.shape
    cp, is_lead = _decode_rows(data, tokens.lengths.to(data.device))
    simple, mlen_rules, e12_rules, e3_rules, max_exp = _fold_rules(max_cp)
    folded = rulemap.range_map(cp, simple)
    mlen = rulemap.range_map(cp, mlen_rules)
    e12 = rulemap.range_map(cp, e12_rules)
    length = torch.where(is_lead, torch.where(mlen > 0, mlen, 1), 0)
    starts = torch.cumsum(length, 1, dtype=torch.int32) - length
    out_w = max_exp * W
    chans = [torch.where(mlen > 0, e12 & 0xFFFF, folded)]
    if max_exp >= 2:
        chans.append(e12 >> 16)
    if max_exp >= 3:
        chans.append(rulemap.range_map(cp, e3_rules))
    out = torch.zeros((B, out_w + 1), dtype=torch.int32, device=data.device)  # column out_w takes dropped writes
    for k, chan in enumerate(chans):
        dst = torch.where(length > k, starts + k, out_w).to(torch.int64)
        out.scatter_(1, dst, chan)
    return out[:, :out_w].contiguous(), length.sum(1, dtype=torch.int32)


def fold_tokens_ascii(tokens) -> tuple[torch.Tensor, torch.Tensor]:
    """Bytewise fold of pure-ASCII tokens (there the full fold is lowercase):
    (folded uint8 ``[B, W]``, counts = lengths). The caller guarantees ASCII
    (``fold_tokens_auto``)."""
    data = tokens.data
    is_upper = (data >= 65) & (data <= 90)
    return torch.where(is_upper, data | 0x20, data), tokens.lengths


def fold_tokens_auto(tokens, data_np: np.ndarray | None = None):
    """(folded, counts, ascii): the ASCII fold when the batch is pure ASCII
    (``data_np``, its bytes on the host, spares a read from the device), else
    ``fold_tokens``."""
    probe = data_np if data_np is not None else tokens.data.cpu().numpy()
    if not probe.size or int(probe.max()) < 0x80:
        folded, counts = fold_tokens_ascii(tokens)
        return folded, counts, True
    folded, counts = fold_tokens(tokens)
    return folded, counts, False


def uncased_equal_batch(a_tokens, b_tokens) -> torch.Tensor:
    """bool[B]: full-fold caseless equality of token pairs."""
    fa, ca = fold_tokens(a_tokens)
    fb, cb = fold_tokens(b_tokens)
    W = max(fa.shape[1], fb.shape[1])
    fa = torch.nn.functional.pad(fa, (0, W - fa.shape[1]))
    fb = torch.nn.functional.pad(fb, (0, W - fb.shape[1]))
    pos = torch.arange(W, device=fa.device)[None, :]
    agree = (fa == fb) | (pos >= ca[:, None])
    return (ca == cb) & agree.all(1)
