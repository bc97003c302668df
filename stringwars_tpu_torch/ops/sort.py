"""Stable string argsort, byte order and case-folded order (family K11).

The port of ``stringwars_tpu.ops.sort`` (reference rows ``sz::argsort``
and ``.uncased()``, ``sequence/bench.rs:51-259``; work n·log2(n)
comparisons; a caller-owned ``out`` index buffer as in
``sequence/bench.py:212-232``), for one device:

- ``byte_columns``: the packed key columns of a padded batch, each uint32
  column three 9-bit values (byte + 1; padding 0, so a prefix sorts first),
  as int32 ``[n_cols, B]`` (entries below 2^27).
- ``lsd_argsort``: the stable lexicographic order of those columns. On a
  card the LSD radix kernel of ``ops/sort_cuda.py``; on the CPU
  ``lsd_argsort_plain``, one stable ``torch.argsort`` a column, least
  significant first, through the order so far (the JAX package's wide-key
  form, ``ops/sort.py:75-80``; its multi-key form gives the same order).
- ``argsort_tape``: a ``prefix_width``-byte key sorted on the tape's
  device; rows that tie on a maxed-out prefix are refined on the host with
  a stable sort of the whole tokens.
- ``uncased_keys``: the key columns of the full case fold of each row's
  first ``key_lengths`` bytes, three codepoints a column or one; on a card
  one launch of the kernel of ``ops/sort_cuda.py``, on the CPU
  ``uncased_keys_plain`` (``casefold.fold_tokens``, then
  ``uncased_columns``). ``uncased_plan`` picks the packing from the batch's
  largest folded count and codepoint: on a card the same kernel's plan mode.
- ``argsort_uncased``: those keys of each prefix clamped to a UTF-8
  boundary, three codepoints a column when the folded ceiling is at most 509
  and one a column otherwise; ties on maxed-out prefixes (equal key columns,
  which cover the longest fold) refine with ``str.casefold``.
- ``sorted_tokens``.

- ``argsort_sharded``: the sample sort over the ranks of a scope
  (``sample_sort_body``: splitters from all-gathered samples, one
  ``all_to_all`` of keys and indices into fixed slots, the radix argsort of
  what arrives), falling back to ``argsort_tape`` when a destination
  overflows; one device takes ``argsort_tape``.

The results are numpy ``int64`` permutations, as the JAX package returns
them.
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch.tape import PaddedTokens, Tape

PREFIX_WIDTH = 96  # bytes of each token the device sorts by


# ---------------------------------------------------------------------------
# Key columns and the sort
# ---------------------------------------------------------------------------

def pack_columns(vals: torch.Tensor, pack3: bool = True) -> torch.Tensor:
    """int32 ``[n_cols, B]`` columns of the ``[B, m]`` key values (each
    below 2^32, as int32 or int64): three 9-bit values a column, the first
    most significant, the last column padded with zeros (``pack3``), or one
    value a column."""
    vals = vals.to(torch.int64)
    if pack3:
        B, m = vals.shape
        n_cols = (m + 2) // 3
        groups = torch.nn.functional.pad(vals, (0, 3 * n_cols - m)).view(B, n_cols, 3)
        vals = (groups[:, :, 0] << 18) | (groups[:, :, 1] << 9) | groups[:, :, 2]
    return _as_u32_bits(vals.T)


def _as_u32_bits(vals: torch.Tensor) -> torch.Tensor:
    """int32 with the uint32 bits of int64 values in [0, 2^32)."""
    return torch.where(vals >= 1 << 31, vals - (1 << 32), vals).to(torch.int32).contiguous()


def byte_columns(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """int32 ``[n_cols, B]`` packed key columns of uint8 ``[B, W]`` rows:
    byte + 1 inside each row's length, 0 past it, three to a column
    (``(W + 2) // 3`` columns)."""
    W = data.shape[1]
    pos = torch.arange(W, device=data.device)[None, :]
    vals = torch.where(pos < lengths.to(data.device)[:, None], data.to(torch.int32) + 1, 0)
    return pack_columns(vals)


def lsd_argsort_plain(columns: torch.Tensor) -> torch.Tensor:
    """int32[n]: the stable argsort of the rows of ``columns`` (each entry
    read as its uint32 bits), one stable ``torch.argsort`` a column, least
    significant first, over the column gathered through the order so far."""
    n_cols, n = columns.shape
    order = torch.arange(n, dtype=torch.int64, device=columns.device)
    for c in reversed(range(n_cols)):
        keys = (columns[c].to(torch.int64) & 0xFFFFFFFF)[order]
        order = order[torch.argsort(keys, stable=True)]
    return order.to(torch.int32)


def lsd_argsort(columns: torch.Tensor) -> torch.Tensor:
    """int32[n]: the stable argsort of the rows of the ``[n_cols, n]`` key
    columns, on their device: the radix kernel on a card, the plain version
    on the CPU."""
    if columns.device.type == "cuda":
        from stringwars_tpu_torch.ops import sort_cuda

        return sort_cuda.radix_argsort(columns)
    if columns.device.type == "cpu":
        return lsd_argsort_plain(columns)
    raise ValueError(f"lsd_argsort runs on a CUDA or CPU tensor, not {columns.device}")


def argsort_tokens(tokens: PaddedTokens) -> torch.Tensor:
    """Stable byte-order argsort of a padded batch: int32[B] on its device."""
    return lsd_argsort(byte_columns(tokens.data, tokens.lengths))


# ---------------------------------------------------------------------------
# Whole tokens: host tie refinement and the out= buffer
# ---------------------------------------------------------------------------

def _write_out(order: np.ndarray, out):
    if out is None:
        return order
    out[: order.shape[0]] = order
    return out


def _refine_ties(order: np.ndarray, tie_with_next: np.ndarray, key_of_index) -> np.ndarray:
    """Stable host-side re-sort of each run of prefix-tied rows."""
    if not tie_with_next.any():
        return order
    boundaries = np.flatnonzero(~tie_with_next)
    start = 0
    order = order.copy()
    for end in boundaries:
        if end > start:
            run = sorted(order[start : end + 1].tolist(), key=key_of_index)
            order[start : end + 1] = run
        start = end + 1
    if start < order.shape[0] - 1:
        run = sorted(order[start:].tolist(), key=key_of_index)
        order[start:] = run
    return order


def _full_lengths(tape: Tape) -> np.ndarray:
    o = tape.offsets.cpu().numpy().astype(np.int64)
    return o[1:] - o[:-1]


def argsort_tape(tape: Tape, *, prefix_width: int = PREFIX_WIDTH, out=None) -> np.ndarray:
    """Stable byte-order argsort of all tokens (indices into tape order).

    Sorts a ``prefix_width``-byte key on the tape's device; rows tying on a
    maxed-out prefix are refined on the host. ``out`` (optional) is a
    caller-owned index buffer written in place.
    """
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    order = argsort_tokens(tokens).cpu().numpy().astype(np.int64)
    return _write_out(_refine_prefixes(order, tape, tokens, prefix_width), out)


def _refine_prefixes(order: np.ndarray, tape: Tape, tokens: PaddedTokens, prefix_width: int) -> np.ndarray:
    """``order`` of the prefix keys, with each run of rows that tie on a
    maxed-out prefix re-sorted on the host by the whole tokens."""
    full_lengths = _full_lengths(tape)
    if full_lengths.size and int(full_lengths.max()) > prefix_width:
        mat = tokens.data.cpu().numpy()
        sorted_mat = mat[order]
        # >= not >: a row of length exactly prefix_width has an identical
        # radix key to a longer row sharing its prefix, and must refine too.
        maxed = full_lengths[order] >= prefix_width
        tie = (sorted_mat[1:] == sorted_mat[:-1]).all(axis=1) & (maxed[1:] | maxed[:-1])
        toks = tape.to_list()
        order = _refine_ties(order, tie, toks.__getitem__)
    return order


# ---------------------------------------------------------------------------
# Sample sort over the ranks of a scope
# ---------------------------------------------------------------------------

SAMPLES_PER_SHARD = 256
CAPACITY_FACTOR = 2  # slots a destination, as a multiple of the mean
PAD_KEY = 0x7FFFFFFF  # every column of an empty slot or a padding row: above any packed key (< 2^27)


def sample_sort_body(cols: torch.Tensor, idx: torch.Tensor, scope) -> tuple[torch.Tensor, int] | None:
    """One rank's sample sort of its ``[n_cols, Bl]`` key columns with their
    tape indices ``idx`` (-1 on padding rows): (the indices it receives, in
    the global stable order of their keys, then -1s; how many are tape
    rows), or ``None`` when some destination overflows its slots on any
    rank (the caller sorts on one device then).

    The JAX package's ``_sharded_sort_body``: 256 evenly spaced samples of
    the first key column from each rank, all-gathered and sorted, give
    D - 1 splitters; a key goes to the rank counting the splitters at or
    below it (equal keys share a rank, so stability survives); each
    destination has ``max(2 * Bl / D, 8)`` slots, empty ones keyed
    ``PAD_KEY`` with index -1; one ``all_to_all`` moves keys and indices,
    and the radix argsort sorts what arrives, which comes in (source,
    position) order, so the local stable order is the global one."""
    from stringwars_tpu_torch.parallel.sharding import all_gather_tokens, all_to_all_rows, psum_scalar

    n_cols, Bl = cols.shape
    D, dev = scope.gpus, cols.device
    cap = max(CAPACITY_FACTOR * Bl // D, 8)
    k0 = cols[0].contiguous()
    step = max(Bl // SAMPLES_PER_SHARD, 1)
    gathered = torch.sort(all_gather_tokens(k0[: step * min(SAMPLES_PER_SHARD, Bl) : step].contiguous(), scope)).values
    splitters = gathered[(torch.arange(1, D, device=dev) * gathered.numel()) // D].contiguous()
    dest = torch.searchsorted(splitters, k0, right=True)
    counts = torch.bincount(dest, minlength=D)
    if int(psum_scalar((counts > cap).any().to(torch.int64).reshape(1), scope)):
        return None
    order = torch.argsort(dest, stable=True)
    to = dest[order]
    slot = torch.arange(Bl, device=dev) - (torch.cumsum(counts, 0) - counts)[to]
    send_keys = torch.full((D, cap, n_cols), PAD_KEY, dtype=torch.int32, device=dev)
    send_keys[to, slot] = cols.t()[order]
    send_idx = torch.full((D, cap), -1, dtype=torch.int32, device=dev)
    send_idx[to, slot] = idx[order].to(torch.int32)
    keys = all_to_all_rows(send_keys, scope).reshape(D * cap, n_cols).t().contiguous()
    received = all_to_all_rows(send_idx, scope).reshape(-1)
    return received[lsd_argsort(keys).long()], int((received >= 0).sum())


def sample_sort(tape: Tape, scope, *, prefix_width: int = PREFIX_WIDTH, out=None) -> np.ndarray:
    """``argsort_tape``'s order by ``sample_sort_body`` over the ranks of
    ``scope`` (any world, one rank included): each rank keys its share of
    the tape's rows, the ranks' sorted indices are gathered on every rank,
    and ties on maxed-out prefixes refine on the host. Falls back to
    ``argsort_tape`` when the sampled partition overflows its slots."""
    from stringwars_tpu_torch.parallel.sharding import all_gather_tokens

    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    B, D = tokens.count, scope.gpus
    if B == 0:
        return argsort_tape(tape, prefix_width=prefix_width, out=out)
    Bl = -(-B // D)
    lo, hi = min(scope.rank * Bl, B), min((scope.rank + 1) * Bl, B)
    cols = torch.nn.functional.pad(byte_columns(tokens.data[lo:hi], tokens.lengths[lo:hi]), (0, Bl - (hi - lo)),
                                   value=PAD_KEY)
    idx = torch.full((Bl,), -1, dtype=torch.int64, device=cols.device)
    idx[: hi - lo] = torch.arange(lo, hi, device=cols.device)
    got = sample_sort_body(cols, idx, scope)
    if got is None:
        return argsort_tape(tape, prefix_width=prefix_width, out=out)
    received, kept = got
    everyone = all_gather_tokens(received, scope).view(D, -1).cpu().numpy()
    kept_by_rank = all_gather_tokens(torch.tensor([kept], dtype=torch.int64, device=cols.device), scope).tolist()
    order = np.concatenate([everyone[d, :k] for d, k in enumerate(kept_by_rank)]).astype(np.int64)
    return _write_out(_refine_prefixes(order, tape, tokens, prefix_width), out)


def argsort_sharded(tape: Tape, scope, *, prefix_width: int = PREFIX_WIDTH, out=None) -> np.ndarray:
    """Stable byte-order argsort over a device scope (``parallel.mesh.DeviceScope``):
    the sample sort over its ranks; a scope of one device (or one rank)
    takes the one-device path. The result is always the exact stable order."""
    if scope.group is None or scope.gpus <= 1:
        return argsort_tape(tape, prefix_width=prefix_width, out=out)
    return sample_sort(tape, scope, prefix_width=prefix_width, out=out)


# ---------------------------------------------------------------------------
# Case-folded order
# ---------------------------------------------------------------------------

def _clamp_utf8_boundary(mat: np.ndarray, lengths: np.ndarray, K: int) -> np.ndarray:
    """Per-row key length clamped so no multibyte char is split at K."""
    clamped = np.minimum(lengths, K)
    long = lengths > K
    if not long.any():
        return clamped.astype(np.int32)
    b = mat.astype(np.int32)
    width = np.where(
        b < 0x80, 1, np.where(b < 0xC0, 0, np.where(b < 0xE0, 2, np.where(b < 0xF0, 3, 4)))
    )
    cut = np.full(lengths.shape[0], K, np.int64)
    found = ~long
    for p in (K - 1, K - 2, K - 3):
        if p < 0:
            break
        w = width[:, p]
        is_lead = w > 0
        hit = ~found & is_lead
        cut = np.where(hit & (p + w > K), p, cut)
        found |= is_lead
    return np.where(long, cut, clamped).astype(np.int32)


def uncased_columns(folded: torch.Tensor, counts: torch.Tensor, n_cols: int, pack3: bool) -> torch.Tensor:
    """int32 ``[n_cols, B]`` key columns of folded rows (``fold_tokens``'
    output): codepoint + 1 inside each row's count, 0 past it, the first
    ``n_cols`` columns of three codepoints (``pack3``) or of one."""
    pos = torch.arange(folded.shape[1], device=folded.device)[None, :]
    vals = torch.where(pos < counts[:, None], (folded.to(torch.int64) & 0xFFFFFFFF) + 1, 0) & 0xFFFFFFFF
    vals = vals[:, : n_cols * (3 if pack3 else 1)]
    return pack_columns(vals, pack3)


def uncased_keys_plain(data: torch.Tensor, key_lengths: torch.Tensor, n_cols: int, pack3: bool) -> torch.Tensor:
    """int32 ``[n_cols, B]`` uncased key columns of uint8 ``[B, W]`` rows by
    torch ops: ``casefold.fold_tokens`` of each row's first ``key_lengths``
    bytes, then ``uncased_columns``."""
    return uncased_columns(*_fold_rows(data, key_lengths), n_cols, pack3)


def _fold_rows(data: torch.Tensor, key_lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    from stringwars_tpu_torch.ops.casefold import fold_tokens

    return fold_tokens(PaddedTokens(data=data, lengths=key_lengths, width=data.shape[1]))


def _packing(max_count: int, max_cp: int) -> tuple[int, bool]:
    """(n_cols, pack3) for a batch's largest folded count and codepoint."""
    pack3 = max_cp <= 509
    return max(1, (-(-max_count // 3)) if pack3 else max_count), pack3


def uncased_keys(data: torch.Tensor, key_lengths: torch.Tensor, n_cols: int, pack3: bool) -> torch.Tensor:
    """int32 ``[n_cols, B]`` uncased key columns of uint8 ``[B, W]`` rows, on
    their device: the kernel on a card, the plain version on the CPU."""
    if data.device.type == "cuda":
        from stringwars_tpu_torch.ops import sort_cuda

        return sort_cuda.uncased_keys(data, key_lengths, n_cols, pack3)
    if data.device.type == "cpu":
        return uncased_keys_plain(data, key_lengths, n_cols, pack3)
    raise ValueError(f"uncased_keys runs on a CUDA or CPU tensor, not {data.device}")


def uncased_order(data: torch.Tensor, key_lengths: torch.Tensor, n_cols: int, pack3: bool) -> torch.Tensor:
    """int32[B]: the stable order of uint8 ``[B, W]`` rows by the full case
    fold of their first ``key_lengths`` bytes: keys, then sort, on the rows'
    device (``stringwars_tpu.ops.sort._uncased_order``)."""
    return lsd_argsort(uncased_keys(data, key_lengths, n_cols, pack3))


def uncased_plan(data: torch.Tensor, key_lengths: torch.Tensor) -> tuple[int, bool]:
    """(n_cols, pack3) of uint8 ``[B, W]`` rows folded as ``uncased_keys``
    folds them: three codepoints a column when every folded codepoint + 1
    fits 9 bits (at most 509), else one; enough columns for the longest
    fold. On a card the kernel's plan mode, on the CPU the plain fold."""
    if data.numel() == 0:
        max_count, max_cp = 0, 0
    elif data.device.type == "cuda":
        from stringwars_tpu_torch.ops import sort_cuda

        max_count, max_cp = sort_cuda.uncased_extent(data, key_lengths)
    elif data.device.type == "cpu":
        folded, counts = _fold_rows(data, key_lengths)
        max_count, max_cp = int(counts.max()), int(folded.max())
    else:
        raise ValueError(f"uncased_plan runs on a CUDA or CPU tensor, not {data.device}")
    return _packing(max_count, max_cp)


def stage_uncased(tape: Tape, prefix_width: int = PREFIX_WIDTH):
    """(tokens, key_lengths tensor, full lengths) of a tape for the uncased
    order: the prefix rows and each row's key length clamped to a UTF-8
    boundary at ``min(prefix_width, width)``."""
    full_lengths = _full_lengths(tape)
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=prefix_width)
    mat = tokens.data.cpu().numpy()
    key_lengths = _clamp_utf8_boundary(mat, full_lengths, min(prefix_width, mat.shape[1]))
    return tokens, torch.from_numpy(key_lengths).to(tokens.data.device), full_lengths


def argsort_uncased(tape: Tape, *, prefix_width: int = PREFIX_WIDTH, out=None) -> np.ndarray:
    """Case-folded order: sort keys are full-case-folded codepoints.

    Compares fold(a) with fold(b) as codepoint sequences
    (``sequence/bench.rs:86-93``): the batch's packing plan, its key columns
    and the sort on the tape's device; ties on maxed-out prefixes refine on
    the host with ``str.casefold``. The fold decides the packing: three
    codepoints a column only when the folded ceiling is at most 509.
    """
    tokens, key_lengths, full_lengths = stage_uncased(tape, prefix_width)
    width = tokens.data.shape[1]
    if tokens.data.device.type == "cpu" and tokens.data.numel():  # one fold gives the plan and the columns
        folded, counts = _fold_rows(tokens.data, key_lengths)
        columns = uncased_columns(folded, counts, *_packing(int(counts.max()), int(folded.max())))
    else:
        columns = uncased_keys(tokens.data, key_lengths, *uncased_plan(tokens.data, key_lengths))
    order_dev = lsd_argsort(columns)
    order = order_dev.cpu().numpy().astype(np.int64)

    # >= not >: length-== -prefix_width rows can tie a longer row's folded
    # prefix key exactly and still need host refinement (see argsort_tape).
    maxed = full_lengths >= min(prefix_width, width)
    if maxed.any():
        # The plan's columns hold each row's whole fold (codepoint + 1, 0
        # past its count): equal columns are an equal folded sequence.
        packed = columns[:, order_dev.to(torch.int64)]
        eq = (packed[:, 1:] == packed[:, :-1]).all(0).cpu().numpy()
        tie = eq & (maxed[order][1:] | maxed[order][:-1])
        toks = tape.to_list()

        def fold_key(i):
            return toks[i].decode("utf-8", "ignore").casefold()

        order = _refine_ties(order, tie, fold_key)
    return _write_out(order, out)


def sorted_tokens(tape: Tape, *, uncased: bool = False) -> list[bytes]:
    order = argsort_uncased(tape) if uncased else argsort_tape(tape)
    tokens = tape.to_list()
    return [tokens[i] for i in order]
