"""Wrappers of the hand-written sort kernels: the LSD radix argsort of
``csrc/radixsort.cu`` and the uncased keys of ``csrc/uncased_keys.cu``.

``radix_argsort`` is the counterpart of the XLA sort
``stringwars_tpu.ops.sort._lsd_argsort``: the stable lexicographic
permutation of the rows of an ``[n_cols, n]`` key matrix (column 0 most
significant, ties in index order). The wrapper allocates the scratch and makes
one call of the C entry point, which, on PyTorch's current stream, reads each
column's OR and AND over the batch (one launch and one 8-byte-a-column
readback), plans a pass for each 9-bit digit that varies, least significant
first, and launches the digit count of every planned pass and then one launch
a pass; it adds one to ``LAUNCHES["radix_argsort"]`` per call that launches.
``radix_argsort_planned`` also gives the plan the call ran, as the entry point
wrote it back.

``uncased_keys`` is the counterpart of the fold and packing of
``stringwars_tpu.ops.sort._uncased_order``: the int32 ``[n_cols, B]`` key
columns of the full case fold of padded rows, in one launch over the rows
where they lie: ASCII rows by word arithmetic, the others a thread a row,
listed by length class, through the dense fold table of ``uncased_table``
(staged once a device). ``uncased_extent`` runs the same kernel in its plan mode: the batch's
largest folded count and codepoint, one 8-byte readback. Each adds one to
``LAUNCHES["uncased_keys"]``.

A CPU tensor raises: the plain versions live in ``ops/sort.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stringwars_tpu_torch import build

# Launches since process start (or the last reset): a radix call of at least
# two keys; each uncased keys or extent call of at least one row.
LAUNCHES = {"radix_argsort": 0, "uncased_keys": 0}

DIGIT_BITS = 9  # csrc/radixsort.cu kRadixBits
TILE = 4096  # csrc/radixsort.cu kTile: positions a pass's block takes
SHIFTS = tuple(range(0, 32, DIGIT_BITS))  # 0, 9, 18, 27
MAX_UNCASED_WIDTH = 904  # csrc/uncased_keys.cu kUncasedMaxWidth: 128 staged rows and the column tile in 227 KB


def radix_argsort(columns: torch.Tensor) -> torch.Tensor:
    """int32[n]: the stable argsort of the rows of ``columns`` (int32 or
    uint32 ``[n_cols, n]`` on a CUDA device, each entry read as its uint32
    bits; n < 2^31), by the kernel."""
    return radix_argsort_planned(columns)[0]


def radix_argsort_planned(columns: torch.Tensor) -> tuple[torch.Tensor, list[tuple[int, int]]]:
    """``radix_argsort(columns)`` and the (column, shift) of each pass it ran,
    least significant first (none where every key is equal or n < 2)."""
    if not isinstance(columns, torch.Tensor) or columns.device.type != "cuda":
        raise ValueError(f"radix_argsort: the CUDA kernel needs a CUDA tensor, got {getattr(columns, 'device', type(columns))}")
    if columns.dtype not in (torch.int32, torch.uint32) or columns.dim() != 2 or not columns.is_contiguous():
        raise ValueError(f"radix_argsort: expected a contiguous int32 [n_cols, n] matrix, got {columns.dtype}{tuple(columns.shape)}")
    n_cols, n = columns.shape
    if n >= 1 << 31 or n_cols > 65535:
        raise ValueError(f"radix_argsort: {n_cols} columns of {n} keys, at most 65,535 of 2^31 - 1")
    dev = columns.device
    if n <= 1 or n_cols == 0:
        return torch.arange(n, dtype=torch.int32, device=dev), []
    # order_tmp and both key buffers; the spread, the device plan, the digit
    # counts and the tickets, each at its size for 4 passes a column; the
    # look-back words (512 a tile); the plan written back.
    order = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty((3, n), dtype=torch.int32, device=dev)
    small = torch.empty((2 + 16 + 4 * (1 << DIGIT_BITS) + 4) * n_cols, dtype=torch.int32, device=dev)
    status = torch.empty((1 << DIGIT_BITS) * -(-n // TILE), dtype=torch.int64, device=dev)
    host_plan = np.zeros(1 + 2 * len(SHIFTS) * n_cols, np.int32)
    base = small.data_ptr()
    with torch.cuda.device(dev):
        code = build.library().sw_radix_argsort(
            columns.data_ptr(), n_cols, n, order.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            scratch[2].data_ptr(), base, base + 4 * 2 * n_cols, base + 4 * 18 * n_cols, status.data_ptr(),
            base + 4 * (18 + 4 * (1 << DIGIT_BITS)) * n_cols, host_plan.ctypes.data, build.stream_of(columns),
        )
    build.check(code, "radix_argsort")
    LAUNCHES["radix_argsort"] += 1
    passes = [(int(c), int(shift)) for c, shift in host_plan[1 : 1 + 2 * host_plan[0]].reshape(-1, 2)]
    if not passes:  # every key equal: the identity is the stable order
        return torch.arange(n, dtype=torch.int32, device=dev), passes
    return order, passes


# ---------------------------------------------------------------------------
# Uncased keys
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def uncased_table() -> np.ndarray:
    """int32 ``[size, 2]``: the full case fold of each codepoint below
    ``size`` as the kernel reads it, derived from the fold's range maps
    (``casefold._fold_rules``) as ``casefold.fold_tokens`` evaluates them:
    entry 0 is the first output codepoint ``| outputs << 24`` (one output
    where the codepoint does not expand), entry 1 the second ``| third <<
    16``. ``size`` is past every rule, so that a codepoint at or above it
    folds to itself, as the range maps give. Below 0x80 the fold must be the
    ASCII lowercase, one output a codepoint: the kernel computes those
    without the table."""
    from stringwars_tpu_torch.ops import casefold as CF
    from stringwars_tpu_torch.ops import rulemap as R

    simple, mlen_rules, e12_rules, e3_rules, _ = CF._fold_rules(None)
    rules = (simple, mlen_rules, e12_rules, e3_rules)
    size = max(int(r.hi.max()) + 2 for r in rules)
    simple_d, mlen, e12, e3 = (np.pad(t, (0, size - t.size)) for t in map(R.dense_delta_table, rules))
    folded = np.arange(size, dtype=np.int32) + simple_d
    outputs = np.where(mlen > 0, mlen, 1)
    first = np.where(mlen > 0, e12 & 0xFFFF, folded)
    second, third = e12 >> 16, e3
    if not (((0 <= first) & (first < 1 << 24)).all() and ((0 <= second) & (second <= 0xFFFF)).all()
            and ((0 <= third) & (third <= 0xFFFF)).all() and ((1 <= outputs) & (outputs <= 3)).all()):
        raise ValueError("the fold's tables do not fit the kernel's packed entries")
    table = np.stack([first | (outputs << 24), second | (third << 16)], axis=1)
    ascii_cps = np.arange(0x80)
    if not np.array_equal(table[:0x80, 0], np.where((ascii_cps >= 0x41) & (ascii_cps <= 0x5A), ascii_cps + 0x20,
                                                    ascii_cps) | (1 << 24)):
        raise ValueError("the fold is not the ASCII lowercase below 0x80, which the kernel computes without the table")
    return np.ascontiguousarray(table, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _staged_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(uncased_table()).to(device)


def _uncased_launch(data: torch.Tensor, key_lengths: torch.Tensor, n_cols: int, pack3: bool, plan: bool, out: torch.Tensor):
    rows, width = data.shape
    table = _staged_table(data.device)
    lib = build.library()
    with torch.cuda.device(data.device):
        code = lib.sw_uncased_keys(data.data_ptr(), key_lengths.data_ptr(), rows, width, table.data_ptr(), table.shape[0],
                                   n_cols, int(pack3), int(plan), out.data_ptr(), build.stream_of(data))
    build.check(code, "uncased_keys")
    LAUNCHES["uncased_keys"] += 1


def _check_rows(data: torch.Tensor, key_lengths: torch.Tensor, what: str) -> None:
    build.require_cuda_bytes(data, what)
    if data.dim() != 2:
        raise ValueError(f"{what}: expected uint8 [rows, width] rows, got {tuple(data.shape)}")
    if data.shape[1] > MAX_UNCASED_WIDTH:
        raise ValueError(f"{what}: rows of {data.shape[1]} bytes, at most {MAX_UNCASED_WIDTH}")
    if (key_lengths.dtype != torch.int32 or key_lengths.shape != (data.shape[0],) or not key_lengths.is_contiguous()
            or key_lengths.device != data.device):
        raise ValueError(f"{what}: key_lengths must be a contiguous int32[{data.shape[0]}] tensor on {data.device}, got "
                         f"{key_lengths.dtype}{tuple(key_lengths.shape)} on {key_lengths.device}")


def uncased_keys(data: torch.Tensor, key_lengths: torch.Tensor, n_cols: int, pack3: bool) -> torch.Tensor:
    """int32 ``[n_cols, B]``: the uncased key columns of the uint8 ``[B, W]``
    rows on a CUDA device (the folded codepoints of each row's first
    ``key_lengths`` bytes + 1, three a column with ``pack3``, else one; 0
    past the row's folded count), by the kernel."""
    _check_rows(data, key_lengths, "uncased_keys")
    if n_cols < 1:
        raise ValueError(f"uncased_keys: n_cols must be at least 1, got {n_cols}")
    out = torch.empty((n_cols, data.shape[0]), dtype=torch.int32, device=data.device)
    if data.numel() == 0:
        return out.zero_()
    _uncased_launch(data, key_lengths, n_cols, pack3, False, out)
    return out


def uncased_extent(data: torch.Tensor, key_lengths: torch.Tensor) -> tuple[int, int]:
    """(largest folded count, largest folded codepoint) over the rows (0 and
    0 for none), by the kernel's plan mode: one launch and an 8-byte
    readback."""
    _check_rows(data, key_lengths, "uncased_extent")
    if data.numel() == 0:
        return 0, 0
    out = torch.empty(2, dtype=torch.int32, device=data.device)
    _uncased_launch(data, key_lengths, 0, False, True, out)
    max_count, max_cp = out.tolist()
    return max_count, max_cp
