"""Wrapper of the hand-written LSD radix argsort in ``csrc/radixsort.cu``.

The counterpart of the XLA sort ``stringwars_tpu.ops.sort._lsd_argsort``:
the stable lexicographic permutation of the rows of an ``[n_cols, n]`` key
matrix (column 0 most significant, ties in index order). The wrapper reads
each column's OR and AND over the batch (one launch and one 8-byte-a-column
readback), plans a pass for each 9-bit digit that varies, least significant
first, allocates the scratch and launches the passes on PyTorch's current
stream; it adds one to ``LAUNCHES["radix_argsort"]`` per call that launches.
A CPU tensor raises: the plain version lives in ``ops/sort.py``.
"""

from __future__ import annotations

import ctypes

import torch

from stringwars_tpu_torch import build

# Launches since process start (or the last reset): one a call of at least two keys.
LAUNCHES = {"radix_argsort": 0}

DIGIT_BITS = 9  # csrc/radixsort.cu kRadixBits
TILE = 4096  # csrc/radixsort.cu kTile: positions a histogram and scatter block takes
SHIFTS = tuple(range(0, 32, DIGIT_BITS))  # 0, 9, 18, 27


def plan_passes(spread: list[int], n_cols: int) -> list[tuple[int, int]]:
    """(column, shift) of each pass, least significant first, for the digits
    that vary over the batch: ``spread`` holds each column's OR, then each
    column's AND."""
    passes = []
    for c in reversed(range(n_cols)):
        varying = spread[c] ^ spread[n_cols + c]
        passes += [(c, shift) for shift in SHIFTS if (varying >> shift) & ((1 << DIGIT_BITS) - 1)]
    return passes


def radix_argsort(columns: torch.Tensor) -> torch.Tensor:
    """int32[n]: the stable argsort of the rows of ``columns`` (int32 or
    uint32 ``[n_cols, n]`` on a CUDA device, each entry read as its uint32
    bits; n < 2^31), by the kernel."""
    if not isinstance(columns, torch.Tensor) or columns.device.type != "cuda":
        raise ValueError(f"radix_argsort: the CUDA kernel needs a CUDA tensor, got {getattr(columns, 'device', type(columns))}")
    if columns.dtype not in (torch.int32, torch.uint32) or columns.dim() != 2 or not columns.is_contiguous():
        raise ValueError(f"radix_argsort: expected a contiguous int32 [n_cols, n] matrix, got {columns.dtype}{tuple(columns.shape)}")
    n_cols, n = columns.shape
    if n >= 1 << 31:
        raise ValueError(f"radix_argsort: {n} keys, at most 2^31 - 1")
    dev = columns.device
    if n <= 1 or n_cols == 0:
        return torch.arange(n, dtype=torch.int32, device=dev)
    lib = build.library()
    stream = build.stream_of(columns)
    spread = torch.empty(2 * n_cols, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.sw_radix_spread(columns.data_ptr(), n_cols, n, spread.data_ptr(), stream)
    build.check(code, "radix_argsort")
    LAUNCHES["radix_argsort"] += 1
    passes = plan_passes([v & 0xFFFFFFFF for v in spread.tolist()], n_cols)
    if not passes:  # every key equal: the identity is the stable order
        return torch.arange(n, dtype=torch.int32, device=dev)
    plan = (ctypes.c_int64 * (2 * len(passes)))(*(v for p in passes for v in p))
    columns_repeat = any(a[0] == b[0] for a, b in zip(passes, passes[1:]))
    order = torch.empty(n, dtype=torch.int32, device=dev)
    order_tmp = torch.empty(n if len(passes) > 1 else 1, dtype=torch.int32, device=dev)
    keys = torch.empty((2, n) if columns_repeat else (2, 1), dtype=torch.int32, device=dev)
    counts = torch.empty((1 << DIGIT_BITS) * -(-n // TILE), dtype=torch.int32, device=dev)
    totals = torch.empty(1 << DIGIT_BITS, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.sw_radix_argsort(
            columns.data_ptr(), n_cols, n, plan, len(passes), order.data_ptr(), order_tmp.data_ptr(), keys[0].data_ptr(),
            keys[1].data_ptr(), counts.data_ptr(), totals.data_ptr(), stream,
        )
    build.check(code, "radix_argsort")
    return order
