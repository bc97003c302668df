"""The radix argsort kernel's pass plan (``csrc/radixsort.cu``'s entry
point), as the CPU tests replay it: a stable pass for each 9-bit digit that
varies over the batch, least significant column first and least significant
digit first within a column; a digit that is constant over the batch is
skipped."""

import numpy as np

SHIFTS = (0, 9, 18, 27)


def digit_plan(cols: np.ndarray) -> list[tuple[int, int]]:
    """(column, shift) of each pass over the ``[n_cols, n]`` uint32 keys."""
    passes = []
    for c in reversed(range(cols.shape[0])):
        varying = int(np.bitwise_or.reduce(cols[c])) ^ int(np.bitwise_and.reduce(cols[c])) if cols.shape[1] else 0
        passes += [(c, shift) for shift in SHIFTS if (varying >> shift) & 511]
    return passes
