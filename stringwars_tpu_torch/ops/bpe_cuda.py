"""Wrapper of the hand-written CUDA kernel in ``csrc/bpe.cu``.

The counterpart of ``stringwars_tpu.ops.bpe_pallas.bpe_encode_fused``'s
kernel (``_make_kernel`` via ``_bpe_tiles``). The wrapper checks its
tensors, allocates the outputs, launches on PyTorch's current stream
without synchronizing, raises on a CUDA launch error, and adds one to
``LAUNCHES["bpe"]``. A CPU tensor raises: the plain version is
``ops/bpe.bpe_encode_plain``.

The kernel encodes several rows a warp, in lane groups, and looks pairs up
in the table's hashed form (``MergeTable.hashed``: two buckets of two
entries a key), in one of two regimes (``regime_of``): a hashed table of up
to ``SHARED_BYTES`` is staged in shared memory per block, a larger one is
read from global memory through the read-only cache. ``global_table=True``
asks for the second at any size, to time the two against each other.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.bpe import KERNEL_WIDTH, MergeTable, check_batch

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"bpe": 0}
SHARED_BYTES = 48 << 10  # the most a launch stages without an opt-in: 2,048 buckets, up to 2,048 merges


def regime_of(table: MergeTable, global_table: bool = False) -> str:
    """Where the kernel reads ``table``: "shared" or "global" memory."""
    return "shared" if table.hashed().buckets.nbytes <= SHARED_BYTES and not global_table else "global"


def bpe_encode(data: torch.Tensor, lengths: torch.Tensor, table: MergeTable, *,
               global_table: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids int32[B, W] with -1 padding, counts int32[B])`` on the device by
    the kernel, for ``W`` from 1 to 32; ``lengths`` int32, clamped to [0, W].
    ``global_table``: read the table from global memory even where it fits
    shared memory."""
    build.require_cuda_bytes(data, "bpe")
    check_batch(data, lengths, table)
    rows, width = data.shape
    if not 1 <= width <= KERNEL_WIDTH:
        raise ValueError(f"bpe: the kernel takes rows of 1 to {KERNEL_WIDTH} bytes, got {width}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"bpe: expected int32 lengths, got {lengths.dtype}")
    lengths = lengths.contiguous()
    buckets, hashed = table.on(data.device)[3], table.hashed()
    ids = torch.empty((rows, width), dtype=torch.int32, device=data.device)
    counts = torch.empty(rows, dtype=torch.int32, device=data.device)
    if rows:
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_bpe(
                data.data_ptr(), rows, width, lengths.data_ptr(), buckets.data_ptr(), buckets.shape[0], *hashed.mults,
                int(regime_of(table, global_table) == "shared"), ids.data_ptr(), counts.data_ptr(), build.stream_of(data),
            )
        build.check(code, "bpe")
        LAUNCHES["bpe"] += 1
    return ids, counts
