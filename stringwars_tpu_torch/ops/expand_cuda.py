"""Wrapper of the hand-written CUDA kernel in ``csrc/expand.cu``.

The counterpart of ``stringwars_tpu.ops.casefold_pallas._expand_stage``.
The wrapper checks its tensors, allocates the outputs, launches on
PyTorch's current stream without synchronizing, raises on a CUDA launch
error, and adds one to ``LAUNCHES["expand"]``. A CPU tensor raises: the
plain version is ``ops/expand.expand_compact_rows_plain``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.expand import ExpandTables, _check

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"expand": 0}


def expand_compact_rows(data: torch.Tensor, lengths: torch.Tensor, tables: ExpandTables, max_exp: int, group: int,
                        utf8: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out int32[B, max_exp * group], counts int32[B])`` on the device by
    the kernel; ``lengths`` (int32 on the device) at most ``group`` each."""
    if not isinstance(data, torch.Tensor) or data.device.type != "cuda":
        raise ValueError(f"expand: the CUDA kernel needs a CUDA tensor, got {getattr(data, 'device', type(data))}")
    _check(data, lengths, tables, max_exp, group, utf8)
    if lengths.dtype != torch.int32:
        raise ValueError(f"expand: expected int32 lengths, got {lengths.dtype}")
    data, lengths = data.contiguous(), lengths.contiguous()
    ts = tables.on(data.device)
    rows = data.shape[0]
    out = torch.empty((rows, max_exp * group), dtype=torch.int32, device=data.device)
    counts = torch.empty(rows, dtype=torch.int32, device=data.device)
    if rows:
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_expand(
                data.data_ptr(), rows, group, int(utf8), lengths.data_ptr(),
                ts[0].data_ptr(), ts[1].data_ptr() if len(ts) > 1 else None, ts[2].data_ptr() if len(ts) > 2 else None,
                tables.size, max_exp, out.data_ptr(), counts.data_ptr(), build.stream_of(data),
            )
        build.check(code, "expand")
        LAUNCHES["expand"] += 1
    return out, counts
