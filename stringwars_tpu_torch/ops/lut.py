"""Table lookups over codepoints: ``class_map`` and ``lut_map`` (K9/K10/K12).

The port of ``stringwars_tpu.ops.lut``. On the TPU, ``lut_map`` runs a
Pallas kernel that splits the table into 128-entry lane windows
(``lane_lut``, ``paged_lane_lut``, ``replicate8``) because XLA's gathers
run near-scalar there. Those helpers have no counterpart here: on Hopper a
table lookup is one indexed load through the read-only cache, which is
what the kernel ``csrc/classmap.cu`` does. The same kernel also replaces
the TPU's step-function walk (``ops/rulemap.step_map``), which evaluates a
class table from its run boundaries.

- ``class_map(cps, table)``: ``table[clamp(cps, 0, size - 1)]`` as int32,
  for a 1-D uint8 or int32 ``table`` tensor on the codepoints' device: the
  kernel for a CUDA tensor, ``class_map_plain`` for a CPU tensor.
- ``stage_table(table, device)``: a numpy table as the tensor
  ``class_map`` takes, narrowed to uint8 when every value fits.
- ``lut_map(values, table)``: int32 in, int32 out, any shape; the JAX
  function's contract, with out-of-range values clamped to the table.
- ``range_map_cuda(cps, table, add_base)``: ``cp * add_base +
  table[clamp(cp, 0, size - 1)]`` over an int32 table by the second entry
  point of ``csrc/classmap.cu``, the lookup of ``ops/rulemap.range_map``
  (the TPU's ``_range_kernel``), counted apart as ``range_map``.
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch import build

# Launches of csrc/classmap.cu since process start (or the last reset).
LAUNCHES = {"class_map": 0, "range_map": 0}


def stage_table(table, device) -> torch.Tensor:
    """A dense table as a contiguous uint8 (when every value is in
    [0, 255]) or int32 tensor on ``device``."""
    t = np.asarray(table)
    if t.ndim != 1 or t.size == 0:
        raise ValueError(f"expected a non-empty 1-D table, got shape {t.shape}")
    narrow = t.dtype == np.bool_ or (int(t.min()) >= 0 and int(t.max()) <= 255)
    return torch.from_numpy(np.ascontiguousarray(t.astype(np.uint8 if narrow else np.int32))).to(device)


def _check(cps: torch.Tensor, table: torch.Tensor) -> None:
    if table.dim() != 1 or table.numel() == 0 or table.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"expected a non-empty 1-D uint8 or int32 table, got {table.dtype}{tuple(table.shape)}")
    if table.device != cps.device:
        raise ValueError(f"table on {table.device}, codepoints on {cps.device}")
    if cps.dtype.is_floating_point or cps.dtype == torch.bool:
        raise ValueError(f"expected integer codepoints, got {cps.dtype}")


def class_map_plain(cps: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[clamp(cps, 0, size - 1)]`` as int32, by an indexed gather."""
    _check(cps, table)
    idx = cps.to(torch.int64).clamp(0, table.numel() - 1)
    return table[idx].to(torch.int32)


def class_map_cuda(cps: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[clamp(cps, 0, size - 1)]`` as int32 by the CUDA kernel, any
    shape, without waiting for it."""
    if not isinstance(cps, torch.Tensor) or cps.device.type != "cuda":
        raise ValueError(f"class_map: the CUDA kernel needs a CUDA tensor, got {getattr(cps, 'device', type(cps))}")
    _check(cps, table)
    if not table.is_contiguous():
        raise ValueError("class_map: expected a contiguous table")
    flat = cps.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty_like(flat)
    if flat.numel():
        lib = build.library()
        with torch.cuda.device(cps.device):
            code = lib.sw_class_map(
                flat.data_ptr(), flat.numel(), table.data_ptr(), table.numel(), table.element_size(),
                out.data_ptr(), build.stream_of(flat),
            )
        build.check(code, "class_map")
        LAUNCHES["class_map"] += 1
    return out.view(cps.shape)


def range_map_cuda(cps: torch.Tensor, table: torch.Tensor, add_base: bool) -> torch.Tensor:
    """``(cps if add_base else 0) + table[clamp(cps, 0, size - 1)]`` as int32
    (the add wraps) by the CUDA kernel, any shape, without waiting for it.
    ``table``: a contiguous 1-D int32 tensor on the codepoints' device."""
    if not isinstance(cps, torch.Tensor) or cps.device.type != "cuda":
        raise ValueError(f"range_map: the CUDA kernel needs a CUDA tensor, got {getattr(cps, 'device', type(cps))}")
    _check(cps, table)
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError(f"range_map: expected a contiguous int32 table, got {table.dtype}")
    flat = cps.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty_like(flat)
    if flat.numel():
        lib = build.library()
        with torch.cuda.device(cps.device):
            code = lib.sw_range_map(
                flat.data_ptr(), flat.numel(), table.data_ptr(), table.numel(), int(bool(add_base)),
                out.data_ptr(), build.stream_of(flat),
            )
        build.check(code, "range_map")
        LAUNCHES["range_map"] += 1
    return out.view(cps.shape)


def class_map(cps: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[clamp(cps, 0, size - 1)]`` as int32: the kernel for a CUDA
    tensor, the plain gather for a CPU tensor."""
    if cps.device.type == "cuda":
        return class_map_cuda(cps, table)
    if cps.device.type == "cpu":
        return class_map_plain(cps, table)
    raise ValueError(f"class_map runs on a CUDA or CPU tensor, not {cps.device}")


def lut_map(values: torch.Tensor, table) -> torch.Tensor:
    """``table[values]`` for any-shape int values, int32 out; values outside
    the table are clamped to its ends. ``table``: a numpy array or a tensor
    (staged as int32, the JAX function's table type)."""
    if isinstance(table, torch.Tensor):
        t = table.to(device=values.device, dtype=torch.int32).reshape(-1).contiguous()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(table, np.int32).reshape(-1))).to(values.device)
    return class_map(values.to(torch.int32), t)
