"""Sharded placement and the collectives of a scope (the cross-device layer).

The port of ``stringwars_tpu.parallel.sharding`` on ``torch.distributed``.
Where the JAX package places one global array across a mesh, each rank here
materialises only its own share, on its own device:

- **Token data-parallelism**: ``shard_tokens`` gives a rank its rows of a
  batch padded to a multiple of the scope's ranks; kernels run on them and
  reduce through ``psum_scalar`` or gather through ``all_gather_tokens``.
- **Byte-axis sharding with halos**: ``shard_bytes`` gives a rank bytes
  ``[r * chunk, (r + 1) * chunk + overlap)`` of a buffer (``chunk`` rounded
  up to 512 bytes, so each row starts 16-byte aligned and
  ``build.aligned_bytes`` copies nothing), so windowed scans see every
  window whole; ``owned_count`` counts a pattern set's matches that start
  in the rank's own chunk.

A scope without a process group (one device) keeps everything: its share is
the whole, and its reductions return their input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from stringwars_tpu_torch.parallel.mesh import DeviceScope

ALIGN = 512  # bytes: a chunk is a multiple, so every rank's row starts 16-byte aligned


def aligned_chunk(n: int, parts: int) -> int:
    """Bytes a part: ``ceil(n / parts)`` rounded up to ``ALIGN``."""
    return (-(-n // parts) + ALIGN - 1) // ALIGN * ALIGN


def replicate(scope: DeviceScope, tree):
    """Every array of ``tree`` (an array, or a tuple, list or dict of them)
    on the scope's device: each rank holds its own copy."""
    if isinstance(tree, dict):
        return {k: replicate(scope, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(scope, v) for v in tree)
    return torch.as_tensor(tree).to(scope.device)


def shard_tokens(scope: DeviceScope, array) -> tuple[torch.Tensor, int]:
    """(this rank's rows of ``array`` on the scope's device, valid count):
    the leading axis padded with zeros to a multiple of the scope's ranks,
    then cut into equal shares."""
    array = torch.as_tensor(array)
    n = array.shape[0]
    per = -(-n // scope.gpus)
    lo, hi = scope.rank * per, min((scope.rank + 1) * per, n)
    share = array[lo:hi].to(scope.device)
    if hi - lo < per:
        pad = torch.zeros((per - max(hi - lo, 0), *array.shape[1:]), dtype=array.dtype, device=scope.device)
        share = torch.cat([share, pad])
    return share, n


def shard_bytes(scope: DeviceScope, data, *, overlap: int = 0) -> tuple[torch.Tensor, int, int]:
    """(row uint8[chunk + overlap] on the scope's device, n, chunk): this
    rank's bytes ``[rank * chunk, (rank + 1) * chunk + overlap)`` of the flat
    buffer ``data`` (a tensor or array), zero past its end."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data, np.uint8))
    n = data.numel()
    chunk = aligned_chunk(n, scope.gpus)
    lo = scope.rank * chunk
    row = torch.zeros(chunk + overlap, dtype=torch.uint8, device=scope.device)
    part = data[lo : min(lo + chunk + overlap, n)]
    row[: part.numel()] = part.to(scope.device)
    return row, n, chunk


def owned_count(count, row: torch.Tensor, chunk: int, extent: int) -> torch.Tensor:
    """Matches of a pattern set that start in ``row[:chunk]`` and end inside
    ``row[:extent]``, where ``count(hay, n)`` counts every match inside
    ``hay[:n]`` and ``extent - chunk`` is below the longest pattern: the
    matches of ``row[:extent]`` less those lying wholly in the halo after
    the chunk (each of those starts past it; any match that starts past it
    lies wholly there)."""
    total = count(row, extent)
    if extent > chunk:
        total = total - count(row[chunk:], extent - chunk)
    return total


def psum_scalar(value: torch.Tensor, scope: DeviceScope) -> torch.Tensor:
    """The sum of ``value`` (a tensor of any shape) over the scope's ranks."""
    if scope.group is None:
        return value
    out = value.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=scope.group)
    return out


def pmax_scalar(value: torch.Tensor, scope: DeviceScope) -> torch.Tensor:
    """The elementwise maximum of ``value`` over the scope's ranks."""
    if scope.group is None:
        return value
    out = value.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=scope.group)
    return out


def all_gather_tokens(value: torch.Tensor, scope: DeviceScope) -> torch.Tensor:
    """Every rank's ``value`` stacked on the leading axis in rank order (the
    JAX ``all_gather(..., tiled=True)``), on every rank."""
    if scope.group is None:
        return value
    value = value.contiguous()
    out = torch.empty((scope.gpus * value.shape[0], *value.shape[1:]), dtype=value.dtype, device=value.device)
    dist.all_gather_into_tensor(out, value, group=scope.group)
    return out


def all_to_all_rows(value: torch.Tensor, scope: DeviceScope) -> torch.Tensor:
    """Block ``d`` of ``value``'s leading axis (cut into one equal block a
    rank) sent to rank ``d``; returns the blocks received, in rank order."""
    if scope.group is None:
        return value
    out = torch.empty_like(value)
    dist.all_to_all_single(out, value.contiguous(), group=scope.group)
    return out
