"""Process groups and host-local data placement on ``torch.distributed``.

The port of ``stringwars_tpu.parallel.distributed``. The port runs one
process a device (a rank): NCCL joins the ranks on cards, gloo on the CPU
when the caller asks for it (``--device cpu``, how the tests run).

- ``maybe_initialize(device)`` joins the process group that the
  environment describes: torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, or the JAX package's ``SWTPU_COORDINATOR``,
  ``SWTPU_NUM_PROCESSES`` and ``SWTPU_PROCESS_ID`` (one process a host, as
  there). ``initialize`` does the same from explicit arguments.
- ``host_byte_range()`` is the slice of a global corpus a rank loads: its
  chunk plus the halo tail that windowed scans read past it, so no rank
  reads another's bytes at run time.
- ``shard_bytes_local()`` makes the rank's halo row from those bytes, the
  row ``sharding.shard_bytes`` would give it from the whole corpus.

A rank's device is ``cuda:LOCAL_RANK``, set before the group is made. A
rank that finds no card and was not asked for the CPU raises, and a failure
to make the NCCL group raises: nothing falls back to gloo on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.parallel.sharding import aligned_chunk

_RANKS_PER_HOST: list[int] = []  # recorded by initialize, for the scope's host count


def initialize(device: str = "cuda", *, init_method: str = "env://", rank: int | None = None,
               world_size: int | None = None, local_rank: int = 0, local_world_size: int | None = None) -> torch.device:
    """Join the process group (idempotent) and return this rank's device:
    ``cuda:local_rank`` over NCCL for ``"cuda"``, the CPU over gloo for
    ``"cpu"``. ``local_world_size`` is the ranks on this host (default: all)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank}: no CUDA device (torch.cuda.is_available() is false). A rank runs on its card; "
                "pass --device cpu to join the ranks over gloo on the CPU."
            )
        if not 0 <= local_rank < torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: LOCAL_RANK {local_rank} but {torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(local_rank)
        dev, backend = torch.device("cuda", local_rank), "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unknown device {device!r}; choose cuda or cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
        _RANKS_PER_HOST[:] = [local_world_size or dist.get_world_size()]
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not the {backend} that {device} needs")
    return dev


def maybe_initialize(device: str = "cuda") -> bool:
    """Join the process group if the environment asks for one; True when the
    world has more than one rank. Idempotent; safe to call from every suite."""
    env = os.environ
    if env.get("SWTPU_COORDINATOR"):
        initialize(device, init_method=f"tcp://{env['SWTPU_COORDINATOR']}", rank=int(env["SWTPU_PROCESS_ID"]),
                   world_size=int(env["SWTPU_NUM_PROCESSES"]), local_world_size=1)
    elif "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        initialize(device, rank=int(env["RANK"]), world_size=world, local_rank=int(env.get("LOCAL_RANK", 0)),
                   local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)))
    return dist.is_initialized() and dist.get_world_size() > 1


def ranks_per_host() -> int:
    """Ranks on each host of the initialized world."""
    return _RANKS_PER_HOST[0] if _RANKS_PER_HOST else dist.get_world_size()


def host_byte_range(total_bytes: int, scope: DeviceScope, *, overlap: int = 0) -> tuple[int, int, int]:
    """(offset, length with halo, chunk) of the global corpus that this rank
    of ``scope`` loads: its chunk (``sharding.shard_bytes``' rule) and the
    ``overlap`` bytes after it, cut at the corpus' end."""
    chunk = aligned_chunk(total_bytes, scope.gpus)
    offset = scope.rank * chunk
    length = max(min(chunk + overlap, total_bytes - offset), 0)
    return offset, length, chunk


def shard_bytes_local(scope: DeviceScope, local_data, global_n: int, *,
                      overlap: int = 0) -> tuple[torch.Tensor, int, int]:
    """(row uint8[chunk + overlap] on the scope's device, global_n, chunk):
    the rank's halo row built from the bytes of its ``host_byte_range``,
    zero past the corpus' end; drop-in for ``sharding.shard_bytes``."""
    chunk = aligned_chunk(global_n, scope.gpus)
    local = torch.from_numpy(np.ascontiguousarray(local_data, np.uint8))
    row = torch.zeros(chunk + overlap, dtype=torch.uint8, device=scope.device)
    take = min(local.numel(), row.numel())
    row[:take] = local[:take].to(scope.device)
    return row, global_n, chunk
