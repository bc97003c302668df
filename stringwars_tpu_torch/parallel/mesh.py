"""Device scopes: where a variant runs, and its name suffix.

The port of ``stringwars_tpu.parallel.mesh``. A scope is one device of this
process, or the ranks of a ``torch.distributed`` process group: one process
a device, each rank running the kernels on its own shard and joining the
others through collectives (NCCL between cards, gloo on the CPU), the
counterpart of JAX's single-controller ``shard_map`` over a mesh.

Names follow the JAX package's rule with ``gpu`` for ``chip``: ``<1gpu>``
and ``<Ngpu>`` on cards, ``<Nhost>`` when the ranks span N hosts, and
``<1cpu>``/``<Ncpu>`` when the caller asks for the CPU (``--device cpu``).
The device is the card unless the caller names the CPU: a host without a
card stops with an error instead of running the device rows on the CPU.
``parallel.distributed`` makes the process group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from stringwars_tpu_torch.utils.config import DEVICE_CHOICES, get_env_parsed


@dataclasses.dataclass(frozen=True)
class DeviceScope:
    """A compute scope of ``gpus`` devices on ``hosts`` hosts, addressed from
    this process through ``device``. ``group`` is the process group of the
    scope's ranks (this process is rank ``rank`` in it), or ``None`` for this
    process's device alone."""

    device: torch.device
    gpus: int = 1
    hosts: int = 1
    rank: int = 0
    group: object | None = None

    @property
    def name(self) -> str:
        """Variant-name suffix: ``<1gpu>``/``<4gpu>``/``<2host>``, ``<Ncpu>`` on the host."""
        if self.hosts > 1:
            return f"<{self.hosts}host>"
        return f"<{self.gpus}{'gpu' if self.device.type == 'cuda' else 'cpu'}>"

    def auto_batch_size(self, default_base: int = 128, base: int | None = None) -> int:
        """Batch scaled by the device count: one device is one "core"
        (reference ``utils.rs:801-843``; ``SWTPU_BATCH_PER_CORE`` overrides)."""
        per_core = base if base is not None else get_env_parsed("BATCH_PER_CORE", default_base)
        return max(1, per_core) * max(1, self.gpus)


def resolve_device(name: str = "cuda") -> torch.device:
    """The device a suite runs on: ``"cuda"`` (the default) is the current
    CUDA device (a rank's own, once ``distributed`` has set it) and raises
    when there is none; ``"cpu"`` is the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}; choose from {DEVICE_CHOICES}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false. The device rows run on "
            "the card; pass --device cpu to run their plain torch versions on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


def process_rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_scope(device: torch.device) -> DeviceScope:
    """The scope of every rank of the initialized world, seen from this one."""
    from stringwars_tpu_torch.parallel.distributed import ranks_per_host

    world = dist.get_world_size()
    return DeviceScope(torch.device(device), gpus=world, hosts=max(world // ranks_per_host(), 1), rank=dist.get_rank(),
                       group=dist.group.WORLD)


def scope_variants(device: torch.device) -> list[DeviceScope]:
    """Scopes to sweep per variant: this process's device, and the world's
    ranks when the world has more than one (the analog of the reference's
    1cpu/Ncpu/1gpu sweep)."""
    scopes = [DeviceScope(torch.device(device))]
    if dist.is_initialized() and dist.get_world_size() > 1:
        scopes.append(world_scope(device))
    return scopes
