"""Device scopes: where a variant runs, and its name suffix.

The port of ``stringwars_tpu.parallel.mesh`` for one device: a scope is one
CUDA device (``<1gpu>``, the reference's own GPU scope suffix) or, on a
machine without a card, the CPU (``<1cpu>``). Multi-GPU scopes over
``torch.distributed`` come with the parallel slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceScope:
    """A compute scope of ``gpus`` devices, addressed through ``device``."""

    device: torch.device
    gpus: int = 1

    @property
    def name(self) -> str:
        """Variant-name suffix: ``<1gpu>`` on a card, ``<1cpu>`` on the host."""
        return f"<{self.gpus}gpu>" if self.device.type == "cuda" else "<1cpu>"


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")


def scope_variants(device: torch.device) -> list[DeviceScope]:
    """Scopes to sweep per variant: the one device."""
    return [DeviceScope(torch.device(device))]
