"""Device scopes: where a variant runs, and its name suffix.

The port of ``stringwars_tpu.parallel.mesh`` for one device: a scope is one
CUDA device (``<1gpu>``, the reference's own GPU scope suffix) or, when the
caller asks for it with ``--device cpu``, the CPU (``<1cpu>``). The device is
the card unless the caller names the CPU: a host without a card stops with
an error instead of running the device rows on the CPU. Multi-GPU scopes
over ``torch.distributed`` come with the parallel slice.
"""

from __future__ import annotations

import dataclasses

import torch

from stringwars_tpu_torch.utils.config import DEVICE_CHOICES, get_env_parsed


@dataclasses.dataclass(frozen=True)
class DeviceScope:
    """A compute scope of ``gpus`` devices, addressed through ``device``."""

    device: torch.device
    gpus: int = 1

    @property
    def name(self) -> str:
        """Variant-name suffix: ``<1gpu>`` on a card, ``<1cpu>`` on the host."""
        return f"<{self.gpus}gpu>" if self.device.type == "cuda" else "<1cpu>"

    def auto_batch_size(self, default_base: int = 128, base: int | None = None) -> int:
        """Batch scaled by the device count: one device is one "core"
        (reference ``utils.rs:801-843``; ``SWTPU_BATCH_PER_CORE`` overrides)."""
        per_core = base if base is not None else get_env_parsed("BATCH_PER_CORE", default_base)
        return max(1, per_core) * max(1, self.gpus)


def resolve_device(name: str = "cuda") -> torch.device:
    """The device a suite runs on: ``"cuda"`` (the default) is the current
    CUDA device and raises when there is none; ``"cpu"`` is the CPU."""
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


def scope_variants(device: torch.device) -> list[DeviceScope]:
    """Scopes to sweep per variant: the one device."""
    return [DeviceScope(torch.device(device))]
