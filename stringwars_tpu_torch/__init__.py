"""stringwars-tpu on PyTorch and CUDA: the port of ``stringwars_tpu`` to an NVIDIA H100.

The JAX package ``stringwars_tpu`` stays beside this one as the reference;
this package imports ``torch``, numpy and the standard library, never JAX.
Layout mirrors the JAX package module for module:

  - ``tape``       — the (flat bytes, offsets) token container, on a torch device
  - ``datasets``   — corpus loading and the seeded synthetic corpora
  - ``ops``        — plain torch versions and their hand-written CUDA kernels
  - ``csrc``       — the CUDA C++ sources, built at first use (``build.py``)
  - ``parallel``   — device scopes, sharding and the sharded pipeline on ``torch.distributed``
  - ``utils``      — config, harness, reporting, profiler
  - ``suites``     — runnable benchmark suites (``python -m stringwars_tpu_torch.suites.find``)

Importing the package has no backend side effects.
"""

__version__ = "0.1.0"

from stringwars_tpu_torch.tape import Tape  # noqa: E402,F401

__all__ = ["Tape", "__version__"]
