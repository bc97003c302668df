"""Build the port's CUDA kernels at first use and bind them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, in ``stringwars_tpu_torch/_build/``
(listed in ``.gitignore``). The library's file name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
loaded as it is. No PyTorch header is compiled: the build takes seconds.

Each C entry point takes device pointers and the stream as ``c_void_p`` and
sizes as ``c_int64``, launches without synchronizing, and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.
A missing toolkit or a failed build raises: nothing falls back to the plain
torch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _N = ctypes.c_void_p, ctypes.c_int64
# C entry point -> argument types; every one returns a cudaError_t as int.
SIGNATURES = {
    "sw_bytesum": (_P, _N, _P, _P),
    "sw_find_count": (_P, _N, _P, _N, _P, _N, _P, _P, _P),
    "sw_byteset_count": (_P, _N, _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=os.path.join(cuda_home, "bin"))
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
            "stringwars_tpu_torch are built from its csrc/ sources at first use and "
            "need the CUDA toolkit"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libswtorch_{digest.hexdigest()[:16]}.so"


def build(path: Path) -> float:
    """Compile every ``csrc/*.cu`` into ``path``; returns the seconds taken.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``<name>.log``.
    """
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    started = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - started
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees the old state or the whole library
    return seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this checkout."""
    path = library_path()
    if not path.exists():
        seconds = build(path)
        print(f"# built {path.name} in {seconds:.1f} s", file=sys.stderr, flush=True)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as error:
        raise KernelBuildError(f"cannot load {path}: {error}") from error
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise KernelLaunchError(f"{kernel}: CUDA error {code} at launch")


def stream_of(tensor: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda_bytes(tensor: torch.Tensor, what: str, *, aligned: bool = False) -> None:
    """The checks every kernel wrapper makes on a byte-tensor argument."""
    if not isinstance(tensor, torch.Tensor) or tensor.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {getattr(tensor, 'device', type(tensor))}")
    if tensor.dtype != torch.uint8:
        raise ValueError(f"{what}: expected uint8, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if aligned and tensor.data_ptr() % 16:
        raise ValueError(f"{what}: expected a 16-byte aligned tensor")
