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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _N = ctypes.c_void_p, ctypes.c_int64
# C entry point -> argument types; every one returns a cudaError_t as int.
SIGNATURES = {
    "sw_bytesum": (_P, _N, _P, _P),
    "sw_find_count": (_P, _N, _P, _N, _N, _P, _N, _N, _N, _P, _P, _P),
    "sw_byteset_count": (_P, _N, _P, _P, _P),
    "sw_xxh64": (_P, _N, _N, _P, _P, _N, _P, _P),
    "sw_xxh64_tree": (_P, _N, _N, _N, _P, _P),
    "sw_xxh32": (_P, _N, _N, _P, _P, _N, ctypes.c_int, _P, _P),
    "sw_fingerprint": (_P, _N, _N, _P, _P, _P, _P, _N, _P, _P, _P),
    "sw_lut_translate": (_P, _N, _P, _P, _P),
    "sw_myers": (_P, _N, _P, _N, _P, _P, _N, _N, _N, _N, _N, _P, _P, _P),
    "sw_align": (_P, _P, _N, _P, _P, _N, _N, _N, _N, _N, _N, _N, _N, _N, _P, _P, _P),
    "sw_ac_count": (_P, _N, _P, _N, _P, _N, _N, _N, _P, _P),
    "sw_shiftand": (_P, _N, _P, _N, _N, _N, _P, _P),
    "sw_class_map": (_P, _N, _P, _N, _N, _P, _P),
    "sw_range_map": (_P, _N, _P, _N, _N, _P, _P),
    "sw_expand": (_P, _N, _N, _N, _P, _P, _P, _P, _N, _N, _P, _P, _P),
    "sw_cp_window": (_P, _N, _P, _N, _P, _P),
    "sw_fused_scan": (_P, _P, _N, _N, _N, _N, _N, _N, _N, _N, _P, _P, _N, _N, _P),
    "sw_lb_rules": (_P, _N, _P, _P),
    "sw_bpe": (_P, _N, _N, _P, _P, _N, _N, _N, _N, _P, _P, _P),
    "sw_threefry_bits": (_N, _N, _N, _P, _P),
    "sw_chacha20_xor": (_P, _P, _N, _P, _P, _N, _P),
    "sw_poly1305": (_P, _N, _P, _N, _N, _P, _N, _N, _N, _P, _P, _P),
    "sw_sha256": (_P, _N, _N, _P, _P, _P),
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

    One ``nvcc -c`` per source, all started together, then one link. The
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    started = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs = [(obj, proc.communicate()[0], proc.returncode) for obj, proc in jobs]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    failed = [(obj, log, rc) for obj, log, rc in outputs if rc != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _, _ in outputs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        outputs.append((tmp, link.stdout, link.returncode))
        failed = [(tmp, link.stdout, link.returncode)] if link.returncode else []
    seconds = time.perf_counter() - started
    path.with_suffix(".log").write_text("".join(log for _, log, _ in outputs))
    for obj, _, _ in outputs[: len(jobs)]:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        obj, log, rc = failed[0]
        raise KernelBuildError(f"nvcc failed ({rc}) on {obj.name}:\n{log[-4000:]}")
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


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once (the launches that size
    their grids by it are host-bound at the suites' batches)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(tensor: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda_bytes(tensor: torch.Tensor, what: str) -> None:
    """The checks every kernel wrapper makes on a byte-tensor argument."""
    if not isinstance(tensor, torch.Tensor) or tensor.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {getattr(tensor, 'device', type(tensor))}")
    if tensor.dtype != torch.uint8:
        raise ValueError(f"{what}: expected uint8, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def aligned_bytes(tensor: torch.Tensor, n: int) -> torch.Tensor:
    """``tensor`` itself when its first byte is 16-byte aligned (or ``n`` is
    0); otherwise a copy of ``tensor[:n]`` into a fresh buffer, which the
    allocator aligns. The haystack scans (find, Shift-And, Aho-Corasick)
    read their input as 16-byte vectors from its first byte: a view at any
    other offset costs one copy of its ``n`` bytes, and an aligned one
    nothing."""
    if n == 0 or tensor.data_ptr() % 16 == 0:
        return tensor
    return tensor[:n].clone()
