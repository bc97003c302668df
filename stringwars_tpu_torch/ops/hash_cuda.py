"""Wrappers of the hand-written CUDA kernels in ``csrc/hash.cu``.

The counterpart of ``stringwars_tpu.ops.hash_pallas`` and of the XLA hashes
of ``stringwars_tpu.ops.hash``. Each wrapper checks its tensors, allocates
the digests, launches on PyTorch's current stream without synchronizing,
raises on a CUDA launch error, and adds one to its entry of ``LAUNCHES``
(once per call; a call with more than 8 seeds launches once per group of 8).
A CPU tensor raises: the plain versions live in ``ops/hash.py``. The
``*_spans_cuda`` wrappers take a tape's ``data`` and ``offsets`` (the spans
form of the same kernels, counted apart: ``xxh64_spans``, ``swh64_spans``,
``xxh32_spans``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.tape import PaddedTokens

# Launches of each kernel entry point since process start (or the last reset).
LAUNCHES = {"xxh64": 0, "xxh64_tree": 0, "swh64": 0, "xxh32": 0, "xxh64_spans": 0, "swh64_spans": 0, "xxh32_spans": 0}

# Bytes of each chunk that one stage of the tree level's shared-memory ring
# holds (csrc/hash.cu kTreeSlice): the checks cross its edges.
TREE_SLICE = 6144


def _check_tokens(tokens: PaddedTokens, what: str) -> None:
    build.require_cuda_bytes(tokens.data, what)
    lengths = tokens.lengths
    if tokens.data.dim() != 2 or tokens.data.shape[1] != tokens.width:
        raise ValueError(f"{what}: expected a [count, {tokens.width}] matrix, got {tuple(tokens.data.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (tokens.count,) or not lengths.is_contiguous():
        raise ValueError(f"{what}: lengths must be a contiguous int32[{tokens.count}] tensor")
    if lengths.device != tokens.data.device:
        raise ValueError(f"{what}: lengths on {lengths.device}, data on {tokens.data.device}")


def _seed_array(seeds: Sequence[int]):
    if not seeds:
        raise ValueError("at least one seed")
    return (ctypes.c_uint64 * len(seeds))(*(int(s) & ((1 << 64) - 1) for s in seeds))


def xxh64(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint64[k, B] on the device: XXH64 of every row under each seed."""
    _check_tokens(tokens, "xxh64")
    out = torch.empty((len(seeds), tokens.count), dtype=torch.uint64, device=tokens.data.device)
    if tokens.count == 0:
        return out
    lib = build.library()
    with torch.cuda.device(tokens.data.device):
        code = lib.sw_xxh64(
            tokens.data.data_ptr(), tokens.count, tokens.width, tokens.lengths.data_ptr(),
            _seed_array(seeds), len(seeds), out.data_ptr(), build.stream_of(tokens.data),
        )
    build.check(code, "xxh64")
    LAUNCHES["xxh64"] += 1
    return out


def tree_level(data: torch.Tensor, n: int) -> torch.Tensor:
    """uint64[chunks] on the device: XXH64 (seed 0) of each 64 KiB chunk of
    ``data[:n]``, read in place (the last chunk short, never read past n)."""
    from stringwars_tpu_torch.ops.hash import TREE_CHUNK

    build.require_cuda_bytes(data, "tree_level")
    if data.dim() != 1 or not 0 <= n <= data.numel():
        raise ValueError(f"tree_level: n={n} outside a 1-D buffer of {data.numel()} bytes")
    chunks = max(1, -(-n // TREE_CHUNK))
    out = torch.empty(chunks, dtype=torch.uint64, device=data.device)
    lib = build.library()
    with torch.cuda.device(data.device):
        code = lib.sw_xxh64_tree(data.data_ptr(), chunks, TREE_CHUNK, n, out.data_ptr(), build.stream_of(data))
    build.check(code, "xxh64_tree")
    LAUNCHES["xxh64_tree"] += 1
    return out


def _xxh32_family(tokens: PaddedTokens, seeds: Sequence[int], swh: bool) -> torch.Tensor:
    name = "swh64" if swh else "xxh32"
    _check_tokens(tokens, name)
    dtype = torch.uint64 if swh else torch.uint32
    out = torch.empty((len(seeds), tokens.count), dtype=dtype, device=tokens.data.device)
    if tokens.count == 0:
        return out
    lib = build.library()
    with torch.cuda.device(tokens.data.device):
        code = lib.sw_xxh32(
            tokens.data.data_ptr(), tokens.count, tokens.width, tokens.lengths.data_ptr(),
            _seed_array(seeds), len(seeds), int(swh), out.data_ptr(), build.stream_of(tokens.data),
        )
    build.check(code, name)
    LAUNCHES[name] += 1
    return out


def xxh32(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint32[k, B] on the device: XXH32 of every row under each seed's low
    32 bits."""
    return _xxh32_family(tokens, seeds, swh=False)


def swh64(tokens: PaddedTokens, seeds: Sequence[int]) -> torch.Tensor:
    """uint64[k, B] on the device: swh64 of every row under each seed."""
    return _xxh32_family(tokens, seeds, swh=True)


def _spans(data: torch.Tensor, offsets: torch.Tensor, seeds: Sequence[int], name: str) -> torch.Tensor:
    """[k, T] digests of a tape's spans by the spans form; one launch a group
    of 8 seeds. Contract (the tape's): ``offsets`` nondecreasing, within
    ``[0, data.numel()]``; the kernel reads no byte outside ``data``."""
    build.require_spans(data, offsets, name)
    count = offsets.numel() - 1
    dtype = torch.uint32 if name == "xxh32_spans" else torch.uint64
    out = torch.empty((len(seeds), count), dtype=dtype, device=data.device)
    if count == 0:
        return out
    lib = build.library()
    with torch.cuda.device(data.device):
        if name == "xxh64_spans":
            code = lib.sw_xxh64_spans(data.data_ptr(), data.numel(), offsets.data_ptr(), count, _seed_array(seeds), len(seeds),
                                      out.data_ptr(), build.stream_of(data))
        else:
            code = lib.sw_xxh32_spans(data.data_ptr(), data.numel(), offsets.data_ptr(), count, _seed_array(seeds), len(seeds),
                                      int(name == "swh64_spans"), out.data_ptr(), build.stream_of(data))
    build.check(code, name)
    LAUNCHES[name] += 1
    return out


def xxh64_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``hash.xxh64_spans_plain`` by the spans form, on the device."""
    return _spans(data, offsets, [seed], "xxh64_spans")[0]


def xxh64_multiseed_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """``hash.xxh64_multiseed_spans_plain`` by the spans form, on the device:
    one pass over the bytes for up to 8 seeds."""
    return _spans(data, offsets, [int(s) for s in np.asarray(seeds, dtype=np.uint64).reshape(-1)], "xxh64_spans")


def xxh32_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``hash.xxh32_spans_plain`` by the spans form, on the device."""
    return _spans(data, offsets, [seed], "xxh32_spans")[0]


def swh64_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``hash.swh64_spans_plain`` by the spans form, on the device."""
    return _spans(data, offsets, [seed], "swh64_spans")[0]


def swh64_multiseed_spans_cuda(data: torch.Tensor, offsets: torch.Tensor, seeds) -> torch.Tensor:
    """``hash.swh64_multiseed_spans_plain`` by the spans form, on the device:
    one pass over the bytes for up to 8 seeds."""
    return _spans(data, offsets, [int(s) for s in np.asarray(seeds, dtype=np.uint64).reshape(-1)], "swh64_spans")
