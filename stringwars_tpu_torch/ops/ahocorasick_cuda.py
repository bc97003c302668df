"""Wrapper of the hand-written CUDA kernel in ``csrc/ahocorasick.cu``.

The counterpart of ``stringwars_tpu.ops.ahocorasick._ac_scan_pallas`` and
``_ac_scan_pallas_lut``: one dense-DFA scan for both. The wrapper picks the
table regime from the automaton's size, checks its tensors, allocates the
output, launches on PyTorch's current stream without synchronizing, raises
on a CUDA launch error, and adds one to ``LAUNCHES``. A CPU tensor raises:
the plain version is ``ops/ahocorasick.ac_count_plain``.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.ahocorasick import Automaton
from stringwars_tpu_torch.ops.find import _extent

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"ac_dfa": 0}

SHARED_STATES = 96  # tables of up to 96 states (96 KiB of entries) go to shared memory
CHUNK_ALIGN = 32  # a chunk is walked in 32-byte batches
MIN_CHUNK = 256  # bytes per thread chunk, at least; and at least four overlaps
MAX_CHUNK = 1 << 24


def regime_of(automaton: Automaton) -> str:
    """The table regime the kernel takes for this automaton: ``shared``
    (the table in shared memory), ``global`` (read through L1/L2) or
    ``wide`` (some output count above 255, read from its own table)."""
    if automaton.max_out > 255:
        return "wide"
    return "shared" if automaton.states <= SHARED_STATES else "global"


def kernel_chunk(max_len: int) -> int:
    """Bytes per thread chunk: at least 256 and four overlaps, a multiple of 32."""
    return -(-max(MIN_CHUNK, 4 * (max_len - 1)) // CHUNK_ALIGN) * CHUNK_ALIGN


def check_chunk(chunk: int, what: str) -> int:
    """A caller's chunk: a multiple of 32 in [32, 2^24]. It may be shorter
    than the overlap: each thread re-derives its entry state on its own."""
    chunk = int(chunk)
    if not (CHUNK_ALIGN <= chunk <= MAX_CHUNK and chunk % CHUNK_ALIGN == 0):
        raise ValueError(f"{what}: chunk must be a multiple of {CHUNK_ALIGN} in [{CHUNK_ALIGN}, {MAX_CHUNK}], got {chunk}")
    return chunk


def ac_count(automaton: Automaton, hay: torch.Tensor, n: int | None = None, *, chunk: int | None = None) -> torch.Tensor:
    """int64[1] on the device: occurrences of all patterns in ``hay[:n]``.
    ``chunk`` (see ``check_chunk``) defaults to ``kernel_chunk``; a caller
    may name a short one to hold many chunk seams against the plain version.
    A haystack that does not start 16-byte aligned is copied once
    (``build.aligned_bytes``): the DFA's state runs from its first byte."""
    build.require_cuda_bytes(hay, "ac_count")
    n = _extent(hay, n)
    hay = build.aligned_bytes(hay, n)
    chunk = kernel_chunk(automaton.max_len) if chunk is None else check_chunk(chunk, "ac_count")
    regime = regime_of(automaton)
    if automaton.states >= 1 << 23:
        raise ValueError(f"ac_count: {automaton.states} states exceed the kernel's 2^23")
    out = torch.zeros(1, dtype=torch.int64, device=hay.device)
    if n == 0:
        return out
    tables = automaton.tables(hay.device)
    lib = build.library()
    with torch.cuda.device(hay.device):
        code = lib.sw_ac_count(
            hay.data_ptr(), n, tables.packed.data_ptr(), automaton.states,
            tables.out_count32.data_ptr() if regime == "wide" else None, int(regime == "shared"),
            chunk, automaton.max_len - 1, out.data_ptr(), build.stream_of(hay),
        )
    build.check(code, "ac_dfa")
    LAUNCHES["ac_dfa"] += 1
    return out
