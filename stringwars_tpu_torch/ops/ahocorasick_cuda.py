"""Wrapper of the hand-written CUDA kernel in ``csrc/ahocorasick.cu``.

The counterpart of ``stringwars_tpu.ops.ahocorasick._ac_scan_pallas`` and
``_ac_scan_pallas_lut``: one DFA scan for both. The wrapper takes the table
regime from the automaton's class layout under the card's shared-memory
limit (``Automaton.layout``), checks its tensors, allocates the output,
launches on PyTorch's current stream without synchronizing, raises on a
CUDA launch error, and adds one to ``LAUNCHES``. A CPU tensor raises: the
plain versions are ``ops/ahocorasick.ac_count_plain`` and, through the
kernel's own tables, ``ac_count_classes_plain``.
"""

from __future__ import annotations

import functools

import torch

from stringwars_tpu_torch import build
from stringwars_tpu_torch.ops.ahocorasick import SHARED_BYTES, Automaton
from stringwars_tpu_torch.ops.find import _extent

# Launches of the kernel since process start (or the last reset).
LAUNCHES = {"ac_dfa": 0}

CHUNK_ALIGN = 32  # a chunk is walked in 32-byte batches
MIN_CHUNK = 256  # bytes per thread chunk, at least; and at least four overlaps
MAX_CHUNK = 1 << 24
BIG_TABLE = 48 << 10  # a block staging more shared memory than this runs BIG_THREADS threads
BIG_THREADS = 1024  # one block an SM still holds 32 warps of chains
THREADS = 256


@functools.cache
def shared_bytes(device: torch.device) -> int:
    """Dynamic shared memory a block may take on ``device`` (the opt-in limit)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def block_threads(layout) -> int:
    """Threads a block of the class kernel, by the rows it stages."""
    return BIG_THREADS if layout.hot * layout.pitch > BIG_TABLE else THREADS


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


def form_of(automaton: Automaton, shared: int = SHARED_BYTES) -> str:
    """The kernel's form for this automaton: its regime and, for the class
    kernel, the entry width and how it finds a class (``/range``: by
    arithmetic; ``/raw``: the map holds classes, not row offsets), e.g.
    ``shared/16-bit/range``."""
    layout = automaton.layout(shared)
    if layout.table is None:
        return layout.regime
    form = f"{layout.regime}/{8 * layout.entry_bytes}-bit"
    return form + ("/range" if layout.range_lo >= 0 else "" if layout.scaled else "/raw")


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
    out = torch.zeros(1, dtype=torch.int64, device=hay.device)
    if n == 0:
        return out
    shared = shared_bytes(hay.device)
    layout = automaton.layout(shared)
    lib = build.library()
    with torch.cuda.device(hay.device):
        if layout.table is None:
            if automaton.states >= 1 << 23:
                raise ValueError(f"ac_count: {automaton.states} states exceed the kernel's 2^23")
            tables = automaton.tables(hay.device)
            code = lib.sw_ac_count(
                hay.data_ptr(), n, tables.packed.data_ptr(), automaton.states,
                tables.out_count32.data_ptr() if layout.regime == "wide" else None,
                chunk, automaton.max_len - 1, out.data_ptr(), build.stream_of(hay),
            )
        else:
            rows, class_map = automaton.class_tables(hay.device, shared)
            code = lib.sw_ac_classes(
                hay.data_ptr(), n, rows.data_ptr(), class_map.data_ptr(), automaton.states, layout.classes,
                layout.entry_bytes, layout.hot, block_threads(layout), layout.range_lo, chunk, automaton.max_len - 1,
                out.data_ptr(), build.stream_of(hay),
            )
    build.check(code, "ac_dfa")
    LAUNCHES["ac_dfa"] += 1
    return out
