"""Aho-Corasick multi-pattern counting (kernel family K2).

The port of ``stringwars_tpu.ops.ahocorasick``. The reference benchmarks
Aho-Corasick DFAs for byteset and multi-pattern scans
(``find/bench.rs:226-348``, pyahocorasick ``find/bench.py:118-123``).

The DFA is built on the host: ``build_dfa`` makes the trie in insertion
order and compresses it with BFS fail links into a dense transition table
with fail-accumulated output counts, state for state and entry for entry
what the JAX package's native ``ac_build`` makes (the port keeps this numpy
copy instead of loading that C++ file). ``Automaton.count_host`` is the
sequential oracle.

The scan counts every occurrence of every pattern in ``hay[:n]``,
overlapping and nested ones included: each position adds the output count
of the state the DFA enters there. It is chunk-parallel and exact: the
state after any prefix depends only on its last ``max_len - 1`` bytes, so
each chunk re-derives its entry state from that many bytes before it and
then counts the matches that end inside it.

The kernel reads the DFA by byte classes (``class_layout``): one class per
distinct column of ``delta`` (every byte that starts no pattern step shares
one), states renumbered breadth-first from the root, and each entry the
next state with its output count above it in 16 bits where both fit, else
32. ``ac_count_classes_plain`` walks those tables as the kernel does.

``ac_count`` takes the hand-written CUDA kernel of ``ops/ahocorasick_cuda.py``
for a CUDA tensor and the plain torch column scan below for a CPU tensor.
Counts are summed in 64 bits and returned as Python ints (the JAX functions
return int32).

Not ported: the TPU's rule-walk and lane-LUT compilations of the table
(``automaton_rules``, ``automaton_luts``), its column staging
(``stage_cols``) and the one-hot matmul scan (``_ac_scan_mxu``): each works
around the TPU's slow gathers, and a GPU reads the table directly.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from stringwars_tpu_torch.ops.find import _extent

PLAIN_CHUNK = 256  # bytes per row of the plain column scan


def build_dfa(patterns: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """The dense AC DFA of ``patterns``: (delta int32[S, 256], out_count int32[S]).

    State 0 is the root; the others are numbered in trie insertion order.
    ``delta[s, c]`` is the state after byte ``c`` in state ``s`` and
    ``out_count[s]`` the number of patterns that end on entering ``s``
    (duplicates counted), the patterns ending at its fail chain included.
    """
    rows = [np.full(256, -1, np.int32)]
    out = [0]
    for p in patterns:
        state = 0
        for c in p:
            if rows[state][c] < 0:
                rows[state][c] = len(rows)
                rows.append(np.full(256, -1, np.int32))
                out.append(0)
            state = int(rows[state][c])
        out[state] += 1
    delta = np.stack(rows)
    out_count = np.asarray(out, np.int32)
    fail = np.zeros(len(rows), np.int32)
    # BFS: a state's fail state is shallower, so its row is complete (and its
    # output accumulated) before the state is reached.
    root = delta[0]
    queue = deque(root[root >= 0].tolist())
    root[root < 0] = 0
    while queue:
        u = queue.popleft()
        f = fail[u]
        out_count[u] += out_count[f]
        row, fail_row = delta[u], delta[f]
        children = np.flatnonzero(row >= 0)
        fail[row[children]] = fail_row[children]
        queue.extend(row[children].tolist())
        missing = row < 0
        row[missing] = fail_row[missing]
    return delta, out_count


@dataclasses.dataclass(frozen=True)
class DfaTables:
    """An automaton's tables on one device.

    ``delta_flat`` and ``out_count`` (int64) feed the plain scan. ``packed``
    (int32[S * 256]) feeds the CUDA kernel: entry ``s * 256 + c`` holds
    ``delta[s, c] << 8 | min(out_count[delta[s, c]], 255)``, the next state's
    row offset and its output count in one word.
    """

    delta_flat: torch.Tensor
    out_count: torch.Tensor
    packed: torch.Tensor
    out_count32: torch.Tensor


SHARED_BYTES = 232_448  # dynamic shared memory a block may take on an H100 (the opt-in limit)
MAP_BYTES = 256  # the class map, one byte a byte value, ahead of the rows in shared memory
MAX_COUNT32 = 1 << 27  # a 32-bit entry's count stays below this: 32 of them sum in 32 bits


def byte_classes(delta: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(class_of int32[256], first int32[C]): one class per distinct column
    of ``delta``, numbered by the first byte whose column it is; ``first[c]``
    is that byte. Exact for any pattern set: bytes of one class step every
    state to the same state."""
    _, first, inverse = np.unique(np.ascontiguousarray(delta.T), axis=0, return_index=True, return_inverse=True)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first)] = np.arange(first.size)
    return rank[inverse.reshape(-1)].astype(np.int32), np.sort(first).astype(np.int32)


def bfs_order(delta: np.ndarray) -> np.ndarray:
    """int32[S]: the states by depth from the root (breadth-first over the
    DFA's transitions), ties by state number; ``order[i]`` is the state the
    kernel numbers ``i``. The root stays 0, and the states a scan visits most
    come first."""
    depth = np.full(delta.shape[0], -1, np.int64)
    depth[0] = 0
    frontier, level = np.zeros(1, np.int64), 0
    while frontier.size:
        level += 1
        reached = np.unique(delta[frontier])
        frontier = reached[depth[reached] < 0]
        depth[frontier] = level
    return np.argsort(depth, kind="stable").astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ClassLayout:
    """The CUDA kernel's view of an automaton under a shared-memory budget.

    ``regime``: ``shared`` (the whole class table and the class map in a
    block's shared memory), ``split`` (the first ``hot`` rows there, the rest
    read from device memory), ``global`` (the classes do not shrink a table
    that does not fit: the 256-column ``DfaTables.packed`` read through
    L1/L2) or ``wide`` (as global, some output count above what an entry
    holds: the counts from their own table). For shared and split,
    ``table[i * classes + c]`` is the entry of state ``bfs_order(delta)[i]``
    under class ``c``: the next state's number, breadth-first, in the low
    ``state_bits`` bits and its output count above them, in ``entry_bytes``
    (2 or 4) bytes.
    ``range_lo``: in the shared regime, where the classes are one byte range
    and the rest (as the 1,000-word dictionary's letters and every other
    byte), its first byte, and the classes are numbered ``min(byte -
    range_lo, classes - 1)`` in unsigned arithmetic, which the kernel
    computes instead of reading the map; else -1 (classes numbered by their
    first byte).
    """

    regime: str
    classes: int
    class_of: np.ndarray
    state_bits: int
    entry_bytes: int
    hot: int
    table: np.ndarray | None
    range_lo: int = -1

    @property
    def pitch(self) -> int:
        """Bytes of one row of the class table."""
        return self.classes * self.entry_bytes

    @property
    def scaled(self) -> bool:
        """The kernel's class map holds ``class * entry_bytes`` (a row
        offset in bytes) where that fits a byte, else the class."""
        return self.pitch <= MAP_BYTES


def class_layout(delta: np.ndarray, out_count: np.ndarray, shared_bytes: int = SHARED_BYTES,
                 entry_bytes: int | None = None) -> ClassLayout:
    """The kernel's tables of the DFA ``(delta, out_count)`` for a block
    that may take ``shared_bytes`` of shared memory. 16-bit entries where
    the state number and the largest output count fit them together, else
    32-bit (``entry_bytes`` forces a width that fits, for tests)."""
    states, top = delta.shape[0], int(out_count.max())
    class_of, first = byte_classes(delta)
    bits = max(1, (states - 1).bit_length())
    fits = {2: bits < 16 and top < 1 << (16 - bits), 4: top < min(1 << (32 - bits), MAX_COUNT32)}
    if entry_bytes is None:
        entry_bytes = 2 if fits[2] else 4 if fits[4] else 0
    elif not fits.get(entry_bytes, False):
        raise ValueError(f"{states} states with counts up to {top} do not fit {entry_bytes}-byte entries")
    classes = first.size
    if entry_bytes == 0:
        return ClassLayout("wide", classes, class_of, bits, 0, 0, None)
    room = (shared_bytes - MAP_BYTES) // 16 * 16
    pitch = classes * entry_bytes
    if states * pitch <= room:
        regime, hot = "shared", states
    elif classes < 256:
        regime, hot = "split", room // pitch
    else:
        return ClassLayout("global" if top <= 255 else "wide", classes, class_of, bits, 0, 0, None)
    order = bfs_order(delta)
    renumber = np.empty(states, np.int64)
    renumber[order] = np.arange(states)
    span = np.zeros(256, np.int64)
    if classes > 1:
        span[first[1] : first[1] + classes - 1] = np.arange(1, classes)
    range_lo = int(first[1]) if regime == "shared" and classes > 1 and np.array_equal(class_of, span) else -1
    if range_lo >= 0:  # the range's bytes first, then the rest: class = min(byte - range_lo, classes - 1)
        class_of, first = (class_of - 1) % classes, np.roll(first, -1)
    nxt = delta[order][:, first].astype(np.int64)  # [S, C], old numbers
    entries = renumber[nxt] | (out_count[nxt].astype(np.int64) << bits)
    table = entries.reshape(-1).astype(np.uint16 if entry_bytes == 2 else np.uint32)
    return ClassLayout(regime, classes, class_of, bits, entry_bytes, hot, table, range_lo)


def class_tensors(layout: ClassLayout, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, class_map) of ``layout`` on ``device`` as the kernel reads
    them: the entries' bytes padded to 16, and the 256-byte class map (row
    offsets where ``scaled``)."""
    raw = layout.table.view(np.uint8)
    rows = np.zeros(-(-raw.size // 16) * 16, np.uint8)
    rows[: raw.size] = raw
    class_map = layout.class_of * (layout.entry_bytes if layout.scaled else 1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(class_map.astype(np.uint8)).to(device)


def _device_key(device) -> torch.device:
    """``device`` as a tensor on it names it (a CUDA device with its index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Automaton:
    """A built AC automaton (dense DFA) ready for scans."""

    def __init__(self, patterns: list[bytes]):
        if not patterns:
            raise ValueError("need at least one pattern")
        if any(len(p) == 0 for p in patterns):
            raise ValueError("empty patterns not allowed")
        delta, out_count = build_dfa(patterns)
        self._set(patterns, delta, out_count)

    @classmethod
    def from_numpy(cls, delta: np.ndarray, out_count: np.ndarray, patterns: list[bytes]) -> "Automaton":
        """Take tables built by the JAX package (``delta_flat`` or a [S, 256]
        ``delta``, and ``out_count``, as numpy arrays)."""
        out_count = np.asarray(out_count, np.int32).reshape(-1)
        states = out_count.shape[0]
        delta = np.asarray(delta, np.int32).reshape(-1)
        if delta.shape[0] != states * 256:
            raise ValueError(f"delta has {delta.shape[0]} entries, expected {states} states x 256")
        if states == 0 or delta.min() < 0 or delta.max() >= states:
            raise ValueError("delta must map into the automaton's states")
        self = cls.__new__(cls)
        self._set(list(patterns), delta.reshape(states, 256).copy(), out_count.copy())
        return self

    def _set(self, patterns: list[bytes], delta: np.ndarray, out_count: np.ndarray) -> None:
        self.patterns = patterns
        self.max_len = max(len(p) for p in patterns)
        self.states = delta.shape[0]
        self.delta = delta
        self.out_count = out_count
        self.max_out = int(out_count.max())
        # Staged tables by device (and layouts by budget): kept on the
        # automaton itself, so they live and die with it (never keyed on
        # id(), which a new object may reuse).
        self._tables: dict[torch.device, DfaTables] = {}
        self._layouts: dict[int, ClassLayout] = {}
        self._class_tables: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def layout(self, shared_bytes: int = SHARED_BYTES) -> ClassLayout:
        """``class_layout`` of this automaton, made once per budget."""
        got = self._layouts.get(shared_bytes)
        if got is None:
            got = self._layouts[shared_bytes] = class_layout(self.delta, self.out_count, shared_bytes)
        return got

    def class_tables(self, device, shared_bytes: int = SHARED_BYTES) -> tuple[torch.Tensor, torch.Tensor]:
        """``class_tensors`` of ``layout(shared_bytes)`` on ``device``,
        staged once per device and budget."""
        key = (_device_key(device), shared_bytes)
        got = self._class_tables.get(key)
        if got is None:
            got = self._class_tables[key] = class_tensors(self.layout(shared_bytes), key[0])
        return got

    def tables(self, device) -> DfaTables:
        """This automaton's tables on ``device``, staged once per device."""
        got = self._tables.get(device)  # a tensor's device: the key as staged
        if got is None:
            device = _device_key(device)
            got = self._tables.get(device)
        if got is None:
            flat = self.delta.reshape(-1).astype(np.int64)
            packed = (flat << 8) | np.minimum(self.out_count[flat], 255)
            got = DfaTables(
                delta_flat=torch.from_numpy(flat).to(device),
                out_count=torch.from_numpy(self.out_count.astype(np.int64)).to(device),
                packed=torch.from_numpy(packed.astype(np.uint32).view(np.int32)).to(device),
                out_count32=torch.from_numpy(self.out_count).to(device),
            )
            self._tables[device] = got
        return got

    def count_host(self, data) -> int:
        """Sequential scan over all of ``data`` (the oracle)."""
        delta, out = self.delta.tolist(), self.out_count.tolist()
        total = state = 0
        for c in np.asarray(data, np.uint8).tolist():
            state = delta[state][c]
            total += out[state]
        return total


# ---------------------------------------------------------------------------
# Plain torch version: the CPU path, and the comparison for the kernel
# ---------------------------------------------------------------------------

def stage_rows(hay: torch.Tensor, n: int, max_len: int, chunk: int | None = None):
    """(rows uint8[C, overlap + chunk], gpos0 int64[C], chunk) on hay's device.

    Row ``c`` holds bytes ``[c * chunk - overlap, (c + 1) * chunk)`` of the
    haystack, zero outside ``[0, n)``; ``gpos0[c]`` is the position of its
    first byte. ``rows`` is a view of one padded buffer.
    """
    chunk = PLAIN_CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    overlap = max_len - 1
    c_count = max(-(-n // chunk), 1)
    buf = torch.zeros(c_count * chunk + overlap, dtype=torch.uint8, device=hay.device)
    buf[overlap : overlap + n] = hay[:n]
    rows = buf.unfold(0, chunk + overlap, chunk)[:c_count]
    gpos0 = torch.arange(c_count, dtype=torch.int64, device=hay.device) * chunk - overlap
    return rows, gpos0, chunk


def column_scan(rows: torch.Tensor, gpos0: torch.Tensor, n: int, overlap: int, init, step, hits) -> torch.Tensor:
    """The chunk-parallel column loop shared by the plain scans: every row
    walks its bytes, ``state = step(state, byte)`` at positions inside
    ``[0, n)``, and adds ``hits(state)`` at its own positions (past the
    overlap). Returns the int64[1] total."""
    cols = rows.t().contiguous()
    state = init
    counts = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for p in range(cols.shape[0]):
        gpos = gpos0 + p
        valid = (gpos >= 0) & (gpos < n)
        state = torch.where(valid, step(state, cols[p].long()), state)
        if p >= overlap:
            counts += torch.where(valid, hits(state), 0)
    return counts.sum().reshape(1)


def ac_count_plain(automaton: Automaton, hay: torch.Tensor, n: int | None = None, *, chunk: int | None = None) -> torch.Tensor:
    """Occurrences of all patterns in ``hay[:n]`` as an int64[1] tensor: the
    counterpart of the JAX package's ``_ac_scan``, chunk rows scanned in
    parallel one column at a time."""
    n = _extent(hay, n)
    tables = automaton.tables(hay.device)
    rows, gpos0, _ = stage_rows(hay, n, automaton.max_len, chunk)
    return column_scan(
        rows, gpos0, n, automaton.max_len - 1,
        torch.zeros(rows.shape[0], dtype=torch.int64, device=hay.device),
        lambda state, byte: tables.delta_flat[state * 256 + byte],
        lambda state: tables.out_count[state],
    )


def ac_count_classes_plain(layout: ClassLayout, hay: torch.Tensor, n: int | None = None, *,
                           chunk: int | None = None, max_len: int = 1) -> torch.Tensor:
    """``ac_count_plain`` through the kernel's own tables (``layout``, shared
    or split): each byte to its class, the entry ``table[next * classes +
    class]`` of the state in the entry before it, from the rows in shared
    memory (the first ``hot``) or from device memory, its count above
    ``state_bits``. ``max_len`` is the automaton's (the overlap)."""
    if layout.table is None:
        raise ValueError(f"the {layout.regime} regime reads no class table")
    n = _extent(hay, n)
    dev = hay.device
    table = torch.from_numpy(layout.table.astype(np.int64)).to(dev)
    on_chip = table[: layout.hot * layout.classes]  # the rows a block stages in shared memory
    class_of = torch.from_numpy(layout.class_of.astype(np.int64)).to(dev)
    mask = (1 << layout.state_bits) - 1

    def step(entry, byte):
        idx = (entry & mask) * layout.classes + class_of[byte]
        hot = idx < on_chip.numel()
        return torch.where(hot, on_chip[torch.where(hot, idx, 0)] if on_chip.numel() else 0, table[idx])

    rows, gpos0, _ = stage_rows(hay, n, max_len, chunk)
    return column_scan(rows, gpos0, n, max_len - 1, torch.zeros(rows.shape[0], dtype=torch.int64, device=dev),
                       step, lambda entry: entry >> layout.state_bits)


# ---------------------------------------------------------------------------
# Public functions: the kernel for a CUDA tensor, the plain version on CPU
# ---------------------------------------------------------------------------

def ac_count_tensor(automaton: Automaton, hay: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Occurrences of all patterns in ``hay[:n]`` as an int64[1] tensor on
    hay's device, without waiting for it."""
    if hay.device.type == "cuda":
        from stringwars_tpu_torch.ops import ahocorasick_cuda

        return ahocorasick_cuda.ac_count(automaton, hay, n)
    if hay.device.type == "cpu":
        return ac_count_plain(automaton, hay, n)
    raise ValueError(f"ac_count runs on a CUDA or CPU tensor, not {hay.device}")


def ac_count(automaton: Automaton, hay: torch.Tensor, n: int | None = None) -> int:
    """Total occurrences of all patterns in ``hay[:n]``, a Python int."""
    return int(ac_count_tensor(automaton, hay, n).item())
