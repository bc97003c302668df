"""The token tape: a flat ``uint8`` byte tensor plus ``int64`` offsets.

The torch counterpart of ``stringwars_tpu.tape``: ``data[offsets[i]:offsets[i+1]]``
is token ``i``. Tokenization runs on the host in numpy (the same spans as the
JAX package, so both packages see the same tokens); the finished tape lives on
an explicit ``torch.device``. Unlike the JAX tape, ``data`` is not padded:
every kernel of the port bounds-checks against ``total_bytes`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_ASCII_WS = np.array([9, 10, 11, 12, 13, 32], dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class Tape:
    """Flat token tape on one device: ``data[offsets[i]:offsets[i+1]]`` is token ``i``."""

    data: torch.Tensor  # uint8[total_bytes]
    offsets: torch.Tensor  # int64[count + 1]
    count: int
    total_bytes: int

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- construction ------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: np.ndarray, offsets: np.ndarray, *, device=None) -> "Tape":
        """Wrap host arrays (uint8 bytes, int-like offsets) into a tape on ``device``.

        Also the converter for state carried over from the JAX package:
        ``Tape.from_numpy(np.asarray(jax_tape.data), np.asarray(jax_tape.offsets))``.
        """
        offsets = np.asarray(offsets).astype(np.int64)
        total = int(offsets[-1])
        data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8)[:total])
        if data.shape[0] != total:
            raise ValueError(f"tape data holds {data.shape[0]} bytes, offsets end at {total}")
        device = torch.device("cpu") if device is None else torch.device(device)
        return cls(
            data=torch.from_numpy(data.copy()).to(device),
            offsets=torch.from_numpy(offsets.copy()).to(device),
            count=int(offsets.shape[0]) - 1,
            total_bytes=total,
        )

    @classmethod
    def from_tokens(cls, tokens: Sequence[bytes], *, device=None) -> "Tape":
        """Build a tape from a Python list of byte strings (tests / small inputs)."""
        lengths = np.fromiter((len(t) for t in tokens), dtype=np.int64, count=len(tokens))
        offsets = np.zeros(len(tokens) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        data = np.frombuffer(b"".join(tokens), dtype=np.uint8) if tokens else np.zeros(0, np.uint8)
        return cls.from_numpy(data, offsets, device=device)

    @classmethod
    def from_buffer(
        cls,
        buffer: bytes | np.ndarray,
        mode: str = "lines",
        *,
        max_tokens: int | None = None,
        unique: bool = False,
        device=None,
    ) -> "Tape":
        """Tokenize a corpus buffer into a tape (``lines``, ``words`` or ``file``).

        ``lines`` splits on LF, ``words`` on ASCII whitespace runs (empty
        tokens dropped, like ``str.split()``), ``file`` is one giant token.
        """
        if isinstance(buffer, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(buffer, dtype=np.uint8)
        else:
            raw = np.ascontiguousarray(buffer, dtype=np.uint8)
        starts, ends = token_spans(raw, mode)
        if max_tokens is not None and starts.shape[0] > max_tokens:
            starts, ends = starts[:max_tokens], ends[:max_tokens]
        if unique and mode != "file":
            starts, ends = _dedup_spans(raw, starts, ends)
        return cls.from_spans(raw, starts, ends, device=device)

    @classmethod
    def from_spans(cls, raw: np.ndarray, starts: np.ndarray, ends: np.ndarray, *, device=None) -> "Tape":
        """Compact (start, end) spans over ``raw`` into a contiguous tape."""
        lengths = (ends - starts).astype(np.int64)
        offsets = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        # Source index of destination byte d of token t is starts[t] + (d - offsets[t]):
        # one repeat of the per-token shift plus an arange, no per-byte search.
        src = np.repeat(starts.astype(np.int64) - offsets[:-1], lengths)
        src += np.arange(total, dtype=np.int64)
        return cls.from_numpy(raw[src], offsets, device=device)

    # -- views -------------------------------------------------------------
    @property
    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def to_list(self) -> list[bytes]:
        o = self.offsets.cpu().numpy()
        d = self.data.cpu().numpy()
        return [d[o[i] : o[i + 1]].tobytes() for i in range(self.count)]

    def subtape(self, lo: int, hi: int) -> "Tape":
        """Tokens [lo, hi) as a compact tape on the same device. They lie
        contiguously in ``data``, so this is a slice, not a gather."""
        o = self.offsets[lo : hi + 1]
        start, end = int(o[0]), int(o[-1])
        return Tape(data=self.data[start:end], offsets=o - start, count=o.numel() - 1, total_bytes=end - start)


def pack_u32(data: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 words of a contiguous uint8 tensor (last axis divisible by 4).

    A reinterpretation, not a copy: a GPU has no tile padding to route around.
    """
    return data.view(torch.uint32)


def token_spans(raw: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) spans for tokens of ``raw`` under ``mode`` — pure numpy."""
    n = raw.shape[0]
    if mode == "file":
        return np.array([0], np.int64), np.array([n], np.int64)
    if mode == "lines":
        # Split on LF; like bytes.split(b"\n") this keeps empty lines.
        newline_at = np.flatnonzero(raw == 0x0A).astype(np.int64)
        starts = np.concatenate(([0], newline_at + 1))
        ends = np.concatenate((newline_at, [n]))
        return starts, ends
    if mode == "words":
        # ASCII-whitespace runs delimit words; empties dropped (str.split semantics).
        is_ws = np.isin(raw, _ASCII_WS)
        edges = np.diff(is_ws.astype(np.int8), prepend=1, append=1)
        starts = np.flatnonzero(edges == -1).astype(np.int64)
        ends = np.flatnonzero(edges == 1).astype(np.int64)
        return starts, ends
    raise ValueError(f"Unknown tokens mode: {mode!r}; use 'lines', 'words', or 'file'")


def _dedup_spans(raw: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Order-preserving token dedup, hashed on the host."""
    seen: dict[bytes, None] = {}
    keep = np.zeros(starts.shape[0], dtype=bool)
    view = raw.tobytes()
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        key = view[s:e]
        if key not in seen:
            seen[key] = None
            keep[i] = True
    return starts[keep], ends[keep]


# ---------------------------------------------------------------------------
# PaddedTokens: rectangular [count, width] view for batched per-token kernels
# ---------------------------------------------------------------------------

def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class PaddedTokens:
    """``[count, width]`` uint8 matrix of zero-padded tokens plus lengths.

    The counterpart of ``stringwars_tpu.tape.PaddedTokens``, with the same
    bytes, lengths and widths. ``width`` is a multiple of 4, so a row is
    whole little-endian u32 words; with the default ``align=64`` every row
    starts 16-byte aligned, which the hash kernels read as 16-byte vectors.
    """

    data: torch.Tensor  # uint8[count, width]
    lengths: torch.Tensor  # int32[count]
    width: int

    @property
    def count(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def from_numpy(cls, data: np.ndarray, lengths: np.ndarray, width: int | None = None, *, device=None) -> "PaddedTokens":
        """Take padded tokens of the JAX package (its arrays as numpy)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        width = data.shape[1] if width is None else int(width)
        if data.ndim != 2 or data.shape[1] != width or width % 4:
            raise ValueError(f"expected a [count, width] matrix with width % 4 == 0, got {data.shape} and width {width}")
        device = torch.device("cpu") if device is None else torch.device(device)
        return cls(
            data=torch.from_numpy(data.copy()).to(device),
            lengths=torch.from_numpy(np.asarray(lengths, dtype=np.int32).copy()).to(device),
            width=width,
        )

    @classmethod
    def from_tape(
        cls,
        tape: Tape,
        *,
        width: int | None = None,
        align: int = 64,
        max_width: int | None = None,
        device=None,
    ) -> "PaddedTokens":
        """Pad every token of ``tape`` to a common width, on the tape's device.

        Tokens longer than ``max_width`` (if set) are truncated — callers that
        need exactness must bucket instead (``bucket_by_length``).
        """
        padded = _pad_spans(tape.data, tape.offsets[:-1], tape.lengths, width=width, align=align, max_width=max_width)
        return padded if device is None else padded.to(device)

    def to(self, device) -> "PaddedTokens":
        return PaddedTokens(data=self.data.to(device), lengths=self.lengths.to(device), width=self.width)


def _pad_spans(
    data: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    width: int | None = None,
    align: int = 64,
    max_width: int | None = None,
) -> PaddedTokens:
    """The tokens ``data[starts[i] : starts[i] + lengths[i]]`` as padded rows,
    built on ``data``'s device by one scatter of every byte."""
    count = lengths.numel()
    natural = int(lengths.max()) if count else 1
    w = width if width is not None else natural
    if max_width is not None:
        w = min(w, max_width)
    w = max(_pad_to(max(w, 1), align), align)
    clamped = lengths.clamp(max=w)
    mat = torch.zeros((count, w), dtype=torch.uint8, device=data.device)
    total = int(clamped.sum()) if count else 0
    if total:
        row = torch.repeat_interleave(torch.arange(count, device=data.device), clamped, output_size=total)
        first = torch.cumsum(clamped, 0) - clamped  # flat index of each row's first byte
        intra = torch.arange(total, device=data.device) - first[row]
        mat.view(-1)[row * w + intra] = data[starts[row] + intra]
    return PaddedTokens(data=mat, lengths=clamped.to(torch.int32), width=w)


def bucket_by_length(tape: Tape, edges: Sequence[int], *, align: int = 64) -> list[PaddedTokens]:
    """Split a tape into per-length-bucket ``PaddedTokens`` (no truncation).

    ``edges`` are inclusive upper bounds per bucket; a final bucket catches
    everything longer. Empty tokens belong to no bucket. The same buckets,
    bytes and widths as the JAX package's, built on the tape's device.
    """
    return [padded for padded, _ in bucket_spans(tape, edges, align=align)]


def bucket_spans(tape: Tape, edges: Sequence[int], *, align: int = 64) -> list[tuple[PaddedTokens, torch.Tensor]]:
    """``bucket_by_length`` with each bucket's token indices into the tape
    (int64, on the tape's device), for mapping results back to tokens."""
    lengths = tape.lengths
    longest = int(lengths.max()) if tape.count else 1
    bounds = list(edges) + [max(longest, (edges[-1] if edges else 0) + 1)]
    out = []
    lo = 0
    for hi in bounds:
        idx = torch.nonzero((lengths > lo) & (lengths <= hi)).squeeze(1)
        if idx.numel():
            out.append((_pad_spans(tape.data, tape.offsets[idx], lengths[idx], align=align), idx))
        lo = hi
    return out
