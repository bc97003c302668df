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
    def to_list(self) -> list[bytes]:
        o = self.offsets.cpu().numpy()
        d = self.data.cpu().numpy()
        return [d[o[i] : o[i + 1]].tobytes() for i in range(self.count)]


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
