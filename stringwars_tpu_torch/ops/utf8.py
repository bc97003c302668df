"""UTF-8 machinery: count, validate, decode, nth codepoint (family K8).

The port of ``stringwars_tpu.ops.utf8`` (reference rows ``sz::count_utf8``,
``convert_utf8_to_utf32`` and ``find_nth_utf8``,
``tokenization/bench.rs:459-633``). The JAX package runs all of these as XLA
(lead-byte classification plus prefix sums), so the port writes them as torch
ops, which run where the data lies. Scalars come back as 0-d tensors on the
data's device; nothing here synchronizes with the host.

Two translations differ in form from the JAX code: ``torch.argmax`` takes no
bool, so the first hit is the argmax of an int32 mask; and the decode's
scatter with ``mode="drop"`` is an ``index_put_`` whose masked-out writes
(continuation bytes) land in a scratch tail, one slot per position, so the
scatter has no duplicate index and needs no host sync.
"""

from __future__ import annotations

import numpy as np
import torch


def _classify(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(is_lead, width) per byte of the int32 bytes ``b``; width 0 for
    continuations and invalid leads."""
    is_cont = (b & 0xC0) == 0x80
    width = torch.where(
        b < 0x80, 1,
        torch.where(b < 0xC0, 0, torch.where(b < 0xE0, 2, torch.where(b < 0xF0, 3, torch.where(b < 0xF8, 4, 0)))),
    ).to(torch.int32)
    return ~is_cont, width


def utf8_count(data: torch.Tensor, n: int) -> torch.Tensor:
    """Number of codepoints (= non-continuation bytes) in ``data[:n]``."""
    return ((data[:n] & 0xC0) != 0x80).sum(dtype=torch.int32)


def utf8_find_nth(data: torch.Tensor, n: int, k) -> torch.Tensor:
    """Byte offset of the k-th codepoint (0-based); n if out of range."""
    is_lead = ((data[:n] & 0xC0) != 0x80).to(torch.int32)
    ranks = torch.cumsum(is_lead, 0, dtype=torch.int32) - is_lead
    hit = ((ranks == k) & (is_lead == 1)).to(torch.int32)
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=data.device)
    first = torch.argmax(hit).to(torch.int32)
    return torch.where(hit.any(), first, torch.full_like(first, n))


def _codepoints_at(b: torch.Tensor, n: int) -> torch.Tensor:
    """Codepoint value decoded at every position of the int32 bytes ``b``
    (junk at non-leads; above 0x10FFFF at the invalid leads 0xF5-0xFF)."""

    def nxt(k):
        return torch.nn.functional.pad(b[k:], (0, min(k, b.shape[0]))) & 0x3F

    _, width = _classify(b)
    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp2 = ((b & 0x1F) << 6) | b1
    cp3 = ((b & 0x0F) << 12) | (b1 << 6) | b2
    cp4 = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    return torch.where(width == 1, b, torch.where(width == 2, cp2, torch.where(width == 3, cp3, cp4)))


def utf8_validate(data: torch.Tensor, n: int) -> torch.Tensor:
    """Strict UTF-8 validity of ``data[:n]`` (structure + ranges), a 0-d bool."""
    b = data[:n].to(torch.int32)
    is_lead, width = _classify(b)
    is_cont = ~is_lead

    def width_at(k):
        """width[i-k], zeros beyond the left edge."""
        return torch.nn.functional.pad(width, (k, 0))[:n]

    covered = (width_at(1) >= 2) | (width_at(2) >= 3) | (width_at(3) >= 4)
    # Every continuation must be covered by a preceding lead's span, and
    # every covered slot must actually be a continuation (no truncation).
    structure_ok = (is_cont == covered).all()
    structure_ok &= (~(is_lead & (width == 0))).all()
    idx = torch.arange(n, dtype=torch.int32, device=data.device)
    structure_ok &= (~(is_lead & (idx + width > n))).all()

    cp = _codepoints_at(b, n)
    ok2 = (width != 2) | (cp >= 0x80)
    ok3 = (width != 3) | ((cp >= 0x800) & ~((cp >= 0xD800) & (cp <= 0xDFFF)))
    ok4 = (width != 4) | ((cp >= 0x10000) & (cp <= 0x10FFFF))
    return structure_ok & torch.where(is_lead, ok2 & ok3 & ok4, True).all()


def utf8_decode(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode to UTF-32: (codepoints int32[n] zero-padded, count).

    Output slot j holds the j-th codepoint; invalid input produces
    unspecified values (validate first when needed).
    """
    b = data[:n].to(torch.int32)
    is_lead = (b & 0xC0) != 0x80
    cp = _codepoints_at(b, n)
    lead32 = is_lead.to(torch.int32)
    rank = torch.cumsum(lead32, 0, dtype=torch.int32) - 1
    # Continuation bytes write to slot n + i of a scratch tail instead of
    # being dropped: every index is distinct, and the tail is cut off.
    dst = torch.where(is_lead, rank, n + torch.arange(n, dtype=torch.int32, device=data.device)).long()
    out = torch.zeros(2 * n, dtype=torch.int32, device=data.device)
    out.index_put_((dst,), cp)
    return out[:n], lead32.sum(dtype=torch.int32)


def decode_codepoints(token: bytes) -> np.ndarray:
    """Host-side decode helper (for building codepoint-level DP inputs)."""
    return np.array([ord(c) for c in token.decode("utf-8")], dtype=np.int32)
