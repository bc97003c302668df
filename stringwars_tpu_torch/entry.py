"""The single-device forward step: padded tokens -> xxh64 -> MinHash -> LUT.

The counterpart of ``__graft_entry__.entry()``: ``entry(device)`` returns
``(forward, args)`` with the same example inputs (numpy ``default_rng(0)``:
64 tokens of 64 printable bytes, lengths 1..63, the reversed-identity LUT),
placed on ``device``. ``forward`` runs eagerly: on a CUDA device through the
xxh64, fingerprint and LUT kernels, on the CPU through their plain versions.
The multi-device dry run (``dryrun_multichip``) comes with the parallel
slice.

    python -m stringwars_tpu_torch.entry            # on the card
    python -m stringwars_tpu_torch.entry --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops.fingerprint import fingerprint
from stringwars_tpu_torch.ops.memops import lut_translate
from stringwars_tpu_torch.parallel.mesh import resolve_device
from stringwars_tpu_torch.tape import PaddedTokens
from stringwars_tpu_torch.utils.config import DEVICE_CHOICES


def example_inputs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens_data uint8[64, 64], tokens_lengths int32[64], lut uint8[256])."""
    rng = np.random.default_rng(0)
    data = rng.integers(32, 127, (64, 64), dtype=np.uint8)
    lengths = rng.integers(1, 64, 64, dtype=np.int32)
    lut = np.arange(256, dtype=np.uint8)[::-1].copy()
    return data, lengths, lut


def forward(tokens_data: torch.Tensor, tokens_lengths: torch.Tensor, lut: torch.Tensor) -> dict[str, torch.Tensor]:
    """``digest_checksum``: the u32 sum of the xxh64 digests' low halves (a
    0-d uint32 tensor); ``minhash``: ``fingerprint(ndim=32,
    with_counts=False)``, uint32[64, 32]; ``translated``: ``lut[data]``."""
    toks = PaddedTokens(data=tokens_data, lengths=tokens_lengths, width=tokens_data.shape[1])
    digests = H.xxh64(toks).view(torch.int64)
    checksum = (digests & 0xFFFFFFFF).sum() & 0xFFFFFFFF
    minhash, _ = fingerprint(toks, ndim=32, with_counts=False)
    return {
        "digest_checksum": checksum.to(torch.uint32),
        "minhash": minhash,
        "translated": lut_translate(tokens_data, lut),
    }


def entry(device: str = "cuda"):
    """(forward, example_args) on ``device`` (``"cuda"`` or ``"cpu"``)."""
    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev) for a in example_inputs())
    return forward, args


def main(argv: list[str] | None = None) -> dict[str, torch.Tensor]:
    parser = argparse.ArgumentParser(description="Run the forward step once")
    parser.add_argument("--device", choices=DEVICE_CHOICES, default="cuda")
    fn, args = entry(parser.parse_args(argv).device)
    out = fn(*args)
    print(f"entry ok: digest_checksum {int(out['digest_checksum'])}, minhash {tuple(out['minhash'].shape)}")
    return out


if __name__ == "__main__":
    main()
