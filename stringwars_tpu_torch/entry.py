"""The single-device forward step: padded tokens -> xxh64 -> MinHash -> LUT.

The counterpart of ``__graft_entry__.entry()``: ``entry(device)`` returns
``(forward, args)`` with the same example inputs (numpy ``default_rng(0)``:
64 tokens of 64 printable bytes, lengths 1..63, the reversed-identity LUT),
placed on ``device``. ``forward`` runs eagerly: on a CUDA device through the
xxh64, fingerprint and LUT kernels, on the CPU through their plain versions.

``dryrun_multichip(world)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the sharded pipeline step
(``parallel/pipeline.py``) over the ranks of the initialized process group
on ``demo_inputs``, its reduced digest checksum held to a one-device replay
of the whole token batch, then ``ops/sort.argsort_sharded`` held to
``argsort_tape`` on 512 random words (``default_rng(3)``). ``main`` runs it
after the forward step: under torchrun over every rank, else over a world of
this process alone.

    python -m stringwars_tpu_torch.entry            # on the card
    python -m stringwars_tpu_torch.entry --device cpu
    torchrun --nproc-per-node 4 -m stringwars_tpu_torch.entry
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops.fingerprint import fingerprint
from stringwars_tpu_torch.ops.memops import lut_translate
from stringwars_tpu_torch.parallel import distributed
from stringwars_tpu_torch.parallel.mesh import resolve_device, world_scope
from stringwars_tpu_torch.tape import PaddedTokens, Tape
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


def dryrun_multichip(world: int, device: str = "cuda") -> dict[str, torch.Tensor]:
    """Run the sharded step once over the initialized process group of
    ``world`` ranks (this rank's device: ``device``) and check it; returns
    the step's outputs on this rank."""
    from stringwars_tpu_torch.ops.sort import argsort_sharded, argsort_tape
    from stringwars_tpu_torch.parallel.pipeline import demo_arrays, demo_inputs, make_sharded_step

    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(f"dryrun_multichip({world}) needs an initialized process group of {world} ranks")
    scope = world_scope(resolve_device(device))
    inputs = demo_inputs(scope)
    out = make_sharded_step(scope)(inputs)

    # The reduced checksum against a one-device replay of the whole batch.
    _, _, tokens, lengths = demo_arrays(world)
    digests = H.xxh64(PaddedTokens.from_numpy(tokens, lengths, device=scope.device)).view(torch.int64)
    want = int((((digests & 0xFFFFFFFF).sum() + ((digests >> 32) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF).item())
    got = int(out["digest_checksum"])
    if got != want:
        raise AssertionError(f"the reduced digest checksum {got} is not the one-device replay's {want}")
    if out["translated"].shape != inputs.tokens.data.shape or out["bpe_ids"].shape != inputs.tokens.data.shape:
        raise AssertionError("the step's token outputs are not of the shard's shape")
    for key in ("matches", "ac_matches", "bpe_tokens"):  # 'ab' soup and 'ab' an AC pattern: all positive
        if int(out[key]) <= 0:
            raise AssertionError(f"the step's {key} is {int(out[key])}")

    # The sample sort over the same ranks: the one-device stable order.
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(97, 105, rng.integers(1, 10), dtype=np.uint8)) for _ in range(512)]
    tape = Tape.from_tokens(words, device=scope.device)
    if not np.array_equal(argsort_sharded(tape, scope), argsort_tape(tape)):
        raise AssertionError("the sharded argsort is not the one-device order")
    return out


def main(argv: list[str] | None = None) -> dict[str, torch.Tensor]:
    parser = argparse.ArgumentParser(description="Run the forward step once, then the sharded dry run")
    parser.add_argument("--device", choices=DEVICE_CHOICES, default="cuda")
    device = parser.parse_args(argv).device
    fn, args = entry(device)
    out = fn(*args)
    print(f"entry ok: digest_checksum {int(out['digest_checksum'])}, minhash {tuple(out['minhash'].shape)}")
    with tempfile.TemporaryDirectory() as scratch:
        if not distributed.maybe_initialize(device) and not dist.is_initialized():
            distributed.initialize(device, init_method=(Path(scratch) / "group").as_uri(), rank=0, world_size=1)
        try:
            dryrun_multichip(dist.get_world_size(), device)
            if dist.get_rank() == 0:
                print(f"dryrun ok: {dist.get_world_size()} rank(s)")
        finally:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
