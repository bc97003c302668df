"""Scaling suite: the sharded pipeline per scope (``<1gpu>`` against ``<Ngpu>``).

The port of ``stringwars_tpu.suites.scaling``: the row
``pipeline/swtorch::sharded_step<scope>`` times the sharded step of
``parallel/pipeline.py`` (halo find, Aho-Corasick, XXH64 and its checksum,
MinHash, BPE, LUT translate, one ``all_reduce`` of the counts) over the
corpus, at the JAX shapes: 4,096 tokens cut to 64 B and 4 MB of haystack a
rank (the corpus repeated to fill it). Work a call = 2 x the haystack bytes
(the find and the AC scan) + the token bytes (``build_inputs``). With more
than one scope the scaling efficiency (bytes/s against the ``<1gpu>`` rate
times the ranks) goes to stderr.

    python -m stringwars_tpu_torch.suites.scaling                        # <1gpu>
    torchrun --nproc-per-node 4 -m stringwars_tpu_torch.suites.scaling   # <1gpu> on rank 0, then <4gpu>

Under torchrun the ``<1gpu>`` row runs on rank 0 while the others wait at a
barrier; the ``<Ngpu>`` row runs on every rank, and rank 0 reports it.
"""

from __future__ import annotations

import numpy as np

from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.parallel.pipeline import NEEDLE_CAP, StepInputs, make_sharded_step, stage_inputs
from stringwars_tpu_torch.suites._common import setup_suite
from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.harness import WorkUnits

TOKENS_PER_CHIP = 4096
HAY_BYTES_PER_CHIP = 4 << 20
TOKEN_WIDTH = 64  # tokens cut to 64 B


def build_inputs(scope: DeviceScope, tape: Tape) -> tuple[StepInputs, int]:
    """(this rank's step inputs, work bytes a call) from the tape, as the
    JAX ``build_inputs`` makes them: a haystack row a rank of the corpus
    repeated, the first ``TOKENS_PER_CHIP`` tokens a rank (empty ones
    dropped, ``pad`` filling in), the AC corpus the rows' chunks end to end."""
    chips = scope.gpus
    row_len = HAY_BYTES_PER_CHIP + 4 * NEEDLE_CAP + 8
    big = np.resize(tape.data[: tape.total_bytes].cpu().numpy(), chips * row_len)
    count = chips * TOKENS_PER_CHIP
    token_list = [t[:TOKEN_WIDTH] for t in tape.subtape(0, min(count, tape.count)).to_list() if t]
    token_list += [b"pad"] * (count - len(token_list))
    tokens = np.zeros((count, TOKEN_WIDTH), np.uint8)
    lengths = np.zeros(count, np.int32)
    for i, t in enumerate(token_list):
        tokens[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    inputs = stage_inputs(scope, big.reshape(chips, row_len), big[: chips * HAY_BYTES_PER_CHIP], tokens, lengths)
    return inputs, 2 * chips * HAY_BYTES_PER_CHIP + int(lengths.sum())


def main(argv: list[str] | None = None):
    """Run the suite; returns its context, whose ``staged`` maps each
    scope's rank count to its bytes/s (on rank 0)."""
    ctx = setup_suite(
        "Multi-GPU scaling of the sharded pipeline",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
        argv=argv,
    )
    ctx.group("pipeline")
    rates: dict[int, float] = {}
    for scope in ctx.scopes:

        def make(scope=scope):
            inputs, total_bytes = build_inputs(scope, ctx.tape)
            step = make_sharded_step(scope)
            return lambda: (step(inputs), WorkUnits(1, total_bytes))[1]

        stats = ctx.run(f"pipeline/swtorch::sharded_step{scope.name}", "bytes", make, scope=scope)
        if stats is not None:
            rates[scope.gpus] = stats.bytes_per_second
    ctx.staged = rates
    if len(rates) > 1:
        base = rates[min(rates)]
        for gpus, rate in sorted(rates.items()):
            eff = rate / (base * gpus / min(rates))
            ctx.log(f"scaling {gpus} gpu(s): {rate / 1e9:.2f} GB/s, efficiency {100 * eff:.1f}%")
    return ctx


if __name__ == "__main__":
    main()
