"""Fingerprints suite: MinHash over multi-scale n-grams, NDIM sweep
(reference ``fingerprints/bench.rs:234-660``, defaults 1 s + 30 s, lines).

The port of ``stringwars_tpu.suites.fingerprints`` for one device. Sweeps
``SWTPU_NDIM`` or ``SWTPU_NDIM_SCALES`` (default 64,128,256,512 like the
reference ``fingerprints/bench.rs:253-266``) over a batch of
``auto_batch_size(256)`` documents padded to at most 4096 bytes; work =
NDIM hash-ops per token byte. The device row
(``minhash/ndim_<d>/swtorch::fingerprint<1gpu>``) runs the CUDA kernel of
``ops/fingerprint.py``; with ``--device cpu`` the row (``<1cpu>``) runs the
plain torch version. Under a world of N ranks (torchrun) the row also runs
sharded (``<Ngpu>``): the batch padded to a multiple of the ranks with empty
documents, each rank fingerprinting its rows; work is counted over the
whole batch. Quality (bit entropy, collision rate) is printed per
scale to stderr; the host row replays the spec in numpy on 8 documents.
"""

from __future__ import annotations

from stringwars_tpu_torch.ops import fingerprint as FP
from stringwars_tpu_torch.parallel.sharding import shard_tokens
from stringwars_tpu_torch.suites._common import setup_suite
from stringwars_tpu_torch.tape import PaddedTokens
from stringwars_tpu_torch.utils.config import get_env
from stringwars_tpu_torch.utils.harness import WorkUnits

MAX_WIDTH = 4096


def ndim_scales() -> list[int]:
    single = get_env("NDIM")
    if single:
        return [int(single)]
    scales = get_env("NDIM_SCALES")
    if scales:
        return [int(s) for s in scales.split(",")]
    return [64, 128, 256, 512]


def main(argv: list[str] | None = None):
    """Run the suite; returns its context, whose ``staged`` holds the
    batch (``tokens``) and, per ndim, the min-hashes and the quality pair
    (bit entropy, collision rate)."""
    ctx = setup_suite(
        "MinHash fingerprint throughput + quality",
        default_tokens="lines",
        default_warmup=1.0,
        default_time=30.0,
        default_synthetic="long-lines",
        argv=argv,
    )
    batch = min(ctx.scopes[-1].auto_batch_size(default_base=256), ctx.tape.count)
    sub = ctx.tape.subtape(0, batch)
    tokens = PaddedTokens.from_tape(sub, max_width=MAX_WIDTH)
    total_bytes = int(tokens.lengths.sum())
    ctx.staged = {"tokens": tokens, "min_hashes": {}, "quality": {}}

    for ndim in ndim_scales():
        ctx.group(f"minhash/ndim_{ndim}")
        units = WorkUnits(elements=ndim * total_bytes, bytes=total_bytes)
        for scope in ctx.scopes:

            def make(ndim=ndim, units=units, scope=scope):
                staged = tokens if scope.group is None else PaddedTokens(
                    shard_tokens(scope, tokens.data)[0], shard_tokens(scope, tokens.lengths)[0], tokens.width)
                return lambda: (FP.fingerprint(staged, ndim=ndim), units)[1]

            ctx.run(f"minhash/ndim_{ndim}/swtorch::fingerprint{scope.name}", "hashes", make, scope=scope)

        mh = FP.fingerprint(tokens, ndim=ndim, with_counts=False)[0].cpu().numpy()
        quality = (FP.bit_entropy(mh), FP.collision_rate(mh))
        ctx.staged["min_hashes"][ndim] = mh
        ctx.staged["quality"][ndim] = quality
        ctx.log(f"quality ndim_{ndim}: bit-entropy {quality[0]:.4f}, collisions {100.0 * quality[1]:.2f}%")

        # Host baseline: numpy replay of the same spec on a token sample.
        def host_factory(ndim=ndim):
            sample = sub.to_list()[:8]
            sample_bytes = sum(map(len, sample))
            dims = min(ndim, 16)

            def routine() -> WorkUnits:
                for t in sample:
                    FP.fingerprint_ref(t, ndim=dims)
                return WorkUnits(elements=dims * sample_bytes, bytes=sample_bytes)

            return routine

        ctx.run(f"minhash/ndim_{ndim}/numpy-replay", "hashes", host_factory)
    return ctx


if __name__ == "__main__":
    main()
