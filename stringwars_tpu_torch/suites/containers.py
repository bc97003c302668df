"""Containers suite: multiseed digests (layer 1) and probabilistic filters
(layer 2) (reference ``containers/bench.rs``, defaults 2 s + 10 s, words).

The port of ``stringwars_tpu.suites.containers`` for one device. The
corpus' unique tokens (the first 1,000,000) form a tape on the device; its
spans are hashed where they lie. Startup asserts that the multiseed digests
equal the per-seed ones (``containers/bench.rs:344-357``). The rows:

- ``multihash/{128,256,512,1024}bit/swtorch::xxh64_multiseed<1gpu>``: XXH64
  of every unique token under 2, 4, 8 and 16 seeds (``ops/hash``'s
  ``xxh64_multiseed_spans``; the ``xxhash`` host rows SKIP where the module
  is missing);
- ``filters/swtorch::bloom-build<1gpu>`` / ``bloom-query<1gpu>``: a Bloom
  filter of ``m_bits = 2^ceil(log2(14·cut))`` bits and 7 seeds over the first
  80% (``cut``) of the unique tokens, queried with the other 20%
  (``ops/filters``: the ``bloom_build`` / ``bloom_query`` kernels on a card);
- ``filters/swtorch::fuse8-build(host)``: BinaryFuse8 over the inserted
  tokens' XXH64 digests, peeled on the host;
- ``filters/swtorch::fuse8-query<1gpu>``: the held-out digests (those not
  inserted) against it, their probes staged on the device beforehand and
  left out of the time, as in the reference's query loop.

The Bloom filter must have no false negative (asserted); both filters'
FPR and bits a key go to stderr. With ``--device cpu`` the rows
(``<1cpu>``) run the plain versions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stringwars_tpu_torch.ops import filters as FLT
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.suites._common import setup_suite
from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.harness import WorkUnits

MULTISEED_SEEDS = tuple(range(1, 17))  # 16 fixed seeds (the reference uses 16 odd ones)
MAX_KEYS = 1_000_000  # the reference caps the filter layer at 1 M unique tokens
BLOOM_SEEDS = tuple(range(1, 8))


def verify_multiseed_matches_naive(tape: Tape) -> None:
    """Startup conformance assertion (reference ``containers/bench.rs:344-357``)."""
    seeds = MULTISEED_SEEDS[:8]
    multi = H.xxh64_multiseed_spans(tape.data, tape.offsets, seeds).view(torch.int64)
    for i, s in enumerate(seeds):
        single = H.xxh64_spans(tape.data, tape.offsets, s).view(torch.int64)
        assert torch.equal(multi[i], single), f"multiseed mismatch at seed {s}"
    print("conformance: multiseed == per-seed for 8 seeds", file=sys.stderr)


def bloom_bits(cut: int) -> int:
    """The suite's filter size: about 14 bits a key, a power of two, at least 1,024."""
    return 1 << max(int(np.ceil(np.log2(max(cut * 14, 1024)))), 10)


def _share(answers) -> float:
    """The share of true answers (0 for none)."""
    return int(answers.sum()) / answers.numel() if answers.numel() else 0.0


def _digests(tape: Tape) -> np.ndarray:
    return H.xxh64_spans(tape.data, tape.offsets).cpu().numpy()


def main(argv: list[str] | None = None):
    """Run the suite; returns its context, whose ``staged`` holds the unique
    tape (``tape``), the split (``inserted``, ``held_out``), the Bloom
    filter (``bloom``), the fuse filter (``fuse``), the digests
    (``ins_keys``, ``out_keys``), the staged probes (``probes``) and the
    quality figures (``quality``)."""
    ctx = setup_suite(
        "Multiseed hashing + probabilistic filters",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
        argv=argv,
    )
    tokens = list(dict.fromkeys(ctx.tape.to_list()))[:MAX_KEYS]
    tape = Tape.from_tokens(tokens, device=ctx.device)
    count, total_bytes = tape.count, tape.total_bytes
    verify_multiseed_matches_naive(tape)

    scope = ctx.scopes[0]
    ctx.group("multihash")
    for bits in (128, 256, 512, 1024):
        k = bits // 64
        seeds = tuple(range(1, k + 1))
        ctx.run(
            f"multihash/{bits}bit/swtorch::xxh64_multiseed{scope.name}",
            "bits",
            lambda seeds=seeds, bits=bits: lambda: (
                H.xxh64_multiseed_spans(tape.data, tape.offsets, seeds),
                WorkUnits(elements=count * bits, bytes=total_bytes),
            )[1],
            scope=scope,
        )

        def host_factory(k=k, bits=bits):
            import xxhash

            host_tokens = tokens[: max(count // 50, 1)]
            host_bytes = sum(map(len, host_tokens))

            def routine() -> WorkUnits:
                for t in host_tokens:
                    for s in range(k // 2):
                        xxhash.xxh3_128_intdigest(t, seed=s)
                return WorkUnits(elements=len(host_tokens) * bits, bytes=host_bytes)

            return routine

        ctx.run(f"multihash/{bits}bit/xxhash.xxh3_128-per-seed", "bits", host_factory)

    ctx.group("filters")
    cut = int(count * 0.8)
    inserted, held_out = tape.subtape(0, cut), tape.subtape(cut, count)
    m_bits = bloom_bits(cut)
    bloom = FLT.bloom_build(inserted, BLOOM_SEEDS, m_bits)
    fpr = _share(FLT.bloom_query(bloom, held_out))
    fn_rate = 1.0 - _share(FLT.bloom_query(bloom, inserted)) if inserted.count else 0.0
    print(
        f"bloom quality: FPR {100 * fpr:.3f}%, FN {100 * fn_rate:.3f}%, {bloom.bits_per_key(cut):.1f} bits/key",
        file=sys.stderr,
    )
    assert fn_rate == 0.0, "bloom filters must have zero false negatives"

    ctx.run(
        f"filters/swtorch::bloom-build{scope.name}",
        "keys",
        lambda: lambda: (FLT.bloom_build(inserted, BLOOM_SEEDS, m_bits), WorkUnits(cut, inserted.total_bytes))[1],
        scope=scope,
    )
    ctx.run(
        f"filters/swtorch::bloom-query{scope.name}",
        "keys",
        lambda: lambda: (FLT.bloom_query(bloom, held_out), WorkUnits(count - cut, held_out.total_bytes))[1],
        scope=scope,
    )

    ins_keys = _digests(inserted)
    out_keys = np.setdiff1d(_digests(held_out), ins_keys)
    fuse = FLT.fuse_build(ins_keys, device=ctx.device)
    fuse_fpr = _share(FLT.fuse_query(fuse, out_keys))
    print(
        f"binary-fuse quality: FPR {100 * fuse_fpr:.3f}%, {fuse.bits_per_key(ins_keys.size):.2f} bits/key",
        file=sys.stderr,
    )

    def fuse_build_routine() -> WorkUnits:
        FLT.fuse_build(ins_keys, device=ctx.device)
        return WorkUnits(elements=cut, bytes=inserted.total_bytes)

    ctx.run("filters/swtorch::fuse8-build(host)", "keys", lambda: fuse_build_routine)

    h, fp = FLT.fuse_stage(fuse, out_keys)
    ctx.staged = {
        "tape": tape, "inserted": inserted, "held_out": held_out, "bloom": bloom, "fuse": fuse, "ins_keys": ins_keys,
        "out_keys": out_keys, "probes": (h, fp), "quality": {"bloom": (fpr, fn_rate), "fuse": fuse_fpr},
    }
    ctx.run(
        f"filters/swtorch::fuse8-query{scope.name}",
        "keys",
        lambda: lambda: (
            FLT.fuse_query_probes(fuse.fingerprints, h, fp),
            WorkUnits(elements=max(out_keys.size, 1), bytes=held_out.total_bytes),
        )[1],
        scope=scope,
    )
    return ctx


if __name__ == "__main__":
    main()
