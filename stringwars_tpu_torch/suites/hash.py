"""Hash suite: stateless / stateful / checksum groups (reference
``hash/bench.rs:483``, ``hash/bench.py:236``; defaults: words tokens,
2 s warm-up + 10 s measure).

The port of ``stringwars_tpu.suites.hash`` for one device. The stateless
device rows (``swtorch::...<1gpu>``: ``swh64``, ``xxh64``, ``xxh32``,
``swh64_multiseed8`` and ``xxh3_64``) hash every token of the corpus where
it lies on the tape, in one launch a call (``ops/hash``'s ``*_spans`` and
``ops/xxh3.xxh3_64_spans``; ``spans_call`` is a row's call): no buckets, the
same work units (the non-empty tokens and their bytes; an empty token gets
the empty input's digest and counts for nothing); the digest of token ``t``
is entry ``t`` (``swh64_multiseed8``: column ``t`` of 8 rows). Under a
world of N ranks (torchrun) the stateless rows also run sharded
(``<Ngpu>``, ``sharded_spans_call``): each rank hashes its equal share of
the tokens, their digests left on its device (as the JAX rows leave them
sharded); work is counted over the whole tape. With
``--device cpu`` the same rows (``<1cpu>``) run the plain versions. The
checksum group's ``swtorch::sha256`` row hashes every token per call over
rectangular ``PaddedTokens`` buckets by length (``BUCKET_EDGES``; SHA-256
is compute-bound on whole 64-byte blocks), staged once per suite run on
the device, the staging seconds to stderr (``HashBuckets``, which also
serve ``digests`` and the collision audit). Host baselines (the ``xxhash``
wheel, CPython builtins, ``zlib``, ``hashlib``) run the same corpus under
the same deadline pacing as the reference's Python suite; a row whose
module is missing is SKIPPED.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from stringwars_tpu_torch.ops import bytesum as B
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops import sha256 as SHA
from stringwars_tpu_torch.ops import xxh3 as X3
from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.tape import PaddedTokens, Tape, bucket_spans
from stringwars_tpu_torch.utils.config import get_env_bool
from stringwars_tpu_torch.utils.harness import WorkUnits, now_ns, paced_items

BUCKET_EDGES = [16, 64, 256, 1024, 4096]
MULTISEEDS = tuple(range(8))


@dataclasses.dataclass(frozen=True)
class HashBuckets:
    """The tape's non-empty tokens bucketed by length, on the tape's device:
    ``buckets[i]`` holds the tokens whose tape indices are ``indices[i]``."""

    buckets: list[PaddedTokens]
    indices: list[torch.Tensor]
    tokens: int
    token_bytes: int

    @classmethod
    def stage(cls, tape: Tape) -> "HashBuckets":
        spans = bucket_spans(tape, BUCKET_EDGES)
        buckets = [padded for padded, _ in spans]
        total = int(sum(int(p.lengths.sum(dtype=torch.int64)) for p in buckets))
        return cls(buckets, [idx for _, idx in spans], sum(p.count for p in buckets), total)

    @property
    def units(self) -> WorkUnits:
        return WorkUnits(elements=self.tokens, bytes=self.token_bytes)

    def digests(self, fn) -> tuple[np.ndarray, np.ndarray]:
        """(token indices, digests) of ``fn`` over every bucket, sorted by
        token index, on the host."""
        idx = torch.cat(self.indices).cpu().numpy()
        out = torch.cat([fn(padded).cpu() for padded in self.buckets]).numpy()
        order = np.argsort(idx, kind="stable")
        return idx[order], out[order]


def device_routine(staged: HashBuckets, fn):
    """One call hashes every bucket once; the digests stay on the device."""

    def routine() -> WorkUnits:
        for padded in staged.buckets:
            fn(padded)
        return staged.units

    return routine


# The stateless device rows: each hash of the tape's spans (seed 0; the
# multiseed row under MULTISEEDS).
SPANS_ROWS = {
    "swh64": H.swh64_spans,
    "xxh64": H.xxh64_spans,
    "xxh32": H.xxh32_spans,
    "swh64_multiseed8": functools.partial(H.swh64_multiseed_spans, seeds=MULTISEEDS),
    "xxh3_64": X3.xxh3_64_spans,
}


def spans_call(tape: Tape, op: str) -> torch.Tensor:
    """The ``stateless/swtorch::<op>`` row's call: the digests of every token
    of the tape where it lies, by token index."""
    return SPANS_ROWS[op](tape.data, tape.offsets)


def sharded_spans_call(tape: Tape, op: str, scope: DeviceScope) -> torch.Tensor:
    """The ``stateless/swtorch::<op><Ngpu>`` row's call on one rank: the
    digests of its share of the tape's tokens (``ceil(T / N)`` a rank, by
    token index from ``rank * ceil(T / N)``)."""
    per = -(-tape.count // scope.gpus)
    lo = min(scope.rank * per, tape.count)
    return SPANS_ROWS[op](tape.data, tape.offsets[lo : min(lo + per, tape.count) + 1])


def bench_device_hashes(ctx: SuiteContext, staged: HashBuckets) -> None:
    tape, units = ctx.tape, staged.units

    def routine(op: str, scope: DeviceScope):
        def run() -> WorkUnits:
            if scope.group is None:
                spans_call(tape, op)
            else:
                sharded_spans_call(tape, op, scope)
            return units

        return run

    for scope in ctx.scopes:
        for op in SPANS_ROWS:
            ctx.run(f"stateless/swtorch::{op}{scope.name}", "bytes", lambda op=op, scope=scope: routine(op, scope),
                    scope=scope)


class HostCopy:
    """The corpus on the host, made at the first host row that needs it."""

    def __init__(self, tape: Tape):
        self.tape = tape

    @functools.cached_property
    def tokens(self) -> list[bytes]:
        return self.tape.to_list()

    @functools.cached_property
    def data(self) -> bytes:
        return self.tape.data[: self.tape.total_bytes].cpu().numpy().tobytes()


def bench_host_hash(ctx: SuiteContext, host: HostCopy, name: str, make_hash) -> None:
    """A host row over every token, paced under the deadline; ``make_hash``
    imports its module, so a missing one SKIPs the row."""

    def factory():
        hash_fn = make_hash()
        tokens = host.tokens

        def routine() -> WorkUnits:
            deadline = now_ns() + int(ctx.budget.time_seconds * 1e9)
            done = done_bytes = 0
            for token in paced_items(tokens, deadline):
                hash_fn(token)
                done += 1
                done_bytes += len(token)
            return WorkUnits(elements=done, bytes=done_bytes)

        return routine

    ctx.run(name, "bytes", factory)


def _xxhash():
    import xxhash

    return xxhash


def bench_stateful(ctx: SuiteContext, host: HostCopy) -> None:
    data, n = ctx.tape.data, ctx.tape.total_bytes
    scope = ctx.scopes[0]
    ctx.run(
        f"stateful/swtorch::tree_hash64{scope.name}",
        "bytes",
        lambda: lambda: (H.tree_hash64(data, n), WorkUnits(elements=1, bytes=n))[1],
        scope=scope,
    )

    def host_stream_factory():
        xxhash = _xxhash()
        data = host.data

        def routine() -> WorkUnits:
            hasher = xxhash.xxh64()
            hasher.update(data)
            hasher.intdigest()
            return WorkUnits(elements=1, bytes=n)

        return routine

    ctx.run("stateful/xxhash.xxh64_stream", "bytes", host_stream_factory)


def bench_checksum(ctx: SuiteContext, staged: HashBuckets, host: HostCopy) -> None:
    data, n = ctx.tape.data, ctx.tape.total_bytes
    scope = ctx.scopes[0]
    ctx.run(
        f"checksum/swtorch::bytesum{scope.name}",
        "bytes",
        lambda: lambda: (B.bytesum(data, n), WorkUnits(elements=1, bytes=n))[1],
        scope=scope,
    )
    ctx.run(f"checksum/swtorch::sha256{scope.name}", "bytes", lambda: device_routine(staged, SHA.sha256),
            scope=scope)

    def host_factory(module: str, fn_name: str):
        def factory():
            fn = getattr(__import__(module), fn_name)
            data = host.data
            return lambda: (fn(data), WorkUnits(elements=1, bytes=n))[1]

        return factory

    ctx.run("checksum/zlib.crc32", "bytes", host_factory("zlib", "crc32"))
    ctx.run("checksum/hashlib.sha256", "bytes", host_factory("hashlib", "sha256"))


def report_collisions(staged: HashBuckets, host: HostCopy) -> None:
    """Opt-in collision audit (reference ``hash/bench.rs:129-167``): count
    distinct xxh64 digests against the unique-token count, to stderr."""
    _, digests = staged.digests(H.xxh64)
    unique_tokens = len(set(t for t in host.tokens if t))
    collisions = unique_tokens - len(np.unique(digests))
    print(
        f"collisions: {collisions:,} over {unique_tokens:,} unique tokens "
        f"({100.0 * collisions / max(unique_tokens, 1):.4f}%)",
        file=sys.stderr,
        flush=True,
    )


def main(argv: list[str] | None = None) -> SuiteContext:
    """Run the suite; returns its context, whose ``staged`` holds the
    device buckets (``HashBuckets``; ``spans_call(ctx.tape, op)`` is a
    stateless row's call, by token index)."""
    ctx = setup_suite(
        "Hash throughput suite (CUDA kernels + host baselines)",
        default_tokens="words",
        default_warmup=2.0,
        default_time=10.0,
        argv=argv,
    )
    started = time.perf_counter()
    staged = HashBuckets.stage(ctx.tape)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    widths = ", ".join(f"{p.count:,}x{p.width}" for p in staged.buckets)
    ctx.log(f"staged {staged.tokens:,} tokens in {len(staged.buckets)} buckets ({widths}) "
            f"in {time.perf_counter() - started:.2f} s")
    ctx.staged = staged

    ctx.group("stateless")
    bench_device_hashes(ctx, staged)
    host = HostCopy(ctx.tape)
    bench_host_hash(ctx, host, "stateless/xxhash.xxh3_64", lambda: _xxhash().xxh3_64_intdigest)
    bench_host_hash(ctx, host, "stateless/xxhash.xxh64", lambda: _xxhash().xxh64_intdigest)
    bench_host_hash(ctx, host, "stateless/builtins.hash", lambda: hash)

    ctx.group("stateful")
    bench_stateful(ctx, host)

    ctx.group("checksum")
    bench_checksum(ctx, staged, host)

    if get_env_bool("COLLISIONS"):
        report_collisions(staged, host)
    return ctx


if __name__ == "__main__":
    main()
