"""Similarities suite: uniform / linear / affine gap-cost groups over dense
query x candidate cross-products (reference ``similarities/bench.rs:269-1026``,
defaults 5 s + 30 s, lines tokens of ``synthetic:dna-100b``).

The port of ``stringwars_tpu.suites.similarities`` for one device. The
workload mirrors the reference: ``side = round(sqrt(batch))`` queries vs
candidates from disjoint token slices, every (q, c) pair scored per call,
CUPS = sum(|q|) * sum(|c|) cells per pass (``similarities/bench.rs:113-118,
216-224``). Rows:

- ``uniform/swtorch::levenshtein<1gpu>``: the bit-parallel Myers kernel
  (``ops/myers.py``) over bytes;
- ``uniform-utf8/swtorch::levenshtein<1gpu>``: the same kernel over decoded
  codepoints (``LevenshteinDistancesUtf8``, ``similarities/bench.rs:230-247``;
  cells are codepoint cells);
- ``uniform-banded{b}/swtorch::levenshtein<1gpu>`` when ``SWTPU_ERROR_BOUND``
  is set (reference ``STRINGWARS_ERROR_BOUND``): the banded wavefront of
  ``ops/similarity.py``, plain torch on the card (no kernel in either package);
- ``uniform/python-dp-diagonal``: the host DP on the diagonal pairs;
- ``linear/`` and ``affine/swtorch::{needleman_wunsch,smith_waterman}<1gpu>``:
  the alignment kernel (``ops/affine.py``), linear (2/-1, gap -2) and Gotoh
  (2/-1, open -5, extend -1) bodies.

Each device row stages its pairs once per run and calls its kernel per
measured call; with ``--device cpu`` the rows (``<1cpu>``) run the plain
versions. Under a world of N ranks (torchrun) each device row also runs
sharded (``<Ngpu>``, ``make_sharded_scorer``): the pair batch padded with
empty pairs to a multiple of the ranks, each rank scoring its share by the
same kernel, the scores all-gathered; the work units are the whole batch's.
"""

from __future__ import annotations

import math
import sys

from stringwars_tpu_torch.ops import affine as A
from stringwars_tpu_torch.ops import myers as M
from stringwars_tpu_torch.ops import similarity as S
from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.parallel.sharding import all_gather_tokens
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.utils.config import get_env_parsed
from stringwars_tpu_torch.utils.harness import WorkUnits
from stringwars_tpu_torch.utils.report import report_skip

# (group, reference function, gap_open, gap_extend, local) of the alignment rows.
ALIGNMENTS = (
    ("linear", "needleman_wunsch", -2, -2, False),
    ("linear", "smith_waterman", -2, -2, True),
    ("affine", "needleman_wunsch", -5, -1, False),
    ("affine", "smith_waterman", -5, -1, True),
)
MATCH, MISMATCH = 2, -1


def build_crossproduct(ctx, max_side: int = 64, max_len: int = 256):
    """(batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b)
    of the suite's cross-product; the batch lies on the context's device."""
    tokens = [t for t in ctx.tape.to_list() if t][: 2 * max_side * max_side]
    tokens = [t[:max_len] for t in tokens]
    side = int(math.sqrt(max(len(tokens) // 2, 1)))
    side = min(side, max_side)
    if side < 1:
        raise ValueError("not enough tokens for a cross-product")
    queries = tokens[:side]
    candidates = tokens[side : 2 * side]
    pairs_a, pairs_b = [], []
    for q in queries:
        for c in candidates:
            pairs_a.append(q)
            pairs_b.append(c)
    batch = S.pack_pairs(pairs_a, pairs_b, device=ctx.device)
    cells = sum(len(q) for q in queries) * sum(len(c) for c in candidates)
    total_bytes = sum(map(len, pairs_a)) + sum(map(len, pairs_b))
    return batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b


def shard_pairs(scope: DeviceScope, pairs_a: list[bytes], pairs_b: list[bytes]) -> tuple[list[bytes], list[bytes]]:
    """This rank's share of the pairs, the batch padded with empty pairs
    (which score 0 in every row) to a multiple of the scope's ranks."""
    per = -(-len(pairs_a) // scope.gpus)
    lo = scope.rank * per
    a, b = pairs_a[lo : lo + per], pairs_b[lo : lo + per]
    pad = [b""] * (per - len(a))
    return a + pad, b + pad


def make_sharded_scorer(scope: DeviceScope, pairs_a: list[bytes], pairs_b: list[bytes], stage, call):
    """``scorer()``: every pair's score on every rank of ``scope``, each rank
    scoring its share (``stage(a, b)``, then ``call(staged)`` per call) and
    the shares all-gathered in rank order."""
    staged = stage(*shard_pairs(scope, pairs_a, pairs_b))
    n = len(pairs_a)
    return lambda: all_gather_tokens(call(staged), scope)[:n]


def device_row(ctx: SuiteContext, name: str, key: str, stage, call, units: WorkUnits) -> None:
    """One device row per scope: ``stage(pairs_a, pairs_b)`` returns the
    staged inputs once per run; each measured call is ``call(staged)``, or
    on a sharded scope the scores of every rank's share. The scores of the
    first call (a warm-up call) go to ``ctx.staged["scores"][key]`` on the
    host (the sharded scope's to ``key + scope.name``). The factory stages
    but scores nothing: a sharded score is an all-gather, which must not
    run before the ranks have agreed that every one staged its share."""
    pairs_a, pairs_b = ctx.staged["pairs_a"], ctx.staged["pairs_b"]
    scores = ctx.staged["scores"]
    for scope in ctx.scopes:

        def factory(scope=scope):
            if scope.group is None:
                staged = stage(pairs_a, pairs_b)
                score, slot = (lambda: call(staged)), key
            else:
                score, slot = make_sharded_scorer(scope, pairs_a, pairs_b, stage, call), key + scope.name

            def routine() -> WorkUnits:
                got = score()
                if slot not in scores:
                    scores[slot] = got.cpu().numpy()
                return units

            return routine

        ctx.run(f"{name}{scope.name}", "cups", factory, scope=scope)


def main(argv: list[str] | None = None) -> SuiteContext:
    """Run the suite; returns its context, whose ``staged`` holds the pairs
    (``pairs_a``, ``pairs_b``, ``batch``) and, per row key, the scores of
    one call (``scores``)."""
    ctx = setup_suite(
        "Edit distances / alignment scores (Myers and alignment kernels)",
        default_tokens="lines",
        default_warmup=5.0,
        default_time=30.0,
        default_synthetic="dna-100b",
        argv=argv,
    )
    try:
        batch, cells, total_bytes, queries, candidates, pairs_a, pairs_b = build_crossproduct(ctx)
    except ValueError as error:
        report_skip("similarities/*", str(error))
        return ctx
    print(
        f"cross-product {len(queries)}x{len(candidates)} pairs, width {batch.width}, {cells:,} cells/pass",
        file=sys.stderr,
        flush=True,
    )
    ctx.staged = {"pairs_a": pairs_a, "pairs_b": pairs_b, "batch": batch, "scores": {}}
    units = WorkUnits(cells, total_bytes)

    ctx.group("uniform")
    device_row(
        ctx, "uniform/swtorch::levenshtein", "levenshtein",
        lambda a, b: M.myers_from_tokens(a, b, device=ctx.device), M.myers_distances, units,
    )

    def stage_utf8(a, b):
        return M.myers_from_codepoints([S.decode_codepoints(t) for t in a], [S.decode_codepoints(t) for t in b],
                                       device=ctx.device)

    cp_cells = sum(len(S.decode_codepoints(a)) * len(S.decode_codepoints(b)) for a, b in zip(pairs_a, pairs_b))
    device_row(ctx, "uniform-utf8/swtorch::levenshtein", "levenshtein_utf8", stage_utf8, M.myers_distances,
               WorkUnits(cp_cells, total_bytes))

    band = int(get_env_parsed("ERROR_BOUND", 0))
    if band > 0:
        device_row(
            ctx, f"uniform-banded{band}/swtorch::levenshtein", "levenshtein_banded",
            lambda a, b: S.pack_pairs(a, b, device=ctx.device),
            lambda staged: S.levenshtein_banded(staged, band), units,
        )

    # Host baseline: the DP on the diagonal pairs only (reference baselines
    # run one pair per call on the diagonal, similarities/bench.rs:746-753).
    diag = list(zip(queries, candidates))
    diag_units = WorkUnits(sum(len(q) * len(c) for q, c in diag), sum(len(q) + len(c) for q, c in diag))

    def host_routine() -> WorkUnits:
        for q, c in diag:
            S.levenshtein_ref(q, c)
        return diag_units

    ctx.run("uniform/python-dp-diagonal", "cups", lambda: host_routine)

    aligned = A.AffineBatch.from_pairs(batch)  # the whole batch, staged once for the four alignment rows

    def stage_aligned(a, b):
        return aligned if a is pairs_a else A.AffineBatch.from_pairs(S.pack_pairs(a, b, device=ctx.device))

    current = None
    for group, function, go, ge, local in ALIGNMENTS:
        if group != current:
            ctx.group(group)
            current = group
        device_row(
            ctx, f"{group}/swtorch::{function}", f"{'sw' if local else 'nw'}_{group}", stage_aligned,
            lambda staged, go=go, ge=ge, local=local: A.affine_scores(staged, MATCH, MISMATCH, go, ge, local=local),
            units,
        )
    return ctx


if __name__ == "__main__":
    main()
