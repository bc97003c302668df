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
versions. Not ported yet: the sharded ``<Ngpu>`` rows.
"""

from __future__ import annotations

import math
import sys

from stringwars_tpu_torch.ops import affine as A
from stringwars_tpu_torch.ops import myers as M
from stringwars_tpu_torch.ops import similarity as S
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


def device_row(ctx: SuiteContext, name: str, key: str, stage, call) -> None:
    """One device row per scope: ``stage()`` returns (staged inputs, work
    units) once per run; each measured call is ``call(staged)``. The scores
    of one call go to ``ctx.staged["scores"][key]`` on the host."""
    for scope in ctx.scopes:

        def factory():
            staged, units = stage()
            ctx.staged["scores"][key] = call(staged).cpu().numpy()
            return lambda: (call(staged), units)[1]

        ctx.run(f"{name}{scope.name}", "cups", factory, device=scope.device)


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
        lambda: (M.myers_from_tokens(pairs_a, pairs_b, device=ctx.device), units),
        M.myers_distances,
    )

    def stage_utf8():
        a_cps = [S.decode_codepoints(t) for t in pairs_a]
        b_cps = [S.decode_codepoints(t) for t in pairs_b]
        staged = M.myers_from_codepoints(a_cps, b_cps, device=ctx.device)
        return staged, WorkUnits(staged.cells(), total_bytes)

    device_row(ctx, "uniform-utf8/swtorch::levenshtein", "levenshtein_utf8", stage_utf8, M.myers_distances)

    band = int(get_env_parsed("ERROR_BOUND", 0))
    if band > 0:
        device_row(
            ctx, f"uniform-banded{band}/swtorch::levenshtein", "levenshtein_banded",
            lambda: (batch, units),
            lambda staged: S.levenshtein_banded(staged, band),
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

    aligned = A.AffineBatch.from_pairs(batch)  # staged once for the four alignment rows
    current = None
    for group, function, go, ge, local in ALIGNMENTS:
        if group != current:
            ctx.group(group)
            current = group
        device_row(
            ctx, f"{group}/swtorch::{function}", f"{'sw' if local else 'nw'}_{group}",
            lambda: (aligned, units),
            lambda staged, go=go, ge=ge, local=local: A.affine_scores(staged, MATCH, MISMATCH, go, ge, local=local),
        )
    return ctx


if __name__ == "__main__":
    main()
