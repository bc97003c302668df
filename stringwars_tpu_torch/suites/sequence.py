"""Sequence suite: stable argsort, byte order and case-folded order
(reference ``sequence/bench.rs``, defaults 5 s + 10 s, words tokens; work
n·log2(n) comparisons, ``sequence/bench.rs:79``).

The port of ``stringwars_tpu.suites.sequence`` for one device. The full
pipeline (the 96-byte prefix sorted on the device, the host tie refinement,
the caller-owned ``out=`` buffer) runs once as a check; the device rows
time what the JAX rows time:

- ``argsort/swtorch::argsort<1gpu>``: the staged key columns
  (``ops/sort.byte_columns`` of the 96-byte prefix rows) to the permutation
  (``ops/sort.lsd_argsort``: the radix kernel on a card);
- ``argsort-uncased/swtorch::argsort_uncased<1gpu>``: the staged prefix
  rows (clamped to UTF-8 boundaries) to their case-folded key columns and
  the sort (``ops/sort.uncased_order``: on a card the uncased keys kernel
  and the radix kernel), packed three codepoints a column only when the
  corpus' folded ceiling is at most 509, as ``argsort_uncased`` decides
  (the JAX row packs three whatever the corpus, which orders codepoints
  above 509 wrongly).

Under a world of N ranks (torchrun) the byte-order row also runs sharded
(``argsort/swtorch::argsort<Ngpu>``): the whole ``ops/sort.argsort_sharded``
with a 96-byte prefix, the sample sort over the ranks (the radix kernel
sorting what each rank receives) and the host tie refinement, as the JAX
row times it. With ``--device cpu`` the rows (``<1cpu>``) run the plain
versions. The host rows sort the tokens with ``sorted``, ``numpy.argsort``
(stable) and ``sorted(key=str.casefold)``.
"""

from __future__ import annotations

import math

import numpy as np

from stringwars_tpu_torch.ops import sort as S
from stringwars_tpu_torch.suites._common import setup_suite
from stringwars_tpu_torch.tape import PaddedTokens
from stringwars_tpu_torch.utils.harness import WorkUnits


def main(argv: list[str] | None = None):
    """Run the suite; returns its context, whose ``staged`` holds the full
    pipeline's order (``order``), the byte row's key columns (``columns``),
    the uncased row's rows, key lengths and plan (``uncased``:
    ``(data, key_lengths, n_cols, pack3)``) and its last call's order
    (``uncased_order``)."""
    ctx = setup_suite(
        "Stable string argsort throughput",
        default_tokens="words",
        default_warmup=5.0,
        default_time=10.0,
        argv=argv,
    )
    tape = ctx.tape
    count = tape.count
    comparisons = int(count * math.log2(max(count, 2)))
    units = WorkUnits(elements=comparisons, bytes=tape.total_bytes)

    ctx.group("argsort")
    out_buf = np.empty(count, dtype=np.intp)
    S.argsort_tape(tape, prefix_width=S.PREFIX_WIDTH, out=out_buf)
    tokens = PaddedTokens.from_tape(tape, align=4, max_width=S.PREFIX_WIDTH)
    columns = S.byte_columns(tokens.data, tokens.lengths)
    ctx.staged = {"order": out_buf, "columns": columns}
    for scope in ctx.scopes:
        if scope.group is None:
            call = lambda: S.lsd_argsort(columns)  # noqa: E731
        else:
            call = lambda scope=scope: S.argsort_sharded(tape, scope, prefix_width=S.PREFIX_WIDTH, out=out_buf)  # noqa: E731
        ctx.run(f"argsort/swtorch::argsort{scope.name}", "comparisons", lambda call=call: lambda: (call(), units)[1],
                scope=scope)

    def host_sorted():
        token_list = tape.to_list()
        return lambda: (sorted(range(len(token_list)), key=token_list.__getitem__), units)[1]

    ctx.run("argsort/sorted-key", "comparisons", host_sorted)

    def host_numpy():
        arr = np.array(tape.to_list(), dtype=object)
        return lambda: (np.argsort(arr, kind="stable"), units)[1]

    ctx.run("argsort/numpy.argsort", "comparisons", host_numpy)

    ctx.group("argsort-uncased")
    rows, key_lengths, _ = S.stage_uncased(tape)
    n_cols, pack3 = S.uncased_plan(rows.data, key_lengths)
    ctx.staged["uncased"] = (rows.data, key_lengths, n_cols, pack3)

    def uncased_call() -> WorkUnits:
        ctx.staged["uncased_order"] = S.uncased_order(rows.data, key_lengths, n_cols, pack3)
        return units

    scope = ctx.scopes[0]
    ctx.run(f"argsort-uncased/swtorch::argsort_uncased{scope.name}", "comparisons", lambda: uncased_call,
            scope=scope)

    def host_uncased():
        token_list = tape.to_list()
        return lambda: (sorted(token_list, key=lambda b: b.decode("utf-8", "ignore").casefold()), units)[1]

    ctx.run("argsort-uncased/sorted-casefold", "comparisons", host_uncased)
    return ctx


if __name__ == "__main__":
    main()
