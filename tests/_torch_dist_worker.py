"""Rank processes for the port's parallel tests: a world of gloo ranks on the CPU.

``World(size, directory)`` starts ``size`` processes (the ``spawn`` method),
each one rank of one gloo process group made through a ``FileStore`` under
``directory`` (no port to race for under parallel test workers), on one
intra-op thread. The ranks also make the sub-groups of their first 2 .. size
- 1 ranks, so that one world serves every world size up to its own.
``world.run(task, *args, ranks=k)`` runs ``TASKS[task](scope, *args)`` on
ranks 0..k-1, ``scope`` being the ``DeviceScope`` of those k ranks, and
returns their results in rank order. The module imports the port and never
``jax``; each rank checks so after every task.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TASK_SECONDS = 240  # a task that takes longer has hung (a rank failed inside a collective)


def _scope(ranks: int, groups: dict):
    from stringwars_tpu_torch.parallel.mesh import DeviceScope

    return DeviceScope(torch.device("cpu"), gpus=ranks, rank=dist.get_rank(), group=groups[ranks])


def _serve(rank: int, size: int, init: str, local_world_size: int | None, inbox, outbox) -> None:
    torch.set_num_threads(1)
    from stringwars_tpu_torch.parallel import distributed

    distributed.initialize("cpu", init_method=init, rank=rank, world_size=size, local_world_size=local_world_size)
    groups = {k: dist.new_group(list(range(k))) for k in range(2, size)}
    groups[size] = dist.group.WORLD
    while True:
        task = inbox.get()
        if task is None:
            break
        name, ranks, args = task
        try:
            result = TASKS[name](_scope(ranks, groups), *args) if rank < ranks else None
            if "jax" in sys.modules:
                raise AssertionError(f"task {name} imported jax")
            outbox.put((rank, None, result))
        except BaseException:  # noqa: BLE001 — reported to the parent, which raises
            outbox.put((rank, traceback.format_exc(), None))
    dist.destroy_process_group()


class World:
    """``size`` gloo ranks on the CPU, serving tasks until ``close``."""

    def __init__(self, size: int, directory: Path, *, local_world_size: int | None = None):
        ctx = mp.get_context("spawn")
        self.size = size
        self.inboxes = [ctx.Queue() for _ in range(size)]
        self.outbox = ctx.Queue()
        init = (Path(directory) / "store").as_uri()
        self.procs = [ctx.Process(target=_serve, args=(r, size, init, local_world_size, self.inboxes[r], self.outbox),
                                  daemon=True) for r in range(size)]
        for proc in self.procs:
            proc.start()

    def run(self, task: str, *args, ranks: int | None = None) -> list:
        ranks = self.size if ranks is None else ranks
        for inbox in self.inboxes:
            inbox.put((task, ranks, args))
        results, errors = [None] * self.size, []
        for _ in range(self.size):
            try:
                rank, error, value = self.outbox.get(timeout=TASK_SECONDS)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"task {task} on {ranks} ranks gave no answer in {TASK_SECONDS} s") from None
            results[rank] = value
            if error:
                errors.append(f"rank {rank}:\n{error}")
        if errors:
            raise AssertionError(f"task {task} on {ranks} ranks failed:\n" + "\n".join(errors))
        return results[:ranks]

    def close(self) -> None:
        for inbox in self.inboxes:
            inbox.put(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)


# ---------------------------------------------------------------------------
# Tasks: each runs on every rank of a scope and returns host values
# ---------------------------------------------------------------------------

def _host(value):
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    return value


def step_task(scope, chips: int | None = None):
    """The sharded step on ``demo_inputs``: this rank's outputs."""
    from stringwars_tpu_torch.parallel.pipeline import demo_inputs, make_sharded_step

    inputs = demo_inputs(scope, chips)
    return _host(make_sharded_step(scope)(inputs)), inputs.bpe_route


def step_arrays_task(scope, hay, corpus, tokens, lengths, needle, patterns):
    """The sharded step on the parent's global arrays: this rank's outputs."""
    from stringwars_tpu_torch.parallel.pipeline import make_sharded_step, stage_inputs

    inputs = stage_inputs(scope, hay, corpus, tokens, lengths, needle=needle, ac_patterns=tuple(patterns))
    return _host(make_sharded_step(scope)(inputs))


def dryrun_task(scope):
    from stringwars_tpu_torch.entry import dryrun_multichip

    return {k: int(v) for k, v in dryrun_multichip(scope.gpus, "cpu").items() if v.dim() == 0}


def seam_counts_task(scope, corpus, needles, patterns):
    """Over the parent's corpus: each needle's sharded (count, last) and
    forward count, the automaton's and each one-pattern set's sharded
    counts (``owned_count``), and the byteset counts of the find suite."""
    from stringwars_tpu_torch.ops import ahocorasick as AC
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import shiftand as SA
    from stringwars_tpu_torch.parallel.sharding import owned_count, psum_scalar, shard_bytes
    from stringwars_tpu_torch.suites import find as FS
    from stringwars_tpu_torch.tape import Tape

    tape = Tape.from_numpy(corpus, np.array([0, corpus.size]))
    forward, backward = FS.make_sharded_find(scope, tape), FS.make_sharded_find(scope, tape, backward=True)
    finds = []
    for needle in needles:
        batch = F.NeedleBatch.from_needles([F.pack_needle(needle, FS.SHARDED_CAP)])
        count, last = backward(batch)
        finds.append((int(forward(batch)[0]), int(count[0]), int(last[0])))
    sets = [AC.Automaton(list(patterns))] + [SA.ShiftAndSet([p]) for p in patterns]
    reach = max(s.max_len for s in sets) - 1
    row, n, chunk = shard_bytes(scope, corpus, overlap=reach)
    counts = []
    for s in sets:
        count = (lambda hay, k, s=s: AC.ac_count_tensor(s, hay, k)) if isinstance(s, AC.Automaton) else (
            lambda hay, k, s=s: SA.shiftand_count_tensor(s, hay, k))
        extent = F.owned_extent(chunk, scope.rank * chunk, n, s.max_len - 1)
        counts.append(int(psum_scalar(owned_count(count, row, chunk, extent), scope)[0]))
    routine, bytesets = FS.sharded_byteset_routine(tape, scope)
    routine()
    return finds, counts, bytesets


def find_rows_task(scope, tokens):
    """The find suite's ``<Ngpu>`` routines over a tape of ``tokens``: the
    results of the forward and backward rows (every needle once), the
    byteset and the aho_corasick rows."""
    from stringwars_tpu_torch.suites import find as FS
    from stringwars_tpu_torch.tape import Tape

    tape = Tape.from_tokens(tokens)
    out = []
    for backward in (False, True):
        routine, results = FS.sharded_substring_routine(tape, scope, backward)
        for _ in FS.sharded_needles(tape):
            routine()
        out.append(results)
    for make in (FS.sharded_byteset_routine, FS.sharded_aho_corasick_routine):
        routine, results = make(tape, scope)
        routine()
        out.append(results)
    return out


def sort_task(scope, tokens, prefix_width: int = 96):
    """``argsort_sharded`` of a tape of ``tokens``, and whether it fell back
    to the one-device sort (a destination overflowed)."""
    from stringwars_tpu_torch.ops import sort as S
    from stringwars_tpu_torch.tape import Tape

    fell_back, one_device = [], S.argsort_tape

    def counted(*args, **kwargs):
        fell_back.append(True)
        return one_device(*args, **kwargs)

    S.argsort_tape = counted
    try:
        order = S.argsort_sharded(Tape.from_tokens(tokens), scope, prefix_width=prefix_width)
    finally:
        S.argsort_tape = one_device
    return order, bool(fell_back)


def scores_task(scope, pairs_a, pairs_b):
    """The similarities suite's sharded scorer: Myers and Gotoh (global and
    local) scores of every pair."""
    from stringwars_tpu_torch.ops import affine as A
    from stringwars_tpu_torch.ops import myers as M
    from stringwars_tpu_torch.ops import similarity as S
    from stringwars_tpu_torch.suites import similarities as SIM

    def aligned(a, b):
        return A.AffineBatch.from_pairs(S.pack_pairs(a, b))

    out = {"myers": SIM.make_sharded_scorer(scope, pairs_a, pairs_b, M.myers_from_tokens, M.myers_distances)()}
    for local in (False, True):
        scorer = SIM.make_sharded_scorer(scope, pairs_a, pairs_b, aligned, lambda staged, local=local: A.affine_scores(
            staged, SIM.MATCH, SIM.MISMATCH, -5, -1, local=local))
        out["sw" if local else "nw"] = scorer()
    return _host(out)


def stage_failure_task(scope, pairs_a, pairs_b, failing_rank: int):
    """The similarities suite's ``device_row`` over ``scope`` where the
    staging of ``failing_rank`` raises, then a row that stages on every
    rank: this rank's report lines and the scores recorded. Every rank must
    return, rank 0 reporting the first row SKIPPED."""
    import contextlib
    import io

    from stringwars_tpu_torch.ops import myers as M
    from stringwars_tpu_torch.suites import similarities as SIM
    from stringwars_tpu_torch.suites._common import SuiteContext
    from stringwars_tpu_torch.utils.harness import BenchBudget, WorkUnits

    ctx = SuiteContext(None, None, BenchBudget(0.0, 0.0), None, [scope], None)
    ctx.staged = {"pairs_a": pairs_a, "pairs_b": pairs_b, "scores": {}}

    def failing(a, b):
        if scope.rank == failing_rank:
            raise RuntimeError(f"rank {scope.rank} cannot stage")
        return M.myers_from_tokens(a, b)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        SIM.device_row(ctx, "uniform/swtorch::levenshtein", "failing", failing, M.myers_distances, WorkUnits(1, 1))
        SIM.device_row(ctx, "uniform/swtorch::levenshtein-after", "after", M.myers_from_tokens, M.myers_distances,
                       WorkUnits(1, 1))
    return out.getvalue(), _host(ctx.staged["scores"])


def shares_task(scope, tokens, data):
    """This rank's shares of the batch-sharded rows: the hash suite's five
    stateless digests, the fingerprints suite's min-hashes (ndim 64) and the
    memory suite's LUT translate and copy."""
    from stringwars_tpu_torch.ops import fingerprint as FP
    from stringwars_tpu_torch.ops import memops as M
    from stringwars_tpu_torch.parallel.sharding import shard_bytes, shard_tokens
    from stringwars_tpu_torch.suites import hash as HS
    from stringwars_tpu_torch.tape import PaddedTokens, Tape

    tape = Tape.from_tokens(tokens)
    out = {op: HS.sharded_spans_call(tape, op, scope) for op in HS.SPANS_ROWS}
    padded = PaddedTokens.from_tape(tape)
    share = PaddedTokens(shard_tokens(scope, padded.data)[0], shard_tokens(scope, padded.lengths)[0], padded.width)
    out["minhash"] = FP.fingerprint(share, ndim=64)[0]
    row = shard_bytes(scope, data)[0]
    out["lut"] = M.lut_translate(row, torch.from_numpy(M.invert_case_lut()))
    out["copy"] = M.copy(row, out=torch.empty_like(row))
    return _host(out)


def hosts_task(scope, n: int, needle: bytes):
    """Two simulated hosts: each rank builds the corpus from ``default_rng(7)``
    but keeps only its ``host_byte_range``, makes its halo row with
    ``shard_bytes_local`` and counts the needle's owned matches; the count
    over the ranks and the scope's name."""
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.parallel import distributed
    from stringwars_tpu_torch.parallel.mesh import world_scope
    from stringwars_tpu_torch.parallel.sharding import psum_scalar

    world = world_scope(scope.device)
    cap = 4
    corpus = np.random.default_rng(7).integers(97, 99, n, dtype=np.uint8)  # a/b soup: many matches
    offset, length, _ = distributed.host_byte_range(n, world, overlap=8 * cap)
    local = corpus[offset : offset + length].copy()
    del corpus
    row, n_glob, chunk = distributed.shard_bytes_local(world, local, n, overlap=8 * cap)
    batch = F.NeedleBatch.from_needles([F.pack_needle(needle, cap)])
    count = F.find_counts_owned(row, batch, chunk, world.rank * chunk, n_glob)
    return int(psum_scalar(count, world)[0]), world.name, length


def suite_task(scope, module: str, argv: list[str]):
    """A suite's ``main`` in the world: rank 0's report lines and staged
    results (the others' are empty)."""
    import contextlib
    import importlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = importlib.import_module(f"stringwars_tpu_torch.suites.{module}").main(argv)
    return out.getvalue(), [s.name for s in ctx.scopes], _host(ctx.staged) if module == "scaling" else None


def scopes_task(scope):
    """``scope_variants`` of this rank: the names."""
    from stringwars_tpu_torch.parallel.mesh import scope_variants

    return [s.name for s in scope_variants(scope.device)], scope.name


TASKS = {
    "step": step_task,
    "step_arrays": step_arrays_task,
    "dryrun": dryrun_task,
    "seam_counts": seam_counts_task,
    "find_rows": find_rows_task,
    "sort": sort_task,
    "scores": scores_task,
    "stage_failure": stage_failure_task,
    "shares": shares_task,
    "hosts": hosts_task,
    "suite": suite_task,
    "scopes": scopes_task,
}
