"""Shared suite scaffolding: arg parsing, tape loading, variant runner.

The per-suite ``main`` composes: parse flags → join the process group the
environment describes (torchrun: one process a device) → pick the device →
load the tape onto it (with stderr stats) → measure the card's roofline →
run groups. The skip-not-crash discipline of the reference holds: a variant
whose setup or any call fails prints ``SKIPPED (<reason>)`` and the suite
moves on (``similarities/bench.py:426-433``). A caller that must not miss a
failure checks the report lines for ``SKIPPED``.

Under a world of N ranks the scopes are this rank's device (``<1gpu>``) and
the world (``<Ngpu>``; ``--chips 1`` keeps the first alone). A variant of
the world's scope runs on every rank, its calls stopping together, and rank
0 reports it; any other variant runs on rank 0 while the others wait at a
barrier. Only rank 0 prints report lines and the stderr log. A failure in a
call of a world variant raises: one rank cannot skip a collective alone.
A world variant's ``make_routine`` runs no collective: the ranks agree on
whether its staging failed before any call, so that they skip together.
The rows that the JAX package does not shard run on ``scopes[0]`` alone.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.parallel.distributed import maybe_initialize
from stringwars_tpu_torch.parallel.mesh import DeviceScope, process_rank, resolve_device, scope_variants
from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.config import (
    add_common_args,
    compile_filter,
    get_env_bool,
    get_env_parsed,
    resolve_tokens,
    should_run,
)
from stringwars_tpu_torch.utils.harness import BenchBudget, WorkUnits, measure_throughput
from stringwars_tpu_torch.utils.profiler import card_identity, measured_roofline
from stringwars_tpu_torch.utils.report import REPORT_NAME_WIDTH, BenchStats, report_skip


class SuiteContext:
    def __init__(
        self,
        args,
        tape: Tape,
        budget: BenchBudget,
        pattern,
        scopes: list[DeviceScope],
        roofline_bytes_per_second: float | None,
    ):
        self.args = args
        self.tape = tape
        self.budget = budget
        self.pattern = pattern
        self.scopes = scopes
        self.roofline_bytes_per_second = roofline_bytes_per_second
        self.staged = None  # a suite's inputs staged once per run, kept for the caller's checks
        self.lead = process_rank() == 0  # this process reports
        self.ranks = dist.get_world_size() if dist.is_initialized() else 1

    @property
    def device(self) -> torch.device:
        return self.scopes[0].device

    def group(self, title: str) -> None:
        if self.lead:
            print(f"# {title}", flush=True)

    def log(self, line: str) -> None:
        """A line of the stderr log (rank 0's)."""
        if self.lead:
            print(line, file=sys.stderr, flush=True)

    def run(
        self,
        name: str,
        unit: str,
        make_routine: Callable[[], Callable[[], WorkUnits]],
        *,
        scope: DeviceScope | None = None,
    ) -> BenchStats | None:
        """Measure one variant under the suite budget; SKIP on failure.

        ``make_routine`` stages the variant and returns its routine; it runs
        only after the filter check, inside the guard, so a staging failure
        skips too. A device variant names its ``scope``: on a card its calls
        are timed with CUDA events and its line gets the "% SoL" column. A
        scope with a process group runs on all its ranks; its
        ``make_routine`` must run no collective (the ranks agree on a
        staging failure before the first call). Returns the statistics on
        the rank that reports, else ``None``.
        """
        device = scope.device if scope is not None else None
        shared = scope is not None and scope.group is not None
        if not shared and self.ranks > 1:
            stats = self._measure(name, unit, make_routine, device, None) if self.lead else None
            dist.barrier()
            return stats
        return self._measure(name, unit, make_routine, device, scope.group if shared else None)

    def _measure(self, name, unit, make_routine, device, group) -> BenchStats | None:
        if not should_run(name, self.pattern):
            self.log(f"{name:<{REPORT_NAME_WIDTH}} SKIPPED (filtered)")
            return None
        try:
            routine, failure = make_routine(), None
        except KeyboardInterrupt:
            report_skip(name, "interrupted by user")
            raise
        except Exception as error:  # noqa: BLE001 — skip-not-crash per suite contract
            routine, failure = None, f"{type(error).__name__}: {error}"
            if get_env_bool("DEBUG_TRACEBACKS"):
                traceback.print_exc()
        if group is not None:  # the ranks skip together when any one failed to stage
            failed = torch.tensor([failure is not None], dtype=torch.int32, device=device)
            dist.all_reduce(failed, op=dist.ReduceOp.MAX, group=group)
            if failed.item() and failure is None:
                failure = "another rank failed to stage the variant"
        if failure is None:
            try:
                stats = measure_throughput(routine, self.budget, device=device, group=group)
            except KeyboardInterrupt:
                report_skip(name, "interrupted by user")
                raise
            except Exception as error:  # noqa: BLE001
                if group is not None:
                    raise
                failure = f"{type(error).__name__}: {error}"
                if get_env_bool("DEBUG_TRACEBACKS"):
                    traceback.print_exc()
        if failure is not None:
            if self.lead:
                report_skip(name, failure)
            return None
        if not self.lead:
            return None
        on_card = device is not None and device.type == "cuda"
        stats.report(name, unit, roofline_bytes_per_second=self.roofline_bytes_per_second if on_card else None)
        return stats


def setup_suite(
    description: str,
    *,
    default_tokens: str,
    default_warmup: float,
    default_time: float,
    default_synthetic: str = "english-words",
    extra_args: Callable[[argparse.ArgumentParser], None] | None = None,
    argv: list[str] | None = None,
) -> SuiteContext:
    parser = argparse.ArgumentParser(description=description)
    add_common_args(parser)
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)

    try:
        maybe_initialize(args.device)
        device = resolve_device(args.device)
    except RuntimeError as error:
        parser.error(str(error))  # exits 2: no card, and the CPU was not asked for
    pattern = compile_filter(args.filter)
    tokens_mode = resolve_tokens(args.tokens, default_tokens)
    tape = datasets.load_tape(
        args.dataset,
        tokens_mode=tokens_mode,
        size_limit=args.dataset_limit,
        default_synthetic=default_synthetic,
        device=device,
    )
    budget = BenchBudget.from_env(default_warmup, default_time).with_overrides(args.warmup, args.time_limit)
    scopes = scope_variants(device)
    chips = args.chips if args.chips is not None else get_env_parsed("CHIPS", None, int)
    if chips is not None and chips > 1 and chips != scopes[-1].gpus:
        parser.error(f"--chips {chips}: the world has {scopes[-1].gpus} rank(s); start {chips} with "
                     f"torchrun --nproc-per-node {chips}")
    if chips == 1:
        scopes = scopes[:1]

    lead = process_rank() == 0
    log = lambda line: lead and print(line, file=sys.stderr, flush=True)  # noqa: E731
    log(f"swtorch: torch {torch.__version__}, CUDA {torch.version.cuda}")
    if device.type == "cuda":
        log(f"device {device}: {card_identity(device)}")
    else:
        log("device cpu (--device cpu): device rows run the plain torch versions")
    roofline = measured_roofline(device)
    if roofline is None:
        log("roofline: not measured (no CUDA device)")
    else:
        log(f"roofline: {roofline / 1e9:.1f} GB/s (bytesum kernel over 256 MB, back-to-back launches)")
    log(f"budget {budget.warmup_seconds}s+{budget.time_seconds}s")
    return SuiteContext(args, tape, budget, pattern, scopes, roofline)
