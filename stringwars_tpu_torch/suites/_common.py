"""Shared suite scaffolding: arg parsing, tape loading, variant runner.

The per-suite ``main`` composes: parse flags → pick the device → load the
tape onto it (with stderr stats) → measure the card's roofline → run
groups. The skip-not-crash discipline of the reference holds: a variant
whose setup or any call fails prints ``SKIPPED (<reason>)`` and the suite
moves on (``similarities/bench.py:426-433``). A caller that must not miss a
failure checks the report lines for ``SKIPPED``.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable

import torch

from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.parallel.mesh import DeviceScope, resolve_device, scope_variants
from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.config import add_common_args, compile_filter, get_env_bool, resolve_tokens, should_run
from stringwars_tpu_torch.utils.harness import BenchBudget, WorkUnits, measure_throughput
from stringwars_tpu_torch.utils.profiler import card_identity, measured_roofline
from stringwars_tpu_torch.utils.report import REPORT_NAME_WIDTH, report_skip


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

    @property
    def device(self) -> torch.device:
        return self.scopes[0].device

    def group(self, title: str) -> None:
        print(f"# {title}", flush=True)

    def run(
        self,
        name: str,
        unit: str,
        make_routine: Callable[[], Callable[[], WorkUnits]],
        *,
        device: torch.device | None = None,
    ) -> None:
        """Measure one variant under the suite budget; SKIP on failure.

        ``make_routine`` stages the variant and returns its routine; it runs
        only after the filter check, inside the guard, so a staging failure
        skips too. A device variant names its ``device``: on a card its calls
        are timed with CUDA events and its line gets the "% SoL" column.
        """
        if not should_run(name, self.pattern):
            print(f"{name:<{REPORT_NAME_WIDTH}} SKIPPED (filtered)", file=sys.stderr, flush=True)
            return
        try:
            stats = measure_throughput(make_routine(), self.budget, device=device)
        except KeyboardInterrupt:
            report_skip(name, "interrupted by user")
            raise
        except Exception as error:  # noqa: BLE001 — skip-not-crash per suite contract
            report_skip(name, f"{type(error).__name__}: {error}")
            if get_env_bool("DEBUG_TRACEBACKS"):
                traceback.print_exc()
            return
        on_card = device is not None and device.type == "cuda"
        stats.report(name, unit, roofline_bytes_per_second=self.roofline_bytes_per_second if on_card else None)


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
    if args.chips is not None and args.chips > 1:
        print("# --chips > 1: multi-device scopes are not ported yet; running one device", file=sys.stderr)
    scopes = scope_variants(device)

    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
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
