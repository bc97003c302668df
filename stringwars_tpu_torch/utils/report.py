"""Reporting (layer L3): one canonical, column-aligned line per variant.

Layout-compatible with the reference's reporters (``utils.rs:623-714``,
``utils.py:243-336``) so outputs diff cleanly against StringWars runs: a
42-character left-aligned variant-name column, then columns joined by
``" | "`` in fixed order — primary rate, bytes/s (when distinct), latency
percentiles. The reference's Rust-only cyc/B and IPC columns are replaced by
an optional percent-of-roofline column (achieved bytes/s against the card's
own measured bytesum rate, ``utils/profiler.measured_roofline``); columns
that cannot be computed are omitted, never reformatted.

A copy of the JAX package's ``utils/report.py``: the line format is the
contract both packages print, and the tests hold the two equal.

The *format* (units, SI thresholds, 2-decimal precision, column order) is
the compatibility contract; the implementation is table-driven rather than
an if-chain: one prefix ladder drives all SI scaling, one unit-spec table
maps ``ReportAs`` names to their suffix and spacing, and one duration
ladder renders latencies.
"""

from __future__ import annotations

import dataclasses

REPORT_NAME_WIDTH = 42

# (threshold, divisor, metric prefix) — walked top-down; sub-kilo rates
# print unprefixed. Decimal SI, matching the reference's thresholds.
_SI_LADDER = ((1e9, "G"), (1e6, "M"), (1e3, "k"))

# Primary-unit registry: ReportAs name -> (numerator, suffix, spaced).
# ``numerator`` picks which WorkUnits field the rate divides;
# ``spaced`` inserts a space between prefix and a word-like suffix
# ("1.24 G hashes/s") but not a symbol-like one ("1.24 GCUPS").
_UNIT_SPECS: dict[str, tuple[str, str, bool]] = {
    "bytes": ("bytes", "B/s", False),
    "cups": ("elements", "CUPS", False),
    "hashes": ("elements", "hashes/s", True),
    "bits": ("elements", "bits/s", True),
    "comparisons": ("elements", "cmp/s", True),
    "keys": ("elements", "keys/s", True),
}

REPORT_UNITS = tuple(_UNIT_SPECS)

# (upper bound in seconds, multiplier, unit) for duration rendering.
_DURATION_LADDER = ((1e-6, 1e9, "ns"), (1e-3, 1e6, "µs"), (1.0, 1e3, "ms"))


def scale_si(value: float) -> tuple[float, str]:
    """Scale to a metric prefix (G/M/k): returns (scaled, prefix)."""
    for threshold, prefix in _SI_LADDER:
        if value >= threshold:
            return value / threshold, prefix
    return value, ""


def _render_rate(rate: float, suffix: str, spaced: bool) -> str:
    scaled, prefix = scale_si(rate)
    joint = " " if (spaced and prefix) else ""
    return f"{scaled:.2f} {prefix}{joint}{suffix}"


def format_byte_rate(bytes_per_second: float) -> str:
    return _render_rate(bytes_per_second, "B/s", False)


def format_si_rate(rate: float, unit: str, space_before_unit: bool) -> str:
    return _render_rate(rate, unit, space_before_unit)


def format_seconds(seconds: float) -> str:
    for bound, multiplier, unit in _DURATION_LADDER:
        if seconds < bound:
            return f"{seconds * multiplier:.2f} {unit}"
    return f"{seconds:.2f} s"


def latency_percentile(samples: list[float], fraction: float) -> float:
    """Nearest-rank-by-rounding percentile over raw (unsorted) samples —
    the same estimator both reference harnesses use, shared here between
    ``BenchStats`` and the line formatter instead of being re-nested."""
    ordered = sorted(samples)
    rank = min(round(fraction * (len(ordered) - 1)), len(ordered) - 1)
    return ordered[rank]


@dataclasses.dataclass(frozen=True)
class BenchStats:
    """Raw measurements for one variant, as produced by ``measure_throughput``."""

    elapsed_seconds: float
    elements: int
    bytes: int
    latencies_seconds: list[float] | None = None

    @property
    def bytes_per_second(self) -> float:
        return self.bytes / max(self.elapsed_seconds, 1e-12)

    @property
    def elements_per_second(self) -> float:
        return self.elements / max(self.elapsed_seconds, 1e-12)

    def latency_quantile(self, fraction: float) -> float | None:
        if not self.latencies_seconds:
            return None
        return latency_percentile(self.latencies_seconds, fraction)

    def report(self, name: str, unit: str = "bytes", *, roofline_bytes_per_second: float | None = None) -> str:
        """Print and return the canonical result line for this variant."""
        line = format_report_line(
            name,
            unit,
            self.elapsed_seconds,
            self.elements,
            self.bytes,
            self.latencies_seconds,
            roofline_bytes_per_second=roofline_bytes_per_second,
        )
        print(line, flush=True)
        return line


def format_report_line(
    name: str,
    unit: str,
    elapsed_seconds: float,
    elements: int,
    total_bytes: int,
    latencies_seconds: list[float] | None = None,
    *,
    roofline_bytes_per_second: float | None = None,
) -> str:
    try:
        numerator, suffix, spaced = _UNIT_SPECS[unit]
    except KeyError:
        raise ValueError(f"Unknown report unit: {unit!r}") from None

    seconds = max(elapsed_seconds, 1e-12)
    rates = {"elements": elements / seconds, "bytes": total_bytes / seconds}

    columns = [_render_rate(rates[numerator], suffix, spaced)]
    if unit != "bytes" and total_bytes > 0:
        columns.append(format_byte_rate(rates["bytes"]))
    if roofline_bytes_per_second:
        columns.append(f"{100.0 * rates['bytes'] / roofline_bytes_per_second:.1f}% SoL")
    if latencies_seconds:
        p50, p99 = (latency_percentile(latencies_seconds, f) for f in (0.5, 0.99))
        columns.append(f"p50 {format_seconds(p50)} p99 {format_seconds(p99)}")

    return f"{name:<{REPORT_NAME_WIDTH}} {' | '.join(columns)}"


def report_stats(
    name: str,
    unit: str,
    elapsed_seconds: float,
    elements: int,
    total_bytes: int,
    latencies_seconds: list[float] | None = None,
) -> None:
    """Functional reporter mirroring the reference's ``report_stats`` signature."""
    print(
        format_report_line(name, unit, elapsed_seconds, elements, total_bytes, latencies_seconds),
        flush=True,
    )


def report_skip(name: str, reason: str) -> None:
    """The skip-not-crash line (reference ``similarities/bench.rs:632-636``)."""
    print(f"{name:<{REPORT_NAME_WIDTH}} SKIPPED ({reason})", flush=True)
