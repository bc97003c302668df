"""Config / flag system (layer L0).

Environment-first configuration mirrored by argparse flags, with the precedence
CLI flag > env var > per-suite default — the same contract as the reference's
``utils.py:18-63,465-494`` and ``utils.rs:15-50``. Variables are read under the
``SWTPU_*`` prefix first and fall back to the reference's ``STRINGWARS_*``
names so existing run scripts keep working. A copy of the JAX package's
``utils/config.py``, unchanged in behaviour, so the port imports no JAX.

Recognized variables (see SURVEY.md §5 "Config / flag system"):
  SWTPU_DATASET          path to the corpus file
  SWTPU_TOKENS           lines | words | file
  SWTPU_MAX_TOKENS       cap on token count
  SWTPU_UNIQUE           deduplicate tokens (order-preserving)
  SWTPU_FILTER           regex over variant names (substring fallback)
  SWTPU_TIME             measured wall-time budget, fractional seconds
  SWTPU_WARMUP           warm-up budget, fractional seconds (also soaks JIT compile)
  SWTPU_BATCH_PER_CORE   batch items per core (1 device == 1 "core")
  SWTPU_CHIPS            device count override for device-scope sweeps
  SWTPU_COLLISIONS       opt-in hash collision counting
  SWTPU_NDIM / SWTPU_NDIM_SCALES   fingerprint dimensionality sweep
  SWTPU_SEED             RNG seed (default 42)
  SWTPU_ERROR_BOUND      banded edit-distance bound
"""

from __future__ import annotations

import os
import re
from typing import Callable, TypeVar

T = TypeVar("T")

DEVICE_CHOICES = ("cuda", "cpu")  # --device: the card (default) or, when asked, the CPU

_PREFIXES = ("SWTPU_", "STRINGWARS_")


def get_env(name: str) -> str | None:
    """Look up ``name`` under each supported prefix; bare names pass through."""
    if name.startswith(_PREFIXES):
        return os.environ.get(name)
    for prefix in _PREFIXES:
        value = os.environ.get(prefix + name)
        if value is not None:
            return value
    return None


def get_env_or_default(name: str, default: str) -> str:
    value = get_env(name)
    return default if value is None else value


def get_env_parsed(name: str, default: T, parse: Callable[[str], T] | None = None) -> T:
    """Parse an env var with ``type(default)`` (or an explicit ``parse``)."""
    value = get_env(name)
    if value is None:
        return default
    parser = parse if parse is not None else type(default)
    try:
        return parser(value)  # type: ignore[call-arg]
    except (TypeError, ValueError) as error:
        raise ValueError(f"Cannot parse {name}={value!r}: {error}") from error


def get_env_bool(name: str) -> bool:
    """True iff the variable is set to 1/true/yes (case-insensitive)."""
    value = (get_env(name) or "").lower()
    return value in ("1", "true", "yes")


_SIZE_PATTERN = re.compile(r"^(\d+(?:\.\d+)?)\s*(b|kb|mb|gb)?$")
_SIZE_MULTIPLIERS = {None: 1, "b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30}


def parse_size(size_text: str) -> int:
    """Parse a human size string like ``128mb`` / ``1gb`` / ``500kb`` into bytes."""
    if not size_text:
        raise ValueError("Size string cannot be empty")
    match = _SIZE_PATTERN.match(size_text.lower().strip())
    if not match:
        raise ValueError(f"Invalid size format: {size_text!r}; use e.g. '128mb', '1gb', '500kb'")
    number, unit = match.groups()
    return int(float(number) * _SIZE_MULTIPLIERS[unit])


def resolve_tokens(cli_value: str | None, default: str) -> str:
    """Token granularity with the CLI > env > suite-default precedence."""
    if cli_value is not None:
        return cli_value
    return get_env_or_default("TOKENS", default)


def add_common_args(parser) -> None:
    """Attach the flags every suite shares (reference ``utils.py:465-494``)."""
    parser.add_argument(
        "--dataset",
        help="Path to the input corpus file (overrides SWTPU_DATASET)",
    )
    parser.add_argument(
        "--tokens",
        choices=["lines", "words", "file"],
        help="Token granularity (overrides SWTPU_TOKENS)",
    )
    parser.add_argument(
        "-k",
        "--filter",
        metavar="REGEX",
        default=get_env("FILTER"),
        help="Regex selecting which variants run (or set SWTPU_FILTER)",
    )
    parser.add_argument(
        "--time-limit",
        type=float,
        default=None,
        help="Measured seconds per variant (overrides SWTPU_TIME and the suite default)",
    )
    parser.add_argument(
        "--warmup",
        type=float,
        default=None,
        help="Warm-up seconds per variant (overrides SWTPU_WARMUP and the suite default)",
    )
    parser.add_argument(
        "--dataset-limit",
        type=str,
        default="128mb",
        help="Maximum corpus bytes to load, e.g. '1gb', '500mb' (default 128mb)",
    )
    parser.add_argument(
        "--chips",
        type=int,
        default=None,
        help="Ranks of the sharded scope: 1 keeps this process's device alone, more must be the world's "
        "size (start N ranks with torchrun --nproc-per-node N); overrides SWTPU_CHIPS; default: the world",
    )
    parser.add_argument(
        "--device",
        choices=DEVICE_CHOICES,
        default="cuda",
        help="Where the device rows run: the CUDA card (default; an error without one) "
        "or the CPU, through the plain torch versions",
    )


def compile_filter(pattern_text: str | None) -> re.Pattern | None:
    """Compile the variant filter; an invalid regex degrades to a substring match
    (the reference's behavior, ``utils.rs:457-483``)."""
    if not pattern_text:
        return None
    try:
        return re.compile(pattern_text)
    except re.error:
        return re.compile(re.escape(pattern_text))


def should_run(name: str, pattern: re.Pattern | None) -> bool:
    """Whether a variant passes the user's ``-k`` / SWTPU_FILTER selection."""
    return pattern is None or bool(pattern.search(name))
