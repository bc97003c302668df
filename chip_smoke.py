"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero and prints no result:

1. device: a CUDA device must be present (its name, ``nvidia-smi``'s name and
   power limit, the torch and CUDA versions);
2. build: the CUDA kernels from ``stringwars_tpu_torch/csrc`` (first use);
3. kernels: each kernel against its plain torch version on the card, exact;
4. main path: ``stringwars_tpu_torch.suites.find.main`` on the default
   128 MB ``synthetic:english-words`` corpus in words mode; every
   ``swtorch::`` row must report, every kernel must have launched in that
   run, and the suite's first forward counts must equal a pure-Python
   overlapping ``bytes.find`` loop;
5. rows: the headline rows, each kernel timed with CUDA events (median of
   5 runs of back-to-back calls, after warm-up) beside its plain version on
   the card.

The line before last is a JSON object of the kernels (launches in the main
path, max |kernel - plain| over every comparison, ms and plain ms); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import time

import numpy as np
import torch

SAMPLES = 5  # timed samples per row, after WARM calls
WARM = 2


def phase(name: str, detail: str) -> None:
    print(f"[{name}] {detail}", flush=True)


def time_ms(fn) -> float:
    """Device time of one call of ``fn``: CUDA events around a run of k
    back-to-back calls (k fills ~20 ms, at most 50), the median of 5 runs."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    k = max(1, min(50, int(20.0 / max(start.elapsed_time(end), 1e-3))))
    samples = []
    for _ in range(SAMPLES):
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / k)
    return statistics.median(samples)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def lowercase(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(97, 123, (n,), dtype=torch.uint8, device=dev, generator=g)


def random_bytes(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=g)


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from stringwars_tpu_torch import build
    from stringwars_tpu_torch.ops import bytesum as B
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC
    from stringwars_tpu_torch.suites import find as suite
    from stringwars_tpu_torch.utils.profiler import card_identity

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card_identity(dev)  # `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(smi, flush=True)

    # -- 2. build -------------------------------------------------------------
    started = time.perf_counter()
    build.library()
    log = build.library_path().with_suffix(".log")
    usage = [line.split(":", 1)[1].strip() for line in log.read_text().splitlines() if "registers" in line] if log.exists() else []
    phase("build", f"{time.perf_counter() - started:.1f} s; ptxas: {' | '.join(usage) or 'library already built'}")

    # -- 3. kernels against their plain versions ------------------------------
    errors = {"bytesum": 0, "find_count": 0, "rfind_count": 0, "byteset_count": 0}
    before = {**B.LAUNCHES, **FC.LAUNCHES}
    rng = np.random.default_rng(1)
    n = 64 << 20
    hay = lowercase(n, 1, dev)
    hay[1000:1064] = ord("a")  # a run: overlapping matches of a*m

    def planted(m: int, count: int) -> list[bytes]:
        needles = [bytes(rng.integers(97, 123, m, dtype=np.uint8)) for _ in range(count)]
        for i, nd in enumerate(needles):
            spots = list(rng.integers(0, n - m, 3)) + ([0] if i == 0 else []) + ([n - 3 - m] if i == 1 else [])
            for p in spots:
                hay[p : p + m] = torch.frombuffer(bytearray(nd), dtype=torch.uint8).to(dev)
        return needles

    sets = {
        "8B": planted(8, 64),
        "16B": planted(16, 64),
        "long": planted(600, 1) + planted(2000, 1),
        "short": [b"e", b"th", b"abc", b"aaaa"],
    }
    checked = 0
    for needles in sets.values():
        batch = F.NeedleBatch.from_needles([F.pack_needle(t, suite._needle_cap(t)) for t in needles], dev)
        for extent in (n, n - 3):
            counts = FC.find_count_batch(hay, batch, extent)
            errors["find_count"] = max(errors["find_count"], max_err(counts, F.find_count_batch_plain(hay, batch, extent)))
            got = FC.rfind_count_batch(hay, batch, extent)
            want = F.rfind_count_batch_plain(hay, batch, extent)
            errors["rfind_count"] = max(errors["rfind_count"], max_err(got[0], want[0]), max_err(got[1], want[1]))
            checked += batch.size
        single = F.NeedleBatch(batch.images[:1], batch.lengths[:1], batch.host_lengths[:1])
        errors["find_count"] = max(errors["find_count"], max_err(FC.find_count_batch(hay, single), F.find_count_batch_plain(hay, single)))
    bytes_hay = random_bytes(n + 16, 2, dev)
    for charset in suite.BYTESETS.values():
        table = F.pack_byteset(charset, dev)
        for offset, extent in ((0, n), (3, n - 5)):
            view = bytes_hay[offset:]
            errors["byteset_count"] = max(
                errors["byteset_count"], max_err(FC.byteset_count(view, table, extent), F.byteset_count_plain(view, table, extent))
            )
    big = random_bytes(256 << 20, 3, dev)
    ones = torch.full((256 << 20,), 0xFF, dtype=torch.uint8, device=dev)
    for data in (big, ones, big[5:], big[: (1 << 20) + 7]):
        errors["bytesum"] = max(errors["bytesum"], max_err(B.bytesum_cuda(data), B.bytesum_plain(data)))
    if int(B.bytesum_cuda(ones).item()) != 255 * ones.numel():
        raise AssertionError("bytesum of 256 MB of 0xFF is not 255 * n")
    torch.cuda.synchronize()
    advanced = {k: v - before[k] for k, v in {**B.LAUNCHES, **FC.LAUNCHES}.items()}
    if any(errors.values()) or not all(advanced.values()):
        raise AssertionError(f"kernels disagree with their plain versions or did not launch: {errors}, {advanced}")
    phase("kernels", f"equal to plain on the card ({checked} needle scans, 3 sets, 4 bytesums); launches {advanced}")
    del hay, bytes_hay, big, ones

    # -- 4. the main path -----------------------------------------------------
    for counter in (B.LAUNCHES, FC.LAUNCHES):
        for key in counter:
            counter[key] = 0
    out = io.StringIO()
    started = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ctx = suite.main(["--dataset-limit", "128mb", "--warmup", "0.5", "--time-limit", "2"])
    torch.cuda.synchronize()
    launches = {**B.LAUNCHES, **FC.LAUNCHES}
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    rows = {
        "substring-forward/swtorch::find_count<1gpu>",
        "substring-backward/swtorch::rfind_count<1gpu>",
        "byteset-forward/swtorch::byteset_count<1gpu>",
    }
    for row in rows:
        hits = [line for line in lines if line.startswith(row + " ")]
        if len(hits) != 1 or "SKIPPED" in hits[0]:
            raise AssertionError(f"main path row missing or skipped: {row}: {hits}")
    if any("swtorch::" in line and "SKIPPED" in line for line in lines):
        raise AssertionError("a swtorch:: row was skipped")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if ctx.tape.device.type != "cuda" or ctx.tape.total_bytes < 100 << 20:
        raise AssertionError(f"the main path ran on {ctx.tape.device} over {ctx.tape.total_bytes} bytes")
    routine, results = suite.forward_routine(ctx.tape)
    routine()
    _, panel, _ = suite.suite_needles(ctx.tape)
    hay_b = ctx.tape.data.cpu().numpy().tobytes()
    for needle in panel[:8]:
        count, pos = 0, hay_b.find(needle)
        while pos >= 0:
            count += 1
            pos = hay_b.find(needle, pos + 1)
        if results[needle] != count:
            raise AssertionError(f"forward count of {needle!r}: suite {results[needle]}, bytes.find loop {count}")
    phase(
        "main path",
        f"{ctx.tape.total_bytes:,} B of {ctx.tape.count:,} words on {ctx.tape.device} in "
        f"{time.perf_counter() - started:.1f} s; launches {launches}; first 8 forward counts "
        f"{[results[t] for t in panel[:8]]} equal the bytes.find loop",
    )
    del ctx, hay_b

    # -- 5. rows: kernel beside plain, on the card ----------------------------
    flat = lowercase(128 << 20, 0, dev)
    timings = {}

    def row(name: str, kernel, plain, work_bytes: int, key: str | None = None) -> None:
        got, want = kernel(), plain()
        err = max(max_err(a, b) for a, b in zip(got, want)) if isinstance(got, tuple) else max_err(got, want)
        if err:
            raise AssertionError(f"{name}: kernel and plain differ by {err}")
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        if key:
            timings[key] = (ms, plain_ms)
        phase(
            "row",
            f"{name}: kernel {ms:.4f} ms ({work_bytes / ms / 1e6:.1f} GB/s), "
            f"plain {plain_ms:.4f} ms ({work_bytes / plain_ms / 1e6:.1f} GB/s), equal",
        )

    needle_rng = np.random.default_rng(3)
    for m, cap in ((8, 4), (16, 8)):
        packed = [F.pack_needle(bytes(needle_rng.integers(97, 123, m, dtype=np.uint8)), cap) for _ in range(64)]
        batch = F.NeedleBatch.from_needles(packed, dev)
        row(
            f"find-cycle64-{m}B-128MB",
            lambda: FC.find_count_batch(flat, batch),
            lambda: F.find_count_batch_plain(flat, batch),
            64 * flat.numel(),
            "find_count" if m == 8 else None,
        )
    single = F.NeedleBatch.from_needles([F.pack_needle(flat[4096:4104].cpu().numpy().tobytes(), 4)], dev)
    row("rfind-8B-128MB", lambda: FC.rfind_count_batch(flat, single), lambda: F.rfind_count_batch_plain(flat, single), flat.numel(), "rfind_count")
    set_hay = random_bytes(128 << 20, 4, dev)
    table = F.pack_byteset(suite.BYTESETS["html"], dev)
    row("byteset-128MB", lambda: FC.byteset_count(set_hay, table), lambda: F.byteset_count_plain(set_hay, table), set_hay.numel(), "byteset_count")
    probe = random_bytes(256 << 20, 5, dev)
    row("bytesum-256MB", lambda: B.bytesum_cuda(probe), lambda: B.bytesum_plain(probe), probe.numel(), "bytesum")

    sources = {
        "bytesum": ("stringwars_tpu_torch/csrc/bytesum.cu", "stringwars_tpu/ops/bytesum.py:142"),
        "find_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find_pallas.py:58"),
        "rfind_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find_pallas.py:58"),
        "byteset_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find.py:217"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": timings[name][0],
            "plain_ms": timings[name][1],
        }
        for name, (source, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
