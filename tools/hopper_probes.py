"""Measurement probes of the port's ChaCha20 XOR and BPE kernels on one GPU.

    python3 tools/hopper_probes.py chacha [--other-tree DIR]
    python3 tools/hopper_probes.py bpe
    python3 tools/hopper_probes.py seal --other-tree DIR

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; each line printed is one measurement, after a line with the card's
``nvidia-smi`` name and power limit. Times are CUDA events around 20
back-to-back launches (median of 5), each variant timed in one order and
again in the reverse order, unless a line says otherwise. What each
subcommand measures:

- ``chacha``: the variants of ``tools/hopper_probes/chacha_variants.cu`` at
  128 MiB (each that computes the function is first held to
  ``chacha20_xor_plain``), ``torch``'s ``copy_`` of the same bytes, and the
  SASS pipe split of each variant's largest basic blocks. With
  ``--other-tree`` (a checkout of another commit), that tree's library is
  built in place and its ``chacha_xor_kernel``'s split printed too.
- ``bpe``: the tokenization suite's batch (GPT-2's pre-split of the first
  4 Mi characters of ``synthetic:multilingual``, its first 400,000
  pretokens of 1 to 32 bytes sorted by length, 512 merges trained on the
  first 30,000), the warp-iterations its lane groups take against one row
  a warp (counted on the host from ``bpe_encode_plain``'s per-row
  iterations), then the settings of ``tools/hopper_probes/bpe_variants.cu``
  (one build each) and the package's own kernel, each held to
  ``bpe_encode_plain`` and timed in both table regimes on the sorted batch
  and on a shuffled copy.
- ``seal``: the encryption suite's per-token call (the first 64 lines of
  ``synthetic:long-lines``, a seal each), a one-time key and the 128 MiB
  corpus seal, with this tree's library and with ``--other-tree``'s (the
  same C entry points), in one process, in the orders A B B A and B A A B;
  host clock around each call and a synchronize, median of 30 calls.

Builds go to ``stringwars_tpu_torch/_build/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from stringwars_tpu_torch import build, datasets  # noqa: E402
from stringwars_tpu_torch.ops import bpe as BPE  # noqa: E402
from stringwars_tpu_torch.ops import bpe_cuda as BPC  # noqa: E402
from stringwars_tpu_torch.ops import chacha as CC  # noqa: E402
from stringwars_tpu_torch.suites import encryption as ES  # noqa: E402
from stringwars_tpu_torch.suites import tokenization as TS  # noqa: E402

PROBES = ROOT / "tools" / "hopper_probes"
_P, _N = ctypes.c_void_p, ctypes.c_int64

# chacha_variants.cu's variants: name, then <kFma, kPrmt, kTiles, kRounds, kMem, kDirect>.
CHACHA_VARIANTS = {
    0: ("one thread a block (the earlier form)", False, False, False, 20, True, False),
    1: ("one thread a block, keystream alone (no loads or stores)", False, False, False, 20, False, False),
    2: ("one thread a block, one round", False, False, False, 1, True, False),
    3: ("one thread a block, adds as IMADs by a runtime 1", True, False, False, 20, True, False),
    4: ("tiles, funnel-shift rotations", False, False, True, 20, True, False),
    5: ("tiles, PRMT rotations", False, True, True, 20, True, False),
    6: ("tiles, PRMT, adds as IMADs by a runtime 1", True, True, True, 20, True, False),
    7: ("tiles, no rounds (the memory alone)", False, True, True, 0, True, False),
    8: ("tiles, PRMT, keystream alone (no loads or stores)", False, True, True, 20, False, False),
    9: ("tiles, PRMT, with the direct path (the kernel's form)", False, True, True, 20, True, True),
    10: ("tiles, PRMT, IMADs by a runtime 1, with the direct path", True, True, True, 20, True, True),
    11: ("tiles, funnel shifts, with the direct path", False, False, True, 20, True, True),
}
# bpe_variants.cu's settings: name, then -D values.
BPE_VARIANTS = {
    "butterfly minimum, buckets of 4, no register bound": {"REDUX": 0, "SLOTS": 4, "MINB": 0},
    "one reduction over the group's mask, buckets of 4, no register bound": {"REDUX": 1, "SLOTS": 4, "MINB": 0},
    "one reduction, buckets of 2, no register bound": {"REDUX": 1, "SLOTS": 2, "MINB": 0},
    "one reduction, buckets of 2, 6 blocks an SM": {"REDUX": 1, "SLOTS": 2, "MINB": 6},
    "one reduction, buckets of 2, 8 blocks an SM (the kernel's settings)": {"REDUX": 1, "SLOTS": 2, "MINB": 8},
    "butterfly minimum, buckets of 2, 8 blocks an SM": {"REDUX": 0, "SLOTS": 2, "MINB": 8},
    "the kernel's settings, chunks of 16 rows, groups from 2 lanes": {"CHUNK": 16, "GMIN_LG": 1},
    "the kernel's settings, chunks of 32 rows": {"CHUNK": 32},
}


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"


def events_ms(fn, launches: int = 20, samples: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def both_orders(calls: dict) -> dict:
    """name -> call: each timed in the dict's order, then in the reverse."""
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(events_ms(calls[name]))
    return times


def nvcc_shared(source: Path, out: Path, defines: dict | None = None) -> subprocess.Popen:
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in (defines or {}).items()),
           "-shared", "-o", str(out), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen, what: str) -> str:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{log[-3000:]}")
    return " | ".join(line.split("info    : ")[-1].strip() for line in log.splitlines() if "Used" in line)


def other_library(tree: Path) -> str:
    """Build ``tree``'s kernel library in that tree; its path."""
    code = "from stringwars_tpu_torch import build; build.library(); print(build.library_path())"
    done = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, check=True)
    return done.stdout.strip().splitlines()[-1]


def chacha(args) -> None:
    dev = torch.device("cuda", 0)
    n = 128 << 20
    rng = np.random.default_rng(3)
    key, nonce = rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    data = CS.random_bytes(n, 5, dev)
    out = torch.empty_like(data)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_chacha_variants.so"
    print(f"chacha_variants.cu built: {finish(nvcc_shared(PROBES / 'chacha_variants.cu', so), 'chacha_variants.cu')}")
    lib = ctypes.CDLL(str(so))
    lib.chacha_variant_run.argtypes = (_N, _P, _P, _N, _P, _P, _N, _P)
    stream = torch.cuda.current_stream().cuda_stream

    def call(variant: int):
        def run():
            code = lib.chacha_variant_run(variant, data.data_ptr(), out.data_ptr(), n, key, nonce, 1, stream)
            if code:
                raise RuntimeError(f"variant {variant}: CUDA error {code}")
        return run

    want = CC.chacha20_xor_plain(key, nonce, data)
    for variant, (name, _fma, _prmt, _tiles, rounds, mem, _direct) in CHACHA_VARIANTS.items():
        if mem and rounds == 20:  # the variants that compute the function
            call(variant)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"variant {variant} ({name}) differs from chacha20_xor_plain")
    del want
    calls = {variant: call(variant) for variant in CHACHA_VARIANTS}
    calls["copy_"] = lambda: out.copy_(data)
    calls["the package's chacha20_xor_cuda"] = lambda: CC.chacha20_xor_cuda(key, nonce, data)
    for name, times in both_orders(calls).items():
        label = f"{name}: {CHACHA_VARIANTS[name][0]}" if isinstance(name, int) else name
        print(f"chacha 128 MiB, {label}: {', '.join(f'{t:.4f}' for t in times)} ms "
              f"({100 * 2 * n / 3.35e12 * 1e3 / statistics.mean(times):.1f}% of the 0.0801 ms byte bound)")
    blocks = n // 64
    for variant, (name, fma, prmt, tiles, rounds, mem, direct) in CHACHA_VARIANTS.items():
        mangled = "chacha_variantI" + "".join(
            f"Lb{int(v)}E" if isinstance(v, bool) else f"Li{v}E" for v in (fma, prmt, tiles, rounds, mem, direct))
        pipes = CS.sass_pipes(mangled, "STS" if tiles else None, library=str(so))
        if pipes:
            ceiling = blocks * pipes["body"]["alu"] / (132 * 64 * 1.98e9) * 1e3
            print(f"chacha SASS, {variant}: {name}: {pipes['text']}; ALU-pipe ceiling {ceiling:.4f} ms")
    if args.other_tree:
        pipes = CS.sass_pipes("chacha_xor_kernel", library=other_library(Path(args.other_tree)))
        print(f"chacha SASS of {args.other_tree}'s library: {pipes['text'] if pipes else 'no cuobjdump'}")


def bpe(args) -> None:
    dev = torch.device("cuda", 0)
    text = datasets.synthesize("multilingual", 10 << 20).decode("utf-8", "ignore")[: TS.BPE_CHARS]
    kept, by_length = TS.bpe_rows(text, TS.BPE_ROWS)
    merges = BPE.train_merges(kept[: TS.BPE_TRAIN], TS.BPE_MERGES)
    table = BPE.MergeTable.from_merges(merges)
    with mock.patch.object(BPE, "HASH_SLOTS", 4):  # the same merges in buckets of 4
        table4 = BPE.MergeTable.from_merges(merges)
        buckets4 = table4.on(dev)[3]
    rows_np, lens_np = BPE.pack_rows(by_length)
    data, lengths = torch.from_numpy(rows_np).to(dev), torch.from_numpy(lens_np).to(dev)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(data.shape[0])).to(dev)
    batches = {"sorted": (data, lengths), "shuffled": (data[perm].contiguous(), lengths[perm].contiguous())}
    wants = {name: BPE.bpe_encode_plain(d, l, table) for name, (d, l) in batches.items()}
    _, _, work = BPE.bpe_encode_plain(data, lengths, table, work=True)
    iterations, lens = work["iterations"].cpu().numpy(), lens_np
    warp_iterations = 0
    for first in range(0, lens.size, 8):  # the kernel's chunks: groups of g lanes, 32 / g rows a pass
        chunk_lens, chunk_its = lens[first : first + 8], iterations[first : first + 8]
        longest = int(chunk_lens.max())
        per_pass = 32 >> (2 if longest <= 4 else (longest - 1).bit_length())
        warp_iterations += sum(int(chunk_its[p : p + per_pass].max()) for p in range(0, chunk_lens.size, per_pass))
    print(f"bpe batch: {data.shape[0]:,} rows of width {data.shape[1]}, mean {float(lengths.float().mean()):.2f} B; "
          f"warp-iterations: {warp_iterations:,} in lane groups, {int(iterations.sum()):,} one row a warp")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, defines) in enumerate(BPE_VARIANTS.items()):
        so = build.BUILD_DIR / f"probe_bpe_variant{i}.so"
        procs[name] = (so, nvcc_shared(PROBES / "bpe_variants.cu", so, defines))
    calls = {}
    for name, (so, proc) in procs.items():
        print(f"bpe variant built ({name}): {finish(proc, name)}")
        lib = ctypes.CDLL(str(so))
        lib.bpe_variant_run.argtypes = (_P, _N, _N, _P, _P, _N, _N, _N, _N, _P, _P, _P)
        slots = BPE_VARIANTS[name].get("SLOTS", 2)
        tab, buckets = (table4, buckets4) if slots == 4 else (table, table.on(dev)[3])
        for batch, (d, l) in batches.items():
            ids = torch.empty(d.shape, dtype=torch.int32, device=dev)
            counts = torch.empty(d.shape[0], dtype=torch.int32, device=dev)
            for shared in (1, 0):
                def run(lib=lib, d=d, l=l, ids=ids, counts=counts, shared=shared, buckets=buckets, tab=tab):
                    code = lib.bpe_variant_run(d.data_ptr(), d.shape[0], d.shape[1], l.data_ptr(), buckets.data_ptr(),
                                               buckets.shape[0], *tab.hashed().mults, shared, ids.data_ptr(),
                                               counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"bpe variant: CUDA error {code}")
                    return ids, counts

                got = run()
                if not (torch.equal(got[0], wants[batch][0]) and torch.equal(got[1], wants[batch][1])):
                    raise AssertionError(f"bpe variant ({name}) differs from bpe_encode_plain on the {batch} batch")
                calls[f"{name}; {batch}, {'shared' if shared else 'global'} table"] = run
    for batch, (d, l) in batches.items():
        for global_table in (False, True):
            got = BPC.bpe_encode(d, l, table, global_table=global_table)
            if not (torch.equal(got[0], wants[batch][0]) and torch.equal(got[1], wants[batch][1])):
                raise AssertionError(f"the package's bpe kernel differs from bpe_encode_plain on the {batch} batch")
            calls[f"the package's bpe_encode; {batch}, {'global' if global_table else 'shared'} table"] = (
                lambda d=d, l=l, g=global_table: BPC.bpe_encode(d, l, table, global_table=g))
    for name, times in both_orders(calls).items():
        print(f"bpe 400k, {name}: {', '.join(f'{t:.4f}' for t in times)} ms")


def seal(args) -> None:
    if not args.other_tree:
        raise SystemExit("seal needs --other-tree")
    dev = torch.device("cuda", 0)
    other = ctypes.CDLL(other_library(Path(args.other_tree)))
    for name in ("sw_chacha20_xor", "sw_poly1305"):
        getattr(other, name).argtypes = build.SIGNATURES[name]
        getattr(other, name).restype = ctypes.c_int
    libraries = {"this tree": build.library(), args.other_tree: other}
    lines = [t for t in datasets.synthesize("long-lines", 1 << 20).split(b"\n") if t][: ES.SAMPLE_TOKENS]
    tokens = [torch.tensor(list(t), dtype=torch.uint8, device=dev) for t in lines]
    corpus = CS.random_bytes(128 << 20, 6, dev)
    zeros = torch.zeros(64, dtype=torch.uint8, device=dev)
    print(f"seal: {len(tokens)} tokens of {sum(map(len, lines)):,} B (longest {max(map(len, lines))} B)")

    def host_ms(fn, calls: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(calls):
            started = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - started) * 1e3)
        return statistics.median(times)

    rows = {
        "64-seal call": (lambda: [CC.aead_encrypt(ES.KEY, ES.counter_nonce(i), t) for i, t in enumerate(tokens)], 30),
        "one-time key (64 B, counter 0)": (lambda: CC.chacha20_xor_cuda(ES.KEY, ES.counter_nonce(0), zeros, 0), 200),
        "corpus seal (128 MiB)": (lambda: CC.aead_encrypt(ES.KEY, ES.counter_nonce(0), corpus), 20),
    }
    times = {(lib, row): [] for lib in libraries for row in rows}
    names = list(libraries)
    for order in (names + names[::-1], names[::-1] + names):
        for lib in order:
            with mock.patch.object(build, "library", lambda lib=lib: libraries[lib]):
                for row, (fn, calls) in rows.items():
                    times[(lib, row)].append(host_ms(fn, calls))
    for (lib, row), values in times.items():
        print(f"seal, {row}, {lib}'s library: {', '.join(f'{v:.4f}' for v in values)} ms (median {statistics.median(values):.4f})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=("chacha", "bpe", "seal"))
    parser.add_argument("--other-tree", help="a checkout of another commit, its library built in place")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("hopper_probes: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    {"chacha": chacha, "bpe": bpe, "seal": seal}[args.probe](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
