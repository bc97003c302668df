"""Measurement probes of the port's ChaCha20, BPE, Myers, Poly1305, Aho-Corasick, Shift-And, XXH3, per-token hash, reordering, composition, sort and Bloom filter kernels on one GPU.

    python3 tools/hopper_probes.py chacha [--other-tree DIR]
    python3 tools/hopper_probes.py bpe
    python3 tools/hopper_probes.py seal --other-tree DIR
    python3 tools/hopper_probes.py myers
    python3 tools/hopper_probes.py poly
    python3 tools/hopper_probes.py ac [--other-tree DIR]
    python3 tools/hopper_probes.py shiftand [--other-tree DIR]
    python3 tools/hopper_probes.py xxh3
    python3 tools/hopper_probes.py reorder
    python3 tools/hopper_probes.py spans [--other-tree DIR]
    python3 tools/hopper_probes.py compose [--other-tree DIR]
    python3 tools/hopper_probes.py sort [--other-tree DIR]
    python3 tools/hopper_probes.py uncased [--other-tree DIR]
    python3 tools/hopper_probes.py filters [--other-tree DIR]

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
- ``myers``: the similarities suite's batch (4,096 pairs of
  ``synthetic:dna-100b`` lines, staged as its ``uniform`` and
  ``uniform-utf8`` rows stage them), 65,536 pairs of 256 B (bytes 65..68,
  nine planes) and 184 x 184 pairs of 1 KB ``synthetic:dna`` lines, through
  the variants of ``tools/hopper_probes/myers_variants.cu``: the earlier
  one-thread-a-pair kernel, the same with its text column made in
  registers instead of loaded, and the lane-group kernel with 32-bit lanes
  of one word at the batch's group size, half it and twice it, and with
  64-bit lanes of 1, 2 and 4 words (every variant but the register one
  held to the earlier kernel's distances), and the package's ``myers``;
  the earlier kernel also on the suite's batch repeated 4 and 16 times.
  Each timed by CUDA events and by ``torch.profiler`` device time a launch
  (the suite's kernels run for less than the host takes to launch them).
  Then the SASS split of each kernel's largest basic block (the earlier
  kernel's column loop).
- ``poly``: at 128 MiB (raw mode) and at a 1.1 KB token (AEAD mode, the
  per-token seal's MAC input), the earlier MAC (its runs kernel and its
  fold launch) whole, its runs kernel with its loads alone and with its
  products alone, its fold launch alone, the package's ``poly1305_cuda``,
  the lane-interleaved kernel at other batch depths and blocks an SM and
  with its loads alone and its products alone (the variants of
  ``tools/hopper_probes/poly_variants.cu``) and, at 128 MiB, ``copy_`` of
  the same bytes; each held to ``poly1305_plain`` where it computes the
  tag, and timed by CUDA events and by ``torch.profiler`` device time a
  call. Then the SASS split of the kernels' largest basic blocks.
- ``ac``: 64 MiB of lowercase (``chip_smoke.py``'s ``ac-dfa-*-64MB``
  rows) through the four-word set and the 1,000-word dictionary: the
  earlier kernel (``tools/hopper_probes/ac_variants.cu``: the 256-column
  int32 table, in shared memory up to 96 states, else read with
  ``__ldg``) as it was and with its table load replaced by arithmetic, the
  dictionary cut to its first 96 states in breadth-first order through the
  earlier shared regime (the same chain from a small table), the package's
  class-table kernel with 16- and 32-bit entries in blocks of 256 and 1,024
  threads, with its classes read from the map where the kernel computes
  them from the byte range, and with 2 and 4 chunks a thread walked in
  step; each that
  computes the count first held to ``ac_count_plain``, each timed by CUDA
  events and by ``torch.profiler`` device time a launch. With
  ``--other-tree`` (a checkout whose ``sw_ac_classes`` takes this
  package's class tables), that tree's kernel on this package's tables of
  each set, in the same orders. Then the SASS split of the
  kernels' largest basic blocks, per byte (bytes a block: its PRMTs, one a
  byte).
- ``shiftand``: the same 64 MiB through the four-word set (one state word)
  and the eight-word set (two), and the find suite's ``aho_corasick`` call
  (its three charsets over the suite's 64 MB ``synthetic:english-words``
  tape): the earlier kernel (``tools/hopper_probes/sa_variants.cu``) as it
  was and without its mask load, the package's kernel and the same without
  its mask load, and a probe kernel with the haystack read directly or
  staged by warps in slices of 64, 128 or 256 bytes a lane and (one word of
  up to 16 bits) two steps' final bits a POPC, held and timed as in
  ``ac``; the same at 16 MiB, which stays in L2; the suite's call traced
  (launches, device ms, busy share) and, with ``--other-tree``, its p50 on
  that tree's library against this tree's in one process (A B B A, host
  clock and a synchronize, median of 200 calls). Then the SASS splits.
- ``xxh3``: the hash suite's tape (128 MB of ``synthetic:english-words``,
  words) and its buckets, and 131,072 lines of 1,015 B in rows of 1 KiB
  (``chip_smoke.py``'s ``xxh3-*-128MB`` rows): the earlier one-thread-a-token
  kernel (``tools/hopper_probes/xxh3_variants.cu``) over the buckets and
  the lines, the package's kernel over the tape's spans, the buckets and
  the lines, and at 3 to 6 blocks an SM; each first held to the package's
  digests (by token index), then timed by CUDA events in both orders and
  by ``torch.profiler`` device time a call. Then the quick step (tokens of
  0..16 bytes) taken apart on the tape: whole, its loads alone, its
  hashing alone (words made from the offsets), the offsets alone, the
  hashing with no loads at all, each also with two tokens a lane; and the
  package kernel's SASS, written to ``_build/xxh3_sass.txt``.
- ``reorder``: the canonical reordering of ``chip_smoke.py``'s
  ``nf_reorder-marks-128MB`` rows (32 Mi codepoints of ``marks_stream`` cut
  by ``segment_rows``) and ``nf_reorder-nfd-128MB`` rows (the NFD slow rows
  of 128 MB of ``synthetic:multilingual``, decomposed as the suite
  decomposes them; the corpus is synthesized by a child process meanwhile)
  by the earlier one-thread-a-row kernel
  (``tools/hopper_probes/reorder_variants.cu``) and the package's
  warp-a-row kernel, also at other settings (16- or 4-byte loads, rows a
  warp, blocks an SM), each held to ``reorder_rows_plain_``, timed by
  ``torch.profiler`` device time a launch (each call sorts a fresh copy)
  and, on the NFD rows, where nothing moves, also by CUDA events in both
  orders on the rows in place; and the kernel's loads alone (1, 2 or 4
  rows a warp, a row's second chunk with its first or after it).
- ``spans``: the per-token hashes (XXH64, swh64, XXH32; swh64 under 8
  seeds) over the hash suite's tape: the spans form (one launch over the
  tape's tokens where they lie) beside the same kernel over the suite's
  buckets, each first held to the other by token index; and over 131,072
  lines of 1,015 B, end to end (the spans form) and in rows of 1 KiB (the
  padded entry points); with ``--other-tree`` (a checkout of the parent),
  its padded kernels on the same buckets and rows; CUDA events in both
  orders and ``torch.profiler`` device time a call. Then each kernel at
  other register budgets (``spans_variants.cu``), on the tape and on the
  rows, with each instance's ptxas lines (registers, stack, spills).
- ``compose``: the composition kernel over ``nf_reorder-marks-128MB``'s
  rows reordered and over the corpus' NFD in rows (``chip_smoke.py``'s
  ``nf_compose-*-128MB`` rows; the multilingual corpus synthesized
  meanwhile), with ``--other-tree``'s kernel (a checkout of the parent,
  whose kernel takes the ccc table) on the same rows, each held to
  ``compose_rows_plain_`` and timed by ``torch.profiler`` device time a
  launch in both orders.
- ``filters``: the Bloom build and query at the containers suite's shape
  (chip_smoke.py's 32 MB of words: 22,095 keys inserted, 5,524 held out,
  k = 7, 524,288 bits) and at its 1 M-key cap (800,000 random lowercase
  words of 5-17 B into 2^24 bits, 200,000 held out): the package's calls;
  with ``--other-tree``, that tree's ``ops/filters.py`` loaded beside them
  with its own library (the earlier wrappers whole: ``earlier_filters``);
  from ``tools/hopper_probes/filter_variants.cu``, the package's query
  kernel at 1, 2 and all 7 seeds a test and the cluster build (one cluster
  of 4, 8 and 16 blocks; 2, 4 and as many clusters of 16 as the card holds,
  written out by atomics and by copies; its global regime), each held to
  its plain version; the BinaryFuse8 query (``fuse_query``) over the
  inserted tokens' XXH64 digests, queried with the held-out ones, beside an
  empty kernel with its arguments on its grid and stream
  (``fuse_floor_kernel``), each by profiler device time a launch and CUDA
  events a call; the query over the inserted tokens (all positive);
  each with its kernel's and its whole call's device time
  (``torch.profiler``, the memset and zeros included), CUDA events and host
  µs a call (the median of 5 runs of 100 calls enqueued back to back).
  Then the split: the hashing alone (each probe's position XORed into a
  register, stored once a lane), the build's bit work alone (positions
  precomputed, a global atomicOr a probe) and the query's (the k word
  loads and tests, a byte stored a token).
- ``sort``: the radix argsort over ``chip_smoke.py``'s
  ``argsort-words-128MB`` columns (the hash suite's tape, its 96-byte
  prefix packed as the sequence suite packs it) and over the uncased key
  columns of the same prefix rows: the package's one-sweep kernel, the same
  with its scatter straight from registers, with ranks by ballots, at 2
  and 3 blocks an SM, with the digit count's counters a warp, and without
  its look-back (timing only: a wrong order)
  (``tools/hopper_probes/radix_variants.cu``, the package's source with
  ``SW_RADIX_*`` switches, ``SWEEP_VARIANTS``) and, with ``--other-tree``
  (a checkout of the parent of the one-sweep passes), that tree's
  three-launch kernel (a histogram, a scan and a scatter a pass) on the
  plan the package's call ran; each but the timing-only one held to
  ``lsd_argsort_plain`` and timed by CUDA events in both orders, each
  split by launch kind (``torch.profiler`` device time a call), and the
  device time of each pass in launch order, the gathering passes (a
  column's first) marked. Then the uncased keys kernel and its plan mode
  beside the earlier torch route (``uncased_keys_plain``), and the uncased
  order split by launch.
- ``uncased``: the uncased keys at the rows that run them (the hash suite's
  128 MB of words, the sequence path's 16 MB of words and 8 MB of
  ``synthetic:multilingual`` words, and those multilingual rows with every
  byte from 0x80 up made ``x``): the earlier kernel, a thread a row
  (``tools/hopper_probes/uncased_variants.cu``), whole and with its parts
  switched off (staging alone, the walk without stores, the stores alone,
  staging and stores without the walk), the package's kernel and its plan
  mode, a copy of it at other settings (``UNCASED_VARIANTS``,
  ``tools/hopper_probes/uncased_settings.cu``) and ``--other-tree``'s kernel, each that computes the keys held to
  ``uncased_keys_plain``, timed by CUDA events in both orders; then the
  uncased order of the 16 MB words split by launch.

Builds go to ``stringwars_tpu_torch/_build/`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
from stringwars_tpu_torch import tape as T  # noqa: E402
from stringwars_tpu_torch.ops import ahocorasick as AC  # noqa: E402
from stringwars_tpu_torch.ops import hash as H  # noqa: E402
from stringwars_tpu_torch.ops import hash_cuda as HC  # noqa: E402
from stringwars_tpu_torch.ops import ahocorasick_cuda as ACC  # noqa: E402
from stringwars_tpu_torch.ops import bpe as BPE  # noqa: E402
from stringwars_tpu_torch.ops import bpe_cuda as BPC  # noqa: E402
from stringwars_tpu_torch.ops import chacha as CC  # noqa: E402
from stringwars_tpu_torch.ops import expand as EX  # noqa: E402
from stringwars_tpu_torch.ops import myers as MY  # noqa: E402
from stringwars_tpu_torch.ops import myers_cuda as MYC  # noqa: E402
from stringwars_tpu_torch.ops import shiftand as SA  # noqa: E402
from stringwars_tpu_torch.ops import shiftand_cuda as SAC  # noqa: E402
from stringwars_tpu_torch.ops import normalize as NORM  # noqa: E402
from stringwars_tpu_torch.ops import similarity as S  # noqa: E402
from stringwars_tpu_torch.ops import xxh3 as X3  # noqa: E402
from stringwars_tpu_torch.suites import encryption as ES  # noqa: E402
from stringwars_tpu_torch.suites import find as FS  # noqa: E402
from stringwars_tpu_torch.suites import hash as HS  # noqa: E402
from stringwars_tpu_torch.suites import normalization as NS  # noqa: E402
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


def device_orders(calls: dict) -> dict:
    """name -> (call, kernel substring): ``torch.profiler`` device ms a call
    of the kernels whose names hold the substring, in the dict's order, then
    in the reverse; None where no trace saw them."""
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            fn, kernel = calls[name]
            times[name].append(CS.device_ms(fn, kernel, calls=30, per_call=True))
    return times


def _fmt(values) -> str:
    return ", ".join("not measured" if v is None else f"{v:.4f}" for v in values)


def suite_myers_batches(dev) -> dict:
    """The similarities suite's two Myers stagings of its 4,096 pairs (64
    queries x 64 candidates of ``synthetic:dna-100b`` lines)."""
    lines = [t for t in datasets.synthesize("dna-100b", 2 * 64 * 64 * 101 + 101).split(b"\n") if t][: 2 * 64 * 64]
    queries, candidates = lines[:64], lines[64:128]
    pa = [q for q in queries for _ in candidates]
    pb = [c for _ in queries for c in candidates]
    return {
        "suite uniform (4,096 pairs of 100 B)": MY.myers_from_tokens(pa, pb, device=dev),
        "suite uniform-utf8 (codepoints)": MY.myers_from_codepoints(
            [S.decode_codepoints(t) for t in pa], [S.decode_codepoints(t) for t in pb], device=dev),
    }


def repeated(mb: MY.MyersBatch, k: int) -> MY.MyersBatch:
    return dataclasses.replace(
        mb, planes=mb.planes.repeat(1, 1, k).contiguous(), text=mb.text.repeat(1, k).contiguous(),
        a_len=mb.a_len.repeat(k).contiguous(), b_len=mb.b_len.repeat(k).contiguous(),
        host_a_len=np.tile(mb.host_a_len, k), host_b_len=np.tile(mb.host_b_len, k))


def myers(args) -> None:
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_myers_variants.so"
    print(f"myers_variants.cu built: {finish(nvcc_shared(PROBES / 'myers_variants.cu', so), 'myers_variants.cu')}")
    lib = ctypes.CDLL(str(so))
    lib.myers_variant_run.argtypes = (_N, _P, _N, _P, _N, _P, _P, _N, _N, _N, _P, _P, _P)
    batches = suite_myers_batches(dev)
    rng = np.random.default_rng(0)
    ca = rng.integers(65, 69, (65536, 256)).astype(np.int32)
    cb = rng.integers(65, 69, (65536, 256)).astype(np.int32)
    full = np.full(65536, 256, np.int32)
    batches["64k x 256 B (bytes, 9 planes)"] = MY.MyersBatch.from_arrays(ca, cb, full, full, nbits=MY.BYTE_BITS, device=dev)
    side = 184
    dna = [t for t in datasets.synthesize("dna", (2 * side + 1) * 1024).split(b"\n") if t]
    queries, candidates = dna[:side], dna[side : 2 * side]
    batches["184 x 184 pairs of 1 KB ACGT"] = MY.myers_from_tokens(
        [q for q in queries for _ in candidates], [c for _ in queries for c in candidates], device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(mb, v, lg, per_lane=1):
        out = torch.empty(mb.count, dtype=torch.int32, device=dev)
        carry = torch.empty(2 * -(-mb.text.shape[0] // 32) * mb.count, dtype=torch.int32, device=dev)

        def run():
            code = lib.myers_variant_run(v, mb.planes.data_ptr(), mb.nbits, mb.text.data_ptr(), mb.text.shape[0],
                                         mb.a_len.data_ptr(), mb.b_len.data_ptr(), mb.count, lg, per_lane,
                                         carry.data_ptr(), out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"myers variant {v}: CUDA error {code}")
            return out
        return run

    for name, mb in batches.items():
        max_a = int(mb.host_a_len.max())
        calls = {
            "the earlier kernel (one thread a pair, 64-bit words)": (variant(mb, 0, 0), "parent_myers_kernel"),
            "the earlier kernel, text made in registers": (variant(mb, 1, 0), "parent_myers_kernel"),
        }
        lg32 = MY.lane_group(max_a).bit_length() - 1
        plans = {(32, 1, g) for g in (max(lg32 - 1, 0), lg32, min(lg32 + 1, 5))}
        for per_lane in (1, 2, 4):
            lg = MY._pow2(-(-max_a // (64 * per_lane))).bit_length() - 1
            plans |= {(64, per_lane, lg), (64, per_lane, min(lg + 1, 5))} if per_lane == 4 else {(64, per_lane, lg)}
        for bits, per_lane, g in sorted(plans):
            calls[f"lane groups, {bits}-bit words, {per_lane} a lane, {1 << g} lanes a pair"] = (
                variant(mb, 2 if bits == 32 else 3, g, per_lane), "myers_lanes_kernel")
        calls[f"the package's myers (schedule {MY.schedule(mb.count, max_a, mb.nbits, sms)})"] = (
            lambda mb=mb: MYC.myers(mb), "myers_lanes_kernel")
        want = calls["the earlier kernel (one thread a pair, 64-bit words)"][0]().clone()
        for label, (fn, _) in calls.items():
            if "registers" not in label and not torch.equal(fn(), want):
                raise AssertionError(f"myers {name}, {label}: distances differ from the earlier kernel's")
        print(f"myers {name}: {mb.count:,} pairs, nbits {mb.nbits}, longest pattern {max_a}, text rows "
              f"{mb.text.shape[0]}; every variant equal to the earlier kernel")
        events = both_orders({label: fn for label, (fn, _) in calls.items()})
        device = device_orders(calls)
        for label in calls:
            print(f"myers {name}, {label}: device {_fmt(device[label])} ms a launch; events {_fmt(events[label])} ms")
        if name.startswith("suite"):
            for k in (4, 16):
                big = repeated(mb, k)
                fn = variant(big, 0, 0)
                print(f"myers {name} x{k} ({big.count:,} pairs), the earlier kernel: device "
                      f"{_fmt(device_orders({'x': (fn, 'parent_myers_kernel')})['x'])} ms a launch; events "
                      f"{_fmt(both_orders({'x': fn})['x'])} ms")
    for label, mangled in (("the earlier kernel, nbits 3", "parent_myers_kernelILi3ELi4ELb0E"),
                           ("the earlier kernel, nbits 9", "parent_myers_kernelILi9ELi4ELb0E"),
                           ("lane groups, 32-bit words, nbits 3", "myers_lanes_kernelILi3EjLi1E"),
                           ("lane groups, 32-bit words, nbits 9", "myers_lanes_kernelILi9EjLi1E"),
                           ("lane groups, 32-bit words, nbits 22", "myers_lanes_kernelILi22EjLi1E"),
                           ("lane groups, 64-bit words, 4 a lane, nbits 9", "myers_lanes_kernelILi9EmLi4E"),
                           ("lane groups, 64-bit words, 4 a lane, nbits 3", "myers_lanes_kernelILi3EmLi4E")):
        pipes = CS.sass_pipes(mangled, library=str(so))
        print(f"myers SASS, {label}: {pipes['text'] if pipes else 'not measured (no cuobjdump)'}")


def poly(args) -> None:
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_poly_variants.so"
    print(f"poly_variants.cu built: {finish(nvcc_shared(PROBES / 'poly_variants.cu', so), 'poly_variants.cu')}")
    lib = ctypes.CDLL(str(so))
    lib.poly_variant_run.argtypes = (_N, _P, _N, _P, _N, _N, _P, _N, _N, _N, _P, _P, _P)
    stream = torch.cuda.current_stream().cuda_stream
    key = np.random.default_rng(5).integers(0, 256, 32, dtype=np.uint8).tobytes()
    key_dev = torch.tensor(list(key), dtype=torch.uint8, device=dev)
    lines = [t for t in datasets.synthesize("long-lines", 1 << 20).split(b"\n") if t]
    token = min(lines[: ES.SAMPLE_TOKENS], key=lambda t: abs(len(t) - 1100))
    empty = torch.empty(0, dtype=torch.uint8, device=dev)
    shapes = {
        "128 MiB, raw mode": (CS.random_bytes(128 << 20, 6, dev), None),
        f"a {len(token)} B token, AEAD mode (the per-token seal's MAC)": (
            torch.tensor(list(token), dtype=torch.uint8, device=dev), empty),
    }
    # lane-interleaved variants: number, label, blocks an SM of its grid
    lanes = {4: ("batches of 4 groups, 2 blocks an SM", 2), 5: ("batches of 8 groups, 2 blocks an SM", 2),
             6: ("batches of 4 groups, 4 blocks an SM", 4), 7: ("batches of 8 groups, 1 block an SM", 1),
             8: ("its loads alone", CC.POLY_BLOCKS_PER_SM), 9: ("its products alone", CC.POLY_BLOCKS_PER_SM)}
    for name, (msg, aad) in shapes.items():
        aead = aad is not None
        blocks = -(-msg.numel() // 16) + (1 if aead else 0)
        partials = torch.zeros((max(-(-blocks // 4096), 4 * sms), 5), dtype=torch.int32, device=dev)
        tag = torch.empty(16, dtype=torch.uint8, device=dev)

        def variant(v, per_sm=2):
            with mock.patch.object(CC, "POLY_BLOCKS_PER_SM", per_sm):
                grid, warps, q = CC.poly_geometry(blocks, sms)

            def run():
                code = lib.poly_variant_run(v, aad.data_ptr() if aead and aad.numel() else None, 0,
                                            msg.data_ptr(), msg.numel(), int(aead), key_dev.data_ptr(), q, warps, grid,
                                            partials.data_ptr(), tag.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"poly variant {v}: CUDA error {code}")
                return tag
            return run

        package = (lambda msg=msg, aad=aad: CC.poly1305_cuda(key_dev, msg, aad))
        want = CC.poly1305_plain(key, CC._mac_data_tensor(b"", msg) if aead else msg)
        checked = {"the earlier MAC": variant(0), "the package's": package}
        checked.update({f"lane-interleaved, {label}": variant(v, per_sm) for v, (label, per_sm) in lanes.items() if v < 8})
        for label, fn in checked.items():
            got = bytes(fn().cpu().tolist())
            if got != want:
                raise AssertionError(f"poly {name}: {label} tag {got.hex()} differs from poly1305_plain's {want.hex()}")
        calls = {
            "the earlier MAC whole (runs, then fold)": (variant(0), "_kernel"),
            "its runs kernel, loads alone": (variant(1), "runs_kernel"),
            "its runs kernel, products alone": (variant(2), "runs_kernel"),
            "its fold launch alone": (variant(3), "fold_kernel"),
            "the package's poly1305_cuda (batches of 4 groups, 3 blocks an SM)": (package, "poly_"),
        }
        calls.update({f"lane-interleaved, {label}": (variant(v, per_sm), "_kernel") for v, (label, per_sm) in lanes.items()})
        if not aead:
            out = torch.empty_like(msg)
            calls["copy_ of the same bytes"] = (lambda: out.copy_(msg), "")
        print(f"poly {name}: {blocks:,} blocks, geometry {CC.poly_geometry(blocks, sms)} (grid, warps, q); every variant "
              f"that computes the tag equals poly1305_plain")
        events = both_orders({label: fn for label, (fn, _) in calls.items()})
        device = device_orders({label: c for label, c in calls.items() if c[1]})
        for label in calls:
            print(f"poly {name}, {label}: device {_fmt(device.get(label, [None]))} ms a call; events {_fmt(events[label])} ms")
    for label, mangled, library in (("the package's kernel", "poly_lanes_kernelILi4ELi3E", str(build.library_path())),
                                    ("batches of 8 groups", "poly_lanes_kernelILi8ELi2E", str(so)),
                                    ("the earlier runs kernel", "runs_kernelILb1ELb1E", str(so))):
        pipes = CS.sass_pipes(mangled, library=library)
        print(f"poly SASS, {label}: {pipes['text'] if pipes else 'not measured (no cuobjdump)'}")


def per_byte_pipes(mangled: str, library: str, steps_of) -> str:
    """The SASS split of a kernel's largest basic block and its ALU and FMA
    instructions a byte (``steps_of(counts)``: the bytes the block walks)."""
    pipes = CS.sass_pipes(mangled, library=library)
    if pipes is None:
        return "not measured (no cuobjdump)"
    body = pipes["body"]
    steps = steps_of(body["counts"])
    if not steps:
        return pipes["text"]
    return f"{pipes['text']}; {steps} bytes a body: ALU {body['alu'] / steps:.2f}, FMA {body['fma'] / steps:.2f} a byte"


def dictionary_words() -> list[bytes]:
    """``chip_smoke.py``'s 1,000-word dictionary (``synthetic:english-words``)."""
    english = datasets.synthesize("english-words", 1 << 20)
    return list(dict.fromkeys(T.Tape.from_buffer(english, "words").to_list()))[:1000]


def bfs_cut(auto: AC.Automaton, keep: int) -> np.ndarray:
    """The earlier kernel's packed table (``next << 8 | count``) of the
    automaton's first ``keep`` states in breadth-first order, transitions
    past them sent to the root: the same chain from a small table (its
    count is not the automaton's)."""
    order = AC.bfs_order(auto.delta)[:keep]
    renumber = np.zeros(auto.states, np.int64)
    renumber[order] = np.arange(keep)
    inside = np.zeros(auto.states, bool)
    inside[order] = True
    nxt = auto.delta[order].astype(np.int64)
    entries = (np.where(inside[nxt], renumber[nxt], 0) << 8) | np.minimum(auto.out_count[nxt], 255)
    return entries.reshape(-1).astype(np.uint32).view(np.int32)


def ac(args) -> None:
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_ac_variants.so"
    print(f"ac_variants.cu built: {finish(nvcc_shared(PROBES / 'ac_variants.cu', so), 'ac_variants.cu')}")
    lib = ctypes.CDLL(str(so))
    lib.ac_parent_run.argtypes = (_N, _P, _N, _P, _N, _N, _N, _N, _P, _P)
    lib.ac_chains_run.argtypes = (_N, _P, _N, _P, _P, _N, _N, _N, _N, _N, _N, _P, _P)
    pkg = build.library()
    hay = CS.lowercase(64 << 20, 0, dev)
    n = hay.numel()
    stream = torch.cuda.current_stream().cuda_stream
    shared = ACC.shared_bytes(dev)
    out = torch.zeros(1, dtype=torch.int64, device=dev)

    def parent(table, states, on_chip, variant, auto):
        def run():
            out.zero_()
            code = lib.ac_parent_run(variant, hay.data_ptr(), n, table.data_ptr(), states, int(on_chip),
                                     ACC.kernel_chunk(auto.max_len), auto.max_len - 1, out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"ac parent variant {variant}: CUDA error {code}")
            return out
        return run

    def classes(auto, entry_bytes, threads, chains=1, by_range=True):
        lay = AC.class_layout(auto.delta, auto.out_count, shared, entry_bytes)
        rows, cmap = AC.class_tensors(lay, dev)

        def run():
            out.zero_()
            if chains == 1:
                code = pkg.sw_ac_classes(hay.data_ptr(), n, rows.data_ptr(), cmap.data_ptr(), auto.states, lay.classes,
                                         lay.entry_bytes, lay.hot, threads,
                                         lay.range_lo if by_range else -1, ACC.kernel_chunk(auto.max_len),
                                         auto.max_len - 1, out.data_ptr(), stream)
            else:
                code = lib.ac_chains_run(chains, hay.data_ptr(), n, rows.data_ptr(), cmap.data_ptr(), auto.states,
                                         lay.classes, lay.entry_bytes, threads, ACC.kernel_chunk(auto.max_len),
                                         auto.max_len - 1, out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"ac class variant ({entry_bytes} B, {threads} threads, {chains} chains): CUDA error {code}")
            return out
        return run, lay

    other = None
    if args.other_tree:
        other = ctypes.CDLL(other_library(Path(args.other_tree)))
        other.sw_ac_classes.argtypes = build.SIGNATURES["sw_ac_classes"]
        other.sw_ac_classes.restype = ctypes.c_int

    def other_classes(auto):
        lay = auto.layout(shared)
        rows, cmap = AC.class_tensors(lay, dev)

        def run():
            out.zero_()
            code = other.sw_ac_classes(hay.data_ptr(), n, rows.data_ptr(), cmap.data_ptr(), auto.states, lay.classes,
                                       lay.entry_bytes, lay.hot, ACC.block_threads(lay), lay.range_lo,
                                       ACC.kernel_chunk(auto.max_len), auto.max_len - 1, out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"ac {args.other_tree}'s class kernel: CUDA error {code}")
            return out
        return run

    for name, auto in (("4 words", AC.Automaton([b"the", b"and", b"tion", b"abcd"])),
                       ("1,000 words", AC.Automaton(dictionary_words()))):
        want = AC.ac_count_plain(auto, hay)
        packed = auto.tables(dev).packed
        on_chip = auto.states <= 96
        where = "shared" if on_chip else "global"
        calls = {f"the earlier kernel ({where} table)": (parent(packed, auto.states, on_chip, 0, auto), "parent_ac_kernel"),
                 f"the earlier kernel, table load replaced by arithmetic": (parent(packed, auto.states, on_chip, 1, auto), "parent_ac_kernel")}
        if not on_chip:
            cut = torch.from_numpy(bfs_cut(auto, 96)).to(dev)
            calls["the earlier kernel on the first 96 states (shared table)"] = (parent(cut, 96, True, 0, auto), "parent_ac_kernel")
        computes = set(calls) - {"the earlier kernel, table load replaced by arithmetic",
                                 "the earlier kernel on the first 96 states (shared table)"}
        for entry_bytes in (2, 4):
            for threads in (256, 1024):
                run, lay = classes(auto, entry_bytes, threads)
                label = f"class table, {8 * entry_bytes}-bit entries ({lay.regime}, {lay.hot} rows on chip), {threads} threads"
                calls[label] = (run, "ac_class_kernel")
                computes.add(label)
        lay = AC.class_layout(auto.delta, auto.out_count, shared, 2)
        if lay.range_lo >= 0:
            threads = ACC.block_threads(lay)
            label = f"class table, 16-bit entries, classes read from the map (not by the byte range), {threads} threads"
            calls[label] = (classes(auto, 2, threads, by_range=False)[0], "ac_class_kernel")
            computes.add(label)
        for chains in (2, 4):
            threads = ACC.block_threads(lay)
            label = f"class table, 16-bit entries, {chains} chunks a thread in step, {threads} threads"
            calls[label] = (classes(auto, 2, threads, chains)[0], "chains_kernel")
            computes.add(label)
        calls["the package's ac_count"] = (lambda auto=auto: ACC.ac_count(auto, hay), "ac_class_kernel")
        computes.add("the package's ac_count")
        if other is not None:
            label = f"{args.other_tree}'s class kernel"
            calls[label] = (other_classes(auto), "ac_class_kernel")
            computes.add(label)
        for label in computes:
            got = calls[label][0]()
            if not torch.equal(got, want):
                raise AssertionError(f"ac {name}, {label}: {int(got.item())} differs from ac_count_plain's {int(want.item())}")
        lay = auto.layout(shared)
        print(f"ac {name}: {auto.states} states, {lay.classes} classes, max_len {auto.max_len}, max_out {auto.max_out}; "
              f"package regime {lay.regime}, {lay.entry_bytes * 8}-bit entries, {lay.hot * lay.pitch + AC.MAP_BYTES:,} B "
              f"staged; count {int(want.item()):,}; every variant that computes it equals ac_count_plain")
        events = both_orders({label: fn for label, (fn, _) in calls.items()})
        device = device_orders(calls)
        for label in calls:
            print(f"ac {name}, {label}: device {_fmt(device[label])} ms a launch; events {_fmt(events[label])} ms")
    library = str(build.library_path())
    for label, mangled, lib_path in (("the earlier kernel, shared table", "parent_ac_kernelILi0ELb0E", str(so)),
                                     ("the earlier kernel, global table", "parent_ac_kernelILi1ELb0E", str(so)),
                                     ("class table, 16-bit, shared", "ac_class_kernelItLb0ELi1EE", library),
                                     ("class table, 16-bit, shared, by the byte range", "ac_class_kernelItLb0ELi2EE", library),
                                     ("class table, 32-bit, split", "ac_class_kernelIjLb1ELi1EE", library)):
        loads = (lambda c: c.get("PRMT", 0)) if "class" in label else (lambda c: c.get("LDS", 0) + c.get("LDG", 0))
        print(f"ac SASS, {label}: {per_byte_pipes(mangled, lib_path, loads)}")


def shiftand(args) -> None:
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_sa_variants.so"
    print(f"sa_variants.cu built: {finish(nvcc_shared(PROBES / 'sa_variants.cu', so), 'sa_variants.cu')}")
    lib = ctypes.CDLL(str(so))
    lib.sa_variant_run.argtypes = (_N, _P, _N, _P, _N, _N, _N, _P, _P)
    stream = torch.cuda.current_stream().cuda_stream
    flat = CS.lowercase(64 << 20, 0, dev)
    tape = datasets.load_tape(None, tokens_mode="words", size_limit="64mb", device=dev)
    suite = [FS.byteset_matcher(cs) for cs in FS.BYTESETS.values()]
    if not all(isinstance(m, SA.ShiftAndSet) for m in suite):
        raise AssertionError("a find-suite charset did not take Shift-And")

    def variant(sa, hay, n, v):
        out = torch.zeros(1, dtype=torch.int64, device=dev)
        table, _ = sa.tables(dev)

        def run():
            out.zero_()
            code = lib.sa_variant_run(v, hay.data_ptr(), n, table.data_ptr(), sa.n_words, ACC.kernel_chunk(sa.max_len),
                                      sa.max_len - 1, out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"shiftand variant {v}: CUDA error {code}")
            return out
        return run

    shapes = {"ac-shiftand-64MB (4 words, one state word)": ([SA.ShiftAndSet([b"the", b"and", b"tion", b"abcd"])], flat, flat.numel()),
              "ac-shiftand8-64MB (8 words, two state words)": (
                  [SA.ShiftAndSet([b"needle", b"haystack", b"pattern", b"search", b"string", b"find", b"match", b"token"])],
                  flat, flat.numel()),
              f"the find suite's aho_corasick call (3 charsets over {tape.total_bytes:,} B)": (suite, tape.data, tape.total_bytes),
              "16 MiB (in L2), 4 words": ([SA.ShiftAndSet([b"the", b"and", b"tion", b"abcd"])], flat[: 16 << 20], 16 << 20)}
    for name, (sets, hay, n) in shapes.items():
        def each(make):
            fns = [make(sa) for sa in sets]
            return lambda: [fn() for fn in fns]

        calls = {
            "the earlier kernel": (each(lambda sa: variant(sa, hay, n, 0)), "parent_sa_kernel"),
            "the earlier kernel without its mask load": (each(lambda sa: variant(sa, hay, n, 1)), "parent_sa_kernel"),
            "the package's kernel": (each(lambda sa: (lambda: SAC.shiftand_count(sa, hay, n))), "sa_kernel"),
        }
        if all(sa.n_words == 2 and sa.max_len > 1 for sa in sets):  # one word: the earlier kernel's loop
            calls["the package's kernel without its mask load"] = (each(lambda sa: variant(sa, hay, n, 2)), "noload_sa_kernel")
        narrow = all(sa.n_words == 1 and sa.occupied < 1 << 16 for sa in sets)
        probes = []
        for code, slice_bytes in enumerate((0, 64, 128, 256)):
            for pack in ((1, 2) if narrow else (1,)):
                label = (f"probe kernel: {f'staged by warps in {slice_bytes}-byte slices' if slice_bytes else 'direct loads'}"
                         f", {'two steps a POPC' if pack == 2 else 'a POPC a word'}")
                calls[label] = (each(lambda sa, v=16 + 4 * code + pack: variant(sa, hay, n, v)), "probe_sa_kernel")
                probes.append(label)
        want = [SA.shiftand_count_plain(sa, hay, n) for sa in sets]
        for label in ("the earlier kernel", "the package's kernel", *probes):
            got = calls[label][0]()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"shiftand {name}, {label}: {[int(g.item()) for g in got]} differ from "
                                     f"shiftand_count_plain's {[int(w.item()) for w in want]}")
        print(f"shiftand {name}: counts {[int(w.item()) for w in want]}; the earlier and the package's kernels equal "
              f"shiftand_count_plain")
        events = both_orders({label: fn for label, (fn, _) in calls.items()})
        device = {label: [] for label in calls}
        for order in (list(calls), list(calls)[::-1]):
            for label in order:
                fn, kernel = calls[label]
                device[label].append(CS.device_ms(fn, kernel, calls=30, per_call=True))
        for label in calls:
            print(f"shiftand {name}, {label}: device {_fmt(device[label])} ms a call ({len(sets)} launches); "
                  f"events {_fmt(events[label])} ms")
    routine, _ = FS.aho_corasick_routine(tape)
    CS.traced_call(f"aho_corasick call (the find suite's byteset-forward/swtorch::aho_corasick over {tape.total_bytes:,} B)",
                   routine, lambda: dict(SAC.LAUNCHES), {"shiftand": "sa_kernel"}, CS.bound_ms(3 * tape.total_bytes))
    if args.other_tree:
        other = ctypes.CDLL(other_library(Path(args.other_tree)))
        other.sw_shiftand.argtypes = build.SIGNATURES["sw_shiftand"]
        other.sw_shiftand.restype = ctypes.c_int
        libraries = {"this tree": build.library(), args.other_tree: other}
        times = {name: [] for name in libraries}

        def p50(calls: int = 200) -> float:
            routine()
            torch.cuda.synchronize()
            samples = []
            for _ in range(calls):
                started = time.perf_counter()
                routine()
                samples.append((time.perf_counter() - started) * 1e3)
            return statistics.median(samples)

        names = list(libraries)
        for name in names + names[::-1]:
            with mock.patch.object(build, "library", lambda name=name: libraries[name]):
                times[name].append(p50())
        for name, values in times.items():
            print(f"shiftand, the find suite's aho_corasick call p50 on {name}'s library: "
                  f"{', '.join(f'{v:.4f}' for v in values)} ms")
    library = str(build.library_path())
    for label, mangled, lib_path in (("the earlier kernel, u32 state", "parent_sa_kernelIjLb1E", str(so)),
                                     ("the earlier kernel, u64 state", "parent_sa_kernelImLb1E", str(so)),
                                     ("the package's kernel, one word", "sa_kernelILi1ELb0E", library),
                                     ("the package's kernel, two words", "sa_kernelILi2ELb0E", library)):
        print(f"shiftand SASS, {label}: {per_byte_pipes(mangled, lib_path, lambda c: c.get('LDS', 0))}")


# xxh3_variants.cu's settings of the package's kernel: blocks an SM.
XXH3_SETTINGS = {0: "3 blocks an SM", 1: "4 blocks an SM", 2: "5 blocks an SM", 3: "6 blocks an SM"}
# reorder_variants.cu's settings: (16-byte loads, rows a warp, blocks an SM).
REORDER_SETTINGS = {0: "(16 B, 1, 3)", 1: "(16 B, 1, 4)", 2: "(16 B, 2, 3)", 3: "(16 B, 2, 4)", 4: "(4 B, 1, 4)"}


def xxh3(args) -> None:
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_xxh3_variants.so"
    print(f"xxh3_variants.cu built: {finish(nvcc_shared(PROBES / 'xxh3_variants.cu', so), 'xxh3_variants.cu')}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.xxh3_parent_run.argtypes = (_P, _N, _N, _P, _P, _P, _P)
    lib.xxh3_variant_run.argtypes = (_N, _P, _N, _P, _P, _N, _N, _P, _P, _P)
    lib.xxh3_short_run.argtypes = (_N, _N, _P, _N, _P, _N, _P, _P, _P)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v: int, data: torch.Tensor, offsets=None, padded=None) -> torch.Tensor:
        count = offsets.numel() - 1 if offsets is not None else padded.count
        out = torch.empty(count, dtype=torch.uint64, device=dev)
        code = lib.xxh3_variant_run(v, data.data_ptr(), data.numel(), offsets.data_ptr() if offsets is not None else None,
                                    padded.lengths.data_ptr() if padded is not None else None,
                                    padded.width if padded is not None else 0, count, X3._key_array(0), out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"xxh3_variant_run {v}: CUDA error {code}")
        return out

    def parent(tokens: T.PaddedTokens) -> torch.Tensor:
        out = torch.empty(tokens.count, dtype=torch.uint64, device=dev)
        code = lib.xxh3_parent_run(tokens.data.data_ptr(), tokens.count, tokens.width, tokens.lengths.data_ptr(),
                                   X3._key_array(0), out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"xxh3_parent_run: CUDA error {code}")
        return out

    tape = datasets.load_tape(None, tokens_mode="words", size_limit="128mb", device=dev)
    buckets = HS.HashBuckets.stage(tape)
    spans = X3.xxh3_64_spans_cuda(tape.data, tape.offsets).view(torch.int64)
    for idx, padded in zip(buckets.indices, buckets.buckets):
        want = spans[idx]
        if not (torch.equal(parent(padded).view(torch.int64), want) and torch.equal(X3.xxh3_64_cuda(padded).view(torch.int64), want)):
            raise AssertionError(f"XXH3 of the bucket of width {padded.width}: the kernels disagree")
    lines = T.PaddedTokens(CS.random_bytes(131072 * 1024, 8, dev).view(131072, 1024),
                           torch.full((131072,), 1024 - 9, dtype=torch.int32, device=dev), 1024)
    if not torch.equal(parent(lines).view(torch.int64), X3.xxh3_64_cuda(lines).view(torch.int64)):
        raise AssertionError("XXH3 of the 1 KiB lines: the kernels disagree")
    for v in XXH3_SETTINGS:
        if not (torch.equal(variant(v, tape.data, offsets=tape.offsets).view(torch.int64), spans)
                and torch.equal(variant(v, lines.data, padded=lines).view(torch.int64), X3.xxh3_64_cuda(lines).view(torch.int64))):
            raise AssertionError(f"XXH3 setting {XXH3_SETTINGS[v]}: the digests differ")
    bound = CS.bound_ms(buckets.token_bytes + 12 * buckets.tokens)[0]
    line_bound = CS.bound_ms(lines.count * (1024 - 9 + 4) + 8 * lines.count)[0]
    cells = {
        "words": (bound, {
            "the package's kernel, the tape's spans (the row's call)": (lambda: X3.xxh3_64_spans_cuda(tape.data, tape.offsets),
                                                                        "xxh3_kernel"),
            "the package's kernel, the buckets": (lambda: [X3.xxh3_64_cuda(p) for p in buckets.buckets], "xxh3_kernel"),
            "the earlier kernel, the buckets": (lambda: [parent(p) for p in buckets.buckets], "parent_xxh3_kernel"),
            **{f"the package's kernel at {name}, the tape's spans": (
                lambda v=v: variant(v, tape.data, offsets=tape.offsets), "xxh3_kernel") for v, name in XXH3_SETTINGS.items()},
        }),
        "1KB-lines": (line_bound, {
            "the package's kernel": (lambda: X3.xxh3_64_cuda(lines), "xxh3_kernel"),
            "the earlier kernel": (lambda: parent(lines), "parent_xxh3_kernel"),
            **{f"the package's kernel at {name}": (lambda v=v: variant(v, lines.data, padded=lines), "xxh3_kernel")
               for v, name in XXH3_SETTINGS.items()},
        }),
    }
    short_out = torch.zeros(tape.count, dtype=torch.uint64, device=dev)

    def short(mode: int, per: int = 1):
        def run():
            code = lib.xxh3_short_run(mode, per, tape.data.data_ptr(), tape.data.numel(), tape.offsets.data_ptr(), tape.count,
                                      X3._key_array(0), short_out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"xxh3_short_run {mode}: CUDA error {code}")
        return run

    lengths = tape.offsets[1:] - tape.offsets[:-1]
    quick = (lengths <= 16) & (torch.arange(tape.count, device=dev) < tape.count - 64)
    for per in (1, 2):
        short_out.zero_()
        short(0, per)()
        if not torch.equal(short_out.view(torch.int64)[quick], spans[quick]):
            raise AssertionError(f"the probe's quick path ({per} a lane) differs from the package's digests")
    cells["words"][1].update({
        "probe: the 0..16-byte path alone": (short(0), "short_kernel"),
        "probe: the 0..16-byte path alone, 2 tokens a lane": (short(0, 2), "short_kernel"),
        "probe: its loads alone (no hashing)": (short(1), "short_kernel"),
        "probe: its hashing alone (no word loads)": (short(2), "short_kernel"),
        "probe: its hashing alone, 2 tokens a lane": (short(2, 2), "short_kernel"),
        "probe: the offsets alone (lengths written)": (short(3), "short_kernel"),
        "probe: the hashing alone with no loads at all": (short(4), "short_kernel"),
        "probe: the hashing alone with no loads at all, 2 tokens a lane": (short(4, 2), "short_kernel"),
    })
    sass = CS.sass_dump(str(build.library_path()))
    if sass:
        (build.BUILD_DIR / "xxh3_sass.txt").write_text("".join("Function : " + part for part in sass.split("Function : ")[1:]
                                                               if "xxh3_kernel" in part.split("\n", 1)[0]))
    print(f"xxh3 words: {tape.count:,} tokens, {buckets.token_bytes:,} B, buckets "
          + ", ".join(f"{p.count:,}x{p.width}" for p in buckets.buckets), flush=True)
    for cell, (cell_bound, calls) in cells.items():
        for name, times in both_orders({name: fn for name, (fn, _) in calls.items()}).items():
            fn, kernel = calls[name]
            traced = CS.device_ms(fn, kernel, calls=20, per_call=True)
            traced_text = f"{traced:.4f}" if traced is not None else "not measured"
            print(f"xxh3 {cell}-128MB, {name}: {', '.join(f'{t:.4f}' for t in times)} ms by CUDA events, "
                  f"{traced_text} ms device a call; bound {cell_bound:.4f} ms (bytes)", flush=True)


def reorder(args) -> None:
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    corpus = build.BUILD_DIR / "probe-multilingual-128mb.txt"
    child = CS.start_corpus(corpus)
    try:
        reorder_cells(dev, child, corpus)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        corpus.unlink(missing_ok=True)
        corpus.with_name(corpus.name + ".part").unlink(missing_ok=True)


def reorder_cells(dev, child: subprocess.Popen, corpus: Path) -> None:
    so = build.BUILD_DIR / "probe_reorder_variants.so"
    print(f"reorder_variants.cu built: {finish(nvcc_shared(PROBES / 'reorder_variants.cu', so), 'reorder_variants.cu')}",
          flush=True)
    lib = ctypes.CDLL(str(so))
    lib.reorder_parent_run.argtypes = (_P, _P, _N, _N, _P, _N, _P)
    lib.reorder_variant_run.argtypes = (_N, _P, _P, _N, _N, _P, _N, _P)
    lib.reorder_loads_run.argtypes = (_N, _P, _P, _N, _N, _P)
    ccc = NORM._ccc_on(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v: int):
        def run(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
            code = lib.reorder_variant_run(v, rows.data_ptr(), counts.data_ptr(), rows.shape[0], rows.shape[1], ccc.data_ptr(),
                                           ccc.numel(), stream)
            if code:
                raise RuntimeError(f"reorder_variant_run {v}: CUDA error {code}")
            return rows
        return run

    def parent(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        code = lib.reorder_parent_run(rows.data_ptr(), counts.data_ptr(), rows.shape[0], rows.shape[1], ccc.data_ptr(),
                                      ccc.numel(), stream)
        if code:
            raise RuntimeError(f"reorder_parent_run: CUDA error {code}")
        return rows

    kernels = {"the package's kernel": (NORM.reorder_rows_cuda_, "nf_reorder_kernel"),
               "the earlier kernel": (parent, "parent_reorder_kernel"),
               **{f"the package's kernel at {name}": (variant(v), "nf_reorder_kernel") for v, name in REORDER_SETTINGS.items()}}

    def cell(name: str, rows: torch.Tensor, counts: torch.Tensor) -> None:
        want = NORM.reorder_rows_plain_(rows.clone(), counts)
        live = int(counts.sum())
        moved = int((want != rows).sum())
        bound = CS.bound_ms(4 * live + 4 * moved + 4 * counts.numel())[0]
        for label, (fn, _) in kernels.items():
            if not torch.equal(fn(rows.clone(), counts), want):
                raise AssertionError(f"reorder {name}: {label} differs from reorder_rows_plain_")
        print(f"reorder {name}: {rows.shape[0]:,} rows of {rows.shape[1]}, {live:,} codepoints, {moved:,} moved; "
              f"bound {bound:.4f} ms (bytes)", flush=True)
        for label, (fn, kernel) in list(kernels.items()) + list(kernels.items())[::-1]:
            traced = CS.device_ms(lambda: fn(rows.clone(), counts), kernel, calls=20)
            print(f"reorder {name}, {label}: {traced:.4f} ms device a launch" if traced is not None
                  else f"reorder {name}, {label}: not measured", flush=True)
        over = counts > 128
        print(f"reorder {name}: {int(over.sum()):,} rows over 128 codepoints, {int(counts[over].sum()):,} of their codepoints",
              flush=True)
        if rows.shape[1] % 4 == 0:
            for v, label in {0: "1 row a warp", 1: "2 rows", 2: "2 rows, both chunks at once", 3: "4 rows, both chunks"}.items():
                def run(v=v):
                    code = lib.reorder_loads_run(v, rows.data_ptr(), counts.data_ptr(), rows.shape[0], rows.shape[1], stream)
                    if code:
                        raise RuntimeError(f"reorder_loads_run {v}: CUDA error {code}")
                traced = CS.device_ms(run, "loads_kernel", calls=20)
                print(f"reorder {name}, probe: the loads alone, {label}: "
                      + (f"{traced:.4f} ms device a launch" if traced is not None else "not measured"), flush=True)
        if not moved:  # the rows are their own output: time the launches in place
            for label, times in both_orders({label: (lambda fn=fn: fn(rows, counts)) for label, (fn, _) in kernels.items()}).items():
                print(f"reorder {name}, {label}, in place: {', '.join(f'{t:.4f}' for t in times)} ms by CUDA events", flush=True)

    marks = NORM.segment_rows(torch.from_numpy(CS.marks_stream(32 << 20, 17)).to(dev), False)[0]
    cell("marks-128MB", marks.rows, marks.lengths)
    del marks
    if child.wait():
        raise RuntimeError(f"synthesizing the multilingual corpus failed (exit code {child.returncode})")
    raw = corpus.read_bytes()
    data = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
    lead, cps = NS.corpus_codepoints(data)
    stage = NS.stage_form("NFD", NS.quick_rows(data, False, lead, cps), lead, cps, NS.corpus_max_cp(raw.decode()))
    b = stage.buckets[0]
    if NORM.decompose_route(False, stage.slow_max, b.width) == "expand":
        fused, max_exp = NORM._decomp_fused_tables(False, stage.slow_max)
        src, counts = EX.expand_compact_rows(b.rows, b.lengths, fused, max_exp, b.width, False)
    else:
        src, counts = NORM.decompose_rows_cuda(b.rows, b.lengths, NORM.decomp_tables(False, stage.slow_max))
    print(f"reorder nfd: the slow rows' ceiling {stage.slow_max:#x}", flush=True)
    cell("nfd-128MB", src, counts)


def save_sass(library: str, holds: tuple, path: Path) -> str:
    """The SASS of the library's functions whose names hold any of ``holds``,
    written to ``path``; a line of each one's instruction count and local
    memory operations (LDL/STL)."""
    dump = CS.sass_dump(library)
    if dump is None:
        return "SASS not measured (no cuobjdump)"
    parts = ["Function : " + part for part in dump.split("Function : ")[1:] if any(h in part.split("\n", 1)[0] for h in holds)]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(parts))
    lines = []
    for part in parts:
        name = part.split("\n", 1)[0].split("Function : ")[1].strip()
        body = [ln for ln in part.splitlines() if "/*0" in ln and ";" in ln]
        local = sum(1 for ln in body if " LDL" in ln or " STL" in ln)
        lines.append(f"{name}: {len(body)} instructions, {local} LDL/STL")
    return "; ".join(lines)


def labeled_ptxas(proc: subprocess.Popen, what: str, holds: tuple) -> str:
    """``finish`` with each line of the functions whose names hold any of
    ``holds`` under its name: registers, stack frame and spills."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{log[-3000:]}")
    own, function = {}, "?"
    for line in log.splitlines():
        if "Function properties for " in line or "Compiling entry function" in line:
            function = line.rsplit(" ", 1)[-1].strip("'")
        elif any(h in function for h in holds) and ("spill" in line or "registers" in line):
            own.setdefault(function, []).append(line.split(":", 1)[-1].strip())
    return "; ".join(f"{name}: {' | '.join(lines)}" for name, lines in own.items())


def spans(args) -> None:
    """The per-token hashes over the hash suite's tape (the spans form, one
    launch) beside the same kernels over its buckets, and over 1 KiB lines
    (the padded entry points and the lines end to end), beside
    ``--other-tree``'s padded kernels (a checkout of the parent: one thread a
    row); the kernels at other register budgets (``spans_variants.cu``),
    with each instance's ptxas lines."""
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_spans_variants.so"
    variants_build = nvcc_shared(PROBES / "spans_variants.cu", so)
    other = ctypes.CDLL(other_library(Path(args.other_tree))) if args.other_tree else None
    tape = datasets.load_tape(None, tokens_mode="words", size_limit="128mb", device=dev)
    buckets = HS.HashBuckets.stage(tape)
    lines, line_tape, line_offsets = CS.kb_lines(dev)
    seeds8 = list(HS.MULTISEEDS)
    stream = torch.cuda.current_stream().cuda_stream

    def parent(p: T.PaddedTokens, seeds: list, kind: str) -> torch.Tensor:
        out = torch.empty((len(seeds), p.count), dtype=torch.uint32 if kind == "xxh32" else torch.uint64, device=dev)
        seed_array = (ctypes.c_uint64 * len(seeds))(*seeds)
        if kind == "xxh64":
            code = other.sw_xxh64(_P(p.data.data_ptr()), _N(p.count), _N(p.width), _P(p.lengths.data_ptr()), seed_array,
                                  _N(len(seeds)), _P(out.data_ptr()), _P(stream))
        else:
            code = other.sw_xxh32(_P(p.data.data_ptr()), _N(p.count), _N(p.width), _P(p.lengths.data_ptr()), seed_array,
                                  _N(len(seeds)), ctypes.c_int(kind != "xxh32"), _P(out.data_ptr()), _P(stream))
        if code:
            raise RuntimeError(f"the other tree's {kind}: CUDA error {code}")
        return out

    forms = {  # name: (spans call, rows call, digest bytes, seeds, the kernel family)
        "xxh64": (lambda d, o: HC.xxh64_spans_cuda(d, o), lambda p: HC.xxh64(p, [0])[0], 8, [0], "xxh64"),
        "swh64": (lambda d, o: HC.swh64_spans_cuda(d, o), lambda p: HC.swh64(p, [0])[0], 8, [0], "swh64"),
        "xxh32": (lambda d, o: HC.xxh32_spans_cuda(d, o), lambda p: HC.xxh32(p, [0])[0], 4, [0], "xxh32"),
        "swh64_multiseed8": (lambda d, o: HC.swh64_multiseed_spans_cuda(d, o, seeds8), lambda p: HC.swh64(p, seeds8), 64, seeds8,
                             "swh64"),
    }
    kernel = {"xxh64": "xxh64_kernel", "swh64": "xxh32_kernel", "xxh32": "xxh32_kernel", "swh64_multiseed8": "xxh32_kernel"}

    def timed(cell: str, calls: dict, note: str = "") -> None:
        for label, times in both_orders(calls).items():
            traced = CS.device_ms(calls[label], kernel[cell.split("-")[0]], calls=20, per_call=True)
            print(f"spans {cell}, {label}: {', '.join(f'{t:.4f}' for t in times)} ms by CUDA events, "
                  + (f"{traced:.4f}" if traced is not None else "not measured") + f" ms device a call{note}", flush=True)

    for name, (span_fn, row_fn, size, seeds, family) in forms.items():
        one = len(seeds) == 1
        pick = 0 if one else slice(None)
        got = span_fn(tape.data, tape.offsets)
        for idx, padded in zip(buckets.indices, buckets.buckets):
            if not torch.equal(CS.signed(got)[..., idx], CS.signed(row_fn(padded))):
                raise AssertionError(f"{name}: the spans form differs from the rows form in the bucket of width {padded.width}")
            if other is not None and not torch.equal(CS.signed(row_fn(padded)), CS.signed(parent(padded, seeds, family)[pick])):
                raise AssertionError(f"{name}: the rows form differs from the other tree's in the bucket of width {padded.width}")
        least = CS.bound_ms(tape.total_bytes + 8 * (tape.count + 1) + size * tape.count)[0]
        calls = {"spans": lambda: span_fn(tape.data, tape.offsets), "buckets": lambda: [row_fn(p) for p in buckets.buckets]}
        if other is not None:
            calls["the other tree's buckets"] = lambda: [parent(p, seeds, family) for p in buckets.buckets]
        timed(f"{name}-words-128MB", calls, f"; the spans call's own bytes {least:.4f} ms")
        if not torch.equal(CS.signed(span_fn(line_tape, line_offsets)), CS.signed(row_fn(lines))):
            raise AssertionError(f"{name}: the spans form differs from the rows form on the 1 KiB lines")
        calls = {"spans (end to end)": lambda: span_fn(line_tape, line_offsets), "rows": lambda: row_fn(lines)}
        if other is not None:
            if not torch.equal(CS.signed(row_fn(lines)), CS.signed(parent(lines, seeds, family)[pick])):
                raise AssertionError(f"{name}: the rows form differs from the other tree's on the 1 KiB lines")
            calls["the other tree's rows"] = lambda: parent(lines, seeds, family)
        timed(f"{name}-1KB-lines-128MB", calls)
    holds = ("xxh64_kernel", "xxh32_kernel")
    print(f"spans_variants.cu built: {labeled_ptxas(variants_build, 'spans_variants.cu', holds)}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.spans_variant_run.argtypes = (_N, _N, _N, _P, _N, _P, _P, _N, _N, _P, _P, _P)
    seed_array = (ctypes.c_uint64 * 8)(*seeds8)
    for kind, name in {0: "xxh64", 1: "xxh32", 2: "swh64", 3: "swh64_multiseed8"}.items():
        cells = [("words", tape.data, tape.offsets, None, 0, tape.count, forms[name][0](tape.data, tape.offsets)),
                 ("1KB-lines", lines.data, None, lines.lengths, lines.width, lines.count, forms[name][1](lines))]
        budgets = [(4, 0), (5, 0), (6, 0), (5, 1)] if kind < 3 else [(1, 0), (2, 0), (3, 0), (3, 1)]
        for cell, data, offsets, lengths, width, count, want in cells:
            for blocks, whole in budgets:
                out = torch.empty_like(want)

                def run(kind=kind, blocks=blocks, whole=whole, out=out, data=data, offsets=offsets, lengths=lengths,
                        width=width, count=count):
                    code = lib.spans_variant_run(kind, blocks, whole, data.data_ptr(), data.numel(),
                                                 offsets.data_ptr() if offsets is not None else None,
                                                 lengths.data_ptr() if lengths is not None else None, width, count, seed_array,
                                                 out.data_ptr(), stream)
                    if code:
                        raise RuntimeError(f"spans_variant_run {kind} {blocks}: CUDA error {code}")

                run()
                if not torch.equal(CS.signed(out), CS.signed(want)):
                    raise AssertionError(f"variant {name} at {blocks} blocks differs from the package's digests ({cell})")
                traced = CS.device_ms(run, kernel[name], calls=20, per_call=True)
                grid = "a block a 256 tokens" if whole else "a resident grid"
                print(f"spans {name}-{cell}-128MB ({'spans' if offsets is not None else 'rows'}) at {blocks} blocks an SM, "
                      f"{grid}: " + (f"{traced:.4f}" if traced is not None else "not measured") + " ms device a call", flush=True)
    print("spans SASS: " + save_sass(str(build.library_path()), ("xxh64_kernelILi1ELb1", "xxh32_kernelILi1ELb0ELb1",
                                                                  "xxh32_kernelILi1ELb1ELb1", "xxh32_kernelILi8ELb1ELb1"),
                                     ROOT / "chiprun_out" / "sass_spans.txt"), flush=True)


def compose(args) -> None:
    """The composition kernel over the marks rows and the corpus' NFD, beside
    ``--other-tree``'s (a checkout of the parent: its kernel takes the ccc
    table)."""
    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    corpus = build.BUILD_DIR / "probe-multilingual-128mb.txt"
    child = CS.start_corpus(corpus)
    so = build.BUILD_DIR / "probe_compose_variants.so"
    variants_build = nvcc_shared(PROBES / "compose_variants.cu", so)
    try:
        other = ctypes.CDLL(other_library(Path(args.other_tree))) if args.other_tree else None
        print(f"compose_variants.cu built: {finish(variants_build, 'compose_variants.cu')}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.compose_variant_run.argtypes = (_N, _P, _P, _P, _N, _N, _P, _N, _P, _N, _P, _N, _P, _N, _P)
        classes = NORM._compose_classes_on(dev)
        ccc = NORM._ccc_on(dev)
        s_rank, c_rank, dense, n_c = NORM._compose_tables(dev)
        stream = torch.cuda.current_stream().cuda_stream

        def parent(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
            kept = torch.empty_like(counts)
            code = other.sw_nf_compose_rows(_P(rows.data_ptr()), _P(counts.data_ptr()), _P(kept.data_ptr()), _N(rows.shape[0]),
                                            _N(rows.shape[1]), _P(ccc.data_ptr()), _N(ccc.numel()), _P(s_rank.data_ptr()),
                                            _N(s_rank.numel()), _P(c_rank.data_ptr()), _N(c_rank.numel()), _P(dense.data_ptr()),
                                            _N(n_c), _P(stream))
            if code:
                raise RuntimeError(f"the other tree's sw_nf_compose_rows: CUDA error {code}")
            return kept

        def variant(v: int):
            def run(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
                kept = torch.empty_like(counts)
                code = lib.compose_variant_run(v, rows.data_ptr(), counts.data_ptr(), kept.data_ptr(), rows.shape[0], rows.shape[1],
                                               classes.data_ptr(), classes.numel(), s_rank.data_ptr(), s_rank.numel(),
                                               c_rank.data_ptr(), c_rank.numel(), dense.data_ptr(), n_c, stream)
                if code:
                    raise RuntimeError(f"compose_variant_run {v}: CUDA error {code}")
                return kept
            return run

        kernels = {"the package's kernel": NORM.compose_rows_cuda_}
        if other is not None:
            kernels[f"{args.other_tree}'s kernel"] = parent
        kernels.update({"the package's kernel at a warp a row, 2 blocks an SM": variant(0),
                        "the package's kernel at half a warp a row, 3 blocks": variant(5),
                        "the package's kernel at a quarter warp a row, 2 blocks": variant(8),
                        "the package's kernel at a quarter warp a row, 3 blocks": variant(9)})
        skeleton = {"probe: no chain walked, a warp a row, 2 blocks": variant(2),
                    "probe: no chain walked, half a warp a row, 2 blocks": variant(6),
                    "probe: no chain walked, a quarter warp a row, 2 blocks": variant(10)}

        def cell(name: str, rows: torch.Tensor, counts: torch.Tensor) -> None:
            want = rows.clone()
            kept = NORM.compose_rows_plain_(want, counts)
            live = int(counts.sum())
            for label, fn in kernels.items():
                got = rows.clone()
                if not (torch.equal(fn(got, counts), kept) and torch.equal(got, want)):
                    raise AssertionError(f"compose {name}: {label} differs from compose_rows_plain_")
            bound = CS.bound_ms(8 * live + 8 * counts.numel())[0]
            print(f"compose {name}: {rows.shape[0]:,} rows of {rows.shape[1]}, {live:,} codepoints, {live - int(kept.sum()):,} "
                  f"composed away; bound {bound:.4f} ms (bytes)", flush=True)
            timed = list(kernels.items()) + list(skeleton.items())
            for label, fn in timed + timed[::-1]:
                traced = CS.device_ms(lambda fn=fn: fn(rows.clone(), counts), "nf_compose_kernel", calls=20)
                print(f"compose {name}, {label}: " + (f"{traced:.4f} ms device a launch" if traced is not None
                                                       else "not measured"), flush=True)

        marks = NORM.segment_rows(torch.from_numpy(CS.marks_stream(32 << 20, 17)).to(dev), False)[0]
        rows = NORM.reorder_rows_cuda_(marks.rows.clone(), marks.lengths)
        cell("marks-128MB", rows, marks.lengths)
        del marks, rows
        if child.wait():
            raise RuntimeError(f"synthesizing the multilingual corpus failed (exit code {child.returncode})")
        import unicodedata

        text = unicodedata.normalize("NFD", corpus.read_bytes().decode())
        nfd = torch.from_numpy(np.frombuffer(text.encode("utf-32-le"), np.int32).copy()).to(dev)
        b = NORM.segment_rows(nfd, False)[0]
        src, counts = NORM.decompose_rows(b.rows, b.lengths, False, int(nfd.max()))
        cell("nfc-of-nfd-128MB", src, counts)
        print("compose SASS: " + save_sass(str(build.library_path()), ("nf_compose_kernel",), ROOT / "chiprun_out" / "sass_compose.txt"),
              flush=True)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        corpus.unlink(missing_ok=True)
        corpus.with_name(corpus.name + ".part").unlink(missing_ok=True)


# The earlier kernel's entry points (a checkout of the parent of the
# one-sweep passes, ``--other-tree``): the spread, then a histogram, a scan
# and a scatter a pass of the plan the caller gives.
EARLIER_SIGNATURES = {"sw_radix_spread": (_P, _N, _N, _P, _P),
                      "sw_radix_argsort": (_P, _N, _N, _P, _N, _P, _P, _P, _P, _P, _P, _P)}
EARLIER_LAUNCHES = {"spread": "radix_spread", "histogram": "radix_histogram", "scan": "radix_scan",
                    "scatter": "radix_scatter"}
SWEEP_LAUNCHES = {"spread": "radix_spread", "digit count": "radix_digits", "passes": "radix_sweep"}
# tools/hopper_probes/radix_variants.cu's settings (SW_RADIX_*: the package's
# radixsort.cu with the switches) built beside the package's; a variant
# whose name says "timing only" gives a wrong order and is not held to the
# plain one.
SWEEP_VARIANTS = {
    "scatter from registers": {"SW_RADIX_DIRECT_SCATTER": 1},
    "ranks by ballots": {"SW_RADIX_BALLOT_RANK": 1},
    "registers unbounded (2 blocks an SM)": {"SW_RADIX_MIN_BLOCKS": 1},
    "3 blocks an SM": {"SW_RADIX_MIN_BLOCKS": 3},
    "digit counts a warp": {"SW_RADIX_WARP_COUNTS": 1},
    "no look-back (timing only)": {"SW_RADIX_LOOKBACK": 0},
}


def launch_times(fn, kernel: str, expect: int) -> list[float] | None:
    """Device ms of each launch of the kernels whose names hold ``kernel`` in
    one call of ``fn``, in launch order (``torch.profiler``; a trace that
    lacks some of the ``expect`` launches is taken again, up to 3 times)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if kernel in e.name and e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if len(events) == expect:
            return [e.time_range.elapsed_us() / 1e3 for e in events]
    return None


def sort(args) -> None:
    """The radix argsort's forms over the words' byte and uncased columns,
    and the uncased keys kernel."""
    from stringwars_tpu_torch.ops import sort as SORT
    from stringwars_tpu_torch.ops import sort_cuda as SC

    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant_so = {name: build.BUILD_DIR / f"probe_radix_{i}.so" for i, name in enumerate(SWEEP_VARIANTS)}
    procs = {name: nvcc_shared(PROBES / "radix_variants.cu", variant_so[name], defines)
             for name, defines in SWEEP_VARIANTS.items()}
    earlier = ctypes.CDLL(other_library(Path(args.other_tree))) if args.other_tree else None
    build.library()
    tape = datasets.load_tape(None, tokens_mode="words", size_limit="128mb", device=dev)
    n = tape.count
    prefix = T.PaddedTokens.from_tape(tape, align=4, max_width=SORT.PREFIX_WIDTH)
    byte_cols = SORT.byte_columns(prefix.data, prefix.lengths)
    del prefix
    rows, key_lengths, _ = SORT.stage_uncased(tape)
    n_cols, pack3 = SORT.uncased_plan(rows.data, key_lengths)
    uncased_cols = SC.uncased_keys(rows.data, key_lengths, n_cols, pack3)
    for name, proc in procs.items():
        print(f"ptxas, {name}: {finish(proc, name)}", flush=True)
    variants = {name: ctypes.CDLL(str(so)) for name, so in variant_so.items()}
    for lib, signatures in ((earlier, EARLIER_SIGNATURES), *((lib, build.SIGNATURES) for lib in variants.values())):
        for fn_name, argtypes in signatures.items():
            if lib is not None and hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def earlier_kernel(cols: torch.Tensor, passes: list[tuple[int, int]]) -> torch.Tensor:
        """The earlier kernel's call as its wrapper made it: the spread
        launch and readback, then the passes of the plan."""
        k_cols, m = cols.shape
        spread = torch.empty(2 * k_cols, dtype=torch.int32, device=dev)
        if earlier.sw_radix_spread(cols.data_ptr(), k_cols, m, spread.data_ptr(), stream):
            raise RuntimeError("the earlier kernel's spread failed")
        spread.tolist()
        plan = (ctypes.c_int64 * (2 * len(passes)))(*(v for p in passes for v in p))
        order = torch.empty(m, dtype=torch.int32, device=dev)
        scratch = torch.empty((3, m), dtype=torch.int32, device=dev)
        counts = torch.empty(512 * -(-m // SC.TILE), dtype=torch.int32, device=dev)
        totals = torch.empty(512, dtype=torch.int32, device=dev)
        if earlier.sw_radix_argsort(cols.data_ptr(), k_cols, m, plan, len(passes), order.data_ptr(), scratch[0].data_ptr(),
                                    scratch[1].data_ptr(), scratch[2].data_ptr(), counts.data_ptr(), totals.data_ptr(),
                                    stream):
            raise RuntimeError("the earlier kernel failed")
        return order

    def variant(cols: torch.Tensor, lib) -> torch.Tensor:
        with mock.patch.object(build, "library", lambda: lib):
            return SC.radix_argsort(cols)

    for keys, cols in (("byte columns", byte_cols), (f"uncased columns ({'pack3' if pack3 else 'one a column'})", uncased_cols)):
        want, passes = SC.radix_argsort_planned(cols)  # the plan the package's call ran
        gathers = [k == 0 or passes[k - 1][0] != c for k, (c, _) in enumerate(passes)]
        if not torch.equal(want, SORT.lsd_argsort_plain(cols)):
            raise AssertionError(f"the package's kernel over the {keys}: the order differs from lsd_argsort_plain")
        forms = {"one-sweep (the package's)": (lambda cols=cols: SC.radix_argsort(cols), SWEEP_LAUNCHES, "radix_sweep")}
        if earlier is not None:
            forms[f"three-launch ({args.other_tree}'s kernel)"] = (
                lambda cols=cols, passes=passes: earlier_kernel(cols, passes), EARLIER_LAUNCHES, "radix_scatter")
        forms.update({f"one-sweep, {name}": (lambda cols=cols, lib=lib: variant(cols, lib), SWEEP_LAUNCHES, "radix_sweep")
                      for name, lib in variants.items()})
        for form, (fn, _, _) in forms.items():
            if "timing only" not in form and not torch.equal(fn(), want):
                raise AssertionError(f"{form} over the {keys}: the order differs from lsd_argsort_plain")
        del want
        print(f"{keys}: {n:,} keys, {cols.shape[0]} columns, {len(passes)} passes ({sum(gathers)} gathering); "
              f"a pass's (index, key) read and written once: {16 * n / 3.35e9:.4f} ms at 3.35 TB/s", flush=True)
        times = both_orders({form: fn for form, (fn, _, _) in forms.items()})
        for form, (fn, launches, per_pass) in forms.items():
            split = CS.device_breakdown(fn, launches, calls=5)
            each = launch_times(fn, per_pass, len(passes))
            print(f"  {form}: CUDA events {_fmt(times[form])} ms a call; profiler device ms a call: "
                  + ("not measured" if split is None else
                     ", ".join(f"{k} {split[k]:.4f}" for k in launches) + f", memsets and copies {split['torch']:.4f}")
                  + "; " + ("per pass not measured" if each is None else "per pass (g: gathers) " + ", ".join(
                      f"{t:.4f}{'g' if g else ''}" for t, g in zip(each, gathers))), flush=True)
    del byte_cols, uncased_cols

    padded_bytes = rows.data.numel()
    calls = {"uncased keys kernel": lambda: SC.uncased_keys(rows.data, key_lengths, n_cols, pack3),
             "its plan mode": lambda: SC.uncased_extent(rows.data, key_lengths),
             "the earlier torch route (uncased_keys_plain)": lambda: SORT.uncased_keys_plain(rows.data, key_lengths, n_cols,
                                                                                           pack3)}
    bound = (padded_bytes + 4 * n + 4 * n_cols * n) / 3.35e9
    print(f"uncased keys: {n:,} rows of {rows.width} B to {n_cols} columns; bound {bound:.4f} ms (the rows and key "
          f"lengths read once, the columns written once, at 3.35 TB/s)", flush=True)
    for name, fn in calls.items():
        print(f"  {name}: CUDA events {events_ms(fn, launches=3 if 'torch' in name else 20):.4f} ms a call", flush=True)
    launches = {"uncased keys": "uncased_keys_kernel", **SWEEP_LAUNCHES}
    split = CS.device_breakdown(lambda: SORT.uncased_order(rows.data, key_lengths, n_cols, pack3), launches, calls=5)
    print("  the uncased order by launch (profiler device ms a call): " + (
        "not measured" if split is None else ", ".join(f"{k} {split[k]:.4f}" for k in launches)
        + f", other device work {split['torch']:.4f}, total {split['total']:.4f}"), flush=True)


# tools/hopper_probes/uncased_variants.cu's entry point and its modes (the
# earlier kernel, a thread a row, with its parts switched off; only mode 0
# computes the function).
PARENT_UNCASED = {"uncased_parent_run": (_N, _P, _P, _N, _N, _P, _N, _N, _N, _P, _P)}
PARENT_MODES = {0: "the earlier kernel (a thread a row)", 1: "the earlier kernel, staging alone (timing only)",
                2: "the earlier kernel, the walk without stores (timing only)",
                3: "the earlier kernel, the stores alone, columns made in registers (timing only)",
                4: "the earlier kernel, staging and the stores, no walk (timing only)"}
# tools/hopper_probes/uncased_settings.cu (csrc/uncased_keys.cu with its
# settings as SW_UNCASED_* switches) built at other settings, each exporting
# uncased_setting_run with sw_uncased_keys' arguments; "timing only" builds
# give wrong columns and are not held to the plain version.
UNCASED_VARIANTS = {
    "tiles of 8 columns": {"SW_UNCASED_TILE": 8},
    "every row through the walk (no ASCII path)": {"SW_UNCASED_ASCII": 0},
    "256 rows a block": {"SW_UNCASED_ROWS": 256},
    "registers for 6 blocks of 256 rows an SM": {"SW_UNCASED_MIN_BLOCKS": 6},
    "no walk of the listed rows (timing only)": {"SW_UNCASED_WALK": 0},
    "the walk with no table load (timing only)": {"SW_UNCASED_FOLD": 0},
}


def uncased_shapes(dev):
    """(name, rows, key lengths) of the uncased keys at the rows the probe
    times: the hash suite's 128 MB of words (``uncased-keys-words-128MB``),
    the sequence path's 16 MB of words and 8 MB of ``synthetic:multilingual``
    words (``chip_smoke.py``'s sequence path: the corpus' first 8 MiB), and
    those multilingual rows with each byte from 0x80 up made ``x`` (ASCII
    rows of the same lengths)."""
    from stringwars_tpu_torch.ops import sort as SORT

    shapes = []
    for name, limit in (("words-128MB", "128mb"), ("seq-words-16MB", "16mb")):
        tape = datasets.load_tape(None, tokens_mode="words", size_limit=limit, device=dev)
        rows, key_lengths, _ = SORT.stage_uncased(tape)
        shapes.append((name, rows.data, key_lengths))
        del tape
    corpus = datasets.synthesize("multilingual", (8 << 20) + 4096)[: 8 << 20]
    rows, key_lengths, _ = SORT.stage_uncased(T.Tape.from_buffer(corpus, "words", device=dev))
    shapes.append(("seq-multilingual-8MB", rows.data, key_lengths))
    shapes.append(("seq-multilingual-8MB, bytes from 0x80 made 'x'",
                   torch.where(rows.data >= 0x80, torch.full_like(rows.data, ord("x")), rows.data), key_lengths))
    return shapes


def uncased(args) -> None:
    """The uncased keys kernel taken apart and timed at the rows that run it:
    the earlier kernel's parts, the package's kernel and its settings, and
    ``--other-tree``'s kernel, in one process."""
    from stringwars_tpu_torch.ops import sort as SORT
    from stringwars_tpu_torch.ops import sort_cuda as SC

    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    parent_so = build.BUILD_DIR / "probe_uncased_parent.so"
    variant_so = {name: build.BUILD_DIR / f"probe_uncased_{i}.so" for i, name in enumerate(UNCASED_VARIANTS)}
    procs = {"the earlier kernel": nvcc_shared(PROBES / "uncased_variants.cu", parent_so)}
    procs.update({name: nvcc_shared(PROBES / "uncased_settings.cu", variant_so[name], defines)
                  for name, defines in UNCASED_VARIANTS.items()})
    other = ctypes.CDLL(other_library(Path(args.other_tree))) if args.other_tree else None
    build.library()
    shapes = uncased_shapes(dev)
    for name, proc in procs.items():
        print(f"ptxas, {name}: {finish(proc, name)}", flush=True)
    parent = ctypes.CDLL(str(parent_so))
    parent.uncased_parent_run.argtypes = PARENT_UNCASED["uncased_parent_run"]
    parent.uncased_parent_run.restype = ctypes.c_int
    entries = {name: ctypes.CDLL(str(so)).uncased_setting_run for name, so in variant_so.items()}
    if other is not None:
        entries[f"{args.other_tree}'s kernel"] = other.sw_uncased_keys
    for entry in entries.values():
        entry.argtypes = build.SIGNATURES["sw_uncased_keys"]
        entry.restype = ctypes.c_int
    table = SC._staged_table(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def parent_call(mode: int, rows, lengths, out, n_cols: int, pack3: bool):
        code = parent.uncased_parent_run(mode, rows.data_ptr(), lengths.data_ptr(), rows.shape[0], rows.shape[1],
                                         table.data_ptr(), table.shape[0], n_cols, int(pack3), out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"uncased_parent_run mode {mode}: CUDA error {code}")
        return out

    def entry_call(entry, rows, lengths, out, n_cols: int, pack3: bool):
        code = entry(rows.data_ptr(), lengths.data_ptr(), rows.shape[0], rows.shape[1], table.data_ptr(),
                     table.shape[0], n_cols, int(pack3), 0, out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"{entry.__name__} of another build: CUDA error {code}")
        return out

    plan_of = {}
    for shape, rows, lengths in shapes:
        n = rows.shape[0]
        if shape not in plan_of:  # the ASCII twin takes the multilingual rows' plan: the same columns to make
            plan_of[shape] = plan_of.get(shape.split(",")[0]) or SORT.uncased_plan(rows, lengths)
        n_cols, pack3 = plan_of[shape]
        ascii_rows = int(((rows >= 0x80) & (torch.arange(rows.shape[1], device=dev)[None, :]
                                            < lengths.clamp(0, rows.shape[1])[:, None])).any(1).logical_not().sum())
        bound = (rows.numel() + 4 * n + 4 * n_cols * n) / 3.35e9
        print(f"{shape}: {n:,} rows of {rows.shape[1]} B ({ascii_rows:,} ASCII below their key lengths, "
              f"{int(lengths.sum()):,} key bytes) to {n_cols} columns {'of three codepoints' if pack3 else 'of a codepoint'}; "
              f"bound {bound:.4f} ms (the rows and key lengths read once, the columns written once, at 3.35 TB/s)",
              flush=True)
        want = SORT.uncased_keys_plain(rows, lengths, n_cols, pack3)
        outs = {}
        calls = {"the package's kernel": lambda: SC.uncased_keys(rows, lengths, n_cols, pack3),
                 "the package's plan mode": lambda: SC.uncased_extent(rows, lengths)}
        for mode, label in PARENT_MODES.items():
            outs[label] = torch.empty((n_cols, n), dtype=torch.int32, device=dev)
            calls[label] = lambda mode=mode, out=outs[label]: parent_call(mode, rows, lengths, out, n_cols, pack3)
        for label, entry in entries.items():
            outs[label] = torch.empty((n_cols, n), dtype=torch.int32, device=dev)
            calls[label] = lambda entry=entry, out=outs[label]: entry_call(entry, rows, lengths, out, n_cols, pack3)
        for label, fn in calls.items():
            if "timing only" in label or "plan" in label:
                continue
            if not torch.equal(fn(), want):
                raise AssertionError(f"uncased {shape}: {label} differs from uncased_keys_plain")
        del want
        times = both_orders(calls)
        for label in calls:
            print(f"  {label}: CUDA events {_fmt(times[label])} ms a call", flush=True)
        del outs, calls
        torch.cuda.empty_cache()
    _, rows, lengths = shapes[1]
    n_cols, pack3 = plan_of[shapes[1][0]]
    launches = {"uncased keys": "uncased_keys_kernel", **SWEEP_LAUNCHES}
    split = CS.device_breakdown(lambda: SORT.uncased_order(rows, lengths, n_cols, pack3), launches, calls=5)
    print(f"the uncased order of {shapes[1][0]} by launch (profiler device ms a call): " + (
        "not measured" if split is None else ", ".join(f"{k} {split[k]:.4f}" for k in launches)
        + f", other device work {split['torch']:.4f}, total {split['total']:.4f}"), flush=True)


# The earlier Bloom entry points (a checkout of the parent, ``--other-tree``):
# the build ORs into words the caller zeroed, the query sets its answers to
# 1 first and clears them.
EARLIER_BLOOM = {"sw_bloom_build": (_P, _N, _P, _P, _N, _N, _P, _N, _N, _P, _P),
                 "sw_bloom_query": (_P, _N, _P, _P, _N, _N, _P, _N, _N, _P, _P, _P)}
FILTER_VARIANTS = {"filter_variant_run": (_N, _P, _N, _P, _N, _P, _N, _N, _P, _P, _P, _P, _P),
                   "query_variant_run": (_N, _P, _N, _P, _N, _P, _N, _N, _P, _P, _P),
                   "cluster_build_run": (_P, _N, _P, _N, _P, _N, _N, _P, _P, _N, _N, _N, _N, _P),
                   "cluster_capacity": (_N, _N, _P),
                   "fuse_floor_run": (_P, _N, _P, _P, _N, _P, _P)}
CLUSTER_REGIMES = ("global", "store", "atomic", "copies")  # cluster_build_run's regime codes


def filter_shapes(dev):
    """(name, inserted, held out, seeds, m_bits): the containers suite over
    ``chip_smoke.py``'s 32 MB of words (its unique tokens, the first 80%
    inserted), and ``chip_smoke.py``'s 1,000,000 random lowercase words of
    5-17 B, the suite's key cap, split the same way."""
    from stringwars_tpu_torch.suites import containers as CT

    words = datasets.load_tape(None, tokens_mode="words", size_limit="32mb")
    suite = T.Tape.from_tokens(list(dict.fromkeys(words.to_list()))[: CT.MAX_KEYS], device=dev)
    rng = np.random.default_rng(49)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    big = list(dict.fromkeys(alphabet[rng.integers(0, 26, n)].tobytes() for n in rng.integers(5, 18, 1_002_000)))[:1_000_000]
    cap = T.Tape.from_tokens(big, device=dev)
    for name, tape in (("suite", suite), ("cap", cap)):
        cut = int(tape.count * 0.8)
        yield name, tape.subtape(0, cut), tape.subtape(cut, tape.count), CT.BLOOM_SEEDS, CT.bloom_bits(cut)


def host_us(fn, calls: int = 100, samples: int = 5) -> float:
    """Host µs a call: the median over ``samples`` runs of ``calls`` calls
    enqueued back to back (no sync between them; one after each run)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(samples):
        started = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - started) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def earlier_filters(tree: Path):
    """``tree``'s ``ops/filters.py`` loaded beside the package's, its kernels
    from ``tree``'s library: the earlier wrappers, their host work whole."""
    import importlib.util
    import types

    lib = ctypes.CDLL(other_library(tree))
    for name, argtypes in EARLIER_BLOOM.items():
        getattr(lib, name).argtypes = argtypes
    spec = importlib.util.spec_from_file_location("earlier_filters", tree / "stringwars_tpu_torch" / "ops" / "filters.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up there
    spec.loader.exec_module(module)
    module.build = types.SimpleNamespace(library=lambda: lib, check=build.check, stream_of=build.stream_of,
                                         require_spans=build.require_spans)
    return module


def filters(args) -> None:
    """The Bloom build and query at the containers suite's shape and at its
    1 M-key cap: each form's kernel and whole-call device time, CUDA events
    and host µs a call; the query at other seed groups, the cluster build,
    and the split into hashing alone and bit work alone
    (``tools/hopper_probes/filter_variants.cu``)."""
    from stringwars_tpu_torch.ops import filters as FLT

    dev = torch.device("cuda", 0)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "probe_filter_variants.so"
    variants_build = nvcc_shared(PROBES / "filter_variants.cu", so)
    earlier = earlier_filters(Path(args.other_tree)) if args.other_tree else None
    build.library()
    print(f"filter_variants.cu built: {finish(variants_build, 'filter_variants.cu')}", flush=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in FILTER_VARIANTS.items():
        getattr(lib, name).argtypes = argtypes
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slice_bytes = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin

    def checked(code: int, what: str) -> None:
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def span_args(tokens):
        return tokens.data.data_ptr(), tokens.data.numel(), tokens.offsets.data_ptr(), tokens.count

    def cluster_build(tokens, seeds, m_bits, regime, blocks=1, clusters=0, slice_words=0):
        words = (torch.zeros if regime in ("global", "atomic") else torch.empty)(m_bits // 32, dtype=torch.int32, device=dev)
        copies = torch.empty((clusters, m_bits // 32), dtype=torch.int32, device=dev) if regime == "copies" else None
        checked(lib.cluster_build_run(*span_args(tokens), FLT._seed_array(seeds), len(seeds), m_bits, words.data_ptr(),
                                      None if copies is None else copies.data_ptr(), CLUSTER_REGIMES.index(regime), blocks,
                                      clusters, slice_words, stream), "cluster_build_run")
        return words

    def query_variant(words, tokens, seeds, m_bits, group):
        out = torch.empty(tokens.count, dtype=torch.bool, device=dev)
        checked(lib.query_variant_run(group, *span_args(tokens), FLT._seed_array(seeds), len(seeds), m_bits, words.data_ptr(),
                                      out.data_ptr(), stream), "query_variant_run")
        return out

    def split_variant(kind, tokens, seeds, m_bits, pos=None, words=None, out=None):
        grid = ctypes.c_int64(0)
        checked(lib.filter_variant_run(kind, *span_args(tokens), FLT._seed_array(seeds), len(seeds), m_bits,
                                       None if pos is None else pos.data_ptr(), None if words is None else words.data_ptr(),
                                       out.data_ptr(), ctypes.addressof(grid), stream), f"filter_variant_run {kind}")

    def report(what: str, fn, kernel: str) -> None:
        traced = CS.device_ms(fn, kernel, calls=30, per_call=True)
        split = CS.device_breakdown(fn, {"kernel": kernel}, calls=10)
        print(f"  {what}: kernel " + ("not measured" if traced is None else f"{traced:.4f}") + " ms device a call, whole call "
              + ("not measured" if split is None else f"{split['total']:.4f} ms device (other ops {split['torch']:.4f})")
              + f", CUDA events {events_ms(fn):.4f} ms a call, host {host_us(fn):.1f} µs a call", flush=True)

    for shape, ins, held, seeds, m_bits in filter_shapes(dev):
        # fuse_query's floor: the BinaryFuse8 table over the inserted
        # tokens' XXH64 digests, queried with the held-out ones (the
        # containers suite's probes), beside an empty kernel with its
        # arguments on its grid and stream.
        ins_keys = H.xxh64_spans(ins.data, ins.offsets).cpu().numpy()
        out_keys = np.setdiff1d(H.xxh64_spans(held.data, held.offsets).cpu().numpy(), ins_keys)
        fuse = FLT.fuse_build(ins_keys, device=dev)
        h, fp = FLT.fuse_stage(fuse, out_keys)
        table, n = fuse.fingerprints, fp.numel()
        answers = torch.empty(n, dtype=torch.bool, device=dev)
        if not torch.equal(FLT.fuse_query_cuda(table, h, fp), FLT.fuse_query_plain(table, h, fp)):
            raise AssertionError(f"filters {shape}: fuse_query_kernel answers otherwise than fuse_query_plain")
        floor = {
            "fuse_query_kernel (the package's call)": (lambda: FLT.fuse_query_cuda(table, h, fp), "fuse_query_kernel"),
            "fuse_floor_kernel (empty, the same arguments)": (lambda: checked(lib.fuse_floor_run(
                table.data_ptr(), table.numel(), h.data_ptr(), fp.data_ptr(), n, answers.data_ptr(), stream),
                "fuse_floor_run"), "fuse_floor_kernel"),
        }
        times = {label: (CS.device_ms(fn, kernel, calls=30, per_call=True), events_ms(fn)) for label, (fn, kernel) in
                 floor.items()}
        grid = min(-(-n // 256), sms * 8)
        print(f"fuse floor {shape}: {n:,} probes, a {table.numel():,}-byte table, {grid} blocks of 256 threads on the "
              "current stream: " + "; ".join(
                  f"{label} {'not measured' if dev_ms is None else f'{dev_ms:.5f}'} ms device a launch, "
                  f"CUDA events {ev_ms:.5f} ms a call" for label, (dev_ms, ev_ms) in times.items()), flush=True)
        (query_ms, _), (empty_ms, _) = times.values()
        if query_ms is not None and empty_ms is not None:
            print(f"fuse floor {shape}: fuse_query_kernel / empty kernel = {query_ms / empty_ms:.3f}", flush=True)
        del fuse, h, fp, answers
        k = len(seeds)
        n_words = m_bits // 32
        words = FLT.bloom_build_plain(ins, seeds, m_bits)
        fill = int(np.unpackbits(CS.signed(words).cpu().numpy().view(np.uint8)).sum())
        answers = FLT.bloom_query_plain(words, held, seeds, m_bits)
        print(f"filters {shape}: {ins.count:,} inserted ({ins.total_bytes:,} B), {held.count:,} held out, k = {k}, "
              f"{m_bits:,} bits, fill {fill / m_bits:.4f}, {int(answers.sum()):,} held-out positives", flush=True)
        builds = {"the package's call": (lambda: FLT.bloom_build_cuda(ins, seeds, m_bits), "bloom_build_kernel")}
        queries = {"the package's call": (lambda: FLT.bloom_query_cuda(words, held, seeds, m_bits), "bloom_query_kernel")}
        if earlier is not None:
            builds[f"{args.other_tree}'s call"] = (lambda: earlier.bloom_build_cuda(ins, seeds, m_bits), "bloom_build_kernel")
            queries[f"{args.other_tree}'s call"] = (lambda: earlier.bloom_query_cuda(words, held, seeds, m_bits),
                                                     "bloom_query_kernel")
        geometries = [("store", b, 1, -(-n_words // b)) for b in (4, 8, 16) if 4 * -(-n_words // b) <= slice_bytes]
        if 4 * -(-n_words // 16) <= slice_bytes:
            held16 = ctypes.c_int64(0)
            checked(lib.cluster_capacity(16, 4 * -(-n_words // 16), ctypes.addressof(held16)), "cluster_capacity")
            geometries += [(regime, 16, c, -(-n_words // 16)) for c in sorted({2, 4, held16.value})
                           for regime in ("atomic", "copies")]
        geometries.append(("global",))
        for g in geometries:
            label = f"cluster_build_kernel, {g[0]}" + (f", {g[2]} cluster(s) of {g[1]} blocks, {g[3]:,} words a block"
                                                         if len(g) > 1 else " (768-thread blocks)")
            builds[label] = (lambda g=g: cluster_build(ins, seeds, m_bits, *g), "cluster_build_kernel")
        for group in (1, 2, 7):
            queries[f"the package's kernel, seeds a test: {group}"] = (
                lambda group=group: query_variant(words, held, seeds, m_bits, group), "bloom_query_kernel")
        for label, (fn, kernel) in builds.items():
            if not torch.equal(CS.signed(fn()), CS.signed(words)):
                raise AssertionError(f"filters {shape}: {label} builds other words than bloom_build_plain")
            report(f"build, {label}", fn, kernel)
        for label, (fn, kernel) in queries.items():
            if not torch.equal(fn(), answers):
                raise AssertionError(f"filters {shape}: {label} answers otherwise than bloom_query_plain")
            report(f"query, {label}", fn, kernel)
        everyone = torch.ones(ins.count, dtype=torch.bool, device=dev)
        positives = {"the package's call": lambda: FLT.bloom_query_cuda(words, ins, seeds, m_bits)}
        if earlier is not None:
            positives[f"{args.other_tree}'s call"] = lambda: earlier.bloom_query_cuda(words, ins, seeds, m_bits)
        positives.update({f"the package's kernel, seeds a test: {group}": (
            lambda group=group: query_variant(words, ins, seeds, m_bits, group)) for group in (1, 7)})
        for label, fn in positives.items():
            if not torch.equal(fn(), everyone):
                raise AssertionError(f"filters {shape}: {label} missed an inserted token")
            report(f"query of the {ins.count:,} inserted tokens (all positive), {label}", fn, "bloom_query_kernel")
        sink = torch.empty(sms * 8 * 256, dtype=torch.int32, device=dev)
        for what, tokens in (("build", ins), ("query", held)):
            report(f"split, {what}'s hashing alone (positions XORed into a register, stored once a lane)",
                   lambda tokens=tokens: split_variant(0, tokens, seeds, m_bits, out=sink), "hash_alone_kernel")
        pos_ins = FLT.bloom_positions(ins, seeds, m_bits).to(torch.int32).contiguous()
        pos_held = FLT.bloom_positions(held, seeds, m_bits).to(torch.int32).contiguous()
        scratch = torch.zeros(n_words, dtype=torch.int32, device=dev)
        split_variant(1, ins, seeds, m_bits, pos=pos_ins, words=scratch, out=sink)
        if not torch.equal(scratch, CS.signed(words)):
            raise AssertionError(f"filters {shape}: the build's bits alone differ from bloom_build_plain")
        report("split, build's bit work alone (precomputed positions, a global atomicOr a probe, the words not zeroed)",
               lambda: split_variant(1, ins, seeds, m_bits, pos=pos_ins, words=scratch, out=sink), "bits_build_kernel")
        got = torch.empty(held.count, dtype=torch.bool, device=dev)
        split_variant(2, held, seeds, m_bits, pos=pos_held, words=words, out=got)
        if not torch.equal(got, answers):
            raise AssertionError(f"filters {shape}: the query's bits alone differ from bloom_query_plain")
        report("split, query's bit work alone (precomputed positions, k word loads and tests, a byte stored a token)",
               lambda: split_variant(2, held, seeds, m_bits, pos=pos_held, words=words, out=got), "bits_query_kernel")
        del pos_ins, pos_held, scratch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=("chacha", "bpe", "seal", "myers", "poly", "ac", "shiftand", "xxh3", "reorder", "spans",
                                            "compose", "sort", "uncased", "filters"))
    parser.add_argument("--other-tree", help="a checkout of another commit, its library built in place")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("hopper_probes: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    {"chacha": chacha, "bpe": bpe, "seal": seal, "myers": myers, "poly": poly, "ac": ac, "shiftand": shiftand, "xxh3": xxh3,
     "reorder": reorder, "spans": spans, "compose": compose, "sort": sort, "uncased": uncased,
     "filters": filters}[args.probe](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
