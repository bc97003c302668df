"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its seconds; any failure exits non-zero and
prints no result:

1. device: a CUDA device must be present (its name, ``nvidia-smi``'s name and
   power limit, the torch and CUDA versions);
2. build: the CUDA kernels from ``stringwars_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel);
3. kernels: each kernel against its plain torch version on the card, exact
   (the hashes also against the published digests of the empty input; the
   Myers and alignment kernels over pattern lengths 0..1023 against texts of
   0..1100 B in the byte, DNA and codepoint alphabets, global and local,
   the Myers kernel also at the edges of its lane groups and bands (lengths
   0..1025 around 32-row lanes and a warp's 1,024 rows, groups of 1 to 32
   lanes, patterns of up to 2,100 rows),
   affine and linear, and 64 pairs against the brute-force oracles, and the
   alignment kernel at the edges of its lane groups and strips (8, 16 and 32
   lanes a pair, strips of 8 and 16 rows, pairs of several passes); the
   Aho-Corasick DFA kernel in each table regime and the Shift-And kernel with
   one and two state words, at their own and at small chunks, and 64 small
   multi-pattern cases against brute force; the class map over every
   segmentation table, pruned at 0xFFFF and whole, the fused scan (one
   launch a program, the builds inside it) of each kind both ways at 128 Mi
   positions and across the seams of its tiles (1,024 to 8,192 positions,
   by the program's on-chip streams), and each of the 8 segmentation
   programs both ways on random streams of 1 to 4 Mi positions; the UAX#14
   rules on random class streams covering every pair of classes; the
   expand-and-compact fold kernel on UTF-8 rows of 32 and 64 bytes of a text
   with 3-codepoint folds, of ``synthetic:naughty`` and of random bytes, and
   on codepoint rows under a synthetic 3-table set at ``max_exp`` 1..4, the
   range map over the fold's rule sets (base 0 and 1, pruned, fully pruned),
   the codepoint-window count at m = 1, 8, 129 and 300; the BPE merge loop
   over 512 and 30,000 merges, the shared-memory and global-memory table
   regimes (the 512-merge table in both), on the JAX tests' cases and at
   every width 1..32, and 3,000 rows against ``bpe_encode_ref``, and at the
   edges of its lane groups and hashed tables (chunks of short rows with one
   of 32 B, shuffled rows, a table whose build drew its multipliers twice);
   the ChaCha20 keystream XOR at lengths 0..1 MiB + 13 and the counters 0, 1
   and 0xFFFFFFF0 (the wrap), at views of offsets 1..15, at the edges of its
   2 KiB warp tiles and of its persistent ring with wraps inside a tile, and
   the RFC 8439 §2.4.2 vector; Poly1305 at lengths 0..300, 65,536 and across
   the earlier kernel's runs, partials and fold, at offsets 1..15, under the
   adversarial key (r at its largest once clamped, s = 2^128 - 1) over 0xFF
   blocks, one byte around each of its lane groups' spans (512 B, 4 KiB, the
   16 KiB of one launch, 32 and 33 partials, the persistent grid's cap) in
   raw and AEAD mode, and the RFC vector, also against ``poly1305_ref``; SHA-256 at the boundary lengths with junk past
   them at every bucket width of the hash suite (a token over 4,096 B
   among them), at every length 0..130 in rows of 4, 16, 64, 128 and 4,160
   B, 16-byte aligned and at a 4-byte offset, and over the hash layouts,
   also against ``hashlib``; the tree level at base offsets 0..15 around
   the 16-byte units, its slices and chunks; find, rfind, Shift-And and
   Aho-Corasick on views at offsets 1..15 of a 64 MB tape (the wrappers'
   aligning copy timed at 64 MB); the Threefry fill against the pinned
   ``jax.random.bits`` words);
4. main path, each path with every launch count set to 0 just before it and
   read just after:
   - ``suites.find.main`` on 64 MB of ``synthetic:english-words`` in words
     mode; the suite's first forward counts must equal a ``bytes.find`` loop,
     and its aho_corasick row's counts the byteset_count row's;
   - ``ac_count`` and ``shiftand_count`` on that tape: the first 1,000
     distinct words as a DFA, four and eight words both ways (the two
     kernels must agree), the dictionary also against the plain version;
   - ``suites.hash.main`` on 128 MB of words; the first 8 tokens' swh64
     digests must equal ``swh64_ref``, every SHA-256 digest the plain
     version on the card and 10,000 sampled ones ``hashlib``;
   - ``suites.fingerprints.main`` on ``synthetic:long-lines``; the first
     documents' min-hashes must equal the numpy spec replay, and the quality
     line is read back;
   - ``entry("cuda")``'s forward, equal to the same forward on the CPU;
   - ``suites.similarities.main`` on its default corpus with
     ``SWTPU_ERROR_BOUND=16``; the first 8 scores of every row must equal
     the brute-force oracles, and every score of each kernel row the plain
     version on the suite's own pairs;
   - ``suites.tokenization.main`` on 128 MB of ``synthetic:multilingual``
     (``swtorch::`` rows only); each segmentation row's count must equal the
     plain feature route's on the card, the whitespace count
     ``len(text.split())``, the newline count the host's count of the newline
     codepoints less CRLF pairs, plus one, and the UTF-8 length
     ``len(bytes.decode())``; the BPE row's ids and counts over its 400,000
     pretokens must equal ``bpe_encode_plain`` on the card, 2,000 sampled
     rows ``bpe_encode_ref`` (its pre-split and training seconds on a line
     of their own); each of the 8 scan programs of the five segmentation
     functions, on the corpus's own streams, equal to the plain executor on
     the card; the launches are those of the suite's run;
   - ``suites.normalization.main`` on the same corpus (``swtorch::`` rows):
     its fold output equal to the plain version on the card, its total to
     ``len(text.casefold())`` and 10,000 sampled rows to ``str.casefold``; its
     1,000 compare booleans to the host's, both ``fold_tokens`` matrices to
     the CPU route's (the plain rule walk); its 100 needle counts to the
     plain window count on the card and to a host count of overlapping
     matches in ``text.casefold()``; the launches are those of the suite's run;
   - ``suites.encryption.main`` on 128 MB of ``synthetic:long-lines``: both
     corpus seals (ciphertext and tag) equal to the plain versions on the
     card, the decryption rows' plaintexts to the corpus, the 64 per-token
     seals of each cipher to ``aead_ref``, XChaCha to the draft's vector, and
     a tampered tag refused; the launches are those of the suite's run;
   every ``swtorch::`` row must report, and every kernel of a path must have
   launched in that path's run;
5. rows: the headline rows (``bench.py`` and ``tools/tpu_campaign.py``
   shapes, the similarities reference's own H100 cell, and the alignment
   rows at the similarities suite's own 4,096 pairs, whose times the kernels
   line's ``affine`` and ``linear`` entries take), each kernel
   timed with CUDA events (median of 5 runs of back-to-back calls, after
   warm-up) beside its plain version on the card (one run for the DP rows),
   its bound (the least time the card could take: bytes over 3.35 TB/s or
   32-bit integer instructions over 33.4 T/s, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time; the
   multi-pattern rows take the kernel's device time from ``torch.profiler``
   (their wrappers' host work outlasts the kernel) and print the
   back-to-back call time beside it; the tokenization rows at 128 MB (each
   segmentation function beside its plain feature route, with its launches
   (one of the scan kernel for each of its scan programs) and device time
   per call by kernel and by the other torch ops (no build runs as a torch
   op: a trace of the call must hold no ``scanline.build`` range), the UTF-8
   rows, and the class map,
   fused scan and UAX#14 rule kernels by profiler device time, the scans
   beside ``torch.cumsum`` and ``torch.cummax``), and the case-folding rows
   at the normalization suite's shapes (``range_map-fold-128MB``,
   ``fold-32B-rows-128MB``, ``cp_window-<m>cp-128MB``, profiler device time),
   and the BPE rows ``bpe-512m-400k`` (the tokenization suite's batch),
   ``bpe-512m-400k-global`` (the same with the table read from global
   memory) and ``bpe-512m-4M`` (4,000,000 pretokens of the same corpus, the
   same table), by profiler device time beside the plain version and a
   bound from the alive slots and looked-up pairs that the plain version
   counts (the first row with the kernel's SASS split by pipe); and
   ``chacha20-xor-128MB`` (with the SASS split of the kernel's tile loop and
   the ALU pipe's ceiling), ``poly1305-128MB``,
   ``aead-seal-128MB`` (the encryption suite's corpus call),
   ``sha256-words-128MB`` (the hash suite's buckets, with the kernel's SASS
   split by pipe and the ALU pipe's ceiling) and ``fill_random-128MB``; the
   tree level also at a byte offset of 1, the class map's and ``lut_map``'s
   rows beside ``table[idx]`` where it computes the same function; and the
   similarities, encryption and hash suites' calls traced as the suites
   make them (``traced_call``: device ms by kernel, busy share, bound).
   The earlier suites run at a quarter second of warm-up and one second a
   row. A profiler trace that
   misses a kernel is taken again, up to three times; where all three miss
   it, the row says so and keeps the CUDA-event time (its split: "not
   measured").

The 128 MB multilingual corpus is synthesized by a child process started at
the beginning (the generator is pure Python), written under
``stringwars_tpu_torch/_build/``, and removed at the end.

The line before last is a JSON object of the kernels (launches in the main
path, max |kernel - plain| over every comparison, ms, plain ms, bound ms,
library ms); before it, the card's ``nvidia-smi`` name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SAMPLES = 5  # timed samples per row, after WARM calls
WARM = 2
ROOT = Path(__file__).resolve().parent
CORPUS_BYTES = 128 << 20  # the tokenization suite's default corpus size

# The least time the card could take (H100 SXM data sheet, at 700 W): bytes
# over the HBM rate, or 32-bit integer instructions over the rate at which
# the card can issue them. The data sheet gives no int32 rate, so the bound
# takes the issue limit: one warp instruction per clock on each of an SM's
# four schedulers, 132 SMs x 128 lanes x 1.98 GHz (the lanes of the 67
# TFLOP/s float32 rate). The INT32 pipe alone has 64 lanes, but integer
# multiply-adds also issue to the FMA pipe, and the 16-seed swh64 row runs
# faster than 64 lanes allow. A multiply-add counts as one instruction.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 128 * 1.98e9


def phase(name: str, detail: str, started: float | None = None) -> None:
    took = f" [{time.perf_counter() - started:.1f} s]" if started is not None else ""
    print(f"[{name}]{took} {detail}", flush=True)


def time_ms(fn, samples: int = SAMPLES, warm: int = WARM) -> float:
    """Device time of one call of ``fn``: CUDA events around a run of k
    back-to-back calls (k fills ~20 ms, at most 50), the median of the runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    k = max(1, min(50, int(20.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(samples):
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


TRACES = 3  # traces taken before a device time counts as not measured
MISSED: list[str] = []  # one entry per trace that lacked what its caller reads


def profile(fn, calls: int, seen, cpu: bool = False, what: str = "?"):
    """A ``torch.profiler`` trace of ``calls`` calls of ``fn``, of the card
    (and, with ``cpu``, of the host), taken again, up to ``TRACES`` times,
    until ``seen(prof)`` holds: the profiler now and then returns a trace
    that lacks some of the card's kernels. None if no trace passes."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA] + ([torch.profiler.ProfilerActivity.CPU] if cpu else [])
    for _ in range(TRACES):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        if seen(prof):
            return prof
        MISSED.append(what)
    return None


def device_events(prof) -> list:
    """The trace's kernels (a trace of the card alone: no host op carries
    device time)."""
    return [e for e in prof.key_averages() if e.device_time_total > 0]


def device_ms(fn, kernel: str, calls: int = 30, per_call: bool = False) -> float | None:
    """Device time of one launch of the CUDA kernel whose name contains
    ``kernel`` (with ``per_call``: of all such launches in one call of
    ``fn``), from ``torch.profiler`` over ``calls`` calls: the kernel's own
    time where the wrapper's host work outlasts it, so that back-to-back
    calls time the host. None if no trace saw the kernel."""
    prof = profile(fn, calls, lambda p: any(kernel in e.key for e in device_events(p)), what=kernel)
    if prof is None:
        return None
    events = [e for e in device_events(prof) if kernel in e.key]
    launches = calls if per_call else sum(e.count for e in events)
    return sum(e.device_time_total for e in events) / launches / 1e3


def device_breakdown(fn, kernels: dict[str, str], calls: int = 3, launches: dict[str, int] | None = None) -> dict[str, float] | None:
    """Device ms per call of ``fn`` by kernel (name -> substring of the CUDA
    kernel's name; each must launch in a call), the rest of the device work
    ("torch") and the total. With ``launches`` (each kernel's CUDA launches
    per call), a kernel's share is its traced mean per launch times that
    count: a trace may hold fewer launches of the port's kernels than were
    made (seen: 5 of 20). None if no trace saw every kernel."""
    prof = profile(fn, calls, lambda p: all(any(k in e.key for e in device_events(p)) for k in kernels.values()),
                   what="+".join(kernels.values()))
    if prof is None:
        return None
    events = device_events(prof)
    out = {}
    for name, key in kernels.items():
        mine = [e for e in events if key in e.key]
        traced = sum(e.device_time_total for e in mine)
        out[name] = (traced / calls if launches is None else launches[name] * traced / sum(e.count for e in mine)) / 1e3
    torch_ms = sum(e.device_time_total for e in events if not any(k in e.key for k in kernels.values())) / calls / 1e3
    out["total"] = sum(out.values()) + torch_ms
    out["torch"] = torch_ms
    return out


def start_corpus(path: Path) -> subprocess.Popen:
    """Synthesize the tokenization suite's 128 MB corpus into ``path`` in a
    child process (written whole, then renamed into place)."""
    code = (
        "import os, sys; from stringwars_tpu_torch import datasets; part = sys.argv[1] + '.part'; "
        f"open(part, 'wb').write(datasets.synthesize('multilingual', {CORPUS_BYTES})); os.replace(part, sys.argv[1])"
    )
    return subprocess.Popen([sys.executable, "-c", code, str(path)], cwd=ROOT)


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """max |a - b| over the elements, exact for any integer type (64-bit
    digests included)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0
    if a.dtype == torch.uint64:
        x, y = a.cpu().numpy(), b.cpu().numpy()
        return int((np.maximum(x, y) - np.minimum(x, y)).max())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rate(ms: float, work_bytes: float, cells: float | None) -> str:
    """A row's rate: GCUPS for a DP row (cells), else GB/s."""
    return f"{cells / ms / 1e6:.1f} GCUPS" if cells else f"{work_bytes / ms / 1e6:.1f} GB/s"


def levenshtein_banded_ref(a, b, band: int) -> int:
    """Brute-force banded Levenshtein for |a| == |b|: cells off the band
    (|i - j| > band) are unreachable, row 0 and column 0 are whole, and the
    result saturates at 2^20, as ``similarity.levenshtein_banded`` defines
    it on a pair that fills its padded width."""
    if len(a) != len(b):
        raise ValueError("the banded oracle covers pairs of equal length")
    big = 1 << 20
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [big] * len(b)
        for j in range(max(1, i - band), min(len(b), i + band) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return min(prev[len(b)], big)


def myers_instructions(batch) -> int:
    """32-bit instructions that Levenshtein by Myers' algorithm needs: per
    32-row word and text column, 17 for the step (myers_pallas.py:84-106)
    and one for Eq, a lookup in the pattern's table of match vectors. The
    kernel spends more (csrc/myers.cu); the bound counts the function."""
    words32 = -(-batch.host_a_len // 32)
    return int((words32 * batch.host_b_len).sum()) * 18


# 32-bit instructions per DP cell that each alignment body needs with
# sm_90's DPX forms, by (gap model, local) (csrc/affine.cu lists them):
# global affine 8, local affine 9, global linear 5, local linear 6.
ALIGN_OPS = {("affine", False): 8, ("affine", True): 9, ("linear", False): 5, ("linear", True): 6}


# SASS opcodes by the pipe that issues them on Hopper: the integer ALU
# (64 lanes an SM) and the FMA pipe, which also takes IMAD in all its forms.
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "SHL", "SHR", "LEA", "ISETP", "SEL", "PRMT", "IABS", "IMNMX", "VIMNMX",
               "VIMNMX3", "BMSK", "PLOP3", "MOV", "FLO", "BREV", "POPC", "IADD", "LOP"}
FMA_OPCODES = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "IDP"}


@functools.lru_cache(maxsize=None)
def sass_dump(library: str) -> str | None:
    """``cuobjdump -sass`` of the built library (once a process), None
    without ``cuobjdump``."""
    import shutil

    from stringwars_tpu_torch import build

    tool = shutil.which("cuobjdump") or str(Path(build.find_nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300).stdout


def sass_pipes(kernel: str, body_holds: str | None = None, library: str | None = None) -> dict | None:
    """Static SASS instruction counts of the CUDA kernel whose (mangled) name
    contains ``kernel`` in ``library`` (the built library by default;
    ``cuobjdump -sass``), split by pipe: ``body`` is its largest basic block
    (the unrolled loop body), or its largest that holds the opcode
    ``body_holds``; ``text`` gives it and the whole function's. None without
    ``cuobjdump``."""
    import re

    from stringwars_tpu_torch import build

    dump = sass_dump(library or str(build.library_path()))
    if dump is None:
        return None
    blocks, current, inside = [], [], False
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")
    for line in dump.splitlines():
        if "Function :" in line:
            inside = kernel in line
            current = []
            if inside:
                blocks.append(current)
            continue
        if not inside:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            current = []
            blocks.append(current)
            continue
        hit = instruction.search(line)
        if hit:
            current.append(hit.group(1))
            if hit.group(1) in ("BRA", "EXIT", "RET", "BRX", "JMP", "CALL"):
                current = []
                blocks.append(current)
    if not any(blocks):
        return None

    def split(ops: list[str]) -> dict:
        alu = sum(op in ALU_OPCODES for op in ops)
        fma = sum(op in FMA_OPCODES for op in ops)
        top = sorted({op: ops.count(op) for op in set(ops)}.items(), key=lambda kv: -kv[1])[:8]
        return {"total": len(ops), "alu": alu, "fma": fma, "other": len(ops) - alu - fma, "top": top}

    bodies = [block for block in blocks if body_holds is None or body_holds in block] or blocks
    body, whole = split(max(bodies, key=len)), split([op for block in blocks for op in block])
    text = (f"{kernel} body (largest basic block) {body['total']} instructions: ALU {body['alu']}, FMA {body['fma']}, "
            f"other {body['other']} ({', '.join(f'{op} {n}' for op, n in body['top'])}); whole function "
            f"{whole['total']}: ALU {whole['alu']}, FMA {whole['fma']}")
    return {"body": body, "text": text}


def table_index(idx: torch.Tensor, table: torch.Tensor):
    """The one PyTorch call that computes a table map, ``table[idx]`` with
    the int32 indices (the table widened to int32 once, outside the timed
    call), and "" where every index lies inside the table and the call
    equals the kernel; else None and why: the kernels clamp an index past
    the table's ends (F6), which no single call does."""
    from stringwars_tpu_torch.ops import lut as LU

    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= table.numel():
        return None, (f"; library: none (indices {lo}..{hi} reach past the {table.numel():,}-entry table, which the "
                      f"kernel clamps and table[idx] does not)")
    wide = table.to(torch.int32)
    if not torch.equal(wide[idx], LU.class_map_cuda(idx, table)):
        raise AssertionError("table[idx] differs from the class map kernel on indices inside the table")
    return (lambda: wide[idx]), "; library: table[idx], int32 indices and table"


def lowercase(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(97, 123, (n,), dtype=torch.uint8, device=dev, generator=g)


def random_bytes(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=g)


def reset(*counters: dict) -> None:
    for counter in counters:
        for key in counter:
            counter[key] = 0


def run_suite(main, argv: list[str], rows: list[str]) -> tuple[object, list[str]]:
    """Run a suite with its report lines captured and echoed; every listed
    row must report unskipped, and no ``swtorch::`` row may be skipped."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = main(argv)
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    for row in rows:
        hits = [line for line in lines if line.startswith(row + " ")]
        if len(hits) != 1 or "SKIPPED" in hits[0]:
            raise AssertionError(f"main path row missing or skipped: {row}: {hits}")
    if any("swtorch::" in line and "SKIPPED" in line for line in lines):
        raise AssertionError("a swtorch:: row was skipped")
    return ctx, lines


# The segmentation class tables (ops/segment.py), and one single-op program
# per fused-scan kind for the kernel checks and rows.
SEG_TABLES = (
    "whitespace_table", "newline_table", "grapheme_break_table", "word_break_table", "sentence_break_table",
    "extended_pictographic_table", "line_break_table", "incb_table",
)
SCAN_KINDS = ("sum", "max", "last", "last2", "delay")
SCAN_BUILDS = {
    "sum": lambda e: e["v"],
    "max": lambda e: e["v"],
    "last": lambda e: (e["v"], e["f"]),
    "last2": lambda e: (e["v"], e["f"]),
    "delay": lambda e: e["v"],
}
# The input streams of the segmentation programs (ops/segment.py), and the
# programs themselves.
SEG_BOOL_STREAMS = ("tok", "lead", "pict", "ri", "nonext", "ctl", "lnk", "nel", "keep", "nl", "basemask", "ign", "ps",
                    "stop", "cm", "hard")
SEG_INT_STREAMS = ("cls", "incb", "eff")


def segment_programs(SEG) -> tuple:
    return (SEG._WS_OPS, SEG._GRAPH_OPS, SEG._WORD_OPS_FWD, SEG._WORD_OPS_BWD, SEG._SENT_OPS_FWD, SEG._SENT_OPS_BWD,
            SEG._LB_OPS_FWD, SEG._LB_OPS_BWD)


# The normalization suite's device rows.
NORMALIZATION_ROWS = (
    "case-fold/swtorch::utf8_fold", "case-insensitive-compare/swtorch::uncased_eq",
    "case-insensitive-find/swtorch::uncased_find",
)
# The encryption suite's device rows (group, row), without the scope.
ENCRYPTION_ROWS = tuple(
    [("keygen", c) for c in ("chacha20poly1305", "xchacha20poly1305", "fill_random")]
    + [("encryption", c) for c in ("chacha20poly1305", "xchacha20poly1305", "chacha20poly1305-corpus", "xchacha20poly1305-corpus")]
    + [("decryption", c) for c in ("chacha20poly1305-corpus", "xchacha20poly1305-corpus")]
)
# The tokenization suite's device rows (``suites/tokenization.device_rows``).
TOKENIZATION_ROWS = (
    "tokenize-whitespace/swtorch::split", "tokenize-newlines/swtorch::split", "tokenize-words-tr29/swtorch::words",
    "tokenize-graphemes-tr29/swtorch::graphemes", "tokenize-sentences-tr29/swtorch::sentences",
    "tokenize-lines-uax14/swtorch::linebreaks", "utf8-length/swtorch::count_utf8",
    "utf8-iterate/swtorch::decode_utf32", "find-nth-utf8/swtorch::find_nth", "tokenize-bpe/swtorch::bpe_encode",
)
BPE_ROWS_4M = 4_000_000  # pretokens of the bpe-512m-4M row
BPE_CHARS_4M = 32 << 20  # characters of the corpus pre-split for it
# jax.random.bits(jax.random.PRNGKey(seed), (count,), uint32)[at : at + 8],
# pinned: the machine with the card has no JAX (tests/test_torch_fill_random.py
# holds them to JAX). seed -> (count, at, words).
THREEFRY_PINS = {
    1: (8, 0, (0x704A38B7, 0x88A4083E, 0x7227B57A, 0x703ABFF1, 0xE5B993A4, 0x8F1716BC, 0xFBDFED74, 0xD78CB814)),
    2: (8, 0, (0xA40AE269, 0xE68DDB64, 0x3AE385E9, 0xE1B135C9, 0x6B113C1D, 0x33CB5CB4, 0xBBC4D164, 0x2FFEC274)),
    77: (65539, 65531, (0x17E275B6, 0xBDACB8C1, 0x0EC6CC21, 0xC47C6C00, 0x8E75FCBB, 0x6CFECD12, 0x033FEBBB, 0x226E252D)),
    2**31 - 1: (1000, 992, (0x7CC7D313, 0xB9A3C2D1, 0x8E03AB1E, 0x25C9867E, 0x2B423E4B, 0x657FDE11, 0xEDBD0F99, 0x729E782E)),
}


def bpe_operations(slots: int, pairs: int, merges: int) -> int:
    """32-bit operations that the BPE merge loop needs, from what the plain
    version counts the rows doing (``bpe_encode_plain(work=True)``): for
    each alive slot in each iteration of its row (its merging rounds and
    the one that finds no pair), 8: the next alive slot and its id (2), its
    part in the row minimum (1), the match (1), the run's parity (2), the
    eaten partner (1), the update (1); and for each pair looked up (an alive
    slot with an alive slot to its right), 3 for its key and the hit (shift,
    or, compare) and 3 for each step of the binary search (load, compare,
    select), ceil(log2(merges + 1)) steps. Slots past a row's end and rows
    that have stopped need nothing."""
    return 8 * slots + pairs * (3 + 3 * math.ceil(math.log2(merges + 1)))


# -- find and fingerprints: kernel checks and the rows at the main path's shapes

FP_NDIMS = (4, 8, 64, 256, 512)  # each split of the fingerprint kernel's cell loop: 1 to 32 groups of four dims a width
WORST_NEEDLES = 64  # the find worst case: needles a * k for k = 1..64


def check_find(dev, errors: dict, n: int = 64 << 20) -> tuple[int, tuple]:
    """The substring kernel against the plain version on the card over n
    bytes of lowercase: batches of planted needles of 8 and 16 B (64 each), 600
    and 2,000 B (longer than the staged halo), 1 to 4 B, 1 to 4 B mixed with
    longer ones, duplicates, needles that share a head (and prefixes of one
    another), one needle, needles with NUL bytes (b"a" and b"a\\0": one key
    word, two key lengths; b"\\0" alone: the one-key instance), and 512 and
    1,100 needles cut from the haystack (1,100: more than one block's 1,024
    counters); each at n and n - 3, both forms, and the first needle as a
    batch built directly from device rows.
    Then the worst case (``find_worst_case``), held to its closed form.
    Returns (needle scans checked, the worst case)."""
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC
    from stringwars_tpu_torch.suites import find as find_suite

    rng = np.random.default_rng(1)
    hay = lowercase(n, 1, dev)
    hay[1000:1064] = ord("a")  # a run: overlapping matches of a*m
    for p in rng.integers(0, n - 4, 8):  # NUL bytes, for needles of one key word and different lengths
        hay[p : p + 4] = torch.tensor(list(b"a\0\0b"), dtype=torch.uint8, device=dev)

    def planted(m: int, count: int) -> list[bytes]:
        needles = [bytes(rng.integers(97, 123, m, dtype=np.uint8)) for _ in range(count)]
        for i, nd in enumerate(needles):
            spots = list(rng.integers(0, n - m, 3)) + ([0] if i == 0 else []) + ([n - 3 - m] if i == 1 else [])
            for p in spots:
                hay[p : p + m] = torch.frombuffer(bytearray(nd), dtype=torch.uint8).to(dev)
        return needles

    head = planted(12, 1)[0]
    dup = planted(9, 2)
    sets = {
        "8B": planted(8, 64),
        "16B": planted(16, 64),
        "long": planted(600, 1) + planted(2000, 1),
        "short": [b"e", b"th", b"abc", b"aaaa"],
        "mixed": [b"q", b"zz", b"xyz", b"wxyz"] + [planted(m, 1)[0] for m in (5, 9, 13, 29, 100, 1100)] + [b"aa", b"e"],
        "duplicates": [dup[0], dup[0], dup[1], b"e", b"e", dup[1], dup[0]],
        "shared-heads": [head, head[:4] + b"zzzz", head[:6], head[:4], head + b"q", head[:5], head[:1], head[:2], head[:3]],
        "one": planted(8, 1),
        "nul": [b"a", b"a\0", b"\0", b"\0\0b"],
        "nul-one": [b"\0"],
    }
    host = hay.cpu().numpy()
    for size, longest in ((512, 16), (1100, 32)):
        starts = rng.integers(0, n - longest, size)
        sets[str(size)] = [host[p : p + m].tobytes() for p, m in zip(starts, rng.integers(1, longest + 1, size))]
    checked = 0
    for needles in sets.values():
        batch = F.NeedleBatch.from_needles([F.pack_needle(t, find_suite._needle_cap(t)) for t in needles], dev)
        for extent in (n, n - 3):
            counts = FC.find_count_batch(hay, batch, extent)
            errors["find_count"] = max(errors["find_count"], max_err(counts, F.find_count_batch_plain(hay, batch, extent)))
            got = FC.rfind_count_batch(hay, batch, extent)
            want = F.rfind_count_batch_plain(hay, batch, extent)
            errors["rfind_count"] = max(errors["rfind_count"], max_err(got[0], want[0]), max_err(got[1], want[1]))
            checked += batch.size
        single = F.NeedleBatch(batch.images[:1], batch.lengths[:1], batch.host_lengths[:1])
        errors["find_count"] = max(errors["find_count"], max_err(FC.find_count_batch(hay, single), F.find_count_batch_plain(hay, single)))
    del hay
    worst = find_worst_case(n, dev)
    worst_hay, worst_batch = worst[:2]
    for extent in (n, n - 3):
        want = [torch.from_numpy(x) for x in find_worst_case_counts(worst_hay[:extent].cpu().numpy())]
        got = FC.rfind_count_batch(worst_hay, worst_batch, extent)
        errors["rfind_count"] = max(errors["rfind_count"], max_err(got[0].cpu(), want[0]), max_err(got[1].cpu(), want[1]))
        got = FC.find_count_batch(worst_hay, worst_batch, extent)
        errors["find_count"] = max(errors["find_count"], max_err(got.cpu(), want[0]))
        checked += 2 * WORST_NEEDLES
    return checked, worst


def find_worst_case_counts(hay: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Counts and last starts of a * k (k = 1..64) in a haystack of runs of
    ``a`` between other bytes, in closed form: a run of r bytes holds
    max(r - k + 1, 0) matches, the last at its end less k."""
    is_a = np.concatenate([[False], hay == ord("a"), [False]])
    edges = np.flatnonzero(is_a[1:] != is_a[:-1])
    begin, run = edges[0::2], edges[1::2] - edges[0::2]
    counts = np.zeros(WORST_NEEDLES, np.int64)
    lasts = np.full(WORST_NEEDLES, -1, np.int64)
    for k in range(1, WORST_NEEDLES + 1):
        fits = np.flatnonzero(run >= k)
        counts[k - 1] = int((run[fits] - k + 1).sum())
        if fits.size:
            lasts[k - 1] = begin[fits[-1]] + run[fits[-1]] - k
    return counts, lasts


def find_worst_case(n: int, dev) -> tuple:
    """The substring kernel's worst case: a haystack of runs of ``a`` (1 to
    255 B, one ``b`` after each) and the 64 needles a * k, k = 1..64, whose
    heads pass the filters nearly everywhere: every window is a candidate
    for every needle that fits in its run. (haystack, batch, counts, lasts),
    the last two in closed form."""
    from stringwars_tpu_torch.ops import find as F

    runs = np.random.default_rng(12).integers(1, 256, n // 64)
    host = np.full(int((runs + 1).sum()), ord("a"), np.uint8)
    host[np.cumsum(runs + 1) - 1] = ord("b")
    host = host[:n]
    batch = F.NeedleBatch.from_needles([F.pack_needle(b"a" * k) for k in range(1, WORST_NEEDLES + 1)], dev)
    return (torch.from_numpy(host).to(dev), batch, *find_worst_case_counts(host))


def check_unaligned(dev, errors: dict, n: int = 64 << 20) -> int:
    """The haystack scans at every misaligned offset: views ``hay[k:]``, k =
    1..15, of 64 MB over the letters a-d (dense matches) through find, rfind
    (counts and last offsets, relative to the view), Shift-And and
    Aho-Corasick, each equal to the plain version (the CPU path) on the same
    bytes; then the cost of the wrapper's aligning copy at that size, on a
    line of its own. Returns the number of views checked."""
    from stringwars_tpu_torch import build
    from stringwars_tpu_torch.ops import ahocorasick as AC
    from stringwars_tpu_torch.ops import ahocorasick_cuda as ACC
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC
    from stringwars_tpu_torch.ops import shiftand as SA
    from stringwars_tpu_torch.ops import shiftand_cuda as SAC

    g = torch.Generator(device=dev).manual_seed(21)
    hay = torch.randint(97, 101, (n + 16,), dtype=torch.uint8, device=dev, generator=g)
    patterns = [b"a", b"abc", b"dcba", b"abcdab", b"bbbbbbbb", b"cadbcadb"]
    batch = F.NeedleBatch.from_needles([F.pack_needle(p) for p in patterns], dev)
    auto, sa = AC.Automaton(patterns), SA.ShiftAndSet(patterns)
    checked = 0
    for k in range(1, 16):
        view = hay[k:]
        extent = n + 16 - k - (k % 3)  # some views end before their last byte
        if view.data_ptr() % 16 == 0:
            raise AssertionError(f"the view at offset {k} is aligned")
        want_counts = F.find_count_batch_plain(view, batch, extent)
        got_counts = FC.find_count_batch(view, batch, extent)
        got_r, want_r = FC.rfind_count_batch(view, batch, extent), F.rfind_count_batch_plain(view, batch, extent)
        errors["find_count"] = max(errors["find_count"], max_err(got_counts, want_counts))
        errors["rfind_count"] = max(errors["rfind_count"], max_err(got_r[0], want_r[0]), max_err(got_r[1], want_r[1]))
        want = AC.ac_count_plain(auto, view, extent)
        errors["ac_dfa"] = max(errors["ac_dfa"], max_err(ACC.ac_count(auto, view, extent), want))
        errors["shiftand"] = max(errors["shiftand"], max_err(SAC.shiftand_count(sa, view, extent), want))
        if int(want.item()) == 0 or int(want_r[1].min().item()) < 0:
            raise AssertionError(f"the unaligned view at offset {k} holds no match of some pattern")
        checked += 1
    view = hay[1 : n + 1]
    copy_ms = time_ms(lambda: build.aligned_bytes(view, n))
    phase("row", f"aligned-copy-64MB (the wrapper's copy of an unaligned {n:,}-byte haystack view): {copy_ms:.4f} ms "
                 f"({2 * n / copy_ms / 1e6:.1f} GB/s read and written); an aligned view is passed as it is")
    return checked


def tree_extents() -> list[int]:
    """Tree-level extents at the edges of the 16-byte units, the stripes,
    the kernel's shared-memory slices, the chunks, and around 8 MB."""
    from stringwars_tpu_torch.ops.hash import TREE_CHUNK
    from stringwars_tpu_torch.ops.hash_cuda import TREE_SLICE as piece

    edges = (16, 32, piece, 3 * piece, TREE_CHUNK, TREE_CHUNK + piece, 2 * TREE_CHUNK + 3 * piece, 8 << 20)
    return sorted({e + d for e in edges for d in (-1, 0, 1)} | {0, 1, 15})


def tree_levels_plain(cases: list) -> list[torch.Tensor]:
    """``tree_level_plain`` of each (data, n) case, by one pass of the plain
    XXH64 over all their chunks: the plain version's time is its 2,048
    stripe steps, whatever the number of rows."""
    from stringwars_tpu_torch import tape as T
    from stringwars_tpu_torch.ops import hash as H

    parts = [H._chunks_of(data, n) for data, n in cases]
    joined = T.PaddedTokens(torch.cat([p.data for p in parts]), torch.cat([p.lengths for p in parts]), H.TREE_CHUNK)
    return list(torch.split(H.xxh64_plain(joined, [0])[0], [p.count for p in parts]))


def sha_rows(width: int, rng, dev):
    """(tokens, aligned, shifted): a token of every length 0..min(130, width)
    and one of the full width, 0xAB junk past each, as rows of ``width``
    bytes, 16-byte aligned and at a 4-byte offset."""
    from stringwars_tpu_torch import tape as T

    tokens = [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in list(range(min(130, width) + 1)) + [width]]
    rows = np.full((len(tokens), width), 0xAB, np.uint8)
    for i, t in enumerate(tokens):
        rows[i, : len(t)] = np.frombuffer(t, np.uint8)
    lens = torch.tensor([len(t) for t in tokens], dtype=torch.int32, device=dev)
    aligned = torch.from_numpy(rows).to(dev)
    shifted = torch.empty(rows.size + 16, dtype=torch.uint8, device=dev)[4 : 4 + rows.size].view(rows.shape)
    shifted.copy_(aligned)
    return tokens, T.PaddedTokens(aligned, lens, width), T.PaddedTokens(shifted, lens, width)


def fingerprint_batches(dev) -> list:
    """The fingerprint kernel's check batches: 256 random documents of 1 to
    4,095 B with the empty one and short ones, in rows of 4,096 B and of
    their own width; periodic documents (b"ab" * 600, b"z" * 1,280, a
    repeated line), whose counts run to hundreds; documents of 0 to 40 B of
    a-c around each gram width, in rows of 4 and of 64 B."""
    from stringwars_tpu_torch import tape as T

    rng = np.random.default_rng(11)
    docs = [bytes(rng.integers(32, 127, int(k), dtype=np.uint8)) for k in rng.integers(1, 4096, 256)]
    docs += [b"", b"x", b"abcd", b"z" * 33]
    periodic = [b"ab" * 600, b"z" * 1280, (b"the same line again\n" * 64)[:1280], b"abc" * 400, b"ab" * 3, b"z" * 40]
    around = [bytes(rng.integers(97, 100, k, dtype=np.uint8)) for k in range(41)]
    return [
        T.PaddedTokens.from_tape(T.Tape.from_tokens(docs), max_width=4096).to(dev),
        T.PaddedTokens.from_tape(T.Tape.from_tokens(docs[-40:]), align=4).to(dev),
        T.PaddedTokens.from_tape(T.Tape.from_tokens(periodic), align=4).to(dev),
        T.PaddedTokens.from_tape(T.Tape.from_tokens(around), align=4).to(dev),
        T.PaddedTokens.from_tape(T.Tape.from_tokens(around), align=64).to(dev),
    ]


def campaign_fingerprint_tokens(dev):
    """16,384 documents of 1,017 random bytes in rows of 1,024
    (tools/tpu_campaign.py:459-475)."""
    from stringwars_tpu_torch import tape as T

    data = random_bytes(16384 * 1024, 7, dev).view(16384, 1024)
    return T.PaddedTokens(data, torch.full((16384,), 1024 - 7, dtype=torch.int32, device=dev), 1024)


def check_fingerprint(dev, errors: dict) -> int:
    """Hashes and counts of the fingerprint kernel against the plain version
    on the card: every batch of ``fingerprint_batches`` at each ndim of
    ``FP_NDIMS``, with counts and without, and the 16 MB row's shape at ndim
    512 both ways. Returns the batches checked."""
    from stringwars_tpu_torch.ops import fingerprint as FP

    checked = 0
    for padded in fingerprint_batches(dev) + [campaign_fingerprint_tokens(dev)]:
        for ndim in FP_NDIMS if padded.count < 16384 else (512,):
            for counts in (True, False):
                got_h, got_c = FP.fingerprint_cuda(padded, ndim, counts)
                want_h, want_c = FP.fingerprint_plain(padded, ndim, with_counts=counts)
                err = max(max_err(got_h, want_h), max_err(got_c, want_c) if counts else 0)
                errors["fingerprint"] = max(errors["fingerprint"], err)
                checked += 1
    return checked


def check_chacha_edges(dev, errors: dict) -> int:
    """The ChaCha20 kernel's tiles (2 KiB a warp, ``CC.TILE_BYTES``) and its
    persistent ring against ``chacha20_xor_plain``, exactly: lengths of a
    tile less one byte, one, one plus one, and two sweeps of the ring (every
    resident warp's tile, at the most warps an SM holds) plus whole tiles
    and a partial block; counters whose wrap past 2^32 falls inside the
    first tile, inside a later tile and at a tile's seam; views at offsets
    1..16 (the direct path's 4-byte and byte forms, and the tiles at 16) of
    lengths under and over a tile. Returns the streams checked."""
    from stringwars_tpu_torch.ops import chacha as CC

    rng = np.random.default_rng(41)
    key, nonce = rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    tile = CC.TILE_BYTES
    sweep = torch.cuda.get_device_properties(dev).multi_processor_count * 64 * tile  # 64 warps an SM at most
    buf = random_bytes(2 * sweep + 7 * tile + 128, 42, dev)
    checked = 0

    def check(view: torch.Tensor, counter: int) -> None:
        nonlocal checked
        got = CC.chacha20_xor_cuda(key, nonce, view, counter)
        errors["chacha20_xor"] = max(errors["chacha20_xor"], max_err(got, CC.chacha20_xor_plain(key, nonce, view, counter)))
        checked += 1

    lengths = (tile - 1, tile, tile + 1, 3 * tile + 64, 2 * sweep + 5 * tile + 37)
    for n in lengths:
        for counter in (1, 0xFFFFFFF0, 0xFFFFFFFF - 40, (1 << 32) - 32 * 3):
            check(buf[:n], counter)
    for off in range(1, 17):
        for n in (1000, 5 * tile + 13):
            check(buf[off : off + n], 7)
    return checked


MYERS_EDGES = (0, 1, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257, 1023, 1024, 1025)


def check_myers_edges(dev, errors: dict) -> int:
    """The Myers kernel's schedules (``MY.schedule``) against ``myers_plain``
    on the card, exactly: every pair of lengths |a|, |b| in ``MYERS_EDGES``
    (the 32-row lane edges, a 1,024-row warp's, and empty sides; pairs of
    other lengths share a group's warp) in the byte, DNA and codepoint
    alphabets, whose longest pattern takes a warp of 32-bit lanes and a
    second band; the same batches repeated until they fill the card, which
    takes 64-bit lanes of 4 words (2 at codepoints); byte batches whose
    longest pattern gives groups of 1, 2, 4, 8 and 16 lanes, and patterns of
    up to 2,100 rows (three bands); and patterns around 8,192 rows in
    batches that take 64-bit lanes and a second band of them. Returns the
    batches checked."""
    from stringwars_tpu_torch.ops import myers as MY
    from stringwars_tpu_torch.ops import myers_cuda as MYC

    rng = np.random.default_rng(43)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checked, plans = 0, set()

    def check(mb, repeats: int = 1) -> None:
        """The kernel over ``mb`` and over ``mb`` repeated (the same pairs
        ``repeats`` times: a larger batch, another schedule) against the
        plain version of ``mb``."""
        nonlocal checked
        want = MY.myers_plain(mb)
        for k in sorted({1, repeats}):
            big = mb if k == 1 else dataclasses.replace(
                mb, planes=mb.planes.repeat(1, 1, k).contiguous(), text=mb.text.repeat(1, k).contiguous(),
                a_len=mb.a_len.repeat(k).contiguous(), b_len=mb.b_len.repeat(k).contiguous(),
                host_a_len=np.tile(mb.host_a_len, k), host_b_len=np.tile(mb.host_b_len, k))
            errors["myers"] = max(errors["myers"], max_err(MYC.myers(big), want.repeat(k)))
            plans.add(MY.schedule(big.count, int(big.host_a_len.max()), big.nbits, sms))
            checked += 1

    pairs = [(m, n) for m in MYERS_EDGES for n in MYERS_EDGES]
    by_bytes = [(bytes(rng.integers(97, 101, m, dtype=np.uint8)), bytes(rng.integers(97, 101, n, dtype=np.uint8)))
                for m, n in pairs]
    cps_a = [rng.integers(0, 0x110000, m).astype(np.int32) for m, _ in pairs]
    cps_b = [np.concatenate([x[: n // 2], rng.integers(0x1F600, 0x1F604, n - n // 2)]).astype(np.int32)[:n]
             for x, (_, n) in zip(cps_a, pairs)]
    fill = -(-sms * MY.LATENCY_THREADS // (len(pairs) * 33)) + 1  # repeats past the latency-bound schedule
    for mb in (MY.MyersBatch.from_arrays(*_padded_codes(by_bytes), nbits=MY.BYTE_BITS, device=dev),
               MY.myers_from_tokens([acgt[rng.integers(0, 4, m)].tobytes() for m, _ in pairs],
                                    [acgt[rng.integers(0, 4, n)].tobytes() for _, n in pairs], device=dev),
               MY.myers_from_codepoints(cps_a, cps_b, device=dev)):
        check(mb, fill)
    for cap in (32, 64, 128, 256, 512, 2100):
        lens = [m for m in MYERS_EDGES if m <= cap] + [cap, int(rng.integers(1, cap + 1))]
        batch = [(bytes(rng.integers(97, 101, m, dtype=np.uint8)), bytes(rng.integers(97, 101, n, dtype=np.uint8)))
                 for m in lens for n in (0, 1, 33, 100, 1025)]
        check(MY.MyersBatch.from_arrays(*_padded_codes(batch), nbits=MY.BYTE_BITS, device=dev))
    long = [(bytes(rng.integers(97, 101, m, dtype=np.uint8)), bytes(rng.integers(97, 101, n, dtype=np.uint8)))
            for m in (8191, 8192, 8193, 9000) for n in (0, 1, 100)]
    check(MY.MyersBatch.from_arrays(*_padded_codes(long), nbits=MY.BYTE_BITS, device=dev), 48)
    if not {(32, 1), (64, 4), (64, 2)} <= {plan[:2] for plan in plans}:
        raise AssertionError(f"the Myers edge batches took the schedules {sorted(plans)}, not every form")
    return checked


def _padded_codes(pairs: list[tuple[bytes, bytes]]):
    """int32 [B, A] patterns, [B, L] texts and their lengths of byte pairs."""
    A = max(1, max(len(a) for a, _ in pairs))
    L = max(1, max(len(b) for _, b in pairs))
    a = np.zeros((len(pairs), A), np.int32)
    b = np.zeros((len(pairs), L), np.int32)
    for i, (x, y) in enumerate(pairs):
        a[i, : len(x)] = np.frombuffer(x, np.uint8)
        b[i, : len(y)] = np.frombuffer(y, np.uint8)
    return a, b, np.array([len(x) for x, _ in pairs]), np.array([len(y) for _, y in pairs])


def check_poly_edges(dev, errors: dict) -> int:
    """The Poly1305 kernel's geometry (``CC.poly_geometry``) against
    ``poly1305_plain`` on the card and, to 64 KiB, ``poly1305_ref``,
    exactly: raw-mode lengths one byte under, at and over a warp's group of
    32 blocks (512 B), a block of 8 warps' groups (4 KiB), the one-launch
    span (16 KiB) and its doubles, 32 and 33 block partials (a fold of more
    than one group of 32) and the persistent grid's cap (2 blocks an SM);
    AEAD mode with the MAC input (pad16(aad), pad16(ciphertext), the
    lengths) across the same spans, with an empty and a 13-byte aad.
    Returns the tags checked."""
    from stringwars_tpu_torch.ops import chacha as CC

    rng = np.random.default_rng(44)
    one = CC.POLY_ONE_LAUNCH * 16
    cap = torch.cuda.get_device_properties(dev).multi_processor_count * CC.POLY_BLOCKS_PER_SM * one
    spans = (512, 4096, one, 2 * one, 32 * one, 33 * one, cap, 2 * cap)
    buf = random_bytes(2 * cap + 4096, 45, dev)
    checked = 0

    def check(key32: bytes, got: bytes, mac: torch.Tensor) -> None:
        nonlocal checked
        want = CC.poly1305_plain(key32, mac)
        errors["poly1305"] = max(errors["poly1305"], max_err(torch.tensor(list(got)), torch.tensor(list(want))))
        if mac.numel() <= 65536:
            ref = CC.poly1305_ref(key32, mac.cpu().numpy().tobytes())
            errors["poly1305"] = max(errors["poly1305"], max_err(torch.tensor(list(got)), torch.tensor(list(ref))))
        checked += 1

    for span in spans:
        for n in (span - 1, span, span + 1):
            key32 = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            check(key32, CC.poly1305_tag(key32, buf[:n]), buf[:n])
    for aad_len in (0, 13):
        aad = buf[-aad_len:] if aad_len else buf[:0]
        for span in spans[:6]:
            for n in (span - 16 - 16 * -(-aad_len // 16) + d for d in (-1, 0, 1)):
                key32 = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                key = torch.tensor(list(key32), dtype=torch.uint8, device=dev)
                tag = bytes(CC.poly1305_cuda(key, buf[:n], aad).cpu().tolist())
                check(key32, tag, CC._mac_data_tensor(aad.cpu().numpy().tobytes(), buf[:n]))
    return checked


def crowded_bpe_merges(seed: int = 0, count: int = 5) -> list[tuple[int, int]]:
    """``count`` byte pairs whose keys all lie in bucket 0 under both
    multipliers that ``build_hashed(seed=seed)`` draws first: their table's
    build has to draw again (as ``tests/test_torch_bpe.py`` builds it)."""
    from stringwars_tpu_torch.ops import bpe as BPE

    mults = [int(m) | 1 for m in np.random.default_rng(seed).integers(0, 1 << 32, 2, dtype=np.uint64)]
    keys = np.arange(1 << 16, dtype=np.uint32)
    keys = (keys >> 8) << 16 | (keys & 0xFF)
    shift = 32 - max(1, (count - 1).bit_length())  # the table's buckets: count at a load of one half
    crowded = keys[(BPE.bucket_of(keys, mults[0], shift) == 0) & (BPE.bucket_of(keys, mults[1], shift) == 0)][:count]
    return [(int(k) >> 16, int(k) & 0xFFFF) for k in crowded]


def check_bpe_edges(dev, errors: dict) -> int:
    """The BPE kernel's lane groups and hashed tables against
    ``bpe_encode_plain``, exactly, in both table regimes: chunks of 8 rows
    that mix rows of 1..4 B with rows of 32 B (groups of 32 lanes for the
    whole chunk), a shuffled batch of 1..32 B, rows at every length
    under each group size's edge (4, 5, 8, 9, 16, 17, 32), batches of 1..9
    rows (a chunk's tail past the batch), and a table whose build drew a
    second multiplier pair (five keys crowded into one bucket). Returns the
    batches checked."""
    from stringwars_tpu_torch.ops import bpe as BPE
    from stringwars_tpu_torch.ops import bpe_cuda as BPC

    rng = np.random.default_rng(43)

    def words(alphabet: bytes, lo: int, hi: int, count: int) -> list[bytes]:
        letters = np.frombuffer(alphabet, np.uint8)
        return [rng.choice(letters, int(rng.integers(lo, hi + 1))).tobytes() for _ in range(count)]

    mixed = words(b"abcd", 1, 4, 8000)
    for at in rng.choice(len(mixed), 600, replace=False):
        mixed[at] = words(b"abcd", 32, 32, 1)[0]
    shuffled = words(b"abcde", 1, 32, 6000)
    edges = [w for n in (3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32) for w in words(b"abc", n, n, 300)]
    merges = BPE.train_merges(mixed + shuffled + edges, 300)
    crowded = crowded_bpe_merges()
    crowded_table = BPE.MergeTable.from_merges(crowded)
    if crowded_table.hashed().attempts < 2:
        raise AssertionError(f"the crowded BPE table was built at its first multipliers: {crowded_table.hashed()}")
    letters = bytes(sorted({b for pair in crowded for b in pair}))
    table = BPE.MergeTable.from_merges(merges)
    cases = [(mixed, table), (shuffled, table), (edges, table), (words(letters, 0, 32, 4001), crowded_table)]
    cases += [(words(b"abcd", 0, 32, n), table) for n in range(1, 10)]
    checked = 0
    for tokens, tab in cases:
        rows_np, lens_np = BPE.pack_rows(tokens, 32)
        rows_t, lens_t = torch.from_numpy(rows_np).to(dev), torch.from_numpy(lens_np).to(dev)
        want = BPE.bpe_encode_plain(rows_t, lens_t, tab)
        for global_table in (False, True):
            got = BPC.bpe_encode(rows_t, lens_t, tab, global_table=global_table)
            errors["bpe"] = max(errors["bpe"], max_err(got[0], want[0]), max_err(got[1], want[1]))
            checked += 1
    return checked


def fingerprint_cells(tokens, ndim: int) -> int:
    """(position, dim) cells of a fingerprint call: for each document and
    width, its valid positions times the width's ndim / 4 dims."""
    from stringwars_tpu_torch.ops import fingerprint as FP

    lengths = tokens.lengths.cpu().numpy().astype(np.int64).clip(0, tokens.width)
    positions = sum(np.minimum(np.maximum(lengths - w, 0) + 1, tokens.width).sum() for w in FP.WINDOW_WIDTHS)
    return int(positions) * (ndim // 4)


# CUDA launches a wrapper launch makes in the traced calls (the MAC: one for
# an input of up to CC.POLY_ONE_LAUNCH blocks, as every per-token seal's;
# a longer one adds its fold): device_breakdown scales a kernel's traced
# mean by these.
CUDA_LAUNCHES = {"poly1305": 1}


def traced_call(name: str, call, launches, kernels: dict[str, str], bound: tuple | None = None) -> None:
    """One line for a suite's call: timed back to back (CUDA events), the
    launches a call of each kernel (launch counter -> substring of its CUDA
    name), its device ms a call in each kernel and in the other torch ops
    (``torch.profiler`` over 20 calls; a kernel's share is its traced mean a
    launch times its launches a call) and a launch, device busy (the device
    time over the call's), and the call's bound."""
    call_ms = time_ms(call)
    before = launches()
    call()
    torch.cuda.synchronize()
    per_call = {key: launches()[key] - before[key] for key in kernels}
    split = device_breakdown(call, kernels, calls=20,
                             launches={key: per_call[key] * CUDA_LAUNCHES.get(key, 1) for key in kernels})
    if split is None:
        detail = f"not measured (no profiler trace in {TRACES} saw {sorted(kernels.values())})"
    else:
        detail = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        detail += "".join(f"; {k} {split[k] / per_call[k]:.4f} a launch" for k in kernels if per_call[k])
        detail += f"; device busy {split['total'] / call_ms:.2f}"
    bound_text = f"; bound {bound[0]:.4f} ms ({bound[1]})" if bound else ""
    launches_text = ", ".join(f"{k} {v}" for k, v in per_call.items())
    phase("row", f"{name}: {call_ms:.4f} ms back to back, launches a call {launches_text}; device ms per call: {detail}"
                 f"{bound_text}")


def find_fingerprint_rows(row, dev, flat: torch.Tensor, worst: tuple, find_tape, fp_tokens, launches) -> None:
    """The substring and fingerprint rows. Substring: 64 needles of 8 and 16
    B over ``flat`` (128 MB of lowercase; bound: one read of the haystack
    and one operation a window, what counting a batch needs, whatever its
    size), the rfind of one needle, the one-key instance beside the
    one-filter bitmap for that needle and for the backward row's first
    needle (``one_key_fork``), the worst case (timed, its own line),
    and the find suite's forward and backward calls traced. Fingerprints:
    ``tools/tpu_campaign.py``'s 16 MB shape without and with counts, the
    fingerprints suite's own batch with counts at each ndim (profiler
    device time; bound: a multiply-add and a min a cell, 9 operations a
    byte for the grams), and the suite's calls traced."""
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC
    from stringwars_tpu_torch.ops import fingerprint as FP
    from stringwars_tpu_torch.suites import find as find_suite
    from stringwars_tpu_torch.suites import fingerprints as fp_suite

    needle_rng = np.random.default_rng(3)
    nf = flat.numel()
    for m, cap in ((8, 4), (16, 8)):
        packed = [F.pack_needle(bytes(needle_rng.integers(97, 123, m, dtype=np.uint8)), cap) for _ in range(64)]
        batch = F.NeedleBatch.from_needles(packed, dev)
        row(f"find-cycle64-{m}B-128MB", lambda: FC.find_count_batch(flat, batch), lambda: F.find_count_batch_plain(flat, batch),
            64 * nf, bound_ms(nf, nf), "find_count" if m == 8 else None)
    single = F.NeedleBatch.from_needles([F.pack_needle(flat[4096:4104].cpu().numpy().tobytes(), 4)], dev)
    row("rfind-8B-128MB", lambda: FC.rfind_count_batch(flat, single), lambda: F.rfind_count_batch_plain(flat, single), nf,
        bound_ms(nf, nf), "rfind_count")
    one_key_fork("rfind-8B-128MB", flat, single, dev)
    first = find_suite.suite_needles(find_tape)[0][0]
    n = find_tape.total_bytes
    one_key_fork(f"find-suite-backward-needle-{n // 10**6}MB (the first of the cycle, {len(first)} B)", find_tape.data[:n],
                 F.NeedleBatch.from_needles([F.pack_needle(first, find_suite._needle_cap(first))], dev), dev)
    worst_hay, worst_batch, want_counts, _ = worst
    worst_ms = time_ms(lambda: FC.find_count_batch(worst_hay, worst_batch))
    matches = int(want_counts.sum())
    phase("row", f"find-worst-64-a-runs-64MB (the needles a * 1..64 over {worst_hay.numel():,} B of runs of a; "
                 f"{matches:,} matches, each verified byte by byte): kernel {worst_ms:.4f} ms "
                 f"({worst_hay.numel() / worst_ms / 1e6:.1f} GB/s, {matches / worst_ms / 1e6:.1f} G matches/s); "
                 f"not a target")
    forward, _ = find_suite.forward_routine(find_tape)
    traced_call(f"find-suite-forward-{n // 10**6}MB (the find suite's forward call over {n:,} B)", forward, launches,
                {"find_count": "find_kernel"}, bound_ms(n, n))
    backward, _ = find_suite.backward_routine(find_tape)
    for _ in range(find_suite.CYCLE):  # each needle's filter table is staged at its first call, as in the suite's warm-up
        backward()
    traced_call(f"find-suite-backward-{n // 10**6}MB (the find suite's backward call, one needle)", backward, launches,
                {"rfind_count": "find_kernel"}, bound_ms(n, n))

    campaign = campaign_fingerprint_tokens(dev)
    cells = fingerprint_cells(campaign, 512)
    moved = 16384 * (1024 - 7 + 4) + 4 * 16384 * 512
    for counts, key in ((False, "fingerprint"), (True, None)):
        row(f"fingerprint-512d-16MB{'-counts' if counts else ''} ({cells:,} cells)",
            lambda: FP.fingerprint_cuda(campaign, 512, counts)[: 1 + counts],
            lambda: FP.fingerprint_plain(campaign, 512, with_counts=counts)[: 1 + counts],
            campaign.data.numel(), bound_ms(moved + (4 * 16384 * 512 if counts else 0), 2 * cells + 9 * campaign.data.numel()),
            key, plain_samples=1)
    del campaign
    text = int(fp_tokens.lengths.sum())
    for ndim in fp_suite.ndim_scales():
        cells = fingerprint_cells(fp_tokens, ndim)
        row(f"fingerprint-suite-{fp_tokens.count}docs-ndim{ndim} ({text:,} B in rows of {fp_tokens.width}, {cells:,} cells)",
            lambda: FP.fingerprint_cuda(fp_tokens, ndim, True), lambda: FP.fingerprint_plain(fp_tokens, ndim, with_counts=True),
            text, bound_ms(text + 4 * fp_tokens.count + 8 * fp_tokens.count * ndim, 2 * cells + 9 * text),
            plain_samples=1, profiled="fingerprint_kernel")
        traced_call(f"fingerprint ndim {ndim} call (the suite's)", lambda: FP.fingerprint(fp_tokens, ndim=ndim), launches,
                    {"fingerprint": "fingerprint_kernel"})


def one_key_fork(name: str, hay: torch.Tensor, batch, dev) -> None:
    """The substring kernel's one-key instance (filters 0: the head compared
    with the needle's key) beside its one-filter bitmap probe on the same
    table, for a batch of one needle: both equal to the plain version, each
    by its device time a launch (profiler), on one line."""
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC

    table = batch.filters(dev)
    if table.filters != 0:
        raise AssertionError(f"{name}: one needle took {table.filters} filters, not the one-key instance")
    bitmap = F.NeedleBatch(batch.images, batch.lengths, batch.host_lengths, batch.host_images)
    bitmap.staged[dev] = dataclasses.replace(table, filters=1)  # the same table through the bitmap probe
    want = F.rfind_count_batch_plain(hay, batch)
    times = []
    for form in (batch, bitmap):
        got = FC.rfind_count_batch(hay, form)
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        if err:
            raise AssertionError(f"{name}: the kernel with {form.filters(dev).filters} filters differs by {err}")
        times.append(device_ms(lambda: FC.rfind_count_batch(hay, form), "find_kernel"))
    text = ", ".join("not measured" if t is None else f"{t:.4f}" for t in times)
    phase("row", f"{name}: one key, one-filter bitmap: {text} ms a launch (device), equal")


def make_row(timings: dict):
    """``row``: a kernel timed beside its plain version on the card (equal
    first), with its bound and, where given, one PyTorch call's time; the
    times of a row with ``key`` go into ``timings`` for the kernels line."""

    def row(name, kernel, plain, work_bytes, bound, key=None, library=None, plain_samples=SAMPLES, cells=None, profiled=None,
            per_call=False, note=""):
        got, want = kernel(), plain()
        err = max(max_err(a, b) for a, b in zip(got, want)) if isinstance(got, tuple) else max_err(got, want)
        if err:
            raise AssertionError(f"{name}: kernel and plain differ by {err}")
        ms = time_ms(kernel)
        calls_text = note
        if profiled:  # the kernel's device time; the back-to-back calls beside it
            traced = device_ms(kernel, profiled, per_call=per_call)
            if traced is None:
                calls_text += f", no profiler trace in {TRACES} saw {profiled}: ms is the CUDA-event time of calls back to back"
            else:
                calls_text += f", calls back to back {ms:.4f} ms"
                ms = traced
        plain_ms = time_ms(plain, samples=plain_samples, warm=min(WARM, plain_samples))
        library_ms = time_ms(library) if library else None
        bound_value, bound_by = bound
        if key:
            timings[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_value, "bound_by": bound_by, "library_ms": library_ms}
        lib_text = f", library {library_ms:.4f} ms" if library_ms is not None else ""
        phase(
            "row",
            f"{name}: kernel {ms:.4f} ms ({rate(ms, work_bytes, cells)}), plain {plain_ms:.4f} ms, "
            f"bound {bound_value:.4f} ms ({bound_by}; kernel at {100 * bound_value / ms:.1f}%){lib_text}{calls_text}, equal",
        )

    return row


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from stringwars_tpu_torch import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    corpus = build.BUILD_DIR / "multilingual-128mb.txt"
    corpus.unlink(missing_ok=True)
    child = start_corpus(corpus)
    try:
        return smoke(corpus, child)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        corpus.unlink(missing_ok=True)
        corpus.with_name(corpus.name + ".part").unlink(missing_ok=True)


def smoke(corpus: Path, child: subprocess.Popen) -> int:
    from stringwars_tpu_torch import build, datasets, entry
    from stringwars_tpu_torch import tape as T
    from stringwars_tpu_torch.ops import bpe as BPE
    from stringwars_tpu_torch.ops import bpe_cuda as BPC
    from stringwars_tpu_torch.ops import bytesum as B
    from stringwars_tpu_torch.ops import chacha as CC
    from stringwars_tpu_torch.ops import find as F
    from stringwars_tpu_torch.ops import find_cuda as FC
    from stringwars_tpu_torch.ops import fingerprint as FP
    from stringwars_tpu_torch.ops import hash as H
    from stringwars_tpu_torch.ops import hash_cuda as HC
    from stringwars_tpu_torch.ops import casefold as CF
    from stringwars_tpu_torch.ops import expand as EX
    from stringwars_tpu_torch.ops import expand_cuda as EXC
    from stringwars_tpu_torch.ops import rulemap as R
    from stringwars_tpu_torch.ops import affine as AF
    from stringwars_tpu_torch.ops import affine_cuda as AFC
    from stringwars_tpu_torch.ops import ahocorasick as AC
    from stringwars_tpu_torch.ops import ahocorasick_cuda as ACC
    from stringwars_tpu_torch.ops import memops as M
    from stringwars_tpu_torch.ops import myers as MY
    from stringwars_tpu_torch.ops import myers_cuda as MYC
    from stringwars_tpu_torch.ops import shiftand as SA
    from stringwars_tpu_torch.ops import shiftand_cuda as SAC
    from stringwars_tpu_torch.ops import similarity as S
    from stringwars_tpu_torch.ops import lut as LU
    from stringwars_tpu_torch.ops import scanline as SL
    from stringwars_tpu_torch.ops import scanline_cuda as SLC
    from stringwars_tpu_torch.ops import segment as SEG
    from stringwars_tpu_torch.ops import sha256 as SHA
    from stringwars_tpu_torch.ops import utf8 as U8
    from stringwars_tpu_torch.suites import encryption as enc_suite
    from stringwars_tpu_torch.suites import find as find_suite
    from stringwars_tpu_torch.suites import fingerprints as fp_suite
    from stringwars_tpu_torch.suites import hash as hash_suite
    from stringwars_tpu_torch.suites import normalization as norm_suite
    from stringwars_tpu_torch.suites import similarities as sim_suite
    from stringwars_tpu_torch.suites import tokenization as tok_suite
    from stringwars_tpu_torch.unicode import tables as UT
    from stringwars_tpu_torch.utils.profiler import card_identity

    counters = (B.LAUNCHES, FC.LAUNCHES, HC.LAUNCHES, FP.LAUNCHES, M.LAUNCHES, MYC.LAUNCHES, AFC.LAUNCHES, ACC.LAUNCHES,
                SAC.LAUNCHES, LU.LAUNCHES, SLC.LAUNCHES, EXC.LAUNCHES, BPC.LAUNCHES, CC.LAUNCHES, SHA.LAUNCHES)

    def wait_corpus() -> bytes:
        if child.wait():
            raise AssertionError(f"synthesizing the tokenization corpus failed (exit code {child.returncode})")
        return corpus.read_bytes()

    def launches() -> dict[str, int]:
        return {k: v for counter in counters for k, v in counter.items()}

    whole = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = card_identity(dev)  # `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(smi, flush=True)

    # -- 2. build -------------------------------------------------------------
    started = time.perf_counter()
    build.library()
    log = build.library_path().with_suffix(".log")
    ptxas = log.read_text().splitlines() if log.exists() else []
    usage = [line.split(":", 1)[1].strip() for line in ptxas if "registers" in line]
    spilled, function = [], "?"
    for line in ptxas:
        if "Function properties for " in line:
            function = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line and " 0 bytes spill stores" not in line:
            spilled.append(f"{function} ({line.strip()})")
    phase(
        "build",
        f"{len(usage)} kernels, {len(spilled)} with spills {spilled}; ptxas: {' | '.join(usage[:12]) or 'library already built'}",
        started,
    )

    # -- 3. kernels against their plain versions ------------------------------
    started = time.perf_counter()
    names = list(launches())
    errors = {name: 0 for name in names}
    before = launches()
    checked, worst = check_find(dev, errors)
    rng = np.random.default_rng(1)
    n = 64 << 20
    bytes_hay = random_bytes(n + 16, 2, dev)
    for charset in find_suite.BYTESETS.values():
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
    del bytes_hay, ones

    # Hashes: tokens of 0..130 B (16-byte rows and 4-byte rows), and one
    # token set spread over every bucket of the hash suite.
    sweep = [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for k in range(131)]
    spread = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in rng.integers(1, 5000, 600)]
    layouts = [T.PaddedTokens.from_tape(T.Tape.from_tokens(sweep), align=a).to(dev) for a in (64, 4)]
    layouts += T.bucket_by_length(T.Tape.from_tokens(spread, device=dev), hash_suite.BUCKET_EDGES)
    seed_sets = ([0], [12345], [0xDEADBEEFCAFEBABE], list(range(8)), list(range(16)))
    for padded in layouts:
        for seeds in seed_sets:
            errors["xxh64"] = max(errors["xxh64"], max_err(HC.xxh64(padded, seeds), H.xxh64_plain(padded, seeds)))
            errors["swh64"] = max(errors["swh64"], max_err(HC.swh64(padded, seeds), H.swh64_plain(padded, seeds)))
            errors["xxh32"] = max(errors["xxh32"], max_err(HC.xxh32(padded, seeds), H.xxh32_plain(padded, seeds)))
    empty = T.PaddedTokens.from_tape(T.Tape.from_tokens([b""])).to(dev)
    empty64 = int(HC.xxh64(empty, [0]).view(torch.int64).item()) & (2**64 - 1)
    empty32 = int(HC.xxh32(empty, [0]).to(torch.int64).item())
    if (empty64, empty32) != (0xEF46DB3751D8E999, 0x02CC5D05):
        raise AssertionError(f"XXH64('') = {empty64:#x}, XXH32('') = {empty32:#x}")
    # The tree level: five extents of a 128 MB buffer, then every base
    # offset 0..15 of an 8 MB one at extents around the 16-byte units, the
    # pipeline's slices and the chunks.
    tree_buf = random_bytes((128 << 20) + 3, 6, dev)
    for extent in (0, 1, H.TREE_CHUNK, H.TREE_CHUNK + 1, tree_buf.numel()):
        errors["xxh64_tree"] = max(errors["xxh64_tree"], max_err(HC.tree_level(tree_buf, extent), H.tree_level_plain(tree_buf, extent)))
    del tree_buf
    tree_buf = random_bytes((8 << 20) + 64, 7, dev)
    tree_cases = [(tree_buf[offset:], extent) for offset in range(16) for extent in tree_extents()]
    for (view, extent), want in zip(tree_cases, tree_levels_plain(tree_cases)):
        errors["xxh64_tree"] = max(errors["xxh64_tree"], max_err(HC.tree_level(view, extent), want))
    tree_levels = 5 + len(tree_cases)
    del tree_buf, tree_cases

    fp_checked = check_fingerprint(dev, errors)

    lut = torch.from_numpy(M.invert_case_lut()).to(dev)
    for view in (big[: 64 << 20], big[3 : (64 << 20) + 8], big[15:1000], big[:7]):
        errors["lut_translate"] = max(errors["lut_translate"], max_err(M.lut_translate_cuda(view, lut), M.lut_translate_plain(view, lut)))
    # Multi-pattern counts over 6 MB + 13 B (lowercase, then a-c, then every
    # byte value) with patterns planted, at n and n - 5 and a short extent:
    # the DFA in its three table regimes (by the automata's sizes: 13 to 47
    # states shared, the dictionary and the long random set global, the
    # 300-fold duplicate wide), the Shift-And kernel
    # with one and two state words, each at its own chunk and at 32-byte
    # chunks (shorter than the long patterns' overlap).
    mp_rng = np.random.default_rng(9)
    english = datasets.synthesize("english-words", 1 << 20)
    words_1k = list(dict.fromkeys(T.Tape.from_buffer(english, "words").to_list()))[:1000]
    random300 = [bytes(mp_rng.choice(np.frombuffer(b"abc", np.uint8), int(m))) for m in (1, 2, 3, 7, 40, 150, 299, 300)]
    mp_parts = [lowercase(4 << 20, 9, dev), torch.from_numpy(mp_rng.choice(np.frombuffer(b"abc", np.uint8), 1 << 20)).to(dev),
                random_bytes((1 << 20) + 13, 10, dev)]
    mp_hay = torch.cat(mp_parts)
    mp_sets = {
        "4words": [b"the", b"and", b"tion", b"abcd"],
        "8words": [b"needle", b"haystack", b"pattern", b"search", b"string", b"find", b"match", b"token"],
        "7words": [b"needle", b"haystack", b"pattern", b"search", b"string", b"find", b"match"],
        "nested": [b"abc", b"bc", b"c"],
        "zero-ff": [b"\x00a", b"\xff", b"a\x00\x00"],
        "html": [bytes([c]) for c in find_suite.BYTESETS["html"]],
        "1kwords": words_1k,
        "random300": random300,
        "wide": [b"a"] * 300 + [b"ab"],
    }
    for patterns in mp_sets.values():
        for i, p in enumerate(patterns[:64]):
            for at in mp_rng.integers(0, mp_hay.numel() - len(p), 4).tolist() + ([mp_hay.numel() - len(p)] if i == 0 else []):
                mp_hay[at : at + len(p)] = torch.frombuffer(bytearray(p), dtype=torch.uint8).to(dev)
    mp_checked, regimes_seen = 0, set()
    for set_name, patterns in mp_sets.items():
        auto = AC.Automaton(patterns)
        regimes_seen.add(ACC.regime_of(auto))
        sa = SA.ShiftAndSet(patterns) if sum(map(len, patterns)) <= SA.MAX_BITS and max(map(len, patterns)) <= 32 else None
        for extent in (mp_hay.numel(), mp_hay.numel() - 5, (1 << 20) + 3):
            want = AC.ac_count_plain(auto, mp_hay, extent)
            for chunk in (None, ACC.CHUNK_ALIGN):
                errors["ac_dfa"] = max(errors["ac_dfa"], max_err(ACC.ac_count(auto, mp_hay, extent, chunk=chunk), want))
                mp_checked += 1
            if sa is not None:
                errors["shiftand"] = max(errors["shiftand"], max_err(SA.shiftand_count_plain(sa, mp_hay, extent), want))
                for chunk in (None, ACC.CHUNK_ALIGN):
                    errors["shiftand"] = max(errors["shiftand"], max_err(SAC.shiftand_count(sa, mp_hay, extent, chunk=chunk), want))
                    mp_checked += 1
    if regimes_seen != {"shared", "global", "wide"} or SA.ShiftAndSet(mp_sets["8words"]).n_words != 2:
        raise AssertionError(f"the multi-pattern checks missed a regime or the two-word Shift-And: {regimes_seen}")
    del mp_parts, mp_hay
    # 64 small cases against brute force: 0..3000 B over two or three
    # letters, sets of 1..6 patterns of 1..8 B.
    mp_oracle = 0
    for case in range(64):
        letters = np.frombuffer(b"ab" if case % 2 else b"abc", np.uint8)
        text = mp_rng.choice(letters, int(mp_rng.integers(0, 3000))).tobytes()
        patterns = [mp_rng.choice(letters, int(mp_rng.integers(1, 9))).tobytes() for _ in range(int(mp_rng.integers(1, 7)))]
        want = sum(sum(1 for i in range(len(text) - len(p) + 1) if text.startswith(p, i)) for p in patterns)
        hay_small = torch.frombuffer(bytearray(text + b"\x00"), dtype=torch.uint8).to(dev)
        got = [int(ACC.ac_count(AC.Automaton(patterns), hay_small, len(text)).item()),
               int(SAC.shiftand_count(SA.ShiftAndSet(patterns), hay_small, len(text)).item())]
        if got != [want, want]:
            raise AssertionError(f"small case {case}: {patterns} over {len(text)} B: kernels {got}, brute force {want}")
        mp_oracle += 1
    unaligned_checked = check_unaligned(dev, errors)

    # Edit distances and alignment scores: pattern lengths across the word
    # edges against texts of 0..1100 B (empty sides included) in three
    # alphabets, each batch more pairs than one block holds, and a uniform
    # batch large enough for 128-thread blocks.
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lengths = [0, 1, 31, 32, 33, 63, 64, 65, 100, 128, 129, 256, 300, 1023]
    texts = [0, 1, 7, 64, 300, 1100]
    pair_lens = [(m, n) for m in lengths for n in texts]
    pair_lens += [(int(m), int(n)) for m, n in zip(rng.integers(0, 400, 300), rng.integers(0, 1100, 300))]
    byte_a = [bytes(rng.integers(0, 256, m, dtype=np.uint8)) for m, _ in pair_lens]
    byte_b = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for _, n in pair_lens]
    dna_a = [acgt[rng.integers(0, 4, m)].tobytes() for m, _ in pair_lens]
    dna_b = [acgt[rng.integers(0, 4, n)].tobytes() for _, n in pair_lens]
    cp_a = [rng.integers(0, 0x110000, m).astype(np.int32) for m, _ in pair_lens]
    cp_b = []
    for x, (_, n) in zip(cp_a, pair_lens):
        y = rng.integers(0x1F5F0, 0x1F610, n).astype(np.int32)  # astral
        k = min(len(x), n) // 2
        y[:k] = x[:k]
        cp_b.append(y)
    uniform = [row.tobytes() for row in acgt[rng.integers(0, 4, (2 * 40000, 64))]]
    dp_outs: dict[tuple[str, str], np.ndarray] = {}
    dp_sets = {
        "bytes": (MY.myers_from_tokens(byte_a, byte_b, device=dev), AF.affine_from_tokens(byte_a, byte_b, device=dev)),
        "dna": (MY.myers_from_tokens(dna_a, dna_b, device=dev), AF.affine_from_tokens(dna_a, dna_b, device=dev)),
        "codepoints": (MY.myers_from_codepoints(cp_a, cp_b, device=dev), None),
        "uniform": (
            MY.myers_from_tokens(uniform[:40000], uniform[40000:], device=dev),
            AF.affine_from_tokens(uniform[:40000], uniform[40000:], device=dev),
        ),
    }
    for set_name, (mb, ab) in dp_sets.items():
        got = MYC.myers(mb)
        errors["myers"] = max(errors["myers"], max_err(got, MY.myers_plain(mb)))
        dp_outs[(set_name, "levenshtein")] = got.cpu().numpy()
        if ab is None:
            continue
        for fn, go, ge, local in (("nw_affine", -5, -1, False), ("sw_affine", -5, -1, True), ("nw_linear", -2, -2, False), ("sw_linear", -2, -2, True)):
            got = AFC.align(ab, 2, -1, go, ge, local=local)
            key = "linear" if go == ge else "affine"
            errors[key] = max(errors[key], max_err(got, S._score_scan(ab.pairs, 2, -1, go, ge, local=local)))
            dp_outs[(set_name, fn)] = got.cpu().numpy()
    dp_nbits = {name: mb.nbits for name, (mb, _) in dp_sets.items()}
    myers_edge_checks = check_myers_edges(dev, errors)
    # A sample of 64 pairs against the brute-force oracles on the host.
    small = [i for i, (m, n) in enumerate(pair_lens) if m * n <= 4000]
    oracle_checked = 0
    for set_name, (xa, xb) in (("bytes", (byte_a, byte_b)), ("dna", (dna_a, dna_b))):
        for i in small[:32]:
            x, y = xa[i], xb[i]
            want = {
                "levenshtein": S.levenshtein_ref(x, y),
                "nw_affine": S.nw_ref(x, y, 2, -1, -5, -1),
                "sw_affine": S.sw_ref(x, y, 2, -1, -5, -1),
                "nw_linear": S.nw_ref(x, y, 2, -1, -2, -2),
                "sw_linear": S.sw_ref(x, y, 2, -1, -2, -2),
            }
            for fn, value in want.items():
                if int(dp_outs[(set_name, fn)][i]) != value:
                    raise AssertionError(f"{fn} of {set_name} pair {i}: kernel {dp_outs[(set_name, fn)][i]}, oracle {value}")
            oracle_checked += 1
    del dp_sets
    # Pairs at each boundary of the alignment kernel's lane groups and
    # strips: a batch per (lanes a pair, strip height), set by its number of
    # pairs and its longest a, the lengths of a at each strip's and pass's
    # edge (the last batch takes several passes).
    align_shapes = []
    for count, lens in ((6400, (1, 7, 8, 9, 63, 64, 65, 127, 128)), (3200, (7, 8, 9, 63, 64, 65, 100, 127, 128)),
                        (3200, (15, 16, 17, 127, 128, 129, 255, 256)),
                        (256, (31, 32, 33, 255, 256, 257, 511, 512, 513, 1024, 1025, 2049))):
        a_t = [acgt[rng.integers(0, 4, lens[i % len(lens)])].tobytes() for i in range(count)]
        b_t = [acgt[rng.integers(0, 4, int(rng.integers(0, 300)))].tobytes() for _ in range(count)]
        ab = AF.affine_from_tokens(a_t, b_t, device=dev)
        for go, ge, local in ((-5, -1, False), (-5, -1, True), (-2, -2, False), (-2, -2, True)):
            key = "linear" if go == ge else "affine"
            want = S._score_scan(ab.pairs, 2, -1, go, ge, local=local)
            errors[key] = max(errors[key], max_err(AFC.align(ab, 2, -1, go, ge, local=local), want))
        align_shapes.append((count, max(lens), ab.shape()))
    torch.cuda.synchronize()
    del big

    # Class maps: every segmentation table pruned at 0xFFFF (u8 tables of at
    # most 64 KiB) and whole (up to 0x10FFFF), over 32 Mi codepoints (128
    # MiB; BMP codepoints, then uniform ones from -3 to 0x11FFFF, past the
    # table: clamped), at an aligned and an unaligned view; and int32 tables
    # through lut_map.
    g = torch.Generator(device=dev).manual_seed(11)
    cps = torch.cat([
        torch.randint(0, 0x10000, (24 << 20,), dtype=torch.int32, device=dev, generator=g),
        torch.randint(-3, 0x120000, (8 << 20,), dtype=torch.int32, device=dev, generator=g),
    ])
    for name in SEG_TABLES:
        for max_cp in (0xFFFF, None):
            table = SEG._class_table(name, max_cp, dev)
            for view in (cps, cps[1:]):
                errors["class_map"] = max(errors["class_map"], max_err(LU.class_map_cuda(view, table), LU.class_map_plain(view, table)))
    for size in (5000, 100_000):  # int32 tables of 20 KB and 400 KB
        table = torch.randint(-(2**30), 2**30, (size,), dtype=torch.int32, device=dev, generator=g)
        idx = torch.randint(0, size, (1 << 20,), dtype=torch.int32, device=dev, generator=g)
        errors["class_map"] = max(errors["class_map"], max_err(LU.lut_map(idx, table), LU.class_map_plain(idx, table)))
    del cps

    # Fused scans: each kind both ways against the plain executor, at 128 Mi
    # positions and across the seams of the kernel's tiles (1,024 to 8,192
    # positions, by the program's on-chip streams), with bool and int8
    # flags (set where > 0) of several densities; then every segmentation
    # program both ways on random streams (the corpus's own streams are held
    # in the tokenization path).
    scan_n = 128 << 20
    values = torch.randint(-1000, 1000, (scan_n,), dtype=torch.int32, device=dev, generator=g)
    flags_b = torch.rand(scan_n, device=dev, generator=g) < 0.05
    flags_i8 = torch.randint(-2, 3, (scan_n,), dtype=torch.int8, device=dev, generator=g)
    sparse = torch.rand(scan_n, device=dev, generator=g) < 1e-4
    scan_checks = program_checks = 0
    seams = sorted({k * t + d for t in (2048, 4096, 8192) for k, d in ((1, -1), (1, 0), (1, 1), (3, 7))} | {1, 40 * 8192 + 3})
    for n_scan in seams + [scan_n]:
        for flags in (flags_b, flags_i8, sparse) if n_scan < scan_n else (flags_b,):
            streams = {"v": values[:n_scan], "f": flags[:n_scan]}
            for reverse in (False, True):
                for scan_kind in SCAN_KINDS:
                    ops = (SL.Op(scan_kind, "o", SCAN_BUILDS[scan_kind], init=-7),)
                    got = SL.fused_scan(streams, ops, n_scan, reverse=reverse)
                    want = SL.fused_scan_plain(streams, ops, n_scan, reverse=reverse)
                    for key in want:
                        errors["fused_scan"] = max(errors["fused_scan"], max_err(got[key], want[key]))
                    scan_checks += 1
    del values, flags_b, flags_i8, sparse, streams, got, want
    program_inputs = {
        name: torch.rand(4 << 20, device=dev, generator=g) < 0.3 for name in SEG_BOOL_STREAMS
    }
    program_inputs.update({
        name: torch.randint(-9, 24, (4 << 20,), dtype=torch.int32, device=dev, generator=g) for name in SEG_INT_STREAMS
    })
    for n_scan in seams + [4 << 20]:
        cut = {k: v[:n_scan] for k, v in program_inputs.items()}
        for ops in segment_programs(SEG):
            for reverse in (False, True):
                got = SL.fused_scan(cut, ops, n_scan, reverse=reverse)
                want = SL.fused_scan_plain(cut, ops, n_scan, reverse=reverse)
                for key in want:
                    errors["fused_scan"] = max(errors["fused_scan"], max_err(got[key], want[key]))
                program_checks += 1
    del program_inputs, cut, got, want

    # UAX#14 rules on random class streams (classes from the continuation
    # sentinel -9 to the last class; every (prev, eff) and (before_sp, eff)
    # pair of classes at the start), against the plain rule function.
    lb_n = (4 << 20) + 3
    lb_classes = len(UT.LB_VALUES)
    env = {name: torch.randint(0, lb_classes, (lb_n,), dtype=torch.int32, device=dev, generator=g) for name in SLC.LB_STREAMS}
    env["cls"] = torch.randint(-9, lb_classes, (lb_n,), dtype=torch.int32, device=dev, generator=g)
    env["lead"] = (torch.rand(lb_n, device=dev, generator=g) < 0.9).to(torch.int32)
    env["attached"] = (torch.rand(lb_n, device=dev, generator=g) < 0.1).to(torch.int32)
    env["ri_run_prev"] = torch.randint(-3, 6, (lb_n,), dtype=torch.int32, device=dev, generator=g)
    env["lead_ord"] = torch.randint(0, 4, (lb_n,), dtype=torch.int32, device=dev, generator=g)
    pairs = torch.arange(lb_classes * lb_classes, dtype=torch.int32, device=dev)
    env["prev"][: pairs.numel()], env["eff"][: pairs.numel()] = pairs // lb_classes, pairs % lb_classes
    env["before_sp"][pairs.numel() : 2 * pairs.numel()] = pairs // lb_classes
    env["eff"][pairs.numel() : 2 * pairs.numel()] = pairs % lb_classes
    errors["lb_rules"] = max(errors["lb_rules"], max_err(SLC.lb_rules(env, lb_n), SEG._lb_rules(env).to(torch.int32)))
    del env

    # Case folding. The expand-and-compact kernel in each of its regimes:
    # 32- and 64-byte UTF-8 rows of a BMP text with 3-codepoint folds (ΐ, ΰ,
    # ﬃ) at max_exp 1..3, rows of synthetic:naughty bytes (every byte value,
    # U+10FFFF) and of random bytes under the BMP fold tables (max_cp
    # 0xFFFF), and codepoint rows of 32 and 64 (negative and past the
    # table) under a synthetic 3-table set with lengths 0..4 at max_exp 3
    # and 4. The range map over the fold's four rule sets, whole (base 0 and
    # 1) and pruned, on BMP codepoints and on -3..0x11FFFF, aligned and not;
    # a fully pruned set takes no kernel. The window count at m = 1, 8, 129
    # and 300 over 16 Mi codepoints of three letters with planted needles,
    # at three extents and unaligned.
    fold_rng = np.random.default_rng(12)
    fold_text = "".join(fold_rng.choice(list("aAbBzZ .ßẞΣσςΐΰﬃİǅⅫ日本한ωΩ\n"), 1 << 20))
    fold_np = np.frombuffer(fold_text.encode(), np.uint8)
    bmp = EX.fold_tables(0xFFFF)
    junk_n = 1 << 16
    utf8_rows = [
        norm_suite.stream_rows(fold_np, 32, device=dev),
        norm_suite.stream_rows(fold_np, 64, device=dev),
        norm_suite.stream_rows(np.frombuffer(datasets.synthesize("naughty", 4 << 20), np.uint8), 32, device=dev),
        T.PaddedTokens(random_bytes(junk_n * 32, 13, dev).view(junk_n, 32),
                       torch.randint(0, 33, (junk_n,), dtype=torch.int32, device=dev, generator=g), 32),
    ]
    expand_checks = 0
    for rows in utf8_rows:
        for max_exp in (1, 2, 3):
            got = EXC.expand_compact_rows(rows.data, rows.lengths, bmp, max_exp, rows.width, True)
            want = EX.expand_compact_rows_plain(rows.data, rows.lengths, bmp, max_exp, rows.width, True)
            errors["expand"] = max(errors["expand"], max_err(got[0], want[0]), max_err(got[1], want[1]))
            expand_checks += 1
    fused, fused_counts = EX.fold_tokens_fused(utf8_rows[0], 0xFFFF)
    if int(fused_counts.sum()) != len(fold_text.casefold()) or fused.shape[1] != 3 * 32:
        raise AssertionError(f"fused fold of the check text: {int(fused_counts.sum())} codepoints, "
                             f"str.casefold {len(fold_text.casefold())}, width {fused.shape[1]}")
    size3 = 70_000
    t1 = ((torch.randint(-300, 300, (size3,), device=dev, generator=g) & 0xFFFF)
          | (torch.randint(0, 5, (size3,), device=dev, generator=g) << 16)).cpu()
    t23 = torch.randint(-(2**31), 2**31, (2, size3), device=dev, generator=g).cpu()
    three = EX.prepare_tables(*(t.to(torch.int32).numpy() for t in (t1, t23[0], t23[1])))
    cp_rows = torch.randint(-5, size3 + 300, (1 << 18, 64), dtype=torch.int32, device=dev, generator=g)
    for group in (32, 64):
        rows_cp = cp_rows[:, :group].contiguous()
        lens_cp = torch.randint(0, group + 1, (rows_cp.shape[0],), dtype=torch.int32, device=dev, generator=g)
        for max_exp in (3, 4):
            got = EXC.expand_compact_rows(rows_cp, lens_cp, three, max_exp, group, False)
            want = EX.expand_compact_rows_plain(rows_cp, lens_cp, three, max_exp, group, False)
            errors["expand"] = max(errors["expand"], max_err(got[0], want[0]), max_err(got[1], want[1]))
            expand_checks += 1
    del utf8_rows, cp_rows, fused
    rm_cps = torch.cat([
        torch.randint(0, 0x10000, (6 << 20,), dtype=torch.int32, device=dev, generator=g),
        torch.randint(-3, 0x120000, (2 << 20,), dtype=torch.int32, device=dev, generator=g),
    ])
    fold_rules = CF._fold_rules(None)[:4] + CF._fold_rules(0x4FF)[:1]
    for rules in fold_rules:
        table = torch.from_numpy(R.dense_delta_table(rules)).to(dev)
        for view in (rm_cps, rm_cps[1:]):
            got = LU.range_map_cuda(view, table, rules.base == 0)
            errors["range_map"] = max(errors["range_map"], max_err(got, R.range_map_plain(view, rules)))
            errors["range_map"] = max(errors["range_map"], max_err(R.range_map(view, rules), got))
    pruned = CF._fold_rules(0x7F)[3]
    if pruned.count or not torch.equal(R.range_map(rm_cps, pruned), torch.zeros_like(rm_cps)):
        raise AssertionError("a fully pruned value map must read zeros without a kernel")
    del rm_cps
    alphabet = torch.tensor([0x61, 0x3C3, 0xDF], dtype=torch.int32, device=dev)
    cp_stream = alphabet[torch.randint(0, 3, (16 << 20,), device=dev, generator=g)]
    cp_stream[5000:6000] = 0x61  # a run: overlapping matches
    window_checks = 0
    for m in (1, 8, 129, 300):
        needle = cp_stream[777 : 777 + m].clone()
        for at in fold_rng.integers(0, cp_stream.numel() - m, 4).tolist() + [cp_stream.numel() - m]:
            cp_stream[at : at + m] = needle
        for nd in (needle, torch.full((m,), 0x61, dtype=torch.int32, device=dev)):
            for view, extent in ((cp_stream, cp_stream.numel()), (cp_stream, cp_stream.numel() - 1), (cp_stream[1:], m + 5)):
                got = FC.cp_window_count(view, extent, nd)
                errors["cp_window"] = max(errors["cp_window"], max_err(got, F.cp_window_count_plain(view, extent, nd)))
                window_checks += 1
    del cp_stream

    # BPE: the kernel against bpe_encode_plain, ids and counts exactly, over
    # 512 trained merges (the shared-memory regime, and the global one asked
    # for) and 30,000 merges (the 512 and random pairs: the global regime),
    # on the JAX tests' cases
    # (hand merges, overlap runs a*1..32, fuzzed words over 3-5 letters at
    # widths up to 16 and 17-32, random bytes: 4,001 rows each, not a
    # multiple of a block's 8 rows), and at every width 1..32 on 1,001 rows
    # of lengths 0..W; 3,000 rows against the host oracle bpe_encode_ref.
    bpe_rng = np.random.default_rng(15)

    def bpe_words(alphabet: bytes, lo: int, hi: int, count: int) -> list[bytes]:
        letters_np = np.frombuffer(alphabet, np.uint8)
        return [bpe_rng.choice(letters_np, int(bpe_rng.integers(lo, hi + 1))).tobytes() for _ in range(count)]

    a_, b_, c_ = ord("a"), ord("b"), ord("c")
    bpe_sets = {
        "abc-1..16": bpe_words(b"abc", 1, 16, 4001),
        "abcde-1..16": bpe_words(b"abcde", 1, 16, 4001),
        "abcd-17..32": bpe_words(b"abcd", 17, 32, 4001),
        "bytes-0..32": [bytes(bpe_rng.integers(0, 256, int(bpe_rng.integers(0, 33)), dtype=np.uint8)) for _ in range(4001)],
    }
    merges512 = BPE.train_merges(sum(bpe_sets.values(), []), 512)
    merges_big, seen_pairs = list(merges512), set(merges512)
    while len(merges_big) < 30_000:
        pair = (int(bpe_rng.integers(0, 256 + len(merges_big))), int(bpe_rng.integers(0, 256 + len(merges_big))))
        if pair not in seen_pairs:
            seen_pairs.add(pair)
            merges_big.append(pair)
    hand = [(a_, a_), (a_, b_), (256, c_), (257, 257)]
    runs = [(a_, a_), (256, 256), (257, a_)]
    table512, table_big = BPE.MergeTable.from_merges(merges512), BPE.MergeTable.from_merges(merges_big)
    bpe_cases = [(tokens, None, merges, table) for merges, table in ((merges512, table512), (merges_big, table_big))
                 for tokens in bpe_sets.values()]
    bpe_cases += [
        ([b"", b"a", b"aa", b"aaa", b"aaaa", b"aaaaa", b"ab", b"aab", b"aac", b"aacaac", b"abab", b"cabcab", b"bca"], None,
         hand, BPE.MergeTable.from_merges(hand)),
        ([b"a" * k for k in range(1, 33)], None, runs, BPE.MergeTable.from_merges(runs)),
    ]
    bpe_cases += [(bpe_words(b"abcd", 0, w, 1001), w, None, table) for table in (table512, table_big) for w in range(1, 33)]
    bpe_regimes, bpe_checks, bpe_oracle = set(), 0, 0
    for tokens, width, merges, table in bpe_cases:
        rows_np, lens_np = BPE.pack_rows(tokens, width)
        rows_t, lens_t = torch.from_numpy(rows_np).to(dev), torch.from_numpy(lens_np).to(dev)
        got = BPC.bpe_encode(rows_t, lens_t, table)
        want = BPE.bpe_encode_plain(rows_t, lens_t, table)
        errors["bpe"] = max(errors["bpe"], max_err(got[0], want[0]), max_err(got[1], want[1]))
        bpe_regimes.add(BPC.regime_of(table))
        if BPC.regime_of(table) == "shared":
            forced = BPC.bpe_encode(rows_t, lens_t, table, global_table=True)
            errors["bpe"] = max(errors["bpe"], max_err(forced[0], want[0]), max_err(forced[1], want[1]))
        bpe_checks += 1
        if merges is merges512 and width is None:
            ids_h, counts_h = got[0].cpu().numpy(), got[1].cpu().numpy()
            for i in range(0, len(tokens), max(1, len(tokens) // 750)):
                if ids_h[i, : counts_h[i]].tolist() != BPE.bpe_encode_ref(tokens[i], merges):
                    raise AssertionError(f"bpe row {tokens[i]!r}: kernel {ids_h[i].tolist()}, bpe_encode_ref differs")
                bpe_oracle += 1
    if bpe_regimes != {"shared", "global"}:
        raise AssertionError(f"the BPE checks missed a table regime: {bpe_regimes}")
    if table_big.hashed().kicks == 0:
        raise AssertionError("the 30,000-merge table's build moved no entry: its cuckoo kicks are unchecked")
    bpe_edge_checks = check_bpe_edges(dev, errors)
    del bpe_cases, table512, table_big
    # ChaCha20: lengths 0..1 MiB + 13 at the counters 0, 1 and 0xFFFFFFF0
    # (the counter wraps), views at offsets 1..15 (the 4-byte and byte
    # paths), and the RFC 8439 §2.4.2 vector. Poly1305: lengths 0..300,
    # 65,536, and across the kernel's 256-byte runs, its 64 KiB partials and
    # the fold's runs of partials (past 256 partials), views at offsets 1..15;
    # the clamped r at its largest with s = 2^128 - 1 over 0xFF blocks; the
    # RFC vector; against the plain version and poly1305_ref.
    cc_rng = np.random.default_rng(17)
    cc_key, cc_nonce = cc_rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), cc_rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    cc_buf = random_bytes((17 << 20) + 64, 18, dev)
    cc_checks = poly_checks = poly_oracle = 0

    def byte_err(a: bytes, b: bytes) -> int:
        return max_err(torch.tensor(list(a)), torch.tensor(list(b)))

    for n_cc in (0, 1, 63, 64, 65, 4095, (1 << 20) + 13):
        for counter in (0, 1, 0xFFFFFFF0):
            view = cc_buf[:n_cc]
            got = CC.chacha20_xor_cuda(cc_key, cc_nonce, view, counter)
            errors["chacha20_xor"] = max(errors["chacha20_xor"], max_err(got, CC.chacha20_xor_plain(cc_key, cc_nonce, view, counter)))
            cc_checks += 1
    for off in range(1, 16):
        view = cc_buf[off : off + 4096 + off]
        got = CC.chacha20_xor_cuda(cc_key, cc_nonce, view, 1)
        errors["chacha20_xor"] = max(errors["chacha20_xor"], max_err(got, CC.chacha20_xor_plain(cc_key, cc_nonce, view, 1)))
        cc_checks += 1
    cc_edge_checks = check_chacha_edges(dev, errors)
    poly_edge_checks = check_poly_edges(dev, errors)
    sunscreen = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
                 b"only one tip for the future, sunscreen would be it.")
    rfc_ct = CC.chacha20_xor_cuda(bytes(range(32)), bytes.fromhex("000000000000004a00000000"),
                                  torch.tensor(list(sunscreen), dtype=torch.uint8, device=dev), 1)
    if rfc_ct.cpu().numpy().tobytes().hex() != (
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0bf91b65c5524733ab8f593dabcd62b3571639d624e65152ab"
        "8f530c359f0861d807ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab77937365af90bbf74a35be6b40b8eedf2785e42874d"
    ):
        raise AssertionError("ChaCha20 of the RFC 8439 §2.4.2 plaintext differs from its vector")
    span = 16 * 4096  # bytes of one partial of the MAC kernel's first pass
    poly_cases = [(0, n) for n in range(301)] + [(0, n) for n in (65536, 255, 256, 257, 4095, span - 1, span, span + 1,
                                                                     3 * span + 5, 256 * span, 257 * span + 7 * 16 + 3)]
    poly_cases += [(off, 1000 + off) for off in range(1, 16)]
    for off, n_poly in poly_cases:
        view = cc_buf[off : off + n_poly]
        key32 = cc_rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        got = CC.poly1305_tag(key32, view)
        errors["poly1305"] = max(errors["poly1305"], byte_err(got, CC.poly1305_plain(key32, view)))
        if n_poly <= 4096:
            errors["poly1305"] = max(errors["poly1305"], byte_err(got, CC.poly1305_ref(key32, view.cpu().numpy().tobytes())))
            poly_oracle += 1
        poly_checks += 1
    adversarial = bytes([0xFF] * 32)
    for n_poly in (16, 17, 160, 4096 + 3, span + 16):
        ones = torch.full((n_poly,), 0xFF, dtype=torch.uint8, device=dev)
        got = CC.poly1305_tag(adversarial, ones)
        errors["poly1305"] = max(errors["poly1305"], byte_err(got, CC.poly1305_plain(adversarial, ones)),
                                 byte_err(got, CC.poly1305_ref(adversarial, b"\xff" * n_poly)))
        poly_checks += 1
    rfc_tag = CC.poly1305_tag(bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b"),
                              torch.tensor(list(b"Cryptographic Forum Research Group"), dtype=torch.uint8, device=dev))
    if rfc_tag != bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9"):
        raise AssertionError(f"Poly1305 of the RFC 8439 §2.5.2 message: {rfc_tag.hex()}")
    del cc_buf
    # SHA-256: the boundary lengths with 0xAB junk past them at every bucket
    # width of the hash suite (64, 256, 1,024, 4,096 and the catch bucket's,
    # here 4,160 with a token of 4,100 B) and at a 4-byte width, and every
    # hash layout above (tokens of 0..130 B, and 600 of 1..5,000 B in the
    # suite's buckets), against the plain version and hashlib.
    sha_checks = sha_oracle = 0
    boundary = [0, 55, 56, 63, 64, 65, 119, 120, 128, 129, 191, 192]
    sha_sets = []
    for width in (4, 64, 256, 1024, 4096, 4160):
        tokens = [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in boundary + [width - 60, width] if 0 <= k <= width]
        rows = np.full((len(tokens), width), 0xAB, np.uint8)
        for i, t in enumerate(tokens):
            rows[i, : len(t)] = np.frombuffer(t, np.uint8)
        sha_sets.append((tokens, T.PaddedTokens.from_numpy(rows, [len(t) for t in tokens], device=dev)))
    sha_sets.append((sweep, layouts[0]))
    sha_sets.append((sweep, layouts[1]))
    # Every length 0..min(130, width) with junk past it, in rows of 4, 16,
    # 64, 128 and 4,160 B, 16-byte aligned and at a 4-byte offset (the
    # rows' 4-byte path): both layouts against one plain pass and hashlib.
    for width in (4, 16, 64, 128, 4160):
        tokens, aligned, shifted = sha_rows(width, rng, dev)
        want = SHA.sha256_plain(aligned)
        for padded in (aligned, shifted):
            got = SHA.sha256_cuda(padded)
            errors["sha256"] = max(errors["sha256"], max_err(got, want))
            for i, digest in enumerate(SHA.digest_bytes(got)):
                if digest.tobytes() != hashlib.sha256(tokens[i]).digest():
                    raise AssertionError(f"SHA-256 of a {len(tokens[i])}-byte token in rows of {width} "
                                         f"(data at {padded.data.data_ptr() % 16} mod 16) differs from hashlib")
                sha_oracle += 1
            sha_checks += 1
    for tokens, padded in sha_sets:
        got = SHA.sha256_cuda(padded)
        errors["sha256"] = max(errors["sha256"], max_err(got, SHA.sha256_plain(padded)))
        for i, digest in enumerate(SHA.digest_bytes(got)):
            if digest.tobytes() != hashlib.sha256(tokens[i]).digest():
                raise AssertionError(f"SHA-256 of a {len(tokens[i])}-byte token in rows of {padded.width} differs from hashlib")
            sha_oracle += 1
        sha_checks += 1
    for padded in layouts[2:]:
        errors["sha256"] = max(errors["sha256"], max_err(SHA.sha256_cuda(padded), SHA.sha256_plain(padded)))
        sha_checks += 1
    # Threefry: the pinned JAX words, and 32 Mi words against the plain version.
    for seed, (count, at, words) in THREEFRY_PINS.items():
        got = M.threefry_bits_cuda(seed, count, dev)
        errors["threefry"] = max(errors["threefry"], max_err(got, M.threefry_bits_plain(seed, count, dev)))
        if got[at : at + len(words)].tolist() != list(words):
            raise AssertionError(f"Threefry words of seed {seed} at {at} differ from the pinned jax.random.bits")
    errors["threefry"] = max(errors["threefry"], max_err(M.threefry_bits_cuda(5, 32 << 20, dev), M.threefry_bits_plain(5, 32 << 20, dev)))
    advanced = {k: v - before[k] for k, v in launches().items()}
    if any(errors.values()) or not all(advanced.values()):
        raise AssertionError(f"kernels disagree with their plain versions or did not launch: {errors}, {advanced}")
    phase(
        "kernels",
        f"equal to plain on the card ({checked} needle scans (the worst case's {WORST_NEEDLES} needles a * k "
        f"held to its closed form), 3 sets, 4 bytesums, {len(layouts)} hash layouts x "
        f"{len(seed_sets)} seed sets, {tree_levels} tree levels (base offsets 0..15), {fp_checked} fingerprint batches (ndim {FP_NDIMS}, counts and "
        f"none), 4 LUT views, 4 DP batches of "
        f"{len(pair_lens)} to 40,000 pairs at nbits {dp_nbits}, {myers_edge_checks} Myers batches at the edges of its "
        f"lane groups and bands (|a|, |b| in {MYERS_EDGES}, groups of 1 to 32 lanes, three bands), {mp_checked} multi-pattern counts in the DFA regimes "
        f"{sorted(regimes_seen)} and Shift-And over 6 MB); XXH64('') and XXH32('') match the published digests; "
        f"{oracle_checked} DP pairs equal levenshtein_ref, nw_ref and sw_ref; alignment batches at the edges of "
        f"the kernel's lane groups and strips, (pairs, longest a, (lanes, rows)): {align_shapes}; "
        f"{mp_oracle} small multi-pattern cases "
        f"equal brute force; find, rfind, Shift-And and Aho-Corasick on {unaligned_checked} unaligned 64 MB views "
        f"(offsets 1..15) equal the plain version; class maps over 8 segmentation tables, pruned and whole, and two "
        f"int32 tables; {scan_checks} fused scans of the kinds {SCAN_KINDS} up to {scan_n:,} positions, "
        f"{program_checks} of the 8 segmentation programs on random streams of 1 to {4 << 20:,} positions; the UAX#14 "
        f"rules over {lb_n:,} random positions covering every pair of classes; {expand_checks} expand-and-compact "
        f"batches (UTF-8 rows of 32 and 64, naughty and random bytes, codepoint rows under 3 tables, max_exp 1..4); "
        f"range maps of {len(fold_rules)} fold rule sets and a fully pruned one; {window_checks} window counts at "
        f"m = 1, 8, 129, 300; {bpe_checks} BPE batches in the table regimes {sorted(bpe_regimes)} (512 and 30,000 "
        f"merges; the JAX tests' cases, widths 1..32), {bpe_oracle} rows equal bpe_encode_ref, {bpe_edge_checks} at the "
        f"edges of the lane groups and hashed tables (mixed chunks, shuffled rows, a redrawn table); {cc_checks} ChaCha20 "
        f"streams (counters 0, 1, 0xFFFFFFF0; offsets 1..15), {cc_edge_checks} at the tiles' and the ring's edges "
        f"(wraps inside tiles, offsets 1..16), and the RFC 8439 §2.4.2 vector; {poly_checks} Poly1305 "
        f"tags, {poly_oracle} equal poly1305_ref, {poly_edge_checks} at the edges of its groups, spans and grid (raw "
        f"and AEAD), the RFC vector; {sha_checks} SHA-256 batches, {sha_oracle} digests equal "
        f"hashlib; Threefry equal to the pinned jax.random.bits; launches {advanced}",
        started,
    )

    # -- 4. the main path -----------------------------------------------------
    main_launches = {name: 0 for name in names}

    def path(expect: list[str], body) -> None:
        reset(*counters)
        body()
        torch.cuda.synchronize()
        counts = launches()
        missing = [k for k in expect if not counts[k]]
        if missing:
            raise AssertionError(f"kernels of the path never launched: {missing}: {counts}")
        for k, v in counts.items():
            main_launches[k] += v

    def find_path() -> None:
        started = time.perf_counter()
        ctx, _ = run_suite(
            find_suite.main,
            ["--dataset-limit", "64mb", "--warmup", "0.25", "--time-limit", "1"],
            [
                "substring-forward/swtorch::find_count<1gpu>",
                "substring-backward/swtorch::rfind_count<1gpu>",
                "byteset-forward/swtorch::byteset_count<1gpu>",
                "byteset-forward/swtorch::aho_corasick<1gpu>",
            ],
        )
        if ctx.tape.device.type != "cuda" or ctx.tape.total_bytes < 48 << 20:
            raise AssertionError(f"the find suite ran on {ctx.tape.device} over {ctx.tape.total_bytes} bytes")
        routine, results = find_suite.forward_routine(ctx.tape)
        routine()
        _, panel, _ = find_suite.suite_needles(ctx.tape)
        hay_b = ctx.tape.data.cpu().numpy().tobytes()
        for needle in panel[:8]:
            count, pos = 0, hay_b.find(needle)
            while pos >= 0:
                count += 1
                pos = hay_b.find(needle, pos + 1)
            if results[needle] != count:
                raise AssertionError(f"forward count of {needle!r}: suite {results[needle]}, bytes.find loop {count}")
        ac_routine, ac_results = find_suite.aho_corasick_routine(ctx.tape)
        ac_routine()
        set_routine, set_results = find_suite.byteset_routine(ctx.tape)
        set_routine()
        if ac_results != set_results:
            raise AssertionError(f"aho_corasick row counts {ac_results} differ from the byteset_count row's {set_results}")
        suite_tape.append(ctx.tape)
        phase(
            "main path",
            f"find suite: {ctx.tape.total_bytes:,} B of {ctx.tape.count:,} words on {ctx.tape.device}; first 8 "
            f"forward counts {[results[t] for t in panel[:8]]} equal the bytes.find loop; aho_corasick counts "
            f"{ac_results} equal the byteset_count row's; launches {launches()}",
            started,
        )

    def multipattern_path() -> None:
        started = time.perf_counter()
        tape = suite_tape[0]
        hay, n = tape.data, tape.total_bytes
        dictionary = AC.Automaton(list(dict.fromkeys(tape.subtape(0, 20000).to_list()))[:1000])
        four, eight = mp_sets["4words"], mp_sets["8words"]
        got = {
            "dictionary": AC.ac_count(dictionary, hay, n),
            "4words-dfa": AC.ac_count(AC.Automaton(four), hay, n),
            "4words-shiftand": SA.shiftand_count(SA.ShiftAndSet(four), hay, n),
            "8words-dfa": AC.ac_count(AC.Automaton(eight), hay, n),
            "8words-shiftand": SA.shiftand_count(SA.ShiftAndSet(eight), hay, n),
        }
        plain = int(AC.ac_count_plain(dictionary, hay, n).item())
        if got["dictionary"] != plain or got["4words-dfa"] != got["4words-shiftand"] or got["8words-dfa"] != got["8words-shiftand"]:
            raise AssertionError(f"multi-pattern counts disagree: {got}, dictionary plain {plain}")
        phase(
            "main path",
            f"ac_count / shiftand_count on the find suite's {n:,} B: {got} ({dictionary.states} DFA states in the "
            f"{ACC.regime_of(dictionary)} regime, equal to the plain version; the DFA and Shift-And counts agree); "
            f"launches {launches()}",
            started,
        )

    def hash_path() -> None:
        started = time.perf_counter()
        ctx, _ = run_suite(
            hash_suite.main,
            ["--dataset-limit", "128mb", "--warmup", "0.25", "--time-limit", "1"],
            [f"stateless/swtorch::{op}<1gpu>" for op in ("swh64", "xxh64", "xxh32", "swh64_multiseed8")]
            + ["stateful/swtorch::tree_hash64<1gpu>", "checksum/swtorch::bytesum<1gpu>", "checksum/swtorch::sha256<1gpu>"],
        )
        suite_launches = launches()  # the suite's own run: the checks below launch the kernels again
        if ctx.tape.device.type != "cuda" or ctx.tape.total_bytes < 100 << 20:
            raise AssertionError(f"the hash suite ran on {ctx.tape.device} over {ctx.tape.total_bytes} bytes")
        idx, digests = ctx.staged.digests(H.swh64)
        first = ctx.tape.subtape(0, 8).to_list()
        want = [H.swh64_ref(t) for t in first]
        if list(idx[:8]) != list(range(8)) or [int(d) for d in digests[:8]] != want:
            raise AssertionError(f"swh64 of the first 8 tokens: suite {digests[:8]}, swh64_ref {want}")
        # SHA-256: every digest of every bucket against the plain version on
        # the card, and 10,000 seeded tokens against hashlib.
        for padded in ctx.staged.buckets:
            err = max_err(SHA.sha256_cuda(padded), SHA.sha256_plain(padded))
            errors["sha256"] = max(errors["sha256"], err)
            if err:
                raise AssertionError(f"SHA-256 of the {padded.count:,} tokens of width {padded.width} differ from the plain version")
        idx, digests = ctx.staged.digests(SHA.sha256)
        sample = np.random.default_rng(19).choice(idx.size, 10_000, replace=False)
        offsets, data = ctx.tape.offsets.cpu().numpy(), ctx.tape.data.cpu().numpy()
        got = SHA.digest_bytes(torch.from_numpy(digests[sample]))
        for row, i in enumerate(idx[sample].tolist()):
            if got[row].tobytes() != hashlib.sha256(data[offsets[i] : offsets[i + 1]].tobytes()).digest():
                raise AssertionError(f"SHA-256 of token {i} differs from hashlib")
        for counter in counters:
            counter.update({k: suite_launches[k] for k in counter})
        hash_keep.update(buckets=ctx.staged, tape=ctx.tape)
        phase(
            "main path",
            f"hash suite: {ctx.staged.tokens:,} tokens, {ctx.staged.token_bytes:,} B in "
            f"{len(ctx.staged.buckets)} buckets on {ctx.tape.device}; first 8 swh64 digests equal swh64_ref; every "
            f"SHA-256 digest equals the plain version on the card, 10,000 sampled tokens hashlib; launches of the "
            f"suite's run {launches()}",
            started,
        )

    def fingerprints_path() -> None:
        started = time.perf_counter()
        scales = fp_suite.ndim_scales()
        ctx, _ = run_suite(
            fp_suite.main,
            ["--dataset-limit", "16mb", "--warmup", "0.25", "--time-limit", "1"],
            [f"minhash/ndim_{d}/swtorch::fingerprint<1gpu>" for d in scales],
        )
        tokens = ctx.staged["tokens"]
        if tokens.device.type != "cuda":
            raise AssertionError(f"the fingerprints suite ran on {tokens.device}")
        docs = ctx.tape.subtape(0, 4).to_list()
        for i, doc in enumerate(docs):
            want, _ = FP.fingerprint_ref(doc[: fp_suite.MAX_WIDTH], ndim=scales[0])
            if not np.array_equal(ctx.staged["min_hashes"][scales[0]][i], want):
                raise AssertionError(f"min-hashes of document {i} differ from the numpy spec replay")
        quality = {d: tuple(round(q, 4) for q in ctx.staged["quality"][d]) for d in scales}
        fp_keep["tokens"] = tokens
        phase(
            "main path",
            f"fingerprints suite: {tokens.count} documents of width {tokens.width} on {tokens.device}; first "
            f"{len(docs)} documents equal the spec replay at ndim {scales[0]}; quality (bit entropy, collision "
            f"rate) {quality}; launches {launches()}",
            started,
        )

    def entry_path() -> None:
        started = time.perf_counter()
        forward, args = entry.entry("cuda")
        if any(a.device.type != "cuda" for a in args):
            raise AssertionError("entry('cuda') did not place its inputs on the card")
        got = forward(*args)
        torch.cuda.synchronize()
        reference = forward(*(a.cpu() for a in args))
        for key, value in reference.items():
            if max_err(got[key].cpu(), value):
                raise AssertionError(f"entry forward on the card differs from the CPU in {key}")
        phase(
            "main path",
            f"entry('cuda') forward equals the CPU forward (digest_checksum {int(got['digest_checksum'])}, "
            f"minhash {tuple(got['minhash'].shape)}, translated {tuple(got['translated'].shape)}); "
            f"launches {launches()}",
            started,
        )

    def similarities_path() -> None:
        started = time.perf_counter()
        band = 16
        os.environ["SWTPU_ERROR_BOUND"] = str(band)  # the banded row runs only when it is set
        try:
            ctx, _ = run_suite(
                sim_suite.main,
                ["--warmup", "0.25", "--time-limit", "1"],
                [
                    "uniform/swtorch::levenshtein<1gpu>",
                    "uniform-utf8/swtorch::levenshtein<1gpu>",
                    f"uniform-banded{band}/swtorch::levenshtein<1gpu>",
                    "uniform/python-dp-diagonal",
                ]
                + [f"{group}/swtorch::{fn}<1gpu>" for group, fn, *_ in sim_suite.ALIGNMENTS],
            )
        finally:
            os.environ.pop("SWTPU_ERROR_BOUND")
        staged = ctx.staged
        if staged["batch"].device.type != "cuda":
            raise AssertionError(f"the similarities suite ran on {staged['batch'].device}")
        sim_keep["batch"] = staged["batch"]
        pairs = list(zip(staged["pairs_a"][:8], staged["pairs_b"][:8]))
        oracles = {
            "levenshtein": [S.levenshtein_ref(x, y) for x, y in pairs],
            "levenshtein_utf8": [S.levenshtein_ref(S.decode_codepoints(x), S.decode_codepoints(y)) for x, y in pairs],
            "levenshtein_banded": [levenshtein_banded_ref(x, y, band) for x, y in pairs],
        }
        for group, fn, go, ge, local in sim_suite.ALIGNMENTS:
            ref = S.sw_ref if local else S.nw_ref
            oracles[f"{'sw' if local else 'nw'}_{group}"] = [ref(x, y, 2, -1, go, ge) for x, y in pairs]
        for key, want in oracles.items():
            got = [int(v) for v in staged["scores"][key][:8]]
            if got != want:
                raise AssertionError(f"{key} of the first 8 pairs: suite {got}, oracle {want}")
        # Every score of each kernel row against the plain version on the
        # suite's own pairs, staged as the suite stages them.
        batch, pairs_a, pairs_b = staged["batch"], staged["pairs_a"], staged["pairs_b"]
        by_bytes = MY.myers_from_tokens(pairs_a, pairs_b, device=dev)
        by_cps = MY.myers_from_codepoints(
            [S.decode_codepoints(t) for t in pairs_a], [S.decode_codepoints(t) for t in pairs_b], device=dev
        )
        plain = {"levenshtein": ("myers", MY.myers_plain(by_bytes)), "levenshtein_utf8": ("myers", MY.myers_plain(by_cps))}
        for group, _, go, ge, local in sim_suite.ALIGNMENTS:
            want = S._score_scan(batch, sim_suite.MATCH, sim_suite.MISMATCH, go, ge, local=local)
            plain[f"{'sw' if local else 'nw'}_{group}"] = (group, want)
        for key, (kernel, want) in plain.items():
            err = max_err(torch.from_numpy(staged["scores"][key]), want.cpu())
            errors[kernel] = max(errors[kernel], err)
            if err:
                raise AssertionError(f"{key}: the suite's scores differ from the plain version by {err}")
        sim_keep["myers"] = {"uniform": by_bytes, "uniform-utf8": by_cps}
        phase(
            "main path",
            f"similarities suite: {batch.a.shape[0]:,} pairs of width {batch.width} ({batch.dp_cells():,} cells) on "
            f"{batch.device}; the first 8 scores of each of the {len(oracles)} rows equal the brute-force oracles; "
            f"all {batch.a.shape[0]:,} scores of each of the {len(plain)} kernel rows equal the plain versions "
            f"(Myers at nbits {by_bytes.nbits} and {by_cps.nbits}); launches {launches()}",
            started,
        )

    def tokenization_path() -> None:
        started = time.perf_counter()
        raw = wait_corpus()
        synthesized = time.perf_counter() - started
        ctx, _ = run_suite(
            tok_suite.main,
            ["--dataset", str(corpus), "--filter", "swtorch::", "--warmup", "0.25", "--time-limit", "1"],
            [f"{row}<1gpu>" for row in TOKENIZATION_ROWS],
        )
        suite_launches = launches()  # the suite's own run: the checks below launch class_map again
        staged = ctx.staged
        data, n, mcp = staged["data"], staged["n"], staged["max_cp"]
        if data.device.type != "cuda" or n != len(raw) or n < CORPUS_BYTES - 16:
            raise AssertionError(f"the tokenization suite ran on {data.device} over {n} bytes")
        counts = {row.split("<")[0]: value for row, value in staged["counts"].items()}
        text = raw.decode()
        lead = (np.frombuffer(raw, np.uint8) & 0xC0) != 0x80
        newlines = sum(text.count(c) for c in "\n\x0b\x0c\r\x85\u2028\u2029") - text.count("\r\n") + 1
        plain = {
            "tokenize-whitespace/swtorch::split": SEG.whitespace_token_count(data, n, max_cp=mcp, scanline=False),
            "tokenize-newlines/swtorch::split": newlines,
            "tokenize-words-tr29/swtorch::words": SEG.word_boundaries(data, n, max_cp=mcp, scanline=False)[1],
            "tokenize-graphemes-tr29/swtorch::graphemes": SEG.grapheme_boundaries(data, n, max_cp=mcp, scanline=False)[1],
            "tokenize-sentences-tr29/swtorch::sentences": SEG.sentence_boundaries(data, n, max_cp=mcp, scanline=False)[1],
            "tokenize-lines-uax14/swtorch::linebreaks": SEG.linebreak_opportunities(data, n, max_cp=mcp, scanline=False)[1],
            "utf8-length/swtorch::count_utf8": len(text),
            "utf8-iterate/swtorch::decode_utf32": len(text),
            "find-nth-utf8/swtorch::find_nth": int(np.flatnonzero(lead)[-1]),
        }
        plain = {row: int(value) for row, value in plain.items()}
        # Every segmentation program on the corpus's own streams: each
        # fused_scan call of the five functions (one launch of the scan
        # kernel, its builds inside) against the plain executor on the card.
        programs_seen = []

        def held(inputs, ops, n_scan, *, reverse=False, outputs=None):
            got = SL.fused_scan(inputs, ops, n_scan, reverse=reverse, outputs=outputs)
            want = SL.fused_scan_plain(inputs, ops, n_scan, reverse=reverse, outputs=outputs)
            for key in want:
                errors["fused_scan"] = max(errors["fused_scan"], max_err(got[key], want[key]))
            programs_seen.append(len(ops))
            return got

        SEG.fused_scan = held
        try:
            for fn in (SEG.whitespace_token_count, SEG.grapheme_boundaries, SEG.word_boundaries,
                       SEG.sentence_boundaries, SEG.linebreak_opportunities):
                fn(data, n, max_cp=mcp)
        finally:
            SEG.fused_scan = SL.fused_scan
        if errors["fused_scan"] or len(programs_seen) != 8:
            raise AssertionError(f"scan programs on the corpus: {len(programs_seen)} calls, error {errors['fused_scan']}")
        torch.cuda.empty_cache()
        for counter in counters:
            counter.update({k: suite_launches[k] for k in counter})
        if counts != plain or counts["tokenize-whitespace/swtorch::split"] != len(text.split()):
            raise AssertionError(f"tokenization counts {counts} differ from the plain route / host {plain}")
        # BPE: the row's last ids and counts over all its rows against the
        # plain version on the card, and 2,000 seeded rows against the host
        # oracle.
        bpe = staged["bpe"]
        ids, bpe_counts, pretokens = bpe["ids"], bpe["counts"], bpe["pretokens"]
        if bpe["data"].device.type != "cuda" or ids.shape != bpe["data"].shape or len(pretokens) != tok_suite.BPE_ROWS:
            raise AssertionError(f"the BPE row ran on {bpe['data'].device}: ids {tuple(ids.shape)}, {len(pretokens)} pretokens")
        want = BPE.bpe_encode_plain(bpe["data"], bpe["lengths"], bpe["table"])
        bpe_err = max(max_err(ids, want[0]), max_err(bpe_counts, want[1]))
        errors["bpe"] = max(errors["bpe"], bpe_err)
        if bpe_err:
            raise AssertionError(f"the BPE row's ids differ from bpe_encode_plain by {bpe_err}")
        sample = np.random.default_rng(16).choice(len(pretokens), 2000, replace=False)
        ids_h, counts_h = ids.cpu().numpy(), bpe_counts.cpu().numpy()
        for r in sample.tolist():
            if ids_h[r, : counts_h[r]].tolist() != BPE.bpe_encode_ref(pretokens[r], bpe["merges"]):
                raise AssertionError(f"BPE row {r} ({pretokens[r]!r}) differs from bpe_encode_ref")
        tok_keep.update(bpe=bpe, text=text)
        phase(
            "bpe staging",
            f"{len(pretokens):,} pretokens ({int(bpe['lengths'].sum()):,} B, width {ids.shape[1]}) of the first "
            f"{tok_suite.BPE_CHARS:,} characters: pre-split {bpe['seconds']['pre-split']:.3f} s, "
            f"{len(bpe['merges'])} merges trained in {bpe['seconds']['train']:.3f} s",
        )
        del ctx, staged, data, text, want
        phase(
            "main path",
            f"tokenization suite: {n:,} B of synthetic:multilingual (max_cp {mcp:#x}; synthesized by the child process, "
            f"waited {synthesized:.1f} s) on {dev}; every segmentation count equals the plain feature route on the card, "
            f"the whitespace count len(text.split()), the newline count the host's, the UTF-8 counts len(decode()): {counts}; "
            f"the 8 scan programs ({programs_seen} ops) on the corpus's streams equal the plain executor on the card; "
            f"BPE ids of all {len(pretokens):,} rows ({int(counts_h.sum()):,} ids) equal bpe_encode_plain on the card, "
            f"2,000 sampled rows bpe_encode_ref; launches of the suite's run {launches()}",
            started,
        )

    def normalization_path() -> None:
        started = time.perf_counter()
        raw = wait_corpus()
        ctx, _ = run_suite(
            norm_suite.main,
            ["--dataset", str(corpus), "--filter", "swtorch::", "--warmup", "0.25", "--time-limit", "1"],
            [f"{row}<1gpu>" for row in NORMALIZATION_ROWS],
        )
        suite_launches = launches()  # the suite's own run: the checks below launch the kernels again
        ran = time.perf_counter()
        staged = ctx.staged
        rows, mcp = staged["rows"], staged["max_cp"]
        if rows.data.device.type != "cuda" or staged["n"] != len(raw) or staged["n"] < CORPUS_BYTES - 16:
            raise AssertionError(f"the normalization suite ran on {rows.data.device} over {staged['n']} bytes")
        text = raw.decode()
        folded_text = text.casefold()
        if mcp != ord(max(text)):
            raise AssertionError(f"codepoint ceiling {mcp:#x}, host {ord(max(text)):#x}")
        # Fold: the whole output against the plain version on the card, the
        # total against str.casefold, and 10,000 seeded rows decoded.
        out, counts = staged["fold"]
        max_exp = CF._fold_rules(mcp)[4]
        want = EX.expand_compact_rows_plain(rows.data, rows.lengths, EX.fold_tables(mcp), max_exp, 32, True)
        fold_err = max(max_err(out, want[0]), max_err(counts, want[1]))
        errors["expand"] = max(errors["expand"], fold_err)
        if fold_err or int(counts.sum()) != len(folded_text):
            raise AssertionError(f"fold: {fold_err} from the plain version; {int(counts.sum())} codepoints against "
                                 f"len(text.casefold()) {len(folded_text)}")
        sample = np.random.default_rng(14).choice(rows.count, 10_000, replace=False)
        idx = torch.from_numpy(sample).to(dev)
        s_rows, s_lens = rows.data[idx].cpu().numpy(), rows.lengths[idx].cpu().numpy()
        s_out, s_counts = out[idx].cpu().numpy(), counts[idx].cpu().numpy()
        for r in range(sample.size):
            if "".join(map(chr, s_out[r, : s_counts[r]])) != s_rows[r, : s_lens[r]].tobytes().decode().casefold():
                raise AssertionError(f"fold of row {int(sample[r])} differs from str.casefold")
        # Compare: the booleans against the host; both fold_tokens matrices
        # (range-map kernel) against the same function on the CPU, whose
        # range_map is the plain rule walk.
        pairs, equal = staged["pairs"], staged["equal"].cpu()
        host_equal = torch.tensor([a.decode().casefold() == b.decode().casefold() for a, b in pairs])
        if not torch.equal(equal, host_equal):
            raise AssertionError("uncased_eq booleans differ from the host's casefold-eq")
        for side in staged["compare_rows"]:
            got, got_counts = CF.fold_tokens(side)
            want, want_counts = CF.fold_tokens(side.to("cpu"))
            err = max(max_err(got.cpu(), want), max_err(got_counts.cpu(), want_counts))
            errors["range_map"] = max(errors["range_map"], err)
            if err:
                raise AssertionError(f"fold_tokens with the range-map kernel differs from the rule walk by {err}")
        # Find: the folded haystack is text.casefold(); each needle's count
        # equals the plain window count on the card and a host count of
        # overlapping matches in the folded text.
        hay = staged["haystack"]
        if not np.array_equal(hay.cpu().numpy(), np.frombuffer(folded_text.encode("utf-32-le"), np.int32)):
            raise AssertionError("the folded haystack differs from text.casefold()")
        host_counts = []
        for nd in staged["needles"]:
            needle_text, count = "".join(map(chr, nd.tolist())), 0
            pos = folded_text.find(needle_text)
            while pos >= 0:
                count, pos = count + 1, folded_text.find(needle_text, pos + 1)
            host_counts.append(count)
            got = FC.cp_window_count(hay, hay.numel(), nd)
            errors["cp_window"] = max(errors["cp_window"], max_err(got, F.cp_window_count_plain(hay, hay.numel(), nd)))
        if staged["needle_counts"] != host_counts or errors["cp_window"]:
            raise AssertionError(f"needle counts {staged['needle_counts']} differ from the host's {host_counts} or the plain version")
        for counter in counters:
            counter.update({k: suite_launches[k] for k in counter})
        norm_keep.update(rows=rows, max_cp=mcp, max_exp=max_exp, haystack=hay, needles=staged["needles"],
                         compare_rows=staged["compare_rows"])
        n_text, n_folded = len(text), len(folded_text)
        del ctx, staged, text, folded_text, out, counts, want
        phase(
            "main path",
            f"normalization suite: {len(raw):,} B of synthetic:multilingual in {rows.count:,} rows of 32 B (max_cp "
            f"{mcp:#x}, max_exp {max_exp}) on {dev}, suite run {ran - started:.1f} s; the fold equals the plain version "
            f"on the card, its {n_folded:,} codepoints (from {n_text:,}) len(text.casefold()), 10,000 sampled rows "
            f"str.casefold; {int(equal.sum())} of {len(pairs)} line pairs equal, as on the host, and both fold_tokens "
            f"matrices equal the rule walk; {len(host_counts)} needle counts {host_counts[:12]}... equal the plain "
            f"window count and the host's overlapping count over {hay.numel():,} folded codepoints; launches of the "
            f"suite's run {launches()}",
            started,
        )

    def encryption_path() -> None:
        started = time.perf_counter()
        ctx, _ = run_suite(
            enc_suite.main,
            ["--dataset-limit", "128mb", "--warmup", "0.25", "--time-limit", "1"],
            [f"{group}/swtorch::{row}<1gpu>" for group, row in ENCRYPTION_ROWS],
        )
        suite_launches = launches()  # the suite's own run: the checks below launch the kernels again
        staged, key = ctx.staged, enc_suite.KEY
        corpus = staged["corpus"]
        if corpus.device.type != "cuda" or corpus.numel() < 100 << 20:
            raise AssertionError(f"the encryption suite ran on {corpus.device} over {corpus.numel()} bytes")
        # The corpus seals against the plain versions on the card; the
        # decryption rows' plaintexts against the corpus.
        for label, nonce_len, _, _ in enc_suite.device_ciphers():
            nonce, ct, tag = staged["sealed"][label]
            sub, sub_nonce = (key, nonce) if nonce_len == 12 else CC._xchacha_subkey(key, nonce)
            want_ct, want_tag = CC.aead_encrypt_plain(sub, sub_nonce, corpus)
            err = max(max_err(ct, want_ct), byte_err(tag, want_tag))
            errors["chacha20_xor"] = max(errors["chacha20_xor"], max_err(ct, want_ct))
            errors["poly1305"] = max(errors["poly1305"], byte_err(tag, want_tag))
            if err or not torch.equal(staged["opened"][label], corpus):
                raise AssertionError(f"{label}: the corpus seal differs from the plain version ({err}) or does not open to the corpus")
        # The 64 per-token seals of each cipher against aead_ref; the XChaCha
        # draft vector; a flipped tag bit must not open.
        sample = staged["sample"]
        for label, nonce_len, _, _ in enc_suite.device_ciphers():
            seals = staged["seals"][label]
            if len(seals) != len(sample):
                raise AssertionError(f"{label}: {len(seals)} per-token seals for {len(sample)} tokens")
            for token, (nonce, ct, tag) in zip(sample, seals):
                sub, sub_nonce = (key, nonce) if nonce_len == 12 else CC._xchacha_subkey(key, nonce)
                if (ct.cpu().numpy().tobytes(), tag) != CC.aead_ref(sub, sub_nonce, token):
                    raise AssertionError(f"{label}: the seal of a {len(token)}-byte token differs from aead_ref")
        draft_ct, draft_tag = CC.xchacha_aead_encrypt(
            bytes.fromhex("808182838485868788898a8b8c8d8e8f909192939495969798999a9b9c9d9e9f"),
            bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657"),
            torch.tensor(list(sunscreen), dtype=torch.uint8, device=dev), bytes.fromhex("50515253c0c1c2c3c4c5c6c7"))
        if draft_ct.cpu().numpy().tobytes().hex()[:32] != "bd6d179d3e83d43b9576579493c0e939" or \
                draft_tag != bytes.fromhex("c0875924c1c7987947deafd8780acf49"):
            raise AssertionError("XChaCha20-Poly1305 of the draft's §A.3 inputs differs from its vector")
        nonce, ct, tag = staged["sealed"]["chacha20poly1305"]
        try:
            CC.aead_decrypt(key, nonce, ct, bytes([tag[0] ^ 1]) + tag[1:])
        except ValueError:
            pass
        else:
            raise AssertionError("a tampered tag opened")
        for counter in counters:
            counter.update({k: suite_launches[k] for k in counter})
        enc_keep.update(corpus=corpus, sealed=staged["sealed"]["chacha20poly1305"], sample=sample)
        phase(
            "main path",
            f"encryption suite: {corpus.numel():,} B of synthetic:long-lines on {corpus.device}; both corpus seals "
            f"(ciphertext and tag) equal the plain versions on the card and open to the corpus; {len(sample)} per-token "
            f"seals of each cipher equal aead_ref; the XChaCha draft vector; a tampered tag is refused; launches of the "
            f"suite's run {launches()}",
            started,
        )

    suite_tape: list = []  # the find suite's tape, for the multi-pattern path and the rows phase
    fp_keep: dict = {}  # the fingerprints suite's batch, for the rows phase
    norm_keep: dict = {}  # the normalization suite's rows, haystack and needles, for the rows phase
    tok_keep: dict = {}  # the tokenization suite's BPE batch and decoded text, for the rows phase
    sim_keep: dict = {}  # the similarities suite's pairs, for the rows phase
    hash_keep: dict = {}  # the hash suite's buckets, for the rows phase
    enc_keep: dict = {}  # the encryption suite's corpus and its seal, for the rows phase
    path(["find_count", "rfind_count", "byteset_count", "bytesum", "shiftand"], find_path)
    path(["ac_dfa", "shiftand"], multipattern_path)
    path(["xxh64", "xxh64_tree", "swh64", "xxh32", "bytesum", "sha256"], hash_path)
    path(["fingerprint"], fingerprints_path)
    path(["xxh64", "fingerprint", "lut_translate"], entry_path)
    path(["myers", "affine", "linear"], similarities_path)
    path(["class_map", "fused_scan", "lb_rules", "bpe"], tokenization_path)
    path(["expand", "range_map", "cp_window"], normalization_path)
    path(["chacha20_xor", "poly1305", "threefry"], encryption_path)
    torch.cuda.empty_cache()

    # -- 5. rows: kernel beside plain, on the card ----------------------------
    started = time.perf_counter()
    timings: dict[str, dict] = {}

    row = make_row(timings)

    flat = lowercase(128 << 20, 0, dev)
    find_fingerprint_rows(row, dev, flat, worst, suite_tape.pop(), fp_keep.pop("tokens"), launches)
    del worst
    set_hay = random_bytes(128 << 20, 4, dev)
    table = F.pack_byteset(find_suite.BYTESETS["html"], dev)
    row(
        "byteset-128MB",
        lambda: FC.byteset_count(set_hay, table),
        lambda: F.byteset_count_plain(set_hay, table),
        set_hay.numel(),
        bound_ms(set_hay.numel(), set_hay.numel()),
        "byteset_count",
    )
    probe = random_bytes(256 << 20, 5, dev)
    row(
        "bytesum-256MB",
        lambda: B.bytesum_cuda(probe),
        lambda: B.bytesum_plain(probe),
        probe.numel(),
        bound_ms(probe.numel(), probe.numel() / 4),  # one dp4a per 4 bytes
        "bytesum",
        library=lambda: torch.sum(probe, dtype=torch.int64),
    )
    del set_hay, probe

    # 131072 lines of 1 KiB, 1015 bytes each (tools/tpu_campaign.py:191-199).
    lines = T.PaddedTokens(
        random_bytes(131072 * 1024, 8, dev).view(131072, 1024),
        torch.full((131072,), 1024 - 9, dtype=torch.int32, device=dev),
        1024,
    )
    line_bytes = lines.count * (1024 - 9 + 4)  # each token's bytes and its length read once
    words = lines.count * (1024 - 9) / 4  # u32 words hashed
    # Per word and XXH32 lane: a multiply-add, a rotate, a multiply; swh64's
    # second lane XORs the word first. An XXH64 round on 8 bytes: a 64-bit
    # multiply-add (4), a 64-bit rotate (2), a 64-bit multiply (3).
    row(
        "swh64-1KB-lines-128MB",
        lambda: HC.swh64(lines, [0]),
        lambda: H.swh64_plain(lines, [0]),
        lines.data.numel(),
        bound_ms(line_bytes + 8 * lines.count, 7 * words),
        "swh64",
    )
    row(
        "xxh64-1KB-lines-128MB",
        lambda: HC.xxh64(lines, [0]),
        lambda: H.xxh64_plain(lines, [0]),
        lines.data.numel(),
        bound_ms(line_bytes + 8 * lines.count, 9 * words / 2),
        "xxh64",
    )
    row(
        "xxh32-1KB-lines-128MB",
        lambda: HC.xxh32(lines, [0]),
        lambda: H.xxh32_plain(lines, [0]),
        lines.data.numel(),
        bound_ms(line_bytes + 4 * lines.count, 3 * words),
        "xxh32",
    )
    row(
        "swh64-multiseed16-1KB-lines-128MB",
        lambda: HC.swh64(lines, list(range(16))),
        lambda: H.swh64_plain(lines, list(range(16))),
        lines.data.numel(),
        bound_ms(line_bytes + 16 * 8 * lines.count, (16 * 2 * 3 + 1) * words),
        plain_samples=1,
    )
    del lines
    row(
        "tree-hash64-level0-128MB",
        lambda: HC.tree_level(flat, flat.numel()),
        lambda: H.tree_level_plain(flat, flat.numel()),
        flat.numel(),
        bound_ms(flat.numel(), 9 * flat.numel() / 8),
        "xxh64_tree",
        plain_samples=1,
    )
    odd = flat[1:]  # the kernel's unaligned instance: each word two shared loads and a funnel shift
    row(
        "tree-hash64-level0-128MB-offset1",
        lambda: HC.tree_level(odd, odd.numel()),
        lambda: H.tree_level_plain(odd, odd.numel()),
        odd.numel(),
        bound_ms(odd.numel(), 9 * odd.numel() / 8),
        plain_samples=1,
    )
    del odd
    row(
        "lut-translate-128MB",
        lambda: M.lut_translate_cuda(flat, lut),
        lambda: M.lut_translate_plain(flat, lut),
        flat.numel(),
        bound_ms(2 * flat.numel(), flat.numel()),
        "lut_translate",
    )
    del flat

    # Multi-pattern counts at tools/tpu_campaign.py's shapes (:940-1006): 64 MB
    # of lowercase; the four-word set as a DFA (shared-memory table) and as
    # one Shift-And word, the eight-word set as two Shift-And words, and the
    # 1,000-word dictionary as a DFA (global table). Bound: one read of the
    # bytes, or the instructions the function needs per byte: the DFA 4
    # (extract the byte, form the index, load, add the count), Shift-And 2
    # (extract, load) + 6 per 32-bit state word (shift, or, and, the final
    # test, popcount, add). Each kernel is shorter than its wrapper's host
    # work, so ms is the profiler's device time of the kernel.
    ac_flat = lowercase(64 << 20, 0, dev)
    nb = ac_flat.numel()
    for name, auto, key in (
        ("ac-dfa-64MB", AC.Automaton(mp_sets["4words"]), "ac_dfa"),
        ("ac-dfa-1kwords-64MB", AC.Automaton(words_1k), None),
    ):
        row(f"{name} ({ACC.regime_of(auto)}, {auto.states} states)", lambda: ACC.ac_count(auto, ac_flat),
            lambda: AC.ac_count_plain(auto, ac_flat), nb, bound_ms(nb, 4 * nb), key, plain_samples=1, profiled="ac_kernel")
    for name, sa, key in (
        ("ac-shiftand-64MB", SA.ShiftAndSet(mp_sets["4words"]), "shiftand"),
        ("ac-shiftand8-64MB", SA.ShiftAndSet(mp_sets["8words"]), None),
    ):
        row(f"{name} ({sa.n_words}-word state)", lambda: SAC.shiftand_count(sa, ac_flat), lambda: SA.shiftand_count_plain(sa, ac_flat),
            nb, bound_ms(nb, (2 + 6 * sa.n_words) * nb), key, plain_samples=1, profiled="sa_kernel")
    del ac_flat

    # Edit distances and alignment scores at tools/tpu_campaign.py's shapes:
    # 65,536 pairs of 256 B (:557-607; the bytes 65..68 under the 9-plane
    # byte Eq, uncompressed), and 64 ACGT reads paired (i, 7i + 1), which
    # stage compressed (:1008-1035). Bound: the instructions of
    # myers_instructions or ALIGN_OPS per cell; bytes: every input read once.
    dp_rng = np.random.default_rng(0)
    pairs, width = 65536, 256
    ca = dp_rng.integers(65, 69, (pairs, width)).astype(np.int32)
    cb = dp_rng.integers(65, 69, (pairs, width)).astype(np.int32)
    full = np.full(pairs, width, np.int32)

    def myers_row(name, mb, key=None):
        in_bytes = mb.planes.numel() * 8 + mb.text.numel() * 4 + 12 * mb.count
        row(name, lambda: MYC.myers(mb), lambda: MY.myers_plain(mb), in_bytes,
            bound_ms(in_bytes, myers_instructions(mb)), key, plain_samples=1, cells=mb.cells())

    def align_row(name, ab, go, ge, local, key=None):
        in_bytes = (ab.pairs.a.numel() + ab.pairs.b.numel()) * 4 + 12 * ab.count
        per_cell = ALIGN_OPS[("linear" if go == ge else "affine", local)]
        row(name, lambda: AFC.align(ab, 2, -1, go, ge, local=local),
            lambda: S._score_scan(ab.pairs, 2, -1, go, ge, local=local), in_bytes,
            bound_ms(in_bytes, per_cell * ab.cells()), key, plain_samples=1, cells=ab.cells(),
            note=f", (lanes a pair, strip rows) {ab.shape()}")

    myers_row("lev-myers-64kx256B", MY.MyersBatch.from_arrays(ca, cb, full, full, nbits=MY.BYTE_BITS, device=dev), "myers")
    reads = [acgt[dp_rng.integers(0, 4, width)].tobytes() for _ in range(64)]
    myers_row(
        "lev-myers-dna-64kx256B",
        MY.myers_from_tokens([reads[i % 64] for i in range(pairs)], [reads[(i * 7 + 1) % 64] for i in range(pairs)], device=dev),
    )
    gotoh = AF.AffineBatch.from_pairs(S.PairBatch.from_numpy(ca, cb, full, full, device=dev))
    align_row("nw-affine-64kx256B", gotoh, -5, -1, False)
    align_row("sw-affine-64kx256B", gotoh, -5, -1, True)
    align_row("nw-linear-64kx256B", gotoh, -2, -2, False)
    del gotoh, ca, cb
    # The similarities suite's own batch (the main path's shape: 4,096 pairs
    # of synthetic:dna-100b lines), each body global and local: the rows
    # that the kernels line's affine and linear entries take.
    suite_pairs = AF.AffineBatch.from_pairs(sim_keep["batch"])
    align_row(f"nw-affine-suite-{suite_pairs.count}x100B", suite_pairs, -5, -1, False, "affine")
    align_row(f"sw-affine-suite-{suite_pairs.count}x100B", suite_pairs, -5, -1, True)
    align_row(f"nw-linear-suite-{suite_pairs.count}x100B", suite_pairs, -2, -2, False, "linear")
    align_row(f"sw-linear-suite-{suite_pairs.count}x100B", suite_pairs, -2, -2, True)
    # Rule 2's step 0: the similarities suite's calls as the suite makes
    # them, traced (device ms a launch beside the bound at this shape).
    for group, mb in sim_keep.pop("myers").items():
        in_bytes = mb.planes.numel() * 8 + mb.text.numel() * 4 + 12 * mb.count
        traced_call(f"levenshtein call (the similarities suite's {group}/swtorch::levenshtein, {mb.count:,} pairs, "
                    f"nbits {mb.nbits})", lambda mb=mb: MY.myers_distances(mb), launches, {"myers": "myers_lanes_kernel"},
                    bound_ms(in_bytes, myers_instructions(mb)))
    in_bytes = (suite_pairs.pairs.a.numel() + suite_pairs.pairs.b.numel()) * 4 + 12 * suite_pairs.count
    for group, go, ge in (("affine", -5, -1), ("linear", -2, -2)):
        traced_call(f"{group} needleman_wunsch call (the similarities suite's {group}/swtorch::needleman_wunsch)",
                    lambda go=go, ge=ge: AF.affine_scores(suite_pairs, sim_suite.MATCH, sim_suite.MISMATCH, go, ge, local=False),
                    launches, {group: "align_kernel"}, bound_ms(in_bytes, ALIGN_OPS[(group, False)] * suite_pairs.cells()))
    del suite_pairs

    # The reference's own H100 cell (BASELINE.md:52,55-57): 1 KB ACGT reads
    # (synthetic:dna lines) at its GPU batch, side = round(sqrt(132 SMs x
    # 256)) = 184 queries x 184 candidates (similarities/bench.rs:113-118,
    # 284-289).
    side = round(math.sqrt(132 * 256))
    dna_lines = T.Tape.from_buffer(datasets.synthesize("dna", (2 * side + 1) * 1024), "lines").to_list()
    queries, candidates = dna_lines[:side], dna_lines[side : 2 * side]
    pa = [q for q in queries for _ in candidates]
    pb = [c for _ in queries for c in candidates]
    myers_row(f"lev-myers-dna-1KB-{side}x{side}", MY.myers_from_tokens(pa, pb, device=dev))
    reads_1kb = AF.affine_from_tokens(pa, pb, device=dev)
    align_row(f"nw-affine-dna-1KB-{side}x{side}", reads_1kb, -5, -1, False)
    align_row(f"nw-linear-dna-1KB-{side}x{side}", reads_1kb, -2, -2, False)
    align_row(f"sw-linear-dna-1KB-{side}x{side}", reads_1kb, -2, -2, True)

    # Tokenization at the main path's shape: the 128 MB multilingual corpus.
    # Each segmentation function on its kernel route beside its plain
    # feature route (masks held equal; bound: one read of the text), with
    # its launches per call and its device time per call by kernel, by the
    # scan programs' builds (torch ops the TPU kernel runs inside its pass)
    # and by the other torch ops (the byte-space prelude, the input
    # streams, the rule functions other than UAX#14's and the counts: XLA
    # in JAX); the
    # UTF-8 rows; then each new kernel on the corpus's own streams, by
    # profiler device time, beside its bound: bytes it must move, each input
    # read once and each output written once.
    raw = corpus.read_bytes()
    text_n = len(raw)
    text = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
    del raw
    mcp = tok_suite._cp_ceiling(int(text.max()))
    new_kernels = {"class_map": "class_map_kernel", "fused_scan": "scan_", "lb_rules": "lb_rules_kernel"}
    # The scan programs each function runs, one launch each.
    scan_calls = {"whitespace": ["ws"], "graphemes": ["graph"], "words": ["fwd", "bwd"], "sentences": ["fwd", "bwd"],
                  "linebreaks": ["fwd", "bwd"]}
    for name, fn in (
        ("whitespace", SEG.whitespace_token_count),
        ("graphemes", SEG.grapheme_boundaries),
        ("words", SEG.word_boundaries),
        ("sentences", SEG.sentence_boundaries),
        ("linebreaks", SEG.linebreak_opportunities),
    ):
        call = lambda fn=fn: fn(text, text_n, max_cp=mcp)  # noqa: E731
        reset(LU.LAUNCHES, SLC.LAUNCHES)
        call()
        torch.cuda.synchronize()
        per_call = {k: v for k, v in {**LU.LAUNCHES, **SLC.LAUNCHES}.items() if v}
        split = device_breakdown(call, {k: v for k, v in new_kernels.items() if k in per_call})
        # The builds run inside the scan kernel: no build range, no torch op.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            call()
            torch.cuda.synchronize()
        if any(e.name == SL.BUILD_RANGE for e in prof.events()):
            raise AssertionError(f"tokenize-{name}: a build ran as torch ops ({SL.BUILD_RANGE}) on the card")
        if per_call.get("fused_scan", 0) != len(scan_calls[name]):
            raise AssertionError(f"tokenize-{name}: {per_call} launches, {len(scan_calls[name])} scan programs")
        if split is None:
            detail = f"not measured (no profiler trace in {TRACES} saw every kernel)"
        else:
            split["builds"] = 0.0
            split["other torch"] = split.pop("torch")
            detail = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        row(f"tokenize-{name}-128MB", call, lambda fn=fn: fn(text, text_n, max_cp=mcp, scanline=False), text_n,
            bound_ms(text_n), plain_samples=1, note=f"; launches per call {per_call}; device ms per call: {detail}")
    for name, call in (
        ("utf8-length", lambda: U8.utf8_count(text, text_n)),
        ("utf8-iterate", lambda: U8.utf8_decode(text, text_n)),
        ("find-nth-utf8", lambda: U8.utf8_find_nth(text, text_n, 12345)),
    ):
        ms = time_ms(call)
        phase("row", f"{name}-128MB: {ms:.4f} ms ({rate(ms, text_n, None)}), torch ops (no kernel of the port)")

    cps, lead, _ = SEG._byte_space(text, text_n)
    n_cp = cps.numel()
    for label, max_cp, key in (("pruned", mcp, "class_map"), ("whole", None, None)):
        table = SEG._class_table("grapheme_break_table", max_cp, dev)
        library, why = table_index(cps, table)
        row(f"class_map-128MB ({label}: {table.numel():,}-entry {table.dtype} table)",
            lambda table=table: LU.class_map_cuda(cps, table), lambda table=table: LU.class_map_plain(cps, table),
            4 * n_cp, bound_ms(8 * n_cp), key, profiled="class_map_kernel", library=library, note=why)
    cls = SEG._lead_cls(cps, lead, "grapheme_break_table", mcp)
    streams = {"v": cls, "f": lead}
    for scan_kind in SCAN_KINDS:
        ops = (SL.Op(scan_kind, "o", SCAN_BUILDS[scan_kind], init=-7),)
        moved = {"last": 9, "last2": 13}.get(scan_kind, 8) * n_cp  # int32 values, bool flags, int32 outputs
        library = {"sum": lambda: torch.cumsum(cls, 0, dtype=torch.int32), "max": lambda: torch.cummax(cls, 0)}.get(scan_kind)
        row(f"fused_scan-{scan_kind}-128MB", lambda ops=ops: tuple(SL.fused_scan(streams, ops, n_cp).values()),
            lambda ops=ops: tuple(SL.fused_scan_plain(streams, ops, n_cp).values()), moved, bound_ms(moved),
            "fused_scan" if scan_kind == "sum" else None, library=library, plain_samples=1, profiled="scan_")
    del cls, streams
    lb_cls = SEG._lb_classes(cps, lead, mcp)
    cm = (lb_cls == SEG._L["CM"]) | (lb_cls == SEG._L["ZWJ"])
    hard = sum(lb_cls == SEG._L[c] for c in ("BK", "CR", "LF", "NL", "SP", "ZW")) > 0
    feats = SEG._lb_feats_scan(lb_cls, cm, hard, ~cm & lead, lead, n_cp)
    env = {"cls": lb_cls, "lead": lead, **{k: feats[k] for k in SLC.LB_STREAMS if k in feats}}
    env = {k: v.to(torch.int32) for k, v in env.items()}
    del feats, cm, hard
    row("lb_rules-128MB (the corpus's UAX#14 features)", lambda: SLC.lb_rules(env, n_cp),
        lambda: SEG._lb_rules(env).to(torch.int32), 48 * n_cp, bound_ms(48 * n_cp), "lb_rules", plain_samples=3,
        profiled="lb_rules_kernel")
    del env, lb_cls, cps, lead

    # BPE at the tokenization suite's shape: its staged batch (400,000
    # pretokens sorted by length, 512 merges: the shared-memory regime, and
    # again with the table read from global memory), and the first
    # 4,000,000 kept pretokens of the corpus's first 32 Mi characters under
    # the same table, staged with numpy. Bound: the larger of the bytes (u8
    # rows and int32 lengths in, int32 ids and counts out) and
    # bpe_operations over the slots and pairs the plain version counts. By
    # profiler device time, as the multi-pattern rows.
    bpe = tok_keep["bpe"]
    bpe_table = bpe["table"]
    started_4m = time.perf_counter()
    _, by_length = tok_suite.bpe_rows(tok_keep["text"][:BPE_CHARS_4M], BPE_ROWS_4M)
    rows_4m, lens_4m = BPE.pack_rows(by_length)
    if rows_4m.shape[0] != BPE_ROWS_4M:
        raise AssertionError(f"the corpus's first {BPE_CHARS_4M:,} characters hold {rows_4m.shape[0]:,} pretokens of 1..32 B")
    staged_4m = time.perf_counter() - started_4m
    del by_length, tok_keep["text"]
    data_4m, lens_4m = torch.from_numpy(rows_4m).to(dev), torch.from_numpy(lens_4m).to(dev)
    bpe_pipes = sass_pipes("bpe_kernelILb1E")  # the shared-table instance
    bpe_sass = "; SASS pipe split not measured (no cuobjdump)" if bpe_pipes is None else f"; SASS {bpe_pipes['text']}"
    for label, data_b, lens_b, key, global_table in (
        ("bpe-512m-400k", bpe["data"], bpe["lengths"], "bpe", False),
        ("bpe-512m-400k-global", bpe["data"], bpe["lengths"], None, True),
        ("bpe-512m-4M", data_4m, lens_4m, None, False),
    ):
        _, _, work = BPE.bpe_encode_plain(data_b, lens_b, bpe_table, work=True)
        rounds, slots, pairs = work["iterations"], int(work["slots"].sum()), int(work["pairs"].sum())
        n_rows, width = data_b.shape
        moved = n_rows * width + 4 * n_rows + 4 * n_rows * width + 4 * n_rows
        operations = bpe_operations(slots, pairs, bpe_table.size)
        row(f"{label} ({n_rows:,} rows of width {width}, {BPC.regime_of(bpe_table, global_table)} table)",
            lambda data_b=data_b, lens_b=lens_b, g=global_table: BPC.bpe_encode(data_b, lens_b, bpe_table, global_table=g),
            lambda data_b=data_b, lens_b=lens_b: BPE.bpe_encode_plain(data_b, lens_b, bpe_table),
            int(lens_b.sum()), bound_ms(moved, operations), key, plain_samples=1, profiled="bpe_kernel",
            note=f"; {int(rounds.sum()):,} row iterations (mean {float(rounds.float().mean()):.2f}, max {int(rounds.max())}) "
                 f"over {slots:,} alive slots and {pairs:,} pairs looked up: {operations:,} operations, {moved:,} B moved"
                 + (f"; staged in {staged_4m:.1f} s" if data_b is data_4m else "") + (bpe_sass if key else ""))
    del rows_4m, data_4m, lens_4m, data_b, lens_b

    # Case folding at the normalization suite's shapes (the same corpus):
    # the range map of the unpruned simple-fold rules (base 0, the dense
    # table's 125 k int32 entries) over the corpus's decoded codepoints, the
    # class map's loop on an int32 table (bound: 8 B a codepoint), and that
    # loop without the add (``lut_map``'s lookup); the fused fold of the
    # suite's 32-byte rows (bound: per row 32 + 4 B in, 4 * max_exp * 32 + 4
    # B out); the window count of the suite's first needle over its folded
    # haystack (bound: 4 B a folded codepoint). Each by profiler device
    # time: the window count is shorter than its wrapper's host work.
    decoded, decoded_n = U8.utf8_decode(text, text_n)
    stream = decoded[: int(decoded_n)]
    simple = CF._fold_rules(None)[0]
    simple_table = torch.from_numpy(R.dense_delta_table(simple)).to(dev)
    row(f"range_map-fold-128MB ({stream.numel():,} codepoints, {simple.count} rules, {simple_table.numel():,}-entry int32 table)",
        lambda: LU.range_map_cuda(stream, simple_table, True), lambda: R.range_map_plain(stream, simple),
        4 * stream.numel(), bound_ms(8 * stream.numel()), "range_map", plain_samples=1, profiled="range_map_kernel")
    library, why = table_index(stream, simple_table)
    row(f"lut_map-int32-128MB (the same codepoints and {simple_table.numel():,}-entry int32 table, no add)",
        lambda: LU.class_map_cuda(stream, simple_table), lambda: LU.class_map_plain(stream, simple_table),
        4 * stream.numel(), bound_ms(8 * stream.numel()), profiled="class_map_kernel", library=library, note=why)
    del decoded, stream, text
    frows, fmax_exp = norm_keep["rows"], norm_keep["max_exp"]
    ftables = EX.fold_tables(norm_keep["max_cp"])
    moved = frows.count * (32 + 4 + 4 * fmax_exp * 32 + 4)
    row(f"fold-32B-rows-128MB ({frows.count:,} rows, max_exp {fmax_exp})",
        lambda: EXC.expand_compact_rows(frows.data, frows.lengths, ftables, fmax_exp, 32, True),
        lambda: EX.expand_compact_rows_plain(frows.data, frows.lengths, ftables, fmax_exp, 32, True),
        text_n, bound_ms(moved), "expand", plain_samples=1, profiled="expand_kernel")
    hay, needle = norm_keep["haystack"], norm_keep["needles"][0]
    row(f"cp_window-{needle.numel()}cp-128MB ({hay.numel():,} folded codepoints)",
        lambda: FC.cp_window_count(hay, hay.numel(), needle), lambda: F.cp_window_count_plain(hay, hay.numel(), needle),
        4 * hay.numel(), bound_ms(4 * hay.numel()), "cp_window", profiled="cp_window_kernel")
    # Where each normalization row's call and the BPE row's call spend their
    # time (``traced_call``; the find and BPE calls end in a count's .item()).
    a_rows, b_rows = norm_keep["compare_rows"]
    for name, call, kernel in (
        ("utf8_fold", lambda: EX.fold_tokens_fused(frows, norm_keep["max_cp"]), {"expand": "expand_kernel"}),
        ("uncased_eq", lambda: CF.uncased_equal_batch(a_rows, b_rows), {"range_map": "range_map_kernel"}),
        ("uncased_find", lambda: int(F.cp_window_count(hay, hay.numel(), needle).item()), {"cp_window": "cp_window_kernel"}),
        ("bpe_encode", lambda: int(BPE.bpe_encode_fused(bpe["data"], bpe["lengths"], bpe_table)[1].sum().item()),
         {"bpe": "bpe_kernel"}),
    ):
        traced_call(f"{name} call (the suite's)", call, launches, kernel)
    norm_keep.clear()
    tok_keep.clear()
    del frows, hay, needle, a_rows, b_rows, bpe

    # The encryption and SHA-256 rows at the main path's shapes: the
    # encryption suite's corpus (128 MB of synthetic:long-lines) through the
    # keystream XOR, the MAC alone (raw mode, the key on the card) and the
    # suite's corpus call (aead_encrypt: the one-time key, the XOR, the MAC of
    # the AEAD's input, the tag read back); the hash suite's buckets through
    # SHA-256; the Threefry fill of 128 MiB. Bounds: 32-bit instructions per
    # block of each function, counted in its kernel's note (ChaCha20 993 a
    # 64-byte block, Poly1305 70 a 16-byte block, SHA-256 1,384 a 64-byte
    # block, Threefry 73 a word), or the bytes, whichever is larger.
    corpus, (seal_nonce, _, _) = enc_keep["corpus"], enc_keep["sealed"]
    key, n_enc = enc_suite.KEY, enc_keep["corpus"].numel()
    key_dev = torch.tensor(list(key), dtype=torch.uint8, device=dev)
    blocks64, blocks16 = -(-n_enc // 64), -(-n_enc // 16)
    cc_pipes = sass_pipes("chacha_xor_kernel", "STS")  # the tile loop: its block stores the keystream to shared memory
    if cc_pipes is None:
        cc_sass = "; SASS pipe split not measured (no cuobjdump)"
    else:
        cc_ceiling = blocks64 * cc_pipes["body"]["alu"] / (132 * 64 * 1.98e9) * 1e3
        cc_sass = (f"; SASS {cc_pipes['text']}; ALU-pipe ceiling {cc_ceiling:.4f} ms (the tile loop's ALU instructions, "
                   f"one block a lane, at 64 a clock an SM, 132 SMs, 1.98 GHz)")
    row(f"chacha20-xor-128MB ({n_enc:,} B)", lambda: CC.chacha20_xor_cuda(key, seal_nonce, corpus),
        lambda: CC.chacha20_xor_plain(key, seal_nonce, corpus), n_enc, bound_ms(2 * n_enc, 993 * blocks64), "chacha20_xor",
        plain_samples=1, note=cc_sass)
    row(f"poly1305-128MB ({n_enc:,} B, raw mode)", lambda: CC.poly1305_cuda(key_dev, corpus),
        lambda: torch.tensor(list(CC.poly1305_plain(key, corpus)), dtype=torch.uint8, device=dev), n_enc,
        bound_ms(n_enc, 70 * blocks16), "poly1305", plain_samples=1)

    def tag_tensor(sealed):
        return sealed[0], torch.tensor(list(sealed[1]), dtype=torch.uint8)

    row(f"aead-seal-128MB (the suite's chacha20poly1305-corpus call, {n_enc:,} B)",
        lambda: tag_tensor(CC.aead_encrypt(key, seal_nonce, corpus)),
        lambda: tag_tensor(CC.aead_encrypt_plain(key, seal_nonce, corpus)), n_enc,
        bound_ms(2 * n_enc, 993 * (blocks64 + 1) + 70 * (blocks16 + 1)), plain_samples=1)
    # Rule 2's step 0: the encryption suite's keygen calls (a key and a
    # nonce, or a key alone, made on the card and read back) and one
    # per-token call (64 seals), as the suite makes them, traced. Bounds:
    # Threefry 73 operations a word; a seal 993 a keystream block (its
    # blocks and the one-time key's) and 70 a MAC block (the text's and the
    # lengths'), or twice its bytes.
    keygen_seed = [0]

    def keygen(n: int) -> None:
        keygen_seed[0] += 1
        M.fill_random(keygen_seed[0], n, dev).cpu()

    for label, n_key in (("chacha20poly1305", 44), ("fill_random", 32)):
        traced_call(f"keygen call (the encryption suite's keygen/swtorch::{label}, {n_key} B read back)",
                    lambda n_key=n_key: keygen(n_key), launches, {"threefry": "threefry_kernel"},
                    bound_ms(n_key, 73 * -(-n_key // 4)))
    tokens = [torch.tensor(list(t), dtype=torch.uint8, device=dev) for t in enc_keep["sample"]]
    seal_ops = sum(993 * (-(-t.numel() // 64) + 1) + 70 * (-(-t.numel() // 16) + 1) for t in tokens)
    traced_call(f"seal call (the encryption suite's encryption/swtorch::chacha20poly1305: {len(tokens)} tokens of "
                f"{sum(t.numel() for t in tokens):,} B, a seal each)",
                lambda: [CC.aead_encrypt(key, enc_suite.counter_nonce(i), t) for i, t in enumerate(tokens)], launches,
                {"chacha20_xor": "chacha_xor_kernel", "poly1305": "poly_"},
                bound_ms(2 * sum(t.numel() for t in tokens), seal_ops))
    enc_keep.clear()
    del corpus, key_dev, tokens
    buckets, tape = hash_keep.pop("buckets"), hash_keep.pop("tape")
    sha_blocks = sum(int(((p.lengths.to(torch.int64) + 9 + 63) // 64).sum()) for p in buckets.buckets)
    sha_bound = bound_ms(buckets.token_bytes + 36 * buckets.tokens, 1384 * sha_blocks)
    pipes = sass_pipes("sha256_kernel")
    if pipes is None:
        sass_text = "; SASS pipe split not measured (no cuobjdump)"
    else:
        alu_ceiling = sha_blocks * pipes["body"]["alu"] / (132 * 64 * 1.98e9) * 1e3
        sass_text = (f"; SASS {pipes['text']}; ALU-pipe ceiling {alu_ceiling:.4f} ms (the body's ALU instructions a block "
                     f"at 64 a clock an SM, 132 SMs, 1.98 GHz)")
    row(f"sha256-words-128MB ({buckets.tokens:,} tokens in {len(buckets.buckets)} buckets, {sha_blocks:,} blocks)",
        lambda: tuple(SHA.sha256_cuda(p) for p in buckets.buckets), lambda: tuple(SHA.sha256_plain(p) for p in buckets.buckets),
        buckets.token_bytes, sha_bound, "sha256", plain_samples=1, note=sass_text)
    # Rule 2's step 0: the hash suite's stateful call (both tree levels
    # and the digest's .item()) and its checksum call over every bucket.
    n_tree = tape.total_bytes
    traced_call(f"tree_hash64 call (the hash suite's stateful/swtorch::tree_hash64 over {n_tree:,} B)",
                lambda: H.tree_hash64(tape.data, n_tree), launches, {"xxh64_tree": "xxh64_tree_kernel"},
                bound_ms(n_tree, 9 * n_tree / 8))
    traced_call(f"sha256 call (the hash suite's checksum/swtorch::sha256 over its {len(buckets.buckets)} buckets)",
                lambda: [SHA.sha256(p) for p in buckets.buckets], launches, {"sha256": "sha256_kernel"}, sha_bound)
    del buckets, tape
    fill_words = 32 << 20
    row("fill_random-128MB (Threefry-2x32, 32 Mi words)", lambda: M.threefry_bits_cuda(1, fill_words, dev),
        lambda: M.threefry_bits_plain(1, fill_words, dev), 4 * fill_words, bound_ms(4 * fill_words, 73 * fill_words), "threefry",
        plain_samples=1)
    torch.cuda.empty_cache()
    phase("rows", "done", started)

    sources = {
        "bytesum": ("stringwars_tpu_torch/csrc/bytesum.cu", "stringwars_tpu/ops/bytesum.py:142"),
        "find_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find_pallas.py:58"),
        "rfind_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find_pallas.py:58"),
        "byteset_count": ("stringwars_tpu_torch/csrc/find.cu", "stringwars_tpu/ops/find.py:217"),
        "xxh64": ("stringwars_tpu_torch/csrc/hash.cu", "stringwars_tpu/ops/hash_pallas.py:74"),
        "xxh64_tree": ("stringwars_tpu_torch/csrc/hash.cu", "stringwars_tpu/ops/hash.py:357"),
        "swh64": ("stringwars_tpu_torch/csrc/hash.cu", "stringwars_tpu/ops/hash.py:504"),
        "xxh32": ("stringwars_tpu_torch/csrc/hash.cu", "stringwars_tpu/ops/hash.py:179"),
        "fingerprint": ("stringwars_tpu_torch/csrc/fingerprint.cu", "stringwars_tpu/ops/fingerprint.py:119"),
        "lut_translate": ("stringwars_tpu_torch/csrc/lut.cu", "stringwars_tpu/ops/memops.py:35"),
        "myers": ("stringwars_tpu_torch/csrc/myers.cu", "stringwars_tpu/ops/myers_pallas.py:49"),
        "affine": ("stringwars_tpu_torch/csrc/affine.cu", "stringwars_tpu/ops/affine_pallas.py:66"),
        "linear": ("stringwars_tpu_torch/csrc/affine.cu", "stringwars_tpu/ops/affine_pallas.py:170"),
        "ac_dfa": ("stringwars_tpu_torch/csrc/ahocorasick.cu", "stringwars_tpu/ops/ahocorasick.py:144"),
        "shiftand": ("stringwars_tpu_torch/csrc/shiftand.cu", "stringwars_tpu/ops/shiftand.py:108"),
        "class_map": ("stringwars_tpu_torch/csrc/classmap.cu", "stringwars_tpu/ops/lut.py:128; stringwars_tpu/ops/rulemap.py:170"),
        "fused_scan": ("stringwars_tpu_torch/csrc/scanline.cu", "stringwars_tpu/ops/scanline.py:203"),
        "lb_rules": ("stringwars_tpu_torch/csrc/lbrules.cu", "stringwars_tpu/ops/scanline.py:375"),
        "expand": ("stringwars_tpu_torch/csrc/expand.cu", "stringwars_tpu/ops/casefold_pallas.py:128"),
        "range_map": ("stringwars_tpu_torch/csrc/classmap.cu", "stringwars_tpu/ops/rulemap.py:184"),
        "cp_window": ("stringwars_tpu_torch/csrc/cpfind.cu", "stringwars_tpu/ops/find_pallas.py:260"),
        "bpe": ("stringwars_tpu_torch/csrc/bpe.cu", "stringwars_tpu/ops/bpe_pallas.py:92"),
        "chacha20_xor": ("stringwars_tpu_torch/csrc/chacha.cu", "stringwars_tpu/ops/chacha.py:102"),
        "poly1305": ("stringwars_tpu_torch/csrc/chacha.cu", "stringwars_tpu/ops/chacha.py:219"),
        "sha256": ("stringwars_tpu_torch/csrc/sha256.cu", "stringwars_tpu/ops/sha256.py:112"),
        "threefry": ("stringwars_tpu_torch/csrc/threefry.cu", "stringwars_tpu/ops/memops.py:104"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": errors[name],
            **timings[name],
        }
        for name, (source, replaces) in sources.items()
    ]
    phase("total", f"{time.perf_counter() - whole:.1f} s; profiler traces retaken for a missing kernel or range: {MISSED}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
