// K10 · Unicode normalization of codepoint rows: decomposition, canonical
// reordering and composition (ops/normalize.py). Each row was cut before a
// safe codepoint (ops/normalize.safe_table), so every row normalizes on its
// own; rows are int32 codepoints, `counts` the live codepoints of each.
//
// sw_nf_decompose_rows replaces the unfused route of
// stringwars_tpu/ops/normalize.py::decompose_rows (:238; range_map of
// rulemap.py:228 for the inline, length and per-position maps, then one
// packed lax.sort a row to compact, a way around the TPU's scatters; NFKD
// takes it at every corpus ceiling, NFD in rows other than 32 or 64 wide).
// One warp a row, 32 codepoints a pass: each lane looks up its codepoint in
// the packed table (the one codepoint of a one-codepoint decomposition, or
// ~(pool offset << 5 | length)), the warp takes the inclusive sum of the
// lengths by shuffles, and each lane writes its expansion from the pool at
// its place in the output row; the warp then zeroes the row past its total.
// Bound on an H100: the bytes, 4 a codepoint read and 4 * max_exp a
// codepoint written (the output row holds max_exp slots a codepoint, most
// of them zeros); the tables are the few lines text touches, in L1.
//
// sw_nf_reorder_rows replaces normalize.py::_canonical_reorder_rows (:298;
// odd-even transposition passes, with a stable two-pass argsort past 64
// passes: both give the stable sort of each run of nonzero-ccc codepoints by
// ccc). Bound: the bytes, 4 a live codepoint read, 4 a moved one written, 4
// a count. Text is mostly starters and its marks mostly in order, so the
// kernel first looks and then sorts only where it must. One warp a row, a
// lane four consecutive codepoints (one 16-byte load where the row allows),
// 128 a chunk; a warp loads a row's first two chunks at once (the next
// row's count with them). Each lane looks up its codepoints' classes in the
// ccc table, whose first 48 KB (every codepoint below U+C000) a block
// stages in shared memory once; a warp with a codepoint above it reads
// those classes through __ldg. A codepoint is out of order when its class
// c > 0 follows a greater one (across lanes and chunks, the class before
// carried over); a row where the warp's ballot finds none is not written.
// A row of at most 128 codepoints that is out of order is sorted in
// registers by the JAX function's own odd-even transposition passes
// (neighbours in a lane by selects, across lanes by shuffles) until a pass
// swaps nothing, and a lane writes its four codepoints back only where they
// moved. A longer row out of order (the wide bucket's runs) is sorted in
// place by the lane at the first codepoint of each run of nonzero classes,
// a stable insertion sort (a codepoint of class c moving left past those of
// a greater class), runs being disjoint. Both are exact and stable for a
// run of any length. kRows rows a warp a step and other blocks an SM are
// for tools/hopper_probes.py reorder.
//
// sw_nf_compose_rows replaces normalize.py::_compose_scan (:429) with
// _nfc_padded's compaction (:614): a lax.scan over the whole stream carrying
// (starter, last ccc), then a segment pass resolving each starter slot and a
// scatter to compact. The walk it runs: a codepoint not blocked from the
// last starter (nothing kept since the starter, or the last kept class
// below its own) that composes with it (Hangul L+V and LV+T by arithmetic,
// else the primary composite of the dense [n_s, n_c] table at the two
// codepoints' ranks) replaces the starter and is dropped; every other
// codepoint is kept, a class-0 one becoming the starter. Bound: the bytes,
// 4 a live codepoint read and written, 4 a count read and a kept count
// written. In place, kComposeLanes lanes a row (a warp takes four rows):
// - a lane takes four consecutive codepoints (one 16-byte load where the row
//   allows), 32 a chunk of a row, and looks up their classes in a class
//   table whose first 48 KB (every codepoint below U+C000) the block stages
//   in shared memory, as nf_reorder does; a warp with a codepoint above it
//   reads those classes through __ldg. The table is the ccc table with every
//   class-0 second element of a primary composite marked kCombiner (the
//   Hangul V and T jamo and 24 others in Unicode 15:
//   ops/normalize.compose_classes).
// - the walk resets at every other class-0 codepoint (a reset point): it
//   becomes the starter, and nothing before it can compose with anything
//   after it. So a row splits into chains, each a reset point and what
//   follows up to the next: a segment (a starter and its marks) and the
//   segments after it led by a combiner, whose leading starter may compose
//   into the chain's starter (L V T; U+0CC6 U+0CC2 U+0CD5). A reset point
//   followed by another is a chain that composes nothing. The others are
//   listed by their rank in the chunk (ballots), and the row's lane j walks
//   chains j, j + kComposeLanes, ... sequentially from the chunk's copy in
//   shared memory: the walk is as long as the longest chain, not a lane's
//   four positions and what follows them.
// - a walk marks each dropped codepoint's class in the copy and writes each
//   composed starter over the starter's place in it; the lanes then write
//   the kept codepoints at the exclusive sum of the kept counts before them,
//   behind every codepoint the row's lanes have read (a chunk with nothing
//   dropped and nothing dropped before it is not written). The chain that
//   reaches a chunk's end is carried into the next chunk (its starter, the
//   row position it was written to, the last kept class), where it is walked
//   on; a composition into a starter of an earlier chunk is written to the
//   row directly. The slots past the kept count are zeroed.
// - Chosen on an H100 (tools/hopper_probes.py compose, PERF.md): a warp a
//   row spends its instructions on ballots, scans and idle lanes over the
//   corpus' rows of about 64 codepoints (0.887 ms on nfc-of-nfd, 0.59 of it
//   with no chain walked); half a warp 0.500, a quarter 0.484. A walk that
//   took a lane's four positions and what follows them, speculative
//   composites looked up for every position at once, and the next row
//   loaded a row ahead were each slower or no faster.
#include "common.cuh"

namespace swt {

constexpr int32_t kSBase = 0xAC00, kLBase = 0x1100, kVBase = 0x1161, kTBase = 0x11A7;
constexpr int32_t kLCount = 19, kVCount = 21, kTCount = 28, kSCount = 11172;

__device__ __forceinline__ int32_t clamped(int32_t v, int32_t size) { return v < 0 ? 0 : (v >= size ? size - 1 : v); }

__global__ void __launch_bounds__(kThreads)
nf_decompose_kernel(const int32_t* __restrict__ cps, const int32_t* __restrict__ lengths, int64_t rows, int64_t width,
                    const int32_t* __restrict__ packed, int32_t size, const int32_t* __restrict__ pool, int32_t pool_size,
                    int32_t max_exp, int32_t* __restrict__ out, int32_t* __restrict__ counts) {
  constexpr int kRowWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t out_w = width * max_exp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp; r < rows; r += stride) {
    const int64_t len = min(static_cast<int64_t>(__ldg(lengths + r)), width);
    const int32_t* row = cps + r * width;
    int32_t* dst = out + r * out_w;
    int64_t carry = 0;  // the row's sum of lengths before this pass
    for (int64_t base = 0; base < len; base += 32) {
      const int64_t e = base + lane;
      const bool live = e < len;
      const int32_t t = live ? __ldg(packed + clamped(__ldg(row + e), size)) : 0;
      const int32_t m = ~t;
      const int32_t length = live ? (t < 0 ? (m & 31) : 1) : 0;
      int32_t incl = length;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const int64_t start = carry + incl - length;
      carry += __shfl_sync(0xffffffffu, incl, 31);
      if (t >= 0) {
        if (length && start < out_w) dst[start] = t;
      } else {
        const int32_t off = m >> 5;
        for (int32_t k = 0; k < length && start + k < out_w; ++k) dst[start + k] = __ldg(pool + clamped(off + k, pool_size));
      }
    }
    for (int64_t d = carry + lane; d < out_w; d += 32) dst[d] = 0;
    if (lane == 0) counts[r] = static_cast<int32_t>(carry);
  }
}

constexpr int kReorderThreads = 512;
constexpr int32_t kCccShared = 0xC000;  // bytes of the ccc table staged in shared memory
constexpr int kReorderRows = 1;         // rows a warp looks at together
constexpr int kReorderMinBlocks = 3;    // blocks an SM the registers must allow

// Four consecutive codepoints of a row from position e (zeros at or past n);
// kVec: one 16-byte load (the row 16-byte aligned, its width a multiple of 4).
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* row, int32_t e, int32_t n) {
  if (kVec) return e < n ? *reinterpret_cast<const int4*>(row + e) : make_int4(0, 0, 0, 0);
  return make_int4(e < n ? row[e] : 0, e + 1 < n ? row[e + 1] : 0, e + 2 < n ? row[e + 2] : 0, e + 3 < n ? row[e + 3] : 0);
}

// Swap the neighbours (x, c) and (y, d) where c > d > 0: one step of the
// odd-even transposition passes.
__device__ __forceinline__ bool exchange(int32_t& x, int32_t& c, int32_t& y, int32_t& d) {
  const bool swap = c > d && d > 0;
  const int32_t tx = swap ? y : x, tc = swap ? d : c;
  y = swap ? x : y;
  d = swap ? c : d;
  x = tx;
  c = tc;
  return swap;
}

template <bool kVec, int kRows, int kMinBlocks>
__global__ void __launch_bounds__(kReorderThreads, kMinBlocks)
nf_reorder_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int64_t rows, int64_t width,
                  const uint8_t* __restrict__ ccc, int32_t ccc_size) {
  __shared__ __align__(16) uint8_t table[kCccShared];
  const int32_t staged = min(ccc_size, kCccShared);
  for (int32_t k = threadIdx.x; k < staged / 16; k += kReorderThreads) {
    reinterpret_cast<uint4*>(table)[k] = __ldg(reinterpret_cast<const uint4*>(ccc) + k);
  }
  for (int32_t k = (staged & ~15) + threadIdx.x; k < staged; k += kReorderThreads) table[k] = __ldg(ccc + k);
  __syncthreads();
  const auto class_of = [&](int32_t cp) -> int32_t {
    return static_cast<uint32_t>(cp) < static_cast<uint32_t>(staged) ? table[cp] : __ldg(ccc + clamped(cp, ccc_size));
  };
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // Classes of the four codepoints at e (0 at or past n), and whether one of
  // them follows a greater class; `carry` is the class before the chunk, and
  // becomes the chunk's last.
  const auto look = [&](const int4& v, int32_t e, int32_t n, int4& c, int32_t& carry) {
    const int32_t x0 = e < n ? v.x : 0, x1 = e + 1 < n ? v.y : 0, x2 = e + 2 < n ? v.z : 0, x3 = e + 3 < n ? v.w : 0;
    const uint32_t top = max(max(static_cast<uint32_t>(x0), static_cast<uint32_t>(x1)),
                             max(static_cast<uint32_t>(x2), static_cast<uint32_t>(x3)));
    if (__any_sync(kFull, top >= static_cast<uint32_t>(staged))) {  // a codepoint past the staged table
      c = make_int4(class_of(x0), class_of(x1), class_of(x2), class_of(x3));
    } else {
      c = make_int4(table[x0], table[x1], table[x2], table[x3]);
    }
    int32_t before = __shfl_up_sync(kFull, c.w, 1);
    if (lane == 0) before = carry;
    carry = __shfl_sync(kFull, c.w, 31);
    return (c.x > 0 && before > c.x) || (c.y > 0 && c.x > c.y) || (c.z > 0 && c.y > c.z) || (c.w > 0 && c.z > c.w);
  };
  // A row of n codepoints whose first 256 are v (0..127) and v2 (128..255).
  const auto reorder_row = [&](int32_t* row, int32_t n, int4 v, int4 v2) {
    int4 c, more;
    int32_t carry = 0;
    bool unsorted = __any_sync(kFull, look(v, 4 * lane, n, c, carry));
    if (n > 128 && !unsorted) unsorted = __any_sync(kFull, look(v2, 128 + 4 * lane, n, more, carry));
    for (int32_t base = 256; base < n && !unsorted; base += 128) {
      unsorted = __any_sync(kFull, look(load4<kVec>(row, base + 4 * lane, n), base + 4 * lane, n, more, carry));
    }
    if (!unsorted) return;
    if (n <= 128) {  // the row is in registers: odd-even transposition passes
      bool moved = false;
      for (;;) {
        bool swapped = exchange(v.x, c.x, v.y, c.y);
        swapped |= exchange(v.z, c.z, v.w, c.w);
        swapped |= exchange(v.y, c.y, v.z, c.z);
        const int32_t next_x = __shfl_down_sync(kFull, v.x, 1), next_c = __shfl_down_sync(kFull, c.x, 1);
        const int32_t prev_x = __shfl_up_sync(kFull, v.w, 1), prev_c = __shfl_up_sync(kFull, c.w, 1);
        const bool with_next = lane < 31 && c.w > next_c && next_c > 0;
        const bool with_prev = lane > 0 && prev_c > c.x && c.x > 0;
        if (with_next) {
          v.w = next_x;
          c.w = next_c;
        }
        if (with_prev) {
          v.x = prev_x;
          c.x = prev_c;
        }
        swapped |= with_next || with_prev;
        moved |= swapped;
        if (!__any_sync(kFull, swapped)) break;
      }
      const int32_t e = 4 * lane;
      if (moved) {
        if (kVec) {
          *reinterpret_cast<int4*>(row + e) = v;
        } else {
          if (e < n) row[e] = v.x;
          if (e + 1 < n) row[e + 1] = v.y;
          if (e + 2 < n) row[e + 2] = v.z;
          if (e + 3 < n) row[e + 3] = v.w;
        }
      }
      return;
    }
    carry = 0;
    for (int32_t base = 0; base < n; base += 32) {
      const int32_t e = base + lane;
      const int32_t cl = e < n ? class_of(row[e]) : 0;
      int32_t before = __shfl_up_sync(kFull, cl, 1);
      if (lane == 0) before = carry;
      carry = __shfl_sync(kFull, cl, 31);
      __syncwarp();
      if (cl > 0 && before == 0) {  // the first codepoint of a run: sort the run
        for (int32_t i = e + 1; i < n; ++i) {
          const int32_t x = row[i];
          const int32_t cx = class_of(x);
          if (cx == 0) break;
          int32_t j = i;
          for (; j > e; --j) {
            const int32_t y = row[j - 1];
            if (class_of(y) <= cx) break;
            row[j] = y;
          }
          if (j != i) row[j] = x;
        }
      }
      __syncwarp();
    }
  };
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kReorderThreads / 32);
  int64_t r = static_cast<int64_t>(blockIdx.x) * (kReorderThreads / 32) + (threadIdx.x >> 5);
  int32_t count[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) count[q] = r + q * warps < rows ? __ldg(counts + r + q * warps) : 0;
  for (; r < rows; r += kRows * warps) {
    int32_t n[kRows];
    int4 v[kRows], v2[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int64_t rq = r + q * warps;
      n[q] = rq < rows ? min(count[q], static_cast<int32_t>(width)) : 0;
      v[q] = load4<kVec>(data + rq * width, 4 * lane, n[q]);
      v2[q] = load4<kVec>(data + rq * width, 128 + 4 * lane, n[q]);
      count[q] = rq + kRows * warps < rows ? __ldg(counts + rq + kRows * warps) : 0;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (r + q * warps < rows) reorder_row(data + (r + q * warps) * width, n[q], v[q], v2[q]);
    }
  }
}

constexpr int kComposeThreads = 512;
constexpr int kComposeMinBlocks = 2;   // blocks an SM the registers must allow
constexpr int kComposeLanes = 8;       // lanes a row: a warp takes 32 / kComposeLanes rows at once
constexpr uint8_t kCombiner = 255;     // class-table mark of a class-0 second element
constexpr uint8_t kDropped = 254;      // a dropped codepoint's class in a warp's copy
constexpr int kComposeWarps = kComposeThreads / 32;
// Dynamic shared memory: the staged class table, then each warp's copy of
// its chunks (128 codepoints, their classes, the first position of each
// chain).
constexpr size_t kComposeWarpBytes = 128 * 6;
constexpr size_t kComposeShared = kCccShared + kComposeWarps * kComposeWarpBytes;

template <bool kVec>
__global__ void __launch_bounds__(kComposeThreads, kComposeMinBlocks)
nf_compose_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int32_t* __restrict__ kept,
                  int64_t rows, int64_t width, const uint8_t* __restrict__ classes, int32_t classes_size,
                  const int32_t* __restrict__ s_rank, int32_t s_size, const int32_t* __restrict__ c_rank, int32_t c_size,
                  const int32_t* __restrict__ dense, int32_t n_c) {
  constexpr int kLanes = kComposeLanes;
  constexpr int kChunk = 4 * kLanes;  // codepoints a row's lanes take at once: four a lane
  constexpr int kRowsAWarp = 32 / kLanes;
  extern __shared__ __align__(16) uint8_t shared[];
  uint8_t* table = shared;
  const int32_t staged = min(classes_size, kCccShared);
  for (int32_t k = threadIdx.x; k < staged / 16; k += kComposeThreads) {
    reinterpret_cast<uint4*>(table)[k] = __ldg(reinterpret_cast<const uint4*>(classes) + k);
  }
  for (int32_t k = (staged & ~15) + threadIdx.x; k < staged; k += kComposeThreads) table[k] = __ldg(classes + k);
  __syncthreads();
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / kLanes, hl = lane % kLanes;  // the lane's row of the warp, and its place in the row's lanes
  const unsigned below_lane = (1u << hl) - 1u, above_lane = ~((2u << hl) - 1u);
  // A warp-wide ballot's bits of the lane's row.
  const auto mine = [&](unsigned ballot) -> unsigned {
    return (ballot >> (kLanes * sub)) & ((1u << kLanes) - 1u);
  };
  const int off = kChunk * sub;  // the row's place in the warp's copies
  int32_t* cps = reinterpret_cast<int32_t*>(shared + kCccShared + warp * kComposeWarpBytes);  // the chunks' codepoints
  uint8_t* cls = reinterpret_cast<uint8_t*>(cps + 128);  // their classes
  uint8_t* chain_from = cls + 128;  // each chain's first position, in order
  const auto class_of = [&](int32_t cp) -> uint32_t {
    return static_cast<uint32_t>(cp) < static_cast<uint32_t>(staged) ? table[cp] : __ldg(classes + clamped(cp, classes_size));
  };
  const int32_t e = 4 * hl;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kComposeWarps * kRowsAWarp;
  for (int64_t first = (static_cast<int64_t>(blockIdx.x) * kComposeWarps + warp) * kRowsAWarp; first < rows; first += stride) {
    const int64_t r = first + sub;
    int32_t* row = data + r * width;
    const int32_t n = r < rows ? static_cast<int32_t>(min(static_cast<int64_t>(__ldg(counts + r)), width)) : 0;
    // The walk's state carried into the next chunk: the starter (-1: none
    // yet), the row position it was written to, the last kept class.
    int32_t starter = -1, slot = -1, last_cc = 0;
    int32_t out = 0;  // codepoints kept so far
    for (int32_t base = 0; __any_sync(kFull, base < n); base += kChunk) {  // the warp's rows, chunk by chunk
      const int32_t nc = max(min(n - base, kChunk), 0);
      const int4 v = load4<kVec>(row + base, e, nc);
      const int32_t vals[4] = {v.x, v.y, v.z, v.w};
      uint32_t c[4];
      const uint32_t top = max(max(static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y)),
                               max(static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)));
      if (__any_sync(kFull, top >= static_cast<uint32_t>(staged))) {  // a codepoint past the staged table
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = class_of(vals[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = table[vals[k]];
      }
      reinterpret_cast<int4*>(cps + off)[hl] = v;
      reinterpret_cast<uint32_t*>(cls + off)[hl] = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
      // Chains: a reset point followed by a codepoint that is none (a reset
      // point followed by another composes with nothing), and position 0
      // when it is none (the chain carried in); each ends before the next
      // reset point. A lane lists the chains that begin in its four
      // positions, at their rank among the chunk's.
      bool reset[4], live[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        live[k] = e + k < nc;
        reset[k] = live[k] && c[k] == 0;
      }
      // Whether position e + 4 (the next lane's first) is live and no reset point.
      const bool next_mark = __shfl_down_sync(kFull, static_cast<int>(live[0] && !reset[0]), 1, kLanes) && hl < kLanes - 1;
      bool begins[4];
      int32_t count = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool mark_after = k < 3 ? live[k + 1] && !reset[k + 1] : next_mark;
        begins[k] = (reset[k] && mark_after) || (e + k == 0 && live[k] && !reset[k]);
        count += begins[k];
      }
      const unsigned b0 = mine(__ballot_sync(kFull, count & 1)), b1 = mine(__ballot_sync(kFull, count & 2)),
                     b2 = mine(__ballot_sync(kFull, count & 4));
      int32_t rank = __popc(b0 & below_lane) + 2 * __popc(b1 & below_lane) + 4 * __popc(b2 & below_lane);
      const int32_t chains = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (begins[k]) chain_from[off + rank++] = static_cast<uint8_t>(e + k);
      }
      __syncwarp();
      // The walk: the row's lane j takes its chains j, j + kLanes, ...; the
      // chain that reaches the chunk's end leaves its state to the next.
      int32_t w_starter = -1, w_spos = -1, w_last = 0;
      bool w_has = false;
      for (int32_t j = hl; j < chains; j += kLanes) {
        const int32_t from = chain_from[off + j];
        int32_t st, spos, lc, pos;
        if (from == 0 && cls[off] != 0) {  // the chain carried in
          st = starter;
          spos = -1;
          lc = last_cc;
          pos = 0;
        } else {
          st = cps[off + from];
          spos = from;
          lc = 0;
          pos = from + 1;
        }
        for (; pos < nc; ++pos) {
          const uint32_t k = cls[off + pos];
          if (k == 0) break;  // the next reset point: the chain's end
          const int32_t cp = cps[off + pos];
          const bool combiner = k == kCombiner;
          const int32_t cc = combiner ? 0 : static_cast<int32_t>(k);
          int32_t composed = -1;
          if (st >= 0 && (lc == 0 || lc < cc)) {  // not blocked: the primary composite, if any
            if (combiner) {  // Hangul V and T are combiners; L+V and LV+T compose by arithmetic
              if (st >= kLBase && st < kLBase + kLCount && cp >= kVBase && cp < kVBase + kVCount) {
                composed = kSBase + ((st - kLBase) * kVCount + (cp - kVBase)) * kTCount;
              } else if (st >= kSBase && st < kSBase + kSCount && (st - kSBase) % kTCount == 0 && cp > kTBase &&
                         cp < kTBase + kTCount) {
                composed = st + (cp - kTBase);
              }
            }
            if (composed < 0) {
              const int32_t pair = __ldg(dense + __ldg(s_rank + clamped(st, s_size)) * n_c + __ldg(c_rank + clamped(cp, c_size)));
              composed = pair > 0 ? pair : -1;
            }
          }
          if (composed >= 0) {
            st = composed;
            cls[off + pos] = kDropped;
            if (spos >= 0) {
              cps[off + spos] = composed;
            } else {
              row[slot] = composed;  // the carried starter, written in an earlier chunk
            }
          } else if (combiner) {  // a class-0 codepoint kept: the new starter
            st = cp;
            spos = pos;
            lc = 0;
          } else {
            lc = cc;
          }
        }
        if (pos == nc) {
          w_starter = st;
          w_spos = spos;
          w_last = lc;
          w_has = true;
        }
      }
      const unsigned carrier = mine(__ballot_sync(kFull, w_has));  // else the chunk ends at a reset point
      const int src = carrier ? sub * kLanes + __ffs(carrier) - 1 : lane;
      w_starter = __shfl_sync(kFull, w_starter, src);
      w_spos = __shfl_sync(kFull, w_spos, src);
      w_last = __shfl_sync(kFull, w_last, src);
      __syncwarp();
      // Compaction: each kept codepoint at `out` plus the kept ones before it.
      const int4 w = reinterpret_cast<const int4*>(cps + off)[hl];
      const uint32_t k4 = reinterpret_cast<const uint32_t*>(cls + off)[hl];
      const int32_t now[4] = {w.x, w.y, w.z, w.w};
      bool keep[4];
      int32_t kept_here = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        keep[k] = live[k] && ((k4 >> (8 * k)) & 0xFF) != kDropped;
        kept_here += keep[k];
      }
      const unsigned k0 = mine(__ballot_sync(kFull, kept_here & 1)), k1 = mine(__ballot_sync(kFull, kept_here & 2)),
                     k2 = mine(__ballot_sync(kFull, kept_here & 4));
      const int32_t before = __popc(k0 & below_lane) + 2 * __popc(k1 & below_lane) + 4 * __popc(k2 & below_lane);
      const int32_t total = __popc(k0) + 2 * __popc(k1) + 4 * __popc(k2);
      if (out != base || total != nc) {
        int32_t at = out + before;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (keep[k]) row[at++] = now[k];
        }
      }
      // The state carried on, the starter's row position among it.
      int32_t below = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) below += keep[k] && e + k < w_spos;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
      if (nc > 0) {
        if (carrier) {
          starter = w_starter;
          last_cc = w_last;
          if (w_spos >= 0) slot = out + below;
        } else {  // the chunk ends at a reset point, kept: the starter
          starter = cps[off + nc - 1];
          slot = out + total - 1;
          last_cc = 0;
        }
      }
      out += total;
      __syncwarp();
    }
    for (int32_t d = out + hl; d < n; d += kLanes) row[d] = 0;
    if (hl == 0 && r < rows) kept[r] = out;
  }
}

}  // namespace swt

// cps: int32[rows, width]; lengths: int32[rows], each at most width; packed:
// int32[size]; pool: int32[pool_size]; out: int32[rows, width * max_exp];
// counts: int32[rows].
extern "C" int sw_nf_decompose_rows(const void* cps, const void* lengths, int64_t rows, int64_t width, const void* packed,
                                    int64_t size, const void* pool, int64_t pool_size, int64_t max_exp, void* out,
                                    void* counts, void* stream) {
  if (rows <= 0 || width <= 0 || size <= 0 || size >= (int64_t{1} << 31) || pool_size <= 0 || max_exp < 1 || max_exp > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = swt::nf_decompose_kernel;
  const int grid = swt::resident_grid(kernel, 0, (rows + swt::kThreads / 32 - 1) / (swt::kThreads / 32));
  kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cps), static_cast<const int32_t*>(lengths), rows, width, static_cast<const int32_t*>(packed),
      static_cast<int32_t>(size), static_cast<const int32_t*>(pool), static_cast<int32_t>(pool_size),
      static_cast<int32_t>(max_exp), static_cast<int32_t*>(out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// data: int32[rows, width], reordered in place; counts: int32[rows]; ccc:
// uint8[ccc_size], 16-byte aligned (a codepoint past it takes its last entry).
extern "C" int sw_nf_reorder_rows(void* data, const void* counts, int64_t rows, int64_t width, const void* ccc,
                                  int64_t ccc_size, void* stream) {
  if (rows <= 0 || width <= 0 || width >= (int64_t{1} << 31) || ccc_size <= 0 || ccc_size >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = swt::kReorderThreads / 32 * swt::kReorderRows;
  // Rows of another width or alignment (none on the suites' paths) are read
  // 4 bytes a load, with the registers of 2 blocks an SM.
  const auto kernel = width % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0
                          ? swt::nf_reorder_kernel<true, swt::kReorderRows, swt::kReorderMinBlocks>
                          : swt::nf_reorder_kernel<false, swt::kReorderRows, 2>;
  const int grid = swt::resident_grid(kernel, 0, (rows + per_block - 1) / per_block, swt::kReorderThreads);
  kernel<<<grid, swt::kReorderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), rows, width, static_cast<const uint8_t*>(ccc),
      static_cast<int32_t>(ccc_size));
  return static_cast<int>(cudaGetLastError());
}

// data: int32[rows, width], composed in place; counts: int32[rows]; kept:
// int32[rows] out; classes: uint8[classes_size], 16-byte aligned, the ccc
// table with the class-0 second elements marked kCombiner (a codepoint past
// it takes its last entry); s_rank, c_rank: int32 rank maps; dense:
// int32[n_s * n_c] primary composites by rank.
extern "C" int sw_nf_compose_rows(void* data, const void* counts, void* kept, int64_t rows, int64_t width, const void* classes,
                                  int64_t classes_size, const void* s_rank, int64_t s_size, const void* c_rank, int64_t c_size,
                                  const void* dense, int64_t n_c, void* stream) {
  if (rows <= 0 || width <= 0 || classes_size <= 0 || s_size <= 0 || c_size <= 0 || n_c <= 0 || width >= (int64_t{1} << 31) ||
      classes_size >= (int64_t{1} << 31) || s_size >= (int64_t{1} << 31) || c_size >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Rows of another width or alignment are read 4 bytes a load.
  const auto kernel = width % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0
                          ? swt::nf_compose_kernel<true>
                          : swt::nf_compose_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(swt::kComposeShared));
  const int64_t rows_a_block = swt::kComposeWarps * (32 / swt::kComposeLanes);
  const int grid = swt::resident_grid(kernel, swt::kComposeShared, (rows + rows_a_block - 1) / rows_a_block, swt::kComposeThreads);
  kernel<<<grid, swt::kComposeThreads, swt::kComposeShared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), static_cast<int32_t*>(kept), rows, width,
      static_cast<const uint8_t*>(classes), static_cast<int32_t>(classes_size), static_cast<const int32_t*>(s_rank),
      static_cast<int32_t>(s_size), static_cast<const int32_t*>(c_rank), static_cast<int32_t>(c_size),
      static_cast<const int32_t*>(dense), static_cast<int32_t>(n_c));
  return static_cast<int>(cudaGetLastError());
}
