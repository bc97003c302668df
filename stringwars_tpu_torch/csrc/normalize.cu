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
// scatter to compact. One thread a row, in place: the walk carries the
// starter, the slot where it was written and the ccc of the last kept
// codepoint; a codepoint not blocked from the starter (the last ccc 0 or
// below its own) that composes with it (Hangul L+V and LV+T by arithmetic,
// else the primary composite of the dense [n_s, n_c] table at the two
// codepoints' ranks) replaces the starter in its slot and is dropped; every
// other codepoint is kept at the row's next slot. Writes never pass the
// read position, so the row is its own output; the slots past the kept
// count are zeroed. Bound: the bytes, 4 a live codepoint read and written.
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

__global__ void __launch_bounds__(kThreads)
nf_compose_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int32_t* __restrict__ kept,
                  int64_t rows, int64_t width, const uint8_t* __restrict__ ccc, int32_t ccc_size,
                  const int32_t* __restrict__ s_rank, int32_t s_size, const int32_t* __restrict__ c_rank, int32_t c_size,
                  const int32_t* __restrict__ dense, int32_t n_c) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  int32_t* row = data + r * width;
  const int64_t n = min(static_cast<int64_t>(__ldg(counts + r)), width);
  int32_t starter = -1, last_cc = 0;
  int64_t slot = 0, out = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cp = row[i];
    const int32_t c = __ldg(ccc + clamped(cp, ccc_size));
    int32_t composed = -1;
    if (starter >= 0 && (last_cc == 0 || last_cc < c)) {
      if (starter >= kLBase && starter < kLBase + kLCount && cp >= kVBase && cp < kVBase + kVCount) {
        composed = kSBase + ((starter - kLBase) * kVCount + (cp - kVBase)) * kTCount;
      } else if (starter >= kSBase && starter < kSBase + kSCount && (starter - kSBase) % kTCount == 0 && cp > kTBase &&
                 cp < kTBase + kTCount) {
        composed = starter + (cp - kTBase);
      } else {
        const int32_t pair = __ldg(dense + __ldg(s_rank + clamped(starter, s_size)) * n_c + __ldg(c_rank + clamped(cp, c_size)));
        if (pair > 0) composed = pair;
      }
    }
    if (composed >= 0) {
      starter = composed;
      row[slot] = composed;
    } else {
      if (c == 0) {
        starter = cp;
        slot = out;
        last_cc = 0;
      } else {
        last_cc = c;
      }
      row[out++] = cp;
    }
  }
  for (int64_t i = out; i < n; ++i) row[i] = 0;
  kept[r] = static_cast<int32_t>(out);
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
// int32[rows] out; ccc: uint8[ccc_size]; s_rank, c_rank: int32 rank maps;
// dense: int32[n_s * n_c] primary composites by rank.
extern "C" int sw_nf_compose_rows(void* data, const void* counts, void* kept, int64_t rows, int64_t width, const void* ccc,
                                  int64_t ccc_size, const void* s_rank, int64_t s_size, const void* c_rank, int64_t c_size,
                                  const void* dense, int64_t n_c, void* stream) {
  if (rows <= 0 || width <= 0 || ccc_size <= 0 || s_size <= 0 || c_size <= 0 || n_c <= 0 || ccc_size >= (int64_t{1} << 31) ||
      s_size >= (int64_t{1} << 31) || c_size >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (rows + swt::kThreads - 1) / swt::kThreads;
  swt::nf_compose_kernel<<<static_cast<unsigned>(blocks), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), static_cast<int32_t*>(kept), rows, width,
      static_cast<const uint8_t*>(ccc), static_cast<int32_t>(ccc_size), static_cast<const int32_t*>(s_rank),
      static_cast<int32_t>(s_size), static_cast<const int32_t*>(c_rank), static_cast<int32_t>(c_size),
      static_cast<const int32_t*>(dense), static_cast<int32_t>(n_c));
  return static_cast<int>(cudaGetLastError());
}
