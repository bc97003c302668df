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
// ccc). One thread a row, in place: a stable insertion sort, a codepoint of
// ccc c moving left past those of ccc greater than c; a codepoint of ccc 0
// stops it. A row of text is mostly starters: one load and one ccc lookup a
// codepoint. Bound: the bytes, 4 a live codepoint read (and written where it
// moves). A run of k marks costs up to k^2 / 2 moves.
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

__global__ void __launch_bounds__(kThreads)
nf_reorder_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int64_t rows, int64_t width,
                  const uint8_t* __restrict__ ccc, int32_t ccc_size) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  int32_t* row = data + r * width;
  const int64_t n = min(static_cast<int64_t>(__ldg(counts + r)), width);
  for (int64_t i = 1; i < n; ++i) {
    const int32_t x = row[i];
    const int32_t c = __ldg(ccc + clamped(x, ccc_size));
    if (c == 0) continue;
    int64_t j = i;
    while (j > 0) {
      const int32_t y = row[j - 1];
      if (__ldg(ccc + clamped(y, ccc_size)) <= c) break;
      row[j] = y;
      --j;
    }
    if (j != i) row[j] = x;
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
// uint8[ccc_size].
extern "C" int sw_nf_reorder_rows(void* data, const void* counts, int64_t rows, int64_t width, const void* ccc,
                                  int64_t ccc_size, void* stream) {
  if (rows <= 0 || width <= 0 || ccc_size <= 0 || ccc_size >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + swt::kThreads - 1) / swt::kThreads;
  swt::nf_reorder_kernel<<<static_cast<unsigned>(blocks), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
