// K10 · codepoint-window count: all (overlapping) matches of an m-codepoint
// needle in an int32 codepoint stream, the uncased find over a folded
// haystack.
//
// Replaces stringwars_tpu/ops/find_pallas.py::_make_cp_kernel (via
// cp_window_count): the number of window starts p <= n - m with
// stream[p:p+m] == needle. The TPU stages the stream into 8 overlapping rows
// with a 128-codepoint halo (stage_cp_rows) and compares every offset of the
// needle against a VMEM panel, so it takes needles of at most 129
// codepoints; here the halo and the needle are read from global memory past
// what shared memory holds, so any m >= 1 works.
//
// What bounds it on an H100: one read of the stream, 4 bytes a codepoint
// (73 M folded codepoints of the 128 MB multilingual corpus: 0.29 GB, about
// 0.09 ms at 3.35 TB/s). Design: a block stages a tile of 8,192 codepoints
// plus up to 512 of halo in shared memory with 16-byte loads, and the
// needle's first 512 codepoints; each thread tests its positions against
// the needle's first codepoint and checks the rest only on a hit, with an
// early exit. Counts reduce per block into one 64-bit atomicAdd.
#include "common.cuh"

namespace swt {

constexpr int kCpTile = 8192;     // window starts per tile
constexpr int kCpHaloCap = 512;   // halo codepoints staged in shared memory
constexpr int kCpNeedleCap = 512; // needle codepoints staged in shared memory

__global__ void __launch_bounds__(kThreads)
cp_window_kernel(const int32_t* __restrict__ s, int64_t n, const int32_t* __restrict__ needle, int64_t m,
                 int aligned, unsigned long long* __restrict__ count) {
  __shared__ __align__(16) int32_t tile[kCpTile + kCpHaloCap];
  __shared__ int32_t nd[kCpNeedleCap];
  const int64_t last = n - m;  // the last window start, >= 0
  const int halo = static_cast<int>(m - 1 < kCpHaloCap ? m - 1 : kCpHaloCap);
  const int staged_needle = static_cast<int>(m < kCpNeedleCap ? m : kCpNeedleCap);
  for (int j = threadIdx.x; j < staged_needle; j += kThreads) nd[j] = __ldg(needle + j);
  unsigned long long local = 0;
  const int64_t tiles = last / kCpTile + 1;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * kCpTile;
    const int avail = static_cast<int>(n - base < kCpTile + halo ? n - base : kCpTile + halo);
    __syncthreads();  // the previous tile is no longer read (and the needle is staged)
    int done = 0;
    if (aligned) {
      const int4* src = reinterpret_cast<const int4*>(s + base);
      int4* dst = reinterpret_cast<int4*>(tile);
      for (int q = threadIdx.x; q < avail / 4; q += kThreads) dst[q] = __ldg(src + q);
      done = avail & ~3;
    }
    for (int i = done + threadIdx.x; i < avail; i += kThreads) tile[i] = __ldg(s + base + i);
    __syncthreads();
    const int positions = static_cast<int>(last - base + 1 < kCpTile ? last - base + 1 : kCpTile);
    const int32_t head = nd[0];
    for (int i = threadIdx.x; i < positions; i += kThreads) {
      if (tile[i] != head) continue;
      bool ok = true;
      for (int64_t j = 1; ok && j < m; ++j) {
        const int32_t hv = i + j < kCpTile + halo ? tile[i + j] : __ldg(s + base + i + j);
        const int32_t nv = j < kCpNeedleCap ? nd[j] : __ldg(needle + j);
        ok = hv == nv;
      }
      local += ok;
    }
  }
  local = block_sum(local);
  if (threadIdx.x == 0 && local) atomicAdd(count, local);
}

}  // namespace swt

// stream: int32[n]; needle: int32[m], 1 <= m <= n; count: uint64[1],
// zeroed by the caller, gets the number of matches added.
extern "C" int sw_cp_window(const void* stream, int64_t n, const void* needle, int64_t m, void* count, void* s) {
  if (m < 1 || n < m) return static_cast<int>(cudaErrorInvalidValue);
  const auto* data = static_cast<const int32_t*>(stream);
  const int aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const int64_t tiles = (n - m) / swt::kCpTile + 1;
  const int grid = swt::resident_grid(swt::cp_window_kernel, 0, tiles);
  swt::cp_window_kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(s)>>>(
      data, n, static_cast<const int32_t*>(needle), m, aligned, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
