// K2 · substring count / rfind over a flat haystack, for a batch of needles.
// K3 · byteset count: how many bytes of a haystack belong to a 256-entry set.
//
// K2 replaces the TPU kernel stringwars_tpu/ops/find_pallas.py::_make_kernel
// (reached through _count, _count_last and _count_batch). For every needle
// of the batch it counts the window starts p <= n - m with
// hay[p:p+m] == needle (overlapping matches count, as in the reference's
// all-matches loop); the rfind form also returns the largest such p, or -1.
//
// What bounds K2: the cycle workload (64 needles of 8 B over 128 MB) asks
// for 64 x 128 MB = 8.6 GB of haystack per call, and 128 MB does not fit
// the 50 MB L2. Blocks are therefore ordered needle-fastest: the blocks of
// one haystack tile for every needle run next to each other, so the tile
// comes from device memory about once and from L2 for the other needles.
// Past that, the bound is the per-window work on the SMs: 8.6 G windows
// per call. Design: a block stages its 16 KiB tile plus m-1 halo bytes (up
// to 1 KiB) and the needle's first 1 KiB in shared memory. Each thread
// takes groups of four window starts: two 32-bit shared-memory loads and a
// funnel shift give each window's first four bytes, one masked compare
// against the needle's head rejects almost every window, and only the rest
// are checked byte by byte with an early exit. All in-block indexing is
// 32-bit. A needle of any length works: bytes past the staged halo or
// needle prefix are read from global memory (L2), so there is no second
// path for long needles. Counts reduce per block and go out through one
// 64-bit atomicAdd, the last offset through atomicMax. Comparing several
// needles per staged tile is later work.
//
// The TPU kernel's staging (the haystack cut into [8, chunkw + 128]
// overlapping word rows, (8, 128) accumulator blocks, scalar-prefetched
// needle words, compares of every needle word with no early exit) existed
// for the TPU's tiling and sequential grid and is not carried over; of its
// four-offset word compare only the head filter above remains.
//
// K3 has no TPU kernel: the JAX package computes it in XLA
// (stringwars_tpu/ops/find.py::_byteset_member / byteset_count). What
// bounds it: one read of n bytes plus a table test per byte. Design: each
// block builds the 256-bit membership bitmap in shared memory from the
// 256-byte table (one __ballot_sync per warp), then streams 16-byte vector
// loads, four in flight per thread, tests each byte against the bitmap,
// and reduces a 64-bit count per block into one atomicAdd.
#include "common.cuh"

namespace swt {

constexpr int kTile = 16384;     // window starts per block
constexpr int kHaloCap = 1024;   // halo bytes staged in shared memory
constexpr int kNeedleCap = 1024; // needle bytes staged in shared memory

template <bool kLast>
__global__ void __launch_bounds__(kThreads)
find_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint8_t* __restrict__ needles,
            int64_t needle_stride, const int64_t* __restrict__ lengths, unsigned batch,
            unsigned long long* __restrict__ counts, long long* __restrict__ lasts) {
  // kHaloCap + 16 past the tile: the head test of the tile's last word
  // group reads one word beyond it even when the halo is short.
  __shared__ __align__(16) uint8_t tile[kTile + kHaloCap + 16];
  __shared__ uint8_t nd[kNeedleCap];

  const unsigned y = blockIdx.x % batch;  // needle: fastest-varying, see the note above
  const int64_t base = static_cast<int64_t>(blockIdx.x / batch) * kTile;
  const int64_t m = lengths[y];
  if (m <= 0 || base > n - m) return;  // no window of this tile counts; uniform across the block
  const uint8_t* needle = needles + y * needle_stride;
  // Window start base + k counts iff k <= limit (p <= n - m).
  const int limit = static_cast<int>(n - m - base < kTile ? n - m - base : kTile);

  // Stage the tile and its halo (bytes at or past n read as 0: no window
  // that can count reaches them) and the needle prefix.
  const int halo = static_cast<int>(m - 1 < kHaloCap ? m - 1 : kHaloCap);
  const int span = kTile + (halo > 16 ? halo : 16);
  for (int v = threadIdx.x; v < (span + 15) / 16; v += kThreads) {
    const int64_t g = base + 16 * v;
    uint4 word;
    if (g + 16 <= n) {
      word = __ldg(reinterpret_cast<const uint4*>(hay + g));
    } else {
      __align__(16) uint8_t b[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = g + k < n ? hay[g + k] : 0;
      word = *reinterpret_cast<const uint4*>(b);
    }
    reinterpret_cast<uint4*>(tile)[v] = word;
  }
  const int staged = static_cast<int>(m < kNeedleCap ? m : kNeedleCap);
  for (int j = threadIdx.x; j < staged; j += kThreads) nd[j] = needle[j];
  __syncthreads();

  // The needle's first four bytes as one little-endian word, and the mask
  // of those that exist (m < 4 compares fewer).
  const int head_len = m < 4 ? static_cast<int>(m) : 4;
  uint32_t head = 0, head_mask = 0;
  for (int i = 0; i < head_len; ++i) {
    head |= static_cast<uint32_t>(nd[i]) << (8 * i);
    head_mask |= 0xFFu << (8 * i);
  }

  // Thread t tests the four windows of word groups t, t + 256, ...: one
  // funnel shift of two shared-memory words gives the head of each window,
  // and only a window whose head matches goes on to the byte-by-byte check.
  const uint32_t* words = reinterpret_cast<const uint32_t*>(tile);
  unsigned count = 0;
  long long best = -1;
#pragma unroll 2
  for (int g = threadIdx.x; g < kTile / 4; g += kThreads) {
    const uint32_t lo = words[g], hi = words[g + 1];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int k = 4 * g + o;
      if (((__funnelshift_r(lo, hi, 8 * o) ^ head) & head_mask) != 0 || k > limit) continue;
      const int in_smem = staged < span - k ? staged : span - k;
      const int64_t lim = m < in_smem ? m : in_smem;
      int64_t j = head_len;
      while (j < lim && tile[k + j] == nd[j]) ++j;
      if (j == lim)  // everything staged matched: finish from global memory
        while (j < m && __ldg(hay + base + k + j) == __ldg(needle + j)) ++j;
      if (j == m) {
        ++count;
        best = base + k;
      }
    }
  }

  const unsigned long long total = block_sum(count);
  if (threadIdx.x == 0 && total) atomicAdd(counts + y, total);
  if constexpr (kLast) {
    best = block_max(best);
    if (threadIdx.x == 0 && best >= 0) atomicMax(lasts + y, best);
  }
}

__device__ __forceinline__ uint32_t member1(const uint32_t* bits, uint32_t b) {
  return (bits[b >> 5] >> (b & 31u)) & 1u;
}

__device__ __forceinline__ uint32_t member4(const uint32_t* bits, uint32_t w) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c += member1(bits, (w >> (8 * k)) & 0xFFu);
  return c;
}

__device__ __forceinline__ uint32_t member16(const uint32_t* bits, uint4 v) {
  return member4(bits, v.x) + member4(bits, v.y) + member4(bits, v.z) + member4(bits, v.w);
}

__global__ void __launch_bounds__(kThreads)
byteset_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t head,
               const uint8_t* __restrict__ table, unsigned long long* __restrict__ out) {
  __shared__ uint32_t bits[8];
  const uint32_t word = __ballot_sync(0xffffffffu, table[threadIdx.x] != 0);
  if ((threadIdx.x & 31) == 0) bits[threadIdx.x >> 5] = word;
  __syncthreads();

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t vectors = (n - head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(data + head);

  unsigned long long acc = 0;
  int64_t i = tid;
  for (; i + 3 * stride < vectors; i += 4 * stride) {
    const uint4 a = __ldg(body + i), b = __ldg(body + i + stride);
    const uint4 c = __ldg(body + i + 2 * stride), d = __ldg(body + i + 3 * stride);
    acc += member16(bits, a) + member16(bits, b) + member16(bits, c) + member16(bits, d);
  }
  for (; i < vectors; i += stride) acc += member16(bits, __ldg(body + i));

  const int64_t tail = head + (vectors << 4);
  if (tid < head) acc += member1(bits, data[tid]);
  if (tid < n - tail) acc += member1(bits, data[tail + tid]);

  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc) atomicAdd(out, acc);
}

}  // namespace swt

// hay: 16-byte aligned. needles: batch rows of needle_stride bytes, row y
// holding needle y's bytes; lengths: int64[batch] on the device.
// counts: zeroed int64[batch]; lasts: int64[batch] filled with -1, or null
// for the count-only form.
extern "C" int sw_find_count(const void* hay, int64_t n, const void* needles, int64_t needle_stride,
                             const void* lengths, int64_t batch, void* counts, void* lasts,
                             void* stream) {
  const int64_t tiles = n / swt::kTile + 1;
  const int64_t blocks = tiles * batch;
  if (batch <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto b = static_cast<unsigned>(batch);
  const auto grid = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* nd = static_cast<const uint8_t*>(needles);
  const auto* len = static_cast<const int64_t*>(lengths);
  auto* c = static_cast<unsigned long long*>(counts);
  if (lasts == nullptr) {
    swt::find_kernel<false><<<grid, swt::kThreads, 0, s>>>(h, n, nd, needle_stride, len, b, c, nullptr);
  } else {
    swt::find_kernel<true><<<grid, swt::kThreads, 0, s>>>(h, n, nd, needle_stride, len, b, c,
                                                          static_cast<long long*>(lasts));
  }
  return static_cast<int>(cudaGetLastError());
}

// table: uint8[256] on the device, nonzero = member. out: one zeroed
// 64-bit word on the device; the count is added into it.
extern "C" int sw_byteset_count(const void* data, int64_t n, const void* table, void* out,
                                void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const int64_t head = swt::unaligned_head(bytes, n);
  const int blocks = swt::stream_blocks((n - head) >> 4);
  swt::byteset_kernel<<<blocks, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bytes, n, head, static_cast<const uint8_t*>(table), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
