// Shared pieces of the port's CUDA kernels: block size, block reductions,
// and the launch geometry of the streaming kernels.
//
// Every C entry point takes raw pointers, 64-bit sizes and the caller's
// stream, launches without synchronizing, and returns cudaGetLastError()
// so the Python wrapper can raise on a launch that CUDA refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace swt {

constexpr int kThreads = 256;  // every kernel runs 8 warps per block
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Sum of one value per thread over a kThreads block; valid in thread 0.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) v = warp_sum(lane < kThreads / 32 ? partial[lane] : 0ull);
  return v;
}

// Max of one value per thread over a kThreads block; valid in thread 0.
__device__ __forceinline__ long long block_max(long long v) {
  __shared__ long long partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = -1;
  if (warp == 0) v = warp_max(lane < kThreads / 32 ? partial[lane] : -1ll);
  return v;
}

// Bytes before the first 16-byte boundary of `data` (at most n): the
// streaming kernels read those and the ragged tail byte by byte, and the
// aligned body as uint4.
inline int64_t unaligned_head(const void* data, int64_t n) {
  const int64_t head = (16 - (reinterpret_cast<uintptr_t>(data) & 15)) & 15;
  return head < n ? head : n;
}

// Grid of a grid-stride streaming kernel over `vectors` uint4 loads:
// enough blocks to fill every SM, no more than there is work for.
inline int stream_blocks(int64_t vectors) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (vectors + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// Blocks of kThreads to launch for a grid-stride kernel (the chunk scans of
// ahocorasick.cu and shiftand.cu): enough to fill every SM at the kernel's
// occupancy with `smem` bytes of dynamic shared memory, no more than `want`.
template <typename Kernel>
inline int resident_grid(Kernel kernel, size_t smem, int64_t want) {
  int device = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// Walks hay[w, end) (w 16-byte aligned, end - w a multiple of 32) in
// 32-byte batches, one full sector per thread, calling step16 on each
// 16-byte vector: the next batch's loads start before the current batch is
// walked, so a thread whose steps form a dependent chain (the chunk scans
// of ahocorasick.cu and shiftand.cu) keeps two batches in flight.
template <class Step16>
__device__ __forceinline__ void scan_batches(const uint8_t* __restrict__ hay, int64_t w, int64_t end, Step16 step16) {
  if (w >= end) return;
  const uint4* p = reinterpret_cast<const uint4*>(hay + w);
  const int64_t batches = (end - w) >> 5;
  uint4 a = __ldg(p), b = __ldg(p + 1);
  for (int64_t i = 1; i < batches; ++i) {
    const uint4 c = __ldg(p + 2 * i), d = __ldg(p + 2 * i + 1);
    step16(a);
    step16(b);
    a = c;
    b = d;
  }
  step16(a);
  step16(b);
}

}  // namespace swt
