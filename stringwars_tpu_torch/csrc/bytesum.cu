// K1 · bytesum: the exact sum of n bytes, the card's own bandwidth probe.
//
// Replaces the TPU kernel stringwars_tpu/ops/bytesum.py::_bytesum_kernel
// (reached through _bytesum_words_pallas / bytesum_words_pallas).
//
// What bounds it: one read of n bytes from device memory; the arithmetic is
// four dp4a per 16 bytes. The design keeps the read at full width: a
// grid-stride loop of 16-byte vector loads, four in flight per thread, with
// only the unaligned head and the tail read byte by byte; per-thread 64-bit
// accumulators, a warp-shuffle + shared-memory block reduction, and one
// 64-bit atomicAdd per block. Exact for n < 2^64 / 255 bytes, so the TPU
// kernel's two-tier 16-bit-limb arithmetic is not needed.
//
// The TPU kernel also XORed a salt into every word. That salt only kept a
// remote TPU runtime from serving repeated identical calls from a cache
// (the chained-loop timing protocol); a local card runs every launch, so
// the salt is dropped.
#include "common.cuh"

namespace swt {

__device__ __forceinline__ uint32_t sum16(uint4 v) {
  // dp4a against 0x01010101 adds the four bytes of a word.
  uint32_t s = __dp4a(v.x, 0x01010101u, 0u);
  s = __dp4a(v.y, 0x01010101u, s);
  s = __dp4a(v.z, 0x01010101u, s);
  return __dp4a(v.w, 0x01010101u, s);
}

__global__ void __launch_bounds__(kThreads)
bytesum_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t head,
               unsigned long long* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t vectors = (n - head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(data + head);

  unsigned long long acc = 0;
  int64_t i = tid;
  for (; i + 3 * stride < vectors; i += 4 * stride) {
    const uint4 a = __ldg(body + i), b = __ldg(body + i + stride);
    const uint4 c = __ldg(body + i + 2 * stride), d = __ldg(body + i + 3 * stride);
    acc += sum16(a) + sum16(b) + sum16(c) + sum16(d);
  }
  for (; i < vectors; i += stride) acc += sum16(__ldg(body + i));

  const int64_t tail = head + (vectors << 4);  // fewer than 16 bytes remain
  if (tid < head) acc += data[tid];
  if (tid < n - tail) acc += data[tail + tid];

  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc) atomicAdd(out, acc);
}

}  // namespace swt

// out: one zeroed 64-bit word on the device; the sum is added into it.
extern "C" int sw_bytesum(const void* data, int64_t n, void* out, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const int64_t head = swt::unaligned_head(bytes, n);
  const int blocks = swt::stream_blocks((n - head) >> 4);
  swt::bytesum_kernel<<<blocks, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bytes, n, head, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
