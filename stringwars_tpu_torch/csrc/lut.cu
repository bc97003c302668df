// K12 · LUT translate: out[i] = lut[data[i]] for a 256-entry byte table.
//
// Replaces the XLA function stringwars_tpu/ops/memops.py::lut_translate
// (:35; a gather on the CPU, the select-plane form lut_translate_planes on
// the TPU, whose u8 gathers run near-scalar). A GPU gathers from shared
// memory at full speed, so the select planes are not ported.
//
// What bounds it on an H100: one read and one write of every byte (128 MB
// each way, about 80 us at 3.35 TB/s). The design: the table is staged in
// shared memory as one 32-bit word per entry, so a lookup is one shared
// load; a grid-stride loop reads and writes 16-byte vectors (16 lookups
// each), and the unaligned head and the ragged tail are translated byte by
// byte. Input and output must share their offset within 16 bytes, which the
// wrapper arranges when it allocates the output.
#include "common.cuh"

namespace swt {

__device__ __forceinline__ uint32_t translate_word(const uint32_t* table, uint32_t w) {
  return table[w & 0xFF] | table[(w >> 8) & 0xFF] << 8 | table[(w >> 16) & 0xFF] << 16 | table[w >> 24] << 24;
}

__global__ void __launch_bounds__(kThreads)
lut_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t n, int64_t head,
           const uint8_t* __restrict__ lut) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = lut[i];
  __syncthreads();

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t vectors = (n - head) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(in + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  for (int64_t i = tid; i < vectors; i += stride) {
    const uint4 v = __ldg(src + i);
    dst[i] = make_uint4(translate_word(table, v.x), translate_word(table, v.y), translate_word(table, v.z),
                        translate_word(table, v.w));
  }
  const int64_t tail = head + (vectors << 4);  // fewer than 16 bytes remain
  if (tid < head) out[tid] = static_cast<uint8_t>(table[in[tid]]);
  if (tid < n - tail) out[tail + tid] = static_cast<uint8_t>(table[in[tail + tid]]);
}

}  // namespace swt

// out[i] = lut[data[i]] for i < n; data and out share their address mod 16.
extern "C" int sw_lut_translate(const void* data, int64_t n, const void* lut, void* out, void* stream) {
  if ((reinterpret_cast<uintptr_t>(data) & 15) != (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bytes = static_cast<const uint8_t*>(data);
  const int64_t head = swt::unaligned_head(bytes, n);
  const int blocks = swt::stream_blocks((n - head) >> 4);
  swt::lut_kernel<<<blocks, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bytes, static_cast<uint8_t*>(out), n, head, static_cast<const uint8_t*>(lut));
  return static_cast<int>(cudaGetLastError());
}
