// K12 · counter-based random words: Threefry-2x32, bit-exact with
// jax.random.bits(PRNGKey(seed), (n,), uint32).
//
// Replaces the XLA function stringwars_tpu/ops/memops.py::fill_random_words
// (:104; jax.random.bits under jax_threefry_partitionable). Word i is
// x0 ^ x1 of Threefry-2x32 (20 rounds, Salmon et al. 2011; the rotation
// constants and key schedule of jax/_src/prng.py::_threefry2x32_lowering)
// under the key (seed >> 32, seed & 0xFFFFFFFF) at the counter
// (i >> 32, i & 0xFFFFFFFF).
//
// What bounds it on an H100: operations. A word takes 20 rounds of an add,
// a rotate and a xor (60), six key injections of two adds (12, the
// injected constants folded) and the final xor: 73 32-bit instructions
// against 4 bytes written; 32 Mi words (128 MiB) are 2.45 G instructions,
// 73 us at 33.4 T/s, against the write's 40 us.
// The design: one thread per word, the state in registers, every round
// unrolled (rotations by constants are one funnel shift each), and each
// thread writes its own word, so a warp stores 128 contiguous bytes.
#include "common.cuh"

namespace swt {

__device__ __forceinline__ uint32_t rotl32_tf(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl32_tf(x1, R0) ^ x0;
  x0 += x1; x1 = rotl32_tf(x1, R1) ^ x0;
  x0 += x1; x1 = rotl32_tf(x1, R2) ^ x0;
  x0 += x1; x1 = rotl32_tf(x1, R3) ^ x0;
}

__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads)
threefry_kernel(uint32_t k0, uint32_t k1, int64_t n, uint32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    out[i] = threefry_word(k0, k1, static_cast<uint64_t>(i));
  }
}

}  // namespace swt

// out[i] = word i of Threefry-2x32 under the key (key0, key1), i < n.
extern "C" int sw_threefry_bits(int64_t key0, int64_t key1, int64_t n, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  swt::threefry_kernel<<<swt::stream_blocks(n), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(key0), static_cast<uint32_t>(key1), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
