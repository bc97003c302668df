// Variants of the ChaCha20 keystream XOR (stringwars_tpu_torch/csrc/chacha.cu)
// for measurement only: which part of the kernel's time is the rounds and
// which the memory, and which of its parts pay. Built and timed by
// tools/hopper_probes.py chacha; nothing of the package calls it.
//
// Every variant takes n a multiple of 2,048 bytes and both buffers 16-byte
// aligned. Template parameters:
//   kFma    every add as an IMAD by a runtime 1 (as csrc/sha256.cu does)
//   kPrmt   rotations by 16 and 8 as byte permutes, else funnel shifts
//   kTiles  2 KiB warp tiles, the keystream through swizzled shared memory
//           and a persistent grid (the kernel's form), else one thread a
//           block with its four 16-byte vectors (the earlier form)
//   kRounds ChaCha rounds: 20, or fewer to leave the memory alone
//   kMem    the data loaded and stored; else made in registers and the
//           result folded into a value that is stored only if it hits a
//           key-dependent constant, so the rounds still run
//   kDirect the kernel's direct path (16-byte, 4-byte and byte forms) also
//           compiled into the kernel, never taken at these inputs
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

struct Key {
  uint32_t key[8];
  uint32_t nonce[3];
};

template <bool kFma>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t one) {
  if constexpr (kFma) return a * one + b; else return a + b;
}

template <bool kPrmt>
__device__ __forceinline__ uint32_t rot16(uint32_t x) {
  if constexpr (kPrmt) return __byte_perm(x, 0, 0x1032); else return __funnelshift_l(x, x, 16);
}

template <bool kPrmt>
__device__ __forceinline__ uint32_t rot8(uint32_t x) {
  if constexpr (kPrmt) return __byte_perm(x, 0, 0x2103); else return __funnelshift_l(x, x, 8);
}

template <bool kFma, bool kPrmt>
__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, uint32_t one) {
  a = add<kFma>(a, b, one); d = rot16<kPrmt>(d ^ a);
  c = add<kFma>(c, d, one); b = __funnelshift_l(b ^ c, b ^ c, 12);
  a = add<kFma>(a, b, one); d = rot8<kPrmt>(d ^ a);
  c = add<kFma>(c, d, one); b = __funnelshift_l(b ^ c, b ^ c, 7);
}

template <bool kFma, bool kPrmt, int kRounds>
__device__ __forceinline__ void block(const Key& k, uint32_t counter, uint32_t x[16], uint32_t one) {
  const uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u, k.key[0], k.key[1], k.key[2], k.key[3],
                          k.key[4], k.key[5], k.key[6], k.key[7], counter, k.nonce[0], k.nonce[1], k.nonce[2]};
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = s[i];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r % 2 == 0) {
      quarter<kFma, kPrmt>(x[0], x[4], x[8], x[12], one);
      quarter<kFma, kPrmt>(x[1], x[5], x[9], x[13], one);
      quarter<kFma, kPrmt>(x[2], x[6], x[10], x[14], one);
      quarter<kFma, kPrmt>(x[3], x[7], x[11], x[15], one);
    } else {
      quarter<kFma, kPrmt>(x[0], x[5], x[10], x[15], one);
      quarter<kFma, kPrmt>(x[1], x[6], x[11], x[12], one);
      quarter<kFma, kPrmt>(x[2], x[7], x[8], x[13], one);
      quarter<kFma, kPrmt>(x[3], x[4], x[9], x[14], one);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = add<kFma>(x[i], s[i], one);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) { return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w); }

__device__ __forceinline__ int ks_slot(int i) {
  const int b = i >> 2;
  return (b << 2) | ((i & 3) ^ ((b >> 1) & 3));
}

template <bool kFma, bool kPrmt, bool kTiles, int kRounds, bool kMem, bool kDirect>
__global__ void __launch_bounds__(256) chacha_variant(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                                      int64_t n, Key k, uint32_t counter0, uint32_t one) {
  const uint4* src = reinterpret_cast<const uint4*>(in);
  uint4* dst = reinterpret_cast<uint4*>(out);
  uint32_t acc = 0;
  if constexpr (!kTiles) {
    const int64_t blocks = n >> 6, stride = static_cast<int64_t>(gridDim.x) * 256;
    for (int64_t b = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; b < blocks; b += stride) {
      uint4 d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = kMem ? __ldg(src + 4 * b + q) : make_uint4(static_cast<uint32_t>(b), q, acc, 7);
      uint32_t x[16];
      block<kFma, kPrmt, kRounds>(k, counter0 + static_cast<uint32_t>(b), x, one);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 o = xor4(d[q], make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
        if constexpr (kMem) dst[4 * b + q] = o; else acc ^= o.x ^ o.y ^ o.z ^ o.w;
      }
    }
  } else {
    __shared__ uint4 tiles_s[8][128];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint4* tile = tiles_s[warp];
    const int64_t tiles = n / 2048, warps = static_cast<int64_t>(gridDim.x) * 8;
    int64_t t = static_cast<int64_t>(blockIdx.x) * 8 + warp;
    uint4 d[4];
    if (kMem && t < tiles) {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = __ldg(src + t * 128 + 32 * q + lane);
    }
    while (t < tiles) {
      const int64_t next = t + warps, ahead = next < tiles ? next : t;
      uint4 dn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kMem) {
          dn[q] = __ldg(src + ahead * 128 + 32 * q + lane);
        } else {
          d[q] = make_uint4(static_cast<uint32_t>(t), q, acc, 7);
          dn[q] = d[q];
        }
      }
      uint32_t x[16];
      block<kFma, kPrmt, kRounds>(k, counter0 + static_cast<uint32_t>(t * 32 + lane), x, one);
#pragma unroll
      for (int q = 0; q < 4; ++q) tile[ks_slot(4 * lane + q)] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 o = xor4(d[q], tile[ks_slot(32 * q + lane)]);
        if constexpr (kMem) dst[t * 128 + 32 * q + lane] = o; else acc ^= o.x ^ o.y ^ o.z ^ o.w;
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = dn[q];
      t = next;
    }
    if constexpr (kDirect) {
      const int64_t blocks = (n + 63) >> 6, stride = static_cast<int64_t>(gridDim.x) * 256;
      const int vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) ? 4 : 16;
      for (int64_t b = tiles * 32 + static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; b < blocks; b += stride) {
        const int64_t off = b << 6;
        uint32_t ks[16];
        if (off + 64 <= n && vec == 16) {
          uint4 v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(in + off) + q);
          block<kFma, kPrmt, kRounds>(k, counter0 + static_cast<uint32_t>(b), ks, one);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            reinterpret_cast<uint4*>(out + off)[q] = xor4(v[q], make_uint4(ks[4 * q], ks[4 * q + 1], ks[4 * q + 2], ks[4 * q + 3]));
          }
        } else if (off + 64 <= n && vec == 4) {
          uint32_t v[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = __ldg(reinterpret_cast<const uint32_t*>(in + off) + i);
          block<kFma, kPrmt, kRounds>(k, counter0 + static_cast<uint32_t>(b), ks, one);
#pragma unroll
          for (int i = 0; i < 16; ++i) reinterpret_cast<uint32_t*>(out + off)[i] = v[i] ^ ks[i];
        } else {
          block<kFma, kPrmt, kRounds>(k, counter0 + static_cast<uint32_t>(b), ks, one);
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            if (j < n - off) out[off + j] = in[off + j] ^ static_cast<uint8_t>(ks[j >> 2] >> (8 * (j & 3)));
          }
        }
      }
    }
  }
  if (!kMem && acc == (k.key[0] ^ 0x5bd1e995u)) out[threadIdx.x] = static_cast<uint8_t>(acc);
}

template <bool kFma, bool kPrmt, bool kTiles, int kRounds, bool kMem, bool kDirect>
int launch(const void* in, void* out, int64_t n, const Key& k, uint32_t counter, cudaStream_t stream) {
  const auto kernel = chacha_variant<kFma, kPrmt, kTiles, kRounds, kMem, kDirect>;
  int device = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, 0);
  const int64_t want = kTiles ? (n / 2048 + 7) / 8 : ((n >> 6) + 255) / 256;
  const int64_t cap = static_cast<int64_t>(sms) * (kTiles ? per_sm : 8);
  kernel<<<static_cast<int>(want < cap ? want : cap), 256, 0, stream>>>(static_cast<const uint8_t*>(in),
                                                                        static_cast<uint8_t*>(out), n, k, counter, 1u);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The variants, by number, as tools/hopper_probes.py names them.
extern "C" int chacha_variant_run(int64_t variant, const void* in, void* out, int64_t n, const void* key32,
                                  const void* nonce12, int64_t counter, void* stream) {
  if (n % 2048 != 0 || ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Key k;
  memcpy(k.key, key32, 32);
  memcpy(k.nonce, nonce12, 12);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<uint32_t>(counter);
  switch (variant) {  // <kFma, kPrmt, kTiles, kRounds, kMem, kDirect>
    case 0: return launch<false, false, false, 20, true, false>(in, out, n, k, c, s);
    case 1: return launch<false, false, false, 20, false, false>(in, out, n, k, c, s);
    case 2: return launch<false, false, false, 1, true, false>(in, out, n, k, c, s);
    case 3: return launch<true, false, false, 20, true, false>(in, out, n, k, c, s);
    case 4: return launch<false, false, true, 20, true, false>(in, out, n, k, c, s);
    case 5: return launch<false, true, true, 20, true, false>(in, out, n, k, c, s);
    case 6: return launch<true, true, true, 20, true, false>(in, out, n, k, c, s);
    case 7: return launch<false, true, true, 0, true, false>(in, out, n, k, c, s);
    case 8: return launch<false, true, true, 20, false, false>(in, out, n, k, c, s);
    case 9: return launch<false, true, true, 20, true, true>(in, out, n, k, c, s);
    case 10: return launch<true, true, true, 20, true, true>(in, out, n, k, c, s);
    case 11: return launch<false, false, true, 20, true, true>(in, out, n, k, c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
