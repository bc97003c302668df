// K3 · XXH3-64 (xxHash v0.8) with a seed, one thread a token.
//
// Replaces stringwars_tpu/ops/xxh3.py::xxh3_64 (an XLA function: the JAX
// package has no Pallas kernel for it; the hash suite's headline row takes
// this kernel). The TPU version evaluates all four length paths branch-free
// on u32 lane pairs over a stripe-major layout and a staged window of each
// token's last 64 bytes; here a thread reads its row where it lies, at any
// byte offset, takes the one path its length selects, and computes in native
// 64-bit integers, __umul64hi giving the high half of the 128-bit products.
//
// The key words (the 0..16-byte paths' bitflips, kSecret's words at the
// middle paths' offsets with the seed added or subtracted, and the seeded
// secret's words at the long path's offsets, aligned or not) are derived
// from the public 192-byte kSecret on the host, once per seed
// (ops/xxh3.secret_words), and passed by value: the kernel's parameters lie
// in the constant bank, where every thread reads the same word at once.
//
// What bounds it on an H100: for the hash suite's words, the bytes (each
// token read once, 8 bytes written); the long path costs about 8 multiplies
// and 24 other operations a 64-byte stripe, far below the ALU rate. The
// rows are read by the thread that hashes them, 8 bytes a load where the
// address allows, so neighbouring threads read rows a width apart: a simple
// kernel, not a coalesced one.
#include <cstring>

#include "common.cuh"

namespace swt {

struct Xxh3Keys {
  uint64_t flips[5];     // len 0 (the seed folded in), 1..3, 4..8, 9..16 (lo, hi)
  uint64_t mid[16];      // (k[16i] + seed, k[16i + 8] - seed), i < 8
  uint64_t mid3[14];     // the same at 16j + 3, j < 7
  uint64_t last[2];      // the same at 119
  uint64_t stripes[24];  // the seeded secret's aligned words
  uint64_t tail[8];      // its words at 121 + 8i (the last stripe)
  uint64_t merge[8];     // its words at 11 + 8i (the merge)
};

constexpr uint64_t kP32_1 = 2654435761ull, kP32_2 = 2246822519ull, kP32_3 = 3266489917ull;
constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ull, kP64_2 = 0xC2B2AE3D27D4EB4Full, kP64_3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP64_4 = 0x85EBCA77C2B2AE63ull, kP64_5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t ld64(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 7) == 0) return __ldg(reinterpret_cast<const unsigned long long*>(p));
  if ((a & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    return static_cast<uint64_t>(__ldg(q)) | (static_cast<uint64_t>(__ldg(q + 1)) << 32);
  }
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v |= static_cast<uint64_t>(__ldg(p + k)) << (8 * k);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) v |= static_cast<uint32_t>(__ldg(p + k)) << (8 * k);
  return v;
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) | __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

__device__ __forceinline__ uint64_t fold64(uint64_t a, uint64_t b) { return (a * b) ^ __umul64hi(a, b); }

__device__ __forceinline__ uint64_t avalanche_xxh64(uint64_t h) {
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= 0x165667919E3779F9ull;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t mix16(const uint8_t* p, uint64_t key_lo, uint64_t key_hi) {
  return fold64(ld64(p) ^ key_lo, ld64(p + 8) ^ key_hi);
}

__device__ __forceinline__ void accumulate512(uint64_t (&acc)[8], const uint8_t* p, const uint64_t* key) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t value = ld64(p + 8 * i);
    const uint64_t mixed = value ^ key[i];
    acc[i ^ 1] += value;
    acc[i] += (mixed & 0xFFFFFFFFull) * (mixed >> 32);
  }
}

__device__ uint64_t xxh3_long(const uint8_t* p, uint64_t n, const Xxh3Keys& k) {
  uint64_t acc[8] = {kP32_3, kP64_1, kP64_2, kP64_3, kP64_4, kP32_2, kP64_5, kP32_1};
  const uint64_t stripes = (n - 1) / 64;  // whole stripes before the overlapping last one
  // Blocks of 16 stripes, each followed by a scramble, then the stripes of
  // the partial block: every key index is a constant, so the keys stay in
  // the parameter bank.
  uint64_t s = 0;
  for (; s + 16 <= stripes; s += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) accumulate512(acc, p + 64 * (s + j), k.stripes + j);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = (acc[i] ^ (acc[i] >> 47) ^ k.stripes[16 + i]) * kP32_1;
  }
#pragma unroll
  for (int j = 0; j < 15; ++j) {
    if (s + j < stripes) accumulate512(acc, p + 64 * (s + j), k.stripes + j);
  }
  accumulate512(acc, p + n - 64, k.tail);
  uint64_t result = n * kP64_1;
#pragma unroll
  for (int i = 0; i < 4; ++i) result += fold64(acc[2 * i] ^ k.merge[2 * i], acc[2 * i + 1] ^ k.merge[2 * i + 1]);
  return avalanche(result);
}

__device__ uint64_t xxh3_one(const uint8_t* p, uint64_t n, const Xxh3Keys& k) {
  if (n <= 16) {
    if (n > 8) {
      const uint64_t lo = ld64(p) ^ k.flips[3], hi = ld64(p + n - 8) ^ k.flips[4];
      return avalanche(n + bswap64(lo) + hi + fold64(lo, hi));
    }
    if (n >= 4) {
      uint64_t x = (static_cast<uint64_t>(ld32(p + n - 4)) + (static_cast<uint64_t>(ld32(p)) << 32)) ^ k.flips[2];
      x ^= rotl64(x, 49) ^ rotl64(x, 24);
      x *= 0x9FB21C651E98DF25ull;
      x ^= (x >> 35) + n;
      x *= 0x9FB21C651E98DF25ull;
      return x ^ (x >> 28);
    }
    if (n > 0) {
      const uint32_t combined = (static_cast<uint32_t>(p[0]) << 16) | (static_cast<uint32_t>(p[n >> 1]) << 24) |
                                static_cast<uint32_t>(p[n - 1]) | (static_cast<uint32_t>(n) << 8);
      return avalanche_xxh64(static_cast<uint64_t>(combined) ^ k.flips[1]);
    }
    return avalanche_xxh64(k.flips[0]);
  }
  uint64_t acc = n * kP64_1;
  if (n <= 128) {
    if (n > 32) {
      if (n > 64) {
        if (n > 96) acc += mix16(p + 48, k.mid[12], k.mid[13]) + mix16(p + n - 64, k.mid[14], k.mid[15]);
        acc += mix16(p + 32, k.mid[8], k.mid[9]) + mix16(p + n - 48, k.mid[10], k.mid[11]);
      }
      acc += mix16(p + 16, k.mid[4], k.mid[5]) + mix16(p + n - 32, k.mid[6], k.mid[7]);
    }
    acc += mix16(p, k.mid[0], k.mid[1]) + mix16(p + n - 16, k.mid[2], k.mid[3]);
    return avalanche(acc);
  }
  if (n <= 240) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += mix16(p + 16 * i, k.mid[2 * i], k.mid[2 * i + 1]);
    acc = avalanche(acc);
    const int rounds = static_cast<int>(n / 16);
#pragma unroll
    for (int i = 8; i < 15; ++i) {
      if (i < rounds) acc += mix16(p + 16 * i, k.mid3[2 * (i - 8)], k.mid3[2 * (i - 8) + 1]);
    }
    acc += mix16(p + n - 16, k.last[0], k.last[1]);
    return avalanche(acc);
  }
  return xxh3_long(p, n, k);
}

__global__ void __launch_bounds__(kThreads)
xxh3_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t width, const int32_t* __restrict__ lengths,
            const Xxh3Keys keys, uint64_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int32_t len = __ldg(lengths + r);
  const uint64_t n = static_cast<uint64_t>(len < 0 ? 0 : (len > width ? width : len));
  out[r] = xxh3_one(data + r * width, n, keys);
}

}  // namespace swt

// data: uint8[rows, width]; lengths: int32[rows], each at most width;
// keys: the host's ops/xxh3.secret_words(seed), KEY_WORDS u64 in the order
// of Xxh3Keys; out: uint64[rows].
extern "C" int sw_xxh3_64(const void* data, int64_t rows, int64_t width, const void* lengths, const void* keys,
                          void* out, void* stream) {
  if (rows <= 0 || width <= 0 || keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  swt::Xxh3Keys k;
  memcpy(&k, keys, sizeof(k));
  const int64_t blocks = (rows + swt::kThreads - 1) / swt::kThreads;
  swt::xxh3_kernel<<<static_cast<unsigned>(blocks), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), rows, width, static_cast<const int32_t*>(lengths), k,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
