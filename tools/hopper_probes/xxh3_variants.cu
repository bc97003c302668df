// The earlier XXH3-64 kernel (one thread a token, a token's row read at its
// width apart from its neighbours', byte loads where unaligned) and the
// package's kernel (stringwars_tpu_torch/csrc/xxh3.cu) at other blocks an
// SM, and its step over tokens of 0..16 bytes taken apart (probe::
// short_kernel), kept for measurement only: tools/hopper_probes.py xxh3
// times them on the same tokens and keys. Nothing of the package calls
// them. The earlier kernel reads the empty input's digest from the key
// words, as the package now passes them.
#include "../../stringwars_tpu_torch/csrc/xxh3.cu"

namespace parent {
using swt::kThreads;

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
    return k.flips[0];  // the package's key words now hold the empty input's digest itself
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
parent_xxh3_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t width, const int32_t* __restrict__ lengths,
            const Xxh3Keys keys, uint64_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int32_t len = __ldg(lengths + r);
  const uint64_t n = static_cast<uint64_t>(len < 0 ? 0 : (len > width ? width : len));
  out[r] = xxh3_one(data + r * width, n, keys);
}

}  // namespace parent

// data: uint8[rows, width]; lengths: int32[rows], each at most width;
// keys: the host's ops/xxh3.secret_words(seed), KEY_WORDS u64 in the order
// of Xxh3Keys; out: uint64[rows].
extern "C" int xxh3_parent_run(const void* data, int64_t rows, int64_t width, const void* lengths, const void* keys,
                          void* out, void* stream) {
  if (rows <= 0 || width <= 0 || keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  parent::Xxh3Keys k;
  memcpy(&k, keys, sizeof(k));
  const int64_t blocks = (rows + swt::kThreads - 1) / swt::kThreads;
  parent::parent_xxh3_kernel<<<static_cast<unsigned>(blocks), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), rows, width, static_cast<const int32_t*>(lengths), k,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The package's kernel at the variant's blocks an SM (3 + variant), over
// spans where offsets is given, else over rows.
extern "C" int xxh3_variant_run(int64_t variant, const void* data, int64_t end, const void* offsets, const void* lengths,
                                int64_t width, int64_t count, const void* keys, void* out, void* stream) {
  if (count <= 0 || keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  swt::Xxh3Keys k;
  memcpy(&k, keys, sizeof(k));
  const auto launch = [&](auto kernel) {
    const int grid = swt::resident_grid(kernel, 0, (count + swt::kThreads - 1) / swt::kThreads);
    kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), end, static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(lengths),
        width, count, k, static_cast<uint64_t*>(out));
  };
  const bool spans = offsets != nullptr;
  switch (variant) {
    case 0: spans ? launch(swt::xxh3_kernel<true, 3>) : launch(swt::xxh3_kernel<false, 3>); break;
    case 1: spans ? launch(swt::xxh3_kernel<true, 4>) : launch(swt::xxh3_kernel<false, 4>); break;
    case 2: spans ? launch(swt::xxh3_kernel<true, 5>) : launch(swt::xxh3_kernel<false, 5>); break;
    case 3: spans ? launch(swt::xxh3_kernel<true, 6>) : launch(swt::xxh3_kernel<false, 6>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace probe {

// The package kernel's quick step over the tape's spans, a lane kPer
// tokens a step (32 apart): kMode 0 hashes the tokens of 0..16 bytes
// (longer ones are left out), 1 loads their words and writes their XOR (no
// hashing), 2 hashes words made from the offsets (no word loads), 3 loads
// the offsets alone and writes each length, 4 hashes words and lengths made
// from the token index (no loads at all).
template <int kMode, int kPer>
__global__ void __launch_bounds__(swt::kThreads, 4)
short_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets, int64_t count,
             const __grid_constant__ swt::Xxh3Keys keys, uint64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * swt::kThreads * kPer;
  const swt::Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  const auto span = [&](int64_t t, int64_t& start, int64_t& n) {
    if (kMode == 4) {
      start = t * 6;
      n = t % 17;
      return;
    }
    start = t <= count ? __ldg(offsets + t) : 0;
    int64_t next = __shfl_down_sync(swt::kFull, start, 1);
    if (lane == 31 && t < count) next = __ldg(offsets + t + 1);
    n = t < count ? next - start : 0;
  };
  int64_t first = (static_cast<int64_t>(blockIdx.x) * (swt::kThreads / 32) + (threadIdx.x >> 5)) * 32 * kPer;
  int64_t start[kPer], n[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    start[j] = n[j] = 0;
    if (first < count) span(first + 32 * j + lane, start[j], n[j]);
  }
  for (; first < count; first += stride) {
    int64_t next_start[kPer], next_n[kPer];
    uint64_t w0[kPer], w1[kPer], w2[kPer];
    bool quick[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      next_start[j] = next_n[j] = 0;
      if (first + stride < count) span(first + stride + 32 * j + lane, next_start[j], next_n[j]);
      const uintptr_t p = x.lo + static_cast<uintptr_t>(start[j]);
      const uint64_t len = static_cast<uint64_t>(n[j]);
      const int off = static_cast<int>(p & 7);
      quick[j] = first + 32 * j + lane < count && len <= 16 && (kMode == 4 || swt::inside(p, len, x));
      if (kMode == 2 || kMode == 4) {
        w0[j] = p * 0x9E3779B97F4A7C15ull;
        w1[j] = w0[j] ^ (w0[j] >> 29);
        w2[j] = w1[j] * 0x9E3779B97F4A7C15ull;
      } else if (kMode != 3) {
        w0[j] = quick[j] && len ? swt::word<false>(p - off, x) : 0;
        w1[j] = quick[j] && off + len > 8 ? swt::word<false>(p - off + 8, x) : 0;
        w2[j] = quick[j] && off + len > 16 ? swt::word<false>(p - off + 16, x) : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t t = first + 32 * j + lane;
      const uint64_t len = static_cast<uint64_t>(n[j]);
      const int off = static_cast<int>((x.lo + static_cast<uintptr_t>(start[j])) & 7);
      if (quick[j]) {
        out[t] = kMode == 3 ? len : kMode == 1 ? w0[j] ^ w1[j] ^ w2[j] ^ len : swt::xxh3_0to16(w0[j], w1[j], w2[j], off, len, keys);
      }
      start[j] = next_start[j];
      n[j] = next_n[j];
    }
  }
}

}  // namespace probe

// probe::short_kernel<mode, per> over the spans (the tokens over 16 bytes are not written).
extern "C" int xxh3_short_run(int64_t mode, int64_t per, const void* data, int64_t end, const void* offsets, int64_t count,
                              const void* keys, void* out, void* stream) {
  if (count <= 0 || keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  swt::Xxh3Keys k;
  memcpy(&k, keys, sizeof(k));
  const auto launch = [&](auto kernel, int per_lane) {
    const int grid = swt::resident_grid(kernel, 0, (count + swt::kThreads * per_lane - 1) / (swt::kThreads * per_lane));
    kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), end, static_cast<const int64_t*>(offsets), count, k, static_cast<uint64_t*>(out));
  };
  switch (mode * 10 + per) {
    case 1: launch(probe::short_kernel<0, 1>, 1); break;
    case 2: launch(probe::short_kernel<0, 2>, 2); break;
    case 11: launch(probe::short_kernel<1, 1>, 1); break;
    case 21: launch(probe::short_kernel<2, 1>, 1); break;
    case 22: launch(probe::short_kernel<2, 2>, 2); break;
    case 31: launch(probe::short_kernel<3, 1>, 1); break;
    case 41: launch(probe::short_kernel<4, 1>, 1); break;
    case 42: launch(probe::short_kernel<4, 2>, 2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
