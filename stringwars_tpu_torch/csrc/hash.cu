// K3 · per-token hashes: XXH64, and the XXH32 core behind xxh32 and swh64.
//
// Replaces the TPU kernel stringwars_tpu/ops/hash_pallas.py::xxh64_stripes
// (_make_kernel: the XXH64 stripe loop, with the merge, tail and avalanche
// left to a jnp epilogue) and the XLA functions of stringwars_tpu/ops/hash.py
// that carry the headline rows: xxh64 (:254, epilogue :288), xxh32 (:179),
// swh64 (:504, over _xxh32_core :450 and _avalanche32 :495), their multiseed
// forms, and the level-0 pass of tree_hash64 (_tree_level :357).
//
// What bounds them on an H100: one read of the token bytes (131072 tokens of
// 1 KiB are 134 MB, about 40 us at 3.35 TB/s); the arithmetic is a few
// integer operations per 4- or 8-byte word. The design:
//
// - One thread hashes one token (a row of a padded [rows, stride] matrix),
//   the whole hash in one pass: stripes, merge, tail and avalanche, with no
//   split into kernel and epilogue. Native 64-bit integers replace the TPU's
//   u32 pairs. The tree level, few long chunks, gives each chunk four
//   threads, one per XXH64 lane (xxh64_tree_kernel says why).
// - Token-major rows, not the TPU's stripe-major [W4, B] transpose: a thread
//   reads its row 32 bytes at a time as two 16-byte loads, so every load
//   instruction of a warp fetches 32 whole 32-byte sectors and no byte is
//   fetched from device memory twice; no transposed copy of the corpus is
//   made. (The stripe-major layout would coalesce each load across the warp,
//   but costs a 2x-corpus staging pass; a later PR can measure the trade.)
// - k seeds per token in one pass (at most 8 per launch, more in groups):
//   each stripe is loaded once and feeds every seed's accumulators.
// - Tails read exactly the token's bytes, zero-padded to 4-byte words as
//   XXH32/XXH64 and swh64_ref specify. A padded row may be read up to its
//   stride; a tree chunk never past the buffer's end, so the flat tape needs
//   no padding copy.
#include "common.cuh"

namespace swt {

constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP64_2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP64_3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP64_4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP64_5 = 0x27D4EB2F165667C5ull;

constexpr uint32_t kP32_1 = 2654435761u;
constexpr uint32_t kP32_2 = 2246822519u;
constexpr uint32_t kP32_3 = 3266489917u;
constexpr uint32_t kP32_4 = 668265263u;
constexpr uint32_t kP32_5 = 374761393u;

// swh64's second lane: data words XORed with kSwhXor, seed_hi ^ kSwhGold.
constexpr uint32_t kSwhXor = 0x85EBCA77u;
constexpr uint32_t kSwhGold = 0x9E3779B9u;

constexpr int kMaxSeeds = 8;
struct Seeds {
  uint64_t v[kMaxSeeds];
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// t[i] for a small index known only at run time, without local memory.
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&t)[N], int i) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) v = (j == i) ? t[j] : v;
  return v;
}

// 32 bytes at p as eight little-endian words: two 16-byte loads when the
// rows are 16-byte aligned, byte loads otherwise.
template <bool kVec>
__device__ __forceinline__ void load32(const uint8_t* p, uint32_t (&w)[8]) {
  if (kVec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + 16));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = uint32_t(p[4 * j]) | uint32_t(p[4 * j + 1]) << 8 | uint32_t(p[4 * j + 2]) << 16 |
             uint32_t(p[4 * j + 3]) << 24;
    }
  }
}

// The r < 32 tail bytes at p as eight zero-padded words. `avail` bytes from
// p may be read (at least r).
template <bool kVec>
__device__ __forceinline__ void load_tail(const uint8_t* p, int r, int64_t avail, uint32_t (&t)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = 0;
  if (r == 0) return;
  if (kVec && avail >= 32) {
    load32<true>(p, t);
  } else if (kVec && r <= 16 && avail >= 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < r) t[i >> 2] |= uint32_t(p[i]) << (8 * (i & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int valid = min(max(r - 4 * j, 0), 4);
    t[j] &= valid == 4 ? 0xFFFFFFFFu : ((1u << (8 * valid)) - 1u);
  }
}

// Row `row` of a padded matrix: its start, its length (clamped to the
// stride) and how far it may be read (the stride).
struct Token {
  const uint8_t* p;
  int64_t len;
  int64_t limit;
};

__device__ __forceinline__ Token token_at(const uint8_t* data, int64_t row, int64_t stride,
                                          const int32_t* lengths) {
  const int64_t given = lengths[row];
  const int64_t len = given < 0 ? 0 : (given > stride ? stride : given);
  return {data + row * stride, len, stride};
}

// -- XXH64 --------------------------------------------------------------------

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t lane) {
  acc += lane * kP64_2;
  return rotl64(acc, 31) * kP64_1;
}

__device__ __forceinline__ uint64_t merge64(uint64_t h, uint64_t acc) {
  h ^= round64(0, acc);
  return h * kP64_1 + kP64_4;
}

__device__ __forceinline__ uint64_t finish64(const uint64_t (&acc)[4], uint64_t seed, int64_t len,
                                             const uint32_t (&t)[8]) {
  uint64_t h;
  if (len >= 32) {
    h = rotl64(acc[0], 1) + rotl64(acc[1], 7) + rotl64(acc[2], 12) + rotl64(acc[3], 18);
#pragma unroll
    for (int i = 0; i < 4; ++i) h = merge64(h, acc[i]);
  } else {
    h = seed + kP64_5;
  }
  h += static_cast<uint64_t>(len);
  const int r = static_cast<int>(len & 31);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < (r >> 3)) {
      h ^= round64(0, uint64_t(t[2 * k]) | uint64_t(t[2 * k + 1]) << 32);
      h = rotl64(h, 27) * kP64_1 + kP64_4;
    }
  }
  if (r & 4) {
    h ^= uint64_t(pick(t, 2 * (r >> 3))) * kP64_1;
    h = rotl64(h, 23) * kP64_2 + kP64_3;
  }
  const uint32_t last = pick(t, r >> 2);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < (r & 3)) {
      h ^= uint64_t((last >> (8 * j)) & 0xFF) * kP64_5;
      h = rotl64(h, 11) * kP64_1;
    }
  }
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  h ^= h >> 32;
  return h;
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
xxh64_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t stride, const int32_t* __restrict__ lengths,
             Seeds seeds, uint64_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const Token tok = token_at(data, row, stride, lengths);

  uint64_t acc[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t s = seeds.v[j];
    acc[j][0] = s + kP64_1 + kP64_2;
    acc[j][1] = s + kP64_2;
    acc[j][2] = s;
    acc[j][3] = s - kP64_1;
  }
  const int64_t stripes = tok.len >> 5;
#pragma unroll 4
  for (int64_t s = 0; s < stripes; ++s) {
    uint32_t w[8];
    load32<kVec>(tok.p + 32 * s, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint64_t lane = uint64_t(w[2 * i]) | uint64_t(w[2 * i + 1]) << 32;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j][i] = round64(acc[j][i], lane);
    }
  }
  uint32_t t[8];
  load_tail<kVec>(tok.p + 32 * stripes, static_cast<int>(tok.len & 31), tok.limit - 32 * stripes, t);
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * rows + row] = finish64(acc[j], seeds.v[j], tok.len, t);
}

// The tree level: XXH64 (seed 0) of each `chunk`-byte piece of n flat bytes.
// A 64 KiB chunk is 2048 stripes of serial work, and 128 MB holds only 2048
// chunks, so one thread per chunk leaves the card latency-bound. Here four
// threads share a chunk, one per XXH64 lane (the lanes are independent until
// the merge), each loading its 8 bytes of eight stripes ahead; the lanes
// meet by warp shuffles and the first thread finishes the hash.
template <bool kAligned8>
__global__ void __launch_bounds__(kThreads)
xxh64_tree_kernel(const uint8_t* __restrict__ data, int64_t chunks, int64_t chunk, int64_t n,
                  uint64_t* __restrict__ out) {
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = thread >> 2;
  const int lane = static_cast<int>(thread & 3);
  const bool live = row < chunks;  // dead threads still join the shuffles
  const int64_t start = live ? row * chunk : 0;
  const int64_t len = live ? (n - start < chunk ? n - start : chunk) : 0;  // the last chunk short
  const uint8_t* chunk_p = data + start;
  const int64_t stripes = len >> 5;

  uint64_t acc = lane == 0 ? kP64_1 + kP64_2 : lane == 1 ? kP64_2 : lane == 2 ? 0 : 0 - kP64_1;
  const uint8_t* p = chunk_p + 8 * lane;
  constexpr int kAhead = 8;
  int64_t s = 0;
  for (; s + kAhead <= stripes; s += kAhead) {
    uint64_t w[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const uint8_t* q = p + 32 * (s + i);
      if (kAligned8) {
        w[i] = __ldg(reinterpret_cast<const unsigned long long*>(q));
      } else {
        w[i] = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) w[i] |= uint64_t(q[b]) << (8 * b);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) acc = round64(acc, w[i]);
  }
  for (; s < stripes; ++s) {
    const uint8_t* q = p + 32 * s;
    uint64_t w = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) w |= uint64_t(q[b]) << (8 * b);
    acc = round64(acc, w);
  }
  uint64_t accs[4];
  const unsigned base = threadIdx.x & ~3u & 31u;
#pragma unroll
  for (int i = 0; i < 4; ++i) accs[i] = __shfl_sync(0xffffffffu, acc, base + i);
  if (!live || lane != 0) return;
  uint32_t t[8];
  load_tail<false>(chunk_p + 32 * stripes, static_cast<int>(len & 31), len - 32 * stripes, t);  // never past n
  out[row] = finish64(accs, 0, len, t);
}

// -- the XXH32 core: xxh32 (one lane) and swh64 (two lanes) --------------------

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t lane) {
  return rotl32(acc + lane * kP32_2, 13) * kP32_1;
}

// The XXH32 finish of one lane; `x` is the lane's per-word XOR.
__device__ __forceinline__ uint32_t finish32(const uint32_t (&acc)[4], uint32_t seed, int64_t len,
                                             const uint32_t (&tail)[4], uint32_t x) {
  uint32_t h = len >= 16 ? rotl32(acc[0], 1) + rotl32(acc[1], 7) + rotl32(acc[2], 12) + rotl32(acc[3], 18)
                         : seed + kP32_5;
  h += static_cast<uint32_t>(len);
  const int r = static_cast<int>(len & 15);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < (r >> 2)) h = rotl32(h + (tail[k] ^ x) * kP32_3, 17) * kP32_4;
  }
  const uint32_t last = pick(tail, r >> 2) ^ x;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < (r & 3)) h = rotl32(h + ((last >> (8 * j)) & 0xFF) * kP32_5, 11) * kP32_1;
  }
  h ^= h >> 15;
  h *= kP32_2;
  h ^= h >> 13;
  h *= kP32_3;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t avalanche_swh(uint32_t h) {
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// L lanes per seed: lane 0 is XXH32 under the seed's low word; for swh64,
// lane 1 runs over data words ^ kSwhXor under (seed >> 32) ^ kSwhGold.
template <int K, bool kSwh, bool kVec>
__global__ void __launch_bounds__(kThreads)
xxh32_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t stride, const int32_t* __restrict__ lengths,
             Seeds seeds, void* __restrict__ out) {
  constexpr int L = kSwh ? 2 : 1;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const Token tok = token_at(data, row, stride, lengths);

  uint32_t seed32[K][L];
  uint32_t acc[K][L][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t s = l == 0 ? static_cast<uint32_t>(seeds.v[j]) : static_cast<uint32_t>(seeds.v[j] >> 32) ^ kSwhGold;
      seed32[j][l] = s;
      acc[j][l][0] = s + kP32_1 + kP32_2;
      acc[j][l][1] = s + kP32_2;
      acc[j][l][2] = s;
      acc[j][l][3] = s - kP32_1;
    }
  }
  auto stripe = [&](uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
    const uint32_t w[4] = {w0, w1, w2, w3};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t x = l == 0 ? 0u : kSwhXor;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j][l][i] = round32(acc[j][l][i], w[i] ^ x);
      }
    }
  };
  const int64_t pairs = tok.len >> 5;  // two 16-byte stripes per 32-byte load
#pragma unroll 2
  for (int64_t s = 0; s < pairs; ++s) {
    uint32_t w[8];
    load32<kVec>(tok.p + 32 * s, w);
    stripe(w[0], w[1], w[2], w[3]);
    stripe(w[4], w[5], w[6], w[7]);
  }
  uint32_t t[8];
  load_tail<kVec>(tok.p + 32 * pairs, static_cast<int>(tok.len & 31), tok.limit - 32 * pairs, t);
  const bool odd = (tok.len & 16) != 0;  // one more whole stripe, then the tail in t[4..7]
  if (odd) stripe(t[0], t[1], t[2], t[3]);
  uint32_t tail[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tail[i] = odd ? t[4 + i] : t[i];

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t lo_lane = finish32(acc[j][0], seed32[j][0], tok.len, tail, 0u);
    if (kSwh) {
      const uint32_t hi_lane = finish32(acc[j][L - 1], seed32[j][L - 1], tok.len, tail, kSwhXor);
      const uint32_t hi = avalanche_swh(hi_lane + rotl32(lo_lane, 16) * kP32_3);
      const uint32_t lo = avalanche_swh(lo_lane ^ (rotl32(hi_lane, 13) * kP32_4));
      static_cast<uint64_t*>(out)[j * rows + row] = uint64_t(hi) << 32 | lo;
    } else {
      static_cast<uint32_t*>(out)[j * rows + row] = lo_lane;
    }
  }
}

// -- launch -------------------------------------------------------------------

template <int K>
void launch_xxh64(const uint8_t* data, int64_t rows, int64_t stride, const int32_t* lengths, const Seeds& seeds,
                  uint64_t* out, cudaStream_t stream, bool vec) {
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (vec) {
    xxh64_kernel<K, true><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  } else {
    xxh64_kernel<K, false><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  }
}

template <int K, bool kSwh>
void launch_xxh32(const uint8_t* data, int64_t rows, int64_t stride, const int32_t* lengths, const Seeds& seeds,
                  void* out, cudaStream_t stream, bool vec) {
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (vec) {
    xxh32_kernel<K, kSwh, true><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  } else {
    xxh32_kernel<K, kSwh, false><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  }
}

// Rows start 16-byte aligned: the stripes are read as 16-byte vectors.
inline bool rows_aligned(const void* data, int64_t stride) {
  return (reinterpret_cast<uintptr_t>(data) & 15) == 0 && (stride & 15) == 0;
}

// Seeds [first, first + count) of `seeds`, for one launch.
inline Seeds seed_group(const uint64_t* seeds, int64_t first, int count) {
  Seeds g{};
  for (int j = 0; j < count; ++j) g.v[j] = seeds[first + j];
  return g;
}

}  // namespace swt

#define SWT_SEED_SWITCH(count, CALL) \
  switch (count) {                   \
    case 1: CALL(1); break;          \
    case 2: CALL(2); break;          \
    case 3: CALL(3); break;          \
    case 4: CALL(4); break;          \
    case 5: CALL(5); break;          \
    case 6: CALL(6); break;          \
    case 7: CALL(7); break;          \
    default: CALL(8); break;         \
  }

// XXH64 of the rows of a padded matrix (row stride `stride`, int32 lengths)
// under k seeds (a host array), into out[k, rows].
extern "C" int sw_xxh64(const void* data, int64_t rows, int64_t stride, const void* lengths, const void* seeds,
                        int64_t k, void* out, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  auto* digests = static_cast<uint64_t*>(out);
  const bool vec = swt::rows_aligned(data, stride);
  for (int64_t first = 0; first < k; first += swt::kMaxSeeds) {
    const int count = static_cast<int>(k - first < swt::kMaxSeeds ? k - first : swt::kMaxSeeds);
    const swt::Seeds group = swt::seed_group(all, first, count);
    uint64_t* dst = digests + first * rows;
#define SWT_CALL(K) swt::launch_xxh64<K>(bytes, rows, stride, lens, group, dst, static_cast<cudaStream_t>(stream), vec)
    SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
  }
  return static_cast<int>(cudaGetLastError());
}

// The tree level: XXH64 (seed 0) of each `chunk`-byte piece of n flat bytes,
// [i*chunk, min((i+1)*chunk, n)), into out[chunks]; never reads past n.
extern "C" int sw_xxh64_tree(const void* data, int64_t chunks, int64_t chunk, int64_t n, void* out, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  auto* digests = static_cast<uint64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>((4 * chunks + swt::kThreads - 1) / swt::kThreads);
  if ((reinterpret_cast<uintptr_t>(data) & 7) == 0 && (chunk & 7) == 0) {
    swt::xxh64_tree_kernel<true><<<blocks, swt::kThreads, 0, s>>>(bytes, chunks, chunk, n, digests);
  } else {
    swt::xxh64_tree_kernel<false><<<blocks, swt::kThreads, 0, s>>>(bytes, chunks, chunk, n, digests);
  }
  return static_cast<int>(cudaGetLastError());
}

// XXH32 (swh = 0: out uint32[k, rows], each seed's low 32 bits) or swh64
// (swh = 1: out uint64[k, rows]) of the rows of a padded matrix.
extern "C" int sw_xxh32(const void* data, int64_t rows, int64_t stride, const void* lengths, const void* seeds,
                        int64_t k, int swh, void* out, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  const bool vec = swt::rows_aligned(data, stride);
  const int64_t item = swh ? 8 : 4;
  for (int64_t first = 0; first < k; first += swt::kMaxSeeds) {
    const int count = static_cast<int>(k - first < swt::kMaxSeeds ? k - first : swt::kMaxSeeds);
    const swt::Seeds group = swt::seed_group(all, first, count);
    void* dst = static_cast<uint8_t*>(out) + first * rows * item;
    const auto s = static_cast<cudaStream_t>(stream);
    if (swh) {
#define SWT_CALL(K) swt::launch_xxh32<K, true>(bytes, rows, stride, lens, group, dst, s, vec)
      SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
    } else {
#define SWT_CALL(K) swt::launch_xxh32<K, false>(bytes, rows, stride, lens, group, dst, s, vec)
      SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
    }
  }
  return static_cast<int>(cudaGetLastError());
}
