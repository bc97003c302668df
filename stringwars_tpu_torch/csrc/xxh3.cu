// K3 · XXH3-64 (xxHash v0.8) with a seed, over tokens where they lie.
//
// Replaces stringwars_tpu/ops/xxh3.py::xxh3_64 (an XLA function: the JAX
// package has no Pallas kernel for it; the hash suite's headline row takes
// this kernel). The TPU version evaluates all four length paths branch-free
// on u32 lane pairs over a stripe-major layout of padded rows and a staged
// window of each token's last 64 bytes; here the tokens are read where they
// lie and each takes the one path its length selects, in native 64-bit
// integers, __umul64hi giving the high half of the 128-bit products.
//
// One kernel serves two layouts: spans (token i is data[offsets[i],
// offsets[i + 1]), the tape's own form) and rows (token i at data + i *
// width, of lengths[i] bytes, a PaddedTokens batch).
//
// What bounds it on an H100: the bytes, each token read once and its digest
// written (8 bytes), plus the offsets or lengths. On short tokens the
// arithmetic comes close: a warp's lanes take the 1..3, 4..8 and 9..16-byte
// paths one after another (30 to 45 instructions each, 64-bit multiplies),
// which on the hash suite's words issue about as long as the bytes take. A
// long token costs 8 multiplies and 24 other operations a 64-byte stripe.
// The design follows the bytes:
// - a token of 0..240 bytes is one lane's: a warp's lanes hash 32 tokens
//   that follow one another on the tape, so the warp reads one contiguous
//   stretch (about 32 x 6 bytes of words), a few sectors rather than one a
//   token. A lane reads the aligned 8-byte words that hold its token and
//   cuts its values out with funnel shifts: no byte loads. The next step's
//   offsets are loaded before this step's words, and a step whose tokens
//   and words all lie inside the buffer reads them with no check a lane.
// - a token over 240 bytes is a warp's: the warp ballots its long tokens and
//   takes them one after another; lanes 8s + i hold accumulator lane i of
//   stripe s, four stripes (one 256-byte coalesced load) a step, and the
//   accumulator's neighbour term acc[i ^ 1] += value is a __shfl_xor. Within
//   a 16-stripe block every update is an add mod 2^64, so the four stripes'
//   partial sums meet by shuffles before each scramble and before the
//   merge, exactly. A block's (or the partial block's and the last
//   stripe's) loads all start before the first is used.
// - no load passes the buffer [data, data + end): a token whose aligned
//   words might reach past either end (the last few of the buffer) takes
//   the guarded instance, which reads such a word byte by byte, its outside
//   bytes as 0 (a token's own bytes always lie inside).
//
// The key words (the empty input's digest and the 1..16-byte paths'
// bitflips, kSecret's words at the middle paths' offsets with the seed
// added or subtracted, and the seeded secret's words at the long path's
// offsets) are derived from the public 192-byte kSecret on the host, once
// per seed (ops/xxh3.secret_words), and passed by value as a
// __grid_constant__: the short paths index them with constants, the long
// path's lanes by lane, from the parameter bank at each use.
#include <cstring>

#include "common.cuh"
#include "spans.cuh"

namespace swt {

struct Xxh3Keys {
  uint64_t flips[5];     // the empty input's digest; the flips of 1..3, 4..8, 9..16 (lo, hi)
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
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) | __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

__device__ __forceinline__ uint64_t fold64(uint64_t a, uint64_t b) { return (a * b) ^ __umul64hi(a, b); }

__device__ __forceinline__ uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= 0x165667919E3779F9ull;
  return h ^ (h >> 32);
}

// 0..16 bytes from the aligned words w0:w1:w2 that hold them, the first
// `off` bytes into w0 (w1 read where off + n > 8, w2 where off + n > 16).
__device__ __forceinline__ uint64_t xxh3_0to16(uint64_t w0, uint64_t w1, uint64_t w2, int off, uint64_t n,
                                               const Xxh3Keys& k) {
  if (n == 0) return k.flips[0];
  const uint64_t t0 = funnel(w0, w1, off), t1 = funnel(w1, w2, off);  // the token's first 16 bytes
  if (n > 8) {
    const int s = static_cast<int>(n) - 8;
    const uint64_t lo = t0 ^ k.flips[3], hi = (s == 8 ? t1 : funnel(t0, t1, s)) ^ k.flips[4];
    return avalanche(n + bswap64(lo) + hi + fold64(lo, hi));
  }
  if (n >= 4) {
    const uint64_t first = static_cast<uint32_t>(t0), last = static_cast<uint32_t>(t0 >> (8 * (n - 4)));
    uint64_t v = (last + (first << 32)) ^ k.flips[2];
    v ^= rotl64(v, 49) ^ rotl64(v, 24);
    v *= 0x9FB21C651E98DF25ull;
    v ^= (v >> 35) + n;
    v *= 0x9FB21C651E98DF25ull;
    return v ^ (v >> 28);
  }
  const uint32_t head = static_cast<uint32_t>(t0);
  const uint32_t c1 = head & 0xFF, c2 = (head >> (8 * (n >> 1))) & 0xFF, c3 = (head >> (8 * (n - 1))) & 0xFF;
  uint64_t h = ((c1 << 16) | (c2 << 24) | c3 | (static_cast<uint32_t>(n) << 8)) ^ k.flips[1];
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  return h ^ (h >> 32);
}

// fold64 of the 16 bytes at p, each half XORed with its key.
template <bool kGuard>
__device__ __forceinline__ uint64_t mix16(uintptr_t p, uint64_t key_lo, uint64_t key_hi, const Extent& x) {
  const int s = static_cast<int>(p & 7);
  const uintptr_t w = p - s;
  const uint64_t a = word<kGuard>(w, x), b = word<kGuard>(w + 8, x);
  const uint64_t c = s ? word<kGuard>(w + 16, x) : 0;
  return fold64((s ? funnel(a, b, s) : a) ^ key_lo, (s ? funnel(b, c, s) : b) ^ key_hi);
}

// 0..240 bytes at p: one lane's token.
template <bool kGuard>
__device__ __forceinline__ uint64_t xxh3_short(uintptr_t p, uint64_t n, const Xxh3Keys& k, const Extent& x) {
  if (n <= 16) {
    const int off = static_cast<int>(p & 7);
    const uintptr_t w = p - off;
    const uint64_t w0 = n ? word<kGuard>(w, x) : 0;
    const uint64_t w1 = off + n > 8 ? word<kGuard>(w + 8, x) : 0;
    const uint64_t w2 = off + n > 16 ? word<kGuard>(w + 16, x) : 0;
    return xxh3_0to16(w0, w1, w2, off, n, k);
  }
  uint64_t acc = n * kP64_1;
  if (n <= 128) {
    if (n > 32) {
      if (n > 64) {
        if (n > 96) acc += mix16<kGuard>(p + 48, k.mid[12], k.mid[13], x) + mix16<kGuard>(p + n - 64, k.mid[14], k.mid[15], x);
        acc += mix16<kGuard>(p + 32, k.mid[8], k.mid[9], x) + mix16<kGuard>(p + n - 48, k.mid[10], k.mid[11], x);
      }
      acc += mix16<kGuard>(p + 16, k.mid[4], k.mid[5], x) + mix16<kGuard>(p + n - 32, k.mid[6], k.mid[7], x);
    }
    acc += mix16<kGuard>(p, k.mid[0], k.mid[1], x) + mix16<kGuard>(p + n - 16, k.mid[2], k.mid[3], x);
    return avalanche(acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += mix16<kGuard>(p + 16 * i, k.mid[2 * i], k.mid[2 * i + 1], x);
  acc = avalanche(acc);
  const int rounds = static_cast<int>(n / 16);
#pragma unroll
  for (int i = 8; i < 15; ++i) {
    if (i < rounds) acc += mix16<kGuard>(p + 16 * i, k.mid3[2 * (i - 8)], k.mid3[2 * (i - 8) + 1], x);
  }
  acc += mix16<kGuard>(p + n - 16, k.last[0], k.last[1], x);
  return avalanche(acc);
}

// A lane's 8 bytes of a warp's 256: its aligned word a, the next lane's (lane
// 31: e, the word after the 256 bytes), cut at byte shift sh.
__device__ __forceinline__ uint64_t lane_value(uint64_t a, uint64_t e, int lane, int sh) {
  uint64_t b = __shfl_down_sync(kFull, a, 1);
  if (lane == 31) b = e;
  return sh ? funnel(a, b, sh) : a;
}

__device__ __forceinline__ uint64_t acc_init(int i) {
  return i == 0 ? kP32_3 : i == 1 ? kP64_1 : i == 2 ? kP64_2 : i == 3 ? kP64_3
       : i == 4 ? kP64_4 : i == 5 ? kP32_2 : i == 6 ? kP64_5 : kP32_1;
}

// The partial sum a lane adds to its accumulator lane for one stripe's value
// (zero where the stripe is not taken; every lane takes part in the shuffle).
__device__ __forceinline__ uint64_t stripe_term(uint64_t value, uint64_t key, bool take) {
  const uint64_t mixed = value ^ key;
  const uint64_t from_neighbour = __shfl_xor_sync(kFull, value, 1);
  return take ? (mixed & 0xFFFFFFFFull) * (mixed >> 32) + from_neighbour : 0;
}

__device__ __forceinline__ uint64_t stripes_sum(uint64_t part) {
  part += __shfl_xor_sync(kFull, part, 8);
  return part + __shfl_xor_sync(kFull, part, 16);
}

// More than 240 bytes at p, by the whole warp; every lane returns the digest.
template <bool kGuard>
__device__ uint64_t xxh3_long_warp(uintptr_t p, uint64_t n, const Xxh3Keys& k, int lane, const Extent& x) {
  const int i = lane & 7, s = lane >> 3;
  // Stripe j of a block reads the seeded secret's words j + i: a lane's four
  // steps take j = s, 4 + s, 8 + s, 12 + s (read from the parameter bank at
  // each use). Lane 31's next word is lane 0's of the next step.
  uint64_t acc = acc_init(i);
  const int sh = static_cast<int>(p & 7);  // every stripe's alignment
  const uintptr_t w = p - sh + 8 * lane;
  const uint64_t stripes = (n - 1) / 64;  // whole stripes before the overlapping last one
  const uint64_t blocks = stripes / 16;
  uint64_t a[4];
  for (uint64_t b = 0; b < blocks; ++b) {
#pragma unroll
    for (int t = 0; t < 4; ++t) a[t] = word<kGuard>(w + 1024 * b + 256 * t, x);
    const uint64_t after = lane == 31 && sh ? word<kGuard>(p - sh + 1024 * b + 1024, x) : 0;
    uint64_t part = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t e = t < 3 ? __shfl_sync(kFull, a[t < 3 ? t + 1 : t], 0) : after;
      part += stripe_term(lane_value(a[t], e, lane, sh), k.stripes[4 * t + s + i], true);
    }
    acc += stripes_sum(part);
    acc = (acc ^ (acc >> 47) ^ k.stripes[16 + i]) * kP32_1;
  }
  // The partial block's stripes, then the last stripe (64 bytes ending at
  // the token's end, the tail keys) in lanes 0..7: no scramble between them.
  const int rest = static_cast<int>(stripes - 16 * blocks);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = 4 * t + s;  // a lane's stripe; the first past the block's end lends lane i = 0's word
    a[t] = j < rest || (j == rest && i == 0) ? word<kGuard>(w + 1024 * blocks + 256 * t, x) : 0;
  }
  const uintptr_t q = p + n - 64 + 8 * i;
  const int tail_sh = static_cast<int>(q & 7);
  const uint64_t t0 = s == 0 ? word<kGuard>(q - tail_sh, x) : 0;
  const uint64_t t1 = s == 0 && tail_sh ? word<kGuard>(q - tail_sh + 8, x) : 0;
  uint64_t part = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (4 * t < rest) {  // a stripe 4t + 3 < rest has its next word in lane 0 of step t + 1 (t < 3)
      const uint64_t e = __shfl_sync(kFull, a[t < 3 ? t + 1 : t], 0);
      part += stripe_term(lane_value(a[t], e, lane, sh), k.stripes[4 * t + s + i], 4 * t + s < rest);
    }
  }
  part += stripe_term(tail_sh ? funnel(t0, t1, tail_sh) : t0, k.tail[i], s == 0);
  acc += stripes_sum(part);
  // The merge: lanes of even i fold (acc[i], acc[i + 1]); their sum.
  const uint64_t odd = __shfl_xor_sync(kFull, acc, 1);
  uint64_t merged = (i & 1) ? 0 : fold64(acc ^ k.merge[i], odd ^ k.merge[i + 1]);
  merged += __shfl_xor_sync(kFull, merged, 2);
  merged += __shfl_xor_sync(kFull, merged, 4);
  return avalanche(n * kP64_1 + merged);
}

constexpr int kXxh3MinBlocks = 4;  // blocks an SM the registers must allow

// Spans (kSpans): token t is data[offsets[t], offsets[t + 1]). Rows: token t
// is lengths[t] bytes (clamped to [0, width]) at t * width. A warp takes 32
// tokens a step, a lane one; the next step's spans are loaded before this
// step's words. A step whose 32 tokens all exist and whose words all lie
// inside the buffer (every step but the last few, on an 8-byte aligned
// buffer) reads them unguarded; the others take the guarded instances.
template <bool kSpans, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
xxh3_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
            const int32_t* __restrict__ lengths, int64_t width, int64_t count, const __grid_constant__ Xxh3Keys keys,
            uint64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  const bool aligned = (x.lo & 7) == 0;
  // [start, stop) of token f + lane (past the count: empty); a warp-wide call.
  const auto span = [&](int64_t f, int64_t& start, int64_t& stop) {
    const int64_t t = f + lane;
    if (kSpans) {
      const bool whole = f + 32 <= count;
      start = whole || t <= count ? __ldg(offsets + t) : 0;
      stop = __shfl_down_sync(kFull, start, 1);
      if (lane == 31 && (whole || t < count)) stop = __ldg(offsets + t + 1);
      if (!whole && t >= count) stop = start;
    } else {
      const int32_t len = t < count ? __ldg(lengths + t) : 0;
      start = t * width;
      stop = start + (len < 0 ? 0 : (len > width ? width : len));
    }
  };
  int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31));
  int64_t start = 0, stop = 0;
  if (first < count) span(first, start, stop);
  for (; first < count; first += stride) {
    int64_t next_start = 0, next_stop = 0;
    if (first + stride < count) span(first + stride, next_start, next_stop);
    const int64_t t = first + lane;
    const uintptr_t p = x.lo + static_cast<uintptr_t>(start);
    const uint64_t n = static_cast<uint32_t>(stop - start);
    const bool interior = aligned && first + 32 <= count && __shfl_sync(kFull, stop, 31) + 16 <= end;
    bool is_long;
    if (interior) {
      // The tokens of 0..16 bytes: the aligned words that hold them, then
      // their digests.
      const bool quick = n <= 16;
      const int off = static_cast<int>(p & 7);
      const uint64_t w0 = quick ? word<false>(p - off, x) : 0;
      const uint64_t w1 = quick && off + n > 8 ? word<false>(p - off + 8, x) : 0;
      const uint64_t w2 = quick && off + n > 16 ? word<false>(p - off + 16, x) : 0;
      if (quick) {
        out[t] = xxh3_0to16(w0, w1, w2, off, n, keys);
      } else if (n <= 240) {
        out[t] = xxh3_short<false>(p, n, keys, x);
      }
      is_long = n > 240;
    } else {
      if (t < count && n <= 240) out[t] = xxh3_short<true>(p, n, keys, x);
      is_long = t < count && n > 240;
    }
    for (unsigned longs = __ballot_sync(kFull, is_long); longs; longs &= longs - 1) {
      const int src = __ffs(longs) - 1;
      const uintptr_t q = __shfl_sync(kFull, p, src);
      const uint64_t m = __shfl_sync(kFull, n, src);
      const uint64_t h = inside(q, m, x) ? xxh3_long_warp<false>(q, m, keys, lane, x) : xxh3_long_warp<true>(q, m, keys, lane, x);
      if (lane == 0) out[first + src] = h;
    }
    start = next_start;
    stop = next_stop;
  }
}

}  // namespace swt

// Spans: data uint8[end]; offsets int64[count + 1], nondecreasing, within
// [0, end]; lengths null. Rows: data uint8[count, width] (end = count *
// width); lengths int32[count]; offsets null. keys: the host's
// ops/xxh3.secret_words(seed), KEY_WORDS u64 in the order of Xxh3Keys; out:
// uint64[count].
extern "C" int sw_xxh3_64(const void* data, int64_t end, const void* offsets, const void* lengths, int64_t width,
                          int64_t count, const void* keys, void* out, void* stream) {
  if (count <= 0 || end < 0 || keys == nullptr || (offsets == nullptr) == (lengths == nullptr) ||
      (offsets == nullptr && width <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swt::Xxh3Keys k;
  memcpy(&k, keys, sizeof(k));
  const auto kernel = offsets != nullptr ? swt::xxh3_kernel<true, swt::kXxh3MinBlocks> : swt::xxh3_kernel<false, swt::kXxh3MinBlocks>;
  const int grid = swt::resident_grid(kernel, 0, (count + swt::kThreads - 1) / swt::kThreads);
  kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), end, static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(lengths),
      width, count, k, static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
