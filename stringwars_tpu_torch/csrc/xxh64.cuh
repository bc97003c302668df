// The per-token read path and the XXH64 core of hash.cu, shared with the
// Bloom filter kernels of filters.cu (which hash each token under k seeds
// and use the digests at once, without writing them).
//
// - token_walk: a warp takes 32 tokens a step of either layout, a padded
//   [count, width] matrix (rows) or a tape (spans: token t is data[offsets[t],
//   offsets[t + 1]), read where it lies); a token under 32 bytes is one
//   lane's, a longer one a group's of four lanes (hash.cu says why).
// - xxh64_walk: XXH64 under K seeds over that walk, each digest handed to an
//   epilogue.
#pragma once

#include "common.cuh"
#include "spans.cuh"

namespace swt {

constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP64_2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP64_3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP64_4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP64_5 = 0x27D4EB2F165667C5ull;

constexpr int kMaxSeeds = 8;
struct Seeds {
  uint64_t v[kMaxSeeds];
};

// seeds.v[j] for a j known only at run time, without local memory.
template <int K>
__device__ __forceinline__ uint64_t seed_at(const Seeds& seeds, int j) {
  uint64_t v = seeds.v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) v = j == k ? seeds.v[k] : v;
  return v;
}

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

// Zeroes the bytes of the eight words past the first r.
__device__ __forceinline__ void clip_words(uint32_t (&t)[8], int r) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int valid = min(max(r - 4 * j, 0), 4);
    t[j] &= valid == 4 ? 0xFFFFFFFFu : ((1u << (8 * valid)) - 1u);
  }
}

// -- the read path --------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kGroupBytes = 32;  // a token this long or longer is a group's

// The n < 32 bytes of a token at p as eight zero-padded little-endian words,
// cut from the aligned 8-byte words that hold them.
template <bool kGuard>
__device__ __forceinline__ void short_words(uintptr_t p, int n, const Extent& x, uint32_t (&t)[8]) {
  const int off = static_cast<int>(p & 7);
  const uintptr_t w = p - off;
  uint64_t a[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) a[j] = 8 * j < off + n ? word<kGuard>(w + 8 * j, x) : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int left = n - 8 * j;  // the token's bytes in these 8
    const uint64_t keep = left >= 8 ? ~uint64_t{0} : (left > 0 ? (uint64_t{1} << (8 * left)) - 1 : 0);
    const uint64_t v = funnel(a[j], a[j + 1], off) & keep;
    t[2 * j] = static_cast<uint32_t>(v);
    t[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  }
}

// short_words of a token of n < 16 bytes, read unguarded: at most three
// aligned words, the upper four words zero.
__device__ __forceinline__ void small_words(uintptr_t p, int n, const Extent& x, uint32_t (&t)[8]) {
  const int off = static_cast<int>(p & 7);
  const uintptr_t w = p - off;
  uint64_t a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) a[j] = 8 * j < off + n ? word<false>(w + 8 * j, x) : 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int left = n - 8 * j;
    const uint64_t keep = left >= 8 ? ~uint64_t{0} : (left > 0 ? (uint64_t{1} << (8 * left)) - 1 : 0);
    const uint64_t v = funnel(a[j], a[j + 1], off) & keep;
    t[2 * j] = static_cast<uint32_t>(v);
    t[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  }
#pragma unroll
  for (int j = 4; j < 8; ++j) t[j] = 0;
}

template <typename Word, bool kGuard>
__device__ __forceinline__ Word group_word(uintptr_t w, const Extent& x) {
  if constexpr (sizeof(Word) == 8) {
    return word<kGuard>(w, x);
  } else {
    return word32<kGuard>(w, x);
  }
}

// A group of four lanes walks the `stripes` 4-word stripes of a token at p:
// lane i = lane & 3 passes word i of each stripe to step, in order. Words
// are Word-sized (XXH64: 8 bytes, XXH32: 4) and read aligned: lane i loads
// the aligned word under its value, and an unaligned token's value is cut
// from it and the next one, lane i + 1's (lane 3: lane 0's of the next
// stripe, or a load of its own after the last of a batch). kU stripes are
// loaded before the first is used. `most` (the warp's largest stripe count)
// paces every lane through the shuffles.
template <typename Word, int kU, bool kGuard, class Step>
__device__ __forceinline__ void group_stripes(uintptr_t p, uint32_t stripes, uint32_t most, int lane, const Extent& x,
                                              Step step) {
  constexpr int kB = sizeof(Word);
  const int i = lane & 3, lead = lane & ~3;
  const int sh = static_cast<int>(p & (kB - 1));
  const uintptr_t base = p - sh + kB * i;  // lane i's aligned word of stripe 0
  const bool shifted = __any_sync(kFull, sh != 0);
  for (uint32_t s = 0; s < most; s += kU) {
    Word a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {  // lane 0 also lends the word after the last stripe to lane 3
      const bool take = s + u < stripes || (i == 0 && sh && stripes && s + u == stripes);
      a[u] = take ? group_word<Word, kGuard>(base + 4 * kB * (s + u), x) : Word(0);
    }
    const Word after = i == 3 && sh && s + kU <= stripes ? group_word<Word, kGuard>(base - 3 * kB + 4 * kB * (s + kU), x) : Word(0);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      Word v = a[u];
      if (shifted) {
        const Word down = __shfl_down_sync(kFull, a[u], 1);
        const Word next = __shfl_sync(kFull, a[u + 1 < kU ? u + 1 : u], lead);
        v = funnel(a[u], i < 3 ? down : (u + 1 < kU ? next : after), sh);
      }
      if (s + u < stripes) step(v);
    }
  }
}

// The r < 32 bytes at p (a long token's tail) as eight zero-padded words in
// every lane of the group: lane i reads bytes 8i..8i + 7.
template <bool kGuard>
__device__ __forceinline__ void group_tail(uintptr_t p, int r, int lane, const Extent& x, uint32_t (&t)[8]) {
  const int i = lane & 3, off = static_cast<int>(p & 7);
  const uintptr_t w = p - off + 8 * i;
  const uint64_t a = 8 * i < r ? word<kGuard>(w, x) : 0;
  const uint64_t b = 8 * i < r && off ? word<kGuard>(w + 8, x) : 0;
  const uint64_t v = funnel(a, b, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t vk = __shfl_sync(kFull, v, (lane & ~3) + k);
    t[2 * k] = static_cast<uint32_t>(vk);
    t[2 * k + 1] = static_cast<uint32_t>(vk >> 32);
  }
  clip_words(t, r);
}

// The walk over the tokens of either layout. Spans (kSpans): token t is
// data[offsets[t], offsets[t + 1]). Rows: token t is lengths[t] bytes
// (clamped to [0, width]) at t * width. Either way the buffer is data[0,
// end). A warp takes 32 tokens a step (grid-stride); short_fn(t, p, n,
// guard, small) hashes a lane's token of under kGroupBytes (guard:
// warp-uniform, some token of the step reads a word outside the buffer;
// small: warp-uniform, every short token of the step is under 16 bytes),
// and long_fn(t, p, n, has, guard, lane) is called by every lane eight
// times at most a step, each group of four lanes taking the next long token
// (has: one is left for the group; guard: warp-uniform). kBlock: the
// launch's threads a block.
template <bool kSpans, int kBlock = kThreads, class ShortFn, class LongFn>
__device__ __forceinline__ void token_walk(const uint8_t* data, int64_t end, const int64_t* __restrict__ offsets,
                                           const int32_t* __restrict__ lengths, int64_t width, int64_t count,
                                           ShortFn short_fn, LongFn long_fn) {
  const int lane = threadIdx.x & 31, group = lane >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  const Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  // [start, stop) of token f + lane (past the count: empty); a warp-wide call.
  const auto span = [&](int64_t f, int64_t& start, int64_t& stop) {
    const int64_t t = f + lane;
    if constexpr (kSpans) {
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
  int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock + (threadIdx.x & ~31);
  int64_t start = 0, stop = 0;
  if (first < count) span(first, start, stop);
  for (; first < count; first += stride) {
    int64_t next_start = 0, next_stop = 0;
    if (first + stride < count) span(first + stride, next_start, next_stop);
    const int64_t t = first + lane;
    const uintptr_t p = x.lo + static_cast<uintptr_t>(start);
    const int64_t n = stop - start;
    const bool is_long = t < count && n >= kGroupBytes;
    const bool is_short = t < count && !is_long;
    const bool guard = __any_sync(kFull, is_short && !inside(p, static_cast<uint64_t>(n), x));  // the buffer's ends only
    const bool small = __all_sync(kFull, !is_short || n < 16);
    if (is_short) short_fn(t, p, static_cast<int>(n), guard, small);
    for (unsigned longs = __ballot_sync(kFull, is_long); longs;) {
      unsigned rest = longs;
      for (int k = 0; k < group; ++k) rest &= rest - 1;  // the group's: the (group + 1)-th long token left
      const bool has = rest != 0;
      const int src = has ? __ffs(rest) - 1 : 0;
      const uintptr_t q = __shfl_sync(kFull, p, src);
      const int64_t m = __shfl_sync(kFull, n, src);
      for (int k = 0; k < 8; ++k) longs &= longs - 1;
      const bool long_guard = __any_sync(kFull, has && !inside(q, static_cast<uint64_t>(m), x));
      long_fn(first + src, q, has ? m : 0, has, long_guard, lane);
    }
    start = next_start;
    stop = next_stop;
  }
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

__device__ __forceinline__ void init64(uint64_t (&acc)[4], uint64_t s) {
  acc[0] = s + kP64_1 + kP64_2;
  acc[1] = s + kP64_2;
  acc[2] = s;
  acc[3] = s - kP64_1;
}

// XXH64 of every token of either layout (token_walk) under K seeds: each
// digest h of token t under seed j goes to epilogue(t, j, h) (j known at run
// time on the long path), in no order. A warp-wide call: every lane of the
// block's warps calls it (kBlock a block).
template <int K, bool kSpans, int kBlock = kThreads, class Epilogue>
__device__ __forceinline__ void xxh64_walk(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                                           const int32_t* __restrict__ lengths, int64_t width, int64_t count,
                                           const Seeds& seeds, Epilogue epilogue) {
  const Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  const auto short_fn = [=](int64_t t, uintptr_t p, int n, bool guard, bool small) {
    uint32_t w[8];
    const uint64_t none[4] = {0, 0, 0, 0};  // no stripe below 32 bytes
    if (small && !guard) {  // n < 16, as the finish is told: no 16..31-byte tail step
      small_words(p, n, x, w);
#pragma unroll
      for (int j = 0; j < K; ++j) epilogue(t, j, finish64(none, seeds.v[j], n & 15, w));
      return;
    }
    if (guard) {
      short_words<true>(p, n, x, w);
    } else {
      short_words<false>(p, n, x, w);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) epilogue(t, j, finish64(none, seeds.v[j], n, w));
  };
  const auto long_fn = [&](int64_t t, uintptr_t q, int64_t m, bool has, bool guard, int lane) {
    const int i = lane & 3;
    uint64_t acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint64_t a[4];
      init64(a, seeds.v[j]);
      acc[j] = i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
    }
    const uint32_t stripes = static_cast<uint32_t>(m >> 5);
    const uint32_t most = __reduce_max_sync(kFull, stripes);
    const auto step = [&](uint64_t v) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = round64(acc[j], v);
    };
    uint32_t w[8];
    if (guard) {
      group_stripes<uint64_t, 4, true>(q, stripes, most, lane, x, step);
      group_tail<true>(q + 32 * static_cast<uintptr_t>(stripes), static_cast<int>(m & 31), lane, x, w);
    } else {
      group_stripes<uint64_t, 4, false>(q, stripes, most, lane, x, step);
      group_tail<false>(q + 32 * static_cast<uintptr_t>(stripes), static_cast<int>(m & 31), lane, x, w);
    }
    // The digests: lane i of the group finishes seeds i, i + 4, ..., so that
    // its four lanes share the K finishes.
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) {
      uint64_t accs[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 4 * q; j < 4 * q + 4 && j < K; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t v = __shfl_sync(kFull, acc[j], (lane & ~3) + k);
          if ((j & 3) == i) accs[k] = v;
        }
      }
      const int j = 4 * q + i;
      if (has && j < K) epilogue(t, j, finish64(accs, seed_at<K>(seeds, j), m, w));
    }
  };
  token_walk<kSpans, kBlock>(data, end, offsets, lengths, width, count, short_fn, long_fn);
}

// Seeds [first, first + count) of `seeds`, for one launch.
inline Seeds seed_group(const uint64_t* seeds, int64_t first, int count) {
  Seeds g{};
  for (int j = 0; j < count; ++j) g.v[j] = seeds[first + j];
  return g;
}

}  // namespace swt
