// csrc/uncased_keys.cu with its settings as compile-time switches, for
// measurement only: tools/hopper_probes.py uncased builds this file once for
// each setting it compares (nvcc -DSW_UNCASED_...=...) and times each build
// beside the package's kernel on the same rows. Nothing of the package calls
// it. With every switch at its default it computes what the package's kernel
// computes; WALK 0 and FOLD 0 give wrong columns (timing only).
#include "../../stringwars_tpu_torch/csrc/common.cuh"

// The settings tools/hopper_probes.py uncased compares (nvcc -D...); the
// values below are the package's constants. TILE: columns a block makes at a time in shared
// memory (a multiple of 4). ASCII 0: every row through the walk. ROWS: rows
// a block (128 or 256; fewer where wide rows need it). MIN_BLOCKS: blocks of
// 256 threads an SM its registers must allow (8: 32 registers a thread).
// For timing alone (wrong columns): WALK 0 skips the listed rows' walk, FOLD
// 0 takes each codepoint as its own fold (no table load).
#ifndef SW_UNCASED_TILE
#define SW_UNCASED_TILE 16
#endif
#ifndef SW_UNCASED_ASCII
#define SW_UNCASED_ASCII 1
#endif
#ifndef SW_UNCASED_ROWS
#define SW_UNCASED_ROWS 128
#endif
#ifndef SW_UNCASED_MIN_BLOCKS
#define SW_UNCASED_MIN_BLOCKS 8
#endif
#ifndef SW_UNCASED_WALK
#define SW_UNCASED_WALK 1
#endif
#ifndef SW_UNCASED_FOLD
#define SW_UNCASED_FOLD 1
#endif

namespace swt_settings {

using swt::kThreads;

constexpr int kUncasedTile = SW_UNCASED_TILE;
constexpr int kLengthClasses = 16;  // key lengths 1-48 by 4 bytes, then by 32, the last from 145 up
static_assert(kUncasedTile % 4 == 0, "a tile takes whole groups of four columns");

struct UncasedArgs {
  const uint8_t* data;         // [rows, width]
  const int32_t* key_lengths;  // [rows]
  const int2* table;           // [table_size]: x = first output | outputs << 24, y = second | third << 16
  int64_t rows;
  int64_t table_size;
  uint64_t magic;              // ceil(2^32 / unit), unit: the row's words (words staged) or bytes
  int width;
  int stride;                  // bytes a staged row takes in shared memory: an odd count of words
  int words_staged;            // 1: the rows staged as 4-byte words (width % 4 == 0, data 4-byte aligned)
  int n_cols;
  int pack3;
};

// The row of staged unit i: i / unit, exact for i * unit < 2^32.
__device__ __forceinline__ int row_of(int i, uint64_t magic) {
  return static_cast<int>((static_cast<uint64_t>(i) * magic) >> 32);
}

// The bytes of a word below k (k <= 0: none, k >= 4: all).
__device__ __forceinline__ uint32_t bytes_below(int k) {
  return k <= 0 ? 0u : k >= 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1u;
}

// Four ASCII bytes lowercased (A-Z to a-z); bytes from 0x80 up give junk
// in their own byte only.
__device__ __forceinline__ uint32_t lower4(uint32_t x) {
  x &= 0x7F7F7F7Fu;
  const uint32_t upper = (x + 0x3F3F3F3Fu) & ~(x + 0x25252525u) & 0x80808080u;  // 0x41 <= byte <= 0x5A
  return x | (upper >> 2);
}

// Bytes z0 (least significant), z1, z2 of z as a column's three 9-bit
// fields, z2 most significant.
__device__ __forceinline__ uint32_t spread3(uint32_t z) {
  return (z & 0xFFu) | ((z << 1) & 0x1FE00u) | ((z << 2) & 0x3FC0000u);
}

// A codepoint's full fold, each output + 1: how many (1 to 3) and which.
struct Folded {
  uint32_t n, v0, v1, v2;
};

__device__ __forceinline__ Folded fold_cp(uint32_t cp, const int2* table, int64_t table_size) {
  if (cp < 0x80) return {1u, (cp - 0x41u < 26u ? cp + 0x20u : cp) + 1u, 1u, 1u};
  if (!SW_UNCASED_FOLD || cp >= table_size) return {1u, cp + 1u, 1u, 1u};
  const int2 e = __ldg(table + cp);
  const auto x = static_cast<uint32_t>(e.x), y = static_cast<uint32_t>(e.y);
  return {x >> 24, (x & 0xFFFFFFu) + 1u, (y & 0xFFFFu) + 1u, (y >> 16) + 1u};
}

template <bool kPlan>
__global__ void __launch_bounds__(kThreads, SW_UNCASED_MIN_BLOCKS)
uncased_keys_kernel(UncasedArgs a, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t shared[];
  __shared__ int16_t listed[kThreads];            // the block's rows: ASCII, then the others by length class
  __shared__ int limits[kThreads];                // their key lengths, by list slot
  __shared__ int class_count[kLengthClasses + 1];  // the ASCII rows, then each length class
  __shared__ int any_other, top_count, top_cp;
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int rows_a_block = blockDim.x;  // a multiple of 32, at most kThreads
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sw = a.stride >> 2;
  auto* staged = reinterpret_cast<uint8_t*>(shared);  // rows_a_block rows of a.stride bytes, then a spare word
  // kUncasedTile x (rows_a_block + 1), past the rows and a spare word
  int32_t* tile = reinterpret_cast<int32_t*>(shared + rows_a_block * sw + 1);
  const int tile_stride = rows_a_block + 1;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_a_block;
  const int here = static_cast<int>(min(static_cast<int64_t>(rows_a_block), a.rows - row0));
  if (t == 0) {
    any_other = 0;
    top_count = 0;
    top_cp = 0;
  }
  if (t <= kLengthClasses) class_count[t] = 0;
  const uint8_t* src = a.data + row0 * a.width;
  if (a.words_staged) {
    const int words = a.width >> 2, total = here * words;
    const auto* src_words = reinterpret_cast<const uint32_t*>(src);
    const auto put = [&](int i, uint32_t v) {
      const int r = row_of(i, a.magic);
      shared[r * sw + i - r * words] = v;
    };
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int quads = total >> 2;
      for (int q = t; q < quads; q += rows_a_block) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src_words) + q);
        put(4 * q, v.x);
        put(4 * q + 1, v.y);
        put(4 * q + 2, v.z);
        put(4 * q + 3, v.w);
      }
      done = quads << 2;
    }
    for (int i = done + t; i < total; i += rows_a_block) put(i, __ldg(src_words + i));
  } else {
    const int total = here * a.width;
    for (int i = t; i < total; i += rows_a_block) {
      const int r = row_of(i, a.magic);
      staged[r * a.stride + i - r * a.width] = __ldg(src + i);
    }
  }
  const bool live = t < here;
  const int limit = live ? min(max(__ldg(a.key_lengths + row0 + t), 0), a.width) : 0;
  __syncthreads();

  // The row's path: a byte from 0x80 up below the key length. The other
  // rows are counted by length class (a warp's rows then about as long).
  const uint32_t* mine = shared + t * sw;
  uint32_t high = 0;
  for (int w = 0; 4 * w < limit; ++w) high |= mine[w] & bytes_below(limit - 4 * w);
  const bool other = live && (!SW_UNCASED_ASCII || (high & 0x80808080u) != 0);
  const int length_class = !other      ? 0  // the ASCII rows first
                           : limit <= 48 ? 1 + ((limit - 1) >> 2)
                                         : 1 + min(kLengthClasses - 1, 12 + ((limit - 49) >> 5));
  // A row's place in its class: one shared atomic a class and warp.
  const unsigned peers = __match_any_sync(kFull, live ? length_class : -1);
  const int leader = __ffs(peers) - 1;
  int in_class = 0;
  if (live && lane == leader) in_class = atomicAdd(&class_count[length_class], __popc(peers));
  in_class = __shfl_sync(kFull, in_class, leader) + __popc(peers & ((1u << lane) - 1u));
  if (__any_sync(kFull, other) && lane == 0) any_other = 1;
  if (kPlan) {  // an ASCII row: as many codepoints as bytes
    uint32_t top = 0;
    if (live && !other) {
      for (int w = 0; 4 * w < limit; ++w) top = __vmaxu4(top, lower4(mine[w]) & bytes_below(limit - 4 * w));
      top = max(max(top & 0xFF, (top >> 8) & 0xFF), max((top >> 16) & 0xFF, top >> 24));
    }
    const int count = __reduce_max_sync(kFull, live && !other ? limit : 0);
    top = __reduce_max_sync(kFull, top);
    if (lane == 0) {
      atomicMax(&top_count, count);
      atomicMax(&top_cp, static_cast<int>(top));
    }
  }
  __syncthreads();
  // In a block with rows of both paths every row is listed: the ASCII
  // rows, then the others by length class (each class in arrival order),
  // so that a warp's threads take rows of one path, and the warp that
  // takes both the ASCII rows' last and the walk's first the shortest walks.
  const int walked_from = any_other ? class_count[0] : here;  // the first listed row to walk
  if (any_other) {
    int before = 0;
#pragma unroll
    for (int c = 0; c < kLengthClasses; ++c) before += c < length_class ? class_count[c] : 0;
    if (live) {
      listed[before + in_class] = static_cast<int16_t>(t);
      limits[before + in_class] = limit;
    }
    __syncthreads();
  }

  // A listed row walked by thread `slot`, four bytes a step (decoded and
  // folded as the header says). Its outputs whose index in the row lies in
  // [lo, hi) go to the row's tile entries, which the thread zeroes first;
  // the plan takes the row's count and its largest codepoint.
  const int per = a.pack3 ? 3 : 1;
  const auto walk = [&](int slot, int lo, int hi, int& count, uint32_t& top) {
    const int r = listed[slot], lim = limits[slot];
    const uint32_t* words = shared + r * sw;
    if (!kPlan) {
      for (int c = 0; c < (hi - lo) / per; ++c) tile[c * tile_stride + r] = 0;
    }
    int q = 0;  // the row's outputs so far
    for (int p = 0; p < lim && q < hi; p += 4) {
      const uint64_t window = (static_cast<uint64_t>(words[(p >> 2) + 1] & bytes_below(a.width - p - 4)) << 32) |
                              (words[p >> 2] & bytes_below(a.width - p));  // bytes p..p+7, 0 past W
      Folded f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const auto x = static_cast<uint32_t>(window >> (8 * e));
        const uint32_t b = x & 0xFF, b1 = (x >> 8) & 0x3F, b2 = (x >> 16) & 0x3F, b3 = (x >> 24) & 0x3F;
        const uint32_t cp = b < 0x80   ? b
                            : b < 0xE0 ? ((b & 0x1F) << 6) | b1
                            : b < 0xF0 ? ((b & 0x0F) << 12) | (b1 << 6) | b2
                                       : ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3;
        f[e] = p + e < lim && (b & 0xC0) != 0x80 ? fold_cp(cp, a.table, a.table_size) : Folded{0u, 0u, 0u, 0u};
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t vals[3] = {f[e].v0, f[e].v1, f[e].v2};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j < static_cast<int>(f[e].n)) {
            if (kPlan) {
              top = max(top, vals[j] - 1u);
            } else if (q >= lo && q < hi) {
              const int at = q - lo;
              if (per == 3) {
                const int col = at / 3;
                tile[col * tile_stride + r] |= static_cast<int>(vals[j] << (9 * (2 - (at - 3 * col))));
              } else {
                tile[at * tile_stride + r] = static_cast<int>(vals[j]);
              }
            }
            ++q;
          }
        }
      }
    }
    count = q;
  };

  if (kPlan) {
    int count = 0;
    uint32_t top = 0;
    if (SW_UNCASED_WALK && t >= walked_from && live) walk(t, 0, 0x7FFFFFFF, count, top);
    if (any_other) {
      count = __reduce_max_sync(kFull, count);
      top = __reduce_max_sync(kFull, top);
      if (lane == 0) {
        atomicMax(&top_count, count);
        atomicMax(&top_cp, static_cast<int>(top));
      }
    }
    __syncthreads();
    // One atomic a block on one address serializes in L2: take it only
    // where the block's value passes the one already there.
    const volatile int32_t* seen = out;
    if (t == 0 && top_count > seen[0]) atomicMax(out, top_count);
    if (t == 0 && top_cp > seen[1]) atomicMax(out + 1, top_cp);
    return;
  }

  // The columns [c0, c1) of an ASCII row (its staged words, its key
  // length) to `emit(c, value)`: four columns from three words (pack3) or
  // from one.
  const auto ascii_columns = [&](const uint32_t* row_words, int lim, int c0, int c1, auto&& emit) {
    const auto keys = [&](int w) {
      return 4 * w < lim ? (lower4(row_words[w]) + 0x01010101u) & bytes_below(lim - 4 * w) : 0u;
    };
    for (int c = c0; c < c1; c += 4) {
      uint32_t col[4];
      if (a.pack3) {
        const int w = 3 * (c >> 2);
        const uint32_t y0 = keys(w), y1 = keys(w + 1), y2 = keys(w + 2);
        col[0] = spread3(__byte_perm(y0, 0, 0x0012));
        col[1] = spread3(__byte_perm(y0, y1, 0x0345));
        col[2] = spread3(__byte_perm(y1, y2, 0x0234));
        col[3] = spread3(__byte_perm(y2, 0, 0x0123));
      } else {
        const uint32_t y = keys(c >> 2);
        col[0] = y & 0xFF;
        col[1] = (y >> 8) & 0xFF;
        col[2] = (y >> 16) & 0xFF;
        col[3] = y >> 24;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < c1) emit(c + e, col[e]);
      }
    }
  };

  const int64_t row = row0 + t;
  if (!any_other) {  // every row ASCII: each thread stores its own row's columns
    if (live) ascii_columns(mine, limit, 0, a.n_cols, [&](int c, uint32_t v) { out[c * a.rows + row] = static_cast<int32_t>(v); });
    return;
  }
  for (int c0 = 0; c0 < a.n_cols; c0 += kUncasedTile) {
    const int c1 = min(c0 + kUncasedTile, a.n_cols);
    if (t < walked_from) {  // a listed ASCII row
      const int r = listed[t];
      ascii_columns(shared + r * sw, limits[t], c0, c1,
                    [&](int c, uint32_t v) { tile[(c - c0) * tile_stride + r] = static_cast<int32_t>(v); });
    }
    if (SW_UNCASED_WALK && t >= walked_from && live) {
      int count;
      uint32_t top;
      walk(t, c0 * per, c1 * per, count, top);
    }
    __syncthreads();
    if (live) {
      for (int c = c0; c < c1; ++c) out[c * a.rows + row] = tile[(c - c0) * tile_stride + t];
    }
    if (c1 < a.n_cols) __syncthreads();
  }
}

}  // namespace swt_settings

// sw_uncased_keys at this file's settings: its arguments and its output
// (wrong columns where WALK or FOLD is 0).
extern "C" int uncased_setting_run(const void* data, const void* key_lengths, int64_t rows, int64_t width,
                               const void* table, int64_t table_size, int64_t n_cols, int64_t pack3, int64_t plan,
                               void* out, void* stream) {
  if (rows <= 0 || width <= 0 || width > 0x7FFF || table_size <= 0 || n_cols < 0 || n_cols > 0x7FFFFFFF ||
      (!plan && n_cols == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t stride = (width + 3) & ~int64_t{3};
  if ((stride >> 2) % 2 == 0) stride += 4;  // an odd count of words: a thread a row reads distinct banks
  // Rows a block: SW_UNCASED_ROWS, halved until the staged rows and the column tile
  // fit the dynamic shared memory left beside the kernel's static arrays.
  constexpr int64_t kDynamicLimit = 227 * 1024 - 4096;
  static_assert(SW_UNCASED_ROWS % 32 == 0 && SW_UNCASED_ROWS <= swt::kThreads, "rows a block: whole warps");
  int64_t rows_a_block = SW_UNCASED_ROWS, shared = 0;
  for (;; rows_a_block >>= 1) {
    shared = rows_a_block * stride + 4 + (plan ? 0 : 4 * swt_settings::kUncasedTile * (rows_a_block + 1));
    if (shared <= kDynamicLimit) break;
    if (rows_a_block == 32) return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool words_staged = (width & 3) == 0 && (reinterpret_cast<uintptr_t>(data) & 3) == 0;
  const uint64_t unit = words_staged ? width >> 2 : width;
  const swt_settings::UncasedArgs a{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(key_lengths),
                           static_cast<const int2*>(table), rows, table_size, ((uint64_t{1} << 32) + unit - 1) / unit,
                           static_cast<int>(width), static_cast<int>(stride), words_staged ? 1 : 0,
                           static_cast<int>(n_cols), pack3 != 0 ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block);
  auto* dst = static_cast<int32_t*>(out);
  const auto threads = static_cast<unsigned>(rows_a_block);
  if (plan) {
    if (shared > 48 * 1024) {
      cudaFuncSetAttribute(swt_settings::uncased_keys_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared));
    }
    cudaMemsetAsync(dst, 0, 2 * sizeof(int32_t), s);
    swt_settings::uncased_keys_kernel<true><<<blocks, threads, shared, s>>>(a, dst);
  } else {
    if (shared > 48 * 1024) {
      cudaFuncSetAttribute(swt_settings::uncased_keys_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared));
    }
    swt_settings::uncased_keys_kernel<false><<<blocks, threads, shared, s>>>(a, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
