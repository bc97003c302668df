// K11 · the case-folded sort keys of padded rows: decode, full case fold and
// packing in one kernel.
//
// Replaces the fold and packing of stringwars_tpu/ops/sort.py::_uncased_order
// (:161-175: casefold.fold_tokens, then the folded codepoints + 1 packed into
// uint32 key columns), which the port ran as torch ops over the [B, W] rows
// (a row decode into several int32 [B, W] temporaries, four range maps, a
// cumsum, three scatters into a [B, 3W + 1] matrix, then the packing through
// int64 temporaries). The output is the same int32 [n_cols, B] matrix:
// column c of row t holds the row's folded codepoints 3c, 3c + 1, 3c + 2
// (pack3: 9 bits each, the first most significant) or c, each + 1, and 0
// past the row's folded count.
//
// What bounds it on an H100: the rows and their key lengths read once and
// the columns written once; the hash suite's 20,899,756 words (rows of 20 B,
// 7 columns) are 418 + 84 + 585 MB, 0.32 ms at 3.35 TB/s. The design:
//
// - A thread a row. A block stages its 256 rows in shared memory with
//   coalesced 4-byte loads (a row stride of an odd count of words, so that
//   the threads' byte reads fall in distinct banks), then each thread walks
//   its row there.
// - The decode is the JAX package's (casefold._decode_rows): a lead byte is
//   a non-continuation byte below the key length; it reads its next three
//   bytes from the row (0 past W, whatever the key length); bytes from 0xF8
//   up decode by the four-byte formula.
// - The fold is one 8-byte load a codepoint from a dense table staged once
//   a device (ops/sort_cuda.uncased_table, derived from the fold's range
//   maps: 125 K entries, 1 MB, in L2 and mostly in L1): the first output
//   codepoint and the count of outputs, then the second and the third.
//   Codepoints past the table fold to themselves, as the range maps give.
// - The walk yields one folded codepoint at a time; every thread of a warp
//   builds column c together and stores it at c * B + t, so that a warp's
//   store covers 128 consecutive bytes.
// - A plan mode walks the same rows and reduces the batch's largest folded
//   count and largest folded codepoint into two int32 (the host's packing
//   plan), instead of writing the columns.
#include "common.cuh"

namespace swt {

struct UncasedRows {
  const uint8_t* data;         // [rows, width]
  const int32_t* key_lengths;  // [rows]
  const int2* table;           // [table_size]: x = first output | outputs << 24, y = second | third << 16
  int64_t rows;
  int width;
  int stride;                  // bytes a staged row takes in shared memory
  int64_t table_size;
};

// One row's folded codepoints + 1, one at a time; 0 once they are spent.
struct FoldWalk {
  const uint8_t* row;  // in shared memory
  const int2* table;
  int64_t table_size;
  int width, limit, pos;
  uint32_t next0, next1, next2;
  int left;

  __device__ __forceinline__ uint32_t take() {
    while (left == 0) {
      if (pos >= limit) return 0;
      const uint32_t b = row[pos++];
      if ((b & 0xC0) == 0x80) continue;  // a continuation byte
      const uint32_t b1 = pos < width ? row[pos] & 0x3F : 0;
      const uint32_t b2 = pos + 1 < width ? row[pos + 1] & 0x3F : 0;
      const uint32_t b3 = pos + 2 < width ? row[pos + 2] & 0x3F : 0;
      const uint32_t cp = b < 0x80   ? b
                          : b < 0xE0 ? ((b & 0x1F) << 6) | b1
                          : b < 0xF0 ? ((b & 0x0F) << 12) | (b1 << 6) | b2
                                     : ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3;
      const int2 e = cp < table_size ? __ldg(table + cp) : make_int2(static_cast<int>(cp | (1u << 24)), 0);
      next0 = static_cast<uint32_t>(e.x) & 0xFFFFFF;
      next1 = static_cast<uint32_t>(e.y) & 0xFFFF;
      next2 = static_cast<uint32_t>(e.y) >> 16;
      left = static_cast<uint32_t>(e.x) >> 24;
    }
    const uint32_t v = next0 + 1;
    next0 = next1;
    next1 = next2;
    --left;
    return v;
  }
};

template <bool kPlan>
__global__ void __launch_bounds__(kThreads)
uncased_keys_kernel(UncasedRows a, int64_t n_cols, int pack3, int32_t* __restrict__ out) {
  extern __shared__ uint32_t staged[];  // kThreads rows of a.stride bytes
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int here = static_cast<int>(min(static_cast<int64_t>(kThreads), a.rows - row0));
  const uint8_t* src = a.data + row0 * a.width;
  if ((a.width & 3) == 0 && (reinterpret_cast<uintptr_t>(a.data) & 3) == 0) {
    const int words = a.width >> 2, stride_words = a.stride >> 2;
    const auto* src_words = reinterpret_cast<const uint32_t*>(src);
    for (int i = threadIdx.x; i < here * words; i += kThreads) {
      const int r = i / words;
      staged[r * stride_words + i - r * words] = __ldg(src_words + i);
    }
  } else {
    auto* bytes = reinterpret_cast<uint8_t*>(staged);
    for (int i = threadIdx.x; i < here * a.width; i += kThreads) {
      const int r = i / a.width;
      bytes[r * a.stride + i - r * a.width] = __ldg(src + i);
    }
  }
  __syncthreads();

  const int64_t t = row0 + threadIdx.x;
  const bool live = threadIdx.x < here;
  FoldWalk w{reinterpret_cast<const uint8_t*>(staged) + threadIdx.x * a.stride, a.table, a.table_size, a.width, 0, 0,
             0, 0, 0, 0};
  if (live) w.limit = min(max(__ldg(a.key_lengths + t), 0), a.width);
  if (kPlan) {
    long long count = 0, top = 0;
    for (uint32_t v = w.take(); v; v = w.take()) {
      ++count;
      top = max(top, static_cast<long long>(v - 1));
    }
    count = block_max(count);
    __syncthreads();  // block_max's partials are reused below
    top = block_max(top);
    if (threadIdx.x == 0) {
      atomicMax(out, static_cast<int>(count));
      atomicMax(out + 1, static_cast<int>(top));
    }
    return;
  }
  for (int64_t c = 0; c < n_cols; ++c) {
    uint32_t word = w.take();
    if (pack3) {
      const uint32_t second = w.take();
      const uint32_t third = w.take();
      word = (word << 18) | (second << 9) | third;
    }
    if (live) out[c * a.rows + t] = static_cast<int32_t>(word);
  }
}

}  // namespace swt

// The int32 [n_cols, rows] uncased key columns of the uint8 [rows, width]
// rows (plan 0), or, with plan 1, the batch's largest folded count and
// largest folded codepoint in out[0] and out[1] (zeroed here). table:
// int2[table_size] (ops/sort_cuda.uncased_table).
extern "C" int sw_uncased_keys(const void* data, const void* key_lengths, int64_t rows, int64_t width,
                               const void* table, int64_t table_size, int64_t n_cols, int64_t pack3, int64_t plan,
                               void* out, void* stream) {
  if (rows <= 0 || width <= 0 || table_size <= 0 || n_cols < 0 || (!plan && n_cols == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t stride = (width + 3) & ~int64_t{3};
  if ((stride >> 2) % 2 == 0) stride += 4;  // an odd count of words: the rows' bytes in distinct banks
  const int64_t shared = stride * swt::kThreads;
  if (shared > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const swt::UncasedRows a{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(key_lengths),
                           static_cast<const int2*>(table), rows, static_cast<int>(width), static_cast<int>(stride),
                           table_size};
  const auto blocks = static_cast<unsigned>((rows + swt::kThreads - 1) / swt::kThreads);
  auto* dst = static_cast<int32_t*>(out);
  const bool large = shared > 48 * 1024;  // rows over 188 B: past the default limit of dynamic shared memory
  if (plan) {
    if (large) {
      cudaFuncSetAttribute(swt::uncased_keys_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared));
    }
    cudaMemsetAsync(dst, 0, 2 * sizeof(int32_t), s);
    swt::uncased_keys_kernel<true><<<blocks, swt::kThreads, shared, s>>>(a, 0, 0, dst);
  } else {
    if (large) {
      cudaFuncSetAttribute(swt::uncased_keys_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared));
    }
    swt::uncased_keys_kernel<false><<<blocks, swt::kThreads, shared, s>>>(a, n_cols, pack3 != 0, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
