// The earlier uncased keys kernel (a thread a row: csrc/uncased_keys.cu
// before its ASCII and length-class paths), kept with its parts switched
// off one at a time for measurement only: tools/hopper_probes.py uncased
// times them beside the package's kernel on the same rows. Nothing of the
// package calls them.
//
// Modes of uncased_parent_run (mode 0 computes the function; the others are
// for timing alone and write no columns, or columns that are not the keys):
//   0  the kernel as it was: staging, the walk, the column stores;
//   1  staging alone: the rows into shared memory, then one word a row read
//      back (stored only where it equals `never`, which it does not);
//   2  the walk without stores: staging and the walk, the columns XORed into
//      one word a row, stored only where it equals `never`;
//   3  the stores alone: no rows read, each column made in registers from
//      its row and column index;
//   4  staging and the stores, no walk: the columns made in registers.
#include "../../stringwars_tpu_torch/csrc/common.cuh"

namespace swt_parent {

using swt::kThreads;

struct UncasedRows {
  const uint8_t* data;
  const int32_t* key_lengths;
  const int2* table;
  int64_t rows;
  int width;
  int stride;
  int64_t table_size;
};

struct FoldWalk {
  const uint8_t* row;
  const int2* table;
  int64_t table_size;
  int width, limit, pos;
  uint32_t next0, next1, next2;
  int left;

  __device__ __forceinline__ uint32_t take() {
    while (left == 0) {
      if (pos >= limit) return 0;
      const uint32_t b = row[pos++];
      if ((b & 0xC0) == 0x80) continue;
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

template <int kMode>
__global__ void __launch_bounds__(kThreads)
parent_kernel(UncasedRows a, int64_t n_cols, int pack3, uint32_t never, int32_t* __restrict__ out) {
  extern __shared__ uint32_t staged[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int here = static_cast<int>(min(static_cast<int64_t>(kThreads), a.rows - row0));
  const int64_t t = row0 + threadIdx.x;
  const bool live = threadIdx.x < here;
  if (kMode == 3) {
    for (int64_t c = 0; c < n_cols; ++c) {
      if (live) out[c * a.rows + t] = static_cast<int32_t>(static_cast<uint32_t>(t) ^ static_cast<uint32_t>(c));
    }
    return;
  }
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
  if (kMode == 1) {
    if (live && staged[threadIdx.x * (a.stride >> 2)] == never) out[t] = 1;
    return;
  }
  if (kMode == 4) {
    const uint32_t first = staged[threadIdx.x * (a.stride >> 2)];
    for (int64_t c = 0; c < n_cols; ++c) {
      if (live) out[c * a.rows + t] = static_cast<int32_t>(first ^ static_cast<uint32_t>(c));
    }
    return;
  }
  FoldWalk w{reinterpret_cast<const uint8_t*>(staged) + threadIdx.x * a.stride, a.table, a.table_size, a.width, 0, 0,
             0, 0, 0, 0};
  if (live) w.limit = min(max(__ldg(a.key_lengths + t), 0), a.width);
  uint32_t folded = 0;
  for (int64_t c = 0; c < n_cols; ++c) {
    uint32_t word = w.take();
    if (pack3) {
      const uint32_t second = w.take();
      const uint32_t third = w.take();
      word = (word << 18) | (second << 9) | third;
    }
    if (kMode == 0) {
      if (live) out[c * a.rows + t] = static_cast<int32_t>(word);
    } else {
      folded ^= word;
    }
  }
  if (kMode == 2 && live && folded == never) out[t] = 1;
}

template <int kMode>
int launch(const UncasedRows& a, int64_t n_cols, int64_t pack3, int64_t shared, void* out, cudaStream_t s) {
  if (shared > 48 * 1024) {
    cudaFuncSetAttribute(parent_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  }
  const auto blocks = static_cast<unsigned>((a.rows + kThreads - 1) / kThreads);
  parent_kernel<kMode><<<blocks, kThreads, kMode == 3 ? 0 : shared, s>>>(a, n_cols, pack3 != 0, 0xFFFFFFFFu,
                                                                         static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt_parent

// The earlier kernel's columns (mode 0) or one of its timing modes (above)
// of the uint8 [rows, width] rows; the arguments as sw_uncased_keys' (no
// plan mode).
extern "C" int uncased_parent_run(int64_t mode, const void* data, const void* key_lengths, int64_t rows, int64_t width,
                                  const void* table, int64_t table_size, int64_t n_cols, int64_t pack3, void* out,
                                  void* stream) {
  if (rows <= 0 || width <= 0 || table_size <= 0 || n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int64_t stride = (width + 3) & ~int64_t{3};
  if ((stride >> 2) % 2 == 0) stride += 4;
  const int64_t shared = stride * swt::kThreads;
  if (shared > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const swt_parent::UncasedRows a{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(key_lengths),
                                  static_cast<const int2*>(table), rows, static_cast<int>(width),
                                  static_cast<int>(stride), table_size};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return swt_parent::launch<0>(a, n_cols, pack3, shared, out, s);
    case 1: return swt_parent::launch<1>(a, n_cols, pack3, shared, out, s);
    case 2: return swt_parent::launch<2>(a, n_cols, pack3, shared, out, s);
    case 3: return swt_parent::launch<3>(a, n_cols, pack3, shared, out, s);
    case 4: return swt_parent::launch<4>(a, n_cols, pack3, shared, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
