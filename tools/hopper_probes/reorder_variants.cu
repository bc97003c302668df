// The earlier canonical-reordering kernel (one thread a row, an insertion
// sort over the whole row) and the package's warp-a-row kernel
// (stringwars_tpu_torch/csrc/normalize.cu) at other settings (rows a warp
// looks at together, blocks an SM, 16-byte loads or not), kept for
// measurement only: tools/hopper_probes.py reorder times them on the same
// rows. Nothing of the package calls them.
#include "../../stringwars_tpu_torch/csrc/normalize.cu"

namespace parent {

using swt::kThreads;

__device__ __forceinline__ int32_t clamped(int32_t v, int32_t size) { return v < 0 ? 0 : (v >= size ? size - 1 : v); }

__global__ void __launch_bounds__(kThreads)
parent_reorder_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int64_t rows, int64_t width,
                      const uint8_t* __restrict__ ccc, int32_t ccc_size) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  int32_t* row = data + r * width;
  const int64_t n = min(static_cast<int64_t>(__ldg(counts + r)), width);
  for (int64_t i = 1; i < n; ++i) {
    const int32_t x = row[i];
    const int32_t c = __ldg(ccc + clamped(x, ccc_size));
    if (c == 0) continue;
    int64_t j = i;
    while (j > 0) {
      const int32_t y = row[j - 1];
      if (__ldg(ccc + clamped(y, ccc_size)) <= c) break;
      row[j] = y;
      --j;
    }
    if (j != i) row[j] = x;
  }
}

}  // namespace parent

extern "C" int reorder_parent_run(void* data, const void* counts, int64_t rows, int64_t width, const void* ccc,
                                  int64_t ccc_size, void* stream) {
  if (rows <= 0 || width <= 0 || ccc_size <= 0 || ccc_size >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + swt::kThreads - 1) / swt::kThreads;
  parent::parent_reorder_kernel<<<static_cast<unsigned>(blocks), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), rows, width, static_cast<const uint8_t*>(ccc),
      static_cast<int32_t>(ccc_size));
  return static_cast<int>(cudaGetLastError());
}

// The package's kernel at (16-byte loads, rows a warp, blocks an SM) = the
// variant's settings.
extern "C" int reorder_variant_run(int64_t variant, void* data, const void* counts, int64_t rows, int64_t width,
                                   const void* ccc, int64_t ccc_size, void* stream) {
  if (rows <= 0 || width <= 0 || ccc_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel, int per_warp) {
    const int per_block = swt::kReorderThreads / 32 * per_warp;
    const int grid = swt::resident_grid(kernel, 0, (rows + per_block - 1) / per_block, swt::kReorderThreads);
    kernel<<<grid, swt::kReorderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), rows, width, static_cast<const uint8_t*>(ccc),
        static_cast<int32_t>(ccc_size));
  };
  switch (variant) {
    case 0: launch(swt::nf_reorder_kernel<true, 1, 3>, 1); break;
    case 1: launch(swt::nf_reorder_kernel<true, 1, 4>, 1); break;
    case 2: launch(swt::nf_reorder_kernel<true, 2, 3>, 2); break;
    case 3: launch(swt::nf_reorder_kernel<true, 2, 4>, 2); break;
    case 4: launch(swt::nf_reorder_kernel<false, 1, 4>, 1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace probe {

// The package kernel's loads alone: kRows rows a warp, a lane 16 bytes of
// each row's first 128 codepoints (and of the next 128 where the row holds
// more, loaded with the first when kBoth), the next rows' counts loaded
// ahead; a lane adds up what it read and writes the sum where it is a
// codepoint no row holds (never), so that nothing is optimized away.
template <int kRows, bool kBoth>
__global__ void __launch_bounds__(swt::kReorderThreads, 3)
loads_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int64_t rows, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (swt::kReorderThreads / 32);
  int64_t r = static_cast<int64_t>(blockIdx.x) * (swt::kReorderThreads / 32) + (threadIdx.x >> 5);
  int32_t count[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) count[q] = r + q * warps < rows ? __ldg(counts + r + q * warps) : 0;
  int32_t sum = 0;
  for (; r < rows; r += kRows * warps) {
    int4 v[kRows], w[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int64_t rq = r + q * warps;
      const int32_t n = rq < rows ? min(count[q], static_cast<int32_t>(width)) : 0;
      v[q] = swt::load4<true>(data + rq * width, 4 * lane, n);
      w[q] = kBoth ? swt::load4<true>(data + rq * width, 128 + 4 * lane, n) : make_int4(0, 0, 0, 0);
      if (!kBoth && n > 128) w[q] = swt::load4<true>(data + rq * width, 128 + 4 * lane, n);
      count[q] = rq + kRows * warps < rows ? __ldg(counts + rq + kRows * warps) : 0;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) sum += v[q].x ^ v[q].y ^ v[q].z ^ v[q].w ^ w[q].x ^ w[q].y ^ w[q].z ^ w[q].w;
  }
  if (sum == 0x7FFFFFFF) data[0] = sum;
}

}  // namespace probe

extern "C" int reorder_loads_run(int64_t variant, void* data, const void* counts, int64_t rows, int64_t width, void* stream) {
  if (rows <= 0 || width % 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel, int per_warp) {
    const int per_block = swt::kReorderThreads / 32 * per_warp;
    const int grid = swt::resident_grid(kernel, 0, (rows + per_block - 1) / per_block, swt::kReorderThreads);
    kernel<<<grid, swt::kReorderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), rows, width);
  };
  switch (variant) {
    case 0: launch(probe::loads_kernel<1, false>, 1); break;
    case 1: launch(probe::loads_kernel<2, false>, 2); break;
    case 2: launch(probe::loads_kernel<2, true>, 2); break;
    case 3: launch(probe::loads_kernel<4, true>, 4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
