// K9/K10 · class map: out[i] = table[clamp(cp[i], 0, size - 1)] over int32
// codepoints, for a dense u8 or int32 table.
//
// Replaces two TPU kernels: stringwars_tpu/ops/rulemap.py::_step_kernel
// (via _step_call <- step_map, the boundary walk sum(deltas[starts <= cp]))
// and stringwars_tpu/ops/lut.py::_lut_kernel (via _lut_call <- lut_map, the
// 128-lane gather windows). Both route around the TPU's slow gathers; a
// Hopper SM gathers through L1 natively, so one indexed load does the job
// of either. The step function is constant past its last boundary, so
// clamping to the table is exact for every codepoint, as on the TPU's LUT
// route (rulemap.py:288-298).
//
// What bounds it on an H100: one 4-byte read and one 4-byte write per
// position (128 Mi codepoints: 1 GiB, about 0.32 ms at 3.35 TB/s). The
// design keeps the stream at full width: 16-byte vector loads and stores in
// a grid-stride loop (scalar when a pointer is not 16-byte aligned), four
// lookups per vector. The table is read through the read-only cache, where
// text's codepoints hit a few hot lines of it: staging the 64 KiB class
// table in shared memory per block was slower on the 128 MB multilingual
// corpus (0.4100 against 0.3889 ms on an H100 SXM at 700 W).
//
// K10 · range map (second entry point, sw_range_map): out[i] =
// (add_base ? cp : 0) + table[clamp(cp, 0, size - 1)] over an int32 table,
// the add wrapping as int32 arithmetic does.
//
// Replaces stringwars_tpu/ops/rulemap.py::_range_kernel (via _range_call <-
// range_map): cp * [base == 0] + sum_r d_r * [lo_r <= cp <= hi_r and
// cp & pmask_r == par_r]. The TPU walks the rules per codepoint, or looks up
// the dense delta table in 128-lane windows (rulemap.py:326-342), both for
// its slow gathers. Here the wrapper stages that dense table
// (ops/rulemap.dense_delta_table, whose last entry matches no rule, so a
// clamped lookup past it reads 0) and the kernel is the class map's loop
// with the add of the codepoint fused: the same bound, 8 bytes a codepoint.
// The whole simple-fold table is about 125 k entries (0.5 MB): text touches
// a few lines of it, which stay in L1 and L2.
#include "common.cuh"

namespace swt {

template <typename T>
__device__ __forceinline__ int32_t lookup(const T* __restrict__ table, int32_t cp, int32_t last) {
  const int32_t i = cp < 0 ? 0 : (cp > last ? last : cp);
  return static_cast<int32_t>(__ldg(table + i));
}

// The range map's value: the looked-up entry, plus cp when kAddBase.
template <bool kAddBase, typename T>
__device__ __forceinline__ int32_t map_one(const T* __restrict__ table, int32_t cp, int32_t last) {
  const int32_t v = lookup(table, cp, last);
  return kAddBase ? static_cast<int32_t>(static_cast<uint32_t>(cp) + static_cast<uint32_t>(v)) : v;
}

// The grid-stride loop of both kernels: 16-byte vectors when both pointers
// are aligned, then the ragged tail one codepoint a thread.
template <bool kAddBase, typename T>
__device__ __forceinline__ void map_stream(const int32_t* __restrict__ cps, int64_t n, const T* __restrict__ table,
                                           int64_t size, int32_t* __restrict__ out, int aligned) {
  const int32_t last = static_cast<int32_t>(size - 1);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (aligned) {
    const int64_t vectors = n >> 2;
    const int4* src = reinterpret_cast<const int4*>(cps);
    int4* dst = reinterpret_cast<int4*>(out);
    for (int64_t i = tid; i < vectors; i += stride) {
      const int4 v = __ldg(src + i);
      dst[i] = make_int4(map_one<kAddBase>(table, v.x, last), map_one<kAddBase>(table, v.y, last),
                         map_one<kAddBase>(table, v.z, last), map_one<kAddBase>(table, v.w, last));
    }
    done = vectors << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) out[i] = map_one<kAddBase>(table, __ldg(cps + i), last);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
class_map_kernel(const int32_t* __restrict__ cps, int64_t n, const T* __restrict__ table, int64_t size,
                 int32_t* __restrict__ out, int aligned) {
  map_stream<false>(cps, n, table, size, out, aligned);
}

template <bool kAddBase>
__global__ void __launch_bounds__(kThreads)
range_map_kernel(const int32_t* __restrict__ cps, int64_t n, const int32_t* __restrict__ table, int64_t size,
                 int32_t* __restrict__ out, int aligned) {
  map_stream<kAddBase>(cps, n, table, size, out, aligned);
}

template <typename Kernel, typename T>
int launch(Kernel kernel, const int32_t* cps, int64_t n, const T* table, int64_t size, int32_t* out,
           cudaStream_t stream) {
  const int aligned = ((reinterpret_cast<uintptr_t>(cps) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t want = ((aligned ? n >> 2 : n) + kThreads - 1) / kThreads;
  const int grid = resident_grid(kernel, 0, want);
  kernel<<<grid, kThreads, 0, stream>>>(cps, n, table, size, out, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// cps: int32[n]; table: size entries of table_bytes (1: uint8, 4: int32)
// each, size in [1, 2^31); out: int32[n].
extern "C" int sw_class_map(const void* cps, int64_t n, const void* table, int64_t size, int64_t table_bytes, void* out,
                            void* stream) {
  if (n <= 0 || size <= 0 || size >= (int64_t{1} << 31) || (table_bytes != 1 && table_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const int32_t*>(cps);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (table_bytes == 1) {
    return swt::launch(swt::class_map_kernel<uint8_t>, c, n, static_cast<const uint8_t*>(table), size, o, s);
  }
  return swt::launch(swt::class_map_kernel<int32_t>, c, n, static_cast<const int32_t*>(table), size, o, s);
}

// cps: int32[n]; table: int32[size], size in [1, 2^31); add_base: 0 or 1;
// out: int32[n].
extern "C" int sw_range_map(const void* cps, int64_t n, const void* table, int64_t size, int64_t add_base, void* out,
                            void* stream) {
  if (n <= 0 || size <= 0 || size >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const int32_t*>(cps);
  const auto* t = static_cast<const int32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return add_base ? swt::launch(swt::range_map_kernel<true>, c, n, t, size, o, s)
                  : swt::launch(swt::range_map_kernel<false>, c, n, t, size, o, s);
}
