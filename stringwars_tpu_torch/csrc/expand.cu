// K10 · fused expand-and-compact: decode -> 1..N table map -> in-row
// compaction, over rows of 32 or 64 elements (UTF-8 bytes or int32
// codepoints). The case fold of fold_tokens_fused, and NFD/NFKD
// decomposition rows later.
//
// Replaces stringwars_tpu/ops/casefold_pallas.py::_make_kernel (via
// _expand_stage <- expand_compact_rows, fold_tokens_fused). Per row, with
// e = element, len = the row's length:
//   is_lead[e] = (utf8 ? (b & 0xC0) != 0x80 : true) && e < len
//   cp[e]      = the UTF-8 decode at e from the next three bytes of the row
//                (0 past it; a byte >= 0xF0 decodes as four bytes), or b
//   t1, t2, t3 = T1/T2/T3[clamp(cp, 0, size - 1)]          (T2, T3 may be absent: 0)
//   length[e]  = is_lead ? t1 >>> 16 : 0
//   channels   = (cp + sext16(t1)) & 0xFFFF, t2 & 0xFFFF, t2 >>> 16, t3 & 0xFFFF
//   out slot d = channel (d - start[src]) of the element src whose span
//                covers d (channel 0 where that is not in [1, max_exp)),
//                0 from the row's total on; counts[row] = total.
// The TPU kernel splits each table into 128-lane windows behind a page map
// and finds each slot's source lane by a binary search over lane gathers:
// both work around its gathers. Here the tables are dense int32 arrays read
// through the read-only cache, and each element writes its own outputs.
//
// What bounds it on an H100: the bytes. A 32-byte UTF-8 row at max_exp 2
// reads 32 + 4 bytes and writes 256 + 4 (4.2 M rows of the 128 MB corpus:
// about 1.24 GB, 0.37 ms at 3.35 TB/s); the table lookups hit the few lines
// of the BMP tables that text touches, in L1. Design: one warp per row (a
// lane holds elements lane and lane + 32 for rows of 64), rows in a
// grid-stride loop. The warp stages its row in shared memory (the decode
// reads the next three bytes there), takes the inclusive sum of the lengths
// by shuffles, and each lead lane writes its outputs into the warp's output
// row in shared memory, zeroed first; the warp then stores the row with
// 16-byte vectors, so the global writes are whole and coalesced.
#include "common.cuh"

namespace swt {

constexpr int kRowWarps = kThreads / 32;

__device__ __forceinline__ int32_t clamp_index(int32_t cp, int32_t last) { return cp < 0 ? 0 : (cp > last ? last : cp); }

template <bool kUtf8, int kGroup, int kMaxExp>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const void* __restrict__ data, const int32_t* __restrict__ lengths, int64_t rows,
              const int32_t* __restrict__ t1, const int32_t* __restrict__ t2, const int32_t* __restrict__ t3,
              int32_t size, int32_t* __restrict__ out, int32_t* __restrict__ counts) {
  constexpr int kPer = kGroup / 32;       // elements per lane
  constexpr int kOut = kMaxExp * kGroup;  // output slots per row, a multiple of 32
  __shared__ int32_t in_s[kRowWarps][kGroup + 4];
  __shared__ __align__(16) int32_t out_s[kRowWarps][kOut];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* row_in = in_s[warp];
  int32_t* row_out = out_s[warp];
  const int32_t last = size - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp; r < rows; r += stride) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * 32 + lane;
      row_in[e] = kUtf8 ? static_cast<int32_t>(__ldg(static_cast<const uint8_t*>(data) + r * kGroup + e))
                        : __ldg(static_cast<const int32_t*>(data) + r * kGroup + e);
    }
    if (lane < 4) row_in[kGroup + lane] = 0;  // the decode reads 0 past the row
#pragma unroll
    for (int d = lane; d < kOut; d += 32) row_out[d] = 0;
    const int32_t len = __ldg(lengths + r);
    __syncwarp();
    int32_t carry = 0;  // the row's sum of lengths before this pass of elements
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * 32 + lane;
      const int32_t b = row_in[e];
      bool lead = e < len;
      int32_t cp = b;
      if (kUtf8) {
        lead = lead && (b & 0xC0) != 0x80;
        const int32_t b1 = row_in[e + 1] & 0x3F, b2 = row_in[e + 2] & 0x3F, b3 = row_in[e + 3] & 0x3F;
        if (b >= 0xF0) {
          cp = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3;
        } else if (b >= 0xE0) {
          cp = ((b & 0x0F) << 12) | (b1 << 6) | b2;
        } else if (b >= 0xC0) {
          cp = ((b & 0x1F) << 6) | b1;
        }
      }
      const int32_t i = clamp_index(cp, last);
      const uint32_t v1 = static_cast<uint32_t>(__ldg(t1 + i));
      const int32_t length = lead ? static_cast<int32_t>(v1 >> 16) : 0;
      int32_t incl = length;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const int32_t start = carry + incl - length;
      carry += __shfl_sync(0xffffffffu, incl, 31);
      if (length > 0 && start < kOut) {
        const uint32_t v2 = (kMaxExp >= 2 && t2 != nullptr) ? static_cast<uint32_t>(__ldg(t2 + i)) : 0u;
        const uint32_t v3 = (kMaxExp >= 4 && t3 != nullptr) ? static_cast<uint32_t>(__ldg(t3 + i)) : 0u;
        const int32_t delta = static_cast<int32_t>(static_cast<int16_t>(v1 & 0xFFFFu));
        const int32_t c0 = static_cast<int32_t>((static_cast<uint32_t>(cp) + static_cast<uint32_t>(delta)) & 0xFFFFu);
        const int32_t c1 = static_cast<int32_t>(v2 & 0xFFFFu), c2 = static_cast<int32_t>(v2 >> 16);
        const int32_t c3 = static_cast<int32_t>(v3 & 0xFFFFu);
        const int32_t end = min(start + length, kOut);
        for (int32_t d = start; d < end; ++d) {
          const int32_t c = d - start;  // the channel; 0 where the kernel holds none
          row_out[d] = (c == 1 && kMaxExp > 1) ? c1 : (c == 2 && kMaxExp > 2) ? c2 : (c == 3 && kMaxExp > 3) ? c3 : c0;
        }
      }
    }
    __syncwarp();
    const int4* src = reinterpret_cast<const int4*>(row_out);
    int4* dst = reinterpret_cast<int4*>(out + r * kOut);
#pragma unroll
    for (int q = lane; q < kOut / 4; q += 32) dst[q] = src[q];
    if (lane == 0) counts[r] = carry;
    __syncwarp();  // the next row reuses the warp's shared rows
  }
}

template <bool kUtf8, int kGroup, int kMaxExp>
int launch_expand(const void* data, const int32_t* lengths, int64_t rows, const int32_t* t1, const int32_t* t2,
                  const int32_t* t3, int32_t size, int32_t* out, int32_t* counts, cudaStream_t stream) {
  const auto kernel = expand_kernel<kUtf8, kGroup, kMaxExp>;
  const int grid = resident_grid(kernel, 0, (rows + kRowWarps - 1) / kRowWarps);
  kernel<<<grid, kThreads, 0, stream>>>(data, lengths, rows, t1, t2, t3, size, out, counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool kUtf8, int kGroup>
int by_max_exp(int64_t max_exp, const void* data, const int32_t* lengths, int64_t rows, const int32_t* t1,
               const int32_t* t2, const int32_t* t3, int32_t size, int32_t* out, int32_t* counts, cudaStream_t stream) {
  switch (max_exp) {
    case 1: return launch_expand<kUtf8, kGroup, 1>(data, lengths, rows, t1, t2, t3, size, out, counts, stream);
    case 2: return launch_expand<kUtf8, kGroup, 2>(data, lengths, rows, t1, t2, t3, size, out, counts, stream);
    case 3: return launch_expand<kUtf8, kGroup, 3>(data, lengths, rows, t1, t2, t3, size, out, counts, stream);
    default: return launch_expand<kUtf8, kGroup, 4>(data, lengths, rows, t1, t2, t3, size, out, counts, stream);
  }
}

}  // namespace swt

// data: [rows, group] of uint8 (utf8) or int32; lengths: int32[rows], each
// at most group; t1 (and t2, t3, or null): int32[size]; max_exp in [1, 4];
// out: int32[rows, max_exp * group] (16-byte aligned); counts: int32[rows].
extern "C" int sw_expand(const void* data, int64_t rows, int64_t group, int64_t utf8, const void* lengths,
                         const void* t1, const void* t2, const void* t3, int64_t size, int64_t max_exp, void* out,
                         void* counts, void* stream) {
  if (rows <= 0 || (group != 32 && group != 64) || max_exp < 1 || max_exp > 4 || size <= 0 ||
      size >= (int64_t{1} << 31) || t1 == nullptr || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto* a = static_cast<const int32_t*>(t1);
  const auto* b = static_cast<const int32_t*>(t2);
  const auto* c = static_cast<const int32_t*>(t3);
  const auto n = static_cast<int32_t>(size);
  auto* o = static_cast<int32_t*>(out);
  auto* k = static_cast<int32_t*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (utf8) {
    return group == 32 ? swt::by_max_exp<true, 32>(max_exp, data, l, rows, a, b, c, n, o, k, s)
                       : swt::by_max_exp<true, 64>(max_exp, data, l, rows, a, b, c, n, o, k, s);
  }
  return group == 32 ? swt::by_max_exp<false, 32>(max_exp, data, l, rows, a, b, c, n, o, k, s)
                     : swt::by_max_exp<false, 64>(max_exp, data, l, rows, a, b, c, n, o, k, s);
}
