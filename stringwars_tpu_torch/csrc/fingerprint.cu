// K6 · MinHash fingerprints over byte n-grams of widths {5, 9, 17, 33}.
//
// Replaces the TPU kernel stringwars_tpu/ops/fingerprint.py::_fingerprint_pallas
// (_fp_kernel :119) and the XLA function fingerprint_xla (:250), which is
// what the JAX package runs: for each token and each dim d, the minimum over
// the valid gram positions p <= max(len - w, 0) of a_d * G_w[p] + b_d (mod
// 2^32), published as mix32 of that minimum, and the number of positions
// that reach it. Dims [wi*ndim/4, (wi+1)*ndim/4) use width wi.
//
// What bounds it on an H100: integer operations. A (position, dim) cell is
// one multiply-add and one unsigned min (two more with counts: a compare and
// a select); fingerprint-512d-16MB is 8.4 G cells. The design:
//
// - One block per token. The block stages the row's bytes in shared memory
//   and builds the gram hashes of all four widths there by log-doubling,
//   G_2k[p] = G_k[p] * B^k + G_k[p + k], then G_{2k+1}[p] = G_2k[p] * B +
//   x[p + 2k]: about nine operations per byte for all four widths. Bytes
//   past the row's width read as zero, as the JAX shift_left pads.
// - The cell loop reads the grams from shared memory four positions at a
//   time (one 16-byte load that every thread of a dim group shares as a
//   broadcast) and keeps (min, count) in registers. With ndim >= 256 each
//   thread owns whole dims; with fewer dims, S = 256 / ndim threads (a power
//   of two, at most 32) split a dim's positions and merge (min, count) with
//   warp shuffles, so every thread has work.
// - The count is over valid positions only, counted directly; the XLA form
//   counts every position and subtracts the duplicates it planted.
#include "common.cuh"

namespace swt {

constexpr uint32_t kBase = 0x01000193u;  // FNV prime, odd
constexpr int kWidthCount = 4;
__constant__ int kGramWidths[kWidthCount] = {5, 9, 17, 33};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Shared memory of one block for rows of `width` bytes (width % 4 == 0):
// the four gram arrays, two level buffers, the bytes.
inline size_t fingerprint_smem(int64_t width) { return static_cast<size_t>(width) * (4 * kWidthCount + 2 * 4 + 1); }

template <bool kCounts>
__device__ __forceinline__ void cell(uint32_t g, uint32_t a, uint32_t b, uint32_t& m, int& c) {
  const uint32_t v = g * a + b;
  if (kCounts) {
    c = v < m ? 1 : c + (v == m ? 1 : 0);
  }
  m = min(m, v);
}

template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const uint8_t* __restrict__ data, int width, const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ coef_a, const uint32_t* __restrict__ coef_b, int ndim,
                   uint32_t* __restrict__ out_hashes, int32_t* __restrict__ out_counts) {
  extern __shared__ uint4 smem[];
  uint32_t* grams = reinterpret_cast<uint32_t*>(smem);  // [kWidthCount][width]
  uint32_t* level_a = grams + kWidthCount * width;
  uint32_t* level_b = level_a + width;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(level_b + width);

  const int64_t token = blockIdx.x;
  const uint8_t* row = data + token * width;
  const int given = lengths[token];
  const int len = given < 0 ? 0 : (given > width ? width : given);
  const int tid = threadIdx.x;

  for (int p = tid; p < width; p += kThreads) {
    const uint8_t x = row[p];
    bytes[p] = x;
    level_a[p] = x;
  }
  __syncthreads();

  // Log-doubling: after the step with k, `cur` holds G_2k; widths 2k + 1
  // are one more byte on top of it.
  uint32_t* cur = level_a;
  uint32_t* nxt = level_b;
  uint32_t power = kBase;  // B^k
  int gram = 0;
  for (int k = 1; k <= 16; k *= 2) {
    for (int p = tid; p < width; p += kThreads) {
      nxt[p] = cur[p] * power + (p + k < width ? cur[p + k] : 0u);
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    power *= power;
    if (2 * k + 1 == kGramWidths[gram]) {
      uint32_t* g = grams + gram * width;
      for (int p = tid; p < width; p += kThreads) {
        g[p] = cur[p] * kBase + (p + 2 * k < width ? uint32_t(bytes[p + 2 * k]) : 0u);
      }
      ++gram;
    }
  }
  __syncthreads();

  // Cells: S threads per dim (S a power of two dividing 32), ndim dims.
  int split = 1;
  while (split < 32 && split * 2 * ndim <= kThreads) split *= 2;
  const int groups = kThreads / split;
  const int slice = tid % split;
  const int per_width = ndim / kWidthCount;
  for (int base = 0; base < ndim; base += groups) {
    const int d = base + tid / split;
    const bool active = d < ndim;
    uint32_t m = 0xFFFFFFFFu;
    int c = 0;
    if (active) {
      const int wi = d / per_width;
      const int w = kGramWidths[wi];
      const int positions = min((len - w > 0 ? len - w : 0) + 1, width);
      const uint32_t a = coef_a[d], b = coef_b[d];
      const uint4* g4 = reinterpret_cast<const uint4*>(grams + wi * width);
      const int quads = positions >> 2;
      for (int q = slice; q < quads; q += split) {
        const uint4 g = g4[q];
        cell<kCounts>(g.x, a, b, m, c);
        cell<kCounts>(g.y, a, b, m, c);
        cell<kCounts>(g.z, a, b, m, c);
        cell<kCounts>(g.w, a, b, m, c);
      }
      const uint32_t* g1 = grams + wi * width;
      for (int p = 4 * quads + slice; p < positions; p += split) cell<kCounts>(g1[p], a, b, m, c);
    }
    for (int o = split / 2; o > 0; o /= 2) {
      const uint32_t m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const int c2 = __shfl_xor_sync(0xffffffffu, c, o);
      if (kCounts) c = m2 < m ? c2 : (m2 == m ? c + c2 : c);
      m = min(m, m2);
    }
    if (active && slice == 0) {
      out_hashes[token * ndim + d] = mix32(m);
      if (kCounts) out_counts[token * ndim + d] = c;
    }
  }
}

}  // namespace swt

// MinHash of `rows` tokens, rows of a padded uint8[rows, width] matrix with
// int32 lengths; coef_a/coef_b: uint32[ndim] on the device; out_hashes
// uint32[rows, ndim]; out_counts int32[rows, ndim] or null (no counts).
extern "C" int sw_fingerprint(const void* data, int64_t rows, int64_t width, const void* lengths, const void* coef_a,
                              const void* coef_b, int64_t ndim, void* out_hashes, void* out_counts, void* stream) {
  const size_t smem = swt::fingerprint_smem(width);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* a = static_cast<const uint32_t*>(coef_a);
  const auto* b = static_cast<const uint32_t*>(coef_b);
  auto* hashes = static_cast<uint32_t*>(out_hashes);
  if (out_counts != nullptr) {
    cudaFuncSetAttribute(swt::fingerprint_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    swt::fingerprint_kernel<true><<<static_cast<unsigned>(rows), swt::kThreads, smem, s>>>(
        bytes, static_cast<int>(width), lens, a, b, static_cast<int>(ndim), hashes, static_cast<int32_t*>(out_counts));
  } else {
    cudaFuncSetAttribute(swt::fingerprint_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    swt::fingerprint_kernel<false><<<static_cast<unsigned>(rows), swt::kThreads, smem, s>>>(
        bytes, static_cast<int>(width), lens, a, b, static_cast<int>(ndim), hashes, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
