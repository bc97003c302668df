// K6 · MinHash fingerprints over byte n-grams of widths {5, 9, 17, 33}.
//
// Replaces the TPU kernel stringwars_tpu/ops/fingerprint.py::_fingerprint_pallas
// (_fp_kernel :119) and the XLA function fingerprint_xla (:250), which is
// what the JAX package runs: for each token and each dim d, the minimum over
// the valid gram positions p <= max(len - w, 0) of a_d * G_w[p] + b_d (mod
// 2^32), published as mix32 of that minimum, and the number of positions
// that reach it. Dims [wi*ndim/4, (wi+1)*ndim/4) use width wi.
//
// What bounds it on an H100: integer operations. A (position, dim) cell
// needs a multiply-add and a min; fingerprint-512d-16MB is 8.4 G cells, the
// fingerprints suite's call 18-148 M. The design:
//
// - One block of 4 warps per (token, width): four blocks a token, each with
//   the dims of its width only, so the suite's 256 documents give 1,024
//   blocks, about 8 an SM, where one block a token gave two. (Blocks of 8
//   warps were slower on the 16 MB row: a block's barriers hold more warps.)
// - Grams by a rolling hash: the block stages the row's bytes in shared
//   memory (bytes past the row's width read as zero, as the JAX
//   shift_left pads), and each thread computes a run of consecutive valid
//   positions, the first as the sum of w products x[p+t] * B^(w-1-t)
//   (powers from a table; four partial sums, a short chain), the rest by
//   G[p] = G[p-1] * B - x[p-1] * B^w + x[p-1+w]: two multiply-adds a gram.
// - Cells: each thread owns four dims and a slice of the positions (S
//   threads a group of four dims, S a power of two, up to the whole block
//   for small ndim), reads four grams at a time (one 16-byte shared load
//   that the threads of a slice share as a broadcast, for 16 cells) and
//   keeps only the min: two cells' values fold into it with one
//   __vimin3_u32, a DPX instruction of sm_90 (a three-way unsigned min; it
//   compiles to one VIMNMX3.U32, checked with cuobjdump -sass). A cell is
//   one IMAD and half a min, counts or not; two plain mins run as fast,
//   since the multiply-adds, not the mins, set the rate. Slices merge by
//   warp shuffles, warps by shared atomicMin.
// - Counts from the argmin. a_d is odd, so g -> a_d * g + b_d (mod 2^32) is
//   a bijection and a position reaches the min m exactly when its gram is
//   g* = a_d^-1 * (m - b_d) (the inverses come from the host with the
//   coefficients). After the cells the block puts each dim's g* in a small
//   open-addressed table in shared memory (dims with the same g* share a
//   slot), every valid position looks its gram up once, and a gram found
//   there adds one to its slot: a multiply, a shift and a shared load or two
//   a position, and an atomic only for the positions that reach a min.
#include "common.cuh"

namespace swt {

constexpr int kFpThreads = 128;    // threads a block
constexpr uint32_t kBase = 0x01000193u;  // FNV prime, odd
constexpr uint32_t kSlotMul = 0x9E3779B1u;
constexpr int kWidthCount = 4;
__constant__ int kGramWidths[kWidthCount] = {5, 9, 17, 33};

__constant__ uint32_t kPowers[34] = {  // B^0 .. B^33
    0x00000001u, 0x01000193u, 0x26027A69u, 0x3EE6B34Bu, 0x502C3F11u, 0x46A747C3u,
    0xFC55F7F9u, 0x34555CFBu, 0x5D615F21u, 0x2148C0F3u, 0x5887BE89u, 0xE6B0F1ABu,
    0xD38C7031u, 0x37149D23u, 0xD8735E19u, 0xD69D215Bu, 0x345B8241u, 0xAD0E0C53u,
    0xC01D66A9u, 0x17489C0Bu, 0xB24DA551u, 0x013B3E83u, 0x73436839u, 0xAC1D11BBu,
    0xACC2E961u, 0x57D563B3u, 0xF7EBF2C9u, 0x116F326Bu, 0xDD0C5E71u, 0x6B78ABE3u,
    0x11F69659u, 0xA02EAE1Bu, 0x447C1481u, 0x50544713u,
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

inline int64_t fp_round_up(int64_t x, int64_t k) { return (x + k - 1) / k * k; }

// Slots of the table of argmin grams for `dims` dims: a power of two of at
// least 8 x the dims, so that most lookups of a gram that is not there end
// at their first slot.
__host__ __device__ inline int target_slots(int dims) {
  int slots = 64;
  while (slots < 8 * dims) slots *= 2;
  return slots;
}

// One block's dynamic shared memory, in this order: the grams, the dims' mins and one count, the dims'
// coefficients (a, b, a^-1), with counts the table of argmin grams (keys,
// counts) and each dim's slot, then the bytes (the row and 32 zero bytes
// past the longest width).
inline size_t fingerprint_smem(int64_t width, int64_t dims, bool counts) {
  const int64_t table = counts ? 8 * target_slots(static_cast<int>(dims)) + 4 * fp_round_up(dims, 4) : 0;
  return static_cast<size_t>(4 * fp_round_up(width, 4) + 4 * fp_round_up(dims + 1, 4) + 12 * fp_round_up(dims, 4) +
                             table + fp_round_up(width + 36, 16));
}

constexpr uint32_t kFree = 0xFFFFFFFFu;  // a free slot's key; that gram is counted apart

template <bool kCounts>
__global__ void __launch_bounds__(kFpThreads)
fingerprint_kernel(const uint8_t* __restrict__ data, int width, const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ coef_a, const uint32_t* __restrict__ coef_b,
                   const uint32_t* __restrict__ coef_inv, int ndim, uint32_t* __restrict__ out_hashes,
                   int32_t* __restrict__ out_counts) {
  extern __shared__ uint4 smem[];
  const int dims = ndim / kWidthCount;
  const int slots = kCounts ? target_slots(dims) : 0;
  uint32_t* grams = reinterpret_cast<uint32_t*>(smem);  // 16-byte aligned
  uint32_t* mins = grams + (width + 3) / 4 * 4;         // [dims], then the count of the free key
  uint32_t* coef = mins + (dims + 4) / 4 * 4;           // [3][dims4]: a, b, a^-1 of the width's dims
  const int dims4 = (dims + 3) / 4 * 4;
  uint32_t* keys = coef + 3 * dims4;                    // [slots], counts only
  uint32_t* hits = keys + slots;                        // [slots], counts only
  int* where = reinterpret_cast<int*>(hits + slots);    // [dims], counts only: each dim's slot
  uint8_t* bytes = reinterpret_cast<uint8_t*>(where + (kCounts ? (dims + 3) / 4 * 4 : 0));

  const int64_t token = blockIdx.x;
  const int wi = blockIdx.y;
  const int w = kGramWidths[wi];
  const int given = lengths[token];
  const int len = given < 0 ? 0 : (given > width ? width : given);
  const int positions = min((len - w > 0 ? len - w : 0) + 1, width);
  const int tid = threadIdx.x, lane = tid & 31;

  const uint8_t* row = data + token * width;
  const int need = positions + w - 1;  // bytes the valid grams read
  for (int p = tid; p < need; p += kFpThreads) bytes[p] = p < width ? row[p] : 0;
  for (int s = tid; s < slots; s += kFpThreads) {
    keys[s] = kFree;
    hits[s] = 0;
  }
  for (int d = tid; d <= dims; d += kFpThreads) {
    mins[d] = d < dims ? 0xFFFFFFFFu : 0u;
    if (d < dims) {
      coef[d] = coef_a[wi * dims + d];
      coef[dims4 + d] = coef_b[wi * dims + d];
      if (kCounts) coef[2 * dims4 + d] = coef_inv[wi * dims + d];
    }
  }
  __syncthreads();

  // Grams: thread t rolls positions [t * per, (t + 1) * per), the first a
  // sum of w independent products (four partial sums, a short chain).
  const uint32_t power = kPowers[w];  // B^w
  const int per = (positions + kFpThreads - 1) / kFpThreads;
  const int first = tid * per;
  uint32_t g0 = 0, g1 = 0, g2 = 0, g3 = 0;
  if (first < positions) {
    const uint8_t* x = bytes + first;
    int t = 0;
    for (; t + 4 <= w; t += 4) {
      g0 += x[t] * kPowers[w - 1 - t];
      g1 += x[t + 1] * kPowers[w - 2 - t];
      g2 += x[t + 2] * kPowers[w - 3 - t];
      g3 += x[t + 3] * kPowers[w - 4 - t];
    }
    for (; t < w; ++t) g0 += x[t] * kPowers[w - 1 - t];
  }
  uint32_t g = g0 + g1 + g2 + g3;
  for (int p = first; p < first + per && p < positions; ++p) {
    if (p > first) g = g * kBase - bytes[p - 1] * power + bytes[p - 1 + w];
    grams[p] = g;
  }
  __syncthreads();

  // Cells: `split` threads for each group of four dims (a group past the
  // last dim repeats it), `groups` groups at a time.
  const int quads = (dims + 3) / 4;
  int split = kFpThreads;
  while (split > 1 && split * quads > kFpThreads) split /= 2;
  const int groups = kFpThreads / split;
  const int slice = tid % split;
  const int width_in_warp = split < 32 ? split : 32;
  const uint4* g4 = reinterpret_cast<const uint4*>(grams);
  const int gram_quads = positions >> 2;
  for (int base = 0; base < quads; base += groups) {
    const int quad = base + tid / split;
    const bool active = quad < quads;
    int d[4];
    uint32_t a[4], b[4], m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = min(4 * quad + i, dims - 1);
      m[i] = 0xFFFFFFFFu;
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = coef[d[i]];
        b[i] = coef[dims4 + d[i]];
      }
#pragma unroll 2
      for (int q = slice; q < gram_quads; q += split) {
        const uint4 v = g4[q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          m[i] = __vimin3_u32(m[i], v.x * a[i] + b[i], v.y * a[i] + b[i]);
          m[i] = __vimin3_u32(m[i], v.z * a[i] + b[i], v.w * a[i] + b[i]);
        }
      }
      for (int p = 4 * gram_quads + slice; p < positions; p += split)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = min(m[i], grams[p] * a[i] + b[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      for (int o = width_in_warp / 2; o > 0; o /= 2) m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
    if (active && lane % width_in_warp == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicMin(mins + d[i], m[i]);
  }
  __syncthreads();

  if (kCounts) {
    // Each dim's argmin gram into the table (the free key apart: slot -1).
    const int shift = 33 - __ffs(slots);  // slots = 2^(32 - shift)
    for (int i = tid; i < dims; i += kFpThreads) {
      const uint32_t target = coef[2 * dims4 + i] * (mins[i] - coef[dims4 + i]);
      int s = -1;
      if (target != kFree)
        for (s = (target * kSlotMul) >> shift;; s = (s + 1) & (slots - 1)) {
          const uint32_t prev = atomicCAS(keys + s, kFree, target);
          if (prev == kFree || prev == target) break;
        }
      where[i] = s;
    }
    __syncthreads();
    // Each valid position's gram looked up once.
#pragma unroll 4
    for (int p = tid; p < positions; p += kFpThreads) {
      const uint32_t gram = grams[p];
      int s = (gram * kSlotMul) >> shift;
      uint32_t key = keys[s];
      if (gram == kFree) {
        atomicAdd(mins + dims, 1u);
        continue;
      }
      while (key != kFree && key != gram) {
        s = (s + 1) & (slots - 1);
        key = keys[s];
      }
      if (key == gram) atomicAdd(hits + s, 1u);
    }
    __syncthreads();
  }

  for (int i = tid; i < dims; i += kFpThreads) {
    const int gd = wi * dims + i;
    out_hashes[token * ndim + gd] = mix32(mins[i]);
    if (kCounts) out_counts[token * ndim + gd] = static_cast<int32_t>(where[i] < 0 ? mins[dims] : hits[where[i]]);
  }
}

template <bool kCounts>
int fingerprint_launch(const uint8_t* data, int64_t rows, int64_t width, const int32_t* lengths, const uint32_t* a,
           const uint32_t* b, const uint32_t* inv, int64_t ndim, uint32_t* hashes, int32_t* counts, cudaStream_t s) {
  const size_t smem = fingerprint_smem(width, ndim / kWidthCount, kCounts);
  int device = 0, optin = 0;  // the card's shared memory a block may opt in to
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);  // rows too wide
  if (smem > 48 * 1024)  // past 48 KB a block must opt in
    cudaFuncSetAttribute(fingerprint_kernel<kCounts>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const dim3 grid(static_cast<unsigned>(rows), kWidthCount);
  fingerprint_kernel<kCounts><<<grid, kFpThreads, smem, s>>>(data, static_cast<int>(width), lengths, a, b, inv,
                                                           static_cast<int>(ndim), hashes, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// MinHash of `rows` tokens, rows of a padded uint8[rows, width] matrix with
// int32 lengths; coef_a/coef_b/coef_inv: uint32[ndim] on the device (coef_inv
// the inverses of coef_a mod 2^32); out_hashes uint32[rows, ndim];
// out_counts int32[rows, ndim] or null (no counts). Rows too wide for a
// block's shared memory on this card return cudaErrorInvalidValue.
extern "C" int sw_fingerprint(const void* data, int64_t rows, int64_t width, const void* lengths, const void* coef_a,
                              const void* coef_b, const void* coef_inv, int64_t ndim, void* out_hashes,
                              void* out_counts, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* a = static_cast<const uint32_t*>(coef_a);
  const auto* b = static_cast<const uint32_t*>(coef_b);
  const auto* inv = static_cast<const uint32_t*>(coef_inv);
  auto* hashes = static_cast<uint32_t*>(out_hashes);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_counts != nullptr)
    return swt::fingerprint_launch<true>(bytes, rows, width, lens, a, b, inv, ndim, hashes, static_cast<int32_t*>(out_counts), s);
  return swt::fingerprint_launch<false>(bytes, rows, width, lens, a, b, inv, ndim, hashes, nullptr, s);
}
