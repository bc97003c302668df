// Variants of the Poly1305 MAC for measurement only. The earlier kernels (one
// thread a run of 16 consecutive blocks, a shared-memory tree a block, a
// one-block fold launch): the whole, its runs kernel with its loads alone or
// its products alone, and its fold launch alone. The lane-interleaved kernel
// of stringwars_tpu_torch/csrc/chacha.cu at other batch depths and
// occupancies, and its loads alone and its products alone. The arithmetic
// helpers are the package's. Built and timed by tools/hopper_probes.py poly;
// nothing of the package calls it.
#include "../../stringwars_tpu_torch/csrc/chacha.cu"

namespace {

using swt::P130;
constexpr int kThreads = 256;
constexpr int kRun = 16;
constexpr int kLevels = 8;
constexpr int64_t kSpan = kRun * kThreads;

__device__ __forceinline__ P130 tree_combine(P130 h, const P130 (&pw)[kLevels], P130 (&v)[kThreads]) {
  const int t = threadIdx.x;
  v[t] = h;
#pragma unroll
  for (int j = 0; j < kLevels; ++j) {
    __syncthreads();
    const int s = 1 << j;
    if ((t & (2 * s - 1)) == 0) {
      h = swt::p130_add(swt::p130_mul(h, pw[j]), v[t + s]);
      v[t] = h;
    }
  }
  return h;
}

// kLoads: the blocks are read (else made from the thread's index); kProducts:
// the Horner runs and the tree (else the words are folded by XOR and stored
// only where they hit a value no input gives, so the loads stay).
template <bool kLoads, bool kProducts>
__global__ void __launch_bounds__(kThreads)
runs_kernel(swt::PolyInput in, const uint8_t* __restrict__ key, uint32_t* __restrict__ partials) {
  __shared__ P130 pw[kLevels];
  __shared__ P130 v[kThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSpan + threadIdx.x * kRun - in.lead;
  uint32_t w[kRun][4], hibit[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (kLoads) {
      hibit[j] = swt::poly_block(in, first + j, w[j]);
    } else {
      const uint32_t x = static_cast<uint32_t>(first + j) * 0x9E3779B1u;
      w[j][0] = x; w[j][1] = x ^ 0x55555555u; w[j][2] = x + 7u; w[j][3] = x >> 3;
      hibit[j] = 1u;
    }
  }
  if (!kProducts) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc ^= w[j][0] ^ w[j][1] ^ w[j][2] ^ w[j][3] ^ hibit[j];
    if (acc == 0x9E3779B9u + key[0]) partials[blockIdx.x * 5] = acc;
    return;
  }
  const P130 r = swt::poly_r(key);
  if (threadIdx.x == 0) {
    P130 p = r;
    for (int k = 1; k < kRun; k <<= 1) p = swt::p130_mul(p, p);
    for (int j = 0; j < kLevels; ++j) {
      pw[j] = p;
      p = swt::p130_mul(p, p);
    }
  }
  P130 h = swt::p130_block(w[0][0], w[0][1], w[0][2], w[0][3], hibit[0]);
#pragma unroll
  for (int j = 1; j < kRun; ++j) {
    h = swt::p130_add(swt::p130_mul(h, r), swt::p130_block(w[j][0], w[j][1], w[j][2], w[j][3], hibit[j]));
  }
  h = tree_combine(h, pw, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) partials[blockIdx.x * 5 + i] = h.h[i];
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(const uint32_t* __restrict__ partials, int64_t count, const uint8_t* __restrict__ key, uint8_t* __restrict__ tag) {
  __shared__ P130 pw[kLevels];
  __shared__ P130 big;
  __shared__ P130 v[kThreads];
  const int64_t per = (count + kThreads - 1) / kThreads;
  const int64_t lead = per * kThreads - count;
  const P130 r = swt::poly_r(key);
  if (threadIdx.x == 0) {
    P130 p = r;
    for (int64_t k = 1; k < kSpan; k <<= 1) p = swt::p130_mul(p, p);
    big = p;
    P130 q = p;
    for (int64_t e = per - 1; e > 0; e >>= 1) {
      if (e & 1) q = swt::p130_mul(q, p);
      p = swt::p130_mul(p, p);
    }
    for (int j = 0; j < kLevels; ++j) {
      pw[j] = q;
      q = swt::p130_mul(q, q);
    }
  }
  __syncthreads();
  const P130 R = big;
  P130 h = swt::p130_zero();
  for (int64_t k = 0; k < per; ++k) {
    const int64_t g = threadIdx.x * per + k - lead;
    P130 x = swt::p130_zero();
    if (g >= 0) {
#pragma unroll
      for (int i = 0; i < 5; ++i) x.h[i] = partials[g * 5 + i];
    }
    h = swt::p130_add(swt::p130_mul(h, R), x);
  }
  h = tree_combine(h, pw, v);
  if (threadIdx.x == 0) swt::poly_finish(h, r, key, tag);
}

// The lane-interleaved kernel's loop with its loads alone (folded by XOR)
// or its products alone (blocks made in registers).
template <bool kLoads>
__global__ void __launch_bounds__(256, swt::kPolyBlocksPerSm)
lanes_part_kernel(swt::PolyInput in, const uint8_t* __restrict__ key, int64_t q, uint32_t* __restrict__ sink) {
  constexpr int kDepth = swt::kPolyDepth;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * warps + warp) * 32 * q + lane - in.lead;
  swt::PolyBatch<kDepth> a, b;
  if (kLoads) {
    uint32_t acc = 0;
    for (int64_t t0 = 0; t0 < q; t0 += kDepth) {
      swt::poly_load(in, base, t0, q, a);
#pragma unroll
      for (int d = 0; d < kDepth; ++d) acc ^= a.w[d][0] ^ a.w[d][1] ^ a.w[d][2] ^ a.w[d][3];
      acc ^= a.hibit;
    }
    if (acc == 0x9E3779B9u + key[0]) sink[0] = acc;
    return;
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const uint32_t x = static_cast<uint32_t>(base + d) * 0x9E3779B1u;
    a.w[d][0] = x; a.w[d][1] = x ^ 0x55555555u; a.w[d][2] = x + 7u; a.w[d][3] = x >> 3;
    b.w[d][0] = x + 1u; b.w[d][1] = x; b.w[d][2] = x ^ 3u; b.w[d][3] = x >> 5;
  }
  a.hibit = b.hibit = (1u << kDepth) - 1u;
  const P130 r32 = swt::p130_shfl(swt::p130_powers(swt::poly_r(key), 32), 31);
  P130 h = swt::p130_zero();
  for (int64_t t0 = 0; t0 < q; t0 += 2 * kDepth) {
    h = swt::poly_horner(h, a, r32, t0, q);
    h = swt::poly_horner(h, b, r32, t0 + kDepth, q);
  }
  if (h.h[0] == 0x3FFFFFFu + key[1]) sink[1] = h.h[1];
}

template <int kDepth, int kMinBlocks>
void launch_lanes(const swt::PolyInput& in, const uint8_t* k, int64_t q, int64_t warps, int64_t grid, uint32_t* parts,
                  uint8_t* out, cudaStream_t s) {
  swt::poly_lanes_kernel<kDepth, kMinBlocks><<<static_cast<unsigned>(grid), static_cast<unsigned>(32 * warps), 0, s>>>(
      in, k, q, parts, out);
  if (grid > 1) swt::poly_fold_kernel<<<1, 32, 0, s>>>(parts, grid, q, k, out);
}

}  // namespace

// variant 0: the earlier MAC whole (runs, then fold); 1: its runs kernel,
// loads alone; 2: its runs kernel, products alone; 3: its fold launch alone;
// partials: ceil(blocks / 4096) x 5 words. The lane-interleaved kernel under
// the geometry (q, warps, grid) (partials: grid x 5 words), then its fold:
// 4: batches of 4 groups, 2 blocks an SM; 5: 8 groups, 2 blocks; 6: 4
// groups, 4 blocks; 7: 8 groups, 1 block; 8: its loads alone; 9: its
// products alone (both at the package's depth and blocks an SM).
extern "C" int poly_variant_run(int64_t variant, const void* aad, int64_t aad_len, const void* msg, int64_t msg_len,
                                int64_t aead, const void* key, int64_t q, int64_t warps, int64_t grid, void* partials,
                                void* tag, void* stream) {
  swt::PolyInput in;
  in.aad = static_cast<const uint8_t*>(aad);
  in.msg = static_cast<const uint8_t*>(msg);
  in.aad_len = aead ? aad_len : 0;
  in.msg_len = msg_len;
  in.aad_blocks = (in.aad_len + 15) / 16;
  in.msg_blocks = (msg_len + 15) / 16;
  in.aead = aead ? 1 : 0;
  in.blocks = aead ? in.aad_blocks + in.msg_blocks + 1 : in.msg_blocks;
  in.direct_lo = in.aad_blocks;
  in.direct_hi = in.direct_lo + ((reinterpret_cast<uintptr_t>(msg) & 15) == 0 ? msg_len / 16 : 0);
  const int64_t count = (in.blocks + kSpan - 1) / kSpan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint8_t*>(key);
  auto* parts = static_cast<uint32_t*>(partials);
  auto* out = static_cast<uint8_t*>(tag);
  if (variant >= 4) {
    in.lead = grid * warps * 32 * q - in.blocks;
    switch (variant) {
      case 4: launch_lanes<4, 2>(in, k, q, warps, grid, parts, out, s); break;
      case 5: launch_lanes<8, 2>(in, k, q, warps, grid, parts, out, s); break;
      case 6: launch_lanes<4, 4>(in, k, q, warps, grid, parts, out, s); break;
      case 7: launch_lanes<8, 1>(in, k, q, warps, grid, parts, out, s); break;
      case 8: lanes_part_kernel<true><<<static_cast<unsigned>(grid), static_cast<unsigned>(32 * warps), 0, s>>>(in, k, q, parts); break;
      case 9: lanes_part_kernel<false><<<static_cast<unsigned>(grid), static_cast<unsigned>(32 * warps), 0, s>>>(in, k, q, parts); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  in.lead = count * kSpan - in.blocks;
  const auto blocks = static_cast<unsigned>(count > 0 ? count : 1);
  switch (variant) {
    case 0:
      if (count > 0) runs_kernel<true, true><<<blocks, kThreads, 0, s>>>(in, k, parts);
      fold_kernel<<<1, kThreads, 0, s>>>(parts, count, k, out);
      break;
    case 1: runs_kernel<true, false><<<blocks, kThreads, 0, s>>>(in, k, parts); break;
    case 2: runs_kernel<false, true><<<blocks, kThreads, 0, s>>>(in, k, parts); break;
    case 3: fold_kernel<<<1, kThreads, 0, s>>>(parts, count, k, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
