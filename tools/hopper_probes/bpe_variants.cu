// Variants of the BPE merge-loop kernel (stringwars_tpu_torch/csrc/bpe.cu)
// for measurement only: which of its parts pay. Built once per setting by
// tools/hopper_probes.py bpe (nvcc -D...) and called through its C entry
// point, which takes the same arguments as sw_bpe; nothing of the package
// calls it. The settings, each the kernel's own value by default:
//   CHUNK   consecutive rows a warp takes (8)
//   GMIN_LG log2 of the smallest lane group (2; 1 needs CHUNK >= 16)
//   REDUX   the group's minimum by one __reduce_min_sync over its mask (1),
//           or by a butterfly of log2(g) xor-shuffles (0)
//   SLOTS   entries a bucket of the hashed table (2; 4 reads two 16-byte
//           halves a bucket; the table is built with as many)
//   MINB    blocks an SM that __launch_bounds__ asks for (8, the kernel's
//           32 registers; 0 asks for none)
#include "../../stringwars_tpu_torch/csrc/common.cuh"

#ifndef CHUNK
#define CHUNK 8
#endif
#ifndef GMIN_LG
#define GMIN_LG 2
#endif
#ifndef REDUX
#define REDUX 1
#endif
#ifndef SLOTS
#define SLOTS 2
#endif
#ifndef MINB
#define MINB 8
#endif
#if MINB > 0
#define BPE_BOUNDS __launch_bounds__(kThreads, MINB)
#else
#define BPE_BOUNDS __launch_bounds__(kThreads)
#endif

namespace swt {

constexpr int kBpeWarps = kThreads / 32;
constexpr int kBpeChunk = CHUNK;
constexpr uint32_t kNoRank = 0xFFFFFFFFu;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // an empty entry's value: no rank reaches 0xFFFF
constexpr unsigned kFull = 0xffffffffu;

struct BpeHash {
  uint32_t mult1, mult2;  // odd multipliers of the two bucket choices
  int shift;              // 32 - log2(buckets)
};

template <bool kShared>
__device__ __forceinline__ uint4 bucket(const uint4* table, uint32_t i) {
  if constexpr (kShared) {
    return table[i];
  } else {
    return __ldg(table + i);
  }
}

// The value rank << 16 | new id of `key`, kEmpty where no merge names it:
// the 4 entries of its two 16-byte buckets. A key lies in one entry at
// most, and an empty entry's key is no merge's.
template <bool kShared>
__device__ __forceinline__ uint32_t probe(const uint4* table, const BpeHash& h, uint32_t key) {
  constexpr int kHalves = SLOTS / 2;  // 16-byte loads a bucket
  const uint32_t b1 = (key * h.mult1) >> h.shift, b2 = (key * h.mult2) >> h.shift;
  uint4 e[2 * kHalves];
#pragma unroll
  for (int i = 0; i < kHalves; ++i) {
    e[i] = bucket<kShared>(table, kHalves * b1 + i);
    e[kHalves + i] = bucket<kShared>(table, kHalves * b2 + i);
  }
  uint32_t v = kEmpty;
#pragma unroll
  for (int i = 0; i < 2 * kHalves; ++i) {
    if (e[i].x == key) v = e[i].y;
    if (e[i].z == key) v = e[i].w;
  }
  return v;
}

template <bool kShared>
__global__ void BPE_BOUNDS
bpe_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths, int64_t rows, int32_t width,
           const uint4* __restrict__ table, int32_t buckets, BpeHash h, int32_t* __restrict__ ids_out,
           int32_t* __restrict__ counts) {
  extern __shared__ uint4 table_s[];
  const uint4* tab = table;
  if constexpr (kShared) {
    for (int32_t i = threadIdx.x; i < buckets * (SLOTS / 2); i += kThreads) table_s[i] = __ldg(table + i);
    __syncthreads();
    tab = table_s;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;     // the lanes under this one
  const uint32_t upto = below | (1u << lane);   // ... and this one
  const int64_t chunks = (rows + kBpeChunk - 1) / kBpeChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBpeWarps;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kBpeWarps + warp; c < chunks; c += stride) {
    const int64_t first = c * kBpeChunk;
    int32_t chunk_len = 0;  // lane k < 8: row k of the chunk's length, clamped (0 past the batch)
    if (lane < kBpeChunk && first + lane < rows) {
      chunk_len = __ldg(lengths + first + lane);
      chunk_len = chunk_len < 0 ? 0 : (chunk_len > width ? width : chunk_len);
    }
    const int32_t longest = __reduce_max_sync(kFull, chunk_len);
    const int lg = longest <= (1 << GMIN_LG) ? GMIN_LG : 32 - __clz(longest - 1);
    const int g = 1 << lg;
    const int group = lane >> lg, slot = lane & (g - 1);
    const uint32_t gmask = g == 32 ? kFull : ((1u << g) - 1u) << (group << lg);
    for (int pass = 0; pass < kBpeChunk; pass += 32 >> lg) {
      const int k = pass + group;  // the chunk's row this group encodes
      const int64_t r = first + k;
      const int32_t len = __shfl_sync(kFull, chunk_len, k);
      int32_t id = slot < len ? static_cast<int32_t>(__ldg(data + r * width + slot)) : -1;
      bool quiet = false;  // the group's row found no pair: it takes no further lookups
      for (int32_t it = 0; it < g; ++it) {
        const uint32_t alive = __ballot_sync(kFull, id >= 0) & gmask;
        const uint32_t right = alive & ~upto;
        const int32_t next = __shfl_sync(kFull, id, right ? __ffs(right) - 1 : lane);
        uint32_t rank = kNoRank, new_id = 0;
        if (!quiet && id >= 0 && right) {
          const uint32_t v = probe<kShared>(tab, h, (static_cast<uint32_t>(id) << 16) | (static_cast<uint32_t>(next) & 0xFFFFu));
          if (v != kEmpty) {
            rank = v >> 16;
            new_id = v & 0xFFFFu;
          }
        }
        uint32_t best = rank;  // the group's minimum
        if (REDUX || lg == 5) {
          best = __reduce_min_sync(gmask, rank);
        } else {
          for (int o = g >> 1; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(kFull, best, o));
        }
        quiet = best == kNoRank;
        const bool m = !quiet && rank == best;
        const uint32_t matched = __ballot_sync(kFull, m);
        if (matched == 0) break;  // every group of the warp is quiescent
        const uint32_t mine = matched & gmask;
        const uint32_t resets = alive & ~mine & below;  // alive unmatched lanes of the group under this one
        const uint32_t since = resets ? ~((2u << (31 - __clz(resets))) - 1u) : kFull;
        const bool merge = m && (__popc(mine & since & upto) & 1);
        const uint32_t done = __ballot_sync(kFull, merge);
        const uint32_t left = alive & below;
        const bool eaten = id >= 0 && left && ((done >> (31 - __clz(left))) & 1u);
        if (merge) id = static_cast<int32_t>(new_id);
        if (eaten) id = -1;
      }
      const uint32_t alive = __ballot_sync(kFull, id >= 0) & gmask;
      if (r < rows) {
        const int32_t count = __popc(alive);
        int32_t* out = ids_out + r * width;
        if (id >= 0) out[__popc(alive & below)] = id;
        for (int32_t j = slot; j < width; j += g) {
          if (j >= count) out[j] = -1;
        }
        if (slot == 0) counts[r] = count;
      }
    }
  }
}

template <bool kShared>
int launch_bpe(const uint8_t* data, const int32_t* lengths, int64_t rows, int32_t width, const uint4* table,
               int32_t buckets, BpeHash h, int32_t* ids, int32_t* counts, cudaStream_t stream) {
  const auto kernel = bpe_kernel<kShared>;
  const size_t smem = kShared ? static_cast<size_t>(buckets) * SLOTS * 8 : 0;
  const int64_t chunks = (rows + kBpeChunk - 1) / kBpeChunk;
  const int grid = resident_grid(kernel, smem, (chunks + kBpeWarps - 1) / kBpeWarps);
  kernel<<<grid, kThreads, smem, stream>>>(data, lengths, rows, width, table, buckets, h, ids, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// sw_bpe's arguments, with buckets of SLOTS entries.
extern "C" int bpe_variant_run(const void* data, int64_t rows, int64_t width, const void* lengths, const void* table,
                               int64_t buckets, int64_t mult1, int64_t mult2, int64_t shared, void* ids, void* counts,
                               void* stream) {
  if (rows <= 0 || width < 1 || width > 32 || buckets < 2 || buckets > (int64_t{1} << 16) ||
      (buckets & (buckets - 1)) != 0 || table == nullptr || (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (shared && buckets * SLOTS * 8 > (48 << 10))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto* t = static_cast<const uint4*>(table);
  auto* i = static_cast<int32_t*>(ids);
  auto* c = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<int32_t>(width), n = static_cast<int32_t>(buckets);
  const swt::BpeHash h{static_cast<uint32_t>(mult1), static_cast<uint32_t>(mult2), 32 - __builtin_ctzll(buckets)};
  return shared ? swt::launch_bpe<true>(d, l, rows, w, t, n, h, i, c, s)
                : swt::launch_bpe<false>(d, l, rows, w, t, n, h, i, c, s);
}
