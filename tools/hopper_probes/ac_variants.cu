// Variants of the Aho-Corasick DFA kernel (stringwars_tpu_torch/csrc/ahocorasick.cu)
// for measurement only: the earlier kernel (the 256-column int32 table, in
// shared memory for up to 96 states, else read with __ldg), as it was and
// with its table load replaced by an arithmetic stand-in (the count is then
// not the function's: a timing variant only), and the class-table kernel
// with 2 or 4 chunks walked in step by each thread. Built and timed by
// tools/hopper_probes.py ac; nothing of the package calls it.
#include "../../stringwars_tpu_torch/csrc/ahocorasick.cu"

namespace {

constexpr int kParentShared = 0, kParentGlobal = 1;

template <int kRegime, bool kStandIn, bool kCount>
__device__ __forceinline__ void parent_step(const uint32_t* table, uint32_t& entry, uint32_t byte, unsigned& hits) {
  const uint32_t idx = (entry & ~0xFFu) | byte;
  if constexpr (kStandIn) {
    entry = idx * 0x9E3779B1u + 0x7F4A7C15u;
  } else if constexpr (kRegime == kParentShared) {
    entry = table[idx];
  } else {
    entry = __ldg(table + idx);
  }
  if constexpr (kCount) hits += entry & 0xFFu;
}

template <int kRegime, bool kStandIn, bool kCount>
__device__ __forceinline__ void parent_step16(const uint32_t* table, uint32_t& entry, uint4 v, unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) parent_step<kRegime, kStandIn, kCount>(table, entry, (words[i] >> (8 * k)) & 0xFFu, hits);
  }
}

// The earlier kernel's shared and global regimes, as they were.
template <int kRegime, bool kStandIn>
__global__ void __launch_bounds__(swt::kThreads)
parent_ac_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint32_t* __restrict__ table, int64_t entries,
                 int64_t chunk, int64_t overlap, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t staged[];
  const uint32_t* T = table;
  if constexpr (kRegime == kParentShared) {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    for (int64_t i = threadIdx.x; i < entries / 4; i += swt::kThreads) reinterpret_cast<uint4*>(staged)[i] = __ldg(src + i);
    __syncthreads();
    T = staged;
  }
  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * swt::kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * swt::kThreads + threadIdx.x; c < chunks; c += stride) {
    const int64_t s = c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;
    const int64_t full = s + ((e - s) & ~int64_t{31});
    uint32_t entry = 0;
    unsigned hits = 0;
    swt::scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                      [&](uint4 v) { parent_step16<kRegime, kStandIn, false>(T, entry, v, hits); });
    swt::scan_batches(hay, s, full, [&](uint4 v) { parent_step16<kRegime, kStandIn, true>(T, entry, v, hits); });
    for (int64_t w = full; w < e; ++w) parent_step<kRegime, kStandIn, true>(T, entry, hay[w], hits);
    total += hits;
  }
  total = swt::block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

// The class-table kernel's shared regime (scaled class map) with kChains
// consecutive chunks a thread walked in step, byte by byte, where all of
// them are whole and past the first overlap; the others one at a time.
template <typename Entry, int kChains>
__global__ void __launch_bounds__(1024)
chains_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint8_t* __restrict__ rows,
              const uint8_t* __restrict__ class_map, int64_t staged, swt::AcClasses a, int64_t chunk, int64_t overlap,
              unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int threads = blockDim.x;
  for (int i = threadIdx.x; i < swt::kMapBytes / 16; i += threads) {
    reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(class_map) + i);
  }
  for (int64_t i = threadIdx.x; i < staged / 16; i += threads) {
    reinterpret_cast<uint4*>(smem + swt::kMapBytes)[i] = __ldg(reinterpret_cast<const uint4*>(rows) + i);
  }
  __syncthreads();
  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t warm = (overlap + 31) & ~int64_t{31};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * threads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * threads + threadIdx.x; g * kChains < chunks; g += stride) {
    const int64_t c0 = g * kChains;
    if (c0 * chunk > overlap && (c0 + kChains) * chunk <= n) {
      uint32_t entry[kChains] = {};
      const uint4* p[kChains];
#pragma unroll
      for (int k = 0; k < kChains; ++k) p[k] = reinterpret_cast<const uint4*>(hay + (c0 + k) * chunk - warm);
      const int64_t batches = (warm + chunk) >> 5;
      uint4 cur[kChains][2];
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        cur[k][0] = __ldg(p[k]);
        cur[k][1] = __ldg(p[k] + 1);
      }
      for (int64_t b = 0; b < batches; ++b) {
        uint4 nxt[kChains][2];
        if (b + 1 < batches) {
#pragma unroll
          for (int k = 0; k < kChains; ++k) {
            nxt[k][0] = __ldg(p[k] + 2 * b + 2);
            nxt[k][1] = __ldg(p[k] + 2 * b + 3);
          }
        }
        uint32_t hits = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int k = 0; k < kChains; ++k) {
                const uint32_t word = i == 0 ? cur[k][h].x : i == 1 ? cur[k][h].y : i == 2 ? cur[k][h].z : cur[k][h].w;
                swt::acc_step<Entry, false, true, true>(smem, rows, a, entry[k], __byte_perm(word, 0, 0x4440 + j), hits);
              }
            }
          }
        }
        if (b * 32 >= warm) total += hits;
        if (b + 1 < batches) {
#pragma unroll
          for (int k = 0; k < kChains; ++k) {
            cur[k][0] = nxt[k][0];
            cur[k][1] = nxt[k][1];
          }
        }
      }
    } else {
      for (int64_t c = c0; c < c0 + kChains && c < chunks; ++c) {
        const int64_t s = c * chunk;
        const int64_t e = s + chunk < n ? s + chunk : n;
        const int64_t full = s + ((e - s) & ~int64_t{31});
        uint32_t entry = 0;
        swt::scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                          [&](uint4 v) { swt::acc_step16<Entry, false, true, false>(smem, rows, a, entry, v, total); });
        swt::scan_batches(hay, s, full,
                          [&](uint4 v) { swt::acc_step16<Entry, false, true, true>(smem, rows, a, entry, v, total); });
        uint32_t hits = 0;
        for (int64_t w = full; w < e; ++w) swt::acc_step<Entry, false, true, true>(smem, rows, a, entry, hay[w], hits);
        total += hits;
      }
    }
  }
  total = swt::warp_sum(total);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, int64_t want, cudaStream_t stream) {
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return swt::resident_grid(kernel, smem, want, threads);
}

}  // namespace

// variant 0: the earlier kernel; 1: with the arithmetic stand-in. table:
// int32[states * 256] packed (next << 8 | count); shared: the earlier
// shared regime (states <= 96).
extern "C" int ac_parent_run(int64_t variant, const void* hay, int64_t n, const void* table, int64_t states,
                             int64_t shared, int64_t chunk, int64_t overlap, void* out, void* stream) {
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const uint32_t*>(table);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t entries = states * 256;
  const int64_t want = ((n + chunk - 1) / chunk + swt::kThreads - 1) / swt::kThreads;
  const size_t smem = shared ? static_cast<size_t>(entries) * 4 : 0;
#define PARENT(R, S)                                                                   \
  {                                                                                    \
    const int grid = launch(parent_ac_kernel<R, S>, smem, swt::kThreads, want, s);     \
    parent_ac_kernel<R, S><<<grid, swt::kThreads, smem, s>>>(h, n, t, entries, chunk, overlap, o); \
  }
  if (shared) {
    if (variant) PARENT(kParentShared, true) else PARENT(kParentShared, false)
  } else {
    if (variant) PARENT(kParentGlobal, true) else PARENT(kParentGlobal, false)
  }
#undef PARENT
  return static_cast<int>(cudaGetLastError());
}

// The class-table kernel's shared regime with `chains` (2 or 4) chunks a
// thread; arguments as sw_ac_classes's with hot == states.
extern "C" int ac_chains_run(int64_t chains, const void* hay, int64_t n, const void* rows, const void* class_map,
                             int64_t states, int64_t classes, int64_t entry_bytes, int64_t threads, int64_t chunk,
                             int64_t overlap, void* out, void* stream) {
  int64_t bits = 1;
  while ((int64_t{1} << bits) < states) ++bits;
  const int64_t staged = (states * classes * entry_bytes + 15) / 16 * 16;
  const swt::AcClasses a{static_cast<uint32_t>((int64_t{1} << bits) - 1), static_cast<uint32_t>(bits),
                         static_cast<uint32_t>(classes), static_cast<uint32_t>(states)};
  if (classes * entry_bytes > swt::kMapBytes || (chains != 2 && chains != 4)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* m = static_cast<const uint8_t*>(class_map);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = swt::kMapBytes + staged;
  const int t = static_cast<int>(threads);
  const int64_t want = ((n + chunk - 1) / chunk / chains + t) / t;
#define CHAINS(E, K)                                                                   \
  {                                                                                    \
    const int grid = launch(chains_kernel<E, K>, smem, t, want, s);                    \
    chains_kernel<E, K><<<grid, t, smem, s>>>(h, n, r, m, staged, a, chunk, overlap, o); \
  }
  if (entry_bytes == 2) {
    if (chains == 2) CHAINS(uint16_t, 2) else CHAINS(uint16_t, 4)
  } else {
    if (chains == 2) CHAINS(uint32_t, 2) else CHAINS(uint32_t, 4)
  }
#undef CHAINS
  return static_cast<int>(cudaGetLastError());
}
