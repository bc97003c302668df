// The Bloom kernels taken apart and at other settings, kept for measurement
// only: tools/hopper_probes.py filters times them at the containers suite's
// shape and at its 1 M-key cap, k = 7, over a tape's spans. Nothing of the
// package calls them.
//
// - hash alone: csrc/xxh64.cuh's walk under 7 seeds with each probe's
//   position XORed into a register, stored once a lane: the build's and
//   the query's hashing with no filter touched.
// - bits alone, build: positions precomputed (uint32[k, n]), a thread a
//   token, one global atomicOr a probe (the build's bit updates).
// - bits alone, query: the same positions, the k word loads and tests, one
//   byte stored a token.
// - the package's query kernel (csrc/filters.cu) at seed groups of 1, 2
//   and all 7.
// - fuse_floor_kernel: an empty kernel with fuse_query_kernel's arguments,
//   launched on its grid (stream_blocks(n) blocks of kThreads): the launch
//   and drain that fuse_query_kernel cannot go below.
// - cluster_build_kernel: the build with one copy of the filter in the
//   distributed shared memory of a cluster of up to 16 blocks (768 threads,
//   one an SM): block r of a cluster holds words [r * slice, (r + 1) *
//   slice), every probe an atomicOr into the owning block's slice (mapa),
//   then, after a cluster barrier, each slice written out by plain stores
//   (one cluster), by an atomicOr of its nonzero words into zeroed words,
//   or as the cluster's copy that a second launch ORs with the others'; and
//   its global regime (768-thread blocks, an atomicOr a probe).
#include <type_traits>

#include "../../stringwars_tpu_torch/csrc/filters.cu"

using namespace swt;

namespace {

template <int K, bool kSpans>
__global__ void __launch_bounds__(kThreads, (K <= 2 ? 5 : 3))
hash_alone_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                  const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint32_t m_bits,
                  uint32_t* __restrict__ sink) {
  uint32_t folded = 0;
  xxh64_walk<K, kSpans>(data, end, offsets, lengths, width, count, seeds,
                        [&](int64_t, int, uint64_t h) { folded ^= bloom_position(h, m_bits); });
  sink[static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x] = folded;
}

__global__ void __launch_bounds__(kThreads)
bits_build_kernel(const uint32_t* __restrict__ pos, int k, int64_t n, uint32_t* __restrict__ words) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    for (int j = 0; j < k; ++j) {
      const uint32_t p = __ldg(pos + j * n + t);
      atomicOr(words + (p >> 5), 1u << (p & 31));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bits_query_kernel(const uint32_t* __restrict__ pos, int k, int64_t n, const uint32_t* __restrict__ words,
                  uint8_t* __restrict__ out) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint32_t ok = 1;
    for (int j = 0; j < k; ++j) {
      const uint32_t p = __ldg(pos + j * n + t);
      ok &= __ldg(words + (p >> 5)) >> (p & 31);
    }
    out[t] = ok & 1u;
  }
}

// -- the cluster build ----------------------------------------------------------

constexpr int kBuildThreads = 768;  // one block an SM, 24 warps, up to 85 registers a thread
enum ClusterRegime : int { kGlobal = 0, kStore = 1, kAtomic = 2, kCopies = 3 };

// The generic address of `p` (this block's shared memory) in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t* cluster_slice(uint32_t* p, uint32_t rank) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<uint32_t*>(q);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// Every thread of the cluster's blocks arrives, then waits for the others
// (not .aligned: a warp may arrive from the walk's diverged paths).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

template <int K, bool kSpans>
__global__ void __launch_bounds__(kBuildThreads, 1)
cluster_build_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                     const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint32_t m_bits,
                     uint32_t* __restrict__ words, uint32_t* __restrict__ copies, int regime, uint32_t slice_words) {
  if (regime == kGlobal) {
    xxh64_walk<K, kSpans, kBuildThreads>(data, end, offsets, lengths, width, count, seeds, [=](int64_t, int, uint64_t h) {
      const uint32_t pos = bloom_position(h, m_bits);
      atomicOr(words + (pos >> 5), 1u << (pos & 31));
    });
    return;
  }
  extern __shared__ uint32_t shared_words[];
  uint32_t* const slice = shared_words;
  for (uint32_t i = threadIdx.x; i < slice_words; i += kBuildThreads) slice[i] = 0;
  cluster_barrier();  // every slice zeroed before any block's probe
  xxh64_walk<K, kSpans, kBuildThreads>(data, end, offsets, lengths, width, count, seeds, [=](int64_t, int, uint64_t h) {
    const uint32_t pos = bloom_position(h, m_bits), w = pos >> 5, owner = w / slice_words;
    atomicOr(cluster_slice(slice + (w - owner * slice_words), owner), 1u << (pos & 31));
  });
  cluster_barrier();  // every probe landed; no block reads another's slice after this
  const uint32_t n_words = m_bits >> 5, lo = cluster_rank() * slice_words;
  const uint32_t hi = lo + slice_words < n_words ? lo + slice_words : n_words;
  const int64_t copy = static_cast<int64_t>(blockIdx.x / cluster_blocks()) * n_words;  // kCopies: the cluster's
  for (uint32_t i = lo + threadIdx.x; i < hi; i += kBuildThreads) {
    const uint32_t v = slice[i - lo];
    if (regime == kStore) {
      words[i] = v;
    } else if (regime == kAtomic) {
      if (v) atomicOr(words + i, v);
    } else {
      copies[copy + i] = v;
    }
  }
}

// words[i] = the OR of the clusters' copies of word i.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* __restrict__ copies, int clusters, int64_t n_words, uint32_t* __restrict__ words) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_words;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint32_t v = 0;
    for (int c = 0; c < clusters; ++c) v |= __ldg(copies + c * n_words + i);
    words[i] = v;
  }
}

int slice_bytes_max() {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return optin;
}

// The 7-seed spans kernel's attributes, set once; its blocks an SM without
// shared memory (the global regime's grid).
int cluster_kernel_per_sm() {
  static const int per_sm = [] {
    const auto kernel = cluster_build_kernel<7, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, slice_bytes_max());
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBuildThreads, 0);
    return n > 0 ? n : 1;
  }();
  return per_sm;
}

cudaLaunchConfig_t cluster_config(int blocks, int clusters, size_t smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks * clusters));
  config.blockDim = dim3(kBuildThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(blocks);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// kind 0: hash alone (sink uint32[grid * 256], grid written to *grid_out);
// 1: bits alone, build (pos uint32[k, count], words zeroed by the caller);
// 2: bits alone, query (out uint8[count]). k must be 7, tokens a tape's spans.
extern "C" int filter_variant_run(int64_t kind, const void* data, int64_t end, const void* offsets, int64_t count,
                                  const void* seeds, int64_t k, int64_t m_bits, const void* pos, void* words, void* out,
                                  void* grid_out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (count <= 0 || k != 7 || offsets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0) {
    const Seeds g = seed_group(static_cast<const uint64_t*>(seeds), 0, 7);
    const int grid = resident_grid(hash_alone_kernel<7, true>, 0, (count + kThreads - 1) / kThreads);
    *static_cast<int64_t*>(grid_out) = grid;
    hash_alone_kernel<7, true><<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(data), end,
                                                         static_cast<const int64_t*>(offsets), nullptr, 0, count, g,
                                                         static_cast<uint32_t>(m_bits), static_cast<uint32_t*>(out));
  } else if (kind == 1) {
    bits_build_kernel<<<stream_blocks(count), kThreads, 0, s>>>(static_cast<const uint32_t*>(pos), 7, count,
                                                                static_cast<uint32_t*>(words));
  } else {
    bits_query_kernel<<<stream_blocks(count), kThreads, 0, s>>>(static_cast<const uint32_t*>(pos), 7, count,
                                                                static_cast<const uint32_t*>(words),
                                                                static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The package's query kernel over a tape's spans under 7 seeds, short
// tokens taking `group` seeds between tests (1, 2 or 7).
extern "C" int query_variant_run(int64_t group, const void* data, int64_t end, const void* offsets, int64_t count,
                                 const void* seeds, int64_t k, int64_t m_bits, const void* words, void* out, void* stream) {
  if (count <= 0 || k != 7 || offsets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Seeds g = seed_group(static_cast<const uint64_t*>(seeds), 0, 7);
  const auto run = [&](auto kernel_group) {
    launch_tokens<bloom_query_kernel<7, decltype(kernel_group)::value, true>>(
        count, static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(data), end,
        static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(nullptr), int64_t{0}, count, g,
        static_cast<uint32_t>(m_bits), static_cast<const uint32_t*>(words), static_cast<uint8_t*>(out), false);
  };
  if (group == 1) {
    run(std::integral_constant<int, 1>{});
  } else if (group == 2) {
    run(std::integral_constant<int, 2>{});
  } else {
    run(std::integral_constant<int, 7>{});
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster build over a tape's spans under 7 seeds. regime 0: global
// atomics into zeroed words; in `clusters` clusters of `blocks` blocks,
// `slice_words` words a block: 1 one cluster's plain stores, 2 each
// cluster's nonzero words ORed into zeroed words, 3 each cluster's copy
// stored into copies (uint32[clusters, m_bits / 32]), then ORed into words.
extern "C" int cluster_build_run(const void* data, int64_t end, const void* offsets, int64_t count, const void* seeds,
                                 int64_t k, int64_t m_bits, void* words, void* copies, int64_t regime, int64_t blocks,
                                 int64_t clusters, int64_t slice_words, void* stream) {
  const int64_t n_words = m_bits / 32;
  if (count <= 0 || k != 7 || offsets == nullptr || regime < kGlobal || regime > kCopies ||
      (regime != kGlobal && (blocks < 1 || blocks > 16 || clusters < 1 || slice_words * blocks < n_words ||
                             4 * slice_words > slice_bytes_max() || (regime == kStore && clusters != 1) ||
                             (regime == kCopies && copies == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const Seeds g = seed_group(static_cast<const uint64_t*>(seeds), 0, 7);
  const auto kernel = cluster_build_kernel<7, true>;
  const int per_sm = cluster_kernel_per_sm();
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* spans = static_cast<const int64_t*>(offsets);
  auto* w = static_cast<uint32_t*>(words);
  auto* c = static_cast<uint32_t*>(copies);
  if (regime == kGlobal) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t want = (count + kBuildThreads - 1) / kBuildThreads, cap = static_cast<int64_t>(sms) * per_sm;
    kernel<<<static_cast<int>(want < cap ? want : cap), kBuildThreads, 0, s>>>(
        bytes, end, spans, nullptr, 0, count, g, static_cast<uint32_t>(m_bits), w, c, kGlobal, 0u);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(static_cast<int>(blocks), static_cast<int>(clusters),
                                                   4 * static_cast<size_t>(slice_words), s, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, bytes, end, spans, static_cast<const int32_t*>(nullptr),
                                             int64_t{0}, count, g, static_cast<uint32_t>(m_bits), w, c,
                                             static_cast<int>(regime), static_cast<uint32_t>(slice_words));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (regime == kCopies) {
    merge_kernel<<<stream_blocks(n_words), kThreads, 0, s>>>(c, static_cast<int>(clusters), n_words, w);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
fuse_floor_kernel(const uint8_t* __restrict__, int64_t, const int32_t* __restrict__, const uint8_t* __restrict__, int64_t,
                  uint8_t* __restrict__) {}

extern "C" int fuse_floor_run(const void* table, int64_t table_len, const void* h, const void* fp, int64_t n, void* out,
                              void* stream) {
  fuse_floor_kernel<<<stream_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), table_len, static_cast<const int32_t*>(h), static_cast<const uint8_t*>(fp), n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// *held (a host int64): how many clusters of `blocks` build blocks, each
// with `slice_bytes` of shared memory, the card runs at once.
extern "C" int cluster_capacity(int64_t blocks, int64_t slice_bytes, void* held) {
  if (blocks < 1 || blocks > 16 || slice_bytes < 4 || slice_bytes > slice_bytes_max()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cluster_kernel_per_sm();
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(static_cast<int>(blocks), 1, static_cast<size_t>(slice_bytes), nullptr, &attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, cluster_build_kernel<7, true>, &config);
  *static_cast<int64_t*>(held) = n;
  return static_cast<int>(err);
}
