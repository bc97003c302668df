// Variants of the multi-pattern Shift-And kernel (stringwars_tpu_torch/csrc/shiftand.cu)
// for measurement only: the earlier kernel (one u32 or u64 state word), as
// it was and with its mask load replaced by an arithmetic stand-in, and the
// package's kernel with the same stand-in (the counts are then not the
// function's: timing variants only). Built and timed by
// tools/hopper_probes.py shiftand; nothing of the package calls it.
#include "../../stringwars_tpu_torch/csrc/shiftand.cu"

namespace {

__device__ __forceinline__ unsigned popcount(uint32_t x) { return __popc(x); }
__device__ __forceinline__ unsigned popcount(uint64_t x) { return __popcll(x); }

template <typename Word>
__device__ __forceinline__ Word stand_in(uint32_t byte) {
  if constexpr (sizeof(Word) == 8) {
    return (static_cast<uint64_t>(byte * 0x85EBCA77u) << 32) | (byte * 0x9E3779B1u);
  } else {
    return byte * 0x9E3779B1u;
  }
}

template <typename Word, bool kLoad, bool kCount>
__device__ __forceinline__ void parent_step16(const Word* masks, Word start, Word fin, Word& state, uint4 v, unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t byte = (words[i] >> (8 * k)) & 0xFFu;
      state = ((state << 1) | start) & (kLoad ? masks[byte] : stand_in<Word>(byte));
      if (kCount) hits += popcount(state & fin);
    }
  }
}

// The earlier kernel, as it was (kLoad) or without its mask load.
template <typename Word, bool kLoad>
__global__ void __launch_bounds__(swt::kThreads)
parent_sa_kernel(const uint8_t* __restrict__ hay, int64_t n, const unsigned long long* __restrict__ table, int64_t chunk,
                 int64_t overlap, unsigned long long* __restrict__ out) {
  __shared__ Word masks[256];
  for (int i = threadIdx.x; i < 256; i += swt::kThreads) masks[i] = static_cast<Word>(table[i]);
  const Word start = static_cast<Word>(table[256]), fin = static_cast<Word>(table[257]);
  __syncthreads();
  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * swt::kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * swt::kThreads + threadIdx.x; c < chunks; c += stride) {
    const int64_t s = c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;
    const int64_t full = s + ((e - s) & ~int64_t{31});
    Word state = 0;
    unsigned hits = 0;
    swt::scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                      [&](uint4 v) { parent_step16<Word, kLoad, false>(masks, start, fin, state, v, hits); });
    swt::scan_batches(hay, s, full, [&](uint4 v) { parent_step16<Word, kLoad, true>(masks, start, fin, state, v, hits); });
    for (int64_t w = full; w < e; ++w) {
      state = ((state << 1) | start) & masks[hay[w]];
      hits += popcount(state & fin);
    }
    total += hits;
  }
  total = swt::block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

template <int kWords, bool kCount>
__device__ __forceinline__ void noload_step16(const uint32_t (&start)[kWords], const uint32_t (&fin)[kWords],
                                              uint32_t (&state)[kWords], uint4 v, unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t byte = __byte_perm(words[i], 0, 0x4440 + k);
      uint32_t pop = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        state[w] = (state[w] * 2u | start[w]) & stand_in<uint32_t>(byte + w);
        pop += __popc(state[w] & fin[w]);
      }
      if (kCount) hits += pop;
    }
  }
}

// The package's two-word kernel (warp tiles staged through shared memory)
// without its mask load.
template <int kWords>
__global__ void __launch_bounds__(swt::kThreads)
noload_sa_kernel(const uint8_t* __restrict__ hay, int64_t n, const unsigned long long* __restrict__ table, int64_t chunk,
                 int64_t overlap, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t stages[];
  uint32_t start[kWords], fin[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    start[w] = static_cast<uint32_t>(table[256] >> (32 * w));
    fin[w] = static_cast<uint32_t>(table[257] >> (32 * w));
  }
  constexpr int kWarps = swt::kThreads / 32;
  uint8_t* stage = stages + (threadIdx.x >> 5) * swt::stage_bytes<swt::kSlice>();
  unsigned long long total = 0;
  const int64_t tiles = ((n + chunk - 1) / chunk + 31) / 32;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); t < tiles;
       t += static_cast<int64_t>(gridDim.x) * kWarps) {
    uint32_t state[kWords] = {};
    unsigned hits = 0;
    swt::walk_tile<swt::kSlice>(
        hay, n, 32 * t, chunk, overlap, stage,
        [&](uint4 v, bool count) {
          if (count) {
            noload_step16<kWords, true>(start, fin, state, v, hits);
          } else {
            noload_step16<kWords, false>(start, fin, state, v, hits);
          }
        },
        [&](uint32_t byte) { hits += byte; });
    total += hits;
  }
  total = swt::block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

// The package's recurrence under other choices: kStaged (warp tiles
// through shared memory in slices of that many bytes, or 0: each lane's
// chunk read directly), kImad (the mask's address as byte * stride + base
// with a runtime stride, an IMAD, where the compiler takes a LEA), kPack (one word of up to 16 occupied
// bits: two steps' final bits packed into one word by a PRMT, one LOP3 and
// one POPC for both).
template <int kWords, bool kImad, int kPack, bool kCount>
__device__ __forceinline__ void probe_step16(const uint8_t* masks, uint32_t stride, const uint32_t (&start)[kWords],
                                             const uint32_t (&fin)[kWords], uint32_t (&state)[kWords], uint4 v,
                                             unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t prev = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t byte = __byte_perm(words[i], 0, 0x4440 + k);
      const uint8_t* at = kImad ? masks + byte * stride : masks + byte * (4 * kWords);
      uint32_t m[kWords];
      if constexpr (kWords == 1) {
        m[0] = *reinterpret_cast<const uint32_t*>(at);
      } else {
        const uint2 both = *reinterpret_cast<const uint2*>(at);
        m[0] = both.x;
        m[1] = both.y;
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) state[w] = (state[w] * 2u | start[w]) & m[w];
      if constexpr (kCount) {
        if constexpr (kPack == 2) {
          if (k & 1) {
            hits += __popc(__byte_perm(prev, state[0], 0x5410) & fin[0]);
          } else {
            prev = state[0];
          }
        } else if constexpr (kWords == 1) {
          hits += __popc(state[0] & fin[0]);
        } else {
          hits += __popc(state[0] & fin[0]) + __popc(state[1] & fin[1]);
        }
      }
    }
  }
}

template <int kWords, int kStaged, bool kImad, int kPack>
__global__ void __launch_bounds__(swt::kThreads)
probe_sa_kernel(const uint8_t* __restrict__ hay, int64_t n, const unsigned long long* __restrict__ table, int64_t chunk,
                int64_t overlap, uint32_t stride, unsigned long long* __restrict__ out) {
  __shared__ __align__(8) uint32_t masks[256 * kWords];
  extern __shared__ __align__(16) uint8_t stages[];
  for (int i = threadIdx.x; i < 256; i += swt::kThreads) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) masks[i * kWords + w] = static_cast<uint32_t>(table[i] >> (32 * w));
  }
  uint32_t start[kWords], fin[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    start[w] = static_cast<uint32_t>(table[256] >> (32 * w));
    fin[w] = static_cast<uint32_t>(table[257] >> (32 * w));
  }
  if (kPack == 2) fin[0] |= fin[0] << 16;
  __syncthreads();
  const uint8_t* mk = reinterpret_cast<const uint8_t*>(masks);
  unsigned long long total = 0;
  auto tail = [&](uint32_t (&state)[kWords], uint32_t byte, unsigned& hits) {
    const uint32_t lo = fin[0] & 0xFFFFu;
#pragma unroll
    for (int w = 0; w < kWords; ++w) state[w] = (state[w] * 2u | start[w]) & masks[byte * kWords + w];
    hits += __popc(state[0] & (kPack == 2 ? lo : fin[0])) + (kWords == 2 ? __popc(state[kWords - 1] & fin[kWords - 1]) : 0);
  };
  if constexpr (kStaged) {
    constexpr int kWarps = swt::kThreads / 32;
    uint8_t* stage = stages + (threadIdx.x >> 5) * swt::stage_bytes<kStaged>();
    const int64_t tiles = ((n + chunk - 1) / chunk + 31) / 32;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); t < tiles;
         t += static_cast<int64_t>(gridDim.x) * kWarps) {
      uint32_t state[kWords] = {};
      unsigned hits = 0;
      swt::walk_tile<kStaged>(
          hay, n, 32 * t, chunk, overlap, stage,
          [&](uint4 v, bool count) {
            if (count) {
              probe_step16<kWords, kImad, kPack, true>(mk, stride, start, fin, state, v, hits);
            } else {
              probe_step16<kWords, kImad, kPack, false>(mk, stride, start, fin, state, v, hits);
            }
          },
          [&](uint32_t byte) { tail(state, byte, hits); });
      total += hits;
    }
  } else {
    const int64_t chunks = (n + chunk - 1) / chunk;
    const int64_t stride_c = static_cast<int64_t>(gridDim.x) * swt::kThreads;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * swt::kThreads + threadIdx.x; c < chunks; c += stride_c) {
      const int64_t s = c * chunk;
      const int64_t e = s + chunk < n ? s + chunk : n;
      const int64_t full = s + ((e - s) & ~int64_t{31});
      uint32_t state[kWords] = {};
      unsigned hits = 0;
      swt::scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s, [&](uint4 v) {
        probe_step16<kWords, kImad, kPack, false>(mk, stride, start, fin, state, v, hits);
      });
      swt::scan_batches(hay, s, full, [&](uint4 v) {
        probe_step16<kWords, kImad, kPack, true>(mk, stride, start, fin, state, v, hits);
      });
      for (int64_t w = full; w < e; ++w) tail(state, hay[w], hits);
      total += hits;
    }
  }
  total = swt::block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

template <int kWords, int kStaged, bool kImad, int kPack>
int run_probe(const uint8_t* h, int64_t n, const unsigned long long* t, int64_t chunk, int64_t overlap,
              unsigned long long* o, cudaStream_t s) {
  auto kernel = probe_sa_kernel<kWords, kStaged, kImad, kPack>;
  const size_t smem = kStaged ? (swt::kThreads / 32) * swt::stage_bytes<kStaged ? kStaged : 32>() : 0;
  if (smem > (48u << 10)) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  const int64_t want = ((n + chunk - 1) / chunk + swt::kThreads - 1) / swt::kThreads;
  const int grid = swt::resident_grid(kernel, smem, want);
  kernel<<<grid, swt::kThreads, smem, s>>>(h, n, t, chunk, overlap, 4 * kWords, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
void run(Kernel kernel, size_t smem, const uint8_t* hay, int64_t n, const unsigned long long* table, int64_t chunk,
         int64_t overlap, unsigned long long* out, cudaStream_t stream) {
  const int64_t want = ((n + chunk - 1) / chunk + swt::kThreads - 1) / swt::kThreads;
  const int grid = swt::resident_grid(kernel, smem, want);
  kernel<<<grid, swt::kThreads, smem, stream>>>(hay, n, table, chunk, overlap, out);
}

}  // namespace

// variant 0: the earlier kernel; 1: the earlier kernel without its mask
// load; 2: the package's two-word kernel without its mask load; 16 + 4 * slice +
// pack: probe_sa_kernel (pack 2 for one word of up to 16 occupied bits).
// Arguments as sw_shiftand's.
extern "C" int sa_variant_run(int64_t variant, const void* hay, int64_t n, const void* table, int64_t n_words,
                              int64_t chunk, int64_t overlap, void* out, void* stream) {
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const unsigned long long*>(table);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool one = n_words == 1;
  if (variant == 0) {
    run(one ? parent_sa_kernel<uint32_t, true> : parent_sa_kernel<uint64_t, true>, 0, h, n, t, chunk, overlap, o, s);
  } else if (variant == 1) {
    run(one ? parent_sa_kernel<uint32_t, false> : parent_sa_kernel<uint64_t, false>, 0, h, n, t, chunk, overlap, o, s);
  } else if (variant == 2) {
    if (one) return static_cast<int>(cudaErrorInvalidValue);  // the one-word form is the earlier kernel's loop
    run(noload_sa_kernel<2>, (swt::kThreads / 32) * swt::stage_bytes<swt::kSlice>(), h, n, t, chunk, overlap, o, s);
  } else {
    // 16 + 4 * slice + pack (1 or 2): the probe kernel read directly (slice
    // 0) or staged by warps in slices of 64, 128 or 256 bytes (1, 2, 3).
    const int v = static_cast<int>(variant - 16);
    const int slice = v >> 2, pack = v & 3;
#define PROBE(CODE, SLICE)                                                                \
  if (slice == CODE) {                                                                    \
    if (!one) return run_probe<2, SLICE, false, 1>(h, n, t, chunk, overlap, o, s);        \
    return pack == 2 ? run_probe<1, SLICE, false, 2>(h, n, t, chunk, overlap, o, s)       \
                     : run_probe<1, SLICE, false, 1>(h, n, t, chunk, overlap, o, s);      \
  }
    PROBE(0, 0) PROBE(1, 64) PROBE(2, 128) PROBE(3, 256)
#undef PROBE
  }
  return static_cast<int>(cudaGetLastError());
}
