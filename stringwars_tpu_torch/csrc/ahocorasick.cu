// K2 · Aho-Corasick multi-pattern count: one chunk-parallel dense-DFA scan.
//
// Replaces both TPU kernels of stringwars_tpu/ops/ahocorasick.py:
// _ac_kernel (via _ac_scan_pallas, the transition as a step-function rule
// walk over the flat key state * 256 + byte) and _ac_kernel_lut (via
// _ac_scan_pallas_lut, the transition by direct or paged lane-LUT gathers),
// and with them the XLA scans _ac_scan (gather chain) and _ac_scan_mxu
// (one-hot matmul). All four compute one function: the number of
// occurrences of every pattern in hay[:n], overlapping and nested ones
// included, i.e. the sum over positions of out_count[state] as the DFA
// walks the bytes. Each was a way around the TPU's slow gathers; a GPU
// reads the table directly.
//
// What bounds it on an H100: every byte is one table lookup whose index
// depends on the lookup before it, so a thread's chunk is a serial chain of
// load latencies (about 30 cycles from shared memory, more from L1/L2), and
// the bytes are one read of n. The function needs about 4 instructions per
// byte (extract the byte, form the index, load, add the count): at 33.4 T
// instructions/s that is below the 3.35 TB/s byte bound, so the byte read
// is the bound, and the design's task is to keep enough chains in flight.
//
// Design:
// - Chunks: each thread walks whole chunks of `chunk` bytes (a multiple of
//   32, at least 256 and four overlaps, chosen by the wrapper), grid-stride,
//   with the grid sized to fill every SM once. Before its chunk it re-derives
//   the entry state from state 0 over the overlap = max_len - 1 bytes before
//   it, counting nothing (the state after a prefix depends only on its last
//   max_len - 1 bytes; starting further back, rounded down to 32 bytes, is
//   exact too), then counts the hits at its own positions below n. A match
//   is counted at its end, inside exactly one chunk.
// - Entries: int32 entry s * 256 + c holds next << 8 | min(out_count[next],
//   255), the next state's row offset and its output count in one word: the
//   next index is (entry & ~0xFF) | byte (one LOP3) and the hits entry & 0xFF.
// - Regimes, picked by the wrapper from the automaton's size: "shared" (at
//   most 96 states, 96 KiB, and every out_count <= 255): the table is copied
//   into dynamic shared memory once per block; "global" (out_count <= 255):
//   entries are read with __ldg through L1/L2; "wide" (some out_count > 255,
//   only with duplicate patterns): as global, the hits from out_count[].
// - The haystack is read in 32-byte batches, a full sector per thread, with
//   the next batch loaded before the current one is walked (scan_batches),
//   so the loads overlap the dependent chain. The lanes' loads are a chunk
//   apart, not coalesced; staging a warp's 32 chunks in shared memory with
//   coalesced loads was measured no faster on small tables and several times
//   slower on the 1,000-word table, whose L1 it takes. The ragged end of the
//   last chunk goes byte by byte.
// - Per-thread counts reduce by warp shuffles to one atomicAdd per block.
// The TPU kernel's int32 byte columns, (32, 128) state planes and 4096
// fixed chunks are not carried over.
#include <type_traits>

#include "common.cuh"

namespace swt {

constexpr int kShared = 0, kGlobal = 1, kWide = 2;
constexpr int64_t kSharedStates = 96;

template <int kRegime>
using AcCount = typename std::conditional<kRegime == kWide, unsigned long long, unsigned>::type;

template <int kRegime, bool kCount>
__device__ __forceinline__ void ac_step(const uint32_t* table, const int32_t* __restrict__ out_count,
                                        uint32_t& entry, uint32_t byte, AcCount<kRegime>& hits) {
  const uint32_t idx = (entry & ~0xFFu) | byte;
  if constexpr (kRegime == kShared) {
    entry = table[idx];
  } else {
    entry = __ldg(table + idx);
  }
  if constexpr (kCount) {
    if constexpr (kRegime == kWide) {
      hits += static_cast<unsigned>(__ldg(out_count + (entry >> 8)));
    } else {
      hits += entry & 0xFFu;
    }
  }
}

template <int kRegime, bool kCount>
__device__ __forceinline__ void ac_step16(const uint32_t* table, const int32_t* __restrict__ out_count,
                                          uint32_t& entry, uint4 v, AcCount<kRegime>& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ac_step<kRegime, kCount>(table, out_count, entry, (words[i] >> (8 * k)) & 0xFFu, hits);
  }
}

template <int kRegime>
__global__ void __launch_bounds__(kThreads)
ac_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint32_t* __restrict__ table, int64_t entries,
          const int32_t* __restrict__ out_count, int64_t chunk, int64_t overlap,
          unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t staged[];
  const uint32_t* T;
  if constexpr (kRegime == kShared) {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    for (int64_t i = threadIdx.x; i < entries / 4; i += kThreads) reinterpret_cast<uint4*>(staged)[i] = __ldg(src + i);
    __syncthreads();
    T = staged;
  } else {
    T = table;
  }

  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; c < chunks; c += stride) {
    const int64_t s = c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;
    const int64_t full = s + ((e - s) & ~int64_t{31});
    uint32_t entry = 0;  // state 0
    AcCount<kRegime> hits = 0;
    scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                 [&](uint4 v) { ac_step16<kRegime, false>(T, out_count, entry, v, hits); });
    scan_batches(hay, s, full, [&](uint4 v) { ac_step16<kRegime, true>(T, out_count, entry, v, hits); });
    for (int64_t w = full; w < e; ++w) ac_step<kRegime, true>(T, out_count, entry, hay[w], hits);
    total += hits;
  }
  total = block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

}  // namespace swt

// hay: 16-byte aligned, n > 0. table: int32[states * 256] packed entries (see
// above). out_count: int32[states] for the wide regime, else null. shared:
// nonzero for the shared-memory regime. chunk: a multiple of 32 in
// [32, 2^24]. out: one zeroed 64-bit word; the count is added into it.
extern "C" int sw_ac_count(const void* hay, int64_t n, const void* table, int64_t states, const void* out_count,
                           int64_t shared, int64_t chunk, int64_t overlap, void* out, void* stream) {
  if (n <= 0 || states <= 0 || states >= (int64_t{1} << 23) || chunk < 32 || chunk % 32 || chunk > (int64_t{1} << 24) ||
      overlap < 0 || (shared && (out_count != nullptr || states > swt::kSharedStates))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* oc = static_cast<const int32_t*>(out_count);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t entries = states * 256;
  const int64_t want = ((n + chunk - 1) / chunk + swt::kThreads - 1) / swt::kThreads;
  if (shared) {
    const size_t smem = static_cast<size_t>(entries) * sizeof(uint32_t);
    cudaFuncSetAttribute(swt::ac_kernel<swt::kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    const int grid = swt::resident_grid(swt::ac_kernel<swt::kShared>, smem, want);
    swt::ac_kernel<swt::kShared><<<grid, swt::kThreads, smem, s>>>(h, n, t, entries, oc, chunk, overlap, o);
  } else if (oc == nullptr) {
    const int grid = swt::resident_grid(swt::ac_kernel<swt::kGlobal>, 0, want);
    swt::ac_kernel<swt::kGlobal><<<grid, swt::kThreads, 0, s>>>(h, n, t, entries, oc, chunk, overlap, o);
  } else {
    const int grid = swt::resident_grid(swt::ac_kernel<swt::kWide>, 0, want);
    swt::ac_kernel<swt::kWide><<<grid, swt::kThreads, 0, s>>>(h, n, t, entries, oc, chunk, overlap, o);
  }
  return static_cast<int>(cudaGetLastError());
}
