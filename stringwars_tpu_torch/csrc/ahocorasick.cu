// K2 · Aho-Corasick multi-pattern count: one chunk-parallel DFA scan.
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
// depends on the lookup before it, and the bytes are one read of n. Read
// through L1/L2, the 1,000-word dictionary's 4 MiB table held the earlier
// kernel to 14% of the byte bound (its first 96 states from shared memory
// ran 2.4x faster, the same chain with no table load 3.5x). From shared
// memory a warp's lookup is one request whose lanes, in different states,
// fall on different words of one bank now and then: those requests, the
// class lookups and the instructions a byte set the time once enough
// chains are in flight (tools/hopper_probes.py ac). The design's task is to
// fit the table on chip and keep the requests and instructions a byte few.
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
// - Byte classes (the class regimes, ac_class_kernel): the host maps each
//   byte to the class of its column of delta (ops/ahocorasick.py
//   class_layout; the 1,000-word dictionary has 27: its letters and one for
//   every other byte) and numbers the states breadth-first. An entry of the
//   table [states][classes] holds the next state's number in its low
//   state_bits bits and that state's output count above them: 16 bits where
//   both fit (the dictionary's 4,092 states x 27 classes: 221 KB), else 32.
//   A step is the class, the row offset next * pitch + class (one IMAD),
//   the entry's load and the count (a shift and an add). The class depends
//   on the byte alone, off the chain: a load from the 256-byte map (which
//   holds class * entry_bytes where that fits a byte), or, where the
//   classes are one byte range and the rest (the dictionary's letters),
//   min(byte - lo, classes - 1), which spares a shared-memory request a
//   byte. The pitch is the class count, so lanes in different states
//   spread over the banks.
// - Regimes, picked by the host from the table's size: "shared" (the class
//   map and the whole table copied into dynamic shared memory once per
//   block; a table over 48 KiB runs 1,024-thread blocks, one an SM, so the
//   SM still holds 32 warps of chains: 256-thread blocks took 1.4x as
//   long); "split" (the table does not fit: the first `hot` rows, the
//   states nearest the root, in shared memory, the rest read with __ldg,
//   chosen by comparing the state number); "global" (the classes do not
//   shrink: the 256-column int32 table, entry s * 256 + c = next << 8 |
//   min(out_count[next], 255), read with __ldg, the next index (entry &
//   ~0xFF) | byte, ac_kernel); "wide" (some count above what an entry
//   holds: as global, the hits from out_count[]).
// - The haystack is read in 32-byte batches, a full sector per thread, with
//   the next batch loaded before the current one is walked (scan_batches),
//   so the loads overlap the dependent chain; staging a warp's chunks
//   through shared memory (walk_tile, as shiftand.cu does) was no faster
//   here. Two or four chunks a thread walked in step were slower. The
//   ragged end of the last chunk goes byte by byte. Counts are summed in 32
//   bits per 16 bytes and in 64 bits per thread, then by warp shuffles to
//   one atomicAdd per warp.
// The TPU kernel's int32 byte columns, (32, 128) state planes and 4096
// fixed chunks are not carried over.
#include <type_traits>

#include "common.cuh"

namespace swt {

constexpr int kGlobal = 1, kWide = 2;
constexpr int kMapBytes = 256;  // the class map ahead of the rows in shared memory
constexpr int kMaxDevices = 64;

template <int kRegime>
using AcCount = typename std::conditional<kRegime == kWide, unsigned long long, unsigned>::type;

template <int kRegime, bool kCount>
__device__ __forceinline__ void ac_step(const uint32_t* __restrict__ table, const int32_t* __restrict__ out_count,
                                        uint32_t& entry, uint32_t byte, AcCount<kRegime>& hits) {
  const uint32_t idx = (entry & ~0xFFu) | byte;
  entry = __ldg(table + idx);
  if constexpr (kCount) {
    if constexpr (kRegime == kWide) {
      hits += static_cast<unsigned>(__ldg(out_count + (entry >> 8)));
    } else {
      hits += entry & 0xFFu;
    }
  }
}

template <int kRegime, bool kCount>
__device__ __forceinline__ void ac_step16(const uint32_t* __restrict__ table, const int32_t* __restrict__ out_count,
                                          uint32_t& entry, uint4 v, AcCount<kRegime>& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ac_step<kRegime, kCount>(table, out_count, entry, (words[i] >> (8 * k)) & 0xFFu, hits);
  }
}

// The 256-column table regimes ("global", "wide").
template <int kRegime>
__global__ void __launch_bounds__(kThreads)
ac_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint32_t* __restrict__ table,
          const int32_t* __restrict__ out_count, int64_t chunk, int64_t overlap, unsigned long long* __restrict__ out) {
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
                 [&](uint4 v) { ac_step16<kRegime, false>(table, out_count, entry, v, hits); });
    scan_batches(hay, s, full, [&](uint4 v) { ac_step16<kRegime, true>(table, out_count, entry, v, hits); });
    for (int64_t w = full; w < e; ++w) ac_step<kRegime, true>(table, out_count, entry, hay[w], hits);
    total += hits;
  }
  total = block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

// The class-table regimes: what a step needs besides the table.
struct AcClasses {
  uint32_t state_mask;  // the next state's bits of an entry
  uint32_t state_bits;  // the count sits above them
  uint32_t classes;     // row pitch in entries
  uint32_t hot;         // rows in shared memory
  uint32_t lo;          // kRange: a byte's class is min(byte - lo, classes - 1), unsigned
};

// How a step finds a byte's class: the map's class (kRaw), the map's class
// * sizeof(Entry) (kScaled), or by arithmetic where the classes are one
// byte range and the rest (kRange: the 1,000-word dictionary's letters),
// which spares a shared-memory request a byte.
constexpr int kRaw = 0, kScaled = 1, kRange = 2;

// One step of the class-table DFA: smem holds the class map (kMapBytes),
// then the first `hot` rows; rows is the whole table in device memory.
template <typename Entry, bool kSplit, int kMap, bool kCount>
__device__ __forceinline__ void acc_step(const uint8_t* smem, const uint8_t* __restrict__ rows, const AcClasses& a,
                                         uint32_t& entry, uint32_t byte, uint32_t& hits) {
  uint32_t cls;
  if constexpr (kMap == kRange) {
    cls = min(byte - a.lo, a.classes - 1) * static_cast<uint32_t>(sizeof(Entry));
  } else {
    cls = smem[byte];
  }
  const uint32_t next = entry & a.state_mask;
  const uint32_t off = kMap != kRaw ? next * (a.classes * sizeof(Entry)) + cls : (next * a.classes + cls) * sizeof(Entry);
  if (kSplit && next >= a.hot) {
    entry = __ldg(reinterpret_cast<const Entry*>(rows + off));
  } else {
    entry = *reinterpret_cast<const Entry*>(smem + kMapBytes + off);
  }
  if constexpr (kCount) hits += entry >> a.state_bits;
}

template <typename Entry, bool kSplit, int kMap, bool kCount>
__device__ __forceinline__ void acc_step16(const uint8_t* smem, const uint8_t* __restrict__ rows, const AcClasses& a,
                                           uint32_t& entry, uint4 v, unsigned long long& total) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t hits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_step<Entry, kSplit, kMap, kCount>(smem, rows, a, entry, __byte_perm(words[i], 0, 0x4440 + k), hits);
    }
  }
  if constexpr (kCount) total += hits;
}

template <typename Entry, bool kSplit, int kMap>
__global__ void __launch_bounds__(1024)
ac_class_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint8_t* __restrict__ rows,
                const uint8_t* __restrict__ class_map, int64_t staged, AcClasses a, int64_t chunk, int64_t overlap,
                unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int threads = blockDim.x;
  for (int i = threadIdx.x; i < kMapBytes / 16; i += threads) {
    reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(class_map) + i);
  }
  for (int64_t i = threadIdx.x; i < staged / 16; i += threads) {
    reinterpret_cast<uint4*>(smem + kMapBytes)[i] = __ldg(reinterpret_cast<const uint4*>(rows) + i);
  }
  __syncthreads();

  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * threads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * threads + threadIdx.x; c < chunks; c += stride) {
    const int64_t s = c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;
    const int64_t full = s + ((e - s) & ~int64_t{31});
    uint32_t entry = 0;  // state 0, count 0
    scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                 [&](uint4 v) { acc_step16<Entry, kSplit, kMap, false>(smem, rows, a, entry, v, total); });
    scan_batches(hay, s, full, [&](uint4 v) { acc_step16<Entry, kSplit, kMap, true>(smem, rows, a, entry, v, total); });
    uint32_t hits = 0;
    for (int64_t w = full; w < e; ++w) acc_step<Entry, kSplit, kMap, true>(smem, rows, a, entry, hay[w], hits);
    total += hits;
  }
  total = warp_sum(total);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(out, total);
}

template <typename Entry, bool kSplit, int kMap>
int launch_classes(const uint8_t* hay, int64_t n, const uint8_t* rows, const uint8_t* class_map, int64_t staged,
                   const AcClasses& a, int threads, int64_t chunk, int64_t overlap, unsigned long long* out,
                   cudaStream_t stream) {
  auto kernel = ac_class_kernel<Entry, kSplit, kMap>;
  const size_t smem = static_cast<size_t>(kMapBytes + staged);
  // The opt-in above 48 KiB is set once per device and size, not per call.
  static size_t allowed[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (smem > (48u << 10) && (device >= kMaxDevices || allowed[device] < smem)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device] = smem;
  }
  const int64_t want = ((n + chunk - 1) / chunk + threads - 1) / threads;
  const int grid = resident_grid(kernel, smem, want, threads);
  kernel<<<grid, threads, smem, stream>>>(hay, n, rows, class_map, staged, a, chunk, overlap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// The 256-column regimes. hay: 16-byte aligned, n > 0. table: int32[states *
// 256] packed entries (see above). out_count: int32[states] for the wide
// regime, else null (global). chunk: a multiple of 32 in [32, 2^24]. out:
// one zeroed 64-bit word; the count is added into it.
extern "C" int sw_ac_count(const void* hay, int64_t n, const void* table, int64_t states, const void* out_count,
                           int64_t chunk, int64_t overlap, void* out, void* stream) {
  if (n <= 0 || states <= 0 || states >= (int64_t{1} << 23) || chunk < 32 || chunk % 32 || chunk > (int64_t{1} << 24) ||
      overlap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* oc = static_cast<const int32_t*>(out_count);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t want = ((n + chunk - 1) / chunk + swt::kThreads - 1) / swt::kThreads;
  if (oc == nullptr) {
    const int grid = swt::resident_grid(swt::ac_kernel<swt::kGlobal>, 0, want);
    swt::ac_kernel<swt::kGlobal><<<grid, swt::kThreads, 0, s>>>(h, n, t, oc, chunk, overlap, o);
  } else {
    const int grid = swt::resident_grid(swt::ac_kernel<swt::kWide>, 0, want);
    swt::ac_kernel<swt::kWide><<<grid, swt::kThreads, 0, s>>>(h, n, t, oc, chunk, overlap, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The class regimes. rows: the class table ([states][classes] entries of
// entry_bytes, 2 or 4; next state in the low state_bits = bit length of
// states - 1 (at least 1), count above), its bytes padded to 16 (16-byte
// aligned). class_map: 256 bytes (16-byte aligned), class * entry_bytes
// where classes * entry_bytes <= 256, else the class. hot: the rows staged
// in shared memory, from the first (hot == states: the shared regime).
// threads: a block's, a multiple of 32 up to 1,024. range_lo: where the
// classes are one byte range and the rest (class_map[b] == min(b -
// range_lo, classes - 1), unsigned), its first byte, and the kernel
// computes the classes (not in the split regime); else -1. Other
// arguments as sw_ac_count's.
extern "C" int sw_ac_classes(const void* hay, int64_t n, const void* rows, const void* class_map, int64_t states,
                             int64_t classes, int64_t entry_bytes, int64_t hot, int64_t threads, int64_t range_lo,
                             int64_t chunk, int64_t overlap, void* out, void* stream) {
  int64_t bits = 1;
  while ((int64_t{1} << bits) < states) ++bits;
  if (n <= 0 || states <= 0 || classes < 1 || classes > 256 || (entry_bytes != 2 && entry_bytes != 4) ||
      bits >= 8 * entry_bytes || hot < 0 || hot > states || threads < 32 || threads > 1024 || threads % 32 ||
      chunk < 32 || chunk % 32 || chunk > (int64_t{1} << 24) || overlap < 0 ||
      (range_lo >= 0 && (hot < states || classes < 2 || range_lo + classes - 1 > 256))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pitch = classes * entry_bytes;
  const int64_t staged = (hot * pitch + 15) / 16 * 16;
  const swt::AcClasses a{static_cast<uint32_t>((int64_t{1} << bits) - 1), static_cast<uint32_t>(bits),
                         static_cast<uint32_t>(classes), static_cast<uint32_t>(hot),
                         static_cast<uint32_t>(range_lo < 0 ? 0 : range_lo)};
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* r = static_cast<const uint8_t*>(rows);
  const auto* m = static_cast<const uint8_t*>(class_map);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(threads);
  const bool split = hot < states, scaled = pitch <= swt::kMapBytes, range = range_lo >= 0;
#define SW_AC_LAUNCH(E, SPLIT, MAP) swt::launch_classes<E, SPLIT, swt::MAP>(h, n, r, m, staged, a, t, chunk, overlap, o, s)
#define SW_AC_FORMS(E)                                                                                  \
  if (split) return scaled ? SW_AC_LAUNCH(E, true, kScaled) : SW_AC_LAUNCH(E, true, kRaw);            \
  if (range) return SW_AC_LAUNCH(E, false, kRange);                                                    \
  return scaled ? SW_AC_LAUNCH(E, false, kScaled) : SW_AC_LAUNCH(E, false, kRaw);
  if (entry_bytes == 2) {
    SW_AC_FORMS(uint16_t)
  }
  SW_AC_FORMS(uint32_t)
#undef SW_AC_FORMS
#undef SW_AC_LAUNCH
}
