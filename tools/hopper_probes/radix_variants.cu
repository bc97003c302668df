// The package's radix argsort (stringwars_tpu_torch/csrc/radixsort.cu) with
// the settings tools/hopper_probes.py sort compares, kept for measurement
// only: each build (nvcc -D...) exports the package's entry point
// sw_radix_argsort at one setting, and the probe calls it through
// ops/sort_cuda.radix_argsort(lib=...). Nothing of the package calls it.
// The defaults below are the package's design; the probe's SWEEP_VARIANTS
// name the builds.
//
// The design and its measurements are described in the package's source.
#include <algorithm>
#include <vector>

#include "../../stringwars_tpu_torch/csrc/common.cuh"

// Settings the probe (tools/hopper_probes.py sort) compares. DIRECT_SCATTER
// 1: each key stored from its registers straight to its global position (the
// earlier scatter); 0: through shared memory. BALLOT_RANK 1: the lanes that
// share a digit found by nine ballots, one a bit; 0: by __match_any_sync.
// MIN_BLOCKS: the blocks an SM the pass kernel's registers must allow (4:
// 64 registers; 1 leaves them at 119, 2 blocks an SM, and takes 20% longer).
// LOOKBACK 0, for timing alone: a tile takes none of the tiles before it
// into account, which gives a wrong order. WARP_COUNTS 1: the digit count
// keeps a row of counters a warp, which the first lane of each digit bumps
// in turn, instead of one row a block bumped by shared-memory atomics.
#ifndef SW_RADIX_DIRECT_SCATTER
#define SW_RADIX_DIRECT_SCATTER 0
#endif
#ifndef SW_RADIX_BALLOT_RANK
#define SW_RADIX_BALLOT_RANK 0
#endif
#ifndef SW_RADIX_MIN_BLOCKS
#define SW_RADIX_MIN_BLOCKS 4
#endif
#ifndef SW_RADIX_LOOKBACK
#define SW_RADIX_LOOKBACK 1
#endif
#ifndef SW_RADIX_WARP_COUNTS
#define SW_RADIX_WARP_COUNTS 0
#endif

namespace swt {

constexpr int kRadixBits = 9;
constexpr int kBuckets = 1 << kRadixBits;            // 512 digits
constexpr int kSortWarps = kThreads / 32;            // 8
constexpr int kItems = 16;                           // rounds of 32 keys a warp takes in a tile
constexpr int kWarpSpan = 32 * kItems;               // 512 consecutive positions a warp
constexpr int kTile = kSortWarps * kWarpSpan;        // 4,096 positions a tile
constexpr int kMaxShifts = 4;                        // digits at bits 0, 9, 18 and 27 of a uint32
constexpr uint32_t kNoDigit = kBuckets;              // past the batch's end
constexpr uint32_t kAggregate = 1, kPrefix = 2;      // a status word's kind

// One pass: the key of position i is keys_in[i] (carried from the last pass
// of the same column) or col[order_in[i]] (order_in null: the identity).
struct Sweep {
  const uint32_t* col;
  const uint32_t* keys_in;
  const int32_t* order_in;
  int32_t* order_out;
  uint32_t* keys_out;          // null: the next pass sorts by another column
  const int32_t* hist;         // the pass's 512 digit counts over the batch
  unsigned long long* status;  // [tiles][512]: ((epoch << 2 | kind) << 32) | value
  unsigned int* ticket;        // the pass's next tile
  int64_t n;
  int shift;
  uint32_t epoch;              // the pass's number + 1
};

__device__ __forceinline__ void load_key(const Sweep& p, int64_t i, int32_t& v, uint32_t& key) {
  v = p.order_in ? __ldg(p.order_in + i) : static_cast<int32_t>(i);
  key = p.keys_in ? __ldg(p.keys_in + i) : __ldg(p.col + v);
}

// The lanes of the warp whose digit is `digit` (kNoDigit: past the batch,
// a lane that takes no part). Every lane must call it.
__device__ __forceinline__ unsigned digit_peers(uint32_t digit) {
#if SW_RADIX_BALLOT_RANK
  unsigned peers = __ballot_sync(0xffffffffu, digit != kNoDigit);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (digit >> b) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return digit == kNoDigit ? 0u : peers;
#else
  return __match_any_sync(0xffffffffu, digit);
#endif
}

__device__ __forceinline__ void publish(unsigned long long* word, uint32_t epoch, uint32_t kind, uint32_t value) {
  const unsigned long long w = (static_cast<unsigned long long>((epoch << 2) | kind) << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
}

// Exclusive prefix sum of one value a thread over the block, in thread
// order; `total` gets the block's sum. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[kSortWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kSortWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kSortWarps; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    if (lane < kSortWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + incl - v;
  total = warp_sums[kSortWarps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before;
}

// A column of n keys as a head of single keys up to its first 16-byte
// boundary, `vecs` 16-byte vectors, and a tail of single keys (the head and
// the tail have at most 3 each).
struct Split16 {
  int64_t head, vecs;
};

__device__ __forceinline__ Split16 split16(const uint32_t* col, int64_t n) {
  const int64_t head = min(n, static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(col) & 15)) & 15) >> 2));
  return {head, (n - head) >> 2};
}

// Each column's OR and AND over the batch: spread[c] |= ..., spread[n_cols +
// c] &= ... (the host sets them to 0 and ~0 first). Grid: (blocks, n_cols).
__global__ void __launch_bounds__(kThreads)
radix_spread_kernel(const uint32_t* __restrict__ cols, int64_t n, uint32_t* __restrict__ spread) {
  __shared__ uint32_t ors[kSortWarps], ands[kSortWarps];
  const int c = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* col = cols + static_cast<int64_t>(c) * n;
  const Split16 sp = split16(col, n);
  const auto* body = reinterpret_cast<const uint4*>(col + sp.head);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t o = 0, a = ~0u;
  for (int64_t v = start; v < sp.vecs; v += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint4 k = __ldg(body + v);
    o |= k.x | k.y | k.z | k.w;
    a &= k.x & k.y & k.z & k.w;
  }
  const int64_t tail = sp.head + 4 * sp.vecs;  // the head's and the tail's single keys, one a thread
  if (start < sp.head || start - sp.head < n - tail) {
    const uint32_t k = __ldg(col + (start < sp.head ? start : tail + (start - sp.head)));
    o |= k;
    a &= k;
  }
  o = __reduce_or_sync(0xffffffffu, o);
  a = __reduce_and_sync(0xffffffffu, a);
  if (lane == 0) {
    ors[warp] = o;
    ands[warp] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSortWarps; ++w) {
      o |= ors[w];
      a &= ands[w];
    }
    atomicOr(spread + c, o);
    atomicAnd(spread + gridDim.y + c, a);
  }
}

// Adds a warp's keys (one a lane; `live` false past the batch) to the
// counts of the digits at shift[0 .. count - 1]: each digit once a warp
// (__match_any_sync), so that a digit most keys share costs one
// shared-memory update a warp, not 32. counts holds a row of kBuckets a
// shift (and, with WARP_COUNTS, a warp: row s * kSortWarps + warp). Every
// lane must call it.
__device__ __forceinline__ void count_digits(int32_t* counts, const int (&shift)[kMaxShifts], int count, uint32_t key,
                                             bool live, unsigned lower) {
#pragma unroll
  for (int s = 0; s < kMaxShifts; ++s) {
    if (s < count) {
      const uint32_t digit = live ? (key >> shift[s]) & (kBuckets - 1) : kNoDigit;
      const unsigned peers = digit_peers(digit);
#if SW_RADIX_WARP_COUNTS
      if (live && (peers & lower) == 0) counts[(s * kSortWarps + (threadIdx.x >> 5)) * kBuckets + digit] += __popc(peers);
      __syncwarp();
#else
      if (live && (peers & lower) == 0) atomicAdd(counts + s * kBuckets + digit, __popc(peers));
#endif
    }
  }
}

// hist[k * 512 + d] += the keys whose digit of pass k is d, for every
// planned pass. Block row y takes job y: passes jobs[2y] .. jobs[2y] +
// jobs[2y + 1] - 1 (at most kMaxShifts), which all sort by one column;
// plan[2k], plan[2k + 1] are pass k's column and shift. A thread reads four
// keys at a time. Dynamic shared memory: kDigitsShared.
constexpr int kCountRows = SW_RADIX_WARP_COUNTS ? kMaxShifts * kSortWarps : kMaxShifts;
constexpr int kDigitsShared = kCountRows * kBuckets * sizeof(int32_t);

__global__ void __launch_bounds__(kThreads)
radix_digits_kernel(const uint32_t* __restrict__ cols, int64_t n, const int32_t* __restrict__ plan,
                    const int32_t* __restrict__ jobs, int32_t* __restrict__ hist) {
  extern __shared__ int32_t counts[];  // [kCountRows][kBuckets]
  const int first = jobs[2 * blockIdx.y], count = jobs[2 * blockIdx.y + 1];
  const uint32_t* col = cols + static_cast<int64_t>(plan[2 * first]) * n;
  int shift[kMaxShifts];
#pragma unroll
  for (int s = 0; s < kMaxShifts; ++s) shift[s] = s < count ? plan[2 * (first + s) + 1] : 0;
  for (int d = threadIdx.x; d < kCountRows * kBuckets; d += kThreads) counts[d] = 0;
  __syncthreads();
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
  const Split16 sp = split16(col, n);
  const auto* body = reinterpret_cast<const uint4*>(col + sp.head);
  // The block's rounds are uniform, so that every lane of a warp takes part
  // in each __match_any_sync.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < sp.vecs;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t v = base + threadIdx.x;
    const bool live = v < sp.vecs;
    const uint4 k = live ? __ldg(body + v) : make_uint4(0, 0, 0, 0);
    count_digits(counts, shift, count, k.x, live, lower);
    count_digits(counts, shift, count, k.y, live, lower);
    count_digits(counts, shift, count, k.z, live, lower);
    count_digits(counts, shift, count, k.w, live, lower);
  }
  if (blockIdx.x == 0) {  // the head's and the tail's single keys, one a thread
    const int64_t tail = sp.head + 4 * sp.vecs;
    const int64_t i = threadIdx.x < sp.head ? threadIdx.x : tail + threadIdx.x - sp.head;
    const bool live = i < n;
    count_digits(counts, shift, count, live ? __ldg(col + i) : 0u, live, lower);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < count * kBuckets; d += kThreads) {
    const int s = d / kBuckets, digit = d % kBuckets;
#if SW_RADIX_WARP_COUNTS
    int v = 0;
    for (int w = 0; w < kSortWarps; ++w) v += counts[(s * kSortWarps + w) * kBuckets + digit];
#else
    const int v = counts[d];
#endif
    if (v) atomicAdd(hist + static_cast<int64_t>(first + s) * kBuckets + digit, v);
  }
}

// The counts of digits d0 and d0 + 1 in the tiles before `tile`: the status
// words walked back from tile - 1, adding aggregates, until an inclusive
// prefix (tile 0 publishes one at once); a word of an earlier pass, or none,
// is waited for.
__device__ __forceinline__ void look_back(const unsigned long long* status, int64_t tile, int d0, uint32_t epoch,
                                          int& before0, int& before1) {
  bool done0 = false, done1 = false;
  int64_t t = tile - 1;
  while (!(done0 && done1)) {
    const unsigned long long* at = status + t * kBuckets + d0;
    const unsigned long long w0 = done0 ? 0ull : peek(at);
    const unsigned long long w1 = done1 ? 0ull : peek(at + 1);
    if (!((done0 || (w0 >> 34) == epoch) && (done1 || (w1 >> 34) == epoch))) continue;
    if (!done0) {
      before0 += static_cast<int>(static_cast<uint32_t>(w0));
      done0 = ((w0 >> 32) & 3) == kPrefix;
    }
    if (!done1) {
      before1 += static_cast<int>(static_cast<uint32_t>(w1));
      done1 = ((w1 >> 32) & 3) == kPrefix;
    }
    --t;
  }
}

// One pass: the stable scatter of one tile, which takes its place by
// look-back. order_out[pos] = index, and keys_out[pos] = key when set.
__global__ void __launch_bounds__(kThreads, SW_RADIX_MIN_BLOCKS)
radix_sweep_kernel(Sweep p) {
  __shared__ union {
    int32_t seen[kSortWarps][kBuckets];  // a warp's keys of each digit so far; then its first local position
    struct {
      int32_t index[kTile];
      uint32_t key[kTile];
    } tile;                              // the tile in digit order
  } sm;
  __shared__ int32_t local_start[kBuckets];  // the tile's first local position of each digit
  __shared__ int32_t target[kBuckets];       // a digit's global position minus its local one
  __shared__ unsigned int ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ticket = atomicAdd(p.ticket, 1u);
  for (int d = lane; d < kBuckets; d += 32) sm.seen[warp][d] = 0;
  __syncthreads();
  const int64_t tile = ticket;

  const int64_t first = tile * kTile + warp * kWarpSpan + lane;
  int32_t index[kItems];
  uint32_t key[kItems];
  int rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = first + 32 * r;
    index[r] = 0;
    key[r] = 0;
    if (i < p.n) load_key(p, i, index[r], key[r]);
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool live = first + 32 * r < p.n;
    const uint32_t digit = live ? (key[r] >> p.shift) & (kBuckets - 1) : kNoDigit;
    const unsigned peers = digit_peers(digit);
    const int leader = live ? __ffs(peers) - 1 : lane;  // the first lane of the digit reads and bumps its counter
    int before = 0;
    if (live && leader == lane) {
      before = sm.seen[warp][digit];
      sm.seen[warp][digit] = before + __popc(peers);
    }
    rank[r] = __shfl_sync(0xffffffffu, before, leader) + __popc(peers & lower);
    __syncwarp();
  }
  __syncthreads();

  // The tile's count of each of this thread's two digits; the warps'
  // counters become each warp's first place among the tile's keys of it.
  static_assert(kBuckets == 2 * kThreads, "two digits a thread");
  const int d0 = 2 * threadIdx.x, d1 = d0 + 1;
  int c0 = 0, c1 = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int a0 = sm.seen[w][d0], a1 = sm.seen[w][d1];
    sm.seen[w][d0] = c0;
    sm.seen[w][d1] = c1;
    c0 += a0;
    c1 += a1;
  }
  unsigned long long* row = p.status + tile * kBuckets;
  const uint32_t kind = tile == 0 ? kPrefix : kAggregate;
  publish(row + d0, p.epoch, kind, c0);
  publish(row + d1, p.epoch, kind, c1);
  int total;
  const int local0 = block_exclusive_scan(c0 + c1, total);
  const int h0 = p.hist[d0], h1 = p.hist[d1];
  const int base0 = block_exclusive_scan(h0 + h1, total);
  int before0 = 0, before1 = 0;
  if (tile > 0) {
#if SW_RADIX_LOOKBACK
    look_back(p.status, tile, d0, p.epoch, before0, before1);
#endif
    publish(row + d0, p.epoch, kPrefix, before0 + c0);
    publish(row + d1, p.epoch, kPrefix, before1 + c1);
  }
  local_start[d0] = local0;
  local_start[d1] = local0 + c0;
  target[d0] = base0 + before0 - local0;
  target[d1] = base0 + h0 + before1 - (local0 + c0);
  __syncthreads();

#if SW_RADIX_DIRECT_SCATTER
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (first + 32 * r < p.n) {
      const int d = (key[r] >> p.shift) & (kBuckets - 1);
      const int64_t pos = static_cast<int64_t>(target[d]) + local_start[d] + sm.seen[warp][d] + rank[r];
      p.order_out[pos] = index[r];
      if (p.keys_out) p.keys_out[pos] = key[r];
    }
  }
#else
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = (key[r] >> p.shift) & (kBuckets - 1);
    rank[r] = first + 32 * r < p.n ? local_start[d] + sm.seen[warp][d] + rank[r] : -1;  // the local position
  }
  __syncthreads();  // the tile below overwrites the warps' counters
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (rank[r] >= 0) {
      sm.tile.index[rank[r]] = index[r];
      sm.tile.key[rank[r]] = key[r];
    }
  }
  __syncthreads();
  const int live = static_cast<int>(min(static_cast<int64_t>(kTile), p.n - tile * kTile));
  for (int j = threadIdx.x; j < live; j += kThreads) {
    const uint32_t k = sm.tile.key[j];
    const int64_t pos = static_cast<int64_t>(target[(k >> p.shift) & (kBuckets - 1)]) + j;
    p.order_out[pos] = sm.tile.index[j];
    if (p.keys_out) p.keys_out[pos] = k;
  }
#endif
}

}  // namespace swt

// The stable argsort of the [n_cols, n] uint32 key matrix (2 <= n < 2^31)
// into order (int32[n]). The call reads each column's OR and AND back
// (spread: uint32[2 n_cols]), plans a pass for each 9-bit digit that varies,
// least significant column and digit first, writes the plan to host_plan (a
// host int32[1 + 8 n_cols]: the count of passes, then (column, shift) a pass;
// no pass: every key is equal, and order is left as it is), then launches the
// digit count and the passes. Scratch: order_tmp, keys_a, keys_b (n each), plan
// (int32[16 n_cols]), hist (int32[2048 n_cols]), status (uint64[512
// ceil(n / 4096)]), tickets (uint32[4 n_cols]).
extern "C" int sw_radix_argsort(const void* columns, int64_t n_cols, int64_t n, void* order, void* order_tmp,
                                void* keys_a, void* keys_b, void* spread, void* plan, void* hist, void* status,
                                void* tickets, void* host_plan, void* stream) {
  if (n_cols <= 0 || n_cols > 65535 || n < 2 || n >= (int64_t{1} << 31) || host_plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cols = static_cast<const uint32_t*>(columns);
  auto* dspread = static_cast<uint32_t*>(spread);
  cudaMemsetAsync(dspread, 0, n_cols * sizeof(uint32_t), s);
  cudaMemsetAsync(dspread + n_cols, 0xFF, n_cols * sizeof(uint32_t), s);
  const dim3 spread_grid(static_cast<unsigned>(swt::stream_blocks(n) / n_cols + 1), static_cast<unsigned>(n_cols));
  swt::radix_spread_kernel<<<spread_grid, swt::kThreads, 0, s>>>(cols, n, dspread);
  std::vector<uint32_t> host_spread(2 * n_cols);
  cudaMemcpyAsync(host_spread.data(), dspread, host_spread.size() * sizeof(uint32_t), cudaMemcpyDeviceToHost, s);
  const cudaError_t read = cudaStreamSynchronize(s);
  if (read != cudaSuccess) return static_cast<int>(read);

  // The plan: (column, shift) a pass, then (first pass, passes) a job of the
  // digit count, a run of at most kMaxShifts passes of one column.
  std::vector<int32_t> table, jobs;
  for (int64_t c = n_cols - 1; c >= 0; --c) {
    const uint32_t varying = host_spread[c] ^ host_spread[n_cols + c];
    jobs.push_back(static_cast<int32_t>(table.size() / 2));
    jobs.push_back(0);
    for (int shift = 0; shift < 32; shift += swt::kRadixBits) {
      if ((varying >> shift) & (swt::kBuckets - 1)) {
        table.push_back(static_cast<int32_t>(c));
        table.push_back(shift);
        ++jobs.back();
      }
    }
    if (jobs.back() == 0) jobs.resize(jobs.size() - 2);
  }
  const int64_t passes = static_cast<int64_t>(table.size()) / 2, n_jobs = static_cast<int64_t>(jobs.size()) / 2;
  auto* out_plan = static_cast<int32_t*>(host_plan);
  out_plan[0] = static_cast<int32_t>(passes);
  std::copy(table.begin(), table.end(), out_plan + 1);
  if (passes == 0) return static_cast<int>(cudaGetLastError());
  table.insert(table.end(), jobs.begin(), jobs.end());
  auto* dplan = static_cast<int32_t*>(plan);
  auto* dhist = static_cast<int32_t*>(hist);
  auto* dstatus = static_cast<unsigned long long*>(status);
  auto* dtickets = static_cast<unsigned int*>(tickets);
  const int64_t tiles = (n + swt::kTile - 1) / swt::kTile;
  // A pageable copy: the host array is staged before the call returns.
  cudaMemcpyAsync(dplan, table.data(), table.size() * sizeof(int32_t), cudaMemcpyHostToDevice, s);
  cudaMemsetAsync(dhist, 0, passes * swt::kBuckets * sizeof(int32_t), s);
  cudaMemsetAsync(dstatus, 0, tiles * swt::kBuckets * sizeof(unsigned long long), s);
  cudaMemsetAsync(dtickets, 0, passes * sizeof(unsigned int), s);
  const dim3 grid(static_cast<unsigned>(swt::stream_blocks(n) / n_jobs + 1), static_cast<unsigned>(n_jobs));
  if (swt::kDigitsShared > 48 * 1024) {
    cudaFuncSetAttribute(swt::radix_digits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, swt::kDigitsShared);
  }
  swt::radix_digits_kernel<<<grid, swt::kThreads, swt::kDigitsShared, s>>>(cols, n, dplan, dplan + 2 * passes, dhist);

  int32_t* orders[2] = {static_cast<int32_t*>(order), static_cast<int32_t*>(order_tmp)};
  uint32_t* keys[2] = {static_cast<uint32_t*>(keys_a), static_cast<uint32_t*>(keys_b)};
  const int32_t* in_order = nullptr;  // the identity
  const uint32_t* in_keys = nullptr;
  for (int64_t k = 0; k < passes; ++k) {
    const int32_t column = table[2 * k];
    const bool same_before = k > 0 && table[2 * (k - 1)] == column;
    const bool same_after = k + 1 < passes && table[2 * (k + 1)] == column;
    int32_t* out = orders[(passes - 1 - k) & 1];  // the last pass writes `order`
    uint32_t* out_keys = same_after ? keys[k & 1] : nullptr;
    const swt::Sweep p{cols + column * n, same_before ? in_keys : nullptr, in_order, out, out_keys,
                       dhist + k * swt::kBuckets, dstatus, dtickets + k, n, table[2 * k + 1],
                       static_cast<uint32_t>(k + 1)};
    swt::radix_sweep_kernel<<<static_cast<unsigned>(tiles), swt::kThreads, 0, s>>>(p);
    in_order = out;
    in_keys = out_keys;
  }
  return static_cast<int>(cudaGetLastError());
}
