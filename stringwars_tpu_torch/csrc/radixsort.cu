// K11 · stable argsort over packed key columns: an LSD radix sort.
//
// Replaces the XLA function stringwars_tpu/ops/sort.py::_lsd_argsort (:56;
// one multi-key lax.sort with the iota as the last key up to 8 columns, one
// stable argsort a column past that), which both sort.py::argsort_tape and
// _uncased_order (:161) reach. The result is the same permutation: the
// stable lexicographic order of the rows of a [n_cols, n] uint32 key matrix,
// column 0 most significant, ties in index order.
//
// What bounds it on an H100: the keys read once (4 B a key and column) and
// the int32 permutation written once; the hash suite's 20,899,756 words in 7
// columns are 669 MB, 0.20 ms at 3.35 TB/s. A radix sort reads more: every
// pass reads the permutation and a key twice and writes both once. The
// design, simple first:
//
// - 9-bit digits, least significant column first and least significant digit
//   first within a column: three passes cover a 27-bit byte column (three
//   bytes + 1 each), a fourth reaches bit 31 for any other key. The wrapper
//   reads each column's OR and AND over the batch (radix_spread_kernel) and
//   plans only the passes whose digit varies: a digit that is constant over
//   the batch leaves a stable order as it is.
// - A pass is three launches over tiles of kTile consecutive positions of
//   the order so far: a histogram of the digit per tile (shared-memory
//   counters), an exclusive scan of the digit-major [digit][tile] counts (a
//   block a digit; the digits' totals beside), and a stable scatter.
// - The scatter ranks each key among the keys of its tile that share its
//   digit, in tile order, without atomics: a warp takes 512 consecutive
//   positions in 16 rounds of 32; in a round __match_any_sync gives the lanes
//   that share a digit and __popc of the lower ones the rank among them, and
//   the warp's own counter of that digit (shared memory, written by the
//   lowest such lane after all have read it) the keys of earlier rounds. The
//   warps' counters are then summed in warp order, digit by digit, onto the
//   digit's base (the totals of smaller digits) and the tile's scanned count.
// - The first pass of a column gathers its keys through the order so far;
//   the scatter writes each key beside its index when the next pass sorts by
//   the same column, which then reads them in place.
#include "common.cuh"

namespace swt {

constexpr int kRadixBits = 9;
constexpr int kBuckets = 1 << kRadixBits;            // 512 digits
constexpr int kSortWarps = kThreads / 32;            // 8
constexpr int kItems = 16;                           // rounds of 32 keys a warp takes in a tile
constexpr int kWarpSpan = 32 * kItems;               // 512 consecutive positions a warp
constexpr int kTile = kSortWarps * kWarpSpan;        // 4,096 positions a tile
constexpr uint32_t kNoDigit = kBuckets;              // past the batch's end

// One pass: the key of position i is keys[i] (carried from the last pass of
// the same column) or col[order[i]] (order null: the identity).
struct Pass {
  const uint32_t* col;
  const uint32_t* keys;
  const int32_t* order;
  int64_t n;
  int shift;
};

__device__ __forceinline__ void load_key(const Pass& p, int64_t i, int32_t& v, uint32_t& key) {
  v = p.order ? __ldg(p.order + i) : static_cast<int32_t>(i);
  key = p.keys ? __ldg(p.keys + i) : __ldg(p.col + v);
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

// Each column's OR and AND over the batch: spread[c] |= ..., spread[n_cols +
// c] &= ... (the host sets them to 0 and ~0 first). Grid: (blocks, n_cols).
__global__ void __launch_bounds__(kThreads)
radix_spread_kernel(const uint32_t* __restrict__ cols, int64_t n, uint32_t* __restrict__ spread) {
  __shared__ uint32_t ors[kSortWarps], ands[kSortWarps];
  const int c = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* col = cols + static_cast<int64_t>(c) * n;
  uint32_t o = 0, a = ~0u;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint32_t k = __ldg(col + i);
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

// counts[d * tiles + t]: the keys of tile t whose digit is d.
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(Pass p, int64_t tiles, int32_t* __restrict__ counts) {
  __shared__ int32_t hist[kBuckets];
  for (int d = threadIdx.x; d < kBuckets; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int j = 0; j < kTile / kThreads; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < p.n) {
      int32_t v;
      uint32_t key;
      load_key(p, i, v, key);
      atomicAdd(hist + ((key >> p.shift) & (kBuckets - 1)), 1);  // a count: its order is of no matter
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBuckets; d += kThreads) counts[d * tiles + blockIdx.x] = hist[d];
}

// Block d scans counts[d * tiles ...] in place (exclusive, tile order) and
// writes the digit's total.
__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(int32_t* __restrict__ counts, int64_t tiles, int32_t* __restrict__ totals) {
  int32_t* row = counts + blockIdx.x * tiles;
  int carry = 0;
  for (int64_t start = 0; start < tiles; start += kThreads) {
    const int64_t t = start + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int sum;
    const int before = block_exclusive_scan(v, sum);
    if (t < tiles) row[t] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The stable scatter of tile blockIdx.x: order_out[pos] = index, and
// keys_out[pos] = key when keys_out is set.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(Pass p, int64_t tiles, const int32_t* __restrict__ counts, const int32_t* __restrict__ totals,
                     int32_t* __restrict__ order_out, uint32_t* __restrict__ keys_out) {
  __shared__ int32_t seen[kSortWarps][kBuckets];  // a warp's keys of each digit so far; then its first position
  __shared__ int32_t start[kBuckets];             // the tile's first position of each digit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Where the tile's keys of digit d go: the totals of the digits below d,
  // plus the keys of digit d in the tiles before this one.
  static_assert(kBuckets == 2 * kThreads, "two digits a thread");
  const int d0 = 2 * threadIdx.x, d1 = d0 + 1;
  const int t0 = totals[d0], t1 = totals[d1];
  int all;
  const int below = block_exclusive_scan(t0 + t1, all);
  start[d0] = below + counts[d0 * tiles + blockIdx.x];
  start[d1] = below + t0 + counts[d1 * tiles + blockIdx.x];
  for (int d = lane; d < kBuckets; d += 32) seen[warp][d] = 0;

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile + warp * kWarpSpan + lane;
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
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool live = first + 32 * r < p.n;
    const uint32_t digit = live ? (key[r] >> p.shift) & (kBuckets - 1) : kNoDigit;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int ahead = __popc(peers & lower);
    const int before = live ? seen[warp][digit] : 0;
    rank[r] = before + ahead;
    __syncwarp();
    if (live && ahead == 0) seen[warp][digit] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBuckets; d += kThreads) {
    int run = start[d];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = seen[w][d];
      seen[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (first + 32 * r < p.n) {
      const int pos = seen[warp][(key[r] >> p.shift) & (kBuckets - 1)] + rank[r];
      order_out[pos] = index[r];
      if (keys_out) keys_out[pos] = key[r];
    }
  }
}

}  // namespace swt

// Each column's OR (spread[0, n_cols)) and AND (spread[n_cols, 2 n_cols)) of
// the [n_cols, n] uint32 key matrix, for the host's plan of passes.
extern "C" int sw_radix_spread(const void* columns, int64_t n_cols, int64_t n, void* spread, void* stream) {
  if (n_cols <= 0 || n_cols > 65535 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<uint32_t*>(spread);
  cudaMemsetAsync(out, 0, n_cols * sizeof(uint32_t), s);
  cudaMemsetAsync(out + n_cols, 0xFF, n_cols * sizeof(uint32_t), s);
  const dim3 grid(static_cast<unsigned>(swt::stream_blocks(n) / n_cols + 1), static_cast<unsigned>(n_cols));
  swt::radix_spread_kernel<<<grid, swt::kThreads, 0, s>>>(static_cast<const uint32_t*>(columns), n, out);
  return static_cast<int>(cudaGetLastError());
}

// The stable argsort of the [n_cols, n] uint32 key matrix (n < 2^31) by the
// planned passes: pass k sorts by the 9-bit digit at bit passes[2k + 1] of
// column passes[2k] (a host int64 array of (column, shift) pairs, least
// significant first). order (int32[n]) gets the permutation; scratch: order_tmp
// (int32[n]), keys_a and keys_b (uint32[n], used when a column has two
// passes or more), counts (int32[512 * ceil(n / 4096)]), totals (int32[512]).
// n_passes >= 1.
extern "C" int sw_radix_argsort(const void* columns, int64_t n_cols, int64_t n, const void* passes, int64_t n_passes,
                                void* order, void* order_tmp, void* keys_a, void* keys_b, void* counts, void* totals,
                                void* stream) {
  if (n_cols <= 0 || n <= 0 || n >= (int64_t{1} << 31) || n_passes <= 0 || passes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* plan = static_cast<const int64_t*>(passes);
  for (int64_t k = 0; k < n_passes; ++k) {
    if (plan[2 * k] < 0 || plan[2 * k] >= n_cols || plan[2 * k + 1] < 0 || plan[2 * k + 1] > 31) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cols = static_cast<const uint32_t*>(columns);
  const int64_t tiles = (n + swt::kTile - 1) / swt::kTile;
  auto* cnt = static_cast<int32_t*>(counts);
  auto* tot = static_cast<int32_t*>(totals);
  int32_t* orders[2] = {static_cast<int32_t*>(order), static_cast<int32_t*>(order_tmp)};
  uint32_t* keys[2] = {static_cast<uint32_t*>(keys_a), static_cast<uint32_t*>(keys_b)};
  const int32_t* in_order = nullptr;  // the identity
  const uint32_t* in_keys = nullptr;
  for (int64_t k = 0; k < n_passes; ++k) {
    const int64_t column = plan[2 * k];
    const bool same_before = k > 0 && plan[2 * (k - 1)] == column;
    const bool same_after = k + 1 < n_passes && plan[2 * (k + 1)] == column;
    swt::Pass p{cols + column * n, same_before ? in_keys : nullptr, in_order, n, static_cast<int>(plan[2 * k + 1])};
    int32_t* out = orders[(n_passes - 1 - k) & 1];  // the last pass writes `order`
    uint32_t* out_keys = same_after ? keys[k & 1] : nullptr;
    swt::radix_histogram_kernel<<<static_cast<unsigned>(tiles), swt::kThreads, 0, s>>>(p, tiles, cnt);
    swt::radix_scan_kernel<<<swt::kBuckets, swt::kThreads, 0, s>>>(cnt, tiles, tot);
    swt::radix_scatter_kernel<<<static_cast<unsigned>(tiles), swt::kThreads, 0, s>>>(p, tiles, cnt, tot, out, out_keys);
    in_order = out;
    in_keys = out_keys;
  }
  return static_cast<int>(cudaGetLastError());
}
