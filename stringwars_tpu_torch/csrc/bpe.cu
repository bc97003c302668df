// K-BPE · the byte-level BPE merge loop, one warp a pretoken row of up to
// 32 bytes, then the row's compaction.
//
// Replaces stringwars_tpu/ops/bpe_pallas.py::_make_kernel (via _bpe_tiles <-
// bpe_encode_fused). Per row, with slot j = lane j, until no pair merges:
//   alive      = the slots that hold an id (-1 marks a hole)
//   pair at j  = (id[j], id[next alive slot after j]), its key id << 16 | next
//   rank, new  = the merge table's entry for the key (none: no pair)
//   m          = the alive slots whose pair has the row's minimum rank
//   run at j   = the matches from the last alive unmatched slot below j up to j
//   do         = m where the run is odd (overlaps go left to right by parity)
//   id[j]      = new where do; -1 where the previous alive slot did
// then the alive ids move to the front of the row, -1 after them, and the
// row's count is the number alive. Only the row's global minimum merges in
// an iteration: merging local minima is unsound (bpe_pallas.py:18-21).
//
// The TPU kernel holds rows of 16 or 32 lanes in an (8, 1024) tile, builds
// every scan from masked roll log-steps, walks all merge rules in SMEM for
// each pair in each iteration, waits for the tile's slowest row, and leaves
// the holes for a packed sort after it. Here the scans are warp masks:
// alive, m and do are ballots; the next alive lane is a find-first-set
// above the lane, its id a shuffle; the row minimum __reduce_min_sync; the
// run a popc of m since the last reset below; the previous alive lane's do
// a bit of the do mask. Each warp stops at its own row's quiescence, and
// compacts to popc(alive below the lane).
//
// The lookup is a lower-bound binary search over the table sorted by key,
// each entry (key, rank << 16 | new id) as one 8-byte load, in one of two
// regimes that the caller picks (ops/bpe_cuda.regime_of): a table of up
// to 48 KiB staged in shared memory per block (the benchmark's 512 merges:
// 4 KiB, where staging beats the read-only cache), or one of any size, up
// to the 65,280 merges a 16-bit vocabulary holds (522 KB), read from
// global memory through the read-only cache.
//
// What bounds it on an H100: latency. A row moves 32 bytes at most in and
// 132 out, and the function needs a few operations for each alive slot
// and a binary search for each pair; but every lane of the warp steps
// through each iteration, a dependent chain of ballots, shuffles and a
// reduction with a search of ceil(log2(M + 1)) dependent loads in it.
// Rows sorted by length let neighbouring warps quiesce together; rows run
// in a grid-stride loop over resident blocks.
#include "common.cuh"

namespace swt {

constexpr int kBpeWarps = kThreads / 32;
constexpr uint32_t kNoRank = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;

template <bool kShared>
__device__ __forceinline__ uint2 entry(const uint2* table, int32_t i) {
  if constexpr (kShared) {
    return table[i];
  } else {
    return __ldg(table + i);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
bpe_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lengths, int64_t rows, int32_t width,
           const uint2* __restrict__ table, int32_t n_merges, int32_t* __restrict__ ids_out,
           int32_t* __restrict__ counts) {
  extern __shared__ uint2 table_s[];
  const uint2* tab = table;
  if constexpr (kShared) {
    for (int32_t i = threadIdx.x; i < n_merges; i += kThreads) table_s[i] = __ldg(table + i);
    __syncthreads();
    tab = table_s;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;     // the lanes under this one
  const uint32_t upto = below | (1u << lane);   // ... and this one
  const uint32_t above = ~upto;                  // the lanes over this one
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBpeWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kBpeWarps + warp; r < rows; r += stride) {
    int32_t len = __ldg(lengths + r);
    len = len < 0 ? 0 : (len > width ? width : len);
    int32_t id = lane < len ? static_cast<int32_t>(__ldg(data + r * width + lane)) : -1;
    for (int32_t it = 0; it < width; ++it) {
      const uint32_t alive = __ballot_sync(kFull, id >= 0);
      const uint32_t right = alive & above;
      const int32_t next = __shfl_sync(kFull, id, right ? __ffs(right) - 1 : lane);
      uint32_t rank = kNoRank, new_id = 0;
      if (id >= 0 && right) {
        const uint32_t key = (static_cast<uint32_t>(id) << 16) | (static_cast<uint32_t>(next) & 0xFFFFu);
        int32_t first = 0, len_left = n_merges;  // lower bound of key
        while (len_left > 0) {
          const int32_t half = len_left >> 1;
          if (entry<kShared>(tab, first + half).x < key) {
            first += half + 1;
            len_left -= half + 1;
          } else {
            len_left = half;
          }
        }
        if (first < n_merges) {
          const uint2 e = entry<kShared>(tab, first);
          if (e.x == key) {
            rank = e.y >> 16;
            new_id = e.y & 0xFFFFu;
          }
        }
      }
      const uint32_t best = __reduce_min_sync(kFull, rank);
      if (best == kNoRank) break;  // the row is quiescent (uniform over the warp)
      const bool m = rank == best;
      const uint32_t matched = __ballot_sync(kFull, m);
      const uint32_t resets = alive & ~matched & below;  // alive unmatched lanes under this one
      const uint32_t since = resets ? ~((2u << (31 - __clz(resets))) - 1u) : kFull;
      const bool merge = m && (__popc(matched & since & upto) & 1);
      const uint32_t done = __ballot_sync(kFull, merge);
      const uint32_t left = alive & below;
      const bool eaten = id >= 0 && left && ((done >> (31 - __clz(left))) & 1u);
      if (merge) id = static_cast<int32_t>(new_id);
      if (eaten) id = -1;
    }
    const uint32_t alive = __ballot_sync(kFull, id >= 0);
    const int32_t count = __popc(alive);
    int32_t* out = ids_out + r * width;
    if (id >= 0) out[__popc(alive & below)] = id;
    if (lane >= count && lane < width) out[lane] = -1;
    if (lane == 0) counts[r] = count;
  }
}

template <bool kShared>
int launch_bpe(const uint8_t* data, const int32_t* lengths, int64_t rows, int32_t width, const uint2* table,
               int32_t n_merges, int32_t* ids, int32_t* counts, cudaStream_t stream) {
  const auto kernel = bpe_kernel<kShared>;
  const size_t smem = kShared ? static_cast<size_t>(n_merges) * sizeof(uint2) : 0;
  const int grid = resident_grid(kernel, smem, (rows + kBpeWarps - 1) / kBpeWarps);
  kernel<<<grid, kThreads, smem, stream>>>(data, lengths, rows, width, table, n_merges, ids, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// data: uint8[rows, width] (row stride width); lengths: int32[rows], clamped
// to [0, width]; table: n_merges entries of (u32 key, u32 rank << 16 | new
// id), keys ascending (null when n_merges is 0); shared: stage the table in
// shared memory (a table past 48 KiB fails the launch); ids: int32[rows,
// width]; counts: int32[rows].
extern "C" int sw_bpe(const void* data, int64_t rows, int64_t width, const void* lengths, const void* table,
                      int64_t n_merges, int64_t shared, void* ids, void* counts, void* stream) {
  if (rows <= 0 || width < 1 || width > 32 || n_merges < 0 || n_merges >= (int64_t{1} << 16) ||
      (n_merges > 0 && table == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto* t = static_cast<const uint2*>(table);
  auto* i = static_cast<int32_t*>(ids);
  auto* c = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<int32_t>(width), m = static_cast<int32_t>(n_merges);
  return shared ? swt::launch_bpe<true>(d, l, rows, w, t, m, i, c, s) : swt::launch_bpe<false>(d, l, rows, w, t, m, i, c, s);
}
