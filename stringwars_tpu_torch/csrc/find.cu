// K2 · substring count / rfind over a flat haystack, for a batch of needles.
// K3 · byteset count: how many bytes of a haystack belong to a 256-entry set.
//
// K2 replaces the TPU kernel stringwars_tpu/ops/find_pallas.py::_make_kernel
// (reached through _count, _count_last and _count_batch). For every needle
// of the batch it counts the window starts p <= n - m with
// hay[p:p+m] == needle (overlapping matches count, as in the reference's
// all-matches loop); the rfind form also returns the largest such p, or -1.
//
// What bounds K2: counting every match of a batch needs one read of the
// haystack and a constant amount of work a window, whatever the batch's
// size (the cycle workload: 64 needles of 8 B over 128 MB, 134 M windows).
// The design does the work of the whole batch in one pass a tile:
//
// - One block a 16 KiB tile (and a chunk of up to 1,024 needles: larger
//   batches take more blocks a tile). The block stages its tile and up to
//   1 KiB of halo in shared memory once, and each thread takes groups of
//   four window starts: two 32-bit shared loads and a funnel shift give
//   each window's first four bytes, its head.
// - Filters, built on the host (ops/find.py FilterTable, once per batch and
//   device): a needle's key is its first L = min(4, m) bytes, and the chunk
//   has one filter for each L present (the find suite's short bucket mixes
//   needles of 1 to 13 B: up to four probes a window, usually one). A probe
//   masks the head to L bytes, hashes it to a slot (a multiply and a shift)
//   and tests the slot's bit in the filter's bitmap, in shared memory (32
//   bits a distinct key, 2^10 to 2^15: a small batch's bitmap spans the 32
//   banks once). A batch of one chunk and one key length whose needles
//   share one key (the backward row's one needle) compares the masked head
//   with that key instead, in about three quarters of the one-filter
//   bitmap's time for one needle over 128 MB on an H100 (chip_smoke.py's
//   rfind row times both). Needles of one key word but of different
//   lengths (b"a" and b"a\0") have two filters and take the bitmaps.
// - A hit is queued in shared memory (the window's offset and filter), so
//   the pass never waits on a verification; after the pass the block
//   verifies the queue, spread evenly over its threads. The slot's entry in
//   a uint16 map (global memory, through L1) leads to its (key, needle)
//   pairs; a pair whose key equals the head is verified against the
//   needle's first 16 bytes, three masked word compares, and bytes past 16
//   come from the tile, then from global memory past the staged halo. So
//   any needle length from 1 up takes the same path. Per-needle limits
//   (p <= n - m) are tested there only. A hit past the queue's 4,096 is
//   verified at once. (Verifying in the probe loop stalls: a warp probes
//   128 windows an iteration, so a false-positive rate of 1/64, or English
//   text's frequent true heads, would send nearly every iteration into a
//   verification.) The kernel is built for 0 (one key) to 4 filters a
//   chunk.
// - Counts go into per-needle counters in shared memory (atomicAdd, and
//   atomicMax of the offset in the kLast form), then one global atomic for
//   each needle and block that found a match. All in-block indexing is
//   32-bit.
//
// The TPU kernel's staging (the haystack cut into [8, chunkw + 128]
// overlapping word rows, (8, 128) accumulator blocks, scalar-prefetched
// needle words, compares of every needle word with no early exit, one
// needle at a time) existed for the TPU's tiling and sequential grid and is
// not carried over.
//
// K3 has no TPU kernel: the JAX package computes it in XLA
// (stringwars_tpu/ops/find.py::_byteset_member / byteset_count). What
// bounds it: one read of n bytes plus a table test per byte. Design: each
// block builds the 256-bit membership bitmap in shared memory from the
// 256-byte table (one __ballot_sync per warp), then streams 16-byte vector
// loads, four in flight per thread, tests each byte against the bitmap,
// and reduces a 64-bit count per block into one atomicAdd.
#include "common.cuh"

namespace swt {

constexpr int kTile = 16384;    // window starts per block
constexpr int kHaloCap = 1024;  // halo bytes staged in shared memory
constexpr int kQueue = 4096;    // candidates a block queues for verification after its pass
constexpr uint32_t kKeyMul = 0x9E3779B1u;  // ops/find.py KEY_MUL
constexpr int kFilters = 4;     // at most one filter for each key length 1..4
constexpr int kRecord = 10 + 4 * kFilters;  // ops/find.py RECORD
constexpr int kChunk = 1024;    // ops/find.py FILTER_CHUNK
constexpr int kPrefix = 16;     // ops/find.py PREFIX
constexpr uint32_t kLastPair = 0x8000u;  // ops/find.py LAST_PAIR

__device__ __forceinline__ uint32_t low_bytes(int count) { return count >= 4 ? 0xFFFFFFFFu : (1u << (8 * count)) - 1u; }

// What a block needs to verify a candidate: its tile, the chunk's filters
// and needles, its counters.
struct Chunk {
  const uint32_t* words;  // the staged tile, as words
  int span;               // staged bytes
  int64_t base, n;
  const uint8_t* hay;
  const uint8_t* needles;
  int64_t stride;
  const int32_t* table;
  int lo, pairs, prefix, lengths;  // table indices
  const uint32_t* filter;  // [kFilters][3] in shared memory: mask, shift, map at
  unsigned* found;
  int* best;
};

// Bytes [kPrefix, m) of a needle at a window: from the staged tile while it
// lasts (k + t < span), then from global memory.
__device__ __noinline__ bool tail_matches(const uint8_t* tile, int span, int k, const uint8_t* __restrict__ window,
                                          const uint8_t* __restrict__ needle, int m) {
  int t = kPrefix;
  const int in_tile = m < span - k ? m : span - k;
  while (t < in_tile && tile[k + t] == __ldg(needle + t)) ++t;
  if (t == in_tile)
    while (t < m && __ldg(window + t) == __ldg(needle + t)) ++t;
  return t == m;
}

// A queued candidate: the window at tile offset k = 4 g + o whose head set
// filter f's bit. Each pair of the head's slot whose key equals the head is
// a candidate needle; its bytes 4 to 15 are compared as words against the
// needle's prefix, the rest by tail_matches. Matches go to the counters.
template <bool kLast>
__device__ __forceinline__ void verify(const Chunk& c, int k, int f) {
  const int g = k >> 2, o = k & 3;
  const uint32_t key = __funnelshift_r(c.words[g], c.words[g + 1], 8 * o) & c.filter[3 * f];
  const auto* map = reinterpret_cast<const uint16_t*>(c.table + c.filter[3 * f + 2]);
  const unsigned entry = __ldg(map + ((key * kKeyMul) >> c.filter[3 * f + 1]));
  if (entry == 0) return;
  const uint2* pairs = reinterpret_cast<const uint2*>(c.table + c.pairs);
  for (unsigned e = entry - 1;; ++e) {
    const uint2 pair = __ldg(pairs + e);
    if (pair.x == key) {
      const int j = pair.y & (kLastPair - 1);
      const int m = __ldg(c.table + c.lengths + j);
      bool match = c.base + k <= c.n - m;  // the window must end by n
      if (match && m > 4) {
        const uint4 pre = __ldg(reinterpret_cast<const uint4*>(c.table + c.prefix) + j);
        uint32_t diff = (__funnelshift_r(c.words[g + 1], c.words[g + 2], 8 * o) ^ pre.y) & low_bytes(m - 4);
        if (m > 8) diff |= (__funnelshift_r(c.words[g + 2], c.words[g + 3], 8 * o) ^ pre.z) & low_bytes(m - 8);
        if (m > 12) diff |= (__funnelshift_r(c.words[g + 3], c.words[g + 4], 8 * o) ^ pre.w) & low_bytes(m - 12);
        match = diff == 0 && (m <= kPrefix || tail_matches(reinterpret_cast<const uint8_t*>(c.words), c.span, k,
                                                           c.hay + c.base + k, c.needles + (c.lo + j) * c.stride, m));
      }
      if (match) {
        atomicAdd(c.found + j, 1u);
        if (kLast) atomicMax(c.best + j, k);
      }
    }
    if (pair.y & kLastPair) return;
  }
}

// kMaxF: the most filters of a chunk (1 to 4), or 0 for one chunk of one
// filter whose needles share one key, whose probe compares the head with it.
template <int kMaxF, bool kLast>
__global__ void __launch_bounds__(kThreads)
find_kernel(const uint8_t* __restrict__ hay, int64_t n, const uint8_t* __restrict__ needles, int64_t stride,
            const int32_t* __restrict__ table, unsigned long long* __restrict__ counts, long long* __restrict__ lasts) {
  constexpr int kProbes = kMaxF > 0 ? kMaxF : 1;
  // kHaloCap + 16 past the tile: the head of the tile's last word group and
  // the prefix words of its last windows read up to 16 bytes beyond it.
  __shared__ __align__(16) uint8_t tile[kTile + kHaloCap + 16];
  __shared__ uint16_t queue[kQueue];  // candidates (k | f << 14), verified after the pass
  __shared__ unsigned queued;
  __shared__ uint32_t filter[kFilters * 3];
  extern __shared__ uint32_t dyn[];  // the chunk's bitmaps, then its counters and last offsets

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  if (base >= n) return;  // no window starts here; uniform across the block
  const int32_t* record = table + kRecord * blockIdx.y;
  const int lo = record[0], count = record[1] - record[0], longest = record[2], filters = record[3];
  const int bitmap_words = record[5];
  uint32_t* bitmaps = dyn;
  unsigned* found = dyn + bitmap_words;
  int* best = reinterpret_cast<int*>(found + count);

  // Stage the tile and its halo (bytes at or past n read as 0: no window
  // that can count reaches them), the chunk's bitmaps, zeroed counters.
  const int halo = longest - 1 < kHaloCap ? longest - 1 : kHaloCap;
  const int span = kTile + (halo > 16 ? halo : 16);
  for (int v = threadIdx.x; v < (span + 15) / 16; v += kThreads) {
    const int64_t g = base + 16 * v;
    uint4 word;
    if (g + 16 <= n) {
      word = __ldg(reinterpret_cast<const uint4*>(hay + g));
    } else {
      __align__(16) uint8_t b[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = g + k < n ? hay[g + k] : 0;
      word = *reinterpret_cast<const uint4*>(b);
    }
    reinterpret_cast<uint4*>(tile)[v] = word;
  }
  for (int i = threadIdx.x; i < bitmap_words; i += kThreads) bitmaps[i] = __ldg(table + record[4] + i);
  for (int i = threadIdx.x; i < count; i += kThreads) {
    found[i] = 0;
    if (kLast) best[i] = -1;
  }
  if (threadIdx.x < kFilters) {
    const int f = threadIdx.x;
    filter[3 * f] = low_bytes(record[10 + 4 * f]);
    filter[3 * f + 1] = record[11 + 4 * f];
    filter[3 * f + 2] = record[13 + 4 * f];
  }
  if (threadIdx.x == 0) queued = 0;
  const uint32_t only_key = record[9];
  uint32_t mask[kProbes];
  int shift[kProbes];
  const uint32_t* bitmap[kProbes];
#pragma unroll
  for (int f = 0; f < kProbes; ++f) {
    mask[f] = low_bytes(record[10 + 4 * f]);
    shift[f] = record[11 + 4 * f];
    bitmap[f] = bitmaps + record[12 + 4 * f];
  }
  __syncthreads();

  const Chunk chunk{reinterpret_cast<const uint32_t*>(tile), span, base, n, hay, needles, stride, table, lo,
                    record[6], record[7], record[8], filter, found, best};
  // The pass: thread t probes the four windows of word groups t, t + 256,
  // ... A hit is queued, or verified at once when the queue is full.
  const uint32_t* words = chunk.words;
  for (int g = threadIdx.x; g < kTile / 4; g += kThreads) {
    const uint32_t low = words[g], high = words[g + 1];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const uint32_t head = __funnelshift_r(low, high, 8 * o);
#pragma unroll
      for (int f = 0; f < kProbes; ++f) {
        if (kMaxF > 1 && f >= filters) break;
        bool hit;
        if (kMaxF == 0) {
          hit = (head & mask[0]) == only_key;
        } else {
          const uint32_t slot = ((head & mask[f]) * kKeyMul) >> shift[f];
          hit = (bitmap[f][slot >> 5] >> (slot & 31)) & 1u;
        }
        if (hit) {
          const unsigned at = atomicAdd(&queued, 1u);
          if (at < kQueue)
            queue[at] = static_cast<uint16_t>((4 * g + o) | (f << 14));
          else
            verify<kLast>(chunk, 4 * g + o, f);
        }
      }
    }
  }
  __syncthreads();
  const unsigned end = queued < kQueue ? queued : kQueue;
  for (unsigned i = threadIdx.x; i < end; i += kThreads) verify<kLast>(chunk, queue[i] & 0x3FFF, queue[i] >> 14);
  __syncthreads();

  for (int i = threadIdx.x; i < count; i += kThreads) {
    if (found[i]) atomicAdd(counts + lo + i, static_cast<unsigned long long>(found[i]));
    if (kLast && best[i] >= 0) atomicMax(lasts + lo + i, base + best[i]);
  }
}

template <int kMaxF, bool kLast>
int find_launch(dim3 grid, size_t smem, cudaStream_t s, const uint8_t* hay, int64_t n, const uint8_t* needles,
                int64_t stride, const int32_t* table, unsigned long long* counts, long long* lasts) {
  if (smem > 8 * 1024)  // past 48 KB in all (the tile and the queue are static), a block must opt in
    cudaFuncSetAttribute(find_kernel<kMaxF, kLast>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  find_kernel<kMaxF, kLast><<<grid, kThreads, smem, s>>>(hay, n, needles, stride, table, counts, lasts);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLast>
int find_dispatch(int64_t filters, dim3 grid, size_t smem, cudaStream_t s, const uint8_t* hay, int64_t n,
                  const uint8_t* needles, int64_t stride, const int32_t* table, unsigned long long* counts,
                  long long* lasts) {
  switch (filters) {
    case 0: return find_launch<0, kLast>(grid, smem, s, hay, n, needles, stride, table, counts, lasts);
    case 1: return find_launch<1, kLast>(grid, smem, s, hay, n, needles, stride, table, counts, lasts);
    case 2: return find_launch<2, kLast>(grid, smem, s, hay, n, needles, stride, table, counts, lasts);
    case 3: return find_launch<3, kLast>(grid, smem, s, hay, n, needles, stride, table, counts, lasts);
    case 4: return find_launch<4, kLast>(grid, smem, s, hay, n, needles, stride, table, counts, lasts);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ uint32_t member1(const uint32_t* bits, uint32_t b) {
  return (bits[b >> 5] >> (b & 31u)) & 1u;
}

__device__ __forceinline__ uint32_t member4(const uint32_t* bits, uint32_t w) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c += member1(bits, (w >> (8 * k)) & 0xFFu);
  return c;
}

__device__ __forceinline__ uint32_t member16(const uint32_t* bits, uint4 v) {
  return member4(bits, v.x) + member4(bits, v.y) + member4(bits, v.z) + member4(bits, v.w);
}

__global__ void __launch_bounds__(kThreads)
byteset_kernel(const uint8_t* __restrict__ data, int64_t n, int64_t head,
               const uint8_t* __restrict__ table, unsigned long long* __restrict__ out) {
  __shared__ uint32_t bits[8];
  const uint32_t word = __ballot_sync(0xffffffffu, table[threadIdx.x] != 0);
  if ((threadIdx.x & 31) == 0) bits[threadIdx.x >> 5] = word;
  __syncthreads();

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t vectors = (n - head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(data + head);

  unsigned long long acc = 0;
  int64_t i = tid;
  for (; i + 3 * stride < vectors; i += 4 * stride) {
    const uint4 a = __ldg(body + i), b = __ldg(body + i + stride);
    const uint4 c = __ldg(body + i + 2 * stride), d = __ldg(body + i + 3 * stride);
    acc += member16(bits, a) + member16(bits, b) + member16(bits, c) + member16(bits, d);
  }
  for (; i < vectors; i += stride) acc += member16(bits, __ldg(body + i));

  const int64_t tail = head + (vectors << 4);
  if (tid < head) acc += member1(bits, data[tid]);
  if (tid < n - tail) acc += member1(bits, data[tail + tid]);

  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc) atomicAdd(out, acc);
}

}  // namespace swt

// hay: 16-byte aligned. needles: batch rows of `stride` bytes, row y
// holding needle y's bytes. table: the batch's FilterTable (ops/find.py) on
// the device: `chunks` records, at most `filters` filters a chunk (0: one
// chunk of one filter whose needles share one key), the largest chunk's bitmaps
// `bitmap_words`. counts: zeroed int64[batch]; lasts:
// int64[batch] filled with -1, or null for the count-only form.
extern "C" int sw_find_count(const void* hay, int64_t n, const void* needles, int64_t stride, int64_t batch,
                             const void* table, int64_t chunks, int64_t filters, int64_t bitmap_words, void* counts,
                             void* lasts, void* stream) {
  const int64_t tiles = n > 0 ? (n + swt::kTile - 1) / swt::kTile : 1;
  if (batch <= 0 || chunks != (batch + swt::kChunk - 1) / swt::kChunk || tiles > 0x7fffffffLL || chunks > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_chunk = batch < swt::kChunk ? batch : swt::kChunk;
  const size_t smem = 4 * static_cast<size_t>(bitmap_words + per_chunk * (lasts == nullptr ? 1 : 2));
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* nd = static_cast<const uint8_t*>(needles);
  const auto* t = static_cast<const int32_t*>(table);
  auto* c = static_cast<unsigned long long*>(counts);
  if (lasts == nullptr) return swt::find_dispatch<false>(filters, grid, smem, s, h, n, nd, stride, t, c, nullptr);
  return swt::find_dispatch<true>(filters, grid, smem, s, h, n, nd, stride, t, c, static_cast<long long*>(lasts));
}

// table: uint8[256] on the device, nonzero = member. out: one zeroed
// 64-bit word on the device; the count is added into it.
extern "C" int sw_byteset_count(const void* data, int64_t n, const void* table, void* out,
                                void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const int64_t head = swt::unaligned_head(bytes, n);
  const int blocks = swt::stream_blocks((n - head) >> 4);
  swt::byteset_kernel<<<blocks, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bytes, n, head, static_cast<const uint8_t*>(table), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
