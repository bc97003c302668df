// K3 · per-token hashes: XXH64, and the XXH32 core behind xxh32 and swh64.
//
// Replaces the TPU kernel stringwars_tpu/ops/hash_pallas.py::xxh64_stripes
// (_make_kernel: the XXH64 stripe loop, with the merge, tail and avalanche
// left to a jnp epilogue) and the XLA functions of stringwars_tpu/ops/hash.py
// that carry the headline rows: xxh64 (:254, epilogue :288), xxh32 (:179),
// swh64 (:504, over _xxh32_core :450 and _avalanche32 :495), their multiseed
// forms, and the level-0 pass of tree_hash64 (_tree_level :357).
//
// What bounds them on an H100: one read of the token bytes (131072 tokens of
// 1 KiB are 134 MB, about 40 us at 3.35 TB/s; the hash suite's 20.9 M words
// of 5.4 bytes on average are 113 MB and 167 MB of offsets); the arithmetic
// is a few integer operations per 4- or 8-byte word. The design:
//
// - One kernel for both layouts a caller holds: a padded [count, width]
//   matrix (rows: token t is lengths[t] bytes at t * width) and a tape
//   (spans: token t is data[offsets[t], offsets[t + 1]), read where it lies,
//   with no padded copy). Only span() in token_walk tells them apart, as in
//   xxh3.cu; the read path and the cores (rounds, merge, finish, swh64's
//   second lane) are the same. Native 64-bit integers replace the TPU's u32
//   pairs, and each hash is whole in one pass (stripes, merge, tail and
//   avalanche), with no split into kernel and epilogue.
// - A token of under 32 bytes (no XXH64 stripe; at most one XXH32 stripe)
//   is one lane's, and a warp's lanes take 32 tokens that follow one another:
//   on a tape the warp reads one contiguous stretch. A lane reads the
//   aligned 8-byte words that hold its token and cuts its eight tail words
//   out of them with funnel shifts (spans.cuh): no byte loads, whatever the
//   alignment. The next step's spans are loaded before this step's words. On
//   the hash suite's words the step issues as long as its bytes take, so a
//   step whose short tokens are all under 16 bytes (nearly every step there)
//   takes a path that reads at most three words and tells the finish its
//   length is under 16: no 16..31-byte tail step is issued.
// - A token of 32 bytes or more is a group's of four lanes, one per
//   accumulator lane (independent until the merge, as in the tree level),
//   eight tokens a warp at once: lane i reads word i of each stripe (8 bytes
//   for XXH64, 4 for XXH32), so a group's load is one stripe, contiguous,
//   and a warp's load eight stripes. An unaligned token's words are cut from
//   two aligned words, the next one borrowed from the neighbouring lane by a
//   shuffle; a few stripes are loaded before the first is used. One lane a
//   long token (lanes 1 KB apart on 1 KB lines, each reading its words one
//   by one) would load four times the instructions for the same bytes and
//   leave each token's rounds to one lane's chain.
// - A token whose words might reach past either end of the buffer (the
//   first and last few) reads them guarded (spans.cuh); the others read them
//   unguarded. No byte outside the buffer is read.
// - k seeds per token in one pass (at most 8 per launch, more in groups):
//   each word is loaded once and feeds every seed's accumulators.
// - The tree level, few long chunks, gives each chunk four threads, one per
//   XXH64 lane, its bytes staged through shared memory (xxh64_tree_kernel
//   says why).
#include "xxh64.cuh"

namespace swt {

constexpr uint32_t kP32_1 = 2654435761u;
constexpr uint32_t kP32_2 = 2246822519u;
constexpr uint32_t kP32_3 = 3266489917u;
constexpr uint32_t kP32_4 = 668265263u;
constexpr uint32_t kP32_5 = 374761393u;

// swh64's second lane: data words XORed with kSwhXor, seed_hi ^ kSwhGold.
constexpr uint32_t kSwhXor = 0x85EBCA77u;
constexpr uint32_t kSwhGold = 0x9E3779B9u;

// Token t of either layout (token_walk) under K seeds, into out[K, count].
// kMinBlocks: blocks an SM the registers must allow.
template <int K, bool kSpans, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
xxh64_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
             const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint64_t* __restrict__ out) {
  xxh64_walk<K, kSpans>(data, end, offsets, lengths, width, count, seeds,
                        [=](int64_t t, int j, uint64_t h) { out[j * count + t] = h; });
}

// -- the tree level -----------------------------------------------------------
//
// XXH64 (seed 0) of each `chunk`-byte piece of n flat bytes (tree_hash64's
// levels). A 64 KiB chunk is 2,048 stripes of serial work, and 128 MB holds
// only 2,048 chunks: four threads share a chunk, one per XXH64 lane (the
// lanes are independent until the merge), and the lanes meet by warp
// shuffles. What held the earlier form of this kernel (each lane eight
// 8-byte loads ahead) at 18% of its byte bound was the bytes in flight: 8,192 threads
// keep 512 KiB moving, where HBM at 3.35 TB/s and about 0.7 us of loaded
// latency asks for over 2 MB. So the bytes come through shared memory by
// bulk asynchronous copies (cp.async.bulk, the TMA's 1-D form):
//
// - A block is one warp and takes up to kTreeChunks = 4 consecutive chunks
//   (fewer when the buffer has fewer chunks than SMs): 512 blocks at 128
//   MB, 433 at the hash suite's 113 MB, four resident an SM.
// - Each block has a ring of kTreeStages = 2 stages; stage k % 2 holds
//   slice k (kTreeSlice = 6 KiB) of each of its chunks. One thread issues
//   a slice's copies (one a chunk) on the stage's mbarrier with their byte
//   count; the lanes wait on it, run the slice's 192 rounds from shared
//   memory, meet at the block barrier, and the thread refills the stage
//   with slice k + 2. One slice a chunk is in flight while the lanes hash
//   the other: 6 KiB a chunk, about 12 MB on the card at 128 MB.
// - Chosen on an H100 among variants of this kernel (PERF.md): the
//   larger the slice the faster, up to the 6 KiB that two stages of four
//   chunks allow at four blocks an SM; an L2 prefetch ahead of the copies
//   made it slower; blocks of 2-8 chunks beat one block an SM of 16, whose
//   single issuing thread and barrier tie all its chunks together, and
//   blocks of one chunk; a range test on every word for the head and tail
//   bytes cost more than patching the two slices that hold them.
// - A chunk's slot is kTreePitch = 6 KiB + 32 B: the 16 bytes of head room
//   a misaligned slice needs, and a stagger of 32 B a chunk, so the four
//   chunks of a warp read four different 32-byte bank groups.
// - Bulk copies take 16-byte aligned addresses and sizes: a slice is
//   copied as the whole 16-byte units that cover it, clipped to the units
//   that lie inside [data, data + n). The at most 15 bytes at the buffer's
//   head and tail outside them are written into their slots from global
//   memory by one thread (patch_slice), in the two slices that hold them;
//   each chunk's tail past its last whole stripe is read by group_tail.
//   Nothing past n is read. Chunks whose offset is not a multiple of 8
//   read each word as two aligned 8-byte shared loads and a funnel shift
//   (kAligned8 false: the tree-hash64-level0-128MB-offset1 row); the
//   aligned instance reads one word a load, faster on the aligned buffers
//   the suites pass than the funnel form with a zero shift.
// - What is left is the lanes' chains: 2,048 dependent rounds a 64 KiB
//   chunk, about 28 cycles each (29 us at 1.98 GHz), under the 40 us that
//   one read of 128 MB takes.
constexpr int kTreeStages = 2;
constexpr int kTreeSlice = 6144;             // bytes of each chunk a stage holds (hash_cuda.TREE_SLICE)
constexpr int kTreePitch = kTreeSlice + 32;  // a chunk's slot in a stage
constexpr int kTreeChunks = 4;               // chunks a block, at most

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_address(bar)) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_address(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes), "r"(shared_address(bar))
               : "memory");
}

// 8 bytes at shared address p, r = p % 8: one load where the chunks are
// 8-byte aligned (kAligned8), else two aligned loads and a funnel shift.
template <bool kAligned8>
__device__ __forceinline__ uint64_t load8_shared(const uint8_t* p, int r) {
  if (kAligned8) return *reinterpret_cast<const uint64_t*>(p);
  const uint64_t* a = reinterpret_cast<const uint64_t*>(p - r);
  return r ? (a[0] >> (8 * r)) | (a[1] << (64 - 8 * r)) : a[0];
}

struct TreeGrid {
  const uint8_t* data;
  int64_t chunks, chunk, n;
  int per_block;

  __device__ __forceinline__ int64_t length(int64_t row) const {
    const int64_t start = row * chunk;
    return n - start < chunk ? n - start : chunk;
  }
  // Bytes of the chunk's whole stripes.
  __device__ __forceinline__ int64_t body(int64_t row) const { return length(row) & ~int64_t{31}; }
};

// Slice k of chunk `row`: its bytes [lo, hi), the 16-byte unit that its
// slot's first byte stands for, and the part [from, to) of the whole units
// inside [data, data + n) that covers it (to <= from: none).
struct TreeSlice {
  uintptr_t lo, hi, unit, from, to;
};

__device__ __forceinline__ TreeSlice tree_slice(const TreeGrid& g, int64_t row, int k) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(g.data);
  const int64_t at = static_cast<int64_t>(k) * kTreeSlice, body = g.body(row);
  TreeSlice s;
  s.lo = base + row * g.chunk + at;
  s.hi = base + row * g.chunk + (at + kTreeSlice < body ? at + kTreeSlice : body);
  s.unit = s.lo & ~uintptr_t{15};
  const uintptr_t inside_lo = (base + 15) & ~uintptr_t{15}, inside_hi = (base + g.n) & ~uintptr_t{15};
  const uintptr_t up = (s.hi + 15) & ~uintptr_t{15};
  s.from = s.unit > inside_lo ? s.unit : inside_lo;
  s.to = up < inside_hi ? up : inside_hi;
  return s;
}

// Slice k of each chunk of the block into stage k % kTreeStages, on the
// stage's barrier, as bulk copies of whole 16-byte units. One thread.
__device__ __forceinline__ void issue_slice(const TreeGrid& g, int64_t first, int k, uint8_t* ring, uint64_t* full) {
  const int stage = k % kTreeStages;
  uint32_t total = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < g.per_block && first + c < g.chunks; ++c) {
      const TreeSlice s = tree_slice(g, first + c, k);
      if (s.lo >= s.hi || s.to <= s.from) continue;
      if (pass == 0) {
        total += static_cast<uint32_t>(s.to - s.from);
      } else {
        uint8_t* slot = ring + (static_cast<int64_t>(stage) * g.per_block + c) * kTreePitch;
        bulk_copy(slot + (s.from - s.unit), reinterpret_cast<const void*>(s.from), static_cast<uint32_t>(s.to - s.from),
                  &full[stage]);
      }
    }
    if (pass == 0) barrier_expect(&full[stage], total);
  }
}

// The bytes of slice k that no bulk copy covers (at most 15 at the buffer's
// head and 15 at its tail), written into the stage's slots from global
// memory byte by byte. One thread; a block barrier follows.
__device__ __forceinline__ void patch_slice(const TreeGrid& g, int64_t first, int k, uint8_t* ring) {
  const int stage = k % kTreeStages;
  for (int c = 0; c < g.per_block && first + c < g.chunks; ++c) {
    const TreeSlice s = tree_slice(g, first + c, k);
    uint8_t* slot = ring + (static_cast<int64_t>(stage) * g.per_block + c) * kTreePitch;
    for (uintptr_t b = s.lo; b < s.hi; ++b) {
      if (b >= s.from && b < s.to) {  // skip the copied units
        b = s.to - 1;
        continue;
      }
      slot[b - s.unit] = *reinterpret_cast<const uint8_t*>(b);
    }
  }
}

template <bool kAligned8>
__global__ void __launch_bounds__(32)
xxh64_tree_kernel(TreeGrid g, uint64_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t ring[];  // [kTreeStages][per_block][kTreePitch]
  __shared__ uint64_t full[kTreeStages];
  const int local = static_cast<int>(threadIdx.x >> 2);
  const int lane = static_cast<int>(threadIdx.x & 3);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * g.per_block;
  const int64_t row = first + local;
  const bool live = local < g.per_block && row < g.chunks;  // dead threads still join the barriers and shuffles
  const uintptr_t base = reinterpret_cast<uintptr_t>(g.data);
  const int64_t len = live ? g.length(row) : 0;
  const int64_t body = len & ~int64_t{31};
  const int slices = static_cast<int>((g.body(first) + kTreeSlice - 1) / kTreeSlice);  // the block's first chunk is its longest
  // The slices with bytes outside the whole 16-byte units of [data, data +
  // n): the buffer's first, when data is not 16-byte aligned, and the one
  // that holds the buffer's last whole stripe (of its last chunk, or of the
  // one before when the last has none), when it ends past the last unit.
  const bool head = blockIdx.x == 0 && (base & 15) != 0;
  const int64_t tail_row = g.body(g.chunks - 1) > 0 || g.chunks == 1 ? g.chunks - 1 : g.chunks - 2;
  const bool tail_here = tail_row >= first && tail_row < first + g.per_block &&
                         base + tail_row * g.chunk + g.body(tail_row) > ((base + g.n) & ~uintptr_t{15});
  const int tail_slice = static_cast<int>((g.body(tail_row) - 1) / kTreeSlice);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kTreeStages; ++i) barrier_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < slices && k < kTreeStages; ++k) issue_slice(g, first, k, ring, full);
  }

  uint64_t acc = lane == 0 ? kP64_1 + kP64_2 : lane == 1 ? kP64_2 : lane == 2 ? 0 : 0 - kP64_1;
  const int head_offset = static_cast<int>((base + (live ? row : 0) * g.chunk) & 15);  // the chunk's first byte in its slots
  const int r = head_offset & 7;  // its words' offset in the slots' 8-byte words
  for (int k = 0; k < slices; ++k) {
    const int stage = k % kTreeStages;
    barrier_wait(&full[stage], static_cast<uint32_t>((k / kTreeStages) & 1));
    if ((head && k == 0) || (tail_here && k == tail_slice)) {  // block-uniform, at most twice in a launch
      if (threadIdx.x == 0) patch_slice(g, first, k, ring);
      __syncthreads();
    }
    const int64_t at = static_cast<int64_t>(k) * kTreeSlice;
    const int rounds = at < body ? static_cast<int>((body - at < kTreeSlice ? body - at : kTreeSlice) >> 5) : 0;
    const uint8_t* slot = ring + (static_cast<int64_t>(stage) * g.per_block + local) * kTreePitch + head_offset + 8 * lane;
    int s = 0;
    for (; s + 8 <= rounds; s += 8) {
      uint64_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = load8_shared<kAligned8>(slot + 32 * (s + i), r);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = round64(acc, w[i]);
    }
    for (; s < rounds; ++s) acc = round64(acc, load8_shared<kAligned8>(slot + 32 * s, r));
    __syncthreads();  // every lane is done with the stage
    if (threadIdx.x == 0 && k + kTreeStages < slices) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_slice(g, first, k + kTreeStages, ring, full);
    }
  }

  uint64_t accs[4];
  const unsigned quad = threadIdx.x & ~3u & 31u;
#pragma unroll
  for (int i = 0; i < 4; ++i) accs[i] = __shfl_sync(kFull, acc, quad + i);
  uint32_t t[8];  // the chunk's tail, read by its four lanes (dead ones read nothing), never past n
  group_tail<true>(base + (live ? row * g.chunk + body : 0), static_cast<int>(len & 31), threadIdx.x, Extent{base, base + g.n}, t);
  if (live && lane == 0) out[row] = finish64(accs, 0, len, t);
}

// -- the XXH32 core: xxh32 (one lane) and swh64 (two lanes) --------------------

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t lane) {
  return rotl32(acc + lane * kP32_2, 13) * kP32_1;
}

// The XXH32 finish of one lane; `x` is the lane's per-word XOR.
__device__ __forceinline__ uint32_t finish32(const uint32_t (&acc)[4], uint32_t seed, int64_t len,
                                             const uint32_t (&tail)[4], uint32_t x) {
  uint32_t h = len >= 16 ? rotl32(acc[0], 1) + rotl32(acc[1], 7) + rotl32(acc[2], 12) + rotl32(acc[3], 18)
                         : seed + kP32_5;
  h += static_cast<uint32_t>(len);
  const int r = static_cast<int>(len & 15);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < (r >> 2)) h = rotl32(h + (tail[k] ^ x) * kP32_3, 17) * kP32_4;
  }
  const uint32_t last = pick(tail, r >> 2) ^ x;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < (r & 3)) h = rotl32(h + ((last >> (8 * j)) & 0xFF) * kP32_5, 11) * kP32_1;
  }
  h ^= h >> 15;
  h *= kP32_2;
  h ^= h >> 13;
  h *= kP32_3;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t avalanche_swh(uint32_t h) {
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// L lanes per seed: lane 0 is XXH32 under the seed's low word; for swh64,
// lane 1 runs over data words ^ kSwhXor under (seed >> 32) ^ kSwhGold.
template <bool kSwh>
__device__ __forceinline__ uint32_t lane_seed32(uint64_t seed, int l) {
  return l == 0 ? static_cast<uint32_t>(seed) : static_cast<uint32_t>(seed >> 32) ^ kSwhGold;
}

__device__ __forceinline__ void init32(uint32_t (&acc)[4], uint32_t s) {
  acc[0] = s + kP32_1 + kP32_2;
  acc[1] = s + kP32_2;
  acc[2] = s;
  acc[3] = s - kP32_1;
}

// One seed's digest from its lanes' accumulators and the tail words: XXH32
// (lane 0) or swh64 (both lanes), stored at out[at].
template <bool kSwh>
__device__ __forceinline__ void store32(const uint32_t (&lo_acc)[4], const uint32_t (&hi_acc)[4], uint64_t seed, int64_t len,
                                        const uint32_t (&tail)[4], void* out, int64_t at) {
  const uint32_t lo_lane = finish32(lo_acc, lane_seed32<kSwh>(seed, 0), len, tail, 0u);
  if (kSwh) {
    const uint32_t hi_lane = finish32(hi_acc, lane_seed32<kSwh>(seed, 1), len, tail, kSwhXor);
    const uint32_t hi = avalanche_swh(hi_lane + rotl32(lo_lane, 16) * kP32_3);
    const uint32_t lo = avalanche_swh(lo_lane ^ (rotl32(hi_lane, 13) * kP32_4));
    static_cast<uint64_t*>(out)[at] = uint64_t(hi) << 32 | lo;
  } else {
    static_cast<uint32_t*>(out)[at] = lo_lane;
  }
}

// The tokens as xxh64_kernel's; out: [K, count] of uint32 (XXH32) or
// uint64 (swh64).
template <int K, bool kSwh, bool kSpans, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
xxh32_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
             const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, void* __restrict__ out) {
  constexpr int L = kSwh ? 2 : 1;
  const Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  // A token of n < 32 bytes (at most one stripe), one seed at a time.
  const auto short_fn = [=](int64_t t, uintptr_t p, int n, bool guard, bool small) {
    uint32_t w[8];
    if (small && !guard) {  // n < 16, as the finish is told: no stripe
      small_words(p, n, x, w);
      const uint32_t tail[4] = {w[0], w[1], w[2], w[3]};
      const uint32_t none[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < K; ++j) store32<kSwh>(none, none, seeds.v[j], n & 15, tail, out, j * count + t);
      return;
    }
    if (guard) {
      short_words<true>(p, n, x, w);
    } else {
      short_words<false>(p, n, x, w);
    }
    const bool odd = (n & 16) != 0;  // one whole stripe, then the tail in w[4..7]
    uint32_t tail[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tail[i] = odd ? w[4 + i] : w[i];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t acc[L][4];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        init32(acc[l], lane_seed32<kSwh>(seeds.v[j], l));
        if (odd) {
          const uint32_t xv = l == 0 ? 0u : kSwhXor;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[l][i] = round32(acc[l][i], w[i] ^ xv);
        }
      }
      store32<kSwh>(acc[0], acc[L - 1], seeds.v[j], n, tail, out, j * count + t);
    }
  };
  const auto long_fn = [&](int64_t t, uintptr_t q, int64_t m, bool has, bool guard, int lane) {
    const int i = lane & 3;
    uint32_t acc[K][L];  // accumulator lane i of each seed and lane
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        uint32_t a[4];
        init32(a, lane_seed32<kSwh>(seeds.v[j], l));
        acc[j][l] = i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
      }
    }
    const uint32_t stripes = static_cast<uint32_t>(m >> 4);
    const uint32_t most = __reduce_max_sync(kFull, stripes);
    const auto step = [&](uint32_t v) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t xv = v ^ (l == 0 ? 0u : kSwhXor);
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j][l] = round32(acc[j][l], xv);
      }
    };
    uint32_t w[8];
    if (guard) {
      group_stripes<uint32_t, 8, true>(q, stripes, most, lane, x, step);
      group_tail<true>(q + 16 * static_cast<uintptr_t>(stripes), static_cast<int>(m & 15), lane, x, w);
    } else {
      group_stripes<uint32_t, 8, false>(q, stripes, most, lane, x, step);
      group_tail<false>(q + 16 * static_cast<uintptr_t>(stripes), static_cast<int>(m & 15), lane, x, w);
    }
    const uint32_t tail[4] = {w[0], w[1], w[2], w[3]};
    // The digests: lane i of the group finishes seeds i, i + 4, ...
#pragma unroll
    for (int q = 0; q < (K + 3) / 4; ++q) {
      uint32_t accs[L][4] = {};
#pragma unroll
      for (int j = 4 * q; j < 4 * q + 4 && j < K; ++j) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t v = __shfl_sync(kFull, acc[j][l], (lane & ~3) + k);
            if ((j & 3) == i) accs[l][k] = v;
          }
        }
      }
      const int j = 4 * q + i;
      if (has && j < K) store32<kSwh>(accs[0], accs[L - 1], seed_at<K>(seeds, j), m, tail, out, j * count + t);
    }
  };
  token_walk<kSpans>(data, end, offsets, lengths, width, count, short_fn, long_fn);
}

// -- launch -------------------------------------------------------------------

// Blocks an SM the registers must allow, for one or two seeds and for more
// (tools/hopper_probes.py spans times other settings).
constexpr int kMinBlocksFew = 5;
constexpr int kMinBlocksMany = 3;

template <int K>
constexpr int min_blocks() { return K <= 2 ? kMinBlocksFew : kMinBlocksMany; }

// The hashes a launch computes.
enum class Hash { kXxh64, kXxh32, kSwh64 };

// One launch over the tokens of either layout (token_walk; offsets null:
// rows) under K seeds: a resident grid of warps striding over the tokens.
template <int K>
void launch(Hash hash, const uint8_t* data, int64_t end, const int64_t* offsets, const int32_t* lengths, int64_t width,
            int64_t count, const Seeds& seeds, void* out, cudaStream_t stream) {
  const auto run = [&](auto kernel, auto* digests) {
    const int grid = resident_grid(kernel, 0, (count + kThreads - 1) / kThreads);
    kernel<<<grid, kThreads, 0, stream>>>(data, end, offsets, lengths, width, count, seeds, digests);
  };
  constexpr int kMin = min_blocks<K>();
  const bool spans = offsets != nullptr;
  if (hash == Hash::kXxh64) {
    run(spans ? xxh64_kernel<K, true, kMin> : xxh64_kernel<K, false, kMin>, static_cast<uint64_t*>(out));
  } else if (hash == Hash::kSwh64) {
    run(spans ? xxh32_kernel<K, true, true, kMin> : xxh32_kernel<K, true, false, kMin>, out);
  } else {
    run(spans ? xxh32_kernel<K, false, true, kMin> : xxh32_kernel<K, false, false, kMin>, out);
  }
}

// Every group of 8 seeds of k, one launch each; out [k, count] of 8-byte
// (XXH64, swh64) or 4-byte (XXH32) digests.
inline int hash_tokens(Hash hash, const void* data, int64_t end, const void* offsets, const void* lengths, int64_t width,
                       int64_t count, const void* seeds, int64_t k, void* out, void* stream) {
  if (count <= 0 || end < 0 || k <= 0 || seeds == nullptr || (offsets == nullptr) == (lengths == nullptr) ||
      (offsets == nullptr && (width <= 0 || end != count * width))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* spans = static_cast<const int64_t*>(offsets);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  const int64_t item = hash == Hash::kXxh32 ? 4 : 8;
  const auto s = static_cast<cudaStream_t>(stream);
  for (int64_t first = 0; first < k; first += kMaxSeeds) {
    const int n = static_cast<int>(k - first < kMaxSeeds ? k - first : kMaxSeeds);
    const Seeds group = seed_group(all, first, n);
    void* dst = static_cast<uint8_t*>(out) + first * count * item;
    switch (n) {
      case 1: launch<1>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 2: launch<2>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 3: launch<3>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 4: launch<4>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 5: launch<5>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 6: launch<6>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      case 7: launch<7>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
      default: launch<8>(hash, bytes, end, spans, lens, width, count, group, dst, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// XXH64 of the rows of a padded matrix (data uint8[rows, stride], int32
// lengths clamped to [0, stride]) under k seeds (a host array), into
// out[k, rows].
extern "C" int sw_xxh64(const void* data, int64_t rows, int64_t stride, const void* lengths, const void* seeds,
                        int64_t k, void* out, void* stream) {
  return swt::hash_tokens(swt::Hash::kXxh64, data, rows * stride, nullptr, lengths, stride, rows, seeds, k, out, stream);
}

// The tree level: XXH64 (seed 0) of each `chunk`-byte piece of n flat bytes,
// [i*chunk, min((i+1)*chunk, n)), into out[chunks]; any base address and
// extent, never reads past n.
extern "C" int sw_xxh64_tree(const void* data, int64_t chunks, int64_t chunk, int64_t n, void* out, void* stream) {
  if (chunks <= 0 || chunk <= 0 || n < 0 || chunks != (n > 0 ? (n + chunk - 1) / chunk : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 132, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int64_t share = (chunks + sms - 1) / sms;  // chunks a block, for a block an SM
  const int64_t fit = optin / (swt::kTreeStages * swt::kTreePitch);  // chunks whose ring fits a block's shared memory
  const int64_t most = fit < swt::kTreeChunks ? fit : swt::kTreeChunks;
  if (most < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = static_cast<int>(share < most ? share : most);
  const swt::TreeGrid g{static_cast<const uint8_t*>(data), chunks, chunk, n, per_block};
  const int blocks = static_cast<int>((chunks + per_block - 1) / per_block);
  const int threads = 32;  // four lanes a chunk, in one warp
  const size_t smem = static_cast<size_t>(swt::kTreeStages) * per_block * swt::kTreePitch;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* digests = static_cast<uint64_t*>(out);
  if ((reinterpret_cast<uintptr_t>(data) & 7) == 0 && (chunk & 7) == 0) {
    cudaFuncSetAttribute(swt::xxh64_tree_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    swt::xxh64_tree_kernel<true><<<blocks, threads, smem, s>>>(g, digests);
  } else {
    cudaFuncSetAttribute(swt::xxh64_tree_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    swt::xxh64_tree_kernel<false><<<blocks, threads, smem, s>>>(g, digests);
  }
  return static_cast<int>(cudaGetLastError());
}

// XXH32 (swh = 0: out uint32[k, rows], each seed's low 32 bits) or swh64
// (swh = 1: out uint64[k, rows]) of the rows of a padded matrix.
extern "C" int sw_xxh32(const void* data, int64_t rows, int64_t stride, const void* lengths, const void* seeds,
                        int64_t k, int swh, void* out, void* stream) {
  return swt::hash_tokens(swh ? swt::Hash::kSwh64 : swt::Hash::kXxh32, data, rows * stride, nullptr, lengths, stride, rows,
                          seeds, k, out, stream);
}

// The spans form: token t is data[offsets[t], offsets[t + 1]) of the
// buffer's `end` bytes (offsets int64[count + 1], nondecreasing, within
// [0, end]); XXH64 under k seeds (a host array) into out uint64[k, count].
// No byte outside the buffer is read.
extern "C" int sw_xxh64_spans(const void* data, int64_t end, const void* offsets, int64_t count, const void* seeds,
                              int64_t k, void* out, void* stream) {
  if (offsets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return swt::hash_tokens(swt::Hash::kXxh64, data, end, offsets, nullptr, 0, count, seeds, k, out, stream);
}

// The spans form of sw_xxh32: XXH32 (swh = 0: out uint32[k, count]) or
// swh64 (swh = 1: out uint64[k, count]).
extern "C" int sw_xxh32_spans(const void* data, int64_t end, const void* offsets, int64_t count, const void* seeds,
                              int64_t k, int swh, void* out, void* stream) {
  if (offsets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return swt::hash_tokens(swh ? swt::Hash::kSwh64 : swt::Hash::kXxh32, data, end, offsets, nullptr, 0, count, seeds, k, out,
                          stream);
}
