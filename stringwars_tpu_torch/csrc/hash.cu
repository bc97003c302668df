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
// 1 KiB are 134 MB, about 40 us at 3.35 TB/s); the arithmetic is a few
// integer operations per 4- or 8-byte word. The design:
//
// - One thread hashes one token (a row of a padded [rows, stride] matrix),
//   the whole hash in one pass: stripes, merge, tail and avalanche, with no
//   split into kernel and epilogue. Native 64-bit integers replace the TPU's
//   u32 pairs. The tree level, few long chunks, gives each chunk four
//   threads, one per XXH64 lane (xxh64_tree_kernel says why).
// - Token-major rows, not the TPU's stripe-major [W4, B] transpose: a thread
//   reads its row 32 bytes at a time as two 16-byte loads, so every load
//   instruction of a warp fetches 32 whole 32-byte sectors and no byte is
//   fetched from device memory twice; no transposed copy of the corpus is
//   made. (The stripe-major layout would coalesce each load across the warp,
//   but costs a 2x-corpus staging pass; a later PR can measure the trade.)
// - k seeds per token in one pass (at most 8 per launch, more in groups):
//   each stripe is loaded once and feeds every seed's accumulators.
// - Tails read exactly the token's bytes, zero-padded to 4-byte words as
//   XXH32/XXH64 and swh64_ref specify. A padded row may be read up to its
//   stride; a tree chunk never past the buffer's end, so the flat tape needs
//   no padding copy.
#include "common.cuh"

namespace swt {

constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP64_2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP64_3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP64_4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP64_5 = 0x27D4EB2F165667C5ull;

constexpr uint32_t kP32_1 = 2654435761u;
constexpr uint32_t kP32_2 = 2246822519u;
constexpr uint32_t kP32_3 = 3266489917u;
constexpr uint32_t kP32_4 = 668265263u;
constexpr uint32_t kP32_5 = 374761393u;

// swh64's second lane: data words XORed with kSwhXor, seed_hi ^ kSwhGold.
constexpr uint32_t kSwhXor = 0x85EBCA77u;
constexpr uint32_t kSwhGold = 0x9E3779B9u;

constexpr int kMaxSeeds = 8;
struct Seeds {
  uint64_t v[kMaxSeeds];
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// t[i] for a small index known only at run time, without local memory.
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&t)[N], int i) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) v = (j == i) ? t[j] : v;
  return v;
}

// 32 bytes at p as eight little-endian words: two 16-byte loads when the
// rows are 16-byte aligned, byte loads otherwise.
template <bool kVec>
__device__ __forceinline__ void load32(const uint8_t* p, uint32_t (&w)[8]) {
  if (kVec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + 16));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = uint32_t(p[4 * j]) | uint32_t(p[4 * j + 1]) << 8 | uint32_t(p[4 * j + 2]) << 16 |
             uint32_t(p[4 * j + 3]) << 24;
    }
  }
}

// The r < 32 tail bytes at p as eight zero-padded words. `avail` bytes from
// p may be read (at least r).
template <bool kVec>
__device__ __forceinline__ void load_tail(const uint8_t* p, int r, int64_t avail, uint32_t (&t)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = 0;
  if (r == 0) return;
  if (kVec && avail >= 32) {
    load32<true>(p, t);
  } else if (kVec && r <= 16 && avail >= 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < r) t[i >> 2] |= uint32_t(p[i]) << (8 * (i & 3));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int valid = min(max(r - 4 * j, 0), 4);
    t[j] &= valid == 4 ? 0xFFFFFFFFu : ((1u << (8 * valid)) - 1u);
  }
}

// Row `row` of a padded matrix: its start, its length (clamped to the
// stride) and how far it may be read (the stride).
struct Token {
  const uint8_t* p;
  int64_t len;
  int64_t limit;
};

__device__ __forceinline__ Token token_at(const uint8_t* data, int64_t row, int64_t stride,
                                          const int32_t* lengths) {
  const int64_t given = lengths[row];
  const int64_t len = given < 0 ? 0 : (given > stride ? stride : given);
  return {data + row * stride, len, stride};
}

// -- XXH64 --------------------------------------------------------------------

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t lane) {
  acc += lane * kP64_2;
  return rotl64(acc, 31) * kP64_1;
}

__device__ __forceinline__ uint64_t merge64(uint64_t h, uint64_t acc) {
  h ^= round64(0, acc);
  return h * kP64_1 + kP64_4;
}

__device__ __forceinline__ uint64_t finish64(const uint64_t (&acc)[4], uint64_t seed, int64_t len,
                                             const uint32_t (&t)[8]) {
  uint64_t h;
  if (len >= 32) {
    h = rotl64(acc[0], 1) + rotl64(acc[1], 7) + rotl64(acc[2], 12) + rotl64(acc[3], 18);
#pragma unroll
    for (int i = 0; i < 4; ++i) h = merge64(h, acc[i]);
  } else {
    h = seed + kP64_5;
  }
  h += static_cast<uint64_t>(len);
  const int r = static_cast<int>(len & 31);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < (r >> 3)) {
      h ^= round64(0, uint64_t(t[2 * k]) | uint64_t(t[2 * k + 1]) << 32);
      h = rotl64(h, 27) * kP64_1 + kP64_4;
    }
  }
  if (r & 4) {
    h ^= uint64_t(pick(t, 2 * (r >> 3))) * kP64_1;
    h = rotl64(h, 23) * kP64_2 + kP64_3;
  }
  const uint32_t last = pick(t, r >> 2);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < (r & 3)) {
      h ^= uint64_t((last >> (8 * j)) & 0xFF) * kP64_5;
      h = rotl64(h, 11) * kP64_1;
    }
  }
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  h ^= h >> 32;
  return h;
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
xxh64_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t stride, const int32_t* __restrict__ lengths,
             Seeds seeds, uint64_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const Token tok = token_at(data, row, stride, lengths);

  uint64_t acc[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t s = seeds.v[j];
    acc[j][0] = s + kP64_1 + kP64_2;
    acc[j][1] = s + kP64_2;
    acc[j][2] = s;
    acc[j][3] = s - kP64_1;
  }
  const int64_t stripes = tok.len >> 5;
#pragma unroll 4
  for (int64_t s = 0; s < stripes; ++s) {
    uint32_t w[8];
    load32<kVec>(tok.p + 32 * s, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint64_t lane = uint64_t(w[2 * i]) | uint64_t(w[2 * i + 1]) << 32;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j][i] = round64(acc[j][i], lane);
    }
  }
  uint32_t t[8];
  load_tail<kVec>(tok.p + 32 * stripes, static_cast<int>(tok.len & 31), tok.limit - 32 * stripes, t);
#pragma unroll
  for (int j = 0; j < K; ++j) out[j * rows + row] = finish64(acc[j], seeds.v[j], tok.len, t);
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
//   each chunk's tail past its last whole stripe is read by load_tail.
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
  for (int i = 0; i < 4; ++i) accs[i] = __shfl_sync(0xffffffffu, acc, quad + i);
  if (!live || lane != 0) return;
  uint32_t t[8];
  load_tail<false>(g.data + row * g.chunk + body, static_cast<int>(len & 31), len - body, t);  // never past n
  out[row] = finish64(accs, 0, len, t);
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
template <int K, bool kSwh, bool kVec>
__global__ void __launch_bounds__(kThreads)
xxh32_kernel(const uint8_t* __restrict__ data, int64_t rows, int64_t stride, const int32_t* __restrict__ lengths,
             Seeds seeds, void* __restrict__ out) {
  constexpr int L = kSwh ? 2 : 1;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  const Token tok = token_at(data, row, stride, lengths);

  uint32_t seed32[K][L];
  uint32_t acc[K][L][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t s = l == 0 ? static_cast<uint32_t>(seeds.v[j]) : static_cast<uint32_t>(seeds.v[j] >> 32) ^ kSwhGold;
      seed32[j][l] = s;
      acc[j][l][0] = s + kP32_1 + kP32_2;
      acc[j][l][1] = s + kP32_2;
      acc[j][l][2] = s;
      acc[j][l][3] = s - kP32_1;
    }
  }
  auto stripe = [&](uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
    const uint32_t w[4] = {w0, w1, w2, w3};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t x = l == 0 ? 0u : kSwhXor;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j][l][i] = round32(acc[j][l][i], w[i] ^ x);
      }
    }
  };
  const int64_t pairs = tok.len >> 5;  // two 16-byte stripes per 32-byte load
#pragma unroll 2
  for (int64_t s = 0; s < pairs; ++s) {
    uint32_t w[8];
    load32<kVec>(tok.p + 32 * s, w);
    stripe(w[0], w[1], w[2], w[3]);
    stripe(w[4], w[5], w[6], w[7]);
  }
  uint32_t t[8];
  load_tail<kVec>(tok.p + 32 * pairs, static_cast<int>(tok.len & 31), tok.limit - 32 * pairs, t);
  const bool odd = (tok.len & 16) != 0;  // one more whole stripe, then the tail in t[4..7]
  if (odd) stripe(t[0], t[1], t[2], t[3]);
  uint32_t tail[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tail[i] = odd ? t[4 + i] : t[i];

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t lo_lane = finish32(acc[j][0], seed32[j][0], tok.len, tail, 0u);
    if (kSwh) {
      const uint32_t hi_lane = finish32(acc[j][L - 1], seed32[j][L - 1], tok.len, tail, kSwhXor);
      const uint32_t hi = avalanche_swh(hi_lane + rotl32(lo_lane, 16) * kP32_3);
      const uint32_t lo = avalanche_swh(lo_lane ^ (rotl32(hi_lane, 13) * kP32_4));
      static_cast<uint64_t*>(out)[j * rows + row] = uint64_t(hi) << 32 | lo;
    } else {
      static_cast<uint32_t*>(out)[j * rows + row] = lo_lane;
    }
  }
}

// -- launch -------------------------------------------------------------------

template <int K>
void launch_xxh64(const uint8_t* data, int64_t rows, int64_t stride, const int32_t* lengths, const Seeds& seeds,
                  uint64_t* out, cudaStream_t stream, bool vec) {
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (vec) {
    xxh64_kernel<K, true><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  } else {
    xxh64_kernel<K, false><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  }
}

template <int K, bool kSwh>
void launch_xxh32(const uint8_t* data, int64_t rows, int64_t stride, const int32_t* lengths, const Seeds& seeds,
                  void* out, cudaStream_t stream, bool vec) {
  const int blocks = static_cast<int>((rows + kThreads - 1) / kThreads);
  if (vec) {
    xxh32_kernel<K, kSwh, true><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  } else {
    xxh32_kernel<K, kSwh, false><<<blocks, kThreads, 0, stream>>>(data, rows, stride, lengths, seeds, out);
  }
}

// Rows start 16-byte aligned: the stripes are read as 16-byte vectors.
inline bool rows_aligned(const void* data, int64_t stride) {
  return (reinterpret_cast<uintptr_t>(data) & 15) == 0 && (stride & 15) == 0;
}

// Seeds [first, first + count) of `seeds`, for one launch.
inline Seeds seed_group(const uint64_t* seeds, int64_t first, int count) {
  Seeds g{};
  for (int j = 0; j < count; ++j) g.v[j] = seeds[first + j];
  return g;
}

}  // namespace swt

#define SWT_SEED_SWITCH(count, CALL) \
  switch (count) {                   \
    case 1: CALL(1); break;          \
    case 2: CALL(2); break;          \
    case 3: CALL(3); break;          \
    case 4: CALL(4); break;          \
    case 5: CALL(5); break;          \
    case 6: CALL(6); break;          \
    case 7: CALL(7); break;          \
    default: CALL(8); break;         \
  }

// XXH64 of the rows of a padded matrix (row stride `stride`, int32 lengths)
// under k seeds (a host array), into out[k, rows].
extern "C" int sw_xxh64(const void* data, int64_t rows, int64_t stride, const void* lengths, const void* seeds,
                        int64_t k, void* out, void* stream) {
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  auto* digests = static_cast<uint64_t*>(out);
  const bool vec = swt::rows_aligned(data, stride);
  for (int64_t first = 0; first < k; first += swt::kMaxSeeds) {
    const int count = static_cast<int>(k - first < swt::kMaxSeeds ? k - first : swt::kMaxSeeds);
    const swt::Seeds group = swt::seed_group(all, first, count);
    uint64_t* dst = digests + first * rows;
#define SWT_CALL(K) swt::launch_xxh64<K>(bytes, rows, stride, lens, group, dst, static_cast<cudaStream_t>(stream), vec)
    SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
  }
  return static_cast<int>(cudaGetLastError());
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
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  const bool vec = swt::rows_aligned(data, stride);
  const int64_t item = swh ? 8 : 4;
  for (int64_t first = 0; first < k; first += swt::kMaxSeeds) {
    const int count = static_cast<int>(k - first < swt::kMaxSeeds ? k - first : swt::kMaxSeeds);
    const swt::Seeds group = swt::seed_group(all, first, count);
    void* dst = static_cast<uint8_t*>(out) + first * rows * item;
    const auto s = static_cast<cudaStream_t>(stream);
    if (swh) {
#define SWT_CALL(K) swt::launch_xxh32<K, true>(bytes, rows, stride, lens, group, dst, s, vec)
      SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
    } else {
#define SWT_CALL(K) swt::launch_xxh32<K, false>(bytes, rows, stride, lens, group, dst, s, vec)
      SWT_SEED_SWITCH(count, SWT_CALL)
#undef SWT_CALL
    }
  }
  return static_cast<int>(cudaGetLastError());
}
