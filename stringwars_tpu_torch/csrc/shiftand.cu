// K2 · multi-pattern Shift-And count, for pattern sets of up to 64 chars.
//
// Replaces the TPU kernel stringwars_tpu/ops/shiftand.py::_sa_kernel (via
// _sa_scan). The function: the number of occurrences of every pattern in
// hay[:n], overlapping and nested ones included (the Aho-Corasick count).
// Per byte, with the patterns packed side by side into one bit space,
//     state = ((state << 1) | start) & mask[byte]
//     hits += popcount(state & final)
//
// What bounds it on an H100: per byte one shared-memory load of mask[byte]
// (it depends on the byte alone, off the chain) and a few integer
// operations per 32-bit state word: the shift, (x | start) & mask, the
// final test, the popcount and the add. Nearly all of them issue to the
// integer ALU pipe, 64 lanes a clock an SM, half the lanes the instruction
// bound assumes. Measured (tools/hopper_probes.py shiftand), the earlier
// kernel ran as fast on 16 MiB held in L2 as on 64 MiB from device memory,
// and as fast without its mask load: the pipes, not the bytes, set the
// time.
//
// Design, one form a word count (each the fastest measured there):
// - The 256-entry mask table sits in shared memory (u32 a word, one load a
//   byte); the TPU kernel rebuilt mask(byte) from eight bitplanes per byte
//   (an XOR trick around its slow gathers), which is not carried over.
// - One state word: each thread walks whole chunks and reads its own
//   haystack directly, a u32 state. The byte by a shift and a mask, the
//   state shifted. Its rewrites (the byte by PRMT, the shift as a multiply,
//   and the chunks staged as below) ran 0.0405-0.0417 ms at 64 MiB against
//   this loop's 0.0392-0.0400.
// - Two state words: two independent u32 words, as in the JAX package's
//   kernel, not one u64, whose shift takes two funnel shifts on the ALU
//   pipe. Every occupied word begins with a start bit (bit 0, and bit 32:
//   placement never lets a pattern straddle the boundary), so the carry
//   from bit 31 into bit 32 that a u64 would pass is always OR'ed over by
//   the start mask: the two forms are one recurrence. The byte is taken by
//   one PRMT, the shift is a multiply (x * 2, on the FMA pipe), one LOP3
//   makes (x | start) & mask, one IADD3 sums the two popcounts. A warp takes
//   32 consecutive chunks at a time and copies them through shared memory
//   in 64-byte slices (walk_tile); with its lanes reading their chunks
//   directly, this form ran as slow as the u64 one.
// - One-byte patterns (max_len 1, the find suite's charsets): every start
//   bit is a final bit and the state after a byte is its mask, so the count
//   is a table of 256 counts summed over the bytes, with no chain; staged
//   as the two-word form.
// - Chunks as in ahocorasick.cu: each thread walks whole chunks, re-derives
//   its entry state from state 0 over the max_len - 1 bytes before the chunk
//   (rounded down to 32 bytes), then counts at its own positions below n.
//   One atomicAdd per block.
#include "common.cuh"

namespace swt {

constexpr int kSlice = 64;  // bytes a lane walks from each staged slice (walk_tile)

// Bytes a lane walks from one staged slice, and a warp's double buffer of
// 32 rows of a slice: rows kSlice + 16 bytes apart, so that eight lanes'
// 16-byte reads at one offset cover the 32 banks once (a warp's read is its
// four wavefronts).
template <int kSlice>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * 32 * (kSlice + 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One slice's copies: the 32 rows' bytes [off, off + (16 << shift)) of row
// r, which starts at hay + first + r * pitch, into buf, row r at r * (kSlice
// + 16). Consecutive lanes copy consecutive 16 bytes of a row.
template <int kSlice>
__device__ __forceinline__ void stage_slice(const uint8_t* __restrict__ hay, int64_t first, int64_t pitch, int64_t off,
                                            int shift, uint8_t* buf) {
  const int lane = threadIdx.x & 31;
  for (int p = lane; p < 32 << shift; p += 32) {
    const int r = p >> shift, col = p & ((1 << shift) - 1);
    cp_async16(buf + r * (kSlice + 16) + col * 16, hay + first + r * pitch + off + col * 16);
  }
  cp_async_commit();
}

// Walks a warp's 32 chunk scans through shared memory: lane r walks the
// `walk` bytes at hay + first + r * pitch (first, pitch and walk multiples
// of 32, hay 16-byte aligned), calling step16(v, count) on each 16-byte
// vector, count false for the first `warm` bytes (a multiple of 32). Slices
// of kSlice bytes a row (32, 64, 128 or 256), then of 32 for the
// rest; the next slice's copies (cp.async) are in flight while the current
// one is walked. stage: the warp's stage_bytes<kSlice>(). Every lane of the
// warp calls it.
template <int kSlice, class Step16>
__device__ __forceinline__ void staged_walk(const uint8_t* __restrict__ hay, int64_t first, int64_t pitch, int64_t walk,
                                            int64_t warm, uint8_t* stage, Step16 step16) {
  static_assert(kSlice == 32 || kSlice == 64 || kSlice == 128 || kSlice == 256, "a slice of 32 to 256 bytes");
  constexpr int kShift = kSlice == 32 ? 1 : kSlice == 64 ? 2 : kSlice == 128 ? 3 : 4;  // log2 of its 16-byte pieces
  const int lane = threadIdx.x & 31;
  const int64_t whole = walk / kSlice, slices = whole + (walk - whole * kSlice) / 32;
  auto offset = [&](int64_t t) { return t < whole ? t * kSlice : whole * kSlice + (t - whole) * 32; };
  auto issue = [&](int64_t t) {
    stage_slice<kSlice>(hay, first, pitch, offset(t), t < whole ? kShift : 1, stage + (t & 1) * (32 * (kSlice + 16)));
  };
  issue(0);
  for (int64_t t = 0; t < slices; ++t) {
    if (t + 1 < slices) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int64_t off = offset(t);
    const uint8_t* row = stage + (t & 1) * (32 * (kSlice + 16)) + lane * (kSlice + 16);
    const int halves = t < whole ? kSlice / 32 : 1;
    for (int h = 0; h < halves; ++h) {
      const bool count = off + 32 * h >= warm;
      step16(*reinterpret_cast<const uint4*>(row + 32 * h), count);
      step16(*reinterpret_cast<const uint4*>(row + 32 * h + 16), count);
    }
    __syncwarp();
  }
}

// A warp's tile of 32 chunks: lane r takes chunk c0 + r of `chunk` bytes (a multiple
// of 32) and walks it after a warm-up from the state at the start: the
// max_len - 1 = overlap bytes before it, rounded up to 32 (from byte 0
// where the chunk starts within them), counting nothing there. A tile of
// whole chunks past the first overlap goes through shared memory
// (staged_walk, stage: the warp's stage_bytes<kSlice>()); any other, at
// the haystack's ends, lane by lane from device memory (scan_batches), the
// ragged end byte by byte through step(byte). Every lane of the warp calls
// it, with step16(v, count) as in staged_walk.
template <int kSlice, class Step16, class Step>
__device__ __forceinline__ void walk_tile(const uint8_t* __restrict__ hay, int64_t n, int64_t c0, int64_t chunk,
                                          int64_t overlap, uint8_t* stage, Step16 step16, Step step) {
  const int64_t warm = (overlap + 31) & ~int64_t{31};
  if (c0 * chunk > overlap && (c0 + 32) * chunk <= n) {
    staged_walk<kSlice>(hay, c0 * chunk - warm, chunk, warm + chunk, warm, stage, step16);
    return;
  }
  const int64_t s = (c0 + (threadIdx.x & 31)) * chunk;
  if (s >= n) return;
  const int64_t e = s + chunk < n ? s + chunk : n;
  const int64_t full = s + ((e - s) & ~int64_t{31});
  scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s, [&](uint4 v) { step16(v, false); });
  scan_batches(hay, s, full, [&](uint4 v) { step16(v, true); });
  for (int64_t w = full; w < e; ++w) step(static_cast<uint32_t>(hay[w]));
}

// 16 bytes of the one-word recurrence.
template <bool kCount>
__device__ __forceinline__ void sa_step16(const uint32_t* masks, uint32_t start, uint32_t fin, uint32_t& state, uint4 v,
                                          unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      state = ((state << 1) | start) & masks[(words[i] >> (8 * k)) & 0xFFu];
      if (kCount) hits += __popc(state & fin);
    }
  }
}

// One step of the two-word recurrence (masks: the two words of a byte's
// mask side by side).
template <bool kCount>
__device__ __forceinline__ void sa2_step(const uint32_t* masks, const uint32_t (&start)[2], const uint32_t (&fin)[2],
                                         uint32_t (&state)[2], uint32_t byte, unsigned& hits) {
  const uint2 m = reinterpret_cast<const uint2*>(masks)[byte];
  state[0] = (state[0] * 2u | start[0]) & m.x;
  state[1] = (state[1] * 2u | start[1]) & m.y;
  if (kCount) hits += __popc(state[0] & fin[0]) + __popc(state[1] & fin[1]);
}

template <bool kCount>
__device__ __forceinline__ void sa2_step16(const uint32_t* masks, const uint32_t (&start)[2], const uint32_t (&fin)[2],
                                           uint32_t (&state)[2], uint4 v, unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sa2_step<kCount>(masks, start, fin, state, __byte_perm(words[i], 0, 0x4440 + k), hits);
  }
}

// One-byte patterns (max_len 1: every start bit is a final bit): the state
// after a byte is its mask, so the count is the sum over the bytes of
// popcount(mask[byte] & fin), a table of 256 counts, with no chain.
__device__ __forceinline__ void sa_count16(const uint8_t* counts, uint4 v, unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) hits += counts[__byte_perm(words[i], 0, 0x4440 + k)];
  }
}

// kOneByte: the count table; else the recurrence of kWords state words.
template <int kWords, bool kOneByte>
__global__ void __launch_bounds__(kThreads)
sa_kernel(const uint8_t* __restrict__ hay, int64_t n, const unsigned long long* __restrict__ table, int64_t chunk,
          int64_t overlap, unsigned long long* __restrict__ out) {
  __shared__ __align__(8) uint32_t masks[256 * kWords];
  __shared__ uint8_t counts[256];
  extern __shared__ __align__(16) uint8_t stages[];
  uint32_t start[kWords], fin[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    start[w] = static_cast<uint32_t>(table[256] >> (32 * w));
    fin[w] = static_cast<uint32_t>(table[257] >> (32 * w));
  }
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      masks[i * kWords + w] = static_cast<uint32_t>(table[i] >> (32 * w));
      c += __popc(masks[i * kWords + w] & fin[w]);
    }
    if (kOneByte) counts[i] = static_cast<uint8_t>(c);
  }
  __syncthreads();

  unsigned long long total = 0;
  if constexpr (kWords == 1 && !kOneByte) {
    const int64_t chunks = (n + chunk - 1) / chunk;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; c < chunks; c += stride) {
      const int64_t s = c * chunk;
      const int64_t e = s + chunk < n ? s + chunk : n;
      const int64_t full = s + ((e - s) & ~int64_t{31});
      uint32_t state = 0;
      unsigned hits = 0;
      scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                   [&](uint4 v) { sa_step16<false>(masks, start[0], fin[0], state, v, hits); });
      scan_batches(hay, s, full, [&](uint4 v) { sa_step16<true>(masks, start[0], fin[0], state, v, hits); });
      for (int64_t w = full; w < e; ++w) {
        state = ((state << 1) | start[0]) & masks[hay[w]];
        hits += __popc(state & fin[0]);
      }
      total += hits;
    }
  } else {
    constexpr int kWarps = kThreads / 32;
    uint8_t* stage = stages + (threadIdx.x >> 5) * stage_bytes<kSlice>();
    const int64_t tiles = ((n + chunk - 1) / chunk + 31) / 32;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); t < tiles;
         t += static_cast<int64_t>(gridDim.x) * kWarps) {
      unsigned hits = 0;
      if constexpr (kOneByte) {
        walk_tile<kSlice>(hay, n, 32 * t, chunk, overlap, stage, [&](uint4 v, bool) { sa_count16(counts, v, hits); },
                          [&](uint32_t byte) { hits += counts[byte]; });
      } else {
        uint32_t state[2] = {};
        walk_tile<kSlice>(
            hay, n, 32 * t, chunk, overlap, stage,
            [&](uint4 v, bool count) {
              if (count) {
                sa2_step16<true>(masks, start, fin, state, v, hits);
              } else {
                sa2_step16<false>(masks, start, fin, state, v, hits);
              }
            },
            [&](uint32_t byte) { sa2_step<true>(masks, start, fin, state, byte, hits); });
      }
      total += hits;
    }
  }
  total = block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

}  // namespace swt

// hay: 16-byte aligned, n > 0. table: uint64[258] on the device, mask(byte)
// for the 256 bytes, then the start and final masks. n_words: 1 (every mask
// below bit 32) or 2. overlap: max_len - 1 (0: the one-byte form). chunk: a
// multiple of 32 in [32, 2^24]. out: one zeroed 64-bit word; the count is
// added into it.
extern "C" int sw_shiftand(const void* hay, int64_t n, const void* table, int64_t n_words, int64_t chunk,
                           int64_t overlap, void* out, void* stream) {
  if (n <= 0 || (n_words != 1 && n_words != 2) || chunk < 32 || chunk % 32 || chunk > (int64_t{1} << 24) || overlap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const unsigned long long*>(table);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int kWarps = swt::kThreads / 32;
  const int64_t want = (((n + chunk - 1) / chunk + 31) / 32 + kWarps - 1) / kWarps;
  auto kernel = overlap == 0 ? (n_words == 1 ? swt::sa_kernel<1, true> : swt::sa_kernel<2, true>)
                             : (n_words == 1 ? swt::sa_kernel<1, false> : swt::sa_kernel<2, false>);
  const bool staged = overlap == 0 || n_words == 2;  // the one-word recurrence reads its chunks directly
  const size_t smem = staged ? kWarps * swt::stage_bytes<swt::kSlice>() : 0;
  const int grid = swt::resident_grid(kernel, smem, want);
  kernel<<<grid, swt::kThreads, smem, s>>>(h, n, t, chunk, overlap, o);
  return static_cast<int>(cudaGetLastError());
}
