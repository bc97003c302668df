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
// and a serial chain of a few integer operations per state word, about 8
// instructions per byte for one word and 14 for two (shift, or, and, the
// final test, popcount and add per word; the byte and the mask load once):
// at 33.4 T instructions/s the one-word set is held by the 3.35 TB/s byte
// read and the two-word set by its instructions. The design keeps a whole
// state in one register (pair) and the chains of many chunks in flight.
//
// Design:
// - The 256-entry mask table (2 KiB as u64) sits in shared memory, one load
//   per byte; the TPU kernel rebuilt mask(byte) from eight bitplanes per
//   byte (an XOR trick around its slow gathers), which is not carried over.
// - One state word: a u32 when the set fits one 32-bit word, else one u64
//   that holds both of the JAX package's u32 words. That is the same
//   recurrence because every occupied word begins with a start bit (bit 0,
//   and bit 32 when there are two words: placement never lets a pattern
//   straddle the boundary), so the carry from bit 31 into bit 32, which the
//   TPU's separate words drop, is always OR'ed over by the start mask.
// - Chunks as in ahocorasick.cu: each thread walks whole chunks, re-derives
//   its entry state from state 0 over the max_len - 1 bytes before the chunk
//   (rounded down to 32 bytes), then counts at its own positions below n;
//   32-byte batches with the next one in flight; one atomicAdd per block.
#include "common.cuh"

namespace swt {

__device__ __forceinline__ unsigned popcount(uint32_t x) { return __popc(x); }
__device__ __forceinline__ unsigned popcount(uint64_t x) { return __popcll(x); }

template <typename Word, bool kCount>
__device__ __forceinline__ void sa_step16(const Word* masks, Word start, Word fin, Word& state, uint4 v,
                                          unsigned& hits) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      state = ((state << 1) | start) & masks[(words[i] >> (8 * k)) & 0xFFu];
      if (kCount) hits += popcount(state & fin);
    }
  }
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
sa_kernel(const uint8_t* __restrict__ hay, int64_t n, const unsigned long long* __restrict__ table, int64_t chunk,
          int64_t overlap, unsigned long long* __restrict__ out) {
  __shared__ Word masks[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) masks[i] = static_cast<Word>(table[i]);
  const Word start = static_cast<Word>(table[256]), fin = static_cast<Word>(table[257]);
  __syncthreads();

  unsigned long long total = 0;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; c < chunks; c += stride) {
    const int64_t s = c * chunk;
    const int64_t e = s + chunk < n ? s + chunk : n;
    const int64_t full = s + ((e - s) & ~int64_t{31});
    Word state = 0;
    unsigned hits = 0;
    scan_batches(hay, s - overlap > 0 ? (s - overlap) & ~int64_t{31} : 0, s,
                 [&](uint4 v) { sa_step16<Word, false>(masks, start, fin, state, v, hits); });
    scan_batches(hay, s, full, [&](uint4 v) { sa_step16<Word, true>(masks, start, fin, state, v, hits); });
    for (int64_t w = full; w < e; ++w) {
      state = ((state << 1) | start) & masks[hay[w]];
      hits += popcount(state & fin);
    }
    total += hits;
  }
  total = block_sum(total);
  if (threadIdx.x == 0 && total) atomicAdd(out, total);
}

}  // namespace swt

// hay: 16-byte aligned, n > 0. table: uint64[258] on the device, mask(byte)
// for the 256 bytes, then the start and final masks. n_words: 1 (every mask
// below bit 32) or 2. chunk: a multiple of 32 in [32, 2^24]. out: one zeroed
// 64-bit word; the count is added into it.
extern "C" int sw_shiftand(const void* hay, int64_t n, const void* table, int64_t n_words, int64_t chunk,
                           int64_t overlap, void* out, void* stream) {
  if (n <= 0 || (n_words != 1 && n_words != 2) || chunk < 32 || chunk % 32 || chunk > (int64_t{1} << 24) || overlap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* h = static_cast<const uint8_t*>(hay);
  const auto* t = static_cast<const unsigned long long*>(table);
  auto* o = static_cast<unsigned long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t want = (chunks + swt::kThreads - 1) / swt::kThreads;
  if (n_words == 1) {
    const int grid = swt::resident_grid(swt::sa_kernel<uint32_t>, 0, want);
    swt::sa_kernel<uint32_t><<<grid, swt::kThreads, 0, s>>>(h, n, t, chunk, overlap, o);
  } else {
    const int grid = swt::resident_grid(swt::sa_kernel<uint64_t>, 0, want);
    swt::sa_kernel<uint64_t><<<grid, swt::kThreads, 0, s>>>(h, n, t, chunk, overlap, o);
  }
  return static_cast<int>(cudaGetLastError());
}
