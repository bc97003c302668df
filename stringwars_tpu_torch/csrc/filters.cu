// K7 · probabilistic membership filters: the Bloom filter's build and query,
// and the BinaryFuse8 query.
//
// Replaces the XLA functions of stringwars_tpu/ops/filters.py: _bloom_build
// (:66; k-seed xxh64_multiseed digests, positions lo ^ hi * 0x9E3779B9 mod
// m_bits (bloom_positions :57), a scatter-max into a byte plane packed to
// u32 words), _bloom_query (:82; the same positions, word gathers, bit tests
// and an AND over k) and _fuse_query_dev (:209; three gathers from the u8
// fingerprint table, their XOR, the compare with the key's fingerprint).
//
// What bounds them on an H100: the Bloom kernels read each token's bytes
// once (and its span or length) and do k XXH64 hashes a token (about 20
// instructions a finish for a short token); the filter itself (m_bits / 8
// bytes, 64 KB to 2 MB at the containers suite's key counts) stays in L2, so
// the k scattered bit updates or tests a token cost L2 latency, not HBM
// bytes. The fuse query reads 13 bytes a probe (three int32 positions and
// the fingerprint) and writes one; its table is in L2 too. The design:
//
// - Build and query run xxh64.cuh's walk (hash.cu's read path: a lane a
//   token under 32 bytes, a group of four lanes a longer one, tokens read
//   where they lie on a tape or as padded rows) with an epilogue in place of
//   the digests' store: no digest is written. Build: one atomicOr a probe
//   (duplicate positions set a bit twice, as the scatter-max tolerates them).
//   Query: the probe's word is loaded and a missing bit clears the token's
//   answer, which the launch sets to 1 first (every writer writes 0, so their
//   order is of no matter).
// - More than 8 seeds run in launches of up to 8, as the hashes do.
// - The fuse query is one grid-stride pass, a probe a thread.
#include "xxh64.cuh"

namespace swt {

__device__ __forceinline__ uint32_t bloom_position(uint64_t h, uint32_t m_bits) {
  const uint32_t lo = static_cast<uint32_t>(h), hi = static_cast<uint32_t>(h >> 32);
  return (lo ^ (hi * 0x9E3779B9u)) % m_bits;
}

// kMin: blocks an SM the registers must allow (hash.cu's budget for its walk).
template <int K, bool kSpans, int kMin = (K <= 2 ? 5 : 3)>
__global__ void __launch_bounds__(kThreads, kMin)
bloom_build_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint32_t m_bits,
                   uint32_t* __restrict__ words) {
  xxh64_walk<K, kSpans>(data, end, offsets, lengths, width, count, seeds, [=](int64_t, int, uint64_t h) {
    const uint32_t pos = bloom_position(h, m_bits);
    atomicOr(words + (pos >> 5), 1u << (pos & 31));
  });
}

// kMin: blocks an SM the registers must allow (hash.cu's budget for its walk).
template <int K, bool kSpans, int kMin = (K <= 2 ? 5 : 3)>
__global__ void __launch_bounds__(kThreads, kMin)
bloom_query_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint32_t m_bits,
                   const uint32_t* __restrict__ words, uint8_t* __restrict__ out) {
  xxh64_walk<K, kSpans>(data, end, offsets, lengths, width, count, seeds, [=](int64_t t, int, uint64_t h) {
    const uint32_t pos = bloom_position(h, m_bits);
    if (!((__ldg(words + (pos >> 5)) >> (pos & 31)) & 1u)) out[t] = 0;
  });
}

// out[i] = table[h0] ^ table[h1] ^ table[h2] == fp[i], the three positions
// h[i], h[n + i], h[2n + i] clamped to the table.
__global__ void __launch_bounds__(kThreads)
fuse_query_kernel(const uint8_t* __restrict__ table, int64_t table_len, const int32_t* __restrict__ h,
                  const uint8_t* __restrict__ fp, int64_t n, uint8_t* __restrict__ out) {
  const auto at = [&](int32_t i) {
    const int64_t j = i < 0 ? 0 : (i >= table_len ? table_len - 1 : i);
    return __ldg(table + j);
  };
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint8_t got = at(__ldg(h + i)) ^ at(__ldg(h + n + i)) ^ at(__ldg(h + 2 * n + i));
    out[i] = got == __ldg(fp + i);
  }
}

// Which Bloom launch a call makes.
enum class Bloom { kBuild, kQuery };

template <int K>
void bloom_launch(Bloom op, const uint8_t* data, int64_t end, const int64_t* offsets, const int32_t* lengths, int64_t width,
                  int64_t count, const Seeds& seeds, uint32_t m_bits, uint32_t* words, uint8_t* out, cudaStream_t s) {
  const auto run = [&](auto kernel, auto... tail) {
    const int grid = resident_grid(kernel, 0, (count + kThreads - 1) / kThreads);
    kernel<<<grid, kThreads, 0, s>>>(data, end, offsets, lengths, width, count, seeds, m_bits, tail...);
  };
  const bool spans = offsets != nullptr;
  if (op == Bloom::kBuild) {
    run(spans ? bloom_build_kernel<K, true> : bloom_build_kernel<K, false>, words);
  } else {
    run(spans ? bloom_query_kernel<K, true> : bloom_query_kernel<K, false>, static_cast<const uint32_t*>(words), out);
  }
}

// Every group of 8 seeds of k, one launch each (xxh64.cuh's layouts: offsets
// set for spans, lengths and width for rows).
inline int bloom_tokens(Bloom op, const void* data, int64_t end, const void* offsets, const void* lengths, int64_t width,
                        int64_t count, const void* seeds, int64_t k, int64_t m_bits, void* words, void* out, void* stream) {
  if (count <= 0 || end < 0 || k <= 0 || seeds == nullptr || m_bits <= 0 || m_bits > 0xFFFFFFFFll || m_bits % 32 ||
      (offsets == nullptr) == (lengths == nullptr) || (offsets == nullptr && (width <= 0 || end != count * width))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* spans = static_cast<const int64_t*>(offsets);
  const auto* lens = static_cast<const int32_t*>(lengths);
  const auto* all = static_cast<const uint64_t*>(seeds);
  auto* w = static_cast<uint32_t*>(words);
  auto* o = static_cast<uint8_t*>(out);
  const auto m = static_cast<uint32_t>(m_bits);
  const auto s = static_cast<cudaStream_t>(stream);
  if (op == Bloom::kQuery) cudaMemsetAsync(o, 1, static_cast<size_t>(count), s);
  for (int64_t first = 0; first < k; first += kMaxSeeds) {
    const int n = static_cast<int>(k - first < kMaxSeeds ? k - first : kMaxSeeds);
    const Seeds group = seed_group(all, first, n);
    switch (n) {
      case 1: bloom_launch<1>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 2: bloom_launch<2>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 3: bloom_launch<3>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 4: bloom_launch<4>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 5: bloom_launch<5>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 6: bloom_launch<6>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      case 7: bloom_launch<7>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
      default: bloom_launch<8>(op, bytes, end, spans, lens, width, count, group, m, w, o, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// Sets the Bloom bits of `count` tokens under k seeds (a host uint64 array)
// in words (uint32[m_bits / 32], zeroed by the caller, m_bits a multiple of
// 32 below 2^32). Tokens: a tape's spans (offsets int64[count + 1] within
// [0, end]; lengths null) or padded rows (offsets null; data uint8[count,
// width], int32 lengths clamped to [0, width], end = count * width).
extern "C" int sw_bloom_build(const void* data, int64_t end, const void* offsets, const void* lengths, int64_t width,
                              int64_t count, const void* seeds, int64_t k, int64_t m_bits, void* words, void* stream) {
  return swt::bloom_tokens(swt::Bloom::kBuild, data, end, offsets, lengths, width, count, seeds, k, m_bits, words, nullptr,
                           stream);
}

// out (uint8[count]): 1 where every one of the token's k bits is set in
// words, else 0; tokens and seeds as sw_bloom_build's.
extern "C" int sw_bloom_query(const void* data, int64_t end, const void* offsets, const void* lengths, int64_t width,
                              int64_t count, const void* seeds, int64_t k, int64_t m_bits, const void* words, void* out,
                              void* stream) {
  return swt::bloom_tokens(swt::Bloom::kQuery, data, end, offsets, lengths, width, count, seeds, k, m_bits,
                           const_cast<void*>(words), out, stream);
}

// out (uint8[n]): the BinaryFuse8 answer of each probe; h int32[3, n] its
// positions in the uint8 table of table_len entries, fp uint8[n] its
// fingerprint.
extern "C" int sw_fuse_query(const void* table, int64_t table_len, const void* h, const void* fp, int64_t n, void* out,
                             void* stream) {
  if (n <= 0 || table_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  swt::fuse_query_kernel<<<swt::stream_blocks(n), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), table_len, static_cast<const int32_t*>(h), static_cast<const uint8_t*>(fp), n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
