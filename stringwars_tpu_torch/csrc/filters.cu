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
// instructions a finish for a short token, their 64-bit products on the
// IMAD pipe); the filter itself (m_bits / 8 bytes, 64 KB to 2 MB at the
// containers suite's key counts) stays in L2, so the k scattered bit
// updates or tests a token cost L2 operations, not HBM bytes. The fuse
// query reads 13 bytes a probe (three int32 positions and the fingerprint)
// and writes one; its table is in L2 too. The design:
//
// - Build and query run xxh64.cuh's walk (hash.cu's read path: a lane a
//   token under 32 bytes, a group of four lanes a longer one, tokens read
//   where they lie on a tape or as padded rows) with an epilogue in place of
//   the digests' store: no digest is written.
// - Build: one global atomicOr a probe (duplicate positions set a bit
//   twice, as the scatter-max tolerates them). Taken apart at the suite's
//   1 M-key cap (800,000 keys, k = 7; tools/hopper_probes.py filters), the
//   hashing alone takes about nine tenths of the kernel's time and the
//   atomics alone seven tenths: the hashing holds it. The filter held in a
//   thread-block cluster's shared memory instead (the probe's
//   cluster_build_kernel) was slower at both of the suite's shapes.
// - Query: one launch a call (up to 8 seeds), no memset: a lane keeps its
//   token's answer in a register, ANDs it over the seeds and stores it once
//   (a warp's short tokens are 32 consecutive bytes: one store). A held-out
//   key is almost always a negative, and at the suite's fill ratios (25-29%
//   of the bits set) its first clear bit comes after about 1.3-1.4 probes:
//   a short token takes its seeds G at a time and a lane whose bit came out
//   clear stops hashing and loading. G = K keeps a token's loads
//   independent, G = 1 issues the fewest; the probe times the three, and G
//   = 2 (kQueryGroup) was the fastest at the suite's 5,524 held-out keys and
//   within noise of G = 1 at 200,000. A long token's group of four lanes
//   walks its stripes once for every seed, finishes four seeds at a time
//   (one a lane) and stops when its ballot finds a clear bit.
// - More than 8 seeds run in launches of up to 8, as the hashes do; a later
//   query launch skips a token an earlier one decided (its bytes are not
//   read, nothing is stored for it).
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

// chained: a later launch of the call's seeds (out holds the earlier ones'
// answers). kMin as the build's.
template <int K, int G, bool kSpans, int kMin = (K <= 2 ? 5 : 3)>
__global__ void __launch_bounds__(kThreads, kMin)
bloom_query_kernel(const uint8_t* __restrict__ data, int64_t end, const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ lengths, int64_t width, int64_t count, Seeds seeds, uint32_t m_bits,
                   const uint32_t* __restrict__ words, uint8_t* __restrict__ out, bool chained) {
  const Extent x{reinterpret_cast<uintptr_t>(data), reinterpret_cast<uintptr_t>(data) + static_cast<uintptr_t>(end)};
  const auto probe = [=](uint64_t h) {
    const uint32_t pos = bloom_position(h, m_bits);
    return (__ldg(words + (pos >> 5)) >> (pos & 31)) & 1u;
  };
  // The seeds over a short token's words in groups of G, until a bit is clear.
  const auto decide = [=](const uint32_t (&w)[8], int len) {
    const uint64_t none[4] = {0, 0, 0, 0};  // no stripe below 32 bytes
    uint32_t ok = 1;
#pragma unroll
    for (int j0 = 0; j0 < K; j0 += G) {
      if (ok) {
#pragma unroll
        for (int j = j0; j < j0 + G && j < K; ++j) ok &= probe(finish64(none, seeds.v[j], len, w));
      }
    }
    return ok;
  };
  const auto short_fn = [=](int64_t t, uintptr_t p, int n, bool guard, bool small) {
    if (chained && !out[t]) return;  // an earlier launch's seeds decided it
    uint32_t w[8];
    uint32_t ok;
    if (small && !guard) {  // n < 16, as the finish is told: no 16..31-byte tail step
      small_words(p, n, x, w);
      ok = decide(w, n & 15);
    } else {
      if (guard) {
        short_words<true>(p, n, x, w);
      } else {
        short_words<false>(p, n, x, w);
      }
      ok = decide(w, n);
    }
    if (!chained || !ok) out[t] = static_cast<uint8_t>(ok);
  };
  const auto long_fn = [=](int64_t t, uintptr_t q, int64_t m, bool has, bool guard, int lane) {
    const int i = lane & 3;
    const bool open = has && (!chained || out[t]);  // the same in the group's four lanes
    const int64_t len = open ? m : 0;  // a decided token's bytes are not read
    uint64_t acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint64_t a[4];
      init64(a, seeds.v[j]);
      acc[j] = i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
    }
    const uint32_t stripes = static_cast<uint32_t>(len >> 5);
    const uint32_t most = __reduce_max_sync(kFull, stripes);
    const auto step = [&](uint64_t v) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = round64(acc[j], v);
    };
    uint32_t w[8];
    if (guard) {
      group_stripes<uint64_t, 4, true>(q, stripes, most, lane, x, step);
      group_tail<true>(q + 32 * static_cast<uintptr_t>(stripes), static_cast<int>(len & 31), lane, x, w);
    } else {
      group_stripes<uint64_t, 4, false>(q, stripes, most, lane, x, step);
      group_tail<false>(q + 32 * static_cast<uintptr_t>(stripes), static_cast<int>(len & 31), lane, x, w);
    }
    // Lane i of the group finishes seeds i, i + 4, ...; after each four the
    // group's ballot says whether a bit was clear.
    uint32_t ok = open;
#pragma unroll
    for (int r = 0; r < (K + 3) / 4; ++r) {
      uint64_t accs[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 4 * r; j < 4 * r + 4 && j < K; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t v = __shfl_sync(kFull, acc[j], (lane & ~3) + k);
          if ((j & 3) == i) accs[k] = v;
        }
      }
      const int j = 4 * r + i;
      if (ok && j < K) ok = probe(finish64(accs, seed_at<K>(seeds, j), len, w));
      ok = ((__ballot_sync(kFull, !ok) >> (lane & ~3)) & 0xFu) == 0;
    }
    if (open && i == 0 && (!chained || !ok)) out[t] = static_cast<uint8_t>(ok);
  };
  token_walk<kSpans>(data, end, offsets, lengths, width, count, short_fn, long_fn);
}

// out[i] = table[h0] ^ table[h1] ^ table[h2] == fp[i], the three positions
// h[i], h[n + i], h[2n + i] read as jnp.take reads them (the JAX
// _fuse_query_dev): one in [-len, -1] wraps to len + p, one past either end
// reads 255.
__global__ void __launch_bounds__(kThreads)
fuse_query_kernel(const uint8_t* __restrict__ table, int64_t table_len, const int32_t* __restrict__ h,
                  const uint8_t* __restrict__ fp, int64_t n, uint8_t* __restrict__ out) {
  const auto at = [&](int32_t i) -> uint8_t {
    const int64_t j = i < 0 ? i + table_len : i;
    return j < 0 || j >= table_len ? 0xFF : __ldg(table + j);
  };
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint8_t got = at(__ldg(h + i)) ^ at(__ldg(h + n + i)) ^ at(__ldg(h + 2 * n + i));
    out[i] = got == __ldg(fp + i);
  }
}

constexpr int kQueryGroup = 2;  // the seeds a short token takes between its tests

// Kernel over `count` tokens on a resident grid: its blocks an SM asked at
// its first launch, the card's SMs at each.
template <auto Kernel, class... Args>
void launch_tokens(int64_t count, cudaStream_t s, Args... args) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (count + kThreads - 1) / kThreads, cap = static_cast<int64_t>(sms) * per_sm;
  Kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0, s>>>(args...);
}

// Which Bloom launch a call makes.
enum class Bloom { kBuild, kQuery };

template <int K>
void bloom_launch(Bloom op, const uint8_t* data, int64_t end, const int64_t* offsets, const int32_t* lengths, int64_t width,
                  int64_t count, const Seeds& seeds, uint32_t m_bits, uint32_t* words, uint8_t* out, bool chained,
                  cudaStream_t s) {
  constexpr int G = K < kQueryGroup ? K : kQueryGroup;
  const uint32_t* filter = words;
  if (op == Bloom::kBuild && offsets != nullptr) {
    launch_tokens<bloom_build_kernel<K, true>>(count, s, data, end, offsets, lengths, width, count, seeds, m_bits, words);
  } else if (op == Bloom::kBuild) {
    launch_tokens<bloom_build_kernel<K, false>>(count, s, data, end, offsets, lengths, width, count, seeds, m_bits, words);
  } else if (offsets != nullptr) {
    launch_tokens<bloom_query_kernel<K, G, true>>(count, s, data, end, offsets, lengths, width, count, seeds, m_bits, filter,
                                                  out, chained);
  } else {
    launch_tokens<bloom_query_kernel<K, G, false>>(count, s, data, end, offsets, lengths, width, count, seeds, m_bits, filter,
                                                   out, chained);
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
  for (int64_t first = 0; first < k; first += kMaxSeeds) {
    const int n = static_cast<int>(k - first < kMaxSeeds ? k - first : kMaxSeeds);
    const Seeds group = seed_group(all, first, n);
    const bool chained = first > 0;
    switch (n) {
      case 1: bloom_launch<1>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 2: bloom_launch<2>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 3: bloom_launch<3>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 4: bloom_launch<4>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 5: bloom_launch<5>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 6: bloom_launch<6>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      case 7: bloom_launch<7>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
      default: bloom_launch<8>(op, bytes, end, spans, lens, width, count, group, m, w, o, chained, s); break;
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
// words, else 0, every byte written by the kernel; tokens and seeds as
// sw_bloom_build's.
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
