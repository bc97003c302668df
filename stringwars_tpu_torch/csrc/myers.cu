// K5 · Levenshtein distance per pair by Myers' bit-parallel algorithm in
// Hyyro's block form, 64 DP rows per 64-bit word.
//
// Replaces the TPU kernel stringwars_tpu/ops/myers_pallas.py::_myers
// (_make_kernel :49, _make_kernel_loop :118), which keeps one pair per
// (sublane, lane) of a u32 vector and 32 rows per word. The function is the
// same: pattern a (rows) against text b (columns); each column advances the
// vertical-delta vectors VP/VN of every word with about 17 operations, the
// words passing their bottom row's horizontal delta up as hp/hn (word 0
// starts from hp = 1, hn = 0); the score starts at |a| and moves by bit
// (|a|-1) % 64 of the unshifted Ph/Mh of word (|a|-1) / 64 in every column
// j < |b|. An empty pattern scores |b|.
//
// What bounds it on an H100: integer operations. The function needs about
// 18 32-bit instructions per 32 rows and column: 17 for the step and one for
// Eq, looked up in a table of the pattern's match vectors. This kernel
// spends more: its 64-bit words make each operation two 32-bit instructions
// (the add a carry pair), and Eq from bitplanes costs 2*NBITS-1 operations
// per word and column (below). There are no bytes to speak of (the text is
// read once per band of words). The design:
//
// - One thread per pair, pairs on consecutive threads: the bitplanes
//   (int64[W, NBITS, B]) and the text (int32[L, B]) are pair-minor, so every
//   load of a warp is one coalesced 256-byte (planes) or 128-byte (text)
//   row. Each thread loops to its own pair's |a| and |b|: no zones, no
//   padding columns.
// - Eq from bitplanes kept in registers: Eq = AND_k (plane_k ^ mask_k(c)),
//   mask_k all ones where the text char lacks bit k, and always all ones for
//   the sentinel plane (bit NBITS-1, set only on pattern padding, so
//   padding never matches). This is the TPU's Eq, kept because it serves
//   bytes (NBITS 9), codepoints up to U+10FFFF (NBITS 22) and staged dense
//   codes of small alphabets (NBITS 2-5; DNA takes 3) with one code path and
//   no per-pair table: a Peq table over the byte alphabet would be 8 KB a
//   pair for 256-row patterns, and over codepoints it has no fixed size.
//   The cost is 2*NBITS-1 logic operations per word and column, 5 for DNA.
// - Bands of words: a thread holds the planes and VP/VN of kBand words in
//   registers (4 words = 256 rows; 2 words for 22-bit codepoints, whose
//   planes are 2.4x larger), sweeps every column for them, and leaves the
//   band's top-row carries (hp/hn of its last word, one bit each per column)
//   in a per-pair scratch of u32 words for the next band. So any |a| runs
//   (a 1 KB read is 4 bands), with no local-memory arrays.
#include "common.cuh"

namespace swt {

template <int kBits, int kBand>
__global__ void __launch_bounds__(128)
myers_kernel(const uint64_t* __restrict__ planes, const int32_t* __restrict__ text, const int32_t* __restrict__ a_len,
             const int32_t* __restrict__ b_len, int64_t pairs, uint32_t* __restrict__ carry, int32_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int alen = a_len[p], blen = b_len[p];
  if (alen <= 0) {
    out[p] = blen;
    return;
  }
  const int words = (alen + 63) >> 6;
  const int lastw = (alen - 1) >> 6;
  const int lastr = (alen - 1) & 63;
  int score = alen;
  for (int band = 0; band < words; band += kBand) {
    const int nw = min(kBand, words - band);
    const bool from_prev = band > 0;  // hp/hn in from the band of the rows above
    const bool to_next = band + kBand < words;
    const int tw = lastw - band;  // the word that holds row |a|, if it lies in this band
    uint64_t pl[kBand][kBits];
    uint64_t vp[kBand], vn[kBand];
#pragma unroll
    for (int w = 0; w < kBand; ++w) {
#pragma unroll
      for (int k = 0; k < kBits; ++k) {
        pl[w][k] = w < nw ? planes[(static_cast<int64_t>(band + w) * kBits + k) * pairs + p] : 0ull;
      }
      vp[w] = ~0ull;
      vn[w] = 0ull;
    }
    uint32_t in_p = 0, in_n = 0, out_p = 0, out_n = 0;
    for (int j = 0; j < blen; ++j) {
      const int bit = j & 31;
      uint32_t* group = carry + static_cast<int64_t>(j >> 5) * 2 * pairs + p;
      if (from_prev && bit == 0) {
        in_p = group[0];
        in_n = group[pairs];
      }
      const uint32_t c = static_cast<uint32_t>(text[static_cast<int64_t>(j) * pairs + p]);
      uint64_t mask[kBits];
#pragma unroll
      for (int k = 0; k < kBits - 1; ++k) mask[k] = ((c >> k) & 1u) ? 0ull : ~0ull;
      mask[kBits - 1] = ~0ull;
      uint64_t hp = from_prev ? (in_p >> bit) & 1u : 1ull;
      uint64_t hn = from_prev ? (in_n >> bit) & 1u : 0ull;
#pragma unroll
      for (int w = 0; w < kBand; ++w) {
        if (w < nw) {
          uint64_t eq = pl[w][0] ^ mask[0];
#pragma unroll
          for (int k = 1; k < kBits; ++k) eq &= pl[w][k] ^ mask[k];
          const uint64_t xv = eq | vn[w];
          const uint64_t eq2 = eq | hn;
          const uint64_t xh = (((eq2 & vp[w]) + vp[w]) ^ vp[w]) | eq2;
          const uint64_t ph = vn[w] | ~(xh | vp[w]);
          const uint64_t mh = vp[w] & xh;
          if (w == tw) score += static_cast<int>((ph >> lastr) & 1ull) - static_cast<int>((mh >> lastr) & 1ull);
          const uint64_t phs = (ph << 1) | hp;
          const uint64_t mhs = (mh << 1) | hn;
          vp[w] = mhs | ~(xv | phs);
          vn[w] = phs & xv;
          hp = ph >> 63;
          hn = mh >> 63;
        }
      }
      if (to_next) {
        out_p |= static_cast<uint32_t>(hp) << bit;
        out_n |= static_cast<uint32_t>(hn) << bit;
        if (bit == 31 || j == blen - 1) {
          group[0] = out_p;
          group[pairs] = out_n;
          out_p = out_n = 0;
        }
      }
    }
  }
  out[p] = score;
}

template <int kBits, int kBand>
int launch_myers(const void* planes, const void* text, const void* a_len, const void* b_len, int64_t pairs, void* carry,
                 void* out, cudaStream_t stream) {
  const int threads = pair_threads(pairs);
  const auto blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
  myers_kernel<kBits, kBand><<<blocks, threads, 0, stream>>>(
      static_cast<const uint64_t*>(planes), static_cast<const int32_t*>(text), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), pairs, static_cast<uint32_t*>(carry), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// Levenshtein distance of `pairs` pairs. planes: uint64[W, nbits, pairs]
// with W * 64 >= every |a|; text: int32[L, pairs] with L >= every |b| (codes
// below 1 << (nbits - 1)); a_len, b_len: int32[pairs]; carry: uint32
// scratch of 2 * ceil(L / 32) * pairs words; out: int32[pairs].
extern "C" int sw_myers(const void* planes, int64_t nbits, const void* text, const void* a_len, const void* b_len,
                        int64_t pairs, void* carry, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 2: return swt::launch_myers<2, 4>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 3: return swt::launch_myers<3, 4>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 4: return swt::launch_myers<4, 4>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 5: return swt::launch_myers<5, 4>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 9: return swt::launch_myers<9, 4>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 22: return swt::launch_myers<22, 2>(planes, text, a_len, b_len, pairs, carry, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
