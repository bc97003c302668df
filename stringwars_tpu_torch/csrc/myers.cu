// K5 · Levenshtein distance per pair by Myers' bit-parallel algorithm in
// Hyyro's block form, a lane group a pair, each lane one or more words of DP
// rows.
//
// Replaces the TPU kernel stringwars_tpu/ops/myers_pallas.py::_myers
// (_make_kernel :49, _make_kernel_loop :118), which keeps one pair per
// (sublane, lane) of a u32 vector and 32 rows per word. The function is the
// same: pattern a (rows) against text b (columns); each column advances the
// vertical-delta vectors VP/VN of every word with about 17 operations, the
// words passing their bottom row's horizontal delta up as hp/hn (word 0
// starts from hp = 1, hn = 0); the score starts at |a| and moves by bit
// (|a|-1) % 32 of the unshifted Ph/Mh of word (|a|-1) / 32 in every column
// j < |b|. An empty pattern scores |b|.
//
// What bounds it on an H100: integer operations, about 18 32-bit
// instructions per 32 rows and column (17 for the step, one for Eq from a
// table of match vectors); there are no bytes to speak of. At the main
// path's shape (the similarities suite's 4,096 pairs of 100 B) that is about
// a microsecond of the card: what holds a kernel there is latency, the
// dependent chain of each column. The earlier form ran one thread a pair
// (128 warps for 4,096 pairs: under one an SM) with a load of the text on
// every column's chain. The design:
//
// - A lane group a pair, each lane one or more words of DP rows. The
//   schedule is chosen once a batch (ops/myers.py schedule). A batch whose
//   32-row words fit 1,024 threads an SM is latency-bound: one 32-bit word
//   a lane and as many lanes as its longest pattern has words, to a power
//   of two from 1 to 32 (4 lanes for 100-row patterns, 8 pairs a warp; 8 at
//   256 rows; a warp at 1 KB). A larger batch fills the card anyway and is
//   bound by its instructions: 4 64-bit words a lane (2 at 22 planes, for
//   registers), which spends the fewest per row, advanced one after the
//   other in each step, and as many lanes as the longest pattern needs.
// - A skewed wavefront. At step s, lane w advances column s - w of its
//   words; it takes hp/hn of the word below at that column from lane w - 1
//   at the previous step by one __shfl_up_sync, both bits in one register
//   (bits 30, 31) together with the text character of its next column (bits
//   0..21). So the next column's Eq is computed while the current step's
//   chain runs, and only lane 0 reads the text. A pair takes |b| + lanes - 1
//   steps; at steps outside its columns a lane's updates are selected away
//   (one word a lane: no branch in the step, which the latency-bound
//   schedule needs) or skipped (several words a lane).
// - The text. The int32[L, B] layout is pair-minor, so a block's pairs are
//   contiguous in each row: a block stages its pairs' columns in shared
//   memory with coalesced loads, in chunks of 8 G columns (8 KB a block),
//   double-buffered: the next chunk is loaded into registers while the
//   steps of this one run, then stored, with one __syncthreads a chunk.
// - Eq from bitplanes: Eq = AND_k (plane_k ^ mask_k(c)), mask_k all ones
//   where the character lacks bit k, and always all ones for the sentinel
//   plane (bit NBITS-1, set only on pattern padding, so padding never
//   matches). Each lane reads its words' planes from the unchanged
//   int64[W, NBITS, B] staging (a 32-bit lane the low or high half of a
//   plane word). Bitplanes serve bytes (NBITS 9), codepoints up to U+10FFFF
//   (NBITS 22) and staged dense codes of small alphabets (NBITS 2-5; DNA
//   takes 3) with no per-pair table, at 2*NBITS-1 operations per word and
//   column, off the chain.
// - Bands. Past a group's words (1,024 rows at 32-bit lanes) the group goes
//   on in bands: the last lane of a band leaves its hp/hn bits, one each
//   per column, in a per-pair scratch of u32 words that lane 0 of the next
//   band reads, a word ahead, through L2 (__ldcg): a band that reads the
//   scratch also writes it for the next, so a line kept in L1 would be
//   stale. The scratch is allocated only when a pair needs a band.
#include "common.cuh"

namespace swt {

constexpr int kMyersThreads = 128;  // threads a block of the lane-group kernel
constexpr int kMyersLoads = 8;      // text words a thread stages a chunk
constexpr uint32_t kCharMask = 0x3FFFFFFFu;

// Match vector of character c against the word's planes pl[0..kBits).
template <int kBits, typename Word>
__device__ __forceinline__ Word eq_of(const Word (&pl)[kBits], uint32_t c) {
  Word eq = ~pl[kBits - 1];
#pragma unroll
  for (int k = 0; k < kBits - 1; ++k) {
    const Word set = static_cast<Word>(static_cast<int32_t>(c << (31 - k)) >> 31);  // all ones where c has bit k
    eq &= ~(pl[k] ^ set);
  }
  return eq;
}

// Word: uint32_t or uint64_t, the rows of a lane's word; kWords: the words
// a lane holds, advanced one after the other in each step (the carries of
// word k are word k + 1's). lg_group: log2 of the lanes a pair.
template <int kBits, typename Word, int kWords>
__global__ void __launch_bounds__(kMyersThreads)
myers_lanes_kernel(const uint64_t* __restrict__ planes, const int32_t* __restrict__ text,
                   const int32_t* __restrict__ a_len, const int32_t* __restrict__ b_len, int64_t pairs,
                   int64_t rows, int lg_group, uint32_t* carry, int32_t* __restrict__ out) {
  constexpr int kWordBits = 8 * sizeof(Word);
  __shared__ int32_t chunk[2][kMyersLoads * kMyersThreads];
  __shared__ int block_max;
  const int G = 1 << lg_group, per_block = kMyersThreads >> lg_group, band_words = G * kWords;
  const int tid = threadIdx.x, w = tid & (G - 1), q = tid >> lg_group;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t p = first + q;
  const bool real = p < pairs;
  const int alen = real ? a_len[p] : 0, blen = real ? b_len[p] : 0;
  const int words = (alen + kWordBits - 1) / kWordBits;
  const int lastw = alen > 0 ? (alen - 1) / kWordBits : -1, lastr = alen > 0 ? (alen - 1) % kWordBits : 0;
  if (real && alen <= 0 && w == 0) out[p] = blen;
  const int columns = kMyersLoads * G;  // a chunk's columns: kMyersLoads words a thread
  int32_t staged[kMyersLoads];
  // Chunk k holds columns 1 + k * columns ..: lane 0 reads the column after its step's.
  auto load = [&](int64_t k) {
#pragma unroll
    for (int i = 0; i < kMyersLoads; ++i) {
      const int e = tid + i * kMyersThreads;
      const int64_t col = 1 + k * columns + (e >> (7 - lg_group)), pair = first + (e & (per_block - 1));
      staged[i] = col < rows && pair < pairs ? __ldg(text + col * pairs + pair) : 0;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kMyersLoads; ++i) chunk[buf][tid + i * kMyersThreads] = staged[i];
  };
  if (tid == 0) block_max = 0;
  __syncthreads();
  atomicMax(&block_max, (words + band_words - 1) / band_words);
  __syncthreads();
  const int bands = block_max;
  int score = alen;
  for (int band = 0; band < bands; ++band) {
    const int word0 = band * band_words + w * kWords;  // this lane's first word
    const int mine = max(0, min(kWords, words - word0));  // its words this pair has
    const int lanes = max(0, min(G, (words - band * band_words + kWords - 1) / kWords));  // the pair's lanes in the band
    const bool to_next = w == G - 1 && words > (band + 1) * band_words;  // this lane's hp/hn feed the next band
    const int tw = lastw - word0;  // which of this lane's words holds row |a|, if in [0, kWords)
    Word pl[kWords][kBits];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int word = word0 + j;
#pragma unroll
      for (int k = 0; k < kBits; ++k) {
        if (j >= mine) {
          pl[j][k] = 0;
        } else if (sizeof(Word) == 8) {
          pl[j][k] = static_cast<Word>(planes[(static_cast<int64_t>(word) * kBits + k) * pairs + p]);
        } else {
          const auto* half = reinterpret_cast<const uint32_t*>(planes);
          pl[j][k] = static_cast<Word>(half[((static_cast<int64_t>(word >> 1) * kBits + k) * pairs + p) * 2 + (word & 1)]);
        }
      }
    }
    Word vp[kWords], vn[kWords], eq[kWords];
    const int steps = lanes > 0 && blen > 0 ? blen + lanes - 1 : 0;
    __syncthreads();  // block_max read by every thread before it is reset
    if (tid == 0) block_max = 0;
    __syncthreads();
    atomicMax(&block_max, steps);
    __syncthreads();
    const int block_steps = block_max;
    const uint32_t c0 = w == 0 && blen > 0 ? static_cast<uint32_t>(__ldg(text + p)) : 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      vp[j] = ~Word(0);
      vn[j] = 0;
      eq[j] = eq_of<kBits, Word>(pl[j], c0);
    }
    uint32_t pk = c0;  // to lane w + 1: next column's character, hp (bit 30), hn (bit 31)
    uint32_t in_p = 0, in_n = 0, next_p = 0, next_n = 0, out_p = 0, out_n = 0;
    const int64_t group_stride = 2 * pairs;
    if (band > 0 && w == 0 && mine > 0 && blen > 0) {
      next_p = __ldcg(carry + p);
      next_n = __ldcg(carry + p + pairs);
    }
    if (block_steps > 0) {
      load(0);
      store(0);
    }
    __syncthreads();
    for (int s0 = 0, k = 0; s0 < block_steps; s0 += columns, ++k) {
      const bool more = s0 + columns < block_steps;
      if (more) load(k + 1);
      const int32_t* cur = chunk[k & 1];
      const int end = min(columns, block_steps - s0);
      for (int i = 0; i < end; ++i) {
        const uint32_t in = __shfl_up_sync(0xffffffffu, pk, 1, G);
        const int col = s0 + i - w;
        const uint32_t head = static_cast<uint32_t>(cur[i * per_block + q]);  // one word for the group's lanes
        uint32_t hp0 = 1u, hn0 = 0u;  // lane 0's carries: 1, 0 in the first band, else the band above's bits
        if (band > 0) {
          const int bit = col & 31;
          if (w == 0 && bit == 0) {
            in_p = next_p;
            in_n = next_n;
            const int64_t g = (col >> 5) + 1;
            if (mine > 0 && g * 32 < blen) {
              next_p = __ldcg(carry + g * group_stride + p);
              next_n = __ldcg(carry + g * group_stride + p + pairs);
            }
          }
          hp0 = (in_p >> bit) & 1u;
          hn0 = (in_n >> bit) & 1u;
        }
        const uint32_t cnext = w == 0 ? head : in & kCharMask;
        uint32_t hp = w == 0 ? hp0 : (in >> 30) & 1u;  // the carries into word j: the word below's out
        uint32_t hn = w == 0 ? hn0 : in >> 31;
        uint32_t hp_out = 0u, hn_out = 0u;  // the carries out of the lane's top word, if it is the pair's
        const bool active = static_cast<unsigned>(col) < static_cast<unsigned>(blen);
        if constexpr (kWords == 1) {  // one word a lane (the latency-bound schedule): selects, no branch
          const bool live = active && mine > 0;
          const Word xv = eq[0] | vn[0];
          const Word eq2 = eq[0] | static_cast<Word>(hn);
          const Word xh = (((eq2 & vp[0]) + vp[0]) ^ vp[0]) | eq2;
          const Word ph = vn[0] | ~(xh | vp[0]);
          const Word mh = vp[0] & xh;
          if (live && tw == 0) score += static_cast<int>((ph >> lastr) & 1u) - static_cast<int>((mh >> lastr) & 1u);
          const Word phs = (ph << 1) | static_cast<Word>(hp);
          const Word mhs = (mh << 1) | static_cast<Word>(hn);
          vp[0] = live ? mhs | ~(xv | phs) : vp[0];
          vn[0] = live ? phs & xv : vn[0];
          hp_out = live ? static_cast<uint32_t>(ph >> (kWordBits - 1)) : 0u;
          hn_out = live ? static_cast<uint32_t>(mh >> (kWordBits - 1)) : 0u;
        } else {
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            if (j < mine) {  // the lane's words this pair has
              const Word xv = eq[j] | vn[j];
              const Word eq2 = eq[j] | static_cast<Word>(hn);
              const Word xh = (((eq2 & vp[j]) + vp[j]) ^ vp[j]) | eq2;
              const Word ph = vn[j] | ~(xh | vp[j]);
              const Word mh = vp[j] & xh;
              if (active) {
                if (j == tw) score += static_cast<int>((ph >> lastr) & 1u) - static_cast<int>((mh >> lastr) & 1u);
                const Word phs = (ph << 1) | static_cast<Word>(hp);
                const Word mhs = (mh << 1) | static_cast<Word>(hn);
                vp[j] = mhs | ~(xv | phs);
                vn[j] = phs & xv;
              }
              hp = static_cast<uint32_t>(ph >> (kWordBits - 1));
              hn = static_cast<uint32_t>(mh >> (kWordBits - 1));
              if (j == kWords - 1 && active) {  // taken here: read after the loop, ptxas (CUDA 12.8, -O1 and up)
                hp_out = hp;                    // passed on another word's carries where a lane holds several
                hn_out = hn;
              }
            }
          }
        }
        if (to_next && active) {
          const int bit = col & 31;
          out_p |= hp_out << bit;
          out_n |= hn_out << bit;
          if (bit == 31 || col == blen - 1) {
            carry[(col >> 5) * group_stride + p] = out_p;
            carry[(col >> 5) * group_stride + p + pairs] = out_n;
            out_p = out_n = 0;
          }
        }
        pk = cnext | (hp_out << 30) | (hn_out << 31);
#pragma unroll
        for (int j = 0; j < kWords; ++j) eq[j] = eq_of<kBits, Word>(pl[j], cnext);
      }
      if (more) store((k + 1) & 1);
      __syncthreads();
    }
    if (tw >= 0 && tw < kWords && real) out[p] = score;
  }
}

template <int kBits, typename Word, int kWords>
int launch_myers_lanes(const void* planes, const void* text, const void* a_len, const void* b_len, int64_t pairs,
                       int64_t rows, int lg_group, void* carry, void* out, cudaStream_t stream) {
  const int per_block = kMyersThreads >> lg_group;
  const auto blocks = static_cast<unsigned>((pairs + per_block - 1) / per_block);
  myers_lanes_kernel<kBits, Word, kWords><<<blocks, kMyersThreads, 0, stream>>>(
      static_cast<const uint64_t*>(planes), static_cast<const int32_t*>(text), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), pairs, rows, lg_group, static_cast<uint32_t*>(carry),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Word, int kWords, int kWordsCodepoints = kWords>
int dispatch_myers(const void* planes, int64_t nbits, const void* text, int64_t rows, const void* a_len,
                   const void* b_len, int64_t pairs, int lg_group, void* carry, void* out, cudaStream_t s) {
  switch (nbits) {
    case 2: return launch_myers_lanes<2, Word, kWords>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    case 3: return launch_myers_lanes<3, Word, kWords>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    case 4: return launch_myers_lanes<4, Word, kWords>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    case 5: return launch_myers_lanes<5, Word, kWords>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    case 9: return launch_myers_lanes<9, Word, kWords>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    case 22:
      return launch_myers_lanes<22, Word, kWordsCodepoints>(planes, text, a_len, b_len, pairs, rows, lg_group, carry, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace swt

// Levenshtein distance of `pairs` pairs. planes: uint64[W, nbits, pairs]
// with W * 64 >= every |a|; text: int32[rows, pairs] with rows >= every |b|
// (codes below 1 << (nbits - 1)); a_len, b_len: int32[pairs]; max_a: the
// longest |a|; the schedule (ops/myers.py schedule): word_bits rows a lane
// word, words_per_lane words a lane, 2^lg_group lanes a pair, either 32, 1
// or 64, 4 (2 at nbits 22); carry: uint32 scratch of 2 * ceil(rows / 32) *
// pairs words, needed (else null) when max_a is past a band of the group's
// rows; out: int32[pairs].
extern "C" int sw_myers(const void* planes, int64_t nbits, const void* text, int64_t rows, const void* a_len,
                        const void* b_len, int64_t pairs, int64_t max_a, int64_t word_bits, int64_t words_per_lane,
                        int64_t lg_group, void* carry, void* out, void* stream) {
  if (pairs <= 0) return static_cast<int>(cudaSuccess);
  const bool narrow = word_bits == 32 && words_per_lane == 1;
  const bool wide = word_bits == 64 && words_per_lane == (nbits == 22 ? 2 : 4);
  if (!(narrow || wide) || lg_group < 0 || lg_group > 5 ||
      (max_a > (int64_t{1} << lg_group) * words_per_lane * word_bits && carry == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int lg = static_cast<int>(lg_group);
  if (narrow) return swt::dispatch_myers<uint32_t, 1>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
  return swt::dispatch_myers<uint64_t, 4, 2>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
}
