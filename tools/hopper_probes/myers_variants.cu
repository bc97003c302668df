// Variants of the Myers Levenshtein kernel (stringwars_tpu_torch/csrc/myers.cu)
// for measurement only: the earlier one-thread-a-pair kernel, as it was and
// with its text column taken from a register, and the lane-group kernel with
// 32- or 64-bit lane words, 1, 2 or 4 of them a lane, at a group size the
// caller forces. Built and timed by tools/hopper_probes.py myers; nothing of
// the package calls it.
#include "../../stringwars_tpu_torch/csrc/myers.cu"

namespace {

// The earlier kernel: one thread a pair, kBand 64-bit words in registers,
// the band's top-row carries in a per-pair scratch. kTextReg: the column's
// character is made from j and p in registers instead of loaded (the
// distances are then not the batch's: a timing variant only).
template <int kBits, int kBand, bool kTextReg>
__global__ void __launch_bounds__(128)
parent_myers_kernel(const uint64_t* __restrict__ planes, const int32_t* __restrict__ text, const int32_t* __restrict__ a_len,
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
    const bool from_prev = band > 0;
    const bool to_next = band + kBand < words;
    const int tw = lastw - band;
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
      const uint32_t c = kTextReg ? ((static_cast<uint32_t>(j) * 0x9E3779B1u + static_cast<uint32_t>(p)) >> 7) &
                                        ((1u << (kBits - 1)) - 1u)
                                  : static_cast<uint32_t>(text[static_cast<int64_t>(j) * pairs + p]);
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

template <int kBits, int kBand, bool kTextReg>
int launch_parent(const void* planes, const void* text, const void* a_len, const void* b_len, int64_t pairs, void* carry,
                  void* out, cudaStream_t stream) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = pairs >= static_cast<int64_t>(sms) * 2 * 128 ? 128 : 32;
  const auto blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
  parent_myers_kernel<kBits, kBand, kTextReg><<<blocks, threads, 0, stream>>>(
      static_cast<const uint64_t*>(planes), static_cast<const int32_t*>(text), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), pairs, static_cast<uint32_t*>(carry), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kTextReg>
int dispatch_parent(const void* planes, int64_t nbits, const void* text, const void* a_len, const void* b_len,
                    int64_t pairs, void* carry, void* out, cudaStream_t s) {
  switch (nbits) {
    case 3: return launch_parent<3, 4, kTextReg>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 4: return launch_parent<4, 4, kTextReg>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 9: return launch_parent<9, 4, kTextReg>(planes, text, a_len, b_len, pairs, carry, out, s);
    case 22: return launch_parent<22, 2, kTextReg>(planes, text, a_len, b_len, pairs, carry, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// variant 0: the earlier kernel; 1: the same, text from registers; 2: the
// lane-group kernel, 32-bit lane words, one a lane; 3: the same, 64-bit lane
// words, words_per_lane (1, 2 or 4) a lane. For 2 and 3, lg_group is log2
// of the lanes a pair. carry: 2 * ceil(rows / 32) * pairs u32 words, always
// given.
extern "C" int myers_variant_run(int64_t variant, const void* planes, int64_t nbits, const void* text, int64_t rows,
                                 const void* a_len, const void* b_len, int64_t pairs, int64_t lg_group,
                                 int64_t words_per_lane, void* carry, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int lg = static_cast<int>(lg_group);
  switch (variant) {
    case 0: return dispatch_parent<false>(planes, nbits, text, a_len, b_len, pairs, carry, out, s);
    case 1: return dispatch_parent<true>(planes, nbits, text, a_len, b_len, pairs, carry, out, s);
    case 2: return swt::dispatch_myers<uint32_t, 1>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
    case 3:
      switch (words_per_lane) {
        case 1: return swt::dispatch_myers<uint64_t, 1>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
        case 2: return swt::dispatch_myers<uint64_t, 2>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
        case 4: return swt::dispatch_myers<uint64_t, 4>(planes, nbits, text, rows, a_len, b_len, pairs, lg, carry, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
