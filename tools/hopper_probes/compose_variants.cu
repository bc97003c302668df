// The package's composition kernel (stringwars_tpu_torch/csrc/normalize.cu)
// at other settings (lanes a row, blocks an SM; no chain walked, the rest of
// the kernel alone), kept for measurement only: tools/hopper_probes.py
// compose times them on the same rows. A copy of nf_compose_kernel with
// those settings as template parameters; the package's kernel is the copy's
// <true, kComposeLanes, kComposeMinBlocks, true>. Nothing of the package
// calls them.
#include "../../stringwars_tpu_torch/csrc/normalize.cu"

namespace swt {

// nf_compose_kernel with kLanes lanes a row (32, 16 or 8), registers for
// kMinBlocks blocks an SM, and, kWalk false, no chain walked (the rest of
// the kernel alone: not the function).
template <bool kVec, int kLanes, int kMinBlocks, bool kWalk>
__global__ void __launch_bounds__(kComposeThreads, kMinBlocks)
compose_variant_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ counts, int32_t* __restrict__ kept,
                       int64_t rows, int64_t width, const uint8_t* __restrict__ classes, int32_t classes_size,
                       const int32_t* __restrict__ s_rank, int32_t s_size, const int32_t* __restrict__ c_rank, int32_t c_size,
                       const int32_t* __restrict__ dense, int32_t n_c) {
  static_assert(kLanes == 32 || kLanes == 16 || kLanes == 8, "a row takes a warp, half or a quarter of one");
  constexpr int kChunk = 4 * kLanes;  // codepoints a row's lanes take at once: four a lane
  constexpr int kRowsAWarp = 32 / kLanes;
  extern __shared__ __align__(16) uint8_t shared[];
  uint8_t* table = shared;
  const int32_t staged = min(classes_size, kCccShared);
  for (int32_t k = threadIdx.x; k < staged / 16; k += kComposeThreads) {
    reinterpret_cast<uint4*>(table)[k] = __ldg(reinterpret_cast<const uint4*>(classes) + k);
  }
  for (int32_t k = (staged & ~15) + threadIdx.x; k < staged; k += kComposeThreads) table[k] = __ldg(classes + k);
  __syncthreads();
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / kLanes, hl = lane % kLanes;  // the lane's row of the warp, and its place in the row's lanes
  const unsigned below_lane = (1u << hl) - 1u, above_lane = ~((2u << hl) - 1u);
  // A warp-wide ballot's bits of the lane's row.
  const auto mine = [&](unsigned ballot) -> unsigned {
    return kLanes == 32 ? ballot : (ballot >> (kLanes * sub)) & ((1u << (kLanes % 32)) - 1u);
  };
  const int off = kChunk * sub;  // the row's place in the warp's copies
  int32_t* cps = reinterpret_cast<int32_t*>(shared + kCccShared + warp * kComposeWarpBytes);  // the chunks' codepoints
  uint8_t* cls = reinterpret_cast<uint8_t*>(cps + 128);  // their classes
  uint8_t* chain_from = cls + 128;  // each chain's first position, in order
  const auto class_of = [&](int32_t cp) -> uint32_t {
    return static_cast<uint32_t>(cp) < static_cast<uint32_t>(staged) ? table[cp] : __ldg(classes + clamped(cp, classes_size));
  };
  const int32_t e = 4 * hl;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kComposeWarps * kRowsAWarp;
  for (int64_t first = (static_cast<int64_t>(blockIdx.x) * kComposeWarps + warp) * kRowsAWarp; first < rows; first += stride) {
    const int64_t r = first + sub;
    int32_t* row = data + r * width;
    const int32_t n = r < rows ? static_cast<int32_t>(min(static_cast<int64_t>(__ldg(counts + r)), width)) : 0;
    // The walk's state carried into the next chunk: the starter (-1: none
    // yet), the row position it was written to, the last kept class.
    int32_t starter = -1, slot = -1, last_cc = 0;
    int32_t out = 0;  // codepoints kept so far
    for (int32_t base = 0; __any_sync(kFull, base < n); base += kChunk) {  // the warp's rows, chunk by chunk
      const int32_t nc = max(min(n - base, kChunk), 0);
      const int4 v = load4<kVec>(row + base, e, nc);
      const int32_t vals[4] = {v.x, v.y, v.z, v.w};
      uint32_t c[4];
      const uint32_t top = max(max(static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y)),
                               max(static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)));
      if (__any_sync(kFull, top >= static_cast<uint32_t>(staged))) {  // a codepoint past the staged table
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = class_of(vals[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = table[vals[k]];
      }
      reinterpret_cast<int4*>(cps + off)[hl] = v;
      reinterpret_cast<uint32_t*>(cls + off)[hl] = c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
      // Chains: a reset point followed by a codepoint that is none (a reset
      // point followed by another composes with nothing), and position 0
      // when it is none (the chain carried in); each ends before the next
      // reset point. A lane lists the chains that begin in its four
      // positions, at their rank among the chunk's.
      bool reset[4], live[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        live[k] = e + k < nc;
        reset[k] = live[k] && c[k] == 0;
      }
      // Whether position e + 4 (the next lane's first) is live and no reset point.
      const bool next_mark = __shfl_down_sync(kFull, static_cast<int>(live[0] && !reset[0]), 1, kLanes) && hl < kLanes - 1;
      bool begins[4];
      int32_t count = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool mark_after = k < 3 ? live[k + 1] && !reset[k + 1] : next_mark;
        begins[k] = (reset[k] && mark_after) || (e + k == 0 && live[k] && !reset[k]);
        count += begins[k];
      }
      const unsigned b0 = mine(__ballot_sync(kFull, count & 1)), b1 = mine(__ballot_sync(kFull, count & 2)),
                     b2 = mine(__ballot_sync(kFull, count & 4));
      int32_t rank = __popc(b0 & below_lane) + 2 * __popc(b1 & below_lane) + 4 * __popc(b2 & below_lane);
      const int32_t chains = kWalk ? __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2) : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (begins[k]) chain_from[off + rank++] = static_cast<uint8_t>(e + k);
      }
      __syncwarp();
      // The walk: the row's lane j takes its chains j, j + kLanes, ...; the
      // chain that reaches the chunk's end leaves its state to the next.
      int32_t w_starter = -1, w_spos = -1, w_last = 0;
      bool w_has = false;
      for (int32_t j = hl; j < chains; j += kLanes) {
        const int32_t from = chain_from[off + j];
        int32_t st, spos, lc, pos;
        if (from == 0 && cls[off] != 0) {  // the chain carried in
          st = starter;
          spos = -1;
          lc = last_cc;
          pos = 0;
        } else {
          st = cps[off + from];
          spos = from;
          lc = 0;
          pos = from + 1;
        }
        for (; pos < nc; ++pos) {
          const uint32_t k = cls[off + pos];
          if (k == 0) break;  // the next reset point: the chain's end
          const int32_t cp = cps[off + pos];
          const bool combiner = k == kCombiner;
          const int32_t cc = combiner ? 0 : static_cast<int32_t>(k);
          int32_t composed = -1;
          if (st >= 0 && (lc == 0 || lc < cc)) {  // not blocked: the primary composite, if any
            if (combiner) {  // Hangul V and T are combiners; L+V and LV+T compose by arithmetic
              if (st >= kLBase && st < kLBase + kLCount && cp >= kVBase && cp < kVBase + kVCount) {
                composed = kSBase + ((st - kLBase) * kVCount + (cp - kVBase)) * kTCount;
              } else if (st >= kSBase && st < kSBase + kSCount && (st - kSBase) % kTCount == 0 && cp > kTBase &&
                         cp < kTBase + kTCount) {
                composed = st + (cp - kTBase);
              }
            }
            if (composed < 0) {
              const int32_t pair = __ldg(dense + __ldg(s_rank + clamped(st, s_size)) * n_c + __ldg(c_rank + clamped(cp, c_size)));
              composed = pair > 0 ? pair : -1;
            }
          }
          if (composed >= 0) {
            st = composed;
            cls[off + pos] = kDropped;
            if (spos >= 0) {
              cps[off + spos] = composed;
            } else {
              row[slot] = composed;  // the carried starter, written in an earlier chunk
            }
          } else if (combiner) {  // a class-0 codepoint kept: the new starter
            st = cp;
            spos = pos;
            lc = 0;
          } else {
            lc = cc;
          }
        }
        if (pos == nc) {
          w_starter = st;
          w_spos = spos;
          w_last = lc;
          w_has = true;
        }
      }
      const unsigned carrier = mine(__ballot_sync(kFull, w_has));  // else the chunk ends at a reset point
      const int src = carrier ? sub * kLanes + __ffs(carrier) - 1 : lane;
      w_starter = __shfl_sync(kFull, w_starter, src);
      w_spos = __shfl_sync(kFull, w_spos, src);
      w_last = __shfl_sync(kFull, w_last, src);
      __syncwarp();
      // Compaction: each kept codepoint at `out` plus the kept ones before it.
      const int4 w = reinterpret_cast<const int4*>(cps + off)[hl];
      const uint32_t k4 = reinterpret_cast<const uint32_t*>(cls + off)[hl];
      const int32_t now[4] = {w.x, w.y, w.z, w.w};
      bool keep[4];
      int32_t kept_here = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        keep[k] = live[k] && ((k4 >> (8 * k)) & 0xFF) != kDropped;
        kept_here += keep[k];
      }
      const unsigned k0 = mine(__ballot_sync(kFull, kept_here & 1)), k1 = mine(__ballot_sync(kFull, kept_here & 2)),
                     k2 = mine(__ballot_sync(kFull, kept_here & 4));
      const int32_t before = __popc(k0 & below_lane) + 2 * __popc(k1 & below_lane) + 4 * __popc(k2 & below_lane);
      const int32_t total = __popc(k0) + 2 * __popc(k1) + 4 * __popc(k2);
      if (out != base || total != nc) {
        int32_t at = out + before;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (keep[k]) row[at++] = now[k];
        }
      }
      // The state carried on, the starter's row position among it.
      int32_t below = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) below += keep[k] && e + k < w_spos;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
      if (nc > 0) {
        if (carrier) {
          starter = w_starter;
          last_cc = w_last;
          if (w_spos >= 0) slot = out + below;
        } else {  // the chunk ends at a reset point, kept: the starter
          starter = cps[off + nc - 1];
          slot = out + total - 1;
          last_cc = 0;
        }
      }
      out += total;
      __syncwarp();
    }
    for (int32_t d = out + hl; d < n; d += kLanes) row[d] = 0;
    if (hl == 0 && r < rows) kept[r] = out;
  }
}

}  // namespace swt

// Variant v: lanes a row 32 (v < 4), 16 (v < 8) or 8, blocks an SM 2 or 3
// (v & 1), the walk unless v & 2.
extern "C" int compose_variant_run(int64_t variant, void* data, const void* counts, void* kept, int64_t rows, int64_t width,
                                   const void* classes, int64_t classes_size, const void* s_rank, int64_t s_size,
                                   const void* c_rank, int64_t c_size, const void* dense, int64_t n_c, void* stream) {
  if (rows <= 0 || width <= 0 || width % 4 || reinterpret_cast<uintptr_t>(data) % 16) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel, int lanes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(swt::kComposeShared));
    const int64_t per_block = swt::kComposeWarps * (32 / lanes);
    const int grid = swt::resident_grid(kernel, swt::kComposeShared, (rows + per_block - 1) / per_block, swt::kComposeThreads);
    kernel<<<grid, swt::kComposeThreads, swt::kComposeShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(data), static_cast<const int32_t*>(counts), static_cast<int32_t*>(kept), rows, width,
        static_cast<const uint8_t*>(classes), static_cast<int32_t>(classes_size), static_cast<const int32_t*>(s_rank),
        static_cast<int32_t>(s_size), static_cast<const int32_t*>(c_rank), static_cast<int32_t>(c_size),
        static_cast<const int32_t*>(dense), static_cast<int32_t>(n_c));
  };
  switch (variant) {
    case 0: launch(swt::compose_variant_kernel<true, 32, 2, true>, 32); break;
    case 1: launch(swt::compose_variant_kernel<true, 32, 3, true>, 32); break;
    case 2: launch(swt::compose_variant_kernel<true, 32, 2, false>, 32); break;
    case 3: launch(swt::compose_variant_kernel<true, 32, 3, false>, 32); break;
    case 4: launch(swt::compose_variant_kernel<true, 16, 2, true>, 16); break;
    case 5: launch(swt::compose_variant_kernel<true, 16, 3, true>, 16); break;
    case 6: launch(swt::compose_variant_kernel<true, 16, 2, false>, 16); break;
    case 7: launch(swt::compose_variant_kernel<true, 16, 3, false>, 16); break;
    case 8: launch(swt::compose_variant_kernel<true, 8, 2, true>, 8); break;
    case 9: launch(swt::compose_variant_kernel<true, 8, 3, true>, 8); break;
    case 10: launch(swt::compose_variant_kernel<true, 8, 2, false>, 8); break;
    case 11: launch(swt::compose_variant_kernel<true, 8, 3, false>, 8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
