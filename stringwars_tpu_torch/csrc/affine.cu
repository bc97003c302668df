// K5 · Needleman-Wunsch (global) and Smith-Waterman (local) alignment
// scores per pair, with affine (Gotoh) or linear gaps.
//
// Replaces the TPU kernel stringwars_tpu/ops/affine_pallas.py::_affine: its
// Gotoh body (_make_kernel :66, three DP matrices) and its linear body
// (_make_kernel_linear :170, one matrix), each global or local. The scores
// follow ops/similarity.py: a substitution scores match or mismatch, the
// first gap char costs gap_open and each further char gap_extend;
//   V[i][j] = max(H[i-1][j] + go, V[i-1][j] + ge)      (gap in b)
//   Z[i][j] = max(H[i][j-1] + go, Z[i][j-1] + ge)      (gap in a)
//   H[i][j] = max(V, Z, H[i-1][j-1] + s(a[i-1], b[j-1]))
// with H[0][0] = 0 and H[n][0] = H[0][n] = go + (n-1) ge. The global score is
// H[|a|][|b|]; the local one floors every H at 0 and takes the maximum over
// all cells. With go == ge, V and Z fold into H: the linear body keeps H only.
//
// What bounds it on an H100: integer operations. With sm_90's DPX forms a
// cell needs, in 32-bit instructions:
//   global affine 8: s (a compare and a select, 2); V = __viaddmax_s32(
//     H_up, go, V_up + ge) (2); Z the same from the left (2); H =
//     __vimax3_s32(V, Z, H_diag + s) (2);
//   local affine 9: H's floor at 0 fused as __vimax3_s32_relu, plus the
//     running maximum (1);
//   global linear 5: s (2); H = __viaddmax_s32(max(H_up, H_left), go,
//     H_diag + s) (3);
//   local linear 6: the floor fused as __viaddmax_s32_relu, plus the
//     running maximum (1).
// The kernel uses exactly these forms. The DP matrices never reach device
// memory. The design:
//
// - A lane group per pair: 8, 16 or 32 lanes of a warp (`group`, chosen by
//   the wrapper from the batch's longest a and its number of pairs, so that
//   small batches still put enough warps on each SM). Lane l holds a strip
//   of R = ceil(|a| / group) rows of a (at most kRows = 8 or 16, which
//   keeps two blocks of 8 warps an SM in registers) with their H and Z.
// - The group sweeps b as a wavefront: at step s, lane l computes column
//   s - l of its strip, so a pair of |b| columns takes |b| + group - 1
//   steps. The strip's bottom H and V (and the column's b char) pass to the
//   next lane by __shfl_up_sync; lane 0 takes each b char from a chunk that
//   the group loads one chunk ahead. Pairs of different lengths run their
//   own loops: the shuffles name the group's lanes only.
// - A pair longer than group * kRows rows takes several passes; the last
//   lane of a pass leaves its bottom H and V per column in a scratch row
//   that lane 0 of the next pass reads (one chunk ahead, as the b chars).
// - NEG = -(1 << 20) stands for minus infinity (V above row 1, Z left of
//   column 1): one gap cost is ever added to it, and scores of a few KB
//   stay within +-2^14.
// - The local score is each lane's running maximum, reduced over the group
//   with __reduce_max_sync.
#include "common.cuh"

namespace swt {

constexpr int kNeg = -(1 << 20);
constexpr int kAlignThreads = 256;

template <bool kLocal, bool kAffine, int kRows>
__global__ void __launch_bounds__(kAlignThreads, 2)
align_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int64_t width,
             const int32_t* __restrict__ a_len, const int32_t* __restrict__ b_len, int64_t pairs, int group, int match,
             int mismatch, int go, int ge, int32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * kAlignThreads + threadIdx.x;
  const int64_t p = thread / group;
  if (p >= pairs) return;  // whole groups: group divides kAlignThreads
  const int lane = static_cast<int>(threadIdx.x) & (group - 1);
  const int warp_lane = static_cast<int>(threadIdx.x) & 31;
  const unsigned mask = group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (warp_lane & ~(group - 1));
  const int m = a_len[p], n = b_len[p];
  // H of a gap of k chars along row 0 or column 0; 0 in the local score.
  auto edge = [&](int k) { return (kLocal || k == 0) ? 0 : go + (k - 1) * ge; };
  if (m <= 0 || n <= 0) {
    if (lane == 0) out[p] = edge(max(m, 0) + max(n, 0));
    return;
  }
  const int32_t* ap = a + p * width;
  const int32_t* bp = b + p * width;
  int32_t* top = scratch ? scratch + p * 2 * (width + 1) : nullptr;  // H, V of a pass's bottom row, per column
  const int rows_per_lane = min(kRows, (m + group - 1) / group);
  const int pass_rows = rows_per_lane * group;
  int best = 0;
  for (int i0 = 0; i0 < m; i0 += pass_rows) {
    const int first = i0 + lane * rows_per_lane;  // rows first + 1 .. first + rows
    const int rows = max(0, min(rows_per_lane, m - first));
    const bool last_pass = i0 + pass_rows >= m;
    // Every lane of the group holds a whole strip: its cells need no row
    // guard (decided for the group, so that its lanes never diverge on it).
    const bool whole = __all_sync(mask, rows == kRows);
    int ach[kRows], hl[kRows], zl[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ach[r] = r < rows ? ap[first + r] : -1;
      hl[r] = edge(first + r + 1);  // H[i][0]
      zl[r] = kNeg;                 // Z[i][0]
    }
    int diag_top = edge(first);  // H[first][j - 1], from column 0
    // Column chunks of `group`: the b chars (and, after the first pass, the
    // row above the pass) that lane 0 reads, loaded one chunk ahead.
    auto load_chunk = [&](int c0, int& ch, int& th, int& tv) {
      const int j = c0 + lane;
      ch = j < n ? bp[j] : 0;
      if (i0 > 0) {
        th = j < n ? top[2 * (j + 1)] : 0;
        tv = j < n ? top[2 * (j + 1) + 1] : 0;
      }
    };
    int cur_c, cur_h = 0, cur_v = 0, next_c, next_h = 0, next_v = 0;
    load_chunk(0, cur_c, cur_h, cur_v);
    load_chunk(group, next_c, next_h, next_v);
    __syncwarp(mask);
    int out_h = 0, out_v = kNeg, out_c = 0;
    const int steps = n + group - 1;
    for (int s = 0; s < steps; ++s) {
      const int at = s & (group - 1);
      int up_h = __shfl_up_sync(mask, out_h, 1, group);
      int up_v = __shfl_up_sync(mask, out_v, 1, group);
      int c = __shfl_up_sync(mask, out_c, 1, group);
      const int c0 = __shfl_sync(mask, cur_c, at, group);
      int h0 = 0, v0 = 0;
      if (i0 > 0) {
        h0 = __shfl_sync(mask, cur_h, at, group);
        v0 = __shfl_sync(mask, cur_v, at, group);
      }
      if (at == group - 1) {  // the next chunk becomes current; load the one after
        cur_c = next_c;
        cur_h = next_h;
        cur_v = next_v;
        load_chunk(s + 1 + group, next_c, next_h, next_v);
      }
      const int j = s - lane;  // this lane's column, 0-based
      if (lane == 0) {
        c = c0;
        up_h = i0 > 0 ? h0 : edge(j + 1);
        up_v = i0 > 0 ? v0 : kNeg;
      }
      if (j >= 0 && j < n && rows > 0) {
        int dh = diag_top;
        diag_top = up_h;
        // One cell of the column, row r of the strip.
        auto cell = [&](int r) {
          const int sub = ach[r] == c ? match : mismatch;
          int h;
          if (kAffine) {
            const int v = __viaddmax_s32(up_h, go, up_v + ge);
            const int z = __viaddmax_s32(hl[r], go, zl[r] + ge);
            h = kLocal ? __vimax3_s32_relu(v, z, dh + sub) : __vimax3_s32(v, z, dh + sub);
            zl[r] = z;
            up_v = v;
          } else {
            const int h_in = max(up_h, hl[r]);
            h = kLocal ? __viaddmax_s32_relu(h_in, go, dh + sub) : __viaddmax_s32(h_in, go, dh + sub);
          }
          if (kLocal) best = max(best, h);
          dh = hl[r];
          hl[r] = h;
          up_h = h;
        };
        if (whole) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) cell(r);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rows) cell(r);
          }
        }
        if (!last_pass && lane == group - 1) {
          top[2 * (j + 1)] = up_h;
          top[2 * (j + 1) + 1] = up_v;
        }
        if (!kLocal && last_pass && first + rows == m && j == n - 1) out[p] = up_h;
      }
      out_h = up_h;
      out_v = up_v;
      out_c = c;
    }
    __syncwarp(mask);  // the pass's bottom row is in scratch for the next
  }
  if (kLocal) {
    best = __reduce_max_sync(mask, best);
    if (lane == 0) out[p] = best;
  }
}

template <bool kLocal, bool kAffine>
int launch_align(const void* a, const void* b, int64_t width, const void* a_len, const void* b_len, int64_t pairs,
                 int group, int rows, int match, int mismatch, int go, int ge, void* scratch, void* out,
                 cudaStream_t stream) {
  const int64_t threads = pairs * group;
  const auto blocks = static_cast<unsigned>((threads + kAlignThreads - 1) / kAlignThreads);
  const auto* A = static_cast<const int32_t*>(a);
  const auto* B = static_cast<const int32_t*>(b);
  const auto* AL = static_cast<const int32_t*>(a_len);
  const auto* BL = static_cast<const int32_t*>(b_len);
  auto* S = static_cast<int32_t*>(scratch);
  auto* O = static_cast<int32_t*>(out);
  if (rows == 8) {
    align_kernel<kLocal, kAffine, 8><<<blocks, kAlignThreads, 0, stream>>>(A, B, width, AL, BL, pairs, group, match,
                                                                            mismatch, go, ge, S, O);
  } else {
    align_kernel<kLocal, kAffine, 16><<<blocks, kAlignThreads, 0, stream>>>(A, B, width, AL, BL, pairs, group, match,
                                                                             mismatch, go, ge, S, O);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// Alignment score of `pairs` pairs. a, b: int32[pairs, width] (the pairs'
// own rows, every |a|, |b| <= width); a_len, b_len: int32[pairs]; group:
// lanes per pair (8, 16 or 32); rows: the kernel's strip height kRows (8
// or 16; a lane holds min(rows, ceil(|a| / group)) rows); scratch: int32
// of 2 * (width + 1) per pair where some |a| > group * rows, else null; out:
// int32[pairs]. affine != 0 takes the Gotoh body, 0 the linear one (which
// reads gap_open only); local != 0 gives Smith-Waterman.
extern "C" int sw_align(const void* a, const void* b, int64_t width, const void* a_len, const void* b_len,
                        int64_t pairs, int64_t group, int64_t rows, int64_t match, int64_t mismatch, int64_t gap_open,
                        int64_t gap_extend, int64_t affine, int64_t local, void* scratch, void* out, void* stream) {
  if (pairs <= 0 || width <= 0 || (group != 8 && group != 16 && group != 32) || (rows != 8 && rows != 16) ||
      !a || !b || !a_len || !b_len || !out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(group), r = static_cast<int>(rows);
  const int mt = static_cast<int>(match), mm = static_cast<int>(mismatch);
  const int go = static_cast<int>(gap_open), ge = static_cast<int>(gap_extend);
  if (affine) {
    return local ? swt::launch_align<true, true>(a, b, width, a_len, b_len, pairs, g, r, mt, mm, go, ge, scratch, out, s)
                 : swt::launch_align<false, true>(a, b, width, a_len, b_len, pairs, g, r, mt, mm, go, ge, scratch, out, s);
  }
  return local ? swt::launch_align<true, false>(a, b, width, a_len, b_len, pairs, g, r, mt, mm, go, ge, scratch, out, s)
               : swt::launch_align<false, false>(a, b, width, a_len, b_len, pairs, g, r, mt, mm, go, ge, scratch, out, s);
}
