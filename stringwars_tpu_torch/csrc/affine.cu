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
// This kernel does not use DPX yet: its separate adds and maxes take about
// 11, 13, 6 and 8. The DP matrices never reach device memory whole. The
// design:
//
// - One thread per pair, pairs on consecutive threads; the characters are
//   staged transposed (int32[L, B]) so every load of a warp is one
//   coalesced 128-byte row. Each thread loops to its own pair's |a| and |b|,
//   so the TPU's sentinel algebra (fake cells outside each pair's
//   rectangle, affine_pallas.py:108-113, :175-184) is not needed: no cell
//   outside the rectangle is ever computed.
// - Row strips instead of the TPU's anti-diagonal: a thread holds a strip of
//   kRows = 16 rows of H and Z (and the strip's a chars) in registers and
//   sweeps every column of b, reading the row above the strip (H and V) from
//   a per-pair scratch row and writing the strip's bottom row back in its
//   place. The scratch costs 8 bytes read and written per column and strip,
//   half a byte per cell; the anti-diagonal was the TPU's way to vectorize
//   inside a pair, and the GPU vectorizes across pairs instead.
// - NEG = -(1 << 20) stands for minus infinity (V above row 1, Z left of
//   column 1): one gap cost is ever added to it, and scores of 1 KB x 1 KB
//   stay within +-2^12.
#include "common.cuh"

namespace swt {

constexpr int kNeg = -(1 << 20);
constexpr int kRows = 16;

template <bool kLocal, bool kAffine>
__global__ void __launch_bounds__(128)
align_kernel(const int32_t* __restrict__ a_cols, const int32_t* __restrict__ b_cols, const int32_t* __restrict__ a_len,
             const int32_t* __restrict__ b_len, int64_t pairs, int match, int mismatch, int go, int ge,
             int32_t* __restrict__ row_h, int32_t* __restrict__ row_v, int32_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int alen = a_len[p], blen = b_len[p];
  // H of a gap of n chars along row 0 or column 0; 0 in the local score.
  auto edge = [&](int n) { return (kLocal || n == 0) ? 0 : go + (n - 1) * ge; };
  if (alen <= 0 || blen <= 0) {
    out[p] = edge(max(alen, 0) + max(blen, 0));
    return;
  }
  int32_t* hrow = row_h + p;  // column j of the row above the current strip at [j * pairs]
  int32_t* vrow = row_v + p;
  for (int j = 1; j <= blen; ++j) {
    hrow[static_cast<int64_t>(j) * pairs] = edge(j);
    if (kAffine) vrow[static_cast<int64_t>(j) * pairs] = kNeg;
  }
  int best = 0;
  for (int i0 = 1; i0 <= alen; i0 += kRows) {
    const int rows = min(kRows, alen - i0 + 1);
    int ach[kRows], left_h[kRows], left_z[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ach[r] = r < rows ? a_cols[static_cast<int64_t>(i0 - 1 + r) * pairs + p] : -1;
      left_h[r] = edge(i0 + r);  // H[i][0]
      left_z[r] = kNeg;          // Z[i][0]
    }
    int diag_top = edge(i0 - 1);  // H[i0-1][j-1], starting at column 0
    for (int j = 1; j <= blen; ++j) {
      const int64_t at = static_cast<int64_t>(j) * pairs;
      const int c = b_cols[static_cast<int64_t>(j - 1) * pairs + p];
      int up_h = hrow[at];
      int up_v = kAffine ? vrow[at] : 0;
      int dh = diag_top;
      diag_top = up_h;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const int s = ach[r] == c ? match : mismatch;
          int h;
          if (kAffine) {
            const int v = max(up_h + go, up_v + ge);
            const int z = max(left_h[r] + go, left_z[r] + ge);
            h = max(max(v, z), dh + s);
            left_z[r] = z;
            up_v = v;
          } else {
            h = max(dh + s, max(up_h, left_h[r]) + go);
          }
          if (kLocal) {
            h = max(h, 0);
            best = max(best, h);
          }
          dh = left_h[r];
          left_h[r] = h;
          up_h = h;
        }
      }
      hrow[at] = up_h;
      if (kAffine) vrow[at] = up_v;
    }
  }
  out[p] = kLocal ? best : hrow[static_cast<int64_t>(blen) * pairs];
}

template <bool kLocal, bool kAffine>
int launch_align(const void* a_cols, const void* b_cols, const void* a_len, const void* b_len, int64_t pairs, int match,
                 int mismatch, int go, int ge, void* row_h, void* row_v, void* out, cudaStream_t stream) {
  const int threads = pair_threads(pairs);
  const auto blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
  align_kernel<kLocal, kAffine><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(a_cols), static_cast<const int32_t*>(b_cols), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), pairs, match, mismatch, go, ge, static_cast<int32_t*>(row_h),
      static_cast<int32_t*>(row_v), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// Alignment score of `pairs` pairs. a_cols, b_cols: int32[L, pairs] with L
// >= every |a| and |b|; a_len, b_len: int32[pairs]; row_h and row_v: int32
// scratch of (L + 1) * pairs each (row_v unused by the linear body); out:
// int32[pairs]. affine != 0 takes the Gotoh body, 0 the linear one (which
// reads gap_open only); local != 0 gives Smith-Waterman.
extern "C" int sw_align(const void* a_cols, const void* b_cols, const void* a_len, const void* b_len, int64_t pairs,
                        int64_t match, int64_t mismatch, int64_t gap_open, int64_t gap_extend, int64_t affine,
                        int64_t local, void* row_h, void* row_v, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int mt = static_cast<int>(match), mm = static_cast<int>(mismatch);
  const int go = static_cast<int>(gap_open), ge = static_cast<int>(gap_extend);
  if (affine) {
    return local ? swt::launch_align<true, true>(a_cols, b_cols, a_len, b_len, pairs, mt, mm, go, ge, row_h, row_v, out, s)
                 : swt::launch_align<false, true>(a_cols, b_cols, a_len, b_len, pairs, mt, mm, go, ge, row_h, row_v, out, s);
  }
  return local ? swt::launch_align<true, false>(a_cols, b_cols, a_len, b_len, pairs, mt, mm, go, ge, row_h, row_v, out, s)
               : swt::launch_align<false, false>(a_cols, b_cols, a_len, b_len, pairs, mt, mm, go, ge, row_h, row_v, out, s);
}
