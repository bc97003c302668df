// K9 · UAX#14 line-break rules: the pair rules LB4-LB31 of
// stringwars_tpu/ops/segment.py::_lb_rules (:1035-1141), one pass over the
// eleven int32 feature streams, out[i] = 1 where a break is allowed.
//
// Replaces stringwars_tpu/ops/scanline.py::_ew_kernel (via _ew_call <-
// elementwise_map), whose one user is this rule set: the TPU kernel loads
// every feature tile once and evaluates a Python rule function in
// registers. Here the same rules are written out as a device function.
//
// The class numbers are the indexes of the LB values tuple
// (stringwars_tpu_torch/unicode/tables.py LB_VALUES) after LB1 resolution
// (AI/SA/XX -> AL, CJ -> NS, done before the features). A CPU test parses
// LbClass and LbStream below and holds them equal to the Python side.
//
// What bounds it on an H100: bytes, 44 read and 4 written per position
// (128 Mi positions: 6 GiB, about 1.9 ms at 3.35 TB/s); the rules are about
// 70 compares and masks, far under the byte time. The design: a grid-stride
// loop, one position per thread per step, coalesced loads through the
// read-only cache, each class set tested as one bit of a 64-bit mask.
#include "common.cuh"

namespace swt {

enum LbClass : int {
  LB_XX = 0, LB_BK = 1, LB_CR = 2, LB_LF = 3, LB_NL = 4, LB_SP = 5, LB_ZW = 6, LB_WJ = 7, LB_GL = 8,
  LB_BA = 9, LB_BB = 10, LB_B2 = 11, LB_HY = 12, LB_CB = 13, LB_CL = 14, LB_CP = 15, LB_EX = 16,
  LB_IN = 17, LB_NS = 18, LB_OP = 19, LB_QU = 20, LB_IS = 21, LB_NU = 22, LB_PO = 23, LB_PR = 24,
  LB_SY = 25, LB_AI = 26, LB_AL = 27, LB_CJ = 28, LB_EB = 29, LB_EM = 30, LB_H2 = 31, LB_H3 = 32,
  LB_HL = 33, LB_ID = 34, LB_JL = 35, LB_JT = 36, LB_JV = 37, LB_RI = 38, LB_SA = 39, LB_CM = 40,
  LB_ZWJ = 41,
};

// The feature streams, in the order of the wrapper's pointer array.
enum LbStream : int {
  LS_cls = 0, LS_lead = 1, LS_attached = 2, LS_eff = 3, LS_prev_raw = 4, LS_prev = 5,
  LS_before_sp = 6, LS_prev2 = 7, LS_ri_run_prev = 8, LS_nxt = 9, LS_lead_ord = 10, LS_count = 11,
};

struct LbStreams {
  const int32_t* s[LS_count];
};

__host__ __device__ constexpr uint64_t bit(int c) { return uint64_t{1} << c; }

template <typename... Cs>
__host__ __device__ constexpr uint64_t mask(Cs... cs) {
  return (bit(cs) | ...);
}

__device__ __forceinline__ bool in(int32_t c, uint64_t m) {
  return c >= 0 && c < 64 && ((m >> c) & 1);
}

__device__ __forceinline__ bool lb_break(const int32_t* f) {
  const int32_t cls = f[LS_cls], eff = f[LS_eff], prev_raw = f[LS_prev_raw], prev = f[LS_prev];
  const int32_t before_sp = f[LS_before_sp], prev2 = f[LS_prev2], nxt = f[LS_nxt];
  const bool is_lead = f[LS_lead] > 0, attached = f[LS_attached] > 0;
  const bool ri = eff == LB_RI;
  const uint64_t AH = mask(LB_AL, LB_HL);

  const bool mandatory_prev = in(prev_raw, mask(LB_BK, LB_CR, LB_LF, LB_NL)) && !(prev_raw == LB_CR && cls == LB_LF);
  bool nb = in(eff, mask(LB_BK, LB_CR, LB_LF, LB_NL));                   // LB6
  nb |= in(eff, mask(LB_SP, LB_ZW));                                     // LB7
  nb |= prev_raw == LB_ZWJ;                                              // LB8a
  nb |= attached;                                                        // LB9
  nb |= eff == LB_WJ || prev == LB_WJ;                                   // LB11
  nb |= prev == LB_GL;                                                   // LB12
  nb |= eff == LB_GL && !in(prev, mask(LB_SP, LB_BA, LB_HY));            // LB12a
  nb |= in(eff, mask(LB_CL, LB_CP, LB_EX, LB_IS, LB_SY));                // LB13
  nb |= before_sp == LB_OP;                                              // LB14
  nb |= in(before_sp, mask(LB_CL, LB_CP)) && eff == LB_NS;               // LB16
  nb |= before_sp == LB_B2 && eff == LB_B2;                              // LB17
  nb |= before_sp == LB_QU && eff == LB_OP;                              // LB15
  nb |= eff == LB_QU || prev == LB_QU;                                   // LB19
  nb |= in(eff, mask(LB_BA, LB_HY, LB_NS)) || prev == LB_BB;             // LB21
  nb |= prev2 == LB_HL && in(prev, mask(LB_HY, LB_BA));                  // LB21a
  nb |= prev == LB_SY && eff == LB_HL;                                   // LB21b
  nb |= eff == LB_IN;                                                    // LB22
  nb |= in(prev, AH) && eff == LB_NU;                                    // LB23
  nb |= prev == LB_NU && in(eff, AH);
  nb |= prev == LB_PR && in(eff, mask(LB_ID, LB_EB, LB_EM));             // LB23a
  nb |= in(prev, mask(LB_ID, LB_EB, LB_EM)) && eff == LB_PO;
  nb |= in(prev, mask(LB_PR, LB_PO)) && in(eff, AH);                     // LB24
  nb |= in(prev, AH) && in(eff, mask(LB_PR, LB_PO));
  nb |= in(prev, mask(LB_PR, LB_PO, LB_OP, LB_HY, LB_NU, LB_SY, LB_IS)) && eff == LB_NU;  // LB25
  nb |= prev == LB_NU && in(eff, mask(LB_NU, LB_SY, LB_IS, LB_CL, LB_CP, LB_PO, LB_PR));
  nb |= in(prev, mask(LB_CL, LB_CP)) && in(eff, mask(LB_PO, LB_PR));
  nb |= in(prev, mask(LB_PR, LB_PO)) && in(eff, mask(LB_OP, LB_HY)) && nxt == LB_NU;
  nb |= prev == LB_JL && in(eff, mask(LB_JL, LB_JV, LB_H2, LB_H3));      // LB26
  nb |= in(prev, mask(LB_JV, LB_H2)) && in(eff, mask(LB_JV, LB_JT));
  nb |= in(prev, mask(LB_JT, LB_H3)) && eff == LB_JT;
  nb |= in(prev, mask(LB_JL, LB_JV, LB_JT, LB_H2, LB_H3)) && eff == LB_PO;  // LB27
  nb |= prev == LB_PR && in(eff, mask(LB_JL, LB_JV, LB_JT, LB_H2, LB_H3));
  nb |= in(prev, AH) && in(eff, AH);                                     // LB28
  nb |= prev == LB_IS && in(eff, AH);                                    // LB29
  nb |= in(prev, mask(LB_AL, LB_HL, LB_NU)) && eff == LB_OP;             // LB30
  nb |= prev == LB_CP && in(eff, mask(LB_AL, LB_HL, LB_NU));
  nb |= prev == LB_RI && ri && (f[LS_ri_run_prev] & 1);                  // LB30a (x mod 2, as Python's %)
  nb |= prev == LB_EB && eff == LB_EM;                                   // LB30b
  const bool cb_break = (eff == LB_CB || prev == LB_CB) && !attached && prev_raw != LB_ZWJ;  // LB20
  nb &= !cb_break;

  bool brk = !nb;
  brk |= mandatory_prev;                                                 // LB4/5
  brk |= before_sp == LB_ZW || prev == LB_ZW;                            // LB8
  brk &= is_lead;
  brk &= !(is_lead && f[LS_lead_ord] == 1);                              // LB2
  return brk;
}

__global__ void __launch_bounds__(kThreads)
lb_rules_kernel(const __grid_constant__ LbStreams in_streams, int64_t n, int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    int32_t f[LS_count];
#pragma unroll
    for (int k = 0; k < LS_count; ++k) f[k] = __ldg(in_streams.s[k] + i);
    out[i] = lb_break(f) ? 1 : 0;
  }
}

}  // namespace swt

// streams: host array of 11 device pointers to int32[n], in LbStream order.
// out: int32[n].
extern "C" int sw_lb_rules(const int64_t* streams, int64_t n, void* out, void* stream) {
  using namespace swt;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  LbStreams s{};
  for (int k = 0; k < LS_count; ++k) {
    s.s[k] = reinterpret_cast<const int32_t*>(streams[k]);
    if (!s.s[k]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = resident_grid(lb_rules_kernel, 0, (n + kThreads - 1) / kThreads);
  lb_rules_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(s, n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
