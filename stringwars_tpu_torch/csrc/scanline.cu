// K9 · fused prefix scans: up to kMaxOps independent scans over one stream
// of n positions, forward or reversed, each of one of five carried kinds.
//
// Replaces stringwars_tpu/ops/scanline.py::_make_kernel (via _build_call <-
// fused_scan). The TPU kernel runs a whole op program in one pass: its grid
// runs in order on one core, so each (32, 1024) tile folds in the previous
// tile's carries from SMEM scratch. Hopper runs blocks in no order, so the
// carries cross tiles by reduce-then-scan, three launches per call:
//   A. each warp reduces its segment of kSegment positions to one carry
//      state per op;
//   B. one block scans the segment states in order into each segment's
//      exclusive carry (starting from the op's initial carry);
//   C. each warp rescans its segment from that carry and writes the outputs.
// Within a segment a warp takes 32 consecutive positions a step (coalesced
// loads, descending addresses when reversed) and scans them with shuffles.
// An op program's chained builds (an op reading an earlier op's output) run
// between calls as torch elementwise ops (ops/scanline.py), so each call
// takes ops whose inputs are already built.
//
// The kinds and their carry states (a, b, c), as in scanline.py:146-200:
//   sum   (a)          a + a'                    out a
//   max   (a)          max(a, a'), starts at init  out a
//   last  (a, c)       c' ? a' : a, c | c'         out c ? a : init
//   last2 (a, b, c)    the last and second-to-last flagged values, c <= 2
//                      out c >= 1 ? a : init, c >= 2 ? b : init
//   delay              out[j] = v[j - 1] (the previous position's INPUT),
//                      init at j = 0; no carry state
// A flag is "set" where it is > 0. Values and flags may be int32, uint8
// (bool) or int8 streams; outputs are int32.
//
// What bounds it on an H100: bytes. Per op, phases A and C each read the
// inputs once and C writes the outputs, so a call moves its inputs twice;
// the bound counts them once. The shuffle scan costs about 5 x 4 operations
// per position for last2 and less for the others, well under the byte time.
#include <climits>

#include "common.cuh"

namespace swt {

constexpr int kMaxOps = 8;
constexpr int kSteps = 64;                 // 32-position steps per warp segment
constexpr int64_t kSegment = 32 * kSteps;  // positions per warp segment
constexpr int kScanThreads = 1024;         // phase B

enum Kind : int { kSum = 0, kMax = 1, kLast = 2, kLast2 = 3, kDelay = 4 };
enum DType : int { kI32 = 0, kU8 = 1, kI8 = 2 };

struct ScanOp {
  const void* v;
  const void* f;
  int32_t* out0;
  int32_t* out1;
  int kind, init, vtype, ftype;
};

struct ScanProgram {
  ScanOp op[kMaxOps];
  int nops;
};

struct St {
  int32_t a, b, c;
};

__device__ __forceinline__ int32_t load(const void* p, int type, int64_t m) {
  if (type == kU8) return static_cast<const uint8_t*>(p)[m];
  if (type == kI8) return static_cast<const int8_t*>(p)[m];
  return static_cast<const int32_t*>(p)[m];
}

// An element that changes no carry (positions past n): a true identity for
// sum, max, last and last2.
__device__ __forceinline__ St neutral(int kind) {
  return St{kind == kSum ? 0 : INT_MIN, 0, 0};
}

__device__ __forceinline__ St initial(const ScanOp& op) {
  return St{op.kind == kSum ? 0 : op.init, op.init, 0};
}

template <int kKind>
__device__ __forceinline__ St element(const ScanOp& op, int64_t m) {
  const int32_t v = load(op.v, op.vtype, m);
  if constexpr (kKind == kLast || kKind == kLast2) return St{v, 0, load(op.f, op.ftype, m) > 0 ? 1 : 0};
  return St{v, 0, 0};
}

// x then y, in scan order.
template <int kKind>
__device__ __forceinline__ St combine(St x, St y) {
  if constexpr (kKind == kSum) {
    return St{static_cast<int32_t>(static_cast<uint32_t>(x.a) + static_cast<uint32_t>(y.a)), 0, 0};
  } else if constexpr (kKind == kMax) {
    return St{x.a > y.a ? x.a : y.a, 0, 0};
  } else if constexpr (kKind == kLast) {
    return St{y.c ? y.a : x.a, 0, x.c | y.c};
  } else {
    const int32_t last = y.c >= 1 ? y.a : x.a;
    const int32_t prev = y.c >= 2 ? y.b : (y.c == 1 ? x.a : x.b);
    const int32_t c = x.c + y.c;
    return St{last, prev, c < 2 ? c : 2};
  }
}

__device__ __forceinline__ St combine(int kind, St x, St y) {
  switch (kind) {
    case kSum: return combine<kSum>(x, y);
    case kMax: return combine<kMax>(x, y);
    case kLast: return combine<kLast>(x, y);
    default: return combine<kLast2>(x, y);
  }
}

// A shuffle of the state fields the kind uses.
template <int kKind, bool kUp>
__device__ __forceinline__ St shfl(St s, int k) {
  auto one = [k](int32_t v) { return kUp ? __shfl_up_sync(0xffffffffu, v, k) : __shfl_sync(0xffffffffu, v, k); };
  St out{one(s.a), 0, 0};
  if constexpr (kKind == kLast2) out.b = one(s.b);
  if constexpr (kKind == kLast || kKind == kLast2) out.c = one(s.c);
  return out;
}

template <int kKind>
__device__ __forceinline__ St warp_scan(St x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const St y = shfl<kKind, true>(x, off);
    if (lane >= off) x = combine<kKind>(y, x);
  }
  return x;
}

__device__ __forceinline__ int64_t memory_index(int64_t j, int64_t n, int reverse) {
  return reverse ? n - 1 - j : j;
}

// Walks one warp's segment of one op from `carry`; writes outputs when kWrite.
template <int kKind, bool kWrite>
__device__ __forceinline__ St segment_scan(const ScanOp& op, int64_t seg, int64_t n, int reverse, St carry, int lane) {
  const int64_t base = seg * kSegment;
  for (int k = 0; k < kSteps; ++k) {
    const int64_t j = base + k * 32 + lane;
    if (base + k * 32 >= n) break;  // warp-uniform
    const int64_t m = memory_index(j, n, reverse);
    St x = j < n ? element<kKind>(op, m) : neutral(kKind);
    x = combine<kKind>(carry, warp_scan<kKind>(x, lane));
    if (kWrite && j < n) {
      if constexpr (kKind == kLast) {
        op.out0[m] = x.c ? x.a : op.init;
      } else if constexpr (kKind == kLast2) {
        op.out0[m] = x.c >= 1 ? x.a : op.init;
        op.out1[m] = x.c >= 2 ? x.b : op.init;
      } else {
        op.out0[m] = x.a;
      }
    }
    carry = shfl<kKind, false>(x, 31);
  }
  return carry;
}

template <bool kWrite>
__device__ __forceinline__ St segment_scan(const ScanOp& op, int64_t seg, int64_t n, int reverse, St carry, int lane) {
  switch (op.kind) {
    case kSum: return segment_scan<kSum, kWrite>(op, seg, n, reverse, carry, lane);
    case kMax: return segment_scan<kMax, kWrite>(op, seg, n, reverse, carry, lane);
    case kLast: return segment_scan<kLast, kWrite>(op, seg, n, reverse, carry, lane);
    default: return segment_scan<kLast2, kWrite>(op, seg, n, reverse, carry, lane);
  }
}

// Phase A: agg[(op * segs + seg) * 3 + {0,1,2}] = the segment's reduction.
__global__ void __launch_bounds__(kThreads)
scan_reduce(const __grid_constant__ ScanProgram prog, int64_t n, int reverse, int64_t segs, int32_t* __restrict__ agg) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (seg >= segs) return;
  for (int o = 0; o < prog.nops; ++o) {
    const ScanOp& op = prog.op[o];
    if (op.kind == kDelay) continue;
    const St s = segment_scan<false>(op, seg, n, reverse, neutral(op.kind), lane);
    if (lane == 0) {
      int32_t* dst = agg + (o * segs + seg) * 3;
      dst[0] = s.a;
      dst[1] = s.b;
      dst[2] = s.c;
    }
  }
}

// Phase B: the segment reductions become exclusive carries, in place.
__global__ void __launch_bounds__(kScanThreads)
scan_carries(const __grid_constant__ ScanProgram prog, int64_t segs, int32_t* __restrict__ agg) {
  __shared__ St part[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (segs + kScanThreads - 1) / kScanThreads;
  const int64_t lo = t * per, hi = lo + per < segs ? lo + per : segs;
  for (int o = 0; o < prog.nops; ++o) {
    const ScanOp& op = prog.op[o];
    if (op.kind == kDelay) continue;
    int32_t* row = agg + o * segs * 3;
    St local = neutral(op.kind);
    for (int64_t s = lo; s < hi; ++s) local = combine(op.kind, local, St{row[3 * s], row[3 * s + 1], row[3 * s + 2]});
    part[t] = local;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive Hillis-Steele over the threads
      const St left = t >= off ? part[t - off] : neutral(op.kind);
      __syncthreads();
      if (t >= off) part[t] = combine(op.kind, left, part[t]);
      __syncthreads();
    }
    St carry = t ? combine(op.kind, initial(op), part[t - 1]) : initial(op);
    for (int64_t s = lo; s < hi; ++s) {
      const St here{row[3 * s], row[3 * s + 1], row[3 * s + 2]};
      row[3 * s] = carry.a;
      row[3 * s + 1] = carry.b;
      row[3 * s + 2] = carry.c;
      carry = combine(op.kind, carry, here);
    }
    __syncthreads();
  }
}

// Phase C: every op's outputs, each segment from its exclusive carry.
__global__ void __launch_bounds__(kThreads)
scan_apply(const __grid_constant__ ScanProgram prog, int64_t n, int reverse, int64_t segs, const int32_t* __restrict__ agg) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (seg >= segs) return;
  for (int o = 0; o < prog.nops; ++o) {
    const ScanOp& op = prog.op[o];
    if (op.kind == kDelay) {
      const int64_t base = seg * kSegment;
      for (int64_t j = base + lane; j < base + kSegment && j < n; j += 32) {
        op.out0[memory_index(j, n, reverse)] = j ? load(op.v, op.vtype, memory_index(j - 1, n, reverse)) : op.init;
      }
      continue;
    }
    const int32_t* c = agg + (o * segs + seg) * 3;
    segment_scan<true>(op, seg, n, reverse, St{c[0], c[1], c[2]}, lane);
  }
}

}  // namespace swt

// desc: host array of 8 int64 per op: kind, init, value type, flag type,
// value, flag, out0, out1 (device pointers; flag and out1 may be null where
// the kind takes none). scratch: int32[3 * nops * ceil(n / 2048)].
extern "C" int sw_fused_scan(const int64_t* desc, int64_t nops, int64_t n, int64_t reverse, void* scratch,
                             int64_t scratch_ints, void* stream) {
  using namespace swt;
  const int64_t segs = (n + kSegment - 1) / kSegment;
  if (n <= 0 || nops <= 0 || nops > kMaxOps || scratch_ints < 3 * nops * segs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanProgram prog{};
  prog.nops = static_cast<int>(nops);
  for (int64_t o = 0; o < nops; ++o) {
    const int64_t* d = desc + 8 * o;
    ScanOp& op = prog.op[o];
    op.kind = static_cast<int>(d[0]);
    op.init = static_cast<int>(d[1]);
    op.vtype = static_cast<int>(d[2]);
    op.ftype = static_cast<int>(d[3]);
    op.v = reinterpret_cast<const void*>(d[4]);
    op.f = reinterpret_cast<const void*>(d[5]);
    op.out0 = reinterpret_cast<int32_t*>(d[6]);
    op.out1 = reinterpret_cast<int32_t*>(d[7]);
    const bool flagged = op.kind == kLast || op.kind == kLast2;
    if (op.kind < kSum || op.kind > kDelay || op.vtype < kI32 || op.vtype > kI8 || op.ftype < kI32 ||
        op.ftype > kI8 || !op.v || !op.out0 || (flagged && !op.f) || (op.kind == kLast2 && !op.out1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto* agg = static_cast<int32_t*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (segs + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  scan_reduce<<<static_cast<int>(blocks), kThreads, 0, s>>>(prog, n, static_cast<int>(reverse), segs, agg);
  scan_carries<<<1, kScanThreads, 0, s>>>(prog, segs, agg);
  scan_apply<<<static_cast<int>(blocks), kThreads, 0, s>>>(prog, n, static_cast<int>(reverse), segs, agg);
  return static_cast<int>(cudaGetLastError());
}
