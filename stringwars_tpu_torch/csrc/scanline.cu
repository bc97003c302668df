// K9 · fused scan programs: one launch runs a whole program of builds and
// chained prefix scans over a stream of n positions, forward or reversed.
//
// Replaces stringwars_tpu/ops/scanline.py::_make_kernel (via _build_call <-
// fused_scan). The TPU kernel evaluates every op's build and every scan of
// a program in one pass over a grid that runs in order on one core, carrying
// each op's state from tile to tile in SMEM. Hopper runs blocks in no order,
// so this kernel is a chained scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016):
//
// - Each block takes a tile of 256 x items positions (items = 4, 8, 16 or
//   32 a thread: the most whose slots leave room for 2 blocks an SM, else
//   1; the registers allow 4) from an atomic tile counter, in scan order
//   (from the end of the stream when reversed), so a tile only ever waits
//   for tiles that are already running.
// - It runs the program (ops/scanline_ir.py lowers each op's build to the
//   steps it interprets): a load step brings an input stream's tile on chip
//   with 16-byte loads; an elementwise step evaluates one operation of a
//   build over the tile; a scan step scans up to 8 ops whose builds are
//   ready. The tile streams live in shared-memory slots (one int32 a
//   position, a word of padding every 32; a byte a position for bool,
//   uint8 and int8 streams). An op's outputs go to a slot where a later
//   build reads them or the call returns them (its first output over its
//   value's slot where nothing else reads that value), and a returned
//   output leaves its slot for device memory in 16-byte stores of
//   consecutive threads (a thread's own run of positions, stored from
//   registers, would scatter a warp's stores over 32 lines).
// - A scan step: each thread reduces its run of consecutive positions, a
//   warp scan and a scan of the 8 warp totals give the tile's aggregate;
//   warp o publishes op o's aggregate, looks back over the tiles before for
//   the op's exclusive carry (128 predecessors a round, 4 a lane, stopping
//   at the nearest inclusive prefix) and publishes the tile's inclusive
//   prefix; then every thread rescans its run from its carry and writes the
//   outputs. The ops of a step find their carries at once, one warp each.
//   The look-back bounds a program's time where its tiles are many (the
//   inclusive prefixes advance one window a round trip), hence the wide
//   window and the large tiles.
// - A status entry per (op, tile) holds the aggregate and the inclusive
//   prefix, flagged with the call's epoch, so the scratch is never cleared
//   between calls. Every kind keeps its flag in the same word, with the
//   same encoding: sum, max, last and delay pack their state beside it in
//   one 64-bit word; last2 writes its payload elsewhere in the entry, then
//   the flag word with release semantics, and a reader fences after it.
//
// The kinds and their carry states (a, b, c), as in scanline.py:146-200:
//   sum   (a)          a + a'                    out a
//   max   (a)          max(a, a'), starts at init  out a
//   last  (a, c)       c' ? a' : a, c | c'         out c ? a : init
//   last2 (a, b, c)    the last and second-to-last flagged values, c <= 2
//                      out c >= 1 ? a : init, c >= 2 ? b : init
//   delay              out[j] = v[j - 1] (the previous position's build),
//                      init at j = 0: its carry is the build's value at the
//                      previous tile's last position, which that tile
//                      publishes as its inclusive prefix at once (a delay of
//                      an input reads it from the input instead).
// A flag is "set" where it is > 0.
//
// What bounds it on an H100: bytes, each input read once and each returned
// output written once. The per-op work is a few shared-memory passes over
// the tile and a look-back round trip to L2, which the resident blocks (4
// an SM, 64 registers a thread) hide in part.
#include <cuda/atomic>

#include <climits>

#include "common.cuh"

namespace swt {

constexpr int kScanThreads = 256;
constexpr int kWarps = kScanThreads / 32;
constexpr int kRun = 4;                          // positions a thread writes at once
constexpr int kStepWords = 12;                   // STEP_WORDS
constexpr int kMaxStageOps = kWarps;             // MAX_STAGE_OPS
constexpr int kMaxInputs = 16;                   // MAX_INPUTS
constexpr int kMaxOutputs = 32;                  // MAX_OUTPUTS
constexpr int kEntryWords = 8;                   // state, flag, aggregate a b c, prefix a b c

enum Kind : int { kSum = 0, kMax = 1, kLast = 2, kLast2 = 3, kDelay = 4 };
enum StepType : int { kLoad = 0, kEw = 1, kScanStep = 2 };
enum Code : int { kEq, kNe, kLt, kLe, kGt, kGe, kAnd, kOr, kNot, kAdd, kSub, kMul, kWhere, kCast };
enum DType : int { kBool = 0, kU8 = 1, kI8 = 2, kI16 = 3, kI32 = 4 };
enum LoadType : int { kLoadI32 = 0, kLoadU8 = 1, kLoadI8 = 2 };
enum Flag : int { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

struct Streams {
  const void* in[kMaxInputs];
  int32_t* out[kMaxOutputs];
  int in_type[kMaxInputs];
};

struct St {
  int32_t a, b, c;
};

// A scan op of the staged program (a row of STEP_WORDS words): kind, init,
// value (slot or constant), flag (slot or constant), output slots, output
// pointers (-1: none), status entry index, and for a delay of an input
// stream that input (-1: none).
struct Row {
  int kind, init, vs, vi, fs, fi, s0, s1, g0, g1, entry, input;
};

__device__ __forceinline__ Row load_row(const int32_t* r) {
  return Row{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10], r[11]};
}


// A block's tile: `items` consecutive positions a thread (4, 8, 16 or 32; the
// wrapper takes the most whose slots fit), `size` = 256 * items positions,
// each slot `words` int32 (a word of padding every 32), from `start`; `len`
// of them lie before n.
// A slot operand is s >= 0 for word slot s (int32 values), -1 for the
// constant beside it, -2 - (2 b + signed) for byte slot b (bool, uint8 or,
// signed, int8 values: a tile of bytes after the word slots).
struct Tile {
  int items, size, words, len;
  int64_t start;
  uint8_t* bytes;
};

__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

__device__ __forceinline__ int32_t fetch(const int32_t* slots, const Tile& tile, int slot, int imm, int p) {
  if (slot >= 0) return slots[slot * tile.words + padded(p)];
  if (slot == -1) return imm;
  const int code = -2 - slot;
  const uint8_t b = tile.bytes[(code >> 1) * tile.size + p];
  return (code & 1) ? static_cast<int32_t>(static_cast<int8_t>(b)) : static_cast<int32_t>(b);
}

__device__ __forceinline__ void store(int32_t* slots, const Tile& tile, int slot, int p, int32_t v) {
  if (slot >= 0) {
    slots[slot * tile.words + padded(p)] = v;
  } else {
    tile.bytes[((-2 - slot) >> 1) * tile.size + p] = static_cast<uint8_t>(v);
  }
}

__device__ __forceinline__ int32_t cast(int32_t x, int dtype) {
  switch (dtype) {
    case kBool: return x != 0;
    case kU8: return x & 0xFF;
    case kI8: return static_cast<int8_t>(x);
    case kI16: return static_cast<int16_t>(x);
    default: return x;
  }
}

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}

__device__ __forceinline__ int32_t evaluate(int code, int dtype, int32_t a, int32_t b, int32_t c) {
  switch (code) {
    case kEq: return a == b;
    case kNe: return a != b;
    case kLt: return a < b;
    case kLe: return a <= b;
    case kGt: return a > b;
    case kGe: return a >= b;
    case kAnd: return cast(a & b, dtype);
    case kOr: return cast(a | b, dtype);
    case kNot: return dtype == kBool ? (a ^ 1) : cast(~a, dtype);
    case kAdd: return cast(wrap_add(a, b), dtype);
    case kSub: return cast(static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b)), dtype);
    case kMul: return cast(static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b)), dtype);
    case kWhere: return a ? b : c;
    default: return cast(a, dtype);
  }
}

// ---------------------------------------------------------------------------
// The carried kinds
// ---------------------------------------------------------------------------

// An element that changes no carry (positions past n).
template <int K>
__device__ __forceinline__ St neutral() {
  return St{K == kSum ? 0 : INT_MIN, 0, 0};
}

template <int K>
__device__ __forceinline__ St initial(int init) {
  return St{K == kSum ? 0 : init, init, 0};
}

template <int K>
__device__ __forceinline__ St element(int32_t v, int32_t f) {
  return St{v, 0, (K == kLast || K == kLast2) && f > 0 ? 1 : 0};
}

// x then y, in scan order.
template <int K>
__device__ __forceinline__ St combine(St x, St y) {
  if constexpr (K == kSum) {
    return St{wrap_add(x.a, y.a), 0, 0};
  } else if constexpr (K == kMax) {
    return St{x.a > y.a ? x.a : y.a, 0, 0};
  } else if constexpr (K == kLast) {
    return St{y.c ? y.a : x.a, 0, x.c | y.c};
  } else {
    const int32_t last = y.c >= 1 ? y.a : x.a;
    const int32_t prev = y.c >= 2 ? y.b : (y.c == 1 ? x.a : x.b);
    const int32_t c = x.c + y.c;
    return St{last, prev, c < 2 ? c : 2};
  }
}

template <int K>
__device__ __forceinline__ void outputs(St x, int init, int32_t& o0, int32_t& o1) {
  if constexpr (K == kLast) {
    o0 = x.c ? x.a : init;
  } else if constexpr (K == kLast2) {
    o0 = x.c >= 1 ? x.a : init;
    o1 = x.c >= 2 ? x.b : init;
  } else {
    o0 = x.a;
  }
}

// 0: shuffle up, 1: shuffle down, 2: read lane k.
template <int K, int kMode>
__device__ __forceinline__ St shfl(St s, int k) {
  auto one = [k](int32_t v) {
    if (kMode == 0) return __shfl_up_sync(0xffffffffu, v, k);
    if (kMode == 1) return __shfl_down_sync(0xffffffffu, v, k);
    return __shfl_sync(0xffffffffu, v, k);
  };
  St out{one(s.a), 0, 0};
  if constexpr (K == kLast2) out.b = one(s.b);
  if constexpr (K == kLast || K == kLast2) out.c = one(s.c);
  return out;
}

// ---------------------------------------------------------------------------
// Status entries
// ---------------------------------------------------------------------------

// An entry per (op, tile), 8 words. Word 1 is the flag word of every
// kind, epoch << 3 | c << 2 | flag. sum, max, last and delay keep their
// state beside it, a in word 0 (and last's c in the flag word): words 0-1
// are stored and read as one 64-bit word. last2 writes its aggregate
// (words 2-4) or prefix (words 5-7) first, then the flag word (c 0) with
// release semantics; a reader polls the flag word, then fences, then reads
// the payload the flag names. No kind writes anything else into word 1, so
// an entry that an op of another kind flagged in an earlier call never
// reads as this call's. (An entry is only ever touched by one op in a
// call, so the two widths of access never meet within a launch.)
using Ref = cuda::atomic_ref<int32_t, cuda::thread_scope_device>;
using Ref64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ Ref64 word_of(int32_t* entry) { return Ref64(*reinterpret_cast<unsigned long long*>(entry)); }

__device__ __forceinline__ unsigned flag_word(int32_t c, int flag, int epoch) {
  return (static_cast<unsigned>(epoch) << 3) | (static_cast<unsigned>(c) << 2) | flag;
}

template <int K>
__device__ __forceinline__ void publish(int32_t* entry, St s, int flag, int epoch) {
  if constexpr (K == kLast2) {
    int32_t* payload = entry + (flag == kPrefix ? 5 : 2);
    Ref(payload[0]).store(s.a, cuda::memory_order_relaxed);
    Ref(payload[1]).store(s.b, cuda::memory_order_relaxed);
    Ref(payload[2]).store(s.c, cuda::memory_order_relaxed);
    Ref(entry[1]).store(static_cast<int32_t>(flag_word(0, flag, epoch)), cuda::memory_order_release);
  } else {
    const auto high = static_cast<unsigned long long>(flag_word(s.c, flag, epoch));
    word_of(entry).store((high << 32) | static_cast<uint32_t>(s.a), cuda::memory_order_relaxed);
  }
}

// The flag of an entry's word once it carries this call's epoch, else 0.
__device__ __forceinline__ int flag_of(unsigned long long word, int epoch) {
  const auto high = static_cast<unsigned>(word >> 32);
  return static_cast<int>(high >> 3) == epoch ? static_cast<int>(high & 3) : kInvalid;
}

// Words 0-1 of an entry; for last2 the flag word alone, in the high half.
template <int K>
__device__ __forceinline__ unsigned long long poll(int32_t* entry) {
  if constexpr (K == kLast2) {
    return static_cast<unsigned long long>(static_cast<uint32_t>(Ref(entry[1]).load(cuda::memory_order_relaxed))) << 32;
  } else {
    return word_of(entry).load(cuda::memory_order_relaxed);
  }
}

// Predecessor entries a lane reads a round.
constexpr int kPerLane = 4;
constexpr int kWindow = 32 * kPerLane;

// Entries of tiles `first`, first - 1, ... (`count` of them, those >= 0)
// once flagged in this epoch; their states and flags.
template <int K>
__device__ __forceinline__ void await_entries(int32_t* entries, int64_t first, int count, int epoch,
                                              St (&e)[kPerLane], int (&flags)[kPerLane]) {
  unsigned long long words[kPerLane];
  int pending = 0;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    flags[q] = kPrefix;  // entries before tile 0 end the walk
    e[q] = neutral<K>();
    if (q < count && first - q >= 0) {
      words[q] = poll<K>(entries + (first - q) * kEntryWords);
      flags[q] = flag_of(words[q], epoch);
      pending |= (flags[q] == kInvalid) << q;
    }
  }
  // A wait of some seconds can only be a fault: trap rather than hang.
  for (uint32_t polls = 0; pending; ++polls) {
    if (polls == (1u << 30)) __trap();
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (pending & (1 << q)) {
        words[q] = poll<K>(entries + (first - q) * kEntryWords);
        flags[q] = flag_of(words[q], epoch);
        if (flags[q] != kInvalid) pending &= ~(1 << q);
      }
    }
  }
  if constexpr (K == kLast2) {
    cuda::atomic_thread_fence(cuda::memory_order_acquire, cuda::thread_scope_device);
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (q < count && first - q >= 0) {
        int32_t* payload = entries + (first - q) * kEntryWords + (flags[q] == kPrefix ? 5 : 2);
        e[q] = St{Ref(payload[0]).load(cuda::memory_order_relaxed), Ref(payload[1]).load(cuda::memory_order_relaxed),
                  Ref(payload[2]).load(cuda::memory_order_relaxed)};
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (q < count && first - q >= 0) {
        const auto high = static_cast<unsigned>(words[q] >> 32);
        e[q] = St{static_cast<int32_t>(static_cast<uint32_t>(words[q])), 0, static_cast<int32_t>((high >> 2) & 1)};
      }
    }
  }
}

// The exclusive carry of tile t (> 0) from the entries of the tiles before
// it: kWindow predecessors a round (lane l reads tiles j - kPerLane l - q,
// q < kPerLane), combined in scan order up to the nearest inclusive prefix.
// Every lane returns it.
template <int K>
__device__ St look_back(int32_t* entries, int64_t t, int epoch, int lane) {
  St acc = neutral<K>();
  for (int64_t j = t - 1;; j -= kWindow) {
    St e[kPerLane];
    int flags[kPerLane];
    await_entries<K>(entries, j - kPerLane * lane, kPerLane, epoch, e, flags);
    // This lane's part: its entries from the nearest prefix among them (or
    // all of them) on, earliest first.
    St s = neutral<K>();
    bool mine = false;
#pragma unroll
    for (int q = kPerLane - 1; q >= 0; --q) {
      if (flags[q] == kPrefix) {
        s = e[q];
        mine = true;
      } else {
        s = combine<K>(s, e[q]);
      }
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, mine);
    if (prefixes && lane > __ffs(prefixes) - 1) s = neutral<K>();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // lane 0: s[31] then ... then s[0]
      const St y = shfl<K, 1>(s, off);
      if (lane + off < 32) s = combine<K>(y, s);
    }
    acc = combine<K>(shfl<K, 2>(s, 0), acc);
    if (prefixes) return acc;
  }
}

// ---------------------------------------------------------------------------
// Steps
// ---------------------------------------------------------------------------

// An input stream's tile into a slot: 16-byte loads where the tile is whole
// and aligned, else one position a thread; positions past n read 0. A byte
// stream (bool, uint8, int8) goes to a byte slot as it is.
__device__ __forceinline__ void load_step(int32_t* slots, int slot, const void* src, int type, const Tile& tile) {
  const int t = threadIdx.x;
  const int size = type == kLoadI32 ? 4 : 1;
  const char* base = static_cast<const char*>(src) + tile.start * size;
  const bool whole = tile.len == tile.size && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  if (slot < 0) {  // a byte slot: bytes in, bytes out
    uint8_t* dst = tile.bytes + ((-2 - slot) >> 1) * tile.size;
    if (whole) {
      for (int c = t; c < tile.size / 16; c += kScanThreads) {
        reinterpret_cast<uint4*>(dst)[c] = __ldcs(reinterpret_cast<const uint4*>(base) + c);
      }
    } else {
      for (int p = t; p < tile.size; p += kScanThreads) dst[p] = p < tile.len ? base[p] : 0;
    }
    return;
  }
  int32_t* dst = slots + slot * tile.words;
  if (whole) {
    // A thread's loads go out four at a time before their stores.
    constexpr int kBatch = 4;
    const int vectors = tile.size * size / 16;
    for (int c0 = t; c0 < vectors; c0 += kBatch * kScanThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = c0 + i * kScanThreads;
        if (c < vectors) v[i] = __ldcs(reinterpret_cast<const uint4*>(base) + c);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = c0 + i * kScanThreads;
        if (c >= vectors) break;
        const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        if (type == kLoadI32) {
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[padded(4 * c + k)] = static_cast<int32_t>(words[k]);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const uint32_t byte = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
            dst[padded(16 * c + k)] = type == kLoadU8 ? static_cast<int32_t>(byte) : static_cast<int8_t>(byte);
          }
        }
      }
    }
    return;
  }
  for (int p = t; p < tile.size; p += kScanThreads) {
    int32_t v = 0;
    if (p < tile.len) {
      if (type == kLoadI32) v = reinterpret_cast<const int32_t*>(base)[p];
      else if (type == kLoadU8) v = reinterpret_cast<const uint8_t*>(base)[p];
      else v = reinterpret_cast<const int8_t*>(base)[p];
    }
    dst[padded(p)] = v;
  }
}

__device__ __forceinline__ void ew_step(const int32_t* st, int32_t* slots, const Tile& tile) {
  const int code = st[1], dtype = st[2], dst = st[3];
  const int as = st[4], ai = st[5], bs = st[6], bi = st[7], cs = st[8], ci = st[9];
  for (int p = threadIdx.x; p < tile.size; p += kScanThreads) {
    store(slots, tile, dst, p,
          evaluate(code, dtype, fetch(slots, tile, as, ai, p), fetch(slots, tile, bs, bi, p), fetch(slots, tile, cs, ci, p)));
  }
}

// The scan order of a thread's positions: thread i owns the i-th run of
// `items` positions in scan order; item(k) is its k-th position in scan
// order, at(k) its k-th in memory order.
template <bool kReverse>
__device__ __forceinline__ int run_of(const Tile& tile) {
  return (kReverse ? kScanThreads - 1 - static_cast<int>(threadIdx.x) : static_cast<int>(threadIdx.x)) * tile.items;
}

template <bool kReverse>
__device__ __forceinline__ int item(const Tile& tile, int first, int k) {
  return first + (kReverse ? tile.items - 1 - k : k);
}

// A thread's reduction and its exclusive prefix within its warp (tpre), and
// each warp's total (wtot).
template <int K, bool kReverse>
__device__ void reduce_op(const Row& row, const int32_t* slots, const Tile& tile, St* tpre, St* wtot) {
  const int t = threadIdx.x, lane = t & 31, first = run_of<kReverse>(tile);
  St x = neutral<K>();
  for (int k0 = 0; k0 < tile.items; k0 += kRun) {
#pragma unroll
    for (int k = k0; k < k0 + kRun; ++k) {
      const int p = item<kReverse>(tile, first, k);
      if (p < tile.len) {
        x = combine<K>(x, element<K>(fetch(slots, tile, row.vs, row.vi, p), fetch(slots, tile, row.fs, row.fi, p)));
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const St y = shfl<K, 0>(x, off);
    if (lane >= off) x = combine<K>(y, x);
  }
  if (lane == 31) wtot[t >> 5] = x;
  const St ex = shfl<K, 0>(x, 1);
  tpre[t] = lane ? ex : neutral<K>();
}

// Warp work of a scan op: the warp offsets, the tile aggregate, its
// publication and the look-back. Returns the tile's exclusive carry.
template <int K>
__device__ St carry_op(int init, const St* wtot, St* wex, int32_t* entries, int64_t t, int epoch, int lane) {
  St x = lane < kWarps ? wtot[lane] : neutral<K>();
#pragma unroll
  for (int off = 1; off < kWarps; off <<= 1) {
    const St y = shfl<K, 0>(x, off);
    if (lane >= off) x = combine<K>(y, x);
  }
  const St ex = shfl<K, 0>(x, 1);
  if (lane < kWarps) wex[lane] = lane ? ex : neutral<K>();
  const St agg = shfl<K, 2>(x, kWarps - 1);
  if (t == 0) {
    if (lane == 0) publish<K>(entries, combine<K>(initial<K>(init), agg), kPrefix, epoch);
    return initial<K>(init);
  }
  if (lane == 0) publish<K>(entries + t * kEntryWords, agg, kAggregate, epoch);
  const St carry = look_back<K>(entries, t, epoch, lane);
  if (lane == 0) publish<K>(entries + t * kEntryWords, combine<K>(carry, agg), kPrefix, epoch);
  return carry;
}

// A delay op's carry: the previous tile's build at its last position; for
// a delay of an input stream, that position of the input, read from device
// memory (no tile waits for another).
template <bool kReverse>
__device__ St carry_delay(const Row& row, const int32_t* slots, const Tile& tile, const Streams& io,
                          int32_t* entries, int64_t t, int epoch, int lane) {
  St carry{row.init, 0, 0};
  if (row.input >= 0) {
    if (lane == 0 && t > 0) {
      const int64_t at = kReverse ? tile.start + tile.size : tile.start - 1;
      const void* src = io.in[row.input];
      const int type = io.in_type[row.input];
      carry.a = type == kLoadI32 ? static_cast<const int32_t*>(src)[at]
                : type == kLoadU8 ? static_cast<int32_t>(static_cast<const uint8_t*>(src)[at])
                                  : static_cast<int32_t>(static_cast<const int8_t*>(src)[at]);
    }
    return carry;
  }
  const St last{fetch(slots, tile, row.vs, row.vi, kReverse ? 0 : tile.size - 1), 0, 0};
  if (lane == 0) {
    publish<kDelay>(entries + t * kEntryWords, last, kPrefix, epoch);
    if (t > 0) {
      St e[kPerLane];
      int flags[kPerLane];
      await_entries<kDelay>(entries, t - 1, 1, epoch, e, flags);
      carry = e[0];
    }
  }
  return carry;
}

// A delay op's build one position before the thread's run in scan order,
// read before any thread writes the step's outputs (a delay writes over
// its value slot): c = 0 where that position is the previous tile's (or
// past n, reversed) and the carry stands in.
template <bool kReverse>
__device__ __forceinline__ void delay_before(const Row& row, const int32_t* slots, const Tile& tile, St* tpre) {
  const int head = item<kReverse>(tile, run_of<kReverse>(tile), 0);
  const int before = kReverse ? head + 1 : head - 1;
  const bool inside = kReverse ? before < tile.len : before >= 0;
  tpre[threadIdx.x] = St{inside ? fetch(slots, tile, row.vs, row.vi, before) : 0, 0, inside};
}

// kRun outputs from tile position `first` on, into their slot (which may be
// the op's value slot: the thread has read these positions).
__device__ __forceinline__ void write_run(int32_t* slot, int first, const int32_t (&v)[kRun]) {
  if (!slot) return;
#pragma unroll
  for (int k = 0; k < kRun; ++k) slot[padded(first + k)] = v[k];
}

// A returned output from its slot to device memory: 16-byte stores of
// consecutive threads where the tile is whole and aligned.
__device__ __forceinline__ void copy_out(const int32_t* slot, int32_t* global, const Tile& tile) {
  int32_t* at = global + tile.start;
  if (tile.len == tile.size && (reinterpret_cast<uintptr_t>(at) & 15) == 0) {
    for (int c = threadIdx.x; c < tile.size / 4; c += kScanThreads) {
      reinterpret_cast<int4*>(at)[c] =
          make_int4(slot[padded(4 * c)], slot[padded(4 * c + 1)], slot[padded(4 * c + 2)], slot[padded(4 * c + 3)]);
    }
    return;
  }
  for (int p = threadIdx.x; p < tile.len; p += kScanThreads) at[p] = slot[padded(p)];
}

// A thread rescans its positions from its carry and writes the op's
// outputs, kRun positions at a time in scan order.
template <int K, bool kReverse>
__device__ void apply_op(const Row& row, int32_t* slots, const Tile& tile, const Streams& io, St carry) {
  const int first = run_of<kReverse>(tile);
  int32_t* slot0 = row.s0 >= 0 ? slots + row.s0 * tile.words : nullptr;
  int32_t* slot1 = row.s1 >= 0 ? slots + row.s1 * tile.words : nullptr;
  for (int k0 = 0; k0 < tile.items; k0 += kRun) {
    int32_t o0[kRun], o1[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = item<kReverse>(tile, first, k0 + k);
      if (p < tile.len) {
        carry = combine<K>(carry, element<K>(fetch(slots, tile, row.vs, row.vi, p), fetch(slots, tile, row.fs, row.fi, p)));
      }
      outputs<K>(carry, row.init, o0[kReverse ? kRun - 1 - k : k], o1[kReverse ? kRun - 1 - k : k]);
    }
    const int run = kReverse ? first + tile.items - k0 - kRun : first + k0;
    write_run(slot0, run, o0);
    if constexpr (K == kLast2) write_run(slot1, run, o1);
  }
}

template <bool kReverse>
__device__ void apply_delay(const Row& row, int32_t* slots, const Tile& tile, St before, int32_t carry) {
  const int first = run_of<kReverse>(tile);
  int32_t prev = before.c ? before.a : carry;
  int32_t* slot0 = row.s0 >= 0 ? slots + row.s0 * tile.words : nullptr;
  for (int k0 = 0; k0 < tile.items; k0 += kRun) {
    int32_t o0[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int p = item<kReverse>(tile, first, k0 + k);
      o0[kReverse ? kRun - 1 - k : k] = prev;
      if (p < tile.len) prev = fetch(slots, tile, row.vs, row.vi, p);
    }
    write_run(slot0, kReverse ? first + tile.items - k0 - kRun : first + k0, o0);
  }
}

struct StepShared {
  St wtot[kMaxStageOps][kWarps];
  St wex[kMaxStageOps][kWarps];
  St carry[kMaxStageOps];
};

template <int K, bool kReverse>
__device__ __forceinline__ void apply_scan(const Row& row, int32_t* slots, const Tile& tile, const Streams& io,
                                           const StepShared& sh, const St* tpre, int o) {
  const int me = threadIdx.x;
  apply_op<K, kReverse>(row, slots, tile, io, combine<K>(combine<K>(sh.carry[o], sh.wex[o][me >> 5]), tpre[me]));
}

template <bool kReverse>
__device__ void scan_step(const int32_t* rows, int count, int32_t* slots, St* tpre, StepShared& sh, const Streams& io,
                          int32_t* status, int64_t t, int64_t tiles, const Tile& tile, int epoch) {
  __syncthreads();  // the step's builds are in their slots
  for (int o = 0; o < count; ++o) {
    const Row row = load_row(rows + o * kStepWords);
    St* mine = tpre + o * kScanThreads;
    switch (row.kind) {
      case kSum: reduce_op<kSum, kReverse>(row, slots, tile, mine, sh.wtot[o]); break;
      case kMax: reduce_op<kMax, kReverse>(row, slots, tile, mine, sh.wtot[o]); break;
      case kLast: reduce_op<kLast, kReverse>(row, slots, tile, mine, sh.wtot[o]); break;
      case kLast2: reduce_op<kLast2, kReverse>(row, slots, tile, mine, sh.wtot[o]); break;
      default: delay_before<kReverse>(row, slots, tile, mine); break;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < count) {
    const Row row = load_row(rows + warp * kStepWords);
    int32_t* entries = status + static_cast<int64_t>(row.entry) * tiles * kEntryWords;
    St carry;
    switch (row.kind) {
      case kSum: carry = carry_op<kSum>(row.init, sh.wtot[warp], sh.wex[warp], entries, t, epoch, lane); break;
      case kMax: carry = carry_op<kMax>(row.init, sh.wtot[warp], sh.wex[warp], entries, t, epoch, lane); break;
      case kLast: carry = carry_op<kLast>(row.init, sh.wtot[warp], sh.wex[warp], entries, t, epoch, lane); break;
      case kLast2: carry = carry_op<kLast2>(row.init, sh.wtot[warp], sh.wex[warp], entries, t, epoch, lane); break;
      default: carry = carry_delay<kReverse>(row, slots, tile, io, entries, t, epoch, lane); break;
    }
    if (lane == 0) sh.carry[warp] = carry;
  }
  __syncthreads();
  for (int o = 0; o < count; ++o) {
    const Row row = load_row(rows + o * kStepWords);
    const St* mine = tpre + o * kScanThreads;
    switch (row.kind) {
      case kSum: apply_scan<kSum, kReverse>(row, slots, tile, io, sh, mine, o); break;
      case kMax: apply_scan<kMax, kReverse>(row, slots, tile, io, sh, mine, o); break;
      case kLast: apply_scan<kLast, kReverse>(row, slots, tile, io, sh, mine, o); break;
      case kLast2: apply_scan<kLast2, kReverse>(row, slots, tile, io, sh, mine, o); break;
      default: apply_delay<kReverse>(row, slots, tile, mine[threadIdx.x], sh.carry[o].a); break;
    }
  }
  __syncthreads();  // the outputs are in their slots
  for (int o = 0; o < count; ++o) {
    const Row row = load_row(rows + o * kStepWords);
    if (row.g0 >= 0) copy_out(slots + row.s0 * tile.words, io.out[row.g0], tile);
    if (row.g1 >= 0) copy_out(slots + row.s1 * tile.words, io.out[row.g1], tile);
  }
}

// prog: the staged program of ops/scanline_ir.Lowered.table(). Dynamic
// shared memory: the slots, then a thread prefix per op of a step. One
// block a tile.
template <bool kReverse>
__global__ void __launch_bounds__(kScanThreads, 4)
fused_scan_kernel(const int32_t* __restrict__ prog, const __grid_constant__ Streams io, int64_t n, int items,
                  int64_t tiles, uint32_t base, uint32_t* counter, int32_t* status, int epoch) {
  extern __shared__ int32_t slots[];
  __shared__ StepShared sh;
  __shared__ int64_t drawn;
  const int steps = prog[0], nslots = prog[1], nbytes = prog[4];
  Tile tile;
  tile.items = items;
  tile.size = kScanThreads * items;
  tile.words = tile.size + tile.size / 32;
  tile.bytes = reinterpret_cast<uint8_t*>(slots + nslots * tile.words);
  St* tpre = reinterpret_cast<St*>(tile.bytes + nbytes * tile.size);
  if (threadIdx.x == 0) drawn = static_cast<int64_t>(atomicAdd(counter, 1u) - base);
  __syncthreads();
  const int64_t t = drawn;
  tile.start = (kReverse ? tiles - 1 - t : t) * tile.size;
  tile.len = static_cast<int>(min(static_cast<int64_t>(tile.size), n - tile.start));
  const int32_t* step = prog + kStepWords;
  const int32_t* rows = step + steps * kStepWords;
  for (int s = 0; s < steps; ++s, step += kStepWords) {
    const int type = step[0];
    // A load may reload a slot that the builds freed; after a scan step, a
    // load or a build may write a slot that the scan's copy-out still reads
    // (the lowering frees a returned output's slot after its step). A scan
    // step starts with a barrier of its own.
    const int prev = s > 0 ? step[-kStepWords] : kLoad;
    if ((prev == kEw && type == kLoad) || (prev == kScanStep && type != kScanStep)) __syncthreads();
    if (type == kLoad) {
      load_step(slots, step[2], io.in[step[1]], io.in_type[step[1]], tile);
      if (s + 1 == steps || step[kStepWords] != kLoad) __syncthreads();
    } else if (type == kEw) {
      ew_step(step, slots, tile);
    } else {
      scan_step<kReverse>(rows + step[1] * kStepWords, step[2], slots, tpre, sh, io, status, t, tiles, tile, epoch);
    }
  }
}

// One launch, a block a tile.
template <bool kReverse>
int launch_scan(const int32_t* prog, const Streams& io, int64_t n, int items, int64_t tiles, uint32_t base,
                uint32_t* counter, int32_t* status, int epoch, size_t shared, cudaStream_t stream) {
  auto* kernel = fused_scan_kernel<kReverse>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(tiles), kScanThreads, shared, stream>>>(prog, io, n, items, tiles, base, counter,
                                                                          status, epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swt

// prog: device int32 program (ops/scanline_ir.Lowered.table()); io: host
// array of n_in (pointer, load type) pairs, then n_out output pointers
// (int32[n] each); items: positions a thread (4, 8, 16 or 32: tiles of 256 *
// items); slots, byte_slots, stage_ops: the program's (dynamic shared
// memory: slots tiles of int32 with their padding, byte_slots tiles of
// bytes, and stage_ops * 256 states); status:
// int32 scratch of 8 words per (scan op, tile), whose flag words hold no
// epoch >= `epoch`; counter: a uint32 tile counter that stands at `base`.
// One launch; the counter ends at base + ceil(n / (256 * items)).
extern "C" int sw_fused_scan(const void* prog, const int64_t* io, int64_t n_in, int64_t n_out, int64_t n,
                             int64_t reverse, int64_t items, int64_t slots, int64_t byte_slots, int64_t stage_ops,
                             void* status, void* counter, int64_t base, int64_t epoch, void* stream) {
  using namespace swt;
  const int64_t size = kScanThreads * items;
  const int64_t tiles = size > 0 ? (n + size - 1) / size : 0;
  const int64_t shared = slots * (size + size / 32) * 4 + byte_slots * size +
                         stage_ops * kScanThreads * static_cast<int64_t>(sizeof(St));
  int device = 0, optin = 0;  // the card's shared memory a block may opt in to
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (n <= 0 || (items != 4 && items != 8 && items != 16 && items != 32) || n_in < 0 || n_in > kMaxInputs ||
      n_out < 0 ||
      n_out > kMaxOutputs || stage_ops < 0 || stage_ops > kMaxStageOps ||
      shared > optin - static_cast<int64_t>(sizeof(StepShared)) - 64 || tiles > INT_MAX || epoch <= 0 ||
      epoch >= (1 << 29) || !prog || !status || !counter) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Streams s{};
  for (int64_t k = 0; k < n_in; ++k) {
    s.in[k] = reinterpret_cast<const void*>(io[2 * k]);
    s.in_type[k] = static_cast<int>(io[2 * k + 1]);
    if (!s.in[k] || s.in_type[k] < kLoadI32 || s.in_type[k] > kLoadI8) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int64_t k = 0; k < n_out; ++k) {
    s.out[k] = reinterpret_cast<int32_t*>(io[2 * n_in + k]);
    if (!s.out[k]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const int32_t*>(prog);
  auto* st = static_cast<int32_t*>(status);
  auto* ctr = static_cast<uint32_t*>(counter);
  const auto b = static_cast<uint32_t>(base);
  const auto q = static_cast<cudaStream_t>(stream);
  const int it = static_cast<int>(items);
  const int ep = static_cast<int>(epoch);
  return reverse ? launch_scan<true>(p, s, n, it, tiles, b, ctr, st, ep, shared, q)
                 : launch_scan<false>(p, s, n, it, tiles, b, ctr, st, ep, shared, q);
}
