// Reading tokens where they lie on a tape (spans: token t is data[offsets[t],
// offsets[t + 1])), shared by the per-token hash kernels (xxh3.cu, hash.cu).
// A token is read as the aligned words that hold it, its values cut out with
// funnel shifts: no byte loads, whatever its alignment. Words that lie inside
// the buffer are read unguarded; a word that may reach past either end (the
// tape's first and last few tokens) is read byte by byte, its outside bytes
// as 0, so no load passes the buffer.
#pragma once

#include <cstdint>

namespace swt {

// The readable bytes [lo, hi).
struct Extent {
  uintptr_t lo, hi;
};

// Whether the aligned words a token at p of n bytes reads, [p & ~7, (p & ~7)
// + n + 16), lie inside the extent: then it reads them unguarded.
__device__ __forceinline__ bool inside(uintptr_t p, uint64_t n, const Extent& x) {
  const uintptr_t w = p & ~uintptr_t{7};
  return w >= x.lo && w + n + 16 <= x.hi;
}

// The 8-byte word at the aligned address w, little-endian; guarded, bytes
// outside the extent read as 0.
template <bool kGuard>
__device__ __forceinline__ uint64_t word(uintptr_t w, const Extent& x) {
  if (!kGuard || (w >= x.lo && w + 8 <= x.hi)) return __ldg(reinterpret_cast<const unsigned long long*>(w));
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (w + k >= x.lo && w + k < x.hi) v |= static_cast<uint64_t>(__ldg(reinterpret_cast<const uint8_t*>(w + k))) << (8 * k);
  }
  return v;
}

// The 4-byte word at the aligned address w, as word() reads 8.
template <bool kGuard>
__device__ __forceinline__ uint32_t word32(uintptr_t w, const Extent& x) {
  if (!kGuard || (w >= x.lo && w + 4 <= x.hi)) return __ldg(reinterpret_cast<const unsigned int*>(w));
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (w + k >= x.lo && w + k < x.hi) v |= static_cast<uint32_t>(__ldg(reinterpret_cast<const uint8_t*>(w + k))) << (8 * k);
  }
  return v;
}

// The 8 bytes that start s bytes (0..7) into the 16 bytes a:b.
__device__ __forceinline__ uint64_t funnel(uint64_t a, uint64_t b, int s) {
  const bool high = s >= 4;
  const uint32_t x0 = high ? static_cast<uint32_t>(a >> 32) : static_cast<uint32_t>(a);
  const uint32_t x1 = high ? static_cast<uint32_t>(b) : static_cast<uint32_t>(a >> 32);
  const uint32_t x2 = high ? static_cast<uint32_t>(b >> 32) : static_cast<uint32_t>(b);
  const unsigned shift = (8 * s) & 31;
  return static_cast<uint64_t>(__funnelshift_r(x0, x1, shift)) |
         (static_cast<uint64_t>(__funnelshift_r(x1, x2, shift)) << 32);
}

// The 4 bytes that start s bytes (0..3) into the 8 bytes a:b.
__device__ __forceinline__ uint32_t funnel(uint32_t a, uint32_t b, int s) { return __funnelshift_r(a, b, 8 * s); }

}  // namespace swt
