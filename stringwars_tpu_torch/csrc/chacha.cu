// K13 · ChaCha20 keystream XOR and the Poly1305 MAC (RFC 8439).
//
// sw_chacha20_xor replaces the TPU kernel
// stringwars_tpu/ops/chacha.py::_xor_keystream_pallas (_chacha_kernel :102)
// and the XLA keystream it falls back to (_keystream :59): out = data ^
// keystream, where block b's 16 words are ChaCha20 (20 rounds) with the
// counter (counter0 + b) mod 2^32.
//
// What bounds it on an H100: one read and one write of the data (128 MiB
// each way: 80 us at 3.35 TB/s) against 993 32-bit instructions a 64-byte
// block (80 quarter rounds of 12, 16 feed-forward adds, 16 XORs with the
// data, the counter's add): 2.1 G for 128 MiB, 62 us at 33.4 T/s; the two
// are close. The TPU's word-major [steps, 16, 8, 128] relayout and its
// 1,024-block granularity are not carried over: the kernel reads the bytes
// where they lie, at any length and any offset, so the host pads nothing.
// The design:
//
// - One thread a 64-byte block, its 16 state words in registers for all 20
//   rounds. Rotations by 16 and 8 are byte permutes (PRMT), by 12 and 7
//   funnel shifts (SHF). nvcc already issues nearly all the adds as IMADs
//   on the FMA pipe (tile loop, per block: about 320 IMAD, 330 LOP3, 160
//   SHF, 160 PRMT and no IADD3 in the rounds; an ALU-pipe ceiling of about
//   0.083 ms for 128 MiB), so the adds are written as adds: forcing them
//   onto the FMA pipe by a multiply by a runtime 1 (sha256.cu) spilled
//   registers here and was slower on an H100 (PERF.md;
//   tools/hopper_probes.py chacha times both).
// - Tiles. Where both buffers are 16-byte aligned, a warp takes 2 KiB at a
//   time, the 32 blocks of its lanes: it loads and stores them as
//   lane-contiguous 16-byte vectors (a warp instruction moves 512
//   contiguous bytes), and the keystream goes through 2 KiB of shared
//   memory a warp from the lane that computed it to the lanes that hold
//   its data. The 16-byte pieces lie there under an XOR swizzle (ks_slot),
//   so that both the lanes writing their blocks' four pieces and the lanes
//   reading the tile's contiguous pieces meet no bank conflict. The earlier
//   form loaded and stored each block's four vectors from its own thread,
//   so a warp instruction touched 32 sectors at a 64-byte stride.
// - The grid is persistent (the blocks that are resident at once) and each
//   warp walks its tiles with the next tile's 2 KiB loaded into registers
//   while the rounds of this one run. On an H100 the kernel then takes
//   about the time of the same loads and stores without the rounds.
// - The bytes past the last whole tile, unaligned views and short messages
//   (the AEAD's one-time key, the suites' per-token seals) take the direct
//   path, one thread a block: 16-byte vectors where both buffers are
//   16-byte aligned, 4-byte words where they are 4-byte aligned, else
//   bytes, and the partial last block byte by byte.
//
// sw_poly1305 replaces the XLA limb products of
// stringwars_tpu/ops/chacha.py::_poly_chunk_partials (:219) and the host
// bigint fold of poly1305_tag (:331): the whole tag is computed on the card,
// for any length, and only its 16 bytes are read back. The MAC is the
// polynomial sum_i m_i r^(N - i) mod 2^130 - 5 (block i of N counted from 0,
// each block with its 2^128 bit) plus s. What bounds it: one read of the
// message (128 MiB: 40 us) against 70 instructions a 16-byte block (the
// limbs of the block, 10; their add, 5; the product by r, 25 multiply-adds
// of 32 x 32 -> 64 bits; its carries, 30): 18 us.
// The design:
//
// - Each thread runs Horner, h = h * r + m, over a run of kPolyRun blocks,
//   in five 26-bit limbs with 64-bit products; its 16 blocks are loaded
//   into registers first, so 256 bytes a thread are in flight at once.
//   Leading zero blocks align the runs at the message's end: a zero block
//   at the head of a Horner chain adds nothing.
// - A block of threads combines its runs in a tree in shared memory:
//   v[t] = v[t] * r^(kPolyRun * s) + v[t + s], which leaves one partial per
//   4,096 message blocks. The powers are squared from r by one thread per
//   block while the others load; no per-key host table.
// - A second launch, one block, folds the partials the same way with the
//   multiplier R = r^4096 (Horner over a run of partials per thread, then
//   the tree), multiplies by r, reduces fully mod 2^130 - 5, adds s mod
//   2^128 and writes the tag.
// - Raw mode is Poly1305 itself (a partial last block gets its 0x01 byte
//   and no 2^128 bit). AEAD mode reads the RFC 8439 §2.8 MAC input in place:
//   pad16(aad) || pad16(ciphertext) || le64(len aad) || le64(len ct), so no
//   copy of the ciphertext is made.
// - r and s are read from device memory (the key's 32 bytes), so the AEAD's
//   one-time key, made by the keystream kernel, never comes back to the
//   host: the keystream and the MAC run back to back without a sync.
#include <cstring>

#include "common.cuh"

namespace swt {

__device__ __forceinline__ uint32_t rotl32_cc(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

struct ChachaKey {
  uint32_t key[8];
  uint32_t nonce[3];
};

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = __byte_perm(d ^ a, 0, 0x1032);  // rotate by 16
  c += d; b = rotl32_cc(b ^ c, 12);
  a += b; d = __byte_perm(d ^ a, 0, 0x2103);  // rotate by 8
  c += d; b = rotl32_cc(b ^ c, 7);
}

// The 16 keystream words of one block (RFC 8439 §2.3).
__device__ __forceinline__ void chacha_block(const ChachaKey& k, uint32_t counter, uint32_t x[16]) {
  const uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                          k.key[0], k.key[1], k.key[2], k.key[3], k.key[4], k.key[5], k.key[6], k.key[7],
                          counter, k.nonce[0], k.nonce[1], k.nonce[2]};
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = s[i];
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += s[i];
}

constexpr int kTileBlocks = 32;                 // 64-byte blocks a warp's tile: one a lane
constexpr int64_t kTileBytes = 64 * kTileBlocks;  // 2 KiB (ops/chacha.TILE_BYTES)
constexpr int kTileVecs = kTileBlocks * 4;      // its 16-byte pieces, four a lane

// The shared-memory slot of a tile's 16-byte piece i (block i / 4, quarter
// i % 4): the quarter XOR bits 1-2 of the block. Eight lanes storing their
// blocks' quarter q (blocks 8j..8j+7) and eight lanes loading pieces
// 32q + 8j..8j+7 (blocks 8q+2j, 8q+2j+1) each cover the 32 banks once.
__device__ __forceinline__ int ks_slot(int i) {
  const int b = i >> 2;
  return (b << 2) | ((i & 3) ^ ((b >> 1) & 3));
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) { return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w); }

// vec: 16 when in and out are 16-byte aligned, 4 when 4-byte aligned, else
// 1; the tiles only at 16.
__global__ void __launch_bounds__(kThreads)
chacha_xor_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t n, ChachaKey k,
                  uint32_t counter0, int vec) {
  __shared__ uint4 ks_tiles[kThreads / 32][kTileVecs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tiles = vec == 16 ? n / kTileBytes : 0;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const uint4* src = reinterpret_cast<const uint4*>(in);
  uint4* dst = reinterpret_cast<uint4*>(out);
  uint4* tile = ks_tiles[warp];
  int64_t t = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
  uint4 d[4];
  if (t < tiles) {
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __ldg(src + t * kTileVecs + 32 * q + lane);
  }
  while (t < tiles) {
    const int64_t next = t + warps;
    const int64_t ahead = next < tiles ? next : t;  // the last tile reloads itself (cached), not past n
    uint4 dn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) dn[q] = __ldg(src + ahead * kTileVecs + 32 * q + lane);
    uint32_t x[16];
    chacha_block(k, counter0 + static_cast<uint32_t>(t * kTileBlocks + lane), x);
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[ks_slot(4 * lane + q)] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[t * kTileVecs + 32 * q + lane] = xor4(d[q], tile[ks_slot(32 * q + lane)]);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = dn[q];
    t = next;
  }
  // The direct path: the blocks past the whole tiles, one thread a block.
  const int64_t blocks = (n + 63) >> 6;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t b = tiles * kTileBlocks + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; b < blocks;
       b += stride) {
    const int64_t off = b << 6;
    const uint32_t counter = counter0 + static_cast<uint32_t>(b);
    uint32_t ks[16];
    if (off + 64 <= n && vec == 16) {
      const uint4* from = reinterpret_cast<const uint4*>(in + off);
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __ldg(from + q);
      chacha_block(k, counter, ks);
      uint4* to = reinterpret_cast<uint4*>(out + off);
#pragma unroll
      for (int q = 0; q < 4; ++q) to[q] = xor4(v[q], make_uint4(ks[4 * q], ks[4 * q + 1], ks[4 * q + 2], ks[4 * q + 3]));
    } else if (off + 64 <= n && vec == 4) {
      const uint32_t* from = reinterpret_cast<const uint32_t*>(in + off);
      uint32_t v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __ldg(from + i);
      chacha_block(k, counter, ks);
      uint32_t* to = reinterpret_cast<uint32_t*>(out + off);
#pragma unroll
      for (int i = 0; i < 16; ++i) to[i] = v[i] ^ ks[i];
    } else {  // unaligned, or the partial last block: byte by byte
      const int64_t rem = n - off;
      chacha_block(k, counter, ks);
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        if (j < rem) out[off + j] = in[off + j] ^ static_cast<uint8_t>(ks[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Poly1305
// ---------------------------------------------------------------------------

constexpr int kPolyRun = 16;                           // 16-byte blocks a thread
constexpr int kPolyLevels = 8;                         // log2(kThreads)
constexpr int64_t kPolySpan = kPolyRun * kThreads;     // message blocks a partial
constexpr uint32_t kM26 = 0x3FFFFFFu;

// A value mod 2^130 - 5 in five 26-bit limbs, not fully reduced. A product's
// limbs are below 2^26 + 2^12; the sums the tree adds stay below 2^30, so
// with the other factor a product, every 5-term sum of 64-bit limb
// products fits (5 x 2^30 x 5 x 2^26.01 < 2^61).
struct P130 {
  uint32_t h[5];
};

__device__ __forceinline__ P130 p130_zero() { return P130{{0u, 0u, 0u, 0u, 0u}}; }

__device__ __forceinline__ P130 p130_add(const P130& a, const P130& b) {
  P130 c;
#pragma unroll
  for (int i = 0; i < 5; ++i) c.h[i] = a.h[i] + b.h[i];
  return c;
}

// a * b mod 2^130 - 5 (2^130 = 5): limbs of the result below 2^26, but the
// second, which may reach 2^26 + 2^12.
__device__ __forceinline__ P130 p130_mul(const P130& a, const P130& b) {
  const uint64_t a0 = a.h[0], a1 = a.h[1], a2 = a.h[2], a3 = a.h[3], a4 = a.h[4];
  const uint64_t b0 = b.h[0], b1 = b.h[1], b2 = b.h[2], b3 = b.h[3], b4 = b.h[4];
  const uint64_t s1 = b1 * 5, s2 = b2 * 5, s3 = b3 * 5, s4 = b4 * 5;
  uint64_t d0 = a0 * b0 + a1 * s4 + a2 * s3 + a3 * s2 + a4 * s1;
  uint64_t d1 = a0 * b1 + a1 * b0 + a2 * s4 + a3 * s3 + a4 * s2;
  uint64_t d2 = a0 * b2 + a1 * b1 + a2 * b0 + a3 * s4 + a4 * s3;
  uint64_t d3 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0 + a4 * s4;
  uint64_t d4 = a0 * b4 + a1 * b3 + a2 * b2 + a3 * b1 + a4 * b0;
  d1 += d0 >> 26;
  d2 += d1 >> 26;
  d3 += d2 >> 26;
  d4 += d3 >> 26;
  d0 = (d0 & kM26) + (d4 >> 26) * 5;
  P130 c;
  c.h[0] = static_cast<uint32_t>(d0 & kM26);
  c.h[1] = static_cast<uint32_t>((d1 & kM26) + (d0 >> 26));
  c.h[2] = static_cast<uint32_t>(d2 & kM26);
  c.h[3] = static_cast<uint32_t>(d3 & kM26);
  c.h[4] = static_cast<uint32_t>(d4 & kM26);
  return c;
}

// A 16-byte block (four little-endian words) and its 2^128 bit as limbs.
__device__ __forceinline__ P130 p130_block(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, uint32_t hibit) {
  return P130{{w0 & kM26, __funnelshift_r(w0, w1, 26) & kM26, __funnelshift_r(w1, w2, 20) & kM26,
               __funnelshift_r(w2, w3, 14) & kM26, (w3 >> 8) | (hibit << 24)}};
}

// r of the key, clamped (RFC 8439 §2.5), and s: the key's 32 bytes on the
// device, 4-byte aligned.
__device__ __forceinline__ P130 poly_r(const uint8_t* key) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(key);
  return p130_block(w[0] & 0x0FFFFFFFu, w[1] & 0x0FFFFFFCu, w[2] & 0x0FFFFFFCu, w[3] & 0x0FFFFFFCu, 0u);
}

struct PolyInput {
  const uint8_t* aad;  // AEAD mode only
  const uint8_t* msg;
  int64_t aad_len, msg_len;
  int64_t aad_blocks, msg_blocks;  // AEAD: ceil(len / 16) each
  int64_t blocks;                  // 16-byte blocks of the MAC input
  int64_t lead;                    // zero blocks before it, to a whole number of partials
  int aead;
};

// `len` bytes (at most 16) at p, little-endian words, zero past len; with
// `one`, the byte 0x01 at len (raw Poly1305's partial last block).
__device__ __forceinline__ void read_block(const uint8_t* p, int64_t len, bool one, uint32_t w[4]) {
  if (len >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t byte = j < len ? static_cast<uint32_t>(p[j]) : (one && j == len ? 1u : 0u);
    w[j >> 2] |= byte << (8 * (j & 3));
  }
}

// Block i of the MAC input (i < 0: a leading zero block): its four
// little-endian words, and its 2^128 bit as the return value.
__device__ __forceinline__ uint32_t poly_block(const PolyInput& in, int64_t i, uint32_t w[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (i < 0) return 0u;
  if (!in.aead) {
    const int64_t left = in.msg_len - i * 16;
    read_block(in.msg + i * 16, left, true, w);
    return left >= 16 ? 1u : 0u;
  }
  if (i < in.aad_blocks) {
    read_block(in.aad + i * 16, in.aad_len - i * 16, false, w);
  } else if (i < in.aad_blocks + in.msg_blocks) {
    const int64_t j = i - in.aad_blocks;
    read_block(in.msg + j * 16, in.msg_len - j * 16, false, w);
  } else {  // le64(len aad) || le64(len ciphertext)
    w[0] = static_cast<uint32_t>(in.aad_len);
    w[1] = static_cast<uint32_t>(static_cast<uint64_t>(in.aad_len) >> 32);
    w[2] = static_cast<uint32_t>(in.msg_len);
    w[3] = static_cast<uint32_t>(static_cast<uint64_t>(in.msg_len) >> 32);
  }
  return 1u;
}

// v[0] = sum_t h_t * m^(kThreads - 1 - t) over the block's threads, m^(2^j)
// given for j < kPolyLevels: the tree in shared memory. Valid in thread 0.
__device__ __forceinline__ P130 tree_combine(P130 h, const P130 (&pw)[kPolyLevels], P130 (&v)[kThreads]) {
  const int t = threadIdx.x;
  v[t] = h;
#pragma unroll
  for (int j = 0; j < kPolyLevels; ++j) {
    __syncthreads();
    const int s = 1 << j;
    if ((t & (2 * s - 1)) == 0) {
      h = p130_add(p130_mul(h, pw[j]), v[t + s]);
      v[t] = h;
    }
  }
  return h;
}

// One partial per kPolySpan blocks of the (lead-padded) MAC input:
// sum_k m_k r^(kPolySpan - 1 - k) over the span's blocks.
__global__ void __launch_bounds__(kThreads)
poly_runs_kernel(PolyInput in, const uint8_t* __restrict__ key, uint32_t* __restrict__ partials) {
  __shared__ P130 pw[kPolyLevels];
  __shared__ P130 v[kThreads];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPolySpan + threadIdx.x * kPolyRun - in.lead;
  uint32_t w[kPolyRun][4], hibit[kPolyRun];
#pragma unroll
  for (int j = 0; j < kPolyRun; ++j) hibit[j] = poly_block(in, first + j, w[j]);
  const P130 r = poly_r(key);
  if (threadIdx.x == 0) {  // r^(kPolyRun * 2^j) by squaring, while the loads are in flight
    P130 p = r;
    for (int k = 1; k < kPolyRun; k <<= 1) p = p130_mul(p, p);
    for (int j = 0; j < kPolyLevels; ++j) {
      pw[j] = p;
      p = p130_mul(p, p);
    }
  }
  P130 h = p130_block(w[0][0], w[0][1], w[0][2], w[0][3], hibit[0]);
#pragma unroll
  for (int j = 1; j < kPolyRun; ++j) {
    h = p130_add(p130_mul(h, r), p130_block(w[j][0], w[j][1], w[j][2], w[j][3], hibit[j]));
  }
  h = tree_combine(h, pw, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) partials[blockIdx.x * 5 + i] = h.h[i];
  }
}

// Folds the partials with R = r^kPolySpan, multiplies by r, reduces mod
// 2^130 - 5, adds s mod 2^128 and writes the 16-byte tag. One block.
__global__ void __launch_bounds__(kThreads)
poly_fold_kernel(const uint32_t* __restrict__ partials, int64_t count, const uint8_t* __restrict__ key,
                 uint8_t* __restrict__ tag) {
  __shared__ P130 pw[kPolyLevels];
  __shared__ P130 big;
  __shared__ P130 v[kThreads];
  const int64_t per = (count + kThreads - 1) / kThreads;  // partials a thread
  const int64_t lead = per * kThreads - count;
  const P130 r = poly_r(key);
  if (threadIdx.x == 0) {
    P130 p = r;
    for (int64_t k = 1; k < kPolySpan; k <<= 1) p = p130_mul(p, p);
    big = p;  // R
    P130 q = p;  // R^per, by square and multiply
    for (int64_t e = per - 1; e > 0; e >>= 1) {
      if (e & 1) q = p130_mul(q, p);
      p = p130_mul(p, p);
    }
    for (int j = 0; j < kPolyLevels; ++j) {
      pw[j] = q;
      q = p130_mul(q, q);
    }
  }
  __syncthreads();
  const P130 R = big;
  P130 h = p130_zero();
  for (int64_t k = 0; k < per; ++k) {
    const int64_t g = threadIdx.x * per + k - lead;
    P130 x = p130_zero();
    if (g >= 0) {
#pragma unroll
      for (int i = 0; i < 5; ++i) x.h[i] = partials[g * 5 + i];
    }
    h = p130_add(p130_mul(h, R), x);
  }
  h = tree_combine(h, pw, v);
  if (threadIdx.x != 0) return;
  h = p130_mul(h, r);
  // Carry fully: limbs below 2^26 but the second (at most 2^26), the value
  // below 2 (2^130 - 5); then subtract 2^130 - 5 where that leaves no borrow.
  uint32_t c;
  c = h.h[1] >> 26; h.h[1] &= kM26; h.h[2] += c;
  c = h.h[2] >> 26; h.h[2] &= kM26; h.h[3] += c;
  c = h.h[3] >> 26; h.h[3] &= kM26; h.h[4] += c;
  c = h.h[4] >> 26; h.h[4] &= kM26; h.h[0] += c * 5;
  c = h.h[0] >> 26; h.h[0] &= kM26; h.h[1] += c;
  uint32_t g[5];
  g[0] = h.h[0] + 5; c = g[0] >> 26; g[0] &= kM26;
  g[1] = h.h[1] + c; c = g[1] >> 26; g[1] &= kM26;
  g[2] = h.h[2] + c; c = g[2] >> 26; g[2] &= kM26;
  g[3] = h.h[3] + c; c = g[3] >> 26; g[3] &= kM26;
  g[4] = h.h[4] + c;
  if (g[4] >= (1u << 26)) {  // h >= 2^130 - 5
    g[4] -= 1u << 26;
#pragma unroll
    for (int i = 0; i < 5; ++i) h.h[i] = g[i];
  }
  // h mod 2^128 as four words (the limbs added, not ORed: the second may be
  // 2^26), plus s, mod 2^128.
  const uint32_t* s = reinterpret_cast<const uint32_t*>(key + 16);
  uint64_t acc = static_cast<uint64_t>(h.h[0]) + (static_cast<uint64_t>(h.h[1]) << 26);
  uint32_t words[4];
  words[0] = static_cast<uint32_t>(acc);
  acc = (acc >> 32) + (static_cast<uint64_t>(h.h[2]) << 20);
  words[1] = static_cast<uint32_t>(acc);
  acc = (acc >> 32) + (static_cast<uint64_t>(h.h[3]) << 14);
  words[2] = static_cast<uint32_t>(acc);
  acc = (acc >> 32) + (static_cast<uint64_t>(h.h[4]) << 8);
  words[3] = static_cast<uint32_t>(acc);
  acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc += static_cast<uint64_t>(words[i]) + s[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) tag[4 * i + b] = static_cast<uint8_t>(acc >> (8 * b));
    acc >>= 32;
  }
}

}  // namespace swt

// out[i] = data[i] ^ keystream byte i, i < n: ChaCha20 under the 32-byte
// key and 12-byte nonce (host memory), block b at counter (counter + b) mod 2^32.
extern "C" int sw_chacha20_xor(const void* data, void* out, int64_t n, const void* key32, const void* nonce12,
                               int64_t counter, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  swt::ChachaKey k;
  memcpy(k.key, key32, 32);
  memcpy(k.nonce, nonce12, 12);
  const uintptr_t both = reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(out);
  const int vec = (both & 15) == 0 ? 16 : ((both & 3) == 0 ? 4 : 1);
  const int64_t tiles = vec == 16 ? n / swt::kTileBytes : 0;
  // A message of whole tiles fills the resident blocks; a shorter one
  // launches a thread a block and no occupancy query.
  const int grid = tiles > 0 ? swt::resident_grid(swt::chacha_xor_kernel, 0, (tiles + swt::kThreads / 32 - 1) / (swt::kThreads / 32))
                             : swt::stream_blocks((n + 63) >> 6);
  swt::chacha_xor_kernel<<<grid, swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), n, k, static_cast<uint32_t>(counter), vec);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte Poly1305 tag under the 32-byte key r || s (device memory,
// 4-byte aligned) of msg[0, msg_len) (raw mode, aead = 0) or of the RFC 8439
// AEAD MAC input over aad and msg (aead = 1). `partials` holds at least
// ceil(blocks / 4096) x 5 words, blocks being the MAC input's 16-byte blocks.
extern "C" int sw_poly1305(const void* aad, int64_t aad_len, const void* msg, int64_t msg_len, int64_t aead,
                           const void* key, void* partials, int64_t capacity, void* tag, void* stream) {
  if ((reinterpret_cast<uintptr_t>(key) & 3) != 0 || aad_len < 0 || msg_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  swt::PolyInput in;
  in.aad = static_cast<const uint8_t*>(aad);
  in.msg = static_cast<const uint8_t*>(msg);
  in.aad_len = aead ? aad_len : 0;
  in.msg_len = msg_len;
  in.aad_blocks = (in.aad_len + 15) / 16;
  in.msg_blocks = (msg_len + 15) / 16;
  in.aead = aead ? 1 : 0;
  in.blocks = aead ? in.aad_blocks + in.msg_blocks + 1 : in.msg_blocks;
  const int64_t count = (in.blocks + swt::kPolySpan - 1) / swt::kPolySpan;
  if (count > capacity || count >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  in.lead = count * swt::kPolySpan - in.blocks;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint8_t*>(key);
  auto* parts = static_cast<uint32_t*>(partials);
  if (count > 0) swt::poly_runs_kernel<<<static_cast<int>(count), swt::kThreads, 0, s>>>(in, k, parts);
  swt::poly_fold_kernel<<<1, swt::kThreads, 0, s>>>(parts, count, k, static_cast<uint8_t*>(tag));
  return static_cast<int>(cudaGetLastError());
}
