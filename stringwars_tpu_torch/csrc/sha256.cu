// K4 · SHA-256 of every token of a padded batch (FIPS 180-4).
//
// Replaces the XLA function stringwars_tpu/ops/sha256.py::sha256 (:144, its
// compression _compress :112) together with its host staging prepare_sha256
// (:79), a numpy pass over every byte that builds the padded big-endian
// message words in a block-major [max_blocks, 16, batch] layout for the
// TPU's lanes. Here the kernel reads a PaddedTokens bucket as it lies: rows
// of uint8[B, W], int32 lengths, bytes past a row's length ignored.
//
// What bounds it on an H100: operations. A 64-byte block takes 1,384 32-bit
// instructions (48 schedule steps of two sigmas, 4 each with the XORs as one
// LOP3, and two 3-input adds; 64 rounds of 14: the two Sigmas 4 each, Ch
// and Maj one LOP3 each, four 3-input adds; 8 feed-forward adds), against
// 64 bytes read: nearly every word of the hash suite's corpus is one block.
// The design: one thread per token, the eight state words and a 16-word
// rolling schedule in registers, all 64 rounds unrolled. The thread builds
// each block in registers: it loads the row's 16-byte pieces that hold
// bytes below the length (one 16-byte vector each where the rows are
// 16-byte aligned, else up to four 4-byte words), zeroes the bytes past the
// length, sets the 0x80 byte and, in the last block, the 64-bit bit length
// (FIPS 180-4 §5.1.1). A token of many blocks (the catch bucket past 4,096
// B) loops in its thread, and its warp waits for it.
//
// What held the earlier form of this kernel at 41% of the bound
// (sha256-words-128MB, PERF.md), and what this one does about it:
// - The pipes. Rotations (SHF), three-input logic (LOP3) and three-input
//   adds (IADD3) all issue on the integer ALU pipe, 64 lanes an SM a
//   clock, half the 128 the bound assumes; the FMA pipe, which takes
//   integer multiply-adds, was nearly idle. Every add is now an IMAD by
//   `one` (add below). Counts of the body, the largest basic block of
//   sha256_kernel (cuobjdump -sass; chip_smoke.py's sha256 row prints
//   them), per 64-byte block: the earlier form 1,433 instructions, ALU
//   1,300 (SHF 677, LOP3 353, IADD3 245, PRMT 16, ISETP 8), FMA 124
//   (IMAD); now 1,699, ALU 1,059 (SHF 677, LOP3 353, PRMT 16, ISETP 8,
//   IADD3 4), FMA 606 (IMAD). At 64 ALU instructions a clock an SM that is
//   a ceiling of 1.62 ms before and 1.32 ms now for the hash suite's 20.9 M
//   blocks on an H100 at 1.98 GHz.
//   Also tried on an H100 and dropped: the schedule's plain shifts as
//   IMAD.HI (no faster), and rotations as the two halves of an IMAD.WIDE
//   (slower: more instructions on both pipes).
// - The digest stores. Each thread wrote its digest as eight 4-byte stores
//   at a 32-byte stride: a warp's store touched 32 sectors for 128 bytes.
//   A warp now stages its 32 digests in shared memory and writes them as 1
//   KiB of whole 128-byte lines with 16-byte stores.
// - Short rows. A row piece below the length is one 16-byte vector
//   wherever the rows are 16-byte aligned (the width is then a multiple of
//   16, so the vector never passes the row); the earlier form took it only
//   where all 16 bytes lay below the length, so most words took up to four
//   4-byte loads.
#include "common.cuh"

namespace swt {

__constant__ uint32_t kSha256K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u,
    0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u,
    0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u, 0x06CA6351u, 0x14292967u,
    0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu, 0x682E6FF3u,
    0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u, 0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

// a + b on the FMA pipe: an IMAD by `one`, a kernel argument equal to 1,
// which the compiler cannot fold back into an IADD3 on the ALU pipe.
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t one) { return a * one + b; }

// One compression of the 16 big-endian words w into the state h. Every add
// is an IMAD (two for a three-input sum, where the ALU pipe took one
// IADD3); the rotations, shifts and Ch/Maj/Sigma logic stay on the ALU.
// h + K[i] + w[i] is summed apart from the e chain.
__device__ __forceinline__ void sha256_compress(uint32_t h[8], uint32_t w[16], uint32_t one) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[i & 15] = add(add(add(w[i & 15], s0, one), w[(i - 7) & 15], one), s1, one);
    }
    const uint32_t pre = add(add(w[i & 15], kSha256K[i], one), hh, one);
    const uint32_t big1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = add(add(pre, big1, one), ch, one);
    const uint32_t big0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g; g = f; f = e; e = add(d, t1, one);
    d = c; c = b; b = a; a = add(add(t1, big0, one), maj, one);
  }
  h[0] = add(h[0], a, one); h[1] = add(h[1], b, one); h[2] = add(h[2], c, one); h[3] = add(h[3], d, one);
  h[4] = add(h[4], e, one); h[5] = add(h[5], f, one); h[6] = add(h[6], g, one); h[7] = add(h[7], hh, one);
}

// The little-endian word x at byte offset o of a token of `len` bytes, with
// the bytes at or past len zeroed and 0x80 at len, as a big-endian word.
__device__ __forceinline__ uint32_t message_word(uint32_t x, int64_t o, int64_t len) {
  const int64_t k = len - o;  // the word's bytes that belong to the token
  if (k < 4) x = k <= 0 ? (k == 0 ? 0x80u : 0u) : ((x & ((1u << (8 * k)) - 1u)) | (0x80u << (8 * k)));
  return __byte_perm(x, 0, 0x0123);
}

// A warp's 32 digests in shared memory: the first halves (h0..h3) of digest
// i at [i], the second halves at [kHalf + i]; the 4-vector gap keeps each
// quarter-warp's 16-byte accesses on distinct banks, writing and reading.
constexpr int kHalf = 36;

// vec16: rows 16-byte aligned (the data pointer and the width). one: 1.
__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ data, int64_t count, int64_t width, const int32_t* __restrict__ lengths,
              uint32_t* __restrict__ out, int vec16, uint32_t one) {
  __shared__ uint4 staged[kThreads / 32][2 * kHalf];
  uint4* mine = staged[threadIdx.x >> 5];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31u); first < count;
       first += stride) {  // the warp's 32 rows from `first`, uniform across the warp
    const int64_t row = first + lane;
    uint32_t h[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                     0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    if (row < count) {
      const uint8_t* p = data + row * width;
      const int64_t len = lengths[row];
      const int64_t blocks = (len + 9 + 63) >> 6;
      for (int64_t k = 0; k < blocks; ++k) {
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t o = (k << 6) + 16 * q;
          uint32_t x[4] = {0u, 0u, 0u, 0u};
          if (o < len) {
            if (vec16) {  // o + 16 <= width: both are multiples of 16 and o < len <= width
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + o));
              x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (o + 4 * i < len) x[i] = __ldg(reinterpret_cast<const uint32_t*>(p + o + 4 * i));
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) w[4 * q + i] = message_word(x[i], o + 4 * i, len);
        }
        if (k == blocks - 1) {
          const uint64_t bits = static_cast<uint64_t>(len) << 3;
          w[14] = static_cast<uint32_t>(bits >> 32);
          w[15] = static_cast<uint32_t>(bits);
        }
        sha256_compress(h, w, one);
      }
    }
    mine[lane] = make_uint4(h[0], h[1], h[2], h[3]);
    mine[kHalf + lane] = make_uint4(h[4], h[5], h[6], h[7]);
    __syncwarp();
    // Vector j of the warp's 1 KiB of digests: half j & 1 of digest j >> 1.
    const int64_t vectors = 2 * (count - first < 32 ? count - first : 32);
    uint4* dst = reinterpret_cast<uint4*>(out + first * 8);
#pragma unroll
    for (int j = lane; j < 64; j += 32) {
      if (j < vectors) dst[j] = mine[(j & 1) * kHalf + (j >> 1)];
    }
    __syncwarp();
  }
}

}  // namespace swt

// out[row, 0:8] = SHA-256 of data[row, 0:lengths[row]] as big-endian words,
// for a [count, width] uint8 matrix (width a multiple of 4, rows 4-byte
// aligned, every length at most width); out 16-byte aligned.
extern "C" int sw_sha256(const void* data, int64_t count, int64_t width, const void* lengths, void* out, void* stream) {
  if (count <= 0) return static_cast<int>(cudaSuccess);
  if (width % 4 != 0 || (reinterpret_cast<uintptr_t>(data) & 3) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = (reinterpret_cast<uintptr_t>(data) & 15) == 0 && width % 16 == 0;
  swt::sha256_kernel<<<swt::stream_blocks(count), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), count, width, static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(out), vec16, 1u);
  return static_cast<int>(cudaGetLastError());
}
