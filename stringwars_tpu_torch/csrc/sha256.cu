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
// each block in registers: it loads the row's words below the length (as
// 16-byte vectors where the rows are 16-byte aligned), zeroes the bytes past
// the length, sets the 0x80 byte and, in the last block, the 64-bit bit
// length (FIPS 180-4 §5.1.1). A token of many blocks (the catch bucket past
// 4,096 B) loops in its thread, and its warp waits for it.
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

// One compression of the 16 big-endian words w into the state h.
__device__ __forceinline__ void sha256_compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t big1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + big1 + ch + kSha256K[i] + w[i & 15];
    const uint32_t big0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + big0 + maj;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// The little-endian word x at byte offset o of a token of `len` bytes, with
// the bytes at or past len zeroed and 0x80 at len, as a big-endian word.
__device__ __forceinline__ uint32_t message_word(uint32_t x, int64_t o, int64_t len) {
  const int64_t k = len - o;  // the word's bytes that belong to the token
  if (k < 4) x = k <= 0 ? (k == 0 ? 0x80u : 0u) : ((x & ((1u << (8 * k)) - 1u)) | (0x80u << (8 * k)));
  return __byte_perm(x, 0, 0x0123);
}

// vec16: rows 16-byte aligned (the data pointer and the width).
__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ data, int64_t count, int64_t width, const int32_t* __restrict__ lengths,
              uint32_t* __restrict__ out, int vec16) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; row < count; row += stride) {
    const uint8_t* p = data + row * width;
    const int64_t len = lengths[row];
    const int64_t blocks = (len + 9 + 63) >> 6;
    uint32_t h[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                     0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    for (int64_t k = 0; k < blocks; ++k) {
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t o = (k << 6) + 16 * q;
        uint32_t x[4] = {0u, 0u, 0u, 0u};
        if (vec16 && o + 16 <= len) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + o));
          x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (o + 4 * i < len) x[i] = __ldg(reinterpret_cast<const uint32_t*>(p + o + 4 * i));
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
      sha256_compress(h, w);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[row * 8 + i] = h[i];
  }
}

}  // namespace swt

// out[row, 0:8] = SHA-256 of data[row, 0:lengths[row]] as big-endian words,
// for a [count, width] uint8 matrix (width a multiple of 4, rows 4-byte
// aligned, every length at most width).
extern "C" int sw_sha256(const void* data, int64_t count, int64_t width, const void* lengths, void* out, void* stream) {
  if (count <= 0) return static_cast<int>(cudaSuccess);
  if (width % 4 != 0 || (reinterpret_cast<uintptr_t>(data) & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = (reinterpret_cast<uintptr_t>(data) & 15) == 0 && width % 16 == 0;
  swt::sha256_kernel<<<swt::stream_blocks(count), swt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), count, width, static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(out), vec16);
  return static_cast<int>(cudaGetLastError());
}
