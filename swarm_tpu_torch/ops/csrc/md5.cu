// MD5 of each row's body on the card (sm_90a).
//
//   match_md5  <- swarm_tpu/ops/md5.py md5_words (:42), a lax.scan over
//                 64-byte blocks that XLA fuses into one loop on the TPU
//
// The corpus checks `md5(body) == "<hex>"` on the card, so every batch
// of a corpus with such a matcher digests every row's body.  In eager
// PyTorch the scan is a Python loop of blocks x 64 rounds x ~11 ops, one
// launch each (~23K a batch); here it is one launch.
//
// Design: one thread per row.  MD5's chain is sequential within a row
// and rows are independent, so a thread walks its own row's
// n = floor((len + 72) / 64) blocks (the padded message: the bytes,
// 0x80, zeros, the 64-bit bit length), never more than the W / 64 + 1
// blocks of the JAX scan.  The padding is applied in registers as each
// block is loaded (four 16-byte loads of the row): bytes at or past
// `len` read as zero (the JAX code masks them, so the stream's bytes
// there need not be zero), 0x80 goes at byte `len`, and word 14 of the
// last block is the bit length (uint32: len * 8 wraps as the JAX code's
// does; word 15 stays zero).  Blocks past the stream's W bytes hold no
// stream bytes and are not loaded.  The block count comes from the
// row's length on the card, so the launch needs no host read.
//
// Output: the four state words per row, little-endian, as int64 [B, 4]
// holding the uint32 values, exactly as the plain md5_words returns
// them (PyTorch for the CPU has no uint32).
//
// Bound: each row's padded bytes read once and ~9 32-bit operations a
// round (64 rounds a block); one thread per row is latency-bound too:
// the longest row's blocks x 64 dependent rounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMd5Threads = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);
}

#define F(b, c, d) ((((c) ^ (d)) & (b)) ^ (d))
#define G(b, c, d) ((((b) ^ (c)) & (d)) ^ (c))
#define H(b, c, d) ((b) ^ (c) ^ (d))
#define I(b, c, d) ((c) ^ ((b) | ~(d)))
#define STEP(f, a, b, c, d, x, k, s) \
  a = b + rotl(a + f(b, c, d) + (x) + (k), s)

__device__ __forceinline__ void md5_block(uint32_t st[4], const uint32_t x[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  STEP(F, a, b, c, d, x[ 0], 0xd76aa478u,  7);
  STEP(F, d, a, b, c, x[ 1], 0xe8c7b756u, 12);
  STEP(F, c, d, a, b, x[ 2], 0x242070dbu, 17);
  STEP(F, b, c, d, a, x[ 3], 0xc1bdceeeu, 22);
  STEP(F, a, b, c, d, x[ 4], 0xf57c0fafu,  7);
  STEP(F, d, a, b, c, x[ 5], 0x4787c62au, 12);
  STEP(F, c, d, a, b, x[ 6], 0xa8304613u, 17);
  STEP(F, b, c, d, a, x[ 7], 0xfd469501u, 22);
  STEP(F, a, b, c, d, x[ 8], 0x698098d8u,  7);
  STEP(F, d, a, b, c, x[ 9], 0x8b44f7afu, 12);
  STEP(F, c, d, a, b, x[10], 0xffff5bb1u, 17);
  STEP(F, b, c, d, a, x[11], 0x895cd7beu, 22);
  STEP(F, a, b, c, d, x[12], 0x6b901122u,  7);
  STEP(F, d, a, b, c, x[13], 0xfd987193u, 12);
  STEP(F, c, d, a, b, x[14], 0xa679438eu, 17);
  STEP(F, b, c, d, a, x[15], 0x49b40821u, 22);
  STEP(G, a, b, c, d, x[ 1], 0xf61e2562u,  5);
  STEP(G, d, a, b, c, x[ 6], 0xc040b340u,  9);
  STEP(G, c, d, a, b, x[11], 0x265e5a51u, 14);
  STEP(G, b, c, d, a, x[ 0], 0xe9b6c7aau, 20);
  STEP(G, a, b, c, d, x[ 5], 0xd62f105du,  5);
  STEP(G, d, a, b, c, x[10], 0x02441453u,  9);
  STEP(G, c, d, a, b, x[15], 0xd8a1e681u, 14);
  STEP(G, b, c, d, a, x[ 4], 0xe7d3fbc8u, 20);
  STEP(G, a, b, c, d, x[ 9], 0x21e1cde6u,  5);
  STEP(G, d, a, b, c, x[14], 0xc33707d6u,  9);
  STEP(G, c, d, a, b, x[ 3], 0xf4d50d87u, 14);
  STEP(G, b, c, d, a, x[ 8], 0x455a14edu, 20);
  STEP(G, a, b, c, d, x[13], 0xa9e3e905u,  5);
  STEP(G, d, a, b, c, x[ 2], 0xfcefa3f8u,  9);
  STEP(G, c, d, a, b, x[ 7], 0x676f02d9u, 14);
  STEP(G, b, c, d, a, x[12], 0x8d2a4c8au, 20);
  STEP(H, a, b, c, d, x[ 5], 0xfffa3942u,  4);
  STEP(H, d, a, b, c, x[ 8], 0x8771f681u, 11);
  STEP(H, c, d, a, b, x[11], 0x6d9d6122u, 16);
  STEP(H, b, c, d, a, x[14], 0xfde5380cu, 23);
  STEP(H, a, b, c, d, x[ 1], 0xa4beea44u,  4);
  STEP(H, d, a, b, c, x[ 4], 0x4bdecfa9u, 11);
  STEP(H, c, d, a, b, x[ 7], 0xf6bb4b60u, 16);
  STEP(H, b, c, d, a, x[10], 0xbebfbc70u, 23);
  STEP(H, a, b, c, d, x[13], 0x289b7ec6u,  4);
  STEP(H, d, a, b, c, x[ 0], 0xeaa127fau, 11);
  STEP(H, c, d, a, b, x[ 3], 0xd4ef3085u, 16);
  STEP(H, b, c, d, a, x[ 6], 0x04881d05u, 23);
  STEP(H, a, b, c, d, x[ 9], 0xd9d4d039u,  4);
  STEP(H, d, a, b, c, x[12], 0xe6db99e5u, 11);
  STEP(H, c, d, a, b, x[15], 0x1fa27cf8u, 16);
  STEP(H, b, c, d, a, x[ 2], 0xc4ac5665u, 23);
  STEP(I, a, b, c, d, x[ 0], 0xf4292244u,  6);
  STEP(I, d, a, b, c, x[ 7], 0x432aff97u, 10);
  STEP(I, c, d, a, b, x[14], 0xab9423a7u, 15);
  STEP(I, b, c, d, a, x[ 5], 0xfc93a039u, 21);
  STEP(I, a, b, c, d, x[12], 0x655b59c3u,  6);
  STEP(I, d, a, b, c, x[ 3], 0x8f0ccc92u, 10);
  STEP(I, c, d, a, b, x[10], 0xffeff47du, 15);
  STEP(I, b, c, d, a, x[ 1], 0x85845dd1u, 21);
  STEP(I, a, b, c, d, x[ 8], 0x6fa87e4fu,  6);
  STEP(I, d, a, b, c, x[15], 0xfe2ce6e0u, 10);
  STEP(I, c, d, a, b, x[ 6], 0xa3014314u, 15);
  STEP(I, b, c, d, a, x[13], 0x4e0811a1u, 21);
  STEP(I, a, b, c, d, x[ 4], 0xf7537e82u,  6);
  STEP(I, d, a, b, c, x[11], 0xbd3af235u, 10);
  STEP(I, c, d, a, b, x[ 2], 0x2ad7d2bbu, 15);
  STEP(I, b, c, d, a, x[ 9], 0xeb86d391u, 21);
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

#undef F
#undef G
#undef H
#undef I
#undef STEP

// stream uint8 [B, width] (width % 64 == 0, 16-byte aligned rows),
// len int32 [B] -> digest int64 [B, 4]
__global__ void __launch_bounds__(kMd5Threads)
match_md5_kernel(const uint8_t* __restrict__ stream, const int32_t* __restrict__ len,
                 int32_t n_rows, int32_t width, int64_t* __restrict__ digest) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t n = len[row];
  const uint8_t* src = stream + (size_t)row * width;
  // the padded message's floor((n + 9 + 63) / 64) blocks, of which the
  // JAX scan walks at most its width / 64 + 1
  const int64_t padded = n + 72;
  const int64_t msg_blocks = padded >= 0 ? padded / 64 : -((63 - padded) / 64);
  const int64_t last = msg_blocks - 1;  // holds the bit length
  int64_t blocks = msg_blocks < 0 ? 0 : msg_blocks;
  if (blocks > width / 64 + 1) blocks = width / 64 + 1;
  const uint32_t bitlen = (uint32_t)n * 8u;
  uint32_t st[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
  uint32_t x[16];
  for (int64_t blk = 0; blk < blocks; ++blk) {
    const int64_t base = blk * 64;
    if (base < width) {
      const uint4* q = reinterpret_cast<const uint4*>(src + base);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = q[i];
        x[4 * i] = v.x;
        x[4 * i + 1] = v.y;
        x[4 * i + 2] = v.z;
        x[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = 0u;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // bytes of word i that lie below the length, then the marker
      const int64_t k = n - (base + 4 * i);
      if (k <= 0) {
        x[i] = 0u;
      } else if (k < 4) {
        x[i] &= (1u << (8 * k)) - 1u;
      }
      if (k >= 0 && k < 4) x[i] |= 0x80u << (8 * k);
    }
    if (blk == last) x[14] = bitlen;
    md5_block(st, x);
  }
  int64_t* out = digest + (size_t)row * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (int64_t)st[i];
}

}  // namespace

extern "C" {

// MD5 of n_rows rows of stream (uint8 [n_rows, width], width % 64 == 0,
// 16-byte aligned) with lengths len (int32 [n_rows]) into digest (int64
// [n_rows, 4]).
int match_md5(const uint8_t* stream, const int32_t* len, int32_t n_rows, int32_t width,
              int64_t* digest, void* stream_handle) {
  if (n_rows <= 0) return 0;
  if (width <= 0 || width % 64) return (int)cudaErrorInvalidValue;
  const int grid = (n_rows + kMd5Threads - 1) / kMd5Threads;
  match_md5_kernel<<<grid, kMd5Threads, 0, (cudaStream_t)stream_handle>>>(
      stream, len, n_rows, width, digest);
  return (int)cudaGetLastError();
}

}  // extern "C"
