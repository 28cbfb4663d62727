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
// What it computes: each row's n = len[row] bytes, padded as the JAX
// code pads them.  Bytes at or past n read as zero (the stream's bytes
// there need not be zero), 0x80 goes at byte n, and word 14 of block
// floor((n + 72) / 64) - 1 is the bit length (uint32: n * 8 wraps as the
// JAX code's does; word 15 stays zero).  A row walks floor((n + 72) / 64)
// blocks, never more than the W / 64 + 1 of the JAX scan (blocks past
// the stream's W bytes hold no stream byte).  Output: the four state
// words per row, little-endian, as int64 [B, 4] holding the uint32
// values, exactly as the plain md5_words returns them (PyTorch for the
// CPU has no uint32).  The launch needs no host read of the lengths.
//
// Bound: each row's padded bytes read once and ~9 32-bit operations a
// round are far below a microsecond at the worker's shapes.  MD5's chain
// cannot be split inside a row, so what bounds a call is latency: the
// longest row's blocks x 64 dependent rounds, each round F, one add and
// the rotate with its add after the independent a + x + k (chip_smoke.py's
// MD5_CHAIN_OPS; STEP below keeps a + x + k off the chain).  At the
// worker's calls the longest row is ~25 blocks.
//
// Design: one thread a row runs the chain, and what would stand between
// one block's rounds and the next (a trip to device memory for the
// block's 64 bytes, then the compare and mask of all 16 words against
// the length) is kept off it.
//   - A block of kThreads threads takes kRows rows: warp 0 consumes (a
//     lane a row, the 64 rounds), warp 1 produces.
//   - The rows are staged through a ring of kStages stages in shared
//     memory.  A stage holds the next chunk of kChunkBlocks 64-byte
//     blocks of each of the block's rows, kRowStride bytes apart (16
//     bytes more than a chunk, so a quarter warp's 16-byte loads of 8
//     rows fall in distinct banks).
//   - The producer warp keeps copies in flight: for each chunk a lane
//     issues one cp.async.bulk of its row's chunk from global to shared
//     memory (contiguous and 16-byte aligned: no tensor map), and lane 0
//     arms the stage's "full" mbarrier with the chunk's byte count.  The
//     consumer runs the rounds of chunk c while chunks c + 1 .. are being
//     copied, and hands the stage back on its "empty" mbarrier.
//   - Copies stop at the row's end: a row's chunk is copied only up to
//     its last block that holds a byte below n within W (a row of length
//     0 or below copies nothing).
//   - Full blocks (base + 64 <= n, within W) go to the rounds straight
//     from shared memory, unmasked.  Only the row's last one or two
//     message blocks are built with the padding (pad_block, in
//     registers and without a branch), and one md5_block call site
//     serves both, so that lanes at different blocks of their rows never
//     split the warp's rounds.
//   - Both warps read the block's 32 lengths and agree, with a warp
//     reduction each, on the chunks to walk: the longest row's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                         // rows a block: a lane of the consumer warp each
constexpr int kThreads = 64;                      // the consumer warp, then the producer warp
constexpr int kChunkBlocks = 4;                   // 64-byte message blocks of a row a stage holds
constexpr int kChunkBytes = 64 * kChunkBlocks;
constexpr int kStages = 2;
constexpr int kRowStride = kChunkBytes + 16;      // a row's chunk in a stage, then 16 bytes apart
constexpr int kStageBytes = kRows * kRowStride;
constexpr uint32_t kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------------
// mbarriers and the bulk copy (PTX)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies before the
// phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "MD5_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra MD5_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// MD5

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);
}

#define F(b, c, d) ((((c) ^ (d)) & (b)) ^ (d))
#define G(b, c, d) ((((b) ^ (c)) & (d)) ^ (c))
#define H(b, c, d) ((b) ^ (c) ^ (d))
#define I(b, c, d) ((c) ^ ((b) | ~(d)))
// a + x + k does not wait on the round before (a is the state word of
// three rounds back): it is summed first, and hidden from the compiler's
// reassociation, which would otherwise add F to a + x and k after it.  A
// round's dependent chain is then F, one add, and the rotate with its add
// (LOP3, IADD3, LEA.HI on sm_90a).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm("" : "+r"(v));
  return v;
}

#define STEP(f, a, b, c, d, x, k, s) \
  a = b + rotl(opaque((a) + (x) + (k)) + f(b, c, d), s)

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

// A row of n bytes in a stream of `width` bytes, in 64-byte blocks.
struct RowPlan {
  int blocks;  // walked: floor((n + 72) / 64), at most width / 64 + 1
  int full;    // leading blocks wholly below n within the width: hashed as they are
  int copied;  // leading blocks that hold a byte below n within the width: staged
  int last;    // the block that holds the bit length (none of the walked if >= blocks)
};

__device__ __forceinline__ RowPlan plan_row(int64_t n, int32_t width) {
  const int64_t stream_blocks = width / 64;
  // the padded message's floor((n + 9 + 63) / 64) blocks (floor division)
  const int64_t padded = n + 72;
  const int64_t msg = padded >= 0 ? padded / 64 : -((63 - padded) / 64);
  const int64_t whole = n > 0 ? n / 64 : 0;
  const int64_t touched = n > 0 ? (n + 63) / 64 : 0;
  RowPlan p;
  p.blocks = (int)(msg < 0 ? 0 : (msg > stream_blocks + 1 ? stream_blocks + 1 : msg));
  p.full = (int)(whole < stream_blocks ? whole : stream_blocks);
  p.copied = (int)(touched < stream_blocks ? touched : stream_blocks);
  p.last = (int)(msg - 1);
  return p;
}

// Block `blk` of a row of n bytes as the padded message has it: the
// words' bytes at or past n cleared, 0x80 at byte n, and the bit length
// in word 14 of the last block.  Without a branch: lanes of a warp reach
// their tails at different blocks, and a branch would run every lane's
// padding, masked, once for each.
__device__ __forceinline__ void pad_block(uint32_t x[16], int64_t n, int blk, int last,
                                          uint32_t bitlen) {
  const int64_t rel = n - (int64_t)blk * 64;  // the block's bytes below the length
  const int r = (int)(rel < -4 ? -4 : (rel > 68 ? 68 : rel));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = r - 4 * i;  // bytes of word i below the length
    const int kept = k < 0 ? 0 : (k > 4 ? 4 : k);
    const int marker_at = k < 0 ? 4 : kept;  // byte 4: no marker in this word
    // (shifts by 32 clamp to 32: all bits shifted out)
    x[i] = (x[i] & ~__funnelshift_lc(0u, ~0u, 8 * kept)) |
           __funnelshift_lc(0u, 0x80u, 8 * marker_at);
  }
  if (blk == last) x[14] = bitlen;
}

// stream uint8 [B, width] (width % 64 == 0, 16-byte aligned rows),
// len int32 [B] -> digest int64 [B, 4]
__global__ void __launch_bounds__(kThreads)
match_md5_kernel(const uint8_t* __restrict__ stream, const int32_t* __restrict__ len,
                 int32_t n_rows, int32_t width, int64_t* __restrict__ digest) {
  __shared__ __align__(128) uint8_t ring[kStages][kStageBytes];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x >= kRows;
  if (threadIdx.x == kRows) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);   // the producer's arrive, then the copies' bytes
      mbar_init(&empty_bar[s], 1);  // the consumer warp's arrive
    }
    mbar_init_fence();
  }
  __syncthreads();

  // lane i of either warp holds row i of the block
  const int row = blockIdx.x * kRows + lane;
  const bool valid = row < n_rows;
  const int64_t n = valid ? len[row] : 0;
  RowPlan p = plan_row(n, width);
  if (!valid) p.blocks = p.full = p.copied = 0;
  const int max_blocks = __reduce_max_sync(kFullMask, p.blocks);
  const int chunks = (max_blocks + kChunkBlocks - 1) / kChunkBlocks;

  if (producer) {
    const uint8_t* src = stream + (size_t)row * width;
    const int copy_end = p.copied * 64;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait(&empty_bar[s], ((c / kStages) & 1) ^ 1);
      const int off = c * kChunkBytes;
      const int left = copy_end - off;
      const int bytes = left <= 0 ? 0 : (left < kChunkBytes ? left : kChunkBytes);
      const int total = __reduce_add_sync(kFullMask, bytes);
      if (lane == 0) mbar_arrive_expect_tx(&full_bar[s], (uint32_t)total);
      __syncwarp();
      if (bytes > 0) {
        bulk_copy_to_shared(&ring[s][lane * kRowStride], src + off, (uint32_t)bytes,
                            &full_bar[s]);
      }
    }
    return;
  }

  const uint32_t bitlen = (uint32_t)n * 8u;
  uint32_t st[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full_bar[s], (c / kStages) & 1);
    const uint8_t* staged = &ring[s][lane * kRowStride];
#pragma unroll 1
    for (int j = 0; j < kChunkBlocks; ++j) {
      const int blk = c * kChunkBlocks + j;
      if (blk >= p.blocks) break;
      uint32_t x[16];
      if (blk < p.copied) {
        const uint4* q = reinterpret_cast<const uint4*>(staged + j * 64);
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
      if (blk >= p.full) pad_block(x, n, blk, p.last, bitlen);
      md5_block(st, x);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[s]);
  }
  if (valid) {
    int64_t* out = digest + (size_t)row * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (int64_t)st[i];
  }
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
  const int grid = (n_rows + kRows - 1) / kRows;
  match_md5_kernel<<<grid, kThreads, 0, (cudaStream_t)stream_handle>>>(
      stream, len, n_rows, width, digest);
  return (int)cudaGetLastError();
}

}  // extern "C"
