// Tensor-core rate probe for Hopper (sm_90a): how many mma.sync products
// the card issues a second.  Not part of the kernels' library and on no
// path: chip_smoke.py builds it on its own and times it.  The 1-bit
// .and.popc rate prices the cluster kernels' bound (the data sheet gives
// no 1-bit rate); the int8 rate is the product the cluster kernels would
// have used on 0/1 planes; the .xor.popc rate shows why they do not use
// it (ptxas lowers it to two BMMA.AND plus logic on this target).
//
// Each warp issues `iters` rounds of 8 independent products on register
// operands; the host times a launch and divides.  Variant 0: int8
// m16n8k32; 1: b1 m16n8k256 .and.popc; 2: b1 m16n8k256 .xor.popc.
//
// Beside it, the cycles of one md5 round on one thread (md5_round_cycles):
// rounds run back to back, each waiting on the one before, timed with
// clock64, so that the card's own latency a round stands beside
// chip_smoke.py's MD5_CHAIN_OPS x DEPENDENT_OP_CYCLES.  Variant 0 is
// csrc/md5.cu's round (a + x + k summed off the chain); 1 sums a + F + x
// + k as written, as that kernel did before.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int kVariant>
__global__ void __launch_bounds__(256)
mma_rate_kernel(uint32_t seed, int iters, int32_t* __restrict__ out) {
  constexpr int kU = 8;
  uint32_t a[4], b[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = seed * (threadIdx.x + 3 * k + 1);
#pragma unroll
  for (int k = 0; k < 2; ++k) b[k] = seed ^ (threadIdx.x * 7 + k);
  int c[kU][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if constexpr (kVariant == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else if constexpr (kVariant == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) sum += c[u][0] + c[u][1] + c[u][2] + c[u][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) { return __funnelshift_l(x, x, s); }

template <int kVariant>
__device__ __forceinline__ uint32_t md5_f_round(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                                uint32_t x, uint32_t k, int s) {
  const uint32_t f = ((c ^ d) & b) ^ d;
  if constexpr (kVariant == 0) return b + rotl(opaque(a + x + k) + f, s);
  return b + rotl(a + f + x + k, s);
}

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (int64_t)t;
}

// one thread: `iters` x 4 dependent md5 rounds; out[0] the cycles, out[1]
// the nanoseconds they took (%globaltimer), out[2] the state (kept live)
template <int kVariant>
__global__ void md5_round_kernel(uint32_t seed, int iters, int64_t* __restrict__ out) {
  uint32_t a = seed, b = seed * 3u + 1u, c = seed * 5u + 2u, d = seed * 7u + 3u;
  const int64_t ns0 = global_ns();
  const int64_t t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const uint32_t x = (uint32_t)it * 0x9e3779b9u;
    a = md5_f_round<kVariant>(a, b, c, d, x, 0xd76aa478u, 7);
    d = md5_f_round<kVariant>(d, a, b, c, x ^ 1u, 0xe8c7b756u, 12);
    c = md5_f_round<kVariant>(c, d, a, b, x ^ 2u, 0x242070dbu, 17);
    b = md5_f_round<kVariant>(b, c, d, a, x ^ 3u, 0xc1bdceeeu, 22);
  }
  const int64_t t1 = clock64();
  const int64_t ns1 = global_ns();
  out[0] = t1 - t0;
  out[1] = ns1 - ns0;
  out[2] = (int64_t)(a ^ b ^ c ^ d);
}

}  // namespace

extern "C" {

// md5_round_kernel<variant> on one thread of the current device, out[3]
// (the cycles and nanoseconds of iters x 4 rounds, the state); returns
// cudaGetLastError().
int md5_round_cycles(int variant, int iters, int64_t* out, void* stream) {
  auto s = (cudaStream_t)stream;
  if (variant == 0) {
    md5_round_kernel<0><<<1, 1, 0, s>>>(12345u, iters, out);
  } else {
    md5_round_kernel<1><<<1, 1, 0, s>>>(12345u, iters, out);
  }
  return (int)cudaGetLastError();
}

// `blocks` blocks of 256 threads on the given stream of the current
// device, out[blocks * 256]; returns cudaGetLastError() (0 = launched).
int mma_rate(int variant, int iters, int blocks, int32_t* out, void* stream) {
  auto s = (cudaStream_t)stream;
  if (variant == 0) {
    mma_rate_kernel<0><<<blocks, 256, 0, s>>>(12345u, iters, out);
  } else if (variant == 1) {
    mma_rate_kernel<1><<<blocks, 256, 0, s>>>(12345u, iters, out);
  } else {
    mma_rate_kernel<2><<<blocks, 256, 0, s>>>(12345u, iters, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
