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

}  // namespace

extern "C" {

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
