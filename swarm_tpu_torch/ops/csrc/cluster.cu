// Density-peaks clustering kernels for Hopper (sm_90a).
//
// These replace the two Pallas kernels of the JAX package:
//   cluster_counts  <- swarm_tpu/ops/cluster.py  _counts_kernel  (_pallas_counts)
//   cluster_parent  <- swarm_tpu/ops/cluster.py  _parent_kernel  (_pallas_parent)
//
// What they compute, over N fingerprints of 512 bits (16 packed 32-bit
// words a row, the uint32 words passed as int32):
//   cluster_counts:  rho[i] = #{ j < n : hamming(i, j) <= radius }, self
//                    included; the comparison is made in float, as the
//                    JAX code makes it.
//   cluster_parent:  the nearest strictly denser row: j qualifies when
//                    rho[j] > rho[i], or rho[j] == rho[i] and j < i, and
//                    j < n, j != i.  delta[i] = its distance, parent[i] =
//                    its index, the lowest index among equal distances;
//                    delta = 3.0e38 and parent = -1 when none qualifies.
//
// Design.  The TPU computes a tile's distances on its matrix unit as
// pop_i + pop_j - 2 * (a_i . a_j) over 0/1 bf16 bit rows.  Here the
// distance is sum_w __popc(a[w] ^ b[w]) on the packed words, which gives
// the same exact integers without unpacking.  One thread owns one row i
// and keeps its 16 words in registers; a block of 128 threads walks all
// j in tiles of 128 rows staged in shared memory (8 KB).  That loop
// inside the block replaces the TPU's sequential j grid axis, so the
// N x N matrix is never stored, and there are no atomics and no second
// pass across blocks.  Every thread of a block reads the same staged row
// at the same time, so the shared-memory reads are broadcasts.
// cluster_parent walks j in ascending order and updates its running
// minimum only on a strictly smaller distance, which reproduces the
// lowest-index tie-break of the Pallas kernel (first index inside a
// tile, strict < across tiles).  rho arrives as int32; the JAX code
// compares it as f32, which is exact for N < 2^24, so the results are
// equal.
//
// What bounds it on this card.  The kernels are bound by the popc rate:
// 16 popc per pair, and about 16 popc per clock per SM, so at N = 65,536
// one pass is 6.9e10 popc, roughly 20 ms on 132 SMs (an estimate from
// the code and the data sheet).  The least time for the same work is set
// by the tensor cores on the 0/1 bit planes, which int8 mma with int32
// accumulation computes exactly: distance is symmetric, so either
// function needs each unordered pair once (for cluster_parent, of two
// rows exactly one is the denser), 512 * N * (N - 1) = 2.2e12 int8
// operations, about 1.1 ms at 1,979 TOP/s.  A tensor-core design (an
// int8 or b1 mma of the bit planes with the threshold and arg-min fused
// into the epilogue) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;      // uint4 per row: 16 words, 512 bits
constexpr int kBlock = 128;  // threads a block = rows a staged tile

__device__ __forceinline__ void load_row(const uint4* __restrict__ rows,
                                         int r, int n, uint4 (&out)[kVec]) {
  if (r < n) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) out[v] = rows[(size_t)r * kVec + v];
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) out[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Stage rows j0 .. j0+kBlock-1 (zero past n) into shared memory; each
// thread copies kVec of the tile's kBlock * kVec uint4, neighbouring
// threads on neighbouring addresses.
__device__ __forceinline__ void stage_tile(const uint4* __restrict__ rows,
                                           int j0, int n,
                                           uint4 (*tile)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int q = (int)threadIdx.x + k * kBlock;
    const int r = q / kVec;
    const int v = q % kVec;
    tile[r][v] = (j0 + r < n) ? rows[(size_t)(j0 + r) * kVec + v]
                              : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ int hamming(const uint4 (&a)[kVec],
                                       const uint4 (&b)[kVec]) {
  int d = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    d += __popc(a[v].x ^ b[v].x) + __popc(a[v].y ^ b[v].y) +
         __popc(a[v].z ^ b[v].z) + __popc(a[v].w ^ b[v].w);
  }
  return d;
}

__global__ void __launch_bounds__(kBlock)
cluster_counts_kernel(const uint4* __restrict__ rows, int n, float radius,
                      int32_t* __restrict__ rho) {
  __shared__ uint4 tile[kBlock][kVec];
  const int i = (int)(blockIdx.x * kBlock + threadIdx.x);
  uint4 a[kVec];
  load_row(rows, i, n, a);
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    __syncthreads();
    stage_tile(rows, j0, n, tile);
    __syncthreads();
    const int jn = min(kBlock, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      uint4 b[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) b[v] = tile[jj][v];
      count += ((float)hamming(a, b) <= radius) ? 1 : 0;
    }
  }
  if (i < n) rho[i] = count;
}

__global__ void __launch_bounds__(kBlock)
cluster_parent_kernel(const uint4* __restrict__ rows,
                      const int32_t* __restrict__ rho, int n,
                      float* __restrict__ delta,
                      int32_t* __restrict__ parent) {
  __shared__ uint4 tile[kBlock][kVec];
  __shared__ int32_t rho_tile[kBlock];
  const int i = (int)(blockIdx.x * kBlock + threadIdx.x);
  uint4 a[kVec];
  load_row(rows, i, n, a);
  const int32_t rho_i = (i < n) ? rho[i] : 0;
  int dmin = 0x7fffffff;
  int pidx = -1;
  for (int j0 = 0; j0 < n; j0 += kBlock) {
    __syncthreads();
    stage_tile(rows, j0, n, tile);
    const int jr = j0 + (int)threadIdx.x;
    rho_tile[threadIdx.x] = (jr < n) ? rho[jr] : 0;
    __syncthreads();
    const int jn = min(kBlock, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const int j = j0 + jj;
      const int32_t rho_j = rho_tile[jj];
      const bool denser = (rho_j > rho_i) || (rho_j == rho_i && j < i);
      uint4 b[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) b[v] = tile[jj][v];
      const int d = hamming(a, b);
      if (denser && j != i && d < dmin) {
        dmin = d;
        pidx = j;
      }
    }
  }
  if (i < n) {
    delta[i] = (pidx >= 0) ? (float)dmin : 3.0e38f;
    parent[i] = pidx;
  }
}

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Launchers: plain C interface for ctypes.  Each launches on the given
// stream of the calling thread's current device (the caller makes the
// tensors' device current), does not synchronise, and returns
// cudaGetLastError() (0 = launched).  `packed` must be 16-byte aligned
// and n > 0.
extern "C" {

int cluster_counts(const int32_t* packed, int32_t n, float radius,
                   int32_t* rho, void* stream) {
  cluster_counts_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(packed), n, radius, rho);
  return (int)cudaGetLastError();
}

int cluster_parent(const int32_t* packed, const int32_t* rho, int32_t n,
                   float* delta, int32_t* parent, void* stream) {
  cluster_parent_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(packed), rho, n, delta, parent);
  return (int)cudaGetLastError();
}

}  // extern "C"
