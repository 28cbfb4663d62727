// Density-peaks clustering kernels for Hopper (sm_90a), on the tensor cores.
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
//                    rho[j] > rho[i], or rho[j] == rho[i] and j < i.
//                    delta[i] = its distance, parent[i] = its index, the
//                    lowest index among equal distances; delta = 3.0e38
//                    and parent = -1 when none qualifies.  The launcher
//                    takes the rows already in density order (rho
//                    descending, index ascending; ops/cluster.py sorts and
//                    gathers them, and scatters the results back), so
//                    "j is denser than i" is "j comes before i".
//
// Design.  The TPU computes a tile's distances on its matrix unit as
// pop_i + pop_j - 2 * (a_i . a_j) over 0/1 bf16 bit rows.  Here the
// distance comes whole out of Hopper's 1-bit tensor-core product,
// mma.sync m16n8k256 .b1 .and.popc (D += popc(a & b) over 256 bits, the
// SASS BMMA.168256.AND.POPC): hamming(a, b) = popc(a & ~b) + popc(~a & b),
// two products a k-step, two k-steps for 512 bits.  (.xor.popc is lowered
// by ptxas to two BMMA.AND plus logic on this target, so it is not used.)
// The 1-bit operands are the packed words themselves: nothing is unpacked.
// Thread (g, t) of a warp feeds words 4t..4t+3 of its rows to both the A
// and the B fragment, the same k positions on both sides, so the product
// sums over every bit once whatever the bit order inside the fragment.
//
// A block owns 128 consecutive rows; each of its 4 warps owns 32 of them
// (two m16 tiles), whose packed words and their complements stay in
// registers for the whole walk.  The block walks the column rows in tiles
// of 128 rows (8 KB packed), staged in a 3-stage ring of shared memory by
// cp.async, so the next tiles load while this one multiplies; every row
// is read from L2 once per block, packed (64 B), never as 512 int8.  A
// warp reads its B fragment as one 16-byte load a thread, and the 8
// threads of each quarter-warp read 128 consecutive bytes: no bank
// conflicts.  The four products of the two m16 tiles are issued phase by
// phase so their accumulator chains interleave.  The threshold count and
// the masked arg-min are fused into the epilogue of each 16 x 8 product
// tile, so the N x N matrix is never stored, and each thread keeps its
// rows' partial results in registers across the whole walk; they are
// reduced across the quad with shuffles once at the end.  No atomics and
// no second pass.
//
// cluster_counts walks the full square.  The product accumulates onto
// C = -(thr + 1), with thr the integer threshold below, so a pair counts
// when the sign bit of D is set: one LEA.HI a pair.  Columns past n are
// zero rows, at distance pop_i from row i; rather than masking them in
// the loop, each row subtracts their number once at the end when
// pop_i <= thr.  The float comparison (float)d <= radius of an integer
// d in [0, 512] is exactly d <= thr with thr = floor(radius) clamped to
// [-1, 1024] (fmaxf drops a NaN radius to -1: nothing counts, as a NaN
// comparison is false; +-inf clamp to 1024 and -1).
//
// cluster_parent walks the triangle: row tile t against column tiles
// 0..t, all columns of tiles < t qualify, and the diagonal tile masks
// column position >= row position.  That is each unordered pair once.
// Block b walks row tile T-1-b and then row tile b, so every block walks
// T + 1 column tiles and the triangle's tail is as short as the square's.
// Each pair's key is (d << 21) | j with j the row's ORIGINAL index (staged
// beside the tile), masked to all ones where j does not qualify; the
// minimum key is the smallest distance and, among equal distances, the
// lowest original index -- the Pallas rule.  d <= 512 needs 10 bits, so
// the 32-bit key holds for n <= 2^21; above that the wrapper asks for the
// 64-bit key (d << 32) | j, whose running minimum is a two-word compare
// and select where the 32-bit one is a single min (PERF.md times both).
//
// What bounds it on this card.  The floor is the tensor cores' 1-bit
// product rate (the data sheet gives none; chip_smoke.py's mma phase
// measures it with csrc/mma_rate.cu and prices each kernel's bound with
// it): each unordered pair once, and one .and.popc product a k-step,
// since hamming = pop_i + pop_j - 2 * popc(a & b) needs a single product
// per 256 bits.  That is N(N-1)/128 products for either function.  This
// design spends two products a k-step (popc(a & ~b) and popc(~a & b)):
// the parent kernel's triangle issues twice the floor's products, and
// the counts kernel, which walks the full square, four times.  PERF.md
// has the times against that bound; both kernels are well above twice
// it.  The next design takes one product a k-step and folds pop_i + pop_j
// in per element (ROADMAP.md).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;                  // uint4 a row: 16 words, 512 bits
constexpr int kTile = 128;               // rows a block, rows a staged tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = kTile / kWarps / 16; // m16 tiles a warp: 2
constexpr int kN8 = kTile / 8;           // n8 tiles a staged tile: 16
constexpr int kStages = 3;               // cp.async ring depth

static_assert(kTile * kVec % kThreads == 0, "tile copy splits evenly");

// ---- cp.async (16 bytes; src_bytes < 16 fills the rest with zeros)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- the 1-bit tensor-core product
//
// Fragments of mma.m16n8k256 .b1 (32 one-bit elements a register): A
// {a0, a1, a2, a3} = rows {g, g+8, g, g+8} at k chunks {t, t, 4+t, 4+t};
// B {b0, b1} = column g at k chunks {t, 4+t}; D {d0, d1, d2, d3} = (row g,
// col 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  Thread (g, t) puts word
// 4t+2s of its rows at chunk t and word 4t+2s+1 at chunk 4+t in k-step s,
// for A and B alike.

struct Rows {  // a thread's words 4t..4t+3 of rows g and g+8 of an m16 tile
  uint32_t lo[4];
  uint32_t hi[4];
};

__device__ __forceinline__ void bmma_init(int (&d)[4], const Rows& a,
                                          const uint32_t (&b)[4], int s,
                                          const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a.lo[2 * s]), "r"(a.hi[2 * s]), "r"(a.lo[2 * s + 1]),
        "r"(a.hi[2 * s + 1]), "r"(b[2 * s]), "r"(b[2 * s + 1]), "r"(c[0]),
        "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__device__ __forceinline__ void bmma_acc(int (&d)[4], const Rows& a,
                                         const uint32_t (&b)[4], int s) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.lo[2 * s]), "r"(a.hi[2 * s]), "r"(a.lo[2 * s + 1]),
        "r"(a.hi[2 * s + 1]), "r"(b[2 * s]), "r"(b[2 * s + 1]));
}

// d[m] = c + hamming(rows of m16 tile m, columns of the n8 tile):
// popc(a & ~b) + popc(~a & b).  The products are issued phase by phase
// across the kMT tiles so that their accumulator chains interleave; one
// tile's four products in a row would each wait for the last.
__device__ __forceinline__ void hamming_tiles(int (&d)[kMT][4],
                                              const Rows (&a)[kMT],
                                              const Rows (&na)[kMT],
                                              const uint32_t (&b)[4],
                                              const uint32_t (&nb)[4],
                                              const int (&c)[4]) {
#pragma unroll
  for (int m = 0; m < kMT; ++m) bmma_init(d[m], a[m], nb, 0, c);
#pragma unroll
  for (int m = 0; m < kMT; ++m) bmma_acc(d[m], a[m], nb, 1);
#pragma unroll
  for (int m = 0; m < kMT; ++m) bmma_acc(d[m], na[m], b, 0);
#pragma unroll
  for (int m = 0; m < kMT; ++m) bmma_acc(d[m], na[m], b, 1);
}

// ---- block set-up shared by both kernels

// Load the warp's rows (zero past n) and their complements.
__device__ __forceinline__ void load_rows(const uint4* __restrict__ rows,
                                          int row0, int n, Rows (&a)[kMT],
                                          Rows (&na)[kMT]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + m * 16 + h * 8 + g;
      const uint4 v = (r < n) ? rows[(size_t)r * kVec + t] : make_uint4(0, 0, 0, 0);
      uint32_t* w = h ? a[m].hi : a[m].lo;
      uint32_t* nw = h ? na[m].hi : na[m].lo;
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) nw[k] = ~w[k];
    }
  }
}

// Stage rows j0 .. j0+kTile-1 of `rows` (zero past n) into `tile`.
__device__ __forceinline__ void stage_rows(const uint4* __restrict__ rows,
                                           int j0, int n, uint4* tile) {
#pragma unroll
  for (int k = 0; k < kTile * kVec / kThreads; ++k) {
    const int q = (int)threadIdx.x + k * kThreads;
    const int r = j0 + q / kVec;
    const bool in = r < n;
    cp_async16(tile + q, rows + (in ? (size_t)r * kVec + q % kVec : 0),
               in ? 16 : 0);
  }
}

// The B fragment of n8 tile nt of a staged tile (words 4t..4t+3 of column
// row g), and its complement.
__device__ __forceinline__ void load_cols(const uint4* tile, int nt,
                                          uint32_t (&b)[4], uint32_t (&nb)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 v = tile[(nt * 8 + g) * kVec + t];
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
#pragma unroll
  for (int k = 0; k < 4; ++k) nb[k] = ~b[k];
}

// Four registers holding v that the compiler cannot merge, so the
// products' C quad is built once, not on every use.
__device__ __forceinline__ void quad_of(int v, int (&q)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) asm volatile("mov.b32 %0, %1;" : "=r"(q[k]) : "r"(v));
}

__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- cluster_counts

__global__ void __launch_bounds__(kThreads)
cluster_counts_kernel(const uint4* __restrict__ rows, int n, int thr,
                      int32_t* __restrict__ rho) {
  __shared__ uint4 ring[kStages][kTile * kVec];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (int)blockIdx.x * kTile + (int)(threadIdx.x >> 5) * (kMT * 16);
  Rows a[kMT], na[kMT];
  load_rows(rows, row0, n, a, na);
  int bias[4];  // D < 0  <=>  hamming <= thr
  quad_of(-(thr + 1), bias);
  int cnt[kMT][2] = {};
  const int ntiles = (n + kTile - 1) / kTile;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage_rows(rows, s * kTile, n, ring[s]);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k is in; every warp is done with tile k - 1
    const int next = k + kStages - 1;
    if (next < ntiles) stage_rows(rows, next * kTile, n, ring[next % kStages]);
    cp_async_commit();
    const uint4* tile = ring[k % kStages];
#pragma unroll 2
    for (int nt = 0; nt < kN8; ++nt) {
      uint32_t b[4], nb[4];
      load_cols(tile, nt, b, nb);
      int d[kMT][4];
      hamming_tiles(d, a, na, b, nb, bias);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const uint32_t* e = reinterpret_cast<const uint32_t*>(d[m]);
        cnt[m][0] += (int)((e[0] >> 31) + (e[1] >> 31));
        cnt[m][1] += (int)((e[2] >> 31) + (e[3] >> 31));
      }
    }
  }
  cp_async_wait<0>();

  // columns past n were zero rows, at distance pop_i from row i
  const int zero_rows = ntiles * kTile - n;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* w = h ? a[m].hi : a[m].lo;
      const int c = quad_sum(cnt[m][h]);
      const int p = quad_sum(__popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]));
      const int r = row0 + m * 16 + h * 8 + g;
      if (t == 0 && r < n) rho[r] = c - (p <= thr ? zero_rows : 0);
    }
  }
}

// ---- cluster_parent

template <typename Key>
struct KeyCodec {
  static constexpr int kShift = sizeof(Key) == 4 ? 21 : 32;
  static constexpr Key kNone = ~Key(0);
  static __device__ __forceinline__ Key make(int d, int j) {
    return ((Key)(uint32_t)d << kShift) | (Key)(uint32_t)j;
  }
};

__device__ __forceinline__ uint32_t shfl_min(uint32_t v, int lane_mask) {
  return min(v, __shfl_xor_sync(0xffffffffu, v, lane_mask));
}
__device__ __forceinline__ unsigned long long shfl_min(unsigned long long v,
                                                       int lane_mask) {
  return min(v, __shfl_xor_sync(0xffffffffu, v, lane_mask));
}

template <typename Key, bool kDiagonal>
__device__ __forceinline__ void parent_tile(const uint4* tile,
                                            const int32_t* orig, int col0,
                                            int row0, const Rows (&a)[kMT],
                                            const Rows (&na)[kMT],
                                            Key (&best)[kMT][2]) {
  using C = KeyCodec<Key>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int zero[4] = {0, 0, 0, 0};
#pragma unroll 2
  for (int nt = 0; nt < kN8; ++nt) {
    uint32_t b[4], nb[4];
    load_cols(tile, nt, b, nb);
    const int2 j = *reinterpret_cast<const int2*>(orig + nt * 8 + 2 * t);
    int d[kMT][4];
    hamming_tiles(d, a, na, b, nb, zero);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      Key k0 = C::make(d[m][0], j.x), k1 = C::make(d[m][1], j.y);
      Key k2 = C::make(d[m][2], j.x), k3 = C::make(d[m][3], j.y);
      if (kDiagonal) {  // only earlier positions are denser
        const int c = col0 + nt * 8 + 2 * t;
        const int r = row0 + m * 16 + g;
        if (c >= r) k0 = C::kNone;
        if (c + 1 >= r) k1 = C::kNone;
        if (c >= r + 8) k2 = C::kNone;
        if (c + 1 >= r + 8) k3 = C::kNone;
      }
      best[m][0] = min(best[m][0], min(k0, k1));
      best[m][1] = min(best[m][1], min(k2, k3));
    }
  }
}

// Row tile rt of the triangle: its rows against column tiles 0..rt.
template <typename Key>
__device__ __forceinline__ void parent_row_tile(
    const uint4* __restrict__ rows, const int32_t* __restrict__ order, int n,
    int rt, uint4 (*ring)[kTile * kVec], int32_t (*orig)[kTile],
    float* __restrict__ delta, int32_t* __restrict__ parent) {
  using C = KeyCodec<Key>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = rt * kTile + (int)(threadIdx.x >> 5) * (kMT * 16);
  Rows a[kMT], na[kMT];
  load_rows(rows, row0, n, a, na);
  Key best[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m) best[m][0] = best[m][1] = C::kNone;
  const int ntiles = rt + 1;

  auto stage = [&](int k) {
    const int j0 = k * kTile, s = k % kStages;
    stage_rows(rows, j0, n, ring[s]);
    if (threadIdx.x < kTile / 4) {  // 4 original indices a thread
      const int j = j0 + 4 * (int)threadIdx.x;
      const int bytes = n - j >= 4 ? 16 : max(0, (n - j) * 4);
      cp_async16(&orig[s][4 * threadIdx.x], order + (bytes ? j : 0), bytes);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k + kStages - 1 < ntiles) stage(k + kStages - 1);
    cp_async_commit();
    const int s = k % kStages;
    if (k < rt) {
      parent_tile<Key, false>(ring[s], orig[s], k * kTile, row0, a, na, best);
    } else {
      parent_tile<Key, true>(ring[s], orig[s], k * kTile, row0, a, na, best);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Key k = shfl_min(shfl_min(best[m][h], 1), 2);
      const int r = row0 + m * 16 + h * 8 + g;
      if (t == 0 && r < n) {
        const bool none = k == C::kNone;
        delta[r] = none ? 3.0e38f : (float)(uint32_t)(k >> C::kShift);
        parent[r] = none ? -1 : (int32_t)(k & (((Key)1 << C::kShift) - 1));
      }
    }
  }
}

// Block b walks row tile T-1-b (T-b column tiles) and then row tile b
// (b+1 column tiles): every block walks T+1 tiles, so the triangle's work
// is even across the blocks.
template <typename Key>
__global__ void __launch_bounds__(kThreads)
cluster_parent_kernel(const uint4* __restrict__ rows,
                      const int32_t* __restrict__ order, int n,
                      float* __restrict__ delta, int32_t* __restrict__ parent) {
  __shared__ uint4 ring[kStages][kTile * kVec];
  __shared__ __align__(16) int32_t orig[kStages][kTile];
  const int last = (n - 1) / kTile, b = (int)blockIdx.x;
  parent_row_tile<Key>(rows, order, n, last - b, ring, orig, delta, parent);
  if (b < last - b) {
    __syncthreads();  // every warp is done with the ring
    parent_row_tile<Key>(rows, order, n, b, ring, orig, delta, parent);
  }
}

inline int row_tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Launchers: plain C interface for ctypes.  Each launches on the given
// stream of the calling thread's current device (the caller makes the
// tensors' device current), does not synchronise, and returns
// cudaGetLastError() (0 = launched).  Row pointers must be 16-byte
// aligned and n > 0.
extern "C" {

int cluster_counts(const int32_t* packed, int32_t n, float radius,
                   int32_t* rho, void* stream) {
  // (float)d <= radius  <=>  d <= thr, for every integer d in [0, 512]
  const int thr = (int)fminf(fmaxf(floorf(radius), -1.0f), 1024.0f);
  cluster_counts_kernel<<<row_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(packed), n, thr, rho);
  return (int)cudaGetLastError();
}

// `rows` in density order and `order` their original indices (16-byte
// aligned); delta and parent are written in that order, parent as an
// original index.  wide_key = 0 takes the 32-bit key (n <= 2^21 only),
// otherwise the 64-bit one.
int cluster_parent(const int32_t* rows, const int32_t* order, int32_t n,
                   int32_t wide_key, float* delta, int32_t* parent,
                   void* stream) {
  const auto* r = reinterpret_cast<const uint4*>(rows);
  const int pairs = (row_tiles(n) + 1) / 2;  // row tiles t and T-1-t a block
  if (!wide_key) {
    cluster_parent_kernel<uint32_t>
        <<<pairs, kThreads, 0, (cudaStream_t)stream>>>(r, order, n, delta, parent);
  } else {
    cluster_parent_kernel<unsigned long long>
        <<<pairs, kThreads, 0, (cudaStream_t)stream>>>(r, order, n, delta, parent);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
