// The verdict lowering on the card (sm_90a): word-slot bits and scalars
// -> matcher, operation and template verdict planes with their
// three-valued uncertainty.
//
//   match_verdicts  <- swarm_tpu/ops/match.py eval_verdicts (:1807),
//                      full=True, which XLA fuses into one computation
//
// In eager PyTorch the lowering is one gather + reduce per power-of-two
// bucket at three levels (matcher -> operation -> template), plus the
// negated-slot buckets and the per-kind scalar, status, size and md5
// checks: hundreds of launches and [B, n, w] intermediate planes a
// batch.  Here it is two launches, a pack and an evaluation.
//
// Layout (built once per corpus, ops/match.py verdict_layout_np): each
// IndexBucket list becomes CSR, owner -> [off[o], off[o + 1]) into a
// member array, bucket padding (repeats of the first member) kept: it
// changes no any / all.  An owner in no bucket has an empty range.  Each
// matcher's kind and flags are one int of bits; the scalar program's
// one-hot check selection is a 7-bit mask per (matcher, conjunct), so
// a conjunct passes when OR_i(mask bit i & check i) holds, as the JAX
// code computes it, for a mask of any number of bits.  A conjunct's
// variable and a size matcher's stream come resolved to an index of
// the row's check sources (ops/match.py CHECK_SOURCES: each stream's
// length, then the status), so the orders of the streams and of the
// scalar variables are defined once, in Python.  m_rx maps a matcher
// to its column of the device-regex overlay, or -1.
//
// Design: rows in the bits of a word, corpus chunks across the grid, so
// that each layout entry is read once for 32 rows, every any / all is a
// word operation, and even 256 rows give the card hundreds of blocks.
//
// 1. match_verdicts_pack_kernel: the [B, ns] value and unc byte planes
//    (and the [B, n_rx] overlay) become row-sliced words [W, ns],
//    W = ceil(B / 32), bit r of word w the row 32 w + r, bits of rows at
//    B or above zero.  A thread a column reads its 32 rows (a warp reads
//    32 consecutive bytes a row) and writes one word; word w of all
//    columns is contiguous, so a block of the evaluation reads one
//    [ns] slice (41 KB for the synthetic corpus), which stays in L2.
// 2. match_verdicts_kernel: grid (w, chunk), the words on x, which is
//    not capped at 65,535.  A chunk is a contiguous range of templates;
//    ops/match.py verdict_chunks gives it, once per corpus, the range of
//    ops and of matchers it computes (the hull of those its templates
//    reach, and of those it owns) and the ranges it owns, which
//    partition the ops and matchers, so that every plane entry is
//    written by exactly one block.  Matchers, then operations,
//    then templates, split by __syncthreads, a thread an owner, the
//    words of the chunk's matchers, ops and templates in shared memory
//    (8 bytes an owner).  The per-row checks (scalar conjuncts, status,
//    size, md5) go a warp at a time: for each matcher of the warp that
//    has one, lane r checks row r against the check sources and digests
//    staged in shared memory, and a ballot makes the matcher's word.  The
//    outputs are written from the shared words by threads indexed
//    (row, owner), owner fastest, so each row's byte stores coalesce.
//
// Every member index is clamped as the JAX gather clamps it (negative
// from the end, then into [0, n - 1]).  The order of the JAX code is
// kept where it matters: the slot level assigns m_unc and the negated
// slots OR into it; the md5 fail-closed rule, the Kleene mask of scalar
// matchers, the residue and prefilter ORs, then the regex overlay
// overwrites m_value / m_unc, and only then is the negation applied;
// op_prefilter replaces op_unc with op_value.  Scalar checks compare
// float32 status and lengths against float32 constants.  m_value is
// written only when the caller asks for it (a corpus with workflow
// gates, which read it).
//
// Bound: the two [B, NS] slot planes and the layout read and the output
// planes written once.  What holds the kernel: the member gathers are
// dependent loads (offsets, then members, then words) that each thread
// waits on; the grid fills the card with chunks x words blocks even at
// 256 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPackThreads = 256;
constexpr int kVerdictThreads = 128;
// the row's check sources: the stream lengths, then the status
constexpr int kSources = 6;
constexpr int kStatusSource = kSources - 1;
// one chunk's ranges, in the order of ops/match.py CHUNK_FIELDS
constexpr int kChunkFields = 10;

// matcher flag bits, in the order of ops/match.py M_FLAG_BITS
constexpr int kMAnd = 1, kMNegative = 2, kMResidue = 4, kMMd5 = 8, kMWords = 16,
              kMRxPrefilter = 32, kMScalar = 64, kMStatus = 128, kMSize = 256;
// operation flag bits, in the order of ops/match.py OP_FLAG_BITS
constexpr int kOpAnd = 1, kOpPrefilter = 2;

// The corpus half, device pointers built once per corpus.  Field order
// is kernels.VerdictLayoutC's.
struct VerdictLayout {
  const int32_t* m_slot_off;     // [NM + 1]
  const int32_t* m_slot_idx;     // slot ids
  const int32_t* m_neg_off;      // [NM + 1]
  const int32_t* m_neg_idx;      // slot ids
  const int32_t* op_m_off;       // [NOP + 1]
  const int32_t* op_m_idx;       // matcher ids
  const int32_t* t_op_off;       // [NT + 1]
  const int32_t* t_op_idx;       // op ids
  const int32_t* m_flags;        // [NM] kM* bits
  const int32_t* op_flags;       // [NOP] kOp* bits
  const int32_t* m_rx;           // [NM] overlay column or -1
  const int32_t* scalar_src;     // [NM, C] check source index
  const float* scalar_cmp;       // [NM, C]
  const int32_t* scalar_mask;    // [NM, C] 7-bit check selection
  const int32_t* m_status;       // [NM, S]
  const int32_t* m_size;         // [NM, S]
  const int32_t* m_size_src;     // [NM] check source index
  const int32_t* m_md5;          // [NM, 4] uint32 bits
  const int32_t* chunks;         // [n_chunks, kChunkFields]
  int32_t nm, nop, nt, n_conj, n_status, n_rx, n_chunks, chunk_smem;
};

// The batch half, per call.
struct VerdictBatch {
  const uint32_t* vw;         // [W, ns] row-sliced value words (pack output)
  const uint32_t* uw;         // [W, ns] unc words
  const uint32_t* rvw;        // [W, n_rx] overlay value words, or null
  const uint32_t* ruw;        // [W, n_rx] overlay unc words
  const int32_t* src[kSources];  // int32 [B] each: the check sources
  const int64_t* digest;      // [B, 4] or null (fail closed)
  uint8_t* t_value;           // bool [B, NT]
  uint8_t* t_unc;
  uint8_t* op_value;          // bool [B, NOP]
  uint8_t* op_unc;
  uint8_t* m_value;           // bool [B, NM] or null (not wanted)
  uint8_t* m_unc;
  int32_t rows, ns;
};

__device__ __forceinline__ int clamped(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// any / all of one owner's members over a (value, unc) word pair, 32
// rows a bit; members clamped into [0, n), then read at j - base
struct Reduced {
  uint32_t all_v = ~0u, any_v = 0u, any_u = 0u;
  uint32_t any_vnu = 0u;   // some member certainly true: v & ~u
  uint32_t any_nvnu = 0u;  // some member certainly false: ~v & ~u
};

__device__ __forceinline__ Reduced reduce(const int32_t* idx, int lo, int hi, int n,
                                          int base, const uint32_t* v, const uint32_t* u) {
  Reduced r;
  for (int e = lo; e < hi; ++e) {
    const int j = clamped(__ldg(idx + e), n) - base;
    const uint32_t gv = v[j], gu = u[j];
    r.all_v &= gv;
    r.any_v |= gv;
    r.any_u |= gu;
    r.any_vnu |= gv & ~gu;
    r.any_nvnu |= ~gv & ~gu;
  }
  return r;
}

__device__ __forceinline__ bool scalar_check(int mask, float v, float c) {
  return ((mask & 1) && v == c) || ((mask & 2) && v != c) || ((mask & 4) && v < c) ||
         ((mask & 8) && v > c) || ((mask & 16) && v <= c) || ((mask & 32) && v >= c) ||
         (mask & 64);
}

// A warp's word of rows (lane r: row r, whose value is got) equal to
// one of matcher mt's n values of vals [NM, n], for any n: the values
// come 32 a pass, lane s loading value p + s, so each pass is one load
// round; a row's hits of all passes are OR-ed before the one ballot
__device__ __forceinline__ uint32_t any_value(const int32_t* vals, int mt, int n, int32_t got,
                                              int lane) {
  const int32_t* row = vals + (size_t)mt * n;
  bool ok = false;
  for (int p = 0; p < n; p += 32) {
    const int32_t want = p + lane < n ? __ldg(row + p + lane) : 0;
    const int cnt = min(32, n - p);
    for (int s = 0; s < cnt; ++s) ok |= got == __shfl_sync(kFullMask, want, s);
  }
  return __ballot_sync(kFullMask, ok);
}

// The bool planes the evaluation reads: value and unc [B, ns], and the
// overlay's [B, n_rx] pair or none.  Four planes, picked by a select
// chain on blockIdx.z (an array indexed at run time would spill).
struct PackArgs {
  const uint8_t* plane0;
  const uint8_t* plane1;
  const uint8_t* plane2;
  const uint8_t* plane3;
  uint32_t* words0;
  uint32_t* words1;
  uint32_t* words2;
  uint32_t* words3;
  int32_t rows, ns, n_rx;
};

// [rows, cols] bool plane -> [W, cols] row-sliced words; blockIdx.x = w,
// blockIdx.y the column block, blockIdx.z the plane (0, 1: the slot
// planes, 2, 3: the overlay)
__global__ void __launch_bounds__(kPackThreads)
match_verdicts_pack_kernel(const PackArgs a) {
  const int z = blockIdx.z;
  const int cols = z < 2 ? a.ns : a.n_rx;
  const int c = blockIdx.y * kPackThreads + threadIdx.x;
  if (c >= cols) return;
  const uint8_t* plane = z == 0 ? a.plane0 : z == 1 ? a.plane1 : z == 2 ? a.plane2 : a.plane3;
  uint32_t* words = z == 0 ? a.words0 : z == 1 ? a.words1 : z == 2 ? a.words2 : a.words3;
  const int r0 = blockIdx.x * 32;
  const int nr = min(32, a.rows - r0);
  const uint8_t* p = plane + (size_t)r0 * cols + c;
  uint32_t word = 0u;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (r < nr) word |= (uint32_t)(__ldg(p + (size_t)r * cols) != 0) << r;
  }
  words[(size_t)blockIdx.x * cols + c] = word;
}

// the owned range [lo, hi) of a word plane computed from base, written
// as bytes of the rows r0 + [0, nr) of a [B, n] plane: the block walks
// (row, owner) pairs, owner fastest, so a row's stores coalesce
__device__ __forceinline__ void write_plane(uint8_t* out, int n, int r0, int nr,
                                            const uint32_t* words, int base, int lo,
                                            int hi) {
  const int cnt = hi - lo;
  if (cnt <= 0) return;
  int r = threadIdx.x / cnt, i = threadIdx.x % cnt;
  while (r < nr) {
    out[(size_t)(r0 + r) * n + lo + i] = (uint8_t)((words[lo - base + i] >> r) & 1u);
    i += blockDim.x;
    while (i >= cnt) {
      i -= cnt;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kVerdictThreads)
match_verdicts_kernel(const VerdictLayout L, const VerdictBatch X) {
  extern __shared__ uint32_t chunk_words[];
  __shared__ int32_t src_s[kSources][32];
  __shared__ long long dig_s[32][4];
  // the chunk's fields, read again from here in each phase, so that no
  // value lives in a register across the phases
  __shared__ int32_t ch_s[kChunkFields];
  if (threadIdx.x < kChunkFields) {
    ch_s[threadIdx.x] = L.chunks[(size_t)blockIdx.y * kChunkFields + threadIdx.x];
  }
  const int w = blockIdx.x;
  {
    const int r0 = w * 32, nr = min(32, X.rows - r0);
    // the sources at constant indices: a parameter array indexed at run
    // time would go through local memory
#pragma unroll
    for (int s = 0; s < kSources; ++s) {
      for (int r = threadIdx.x; r < 32; r += blockDim.x) src_s[s][r] = r < nr ? X.src[s][r0 + r] : 0;
    }
    if (X.digest != nullptr) {
      for (int i = threadIdx.x; i < 32 * 4; i += blockDim.x) {
        const int r = i / 4;
        dig_s[r][i % 4] = r < nr ? X.digest[(size_t)(r0 + r) * 4 + i % 4] : 0;
      }
    }
  }
  __syncthreads();
  const uint32_t* vw = X.vw + (size_t)w * X.ns;
  const uint32_t* uw = X.uw + (size_t)w * X.ns;

  // --- matchers ---
  // A warp takes 32 matchers at a time, all its lanes in the loop, so
  // that the per-row checks can go a warp at a time: for each matcher
  // of the warp that has one, lane r evaluates row r and a ballot makes
  // the matcher's word.
  const int lane = threadIdx.x & 31;
  {
    const int m_lo = ch_s[6], m_hi = ch_s[7];
    uint32_t* mv = chunk_words;  // [m_hi - m_lo], then mu, ov, ou, tv, tu
    uint32_t* mu = mv + (m_hi - m_lo);
    for (int base = m_lo + (threadIdx.x & ~31); base < m_hi; base += blockDim.x) {
      const int m = base + lane;
      const bool live = m < m_hi;
      const int fl = live ? __ldg(L.m_flags + m) : 0;
      uint32_t scalar_ok = ~0u, status_ok = 0u, size_ok = 0u, md5_ok = ~0u;
      unsigned todo = __ballot_sync(kFullMask, fl & (kMScalar | kMStatus | kMSize | kMMd5));
      while (todo) {
        const int t = __ffs(todo) - 1;
        todo &= todo - 1;
        const int mt = base + t;
        const int ft = __shfl_sync(kFullMask, fl, t);
        if (ft & kMScalar) {
          // lane c holds conjunct c's selection, comparison and source,
          // loaded in one round; the conjuncts that pass on every row
          // (mask bit 6) are skipped
          int mask_c = 64, src_c = 0;
          float cmp_c = 0.f;
          if (lane < L.n_conj) {
            const int k = mt * L.n_conj + lane;
            mask_c = __ldg(L.scalar_mask + k);
            src_c = __ldg(L.scalar_src + k);
            cmp_c = __ldg(L.scalar_cmp + k);
          }
          unsigned real = __ballot_sync(kFullMask, !(mask_c & 64));
          uint32_t ok = ~0u;
          while (real) {
            const int c = __ffs(real) - 1;
            real &= real - 1;
            const int mask = __shfl_sync(kFullMask, mask_c, c);
            const float v = (float)src_s[__shfl_sync(kFullMask, src_c, c)][lane];
            ok &= __ballot_sync(kFullMask, scalar_check(mask, v, __shfl_sync(kFullMask, cmp_c, c)));
          }
          if (lane == t) scalar_ok = ok;
        }
        if (ft & kMStatus) {
          const uint32_t w = any_value(L.m_status, mt, L.n_status, src_s[kStatusSource][lane], lane);
          if (lane == t) status_ok = w;
        }
        if (ft & kMSize) {
          const int32_t got = src_s[__ldg(L.m_size_src + mt)][lane];
          const uint32_t w = any_value(L.m_size, mt, L.n_status, got, lane);
          if (lane == t) size_ok = w;
        }
        // md5 digest equality (without a digest the check fails closed, below)
        if ((ft & kMMd5) && X.digest != nullptr) {
          bool eq = true;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            eq &= dig_s[lane][i] == (long long)(uint32_t)__ldg(L.m_md5 + mt * 4 + i);
          }
          const uint32_t w = __ballot_sync(kFullMask, eq);
          if (lane == t) md5_ok = w;
        }
      }
      if (!live) continue;
      // slot reduction (vacuously true without slots); Kleene: a certain
      // hit decides OR, any miss decides AND
      uint32_t slot_red = ~0u, unc = 0u;
      const int s0 = __ldg(L.m_slot_off + m), s1 = __ldg(L.m_slot_off + m + 1);
      if (s1 > s0) {
        const Reduced r = reduce(L.m_slot_idx, s0, s1, X.ns, 0, vw, uw);
        const bool is_and = fl & kMAnd;
        slot_red = is_and ? r.all_v : r.any_v;
        const uint32_t decided = is_and ? ~r.all_v : r.any_vnu;
        unc = r.any_u & ~decided;
      }
      // negated slots: none may be present
      uint32_t neg_present = 0u, neg_decided_false = 0u;
      const int n0 = __ldg(L.m_neg_off + m), n1 = __ldg(L.m_neg_off + m + 1);
      if (n1 > n0) {
        const Reduced r = reduce(L.m_neg_idx, n0, n1, X.ns, 0, vw, uw);
        neg_present = r.any_v;
        neg_decided_false = r.any_vnu;
        unc |= r.any_u;
      }
      if ((fl & kMMd5) && X.digest == nullptr) unc = ~0u;
      uint32_t val = 0u;
      if (fl & kMWords) val = slot_red;
      if (fl & kMScalar) val = scalar_ok & slot_red & ~neg_present & md5_ok;
      if (fl & kMStatus) val = status_ok;
      if (fl & kMSize) val = size_ok;
      // Kleene over the scalar & slots & ~neg & md5 conjunction
      if (fl & kMScalar) unc &= scalar_ok & md5_ok & ~neg_decided_false;
      // residues and fired regex prefilters need host confirmation ...
      if (fl & (kMResidue | kMRxPrefilter)) unc |= val;
      // ... but for the matchers the device regex re-checked exactly
      if (X.rvw != nullptr) {
        const int r = __ldg(L.m_rx + m);
        if (r >= 0) {
          val = X.rvw[(size_t)w * L.n_rx + r];
          unc = X.ruw[(size_t)w * L.n_rx + r];
        }
      }
      // negation after uncertainty capture
      if (fl & kMNegative) val = ~val;
      mv[m - m_lo] = val;
      mu[m - m_lo] = unc;
    }
  }
  __syncthreads();

  // --- operations: Kleene AND / OR over their matchers ---
  {
    const int m_lo = ch_s[6], mc = ch_s[7] - m_lo, op_lo = ch_s[2], op_hi = ch_s[3];
    const uint32_t* mv = chunk_words;
    const uint32_t* mu = mv + mc;
    uint32_t* ov = chunk_words + 2 * mc;  // [op_hi - op_lo]
    uint32_t* ou = ov + (op_hi - op_lo);
    for (int o = op_lo + threadIdx.x; o < op_hi; o += blockDim.x) {
      const int fl = __ldg(L.op_flags + o);
      uint32_t val = 0u, unc = 0u;
      const int e0 = __ldg(L.op_m_off + o), e1 = __ldg(L.op_m_off + o + 1);
      if (e1 > e0) {
        const Reduced r = reduce(L.op_m_idx, e0, e1, L.nm, m_lo, mv, mu);
        const bool is_and = fl & kOpAnd;
        val = is_and ? r.all_v : r.any_v;
        const uint32_t decided = is_and ? r.any_nvnu : r.any_vnu;
        unc = r.any_u & ~decided;
      }
      // superset-lowered ops: uncertain exactly when fired
      if (fl & kOpPrefilter) unc = val;
      ov[o - op_lo] = val;
      ou[o - op_lo] = unc;
    }
  }
  __syncthreads();

  // --- templates: OR over their operations ---
  {
    const int op_lo = ch_s[2], opc = ch_s[3] - op_lo, t_lo = ch_s[0], t_hi = ch_s[1];
    const uint32_t* ov = chunk_words + 2 * (ch_s[7] - ch_s[6]);
    const uint32_t* ou = ov + opc;
    uint32_t* tv = chunk_words + 2 * (ch_s[7] - ch_s[6]) + 2 * opc;  // [t_hi - t_lo]
    uint32_t* tu = tv + (t_hi - t_lo);
    for (int t = t_lo + threadIdx.x; t < t_hi; t += blockDim.x) {
      uint32_t val = 0u, unc = 0u;
      const int e0 = __ldg(L.t_op_off + t), e1 = __ldg(L.t_op_off + t + 1);
      if (e1 > e0) {
        const Reduced r = reduce(L.t_op_idx, e0, e1, L.nop, op_lo, ov, ou);
        val = r.any_v;
        unc = r.any_u & ~r.any_vnu;
      }
      tv[t - t_lo] = val;
      tu[t - t_lo] = unc;
    }
  }
  __syncthreads();

  // --- the owned entries of each plane, as bytes ---
  const int r0 = w * 32, nr = min(32, X.rows - r0);
  const int mc = ch_s[7] - ch_s[6], opc = ch_s[3] - ch_s[2], tc = ch_s[1] - ch_s[0];
  const uint32_t* words = chunk_words;
  write_plane(X.t_value, L.nt, r0, nr, words + 2 * (mc + opc), ch_s[0], ch_s[0], ch_s[1]);
  write_plane(X.t_unc, L.nt, r0, nr, words + 2 * (mc + opc) + tc, ch_s[0], ch_s[0], ch_s[1]);
  write_plane(X.op_value, L.nop, r0, nr, words + 2 * mc, ch_s[2], ch_s[4], ch_s[5]);
  write_plane(X.op_unc, L.nop, r0, nr, words + 2 * mc + opc, ch_s[2], ch_s[4], ch_s[5]);
  if (X.m_value != nullptr) write_plane(X.m_value, L.nm, r0, nr, words, ch_s[6], ch_s[8], ch_s[9]);
  write_plane(X.m_unc, L.nm, r0, nr, words + mc, ch_s[6], ch_s[8], ch_s[9]);
}

}  // namespace

extern "C" {

// The verdict planes of n_rows rows.  layout: the corpus half, a host
// VerdictLayout of device pointers (kernels.VerdictLayoutC), passed as
// void* so that no type of the unnamed namespace is in the exported
// signature; sources, a host array of kSources device pointers (the
// check sources' int32 [B] columns, in ops/match.py CHECK_SOURCES
// order); words, int32 scratch of ceil(B / 32) * (2 ns + 2 n_rx)
// (2 ns without the overlay); the other pointers as VerdictBatch holds
// them.  digest, rx_value / rx_unc and m_value may be null.  split, a
// cudaEvent_t or null, is recorded on the stream between the pack and
// the evaluation, so that events time each launch.
int match_verdicts(const void* layout, int32_t n_rows, const uint8_t* value,
                   const uint8_t* unc, int32_t ns, const int32_t* const* sources,
                   const int64_t* digest,
                   const uint8_t* rx_value, const uint8_t* rx_unc, uint8_t* t_value,
                   uint8_t* t_unc, uint8_t* op_value, uint8_t* op_unc, uint8_t* m_value,
                   uint8_t* m_unc, int32_t* words, void* stream, void* split) {
  if (n_rows <= 0) return 0;
  const VerdictLayout L = *static_cast<const VerdictLayout*>(layout);
  // a matcher's conjuncts are loaded a lane each (the compiler caps them
  // at 6); its status and size values 32 a pass, any number of them
  if (ns < 1 || L.nt < 1 || L.nm < 0 || L.nop < 0 || L.n_chunks < 1 || L.n_conj > 32 ||
      L.n_status < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_words = (n_rows + 31) / 32;
  const bool overlay = rx_value != nullptr && L.n_rx > 0;
  uint32_t* vw = reinterpret_cast<uint32_t*>(words);
  uint32_t* uw = vw + (size_t)n_words * ns;
  uint32_t* rvw = overlay ? uw + (size_t)n_words * ns : nullptr;
  uint32_t* ruw = overlay ? rvw + (size_t)n_words * L.n_rx : nullptr;
  const PackArgs pa = {value, unc, rx_value, rx_unc, vw, uw, rvw, ruw, n_rows, ns, L.n_rx};
  const int cols = overlay && L.n_rx > ns ? L.n_rx : ns;
  const dim3 pgrid(n_words, (cols + kPackThreads - 1) / kPackThreads, overlay ? 4 : 2);
  match_verdicts_pack_kernel<<<pgrid, kPackThreads, 0, st>>>(pa);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (split != nullptr) {
    e = cudaEventRecord((cudaEvent_t)split, st);
    if (e != cudaSuccess) return (int)e;
  }
  VerdictBatch X = {vw, uw, rvw, ruw, {}, digest, t_value, t_unc, op_value, op_unc,
                    m_value, m_unc, n_rows, ns};
  for (int s = 0; s < kSources; ++s) X.src[s] = sources[s];
  if (L.chunk_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(match_verdicts_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L.chunk_smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_words, L.n_chunks);
  match_verdicts_kernel<<<grid, kVerdictThreads, (size_t)L.chunk_smem, st>>>(L, X);
  return (int)cudaGetLastError();
}

}  // extern "C"
