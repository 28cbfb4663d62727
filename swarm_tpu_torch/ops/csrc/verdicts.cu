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
// batch.  Here it is one launch.
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
// Design: one block per row, three phases split by __syncthreads, each a
// thread-strided loop over its owners: matchers, then operations, then
// templates.  The matcher and operation planes of the row live in shared
// memory as bytes (2 * (NM + NOP) bytes; 28,894 for the synthetic
// corpus of the reference's shape), and are copied out as they are made.
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
// Bound: the two [B, NS] slot planes read and the output planes written
// once; the member gathers hit L1 / shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVerdictThreads = 256;
// the row's check sources: the stream lengths, then the status
constexpr int kSources = 6;
constexpr int kStatusSource = kSources - 1;

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
  int32_t nm, nop, nt, n_conj, n_status, n_rx;
};

// The batch half, per call.
struct VerdictBatch {
  const uint8_t* value;       // bool [B, ns]
  const uint8_t* unc;         // bool [B, ns]
  const int32_t* src[kSources];  // int32 [B] each: the check sources
  const int64_t* digest;      // [B, 4] or null (fail closed)
  const uint8_t* rx_value;    // bool [B, n_rx] or null (no overlay)
  const uint8_t* rx_unc;
  uint8_t* t_value;           // bool [B, NT]
  uint8_t* t_unc;
  uint8_t* op_value;          // bool [B, NOP]
  uint8_t* op_unc;
  uint8_t* m_value;           // bool [B, NM] or null (not wanted)
  uint8_t* m_unc;
  int32_t ns;
};

__device__ __forceinline__ int clamped(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// any / all of one owner's members over a (value, unc) plane pair
struct Reduced {
  bool all_v = true, any_v = false, any_u = false;
  bool any_vnu = false;   // some member certainly true: v & ~u
  bool any_nvnu = false;  // some member certainly false: ~v & ~u
};

__device__ __forceinline__ Reduced reduce(const int32_t* idx, int lo, int hi, int n,
                                          const uint8_t* v, const uint8_t* u) {
  Reduced r;
  for (int e = lo; e < hi; ++e) {
    const int j = clamped(__ldg(idx + e), n);
    const bool gv = v[j] != 0, gu = u[j] != 0;
    r.all_v &= gv;
    r.any_v |= gv;
    r.any_u |= gu;
    r.any_vnu |= gv && !gu;
    r.any_nvnu |= !gv && !gu;
  }
  return r;
}

// v[i] by a select chain over registers: an array indexed at run time
// would live in local memory
__device__ __forceinline__ int32_t pick(const int32_t (&v)[kSources], int i) {
  int32_t r = v[0];
#pragma unroll
  for (int s = 1; s < kSources; ++s) r = i == s ? v[s] : r;
  return r;
}

__device__ __forceinline__ bool scalar_check(int mask, float v, float c) {
  return ((mask & 1) && v == c) || ((mask & 2) && v != c) || ((mask & 4) && v < c) ||
         ((mask & 8) && v > c) || ((mask & 16) && v <= c) || ((mask & 32) && v >= c) ||
         (mask & 64);
}

__global__ void __launch_bounds__(kVerdictThreads)
match_verdicts_kernel(const VerdictLayout L, const VerdictBatch X) {
  extern __shared__ uint8_t planes[];
  uint8_t* mv = planes;           // [NM]
  uint8_t* mu = mv + L.nm;        // [NM]
  uint8_t* ov = mu + L.nm;        // [NOP]
  uint8_t* ou = ov + L.nop;       // [NOP]
  const int b = blockIdx.x;
  const uint8_t* vrow = X.value + (size_t)b * X.ns;
  const uint8_t* urow = X.unc + (size_t)b * X.ns;
  int32_t src[kSources];
#pragma unroll
  for (int s = 0; s < kSources; ++s) src[s] = X.src[s][b];
  const int32_t status = src[kStatusSource];

  // --- matchers ---
  for (int m = threadIdx.x; m < L.nm; m += blockDim.x) {
    const int fl = L.m_flags[m];
    // slot reduction (vacuously true without slots); Kleene: a certain
    // hit decides OR, any miss decides AND
    bool slot_red = true, unc = false;
    const int s0 = L.m_slot_off[m], s1 = L.m_slot_off[m + 1];
    if (s1 > s0) {
      const Reduced r = reduce(L.m_slot_idx, s0, s1, X.ns, vrow, urow);
      const bool is_and = fl & kMAnd;
      slot_red = is_and ? r.all_v : r.any_v;
      const bool decided = is_and ? !r.all_v : r.any_vnu;
      unc = r.any_u && !decided;
    }
    // negated slots: none may be present
    bool neg_present = false, neg_decided_false = false;
    const int n0 = L.m_neg_off[m], n1 = L.m_neg_off[m + 1];
    if (n1 > n0) {
      const Reduced r = reduce(L.m_neg_idx, n0, n1, X.ns, vrow, urow);
      neg_present = r.any_v;
      neg_decided_false = r.any_vnu;
      unc |= r.any_u;
    }
    bool scalar_ok = true;
    if (fl & kMScalar) {
      for (int c = 0; c < L.n_conj; ++c) {
        const int k = m * L.n_conj + c;
        const float v = (float)pick(src, L.scalar_src[k]);
        scalar_ok &= scalar_check(L.scalar_mask[k], v, L.scalar_cmp[k]);
      }
    }
    bool status_ok = false, size_ok = false;
    if (fl & kMStatus) {
      for (int s = 0; s < L.n_status; ++s) status_ok |= status == L.m_status[m * L.n_status + s];
    }
    if (fl & kMSize) {
      const int32_t sel = pick(src, L.m_size_src[m]);
      for (int s = 0; s < L.n_status; ++s) size_ok |= sel == L.m_size[m * L.n_status + s];
    }
    // md5 digest equality; without a digest the check fails closed
    bool md5_ok = true;
    if (fl & kMMd5) {
      if (X.digest != nullptr) {
        const int64_t* d = X.digest + (size_t)b * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          md5_ok &= d[i] == (int64_t)(uint32_t)L.m_md5[m * 4 + i];
        }
      } else {
        unc = true;
      }
    }
    bool val = false;
    if (fl & kMWords) val = slot_red;
    if (fl & kMScalar) val = scalar_ok && slot_red && !neg_present && md5_ok;
    if (fl & kMStatus) val = status_ok;
    if (fl & kMSize) val = size_ok;
    // Kleene over the scalar & slots & ~neg & md5 conjunction
    if ((fl & kMScalar) && (!scalar_ok || !md5_ok || neg_decided_false)) unc = false;
    // residues and fired regex prefilters need host confirmation ...
    if ((fl & (kMResidue | kMRxPrefilter)) && val) unc = true;
    // ... but for the matchers the device regex re-checked exactly
    if (X.rx_value != nullptr) {
      const int r = L.m_rx[m];
      if (r >= 0) {
        val = X.rx_value[(size_t)b * L.n_rx + r] != 0;
        unc = X.rx_unc[(size_t)b * L.n_rx + r] != 0;
      }
    }
    // negation after uncertainty capture
    if (fl & kMNegative) val = !val;
    mv[m] = val;
    mu[m] = unc;
    if (X.m_value != nullptr) X.m_value[(size_t)b * L.nm + m] = val;
    X.m_unc[(size_t)b * L.nm + m] = unc;
  }
  __syncthreads();

  // --- operations: Kleene AND / OR over their matchers ---
  for (int o = threadIdx.x; o < L.nop; o += blockDim.x) {
    const int fl = L.op_flags[o];
    bool val = false, unc = false;
    const int e0 = L.op_m_off[o], e1 = L.op_m_off[o + 1];
    if (e1 > e0) {
      const Reduced r = reduce(L.op_m_idx, e0, e1, L.nm, mv, mu);
      const bool is_and = fl & kOpAnd;
      val = is_and ? r.all_v : r.any_v;
      const bool decided = is_and ? r.any_nvnu : r.any_vnu;
      unc = r.any_u && !decided;
    }
    // superset-lowered ops: uncertain exactly when fired
    if (fl & kOpPrefilter) unc = val;
    ov[o] = val;
    ou[o] = unc;
    X.op_value[(size_t)b * L.nop + o] = val;
    X.op_unc[(size_t)b * L.nop + o] = unc;
  }
  __syncthreads();

  // --- templates: OR over their operations ---
  for (int t = threadIdx.x; t < L.nt; t += blockDim.x) {
    bool val = false, unc = false;
    const int e0 = L.t_op_off[t], e1 = L.t_op_off[t + 1];
    if (e1 > e0) {
      const Reduced r = reduce(L.t_op_idx, e0, e1, L.nop, ov, ou);
      val = r.any_v;
      unc = r.any_u && !r.any_vnu;
    }
    X.t_value[(size_t)b * L.nt + t] = val;
    X.t_unc[(size_t)b * L.nt + t] = unc;
  }
}

}  // namespace

extern "C" {

// The verdict planes of n_rows rows.  layout: the corpus half, a host
// VerdictLayout of device pointers (kernels.VerdictLayoutC), passed as
// void* so that no type of the unnamed namespace is in the exported
// signature; sources, a host array of kSources device pointers (the
// check sources' int32 [B] columns, in ops/match.py CHECK_SOURCES
// order); the batch pointers as VerdictBatch holds them.  digest,
// rx_value / rx_unc and m_value may be null.
int match_verdicts(const void* layout, int32_t n_rows, const uint8_t* value,
                   const uint8_t* unc, int32_t ns, const int32_t* const* sources,
                   const int64_t* digest,
                   const uint8_t* rx_value, const uint8_t* rx_unc, uint8_t* t_value,
                   uint8_t* t_unc, uint8_t* op_value, uint8_t* op_unc, uint8_t* m_value,
                   uint8_t* m_unc, void* stream) {
  if (n_rows <= 0) return 0;
  const VerdictLayout L = *static_cast<const VerdictLayout*>(layout);
  if (ns < 1 || L.nt < 1 || L.nm < 0 || L.nop < 0) return (int)cudaErrorInvalidValue;
  VerdictBatch X = {value, unc, {}, digest, rx_value, rx_unc, t_value, t_unc, op_value,
                    op_unc, m_value, m_unc, ns};
  for (int s = 0; s < kSources; ++s) X.src[s] = sources[s];
  const int64_t smem = 2 * ((int64_t)L.nm + L.nop);  // the row's m and op planes
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_verdicts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  match_verdicts_kernel<<<n_rows, kVerdictThreads, (size_t)smem, (cudaStream_t)stream>>>(L, X);
  return (int)cudaGetLastError();
}

}  // extern "C"
