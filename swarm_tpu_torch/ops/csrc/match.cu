// Template-fingerprint match kernels for Hopper (sm_90a).
//
// The JAX package runs the match path as XLA-lowered jnp with no Pallas
// kernel (swarm_tpu/ops/match.py, swarm_tpu/ops/regexdev.py).  In eager
// PyTorch the same code would build [tables, B, W] flag planes, a [B, C]
// int32 rank plane and a byte-at-a-time regex scan of thousands of
// launches, so the three device stages that carry the work are written
// here by hand; the verdict tail stays torch ops (ops/match.py).
//
//   match_phase_a     <- swarm_tpu/ops/match.py prefilter_counts +
//                        compact_candidates (:1350-1438), kernel_a (:584)
//   match_verify      <- swarm_tpu/ops/match.py verify_candidates (:1465)
//   match_regex_scan  <- swarm_tpu/ops/regexdev.py regex_verify's
//                        lax.scan shift-and recurrence (:134-208)
//
// Streams.  Each word table probes one (stream, lowered, q) view: the
// stream is uint8 [B, W] row-major, its lengths int32 [B]; "lowered"
// ASCII-lowercases each byte as it is read.  A table's descriptor holds
// the stream's pointer, lengths pointer, width and q; the launchers take
// them as host arrays and pass them to the kernel by value.  The uint32
// corpus arrays (hashes, bloom words, regex lanes) arrive as int32
// tensors holding the same bits.
//
// match_phase_a: a block owns a row.  Table by table (ascending, the
// table-major candidate axis of the JAX code) it stages the row's bytes
// in shared memory, hashes each window i < len - q + 1 with the two
// rolling polynomials (uint32 wrap, ops/hashing.py), probes the table's
// bloom bitmap with both bits, and ranks the fired windows with a
// block-wide ballot scan in window order.  The first min(n_surv, K)
// fired columns (col_start[t] + i) go to col[b, rank]; the rest of the
// row's `budget` columns hold -1, and n_surv[b] is the row's total.  The
// [B, C] rank plane of the JAX code is never written.  Windows past
// len - q cannot fire (the JAX position bound), so they are not hashed.
// Bound: the streams' bytes read once and the blooms' probed words; the
// hashing is 2q multiply-adds a window.
//
// match_verify: one thread per (row, candidate column).  The candidate's
// table is the last t with col_start[t] <= col; its window hash is
// recomputed from the bytes (zero past W, as the JAX hash plane pads),
// the table's sorted group_h1[:n_groups] is binary-searched, and each
// group entry e (clamped to emax - 1 as the JAX gather clamps) is
// screened by h2, the suffix-gram hashes at pos + suf_delta (in bounds
// only), the word's bounds, and then byte-verified against slot_bytes
// for min(len, 64) bytes.  A verified entry sets value[b, slot], and
// unc[b, slot] when the slot is longer than VERIFY_WIDTH.  Every write
// stores 1 into a zeroed byte plane, so concurrent writers of one slot
// agree.  Bound: the candidates' table lookups and byte compares.
//
// match_regex_scan: a warp per compacted (row, sequence) pair, four
// one-warp blocks an SM walking the K pairs (each answers the pairs
// that are not valid 32 at a time; the live pairs are a prefix, so
// each gets a warp of its own).  It keeps the shift-and state of up
// to 96 NFA positions in L uint32 lanes (L = 1..3, a template
// argument) and handles anchors, a leading / trailing \b and $ / \Z
// with the trailing newline exactly as the lax.scan step does; bytes
// past the row's length leave nothing that is read changed, so the
// scan stops at the length.  A byte's state update is a few lane
// operations behind three dependent loads (the byte, its wordness,
// its bytemap row), and a batch has only tens of live pairs.  So, per
// piece of 256 positions, the warp stages off the chain what each
// position needs (its class words, its seed and self loop terms and
// its end-rule mask, from the bytemap and word table in shared
// memory; the bytes come in with 8-byte loads issued a piece ahead),
// and lane 0 then runs the recurrence from shared memory, a funnel
// shift and one logic operation of dependent chain a byte (see
// RegexStage).  Bound: the live pairs' bytes and one bytemap row
// each; held by the longest pair's serial chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTables = 64;
constexpr int kMaxVariants = 16;
constexpr int kBloomBits = 1 << 18;
constexpr int kBloomWords = kBloomBits / 32;
constexpr int kVerifyWidth = 64;
constexpr uint32_t kBase1 = 0x01000193u;
constexpr uint32_t kBase2 = 0x85EBCA77u;
constexpr int kPhaseAThreads = 256;
constexpr int kEndNone = 0, kEndZ = 1, kEndDollar = 2;

struct StreamRef {
  const uint8_t* data;  // [B, width]
  const int32_t* len;   // [B]
  int32_t width;
  int32_t lowered;
};

struct Tables {
  int32_t n;
  StreamRef s[kMaxTables];
  int32_t q[kMaxTables];
  int32_t col_start[kMaxTables + 1];
};

__device__ __forceinline__ uint32_t lower_ascii(uint32_t c) {
  return (c >= 65u && c <= 90u) ? c + 32u : c;
}

__device__ __forceinline__ uint32_t read_byte(const StreamRef& s, int b, int p) {
  if (p < 0 || p >= s.width) return 0u;
  const uint32_t c = s.data[(size_t)b * s.width + p];
  return s.lowered ? lower_ascii(c) : c;
}

// (h1, h2) of bytes[p, p + q) of row b, zero past the width
__device__ __forceinline__ void hash_at(const StreamRef& s, int q, int b, int p,
                                        uint32_t& h1, uint32_t& h2) {
  uint32_t p1 = 1u, p2 = 1u;
  h1 = 0u;
  h2 = 0u;
  for (int j = 0; j < q; ++j) {
    const uint32_t c = read_byte(s, b, p + j);
    h1 += c * p1;
    h2 += c * p2;
    p1 *= kBase1;
    p2 *= kBase2;
  }
}

__device__ __forceinline__ bool bloom_hit(const uint32_t* bloom, uint32_t h1,
                                          uint32_t h2) {
  const uint32_t i1 = h1 & (kBloomBits - 1), i2 = h2 & (kBloomBits - 1);
  const uint32_t w1 = __ldg(bloom + (i1 >> 5)), w2 = __ldg(bloom + (i2 >> 5));
  return ((w1 >> (i1 & 31)) & (w2 >> (i2 & 31)) & 1u) != 0u;
}

// ---------------------------------------------------------------------------
// Phase A

__global__ void __launch_bounds__(kPhaseAThreads)
match_phase_a_kernel(Tables tabs, const uint32_t* __restrict__ bloom, int budget,
                     int kclamp, int32_t* __restrict__ col,
                     int32_t* __restrict__ n_surv) {
  extern __shared__ uint8_t srow[];
  __shared__ int warp_count[kPhaseAThreads / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* out = col + (size_t)b * budget;
  for (int j = tid; j < budget; j += kPhaseAThreads) out[j] = -1;
  int base = 0;  // fired windows ranked so far (same value in every thread)
  for (int t = 0; t < tabs.n; ++t) {
    const StreamRef s = tabs.s[t];
    const int q = tabs.q[t];
    const int nwin = min(s.width, s.len[b] - q + 1);
    if (nwin <= 0) continue;
    __syncthreads();  // the previous table's reads of srow are done
    const int staged = nwin + q - 1;  // <= len <= width
    const uint8_t* src = s.data + (size_t)b * s.width;
    for (int i = tid; i < staged; i += kPhaseAThreads) {
      const uint32_t c = src[i];
      srow[i] = (uint8_t)(s.lowered ? lower_ascii(c) : c);
    }
    __syncthreads();
    uint32_t pw1[8], pw2[8];
    pw1[0] = pw2[0] = 1u;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      pw1[j] = pw1[j - 1] * kBase1;
      pw2[j] = pw2[j - 1] * kBase2;
    }
    const uint32_t* tb = bloom + (size_t)t * kBloomWords;
    const int cs = tabs.col_start[t];
    for (int i0 = 0; i0 < nwin; i0 += kPhaseAThreads) {
      const int i = i0 + tid;
      bool fired = false;
      if (i < nwin) {
        uint32_t h1 = 0u, h2 = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < q) {
            const uint32_t c = srow[i + j];
            h1 += c * pw1[j];
            h2 += c * pw2[j];
          }
        }
        fired = bloom_hit(tb, h1, h2);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, fired);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kPhaseAThreads / 32; ++w) {
        const int c = warp_count[w];
        before += (w < warp) ? c : 0;
        total += c;
      }
      const int rank = base + before + __popc(ballot & ((1u << lane) - 1u));
      if (fired && rank < kclamp) out[rank] = cs + i;
      base += total;
      __syncthreads();  // warp_count is rewritten next round
    }
  }
  if (tid == 0) n_surv[b] = base;
}

// ---------------------------------------------------------------------------
// Phase B: gather-verify

struct VerifyArgs {
  const int32_t* col;  // [B, col_stride], the first kc columns used
  int32_t col_stride, kc, n_rows;
  const uint32_t* group_h1;  // [T, gmax]
  const int32_t* entry_start;
  const int32_t* entry_count;
  const int32_t* n_groups;  // [T]
  const uint32_t* entry_h2;  // [T, emax]
  const int32_t* entry_slot;
  const int32_t* entry_off;
  const int32_t* entry_len;
  const int32_t* entry_suf_delta;
  const uint32_t* entry_suf_h1;
  const uint32_t* entry_suf_h2;
  int32_t gmax, emax, max_group;
  const uint8_t* slot_bytes;  // [NS, VERIFY_WIDTH]
  const int32_t* slot_len;    // [NS]
  uint8_t* value;             // [B, plane_width], zeroed
  uint8_t* unc;
  int32_t plane_width;
};

__global__ void match_verify_kernel(Tables tabs, VerifyArgs a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.n_rows * a.kc) return;
  const int b = (int)(idx / a.kc), j = (int)(idx % a.kc);
  const int c = a.col[(size_t)b * a.col_stride + j];
  if (c < 0) return;
  int t = 0;
  while (t + 1 < tabs.n && tabs.col_start[t + 1] <= c) ++t;
  const StreamRef s = tabs.s[t];
  const int q = tabs.q[t];
  const int cpos = c - tabs.col_start[t];
  const int W = s.width;
  const int slen = s.len[b];
  uint32_t h1, h2;
  hash_at(s, q, b, cpos, h1, h2);

  // lower bound of h1 in the table's sorted groups
  const uint32_t* gh = a.group_h1 + (size_t)t * a.gmax;
  const int ng = a.n_groups[t];
  int lo = 0, hi = ng;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(gh + mid) < h1) lo = mid + 1; else hi = mid;
  }
  if (lo >= ng) return;
  const int gidx = min(lo, a.gmax - 1);
  if (__ldg(gh + gidx) != h1) return;
  const size_t grow = (size_t)t * a.gmax + gidx;
  const int e_start = a.entry_start[grow];
  const int e_count = a.entry_count[grow];
  const size_t erow = (size_t)t * a.emax;
  for (int g = 0; g < a.max_group && g < e_count; ++g) {
    const size_t e = erow + min(e_start + g, a.emax - 1);
    if (__ldg(a.entry_h2 + e) != h2) continue;
    const int spos = cpos + a.entry_suf_delta[e];
    if (spos < 0 || spos >= W) continue;
    uint32_t s1, s2;
    hash_at(s, q, b, spos, s1, s2);
    if (s1 != __ldg(a.entry_suf_h1 + e) || s2 != __ldg(a.entry_suf_h2 + e)) continue;
    const int off = a.entry_off[e], len = a.entry_len[e];
    const int start = cpos - off;
    if (start < 0 || start + len > slen || start + len > W) continue;
    const int slot = a.entry_slot[e];
    const uint8_t* want = a.slot_bytes + (size_t)slot * kVerifyWidth;
    const int lv = min(len, kVerifyWidth);
    bool eq = true;
    for (int o = 0; o < lv && eq; ++o) eq = read_byte(s, b, start + o) == want[o];
    if (!eq) continue;
    a.value[(size_t)b * a.plane_width + slot] = 1;
    if (a.slot_len[slot] > kVerifyWidth) a.unc[(size_t)b * a.plane_width + slot] = 1;
  }
}

// ---------------------------------------------------------------------------
// Device regex: the shift-and scan of the compacted pairs

struct Variants {
  int32_t n;
  StreamRef s[kMaxVariants];
};

struct RegexArgs {
  const int64_t* pair_b;  // [K]
  const int64_t* pair_s;  // [K]
  const bool* valid;      // [K]
  int32_t K;
  const int32_t* var_of_seq;  // [NSEQ]
  const uint32_t* bytemap;    // [NSEQ, 256, L]
  const uint32_t* seed;       // [NSEQ, L]
  const uint32_t* skip;
  const uint32_t* accept;
  const uint32_t* self_loop;
  const bool* anchored;       // [NSEQ]
  const int32_t* end_mode;
  const bool* start_wb;
  const bool* end_wb;
  const bool* word_tab;  // [256]
  int32_t r_closure;
  bool* matched;  // [K]
};

// The staged scan.  A warp owns a pair; per piece of kRegexPiece
// positions the 32 lanes stage, off the state chain, everything of a
// position that does not depend on the state, and then lane 0 runs the
// recurrence over the piece from shared memory and registers.
//
// The step of the lax.scan, for a live position with class words bc:
//   d' = ((shift(d) | (s_ok ? seed : 0)) & bc) | (d & self & bc)
//      = (shift(d) & A) | ((d & T) | S)
// with A = bc, T = self & bc and S = s_ok ? seed & bc : 0, each a
// function of the position alone; then r_closure rounds of
// d |= shift(d) & skip.  The chain a byte is a funnel shift and one
// three-input logic operation (and two more a closure round); d & T | S
// runs beside the shift.
//
// The accept test folds the end rules into a position mask E: a pair
// matches when some position's d & accept is non-zero with E set, so
// lane 0 only ORs d & E into acc (one operation a lane) and tests acc &
// accept once at the end.  E is the scan's end rule at that position:
// without a trailing \b, end_ok (any position; $ / \Z at the last, $
// also before a trailing newline); with one, the byte boundary after
// it, as the pending / pend_word logic of the scan resolves it (the
// next byte's wordness differs, or, at the last byte, the byte is a
// word byte).  Positions at or past the pair's length have E = 0 and
// change nothing that is read.

constexpr int kRegexPiece = 256;
constexpr int kRegexGroup = 4;  // positions a step group (one uint4 a plane)
constexpr int kRegexPad = kRegexPiece + kRegexGroup;  // the prefetch reads one group past
// warps the scan launches an SM: enough to spread the live pairs, few
// enough that the blocks of pairs that are not valid cost no launch wave
constexpr int kRegexWarpsPerSm = 4;

template <int L>
struct RegexStage {
  uint32_t a[L][kRegexPad];  // bc
  uint32_t s[L][kRegexPad];  // s_ok ? seed & bc : 0
  uint32_t t[L][kRegexPad];  // self & bc
  uint32_t e[kRegexPad];     // ~0 where an accept counts, else 0
};

template <int L>
__device__ __forceinline__ void lane_shift(const uint32_t (&d)[L], uint32_t (&out)[L]) {
#pragma unroll
  for (int l = L - 1; l > 0; --l) out[l] = __funnelshift_l(d[l - 1], d[l], 1);
  out[0] = d[0] << 1;
}

// component q of v; q is a constant once the caller's loop is unrolled
__device__ __forceinline__ uint32_t component(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <int L>
__device__ __forceinline__ void load_group(const RegexStage<L>& st, int g, uint4 (&a)[L],
                                           uint4 (&s)[L], uint4 (&t)[L], uint4& e) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    a[l] = *reinterpret_cast<const uint4*>(&st.a[l][g]);
    s[l] = *reinterpret_cast<const uint4*>(&st.s[l][g]);
    t[l] = *reinterpret_cast<const uint4*>(&st.t[l][g]);
  }
  e = *reinterpret_cast<const uint4*>(&st.e[g]);
}

template <int L, bool Closure>
__device__ __forceinline__ void regex_step(uint32_t (&d)[L], uint32_t (&acc)[L],
                                           const uint32_t (&a)[L], const uint32_t (&s)[L],
                                           const uint32_t (&t)[L], uint32_t e,
                                           const uint32_t (&skip)[L], int r_closure) {
  uint32_t sh[L];
  lane_shift<L>(d, sh);
#pragma unroll
  for (int l = 0; l < L; ++l) d[l] = (sh[l] & a[l]) | ((d[l] & t[l]) | s[l]);
  if (Closure) {
    for (int r = 0; r < r_closure; ++r) {
      lane_shift<L>(d, sh);
#pragma unroll
      for (int l = 0; l < L; ++l) d[l] |= sh[l] & skip[l];
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] |= d[l] & e;
}

// the recurrence over the staged positions [0, cnt), rounded up to
// whole groups (the positions past the pair's length have E = 0)
template <int L, bool Closure>
__device__ __forceinline__ void regex_scan_piece(const RegexStage<L>& st, int cnt,
                                                 uint32_t (&d)[L], uint32_t (&acc)[L],
                                                 const uint32_t (&skip)[L], int r_closure) {
  uint4 a[L], s[L], t[L], e;
  load_group<L>(st, 0, a, s, t, e);
  for (int g = 0; g < cnt; g += kRegexGroup) {
    // the next group's loads go out before this group's chain
    uint4 na[L], ns[L], nt[L], ne;
    load_group<L>(st, g + kRegexGroup, na, ns, nt, ne);
#pragma unroll
    for (int q = 0; q < kRegexGroup; ++q) {
      uint32_t x[L], y[L], z[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        x[l] = component(a[l], q);
        y[l] = component(s[l], q);
        z[l] = component(t[l], q);
      }
      regex_step<L, Closure>(d, acc, x, y, z, component(e, q), skip, r_closure);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      a[l] = na[l];
      s[l] = ns[l];
      t[l] = nt[l];
    }
    e = ne;
  }
}

// 8 bytes of row at [q, q + 8), zero at or past lim (bytes past the
// stream's width read as zero, as read_byte has them)
__device__ __forceinline__ uint2 load8(const uint8_t* row, int q, int lim) {
  if (q + 8 <= lim && (reinterpret_cast<uintptr_t>(row + q) & 7u) == 0u) {
    return *reinterpret_cast<const uint2*>(row + q);
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (q + j < lim) w[j >> 2] |= (uint32_t)row[q + j] << (8 * (j & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ uint32_t byte_of(uint2 v, int j) {
  return ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xFFu;
}

template <int L>
struct RegexShared {
  RegexStage<L> st;
  uint32_t smap[256 * L];              // the pair's sequence's bytemap
  uint8_t sbytes[kRegexPiece + 2];     // positions p0 - 1 .. p0 + P
  uint8_t sword[256];                  // the word table
};

// One pair k, by the whole warp; writes matched[k]
template <int L>
__device__ __forceinline__ void regex_scan_pair(const Variants& vars, const RegexArgs& a,
                                                RegexShared<L>& sh, int k, int lane) {
  const int b = (int)a.pair_b[k];
  const int seq = (int)a.pair_s[k];
  const StreamRef s = vars.s[a.var_of_seq[seq]];
  const uint8_t* row = s.data + (size_t)b * s.width;
  const int mine = lane * (kRegexPiece / 32);  // this lane's 8 positions of a piece
  // the first two pieces' bytes go out before the length is known:
  // bytes past the length change nothing that is read
  uint2 cur = load8(row, mine, s.width);
  uint2 nxt = load8(row, kRegexPiece + mine, s.width);
  const uint32_t* bmap = a.bytemap + (size_t)seq * 256 * L;
  __syncwarp();  // the previous pair is done with the shared arrays
  for (int i = lane; i < 256 * L; i += 32) sh.smap[i] = __ldg(bmap + i);
  uint32_t seed[L], skip[L], sloop[L], d[L], acc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    seed[l] = __ldg(a.seed + (size_t)seq * L + l);
    skip[l] = __ldg(a.skip + (size_t)seq * L + l);
    sloop[l] = __ldg(a.self_loop + (size_t)seq * L + l);
    d[l] = 0u;
    acc[l] = 0u;
  }
  const bool anchored = a.anchored[seq];
  const int end_mode = a.end_mode[seq];
  const bool start_wb = a.start_wb[seq], end_wb = a.end_wb[seq];
  const int n = s.len[b];
  const bool trail_nl = n > 0 && n - 1 < s.width && row[n - 1] == 0x0Au;
  // without a trailing \b an accept counts at positions >= end_lo
  const int end_lo = end_mode == kEndNone ? 0 : (end_mode == kEndDollar && trail_nl ? n - 2 : n - 1);
  bool prev_w = false;  // the wordness of the byte before the piece
  for (int p0 = 0; p0 < n; p0 += kRegexPiece) {
    // the piece's bytes, lowered as the view reads them, and the first
    // byte of the next piece
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t c = byte_of(cur, j);
      sh.sbytes[1 + mine + j] = (uint8_t)(s.lowered ? lower_ascii(c) : c);
    }
    if (lane == 0) {
      const uint32_t c = byte_of(nxt, 0);
      sh.sbytes[kRegexPiece + 1] = (uint8_t)(s.lowered ? lower_ascii(c) : c);
    }
    __syncwarp();
    // the piece after next: its loads run under this piece's work
    const uint2 after = load8(row, p0 + 2 * kRegexPiece + mine, s.width);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = mine + j, pos = p0 + i;
      const uint32_t c = sh.sbytes[1 + i];
      const bool w = sh.sword[c];
      const bool w_prev = i == 0 ? prev_w : sh.sword[sh.sbytes[i]];
      const bool w_next = sh.sword[sh.sbytes[2 + i]];
      const bool s_ok = (!anchored || pos == 0) && (!start_wb || w != w_prev);
      bool e_ok;
      if (end_wb) {
        e_ok = pos + 1 < n ? w != w_next : w;
      } else {
        e_ok = pos >= end_lo;
      }
      sh.st.e[i] = pos < n && e_ok ? ~0u : 0u;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t bc = sh.smap[c * L + l];
        sh.st.a[l][i] = bc;
        sh.st.s[l][i] = s_ok ? seed[l] & bc : 0u;
        sh.st.t[l][i] = sloop[l] & bc;
      }
    }
    __syncwarp();
    if (lane == 0) {
      const int cnt = min(kRegexPiece, n - p0);
      if (a.r_closure > 0) {
        regex_scan_piece<L, true>(sh.st, cnt, d, acc, skip, a.r_closure);
      } else {
        regex_scan_piece<L, false>(sh.st, cnt, d, acc, skip, 0);
      }
    }
    __syncwarp();
    prev_w = sh.sword[sh.sbytes[kRegexPiece]];
    __syncwarp();  // every lane has read sbytes before the next piece writes it
    cur = nxt;
    nxt = after;
  }
  if (lane == 0) {
    uint32_t hit = 0u;
#pragma unroll
    for (int l = 0; l < L; ++l) hit |= acc[l] & __ldg(a.accept + (size_t)seq * L + l);
    a.matched[k] = hit != 0u;
  }
}

// A warp a block, a few blocks an SM, each warp taking the pairs k =
// blockIdx.x + i * gridDim.x: 32 of them at a time are checked for
// validity with one load a lane, the pairs that are not valid answered
// at once, and the valid ones scanned in turn.  The live pairs are a
// prefix, so each lands on a warp of its own.
template <int L>
__global__ void __launch_bounds__(32) match_regex_scan_kernel(Variants vars, RegexArgs a) {
  __shared__ __align__(16) RegexShared<L> sh;
  const int lane = threadIdx.x;
  for (int i = lane; i < 256; i += 32) sh.sword[i] = a.word_tab[i] ? 1 : 0;
  const int stride = gridDim.x;
  for (int k0 = blockIdx.x; k0 < a.K; k0 += 32 * stride) {
    const int kk = k0 + lane * stride;
    const bool v = kk < a.K && a.valid[kk];
    if (kk < a.K && !v) a.matched[kk] = false;
    unsigned live = __ballot_sync(0xffffffffu, v);
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      regex_scan_pair<L>(vars, a, sh, k0 + j * stride, lane);
    }
  }
}

Tables make_tables(int32_t n, const int64_t* data, const int64_t* lens,
                   const int32_t* widths, const int32_t* lowered,
                   const int32_t* qs, const int32_t* col_starts) {
  Tables t{};
  t.n = n;
  for (int i = 0; i < n; ++i) {
    t.s[i].data = reinterpret_cast<const uint8_t*>(data[i]);
    t.s[i].len = reinterpret_cast<const int32_t*>(lens[i]);
    t.s[i].width = widths[i];
    t.s[i].lowered = lowered[i];
    t.q[i] = qs[i];
    t.col_start[i] = col_starts[i];
  }
  t.col_start[n] = col_starts[n];
  return t;
}

}  // namespace

extern "C" {

int match_max_tables() { return kMaxTables; }
int match_max_variants() { return kMaxVariants; }

// Phase A over n_rows rows.  Tables are given as host arrays (stream and
// lengths device pointers, widths, lowered flags, q, col_starts [T + 1]);
// bloom is int32 [T, BLOOM_WORDS]; col int32 [B, budget]; n_surv int32 [B].
int match_phase_a(int32_t n_rows, int32_t n_tables, const int64_t* data,
                  const int64_t* lens, const int32_t* widths,
                  const int32_t* lowered, const int32_t* qs,
                  const int32_t* col_starts, const int32_t* bloom,
                  int32_t budget, int32_t kclamp, int32_t* col,
                  int32_t* n_surv, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables) return (int)cudaErrorInvalidValue;
  const Tables t = make_tables(n_tables, data, lens, widths, lowered, qs, col_starts);
  int max_width = 0;
  for (int i = 0; i < n_tables; ++i) max_width = std::max(max_width, widths[i]);
  const size_t smem = (size_t)max_width + 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        match_phase_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  match_phase_a_kernel<<<n_rows, kPhaseAThreads, smem, (cudaStream_t)stream>>>(
      t, reinterpret_cast<const uint32_t*>(bloom), budget, kclamp, col, n_surv);
  return (int)cudaGetLastError();
}

// Gather-verify of col[:, :kc] (row stride col_stride).  The corpus
// pointers follow VerifyArgs; value and unc are zeroed bool [B, plane_width].
int match_verify(int32_t n_rows, int32_t n_tables, const int64_t* data,
                 const int64_t* lens, const int32_t* widths,
                 const int32_t* lowered, const int32_t* qs,
                 const int32_t* col_starts, const int32_t* col,
                 int32_t col_stride, int32_t kc, const int32_t* group_h1,
                 const int32_t* entry_start, const int32_t* entry_count,
                 const int32_t* n_groups, const int32_t* entry_h2,
                 const int32_t* entry_slot, const int32_t* entry_off,
                 const int32_t* entry_len, const int32_t* entry_suf_delta,
                 const int32_t* entry_suf_h1, const int32_t* entry_suf_h2,
                 int32_t gmax, int32_t emax, int32_t max_group,
                 const uint8_t* slot_bytes, const int32_t* slot_len,
                 uint8_t* value, uint8_t* unc, int32_t plane_width,
                 void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables) return (int)cudaErrorInvalidValue;
  const Tables t = make_tables(n_tables, data, lens, widths, lowered, qs, col_starts);
  VerifyArgs a;
  a.col = col;
  a.col_stride = col_stride;
  a.kc = kc;
  a.n_rows = n_rows;
  a.group_h1 = reinterpret_cast<const uint32_t*>(group_h1);
  a.entry_start = entry_start;
  a.entry_count = entry_count;
  a.n_groups = n_groups;
  a.entry_h2 = reinterpret_cast<const uint32_t*>(entry_h2);
  a.entry_slot = entry_slot;
  a.entry_off = entry_off;
  a.entry_len = entry_len;
  a.entry_suf_delta = entry_suf_delta;
  a.entry_suf_h1 = reinterpret_cast<const uint32_t*>(entry_suf_h1);
  a.entry_suf_h2 = reinterpret_cast<const uint32_t*>(entry_suf_h2);
  a.gmax = gmax;
  a.emax = emax;
  a.max_group = max_group;
  a.slot_bytes = slot_bytes;
  a.slot_len = slot_len;
  a.value = value;
  a.unc = unc;
  a.plane_width = plane_width;
  const long long n = (long long)n_rows * kc;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  match_verify_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(t, a);
  return (int)cudaGetLastError();
}

// The shift-and scan of K compacted pairs over the stream variants
// (host arrays of device pointers, widths and lowered flags), L lanes;
// sms, the card's SM count, which the caller reads once.
int match_regex_scan(int32_t K, int32_t n_vars, const int64_t* data,
                     const int64_t* lens, const int32_t* widths,
                     const int32_t* lowered, const int64_t* pair_b,
                     const int64_t* pair_s, const bool* valid,
                     const int32_t* var_of_seq, const int32_t* bytemap,
                     const int32_t* seed, const int32_t* skip,
                     const int32_t* accept, const int32_t* self_loop,
                     const bool* anchored, const int32_t* end_mode,
                     const bool* start_wb, const bool* end_wb,
                     const bool* word_tab, int32_t lanes, int32_t r_closure,
                     int32_t sms, bool* matched, void* stream) {
  if (n_vars < 1 || n_vars > kMaxVariants || sms < 1) return (int)cudaErrorInvalidValue;
  Variants v{};
  v.n = n_vars;
  for (int i = 0; i < n_vars; ++i) {
    v.s[i].data = reinterpret_cast<const uint8_t*>(data[i]);
    v.s[i].len = reinterpret_cast<const int32_t*>(lens[i]);
    v.s[i].width = widths[i];
    v.s[i].lowered = lowered[i];
  }
  RegexArgs a;
  a.pair_b = pair_b;
  a.pair_s = pair_s;
  a.valid = valid;
  a.K = K;
  a.var_of_seq = var_of_seq;
  a.bytemap = reinterpret_cast<const uint32_t*>(bytemap);
  a.seed = reinterpret_cast<const uint32_t*>(seed);
  a.skip = reinterpret_cast<const uint32_t*>(skip);
  a.accept = reinterpret_cast<const uint32_t*>(accept);
  a.self_loop = reinterpret_cast<const uint32_t*>(self_loop);
  a.anchored = anchored;
  a.end_mode = end_mode;
  a.start_wb = start_wb;
  a.end_wb = end_wb;
  a.word_tab = word_tab;
  a.r_closure = r_closure;
  a.matched = matched;
  if (K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int warps = std::min(K, kRegexWarpsPerSm * sms);  // a warp a block
  switch (lanes) {
    case 1: match_regex_scan_kernel<1><<<warps, 32, 0, st>>>(v, a); break;
    case 2: match_regex_scan_kernel<2><<<warps, 32, 0, st>>>(v, a); break;
    case 3: match_regex_scan_kernel<3><<<warps, 32, 0, st>>>(v, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
