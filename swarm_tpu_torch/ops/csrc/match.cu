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
// ASCII-lowercases each byte as it is read.  The uint32 corpus arrays
// (hashes, bloom words, regex lanes) arrive as int32 tensors holding the
// same bits.  Phase A and the verify take the batch's tables as one
// TableSet (kernels.TableSetC, built once per dispatch, passed by value)
// and the verify its corpus arrays as one VerifyCorpus
// (kernels.VerifyCorpusC, built once per corpus).
//
// Sequence parallelism (swarm_tpu/ops/match.py match_slots, :1054-1074).
// A seq-sharded grid hands each rank its slice of the row's bytes with
// `back` bytes of the previous slice before it and `fwd` bytes of the
// next after it (kernels.TableSetC's back and fwd; 0 and 0 unsharded).
// A table's windows start only in [back, width - fwd): its local width
// W = width - back - fwd is its run of candidate columns.  Hash, suffix
// and byte reads may reach into both halos.  Window i of table t sits
// at global position off[t] + i, where off[t] is the slice's first byte
// in the row, and lengths are the row's global lengths.
//
// match_phase_a  (replaces swarm_tpu/ops/match.py prefilter_counts +
// compact_candidates).  For each row, each table's two-hash bloom probe
// of every window i < min(W, len - off - q + 1), hashed at back + i; the
// fired (table, window) columns col_start[t] + i in ascending
// table-major order: col[b, r] the r-th for r < min(n_surv, kclamp), -1
// after it up to budget; n_surv[b] the row's count, overflow included.
//   Bound: 2q multiply-adds and two bloom bits a live window, the
//   streams' bytes read once: sub-microsecond at the fingerprint job's
//   shapes.  What holds a design that probes the bitmaps in device
//   memory is the gathers: each bit is a load from a random line, and an
//   SM's L1 takes about one such line a cycle, so a batch's ~2.7 M
//   probes (512 rows) need ~10 us spread over all 132 SMs, and a block
//   a row puts the longest row's ~40 k probes on one SM (~20 us: the
//   earlier design, and this one's first version).  So the probes read
//   the bitmaps from shared memory, and a row is spread over blocks:
//   1. probe pass: a block takes one group (up to kGroupTables tables
//      that read one (stream, lowered) view, the JAX _combo_groups
//      pairing; the compiler emits a q = 4 and a q = 8 table a view)
//      for kProbeRows rows, and stages the group's bitmaps (32 KB a
//      table) in shared memory.  A thread owns whole 32-window words: it
//      loads the word's 40 bytes once (five 8-byte loads), lowers them
//      in registers, hashes every window for both q at once (h8(p) =
//      h4(p) + base^4 h4(p + 4), each h4 computed once, uint32 wrap),
//      probes both tables' bitmaps and keeps each table's fired windows
//      as a 32-bit mask, written to the word's (table, word) slot of the
//      row's masks.  Words are the table's own (windows 32 k .. 32 k +
//      31 of table t), so no word straddles two tables whatever the
//      widths, and windows past the table's live count are masked off.
//      The grid is (rows / 8) x groups: 192 blocks at 256 rows.
//   2. rank pass: a block a row takes its live slots in table-major
//      order, a contiguous run a thread; one block-wide exclusive scan
//      of the runs' popcounts ranks every fired window, and each thread
//      writes its own fired columns with rank < kclamp, then the -1
//      tail; n_surv is the scan's total.
//   A call is these two launches.  Views whose q is not 4 or 8 take a
//   slower path (each window hashed from its bytes); the compiler emits
//   none.
//
// match_verify  (replaces swarm_tpu/ops/match.py verify_candidates).
// For each live candidate of col[:, :kc]: its table (the last t with
// col_start[t] <= c), the window's (h1, h2) at back + c - col_start[t]
// (zero past the width), the lower
// bound of h1 in the table's sorted group_h1[:n_groups] (clamped to
// gmax - 1), then for up to min(max_group, count) entries (each index
// clamped to emax - 1) the h2, suffix-gram (in bounds only) and bounds
// screens (the word inside the row's global length and inside the
// view) and a byte verify of min(len, 64) bytes against slot_bytes; a
// verified entry sets value[b, slot], and unc[b, slot] when the slot is
// longer than 64.  Every write stores 1 into zeroed planes, so two
// candidates that verify one slot agree.
//   Bound: the live candidates' lookups and compares, a few KB; held by
//   each candidate's chain of dependent loads.  The earlier design gave
//   a thread each (row, candidate), 93-96% of them dead, and each live
//   one a serial chain: table scan, q byte loads, a 12-level binary
//   search, up to 8 entries, a 64-load byte compare.  Here a warp takes
//   a live candidate: the warps stride over the (candidate, row) slots,
//   candidate-major, consecutive slots on consecutive warps, checking 32
//   of theirs with one load and leaving the dead ones at once (the live
//   ones are a prefix of each row, so the live slots come first and
//   spread over distinct warps).
//   The table is one ballot over the column starts; the window hash one
//   byte a lane and three shuffles; the lower bound a 32-way fan-out
//   search, one load a lane and a ballot a level (3 levels for 2,815
//   groups); the group's entries screened one a lane, together (h2,
//   the suffix gram from its bytes, the bounds); the verify bytes of
//   each that passes compared across the warp in one load round, 2 a
//   lane, then __all_sync.  (A suffix hashed a byte a lane, entry by
//   entry, ran slower on the job's calls.)  The two planes are zeroed by one
//   fill of a [2, B, plane_width] tensor in the wrapper (one launch a
//   call, where there were two).
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
#include <climits>

namespace {

constexpr int kMaxTables = 64;
constexpr int kMaxVariants = 16;
constexpr int kBloomBits = 1 << 18;
constexpr int kBloomWords = kBloomBits / 32;
constexpr int kVerifyWidth = 64;
constexpr uint32_t kBase1 = 0x01000193u;
constexpr uint32_t kBase2 = 0x85EBCA77u;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEndNone = 0, kEndZ = 1, kEndDollar = 2;

// phase A: threads a block, the windows of a thread's word, the
// tables of a group (one (stream, lowered) view), the bytes a word reads
constexpr int kPhaseAThreads = 256;
constexpr int kWordWindows = 32;
constexpr int kGroupTables = 2;
constexpr int kWordBytes = 40;  // 32 windows + 7 bytes of the last 8-gram, in 8-byte loads
// windows a step of a thread's word (the bytes shift down a step at a
// time), and the rows a probe block takes of one group
constexpr int kProbeBatch = 8;
constexpr int kProbeRows = 8;
// the verify: warps a block, and warps the launch asks for an SM
constexpr int kVerifyWarps = 4;
constexpr int kVerifyWarpsPerSm = 32;
// lanes of the window hash (one byte a lane), and of the fan-out search
constexpr int kGramLanes = 8;
constexpr int kFanOut = 32;

struct StreamRef {
  const uint8_t* data;  // [B, width]
  const int32_t* len;   // [B]
  int32_t width;
  int32_t lowered;
};

// The batch's word tables, built once per dispatch (kernels.TableSetC,
// same field order).  group_table lists the tables of each group, -1
// past its last; word_base[t] = sum over tables before t of
// ceil(W / 32) (W the local width), table t's first (table, word) slot
// of a row of phase A's masks, and scan_words = word_base[n_tables], a
// row's slots; back and fwd the halos, off[t] table t's global offset.
struct TableSet {
  int32_t n_tables, n_groups, scan_words, back, fwd, pad;
  StreamRef s[kMaxTables];
  int32_t q[kMaxTables];
  int32_t off[kMaxTables];
  int32_t col_start[kMaxTables + 1];
  int32_t word_base[kMaxTables + 1];
  int32_t group_table[kMaxTables][kGroupTables];
};

// The verify's corpus arrays, built once per corpus (kernels.VerifyCorpusC,
// same field order): the stacked [T, gmax] group and [T, emax] entry
// tables, then the slot bytes [NS, kVerifyWidth] and lengths [NS].
struct VerifyCorpus {
  const uint32_t* group_h1;
  const int32_t* entry_start;
  const int32_t* entry_count;
  const int32_t* n_groups;  // [T]
  const uint32_t* entry_h2;
  const int32_t* entry_slot;
  const int32_t* entry_off;
  const int32_t* entry_len;
  const int32_t* entry_suf_delta;
  const uint32_t* entry_suf_h1;
  const uint32_t* entry_suf_h2;
  const uint8_t* slot_bytes;
  const int32_t* slot_len;
  int32_t gmax, emax, max_group, n_tables;
};

__device__ __forceinline__ uint32_t lower_ascii(uint32_t c) {
  return (c >= 65u && c <= 90u) ? c + 32u : c;
}

// the four bytes of x ASCII-lowercased ('A'..'Z' get bit 5)
__device__ __forceinline__ uint32_t lower4(uint32_t x) {
  return x | (__vcmpgeu4(x, 0x41414141u) & __vcmpleu4(x, 0x5a5a5a5au) & 0x20202020u);
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

// inclusive scan of v over the warp's lanes
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// out[i] = v_0 + ... + v_(i-1) for i in [0, 64], of 64 values held two a
// lane (v0: value lane, v1: value 32 + lane); by one whole warp
__device__ __forceinline__ void exclusive_scan64(int v0, int v1, int lane, int* out) {
  const int i0 = warp_scan(v0, lane);
  const int total0 = __shfl_sync(kFullMask, i0, 31);
  const int i1 = warp_scan(v1, lane);
  out[lane] = i0 - v0;
  out[32 + lane] = total0 + i1 - v1;
  if (lane == 31) out[64] = total0 + i1;
}

// ---------------------------------------------------------------------------
// Phase A

// byte p of the word's bytes (p a constant once the caller is unrolled)
__device__ __forceinline__ uint32_t word_byte(const uint32_t (&w)[kWordBytes / 4], int p) {
  return (w[p >> 2] >> (8 * (p & 3))) & 0xFFu;
}

// the 4-gram hash at p under the powers r1 = base, r2 = base^2, r3 = base^3
__device__ __forceinline__ uint32_t gram4(const uint32_t (&w)[kWordBytes / 4], int p, uint32_t r1,
                                          uint32_t r2, uint32_t r3) {
  return word_byte(w, p) + r1 * word_byte(w, p + 1) + r2 * word_byte(w, p + 2) +
         r3 * word_byte(w, p + 3);
}

// bytes [p, p + kWordBytes) of row b, zero at or past the width, as
// little-endian words, lowered when the view is
__device__ __forceinline__ void load_word_bytes(const StreamRef& s, int b, int p,
                                                uint32_t (&w)[kWordBytes / 4]) {
  const uint8_t* row = s.data + (size_t)b * s.width;
  if (p + kWordBytes <= s.width && (reinterpret_cast<uintptr_t>(row + p) & 7u) == 0u) {
    const uint2* src = reinterpret_cast<const uint2*>(row + p);
#pragma unroll
    for (int i = 0; i < kWordBytes / 8; ++i) {
      const uint2 v = __ldg(src + i);
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWordBytes / 4; ++i) w[i] = 0u;
#pragma unroll
    for (int j = 0; j < kWordBytes; ++j) {
      if (p + j < s.width) w[j >> 2] |= (uint32_t)row[p + j] << (8 * (j & 3));
    }
  }
  if (s.lowered) {
#pragma unroll
    for (int i = 0; i < kWordBytes / 4; ++i) w[i] = lower4(w[i]);
  }
}

// the windows of table t in row b that can begin a gram: those below
// its local width whose global position is at most len - q
__device__ __forceinline__ int live_windows(const TableSet& ts, int t, int b) {
  const int w = ts.s[t].width - ts.back - ts.fwd;
  return max(min(w, __ldg(ts.s[t].len + b) - ts.off[t] - ts.q[t] + 1), 0);
}

// both bloom bits of (h1, h2) in a table's bitmap in shared memory
__device__ __forceinline__ uint32_t bloom_bit(const uint32_t* sb, uint32_t h1, uint32_t h2) {
  const uint32_t i1 = h1 & (kBloomBits - 1), i2 = h2 & (kBloomBits - 1);
  return (sb[i1 >> 5] >> (i1 & 31)) & (sb[i2 >> 5] >> (i2 & 31)) & 1u;
}

// The fired-window masks of word k of group g in row b: mask[j] bit i is
// window 32 k + i of the group's table j (hashed at back + 32 k + i);
// live[j] of the word's windows
// can fire (the rest are masked off).  sbloom holds the group's bitmaps,
// kBloomWords a table.  For q = 4 and q = 8 the hashes come from the
// word's bytes in registers, both q at once; any other q hashes each
// window from its bytes.
__device__ __forceinline__ void probe_group_word(const TableSet& ts, const uint32_t* sbloom,
                                                 int g, int b, int k,
                                                 const int (&live)[kGroupTables],
                                                 uint32_t (&mask)[kGroupTables]) {
  int tab[kGroupTables];
  bool fast = true;
#pragma unroll
  for (int j = 0; j < kGroupTables; ++j) {
    const int t = ts.group_table[g][j];
    tab[j] = t < 0 ? ts.group_table[g][0] : t;  // an absent table has no live window
    fast &= ts.q[tab[j]] == 4 || ts.q[tab[j]] == 8;
    mask[j] = 0u;
  }
  const StreamRef s = ts.s[tab[0]];
  if (!fast) {
#pragma unroll
    for (int j = 0; j < kGroupTables; ++j) {
      for (int i = 0; i < live[j]; ++i) {
        uint32_t h1, h2;
        hash_at(s, ts.q[tab[j]], b, ts.back + kWordWindows * k + i, h1, h2);
        mask[j] |= bloom_bit(sbloom + j * kBloomWords, h1, h2) << i;
      }
    }
    return;
  }
  uint32_t w[kWordBytes / 4];
  load_word_bytes(s, b, ts.back + kWordWindows * k, w);
  bool eight[kGroupTables];
#pragma unroll
  for (int j = 0; j < kGroupTables; ++j) eight[j] = ts.q[tab[j]] == 8;
  constexpr uint32_t a1 = kBase1, a2 = a1 * kBase1, a3 = a2 * kBase1, a4 = a3 * kBase1;
  constexpr uint32_t c1 = kBase2, c2 = c1 * kBase2, c3 = c2 * kBase2, c4 = c3 * kBase2;
  // kProbeBatch windows a step, the step not unrolled (unrolled, the
  // compiler hoists every step's loads and spills): w holds the step's
  // bytes from w[0], shifted down after each step
#pragma unroll 1
  for (int i0 = 0; i0 < kWordWindows; i0 += kProbeBatch) {
#pragma unroll
    for (int ii = 0; ii < kProbeBatch; ++ii) {
      // h4 at ii and at ii + 4; h8 at ii = h4(ii) + base^4 h4(ii + 4)
      const uint32_t x1 = gram4(w, ii, a1, a2, a3), x2 = gram4(w, ii, c1, c2, c3);
      const uint32_t y1 = gram4(w, ii + 4, a1, a2, a3), y2 = gram4(w, ii + 4, c1, c2, c3);
      const uint32_t e1 = x1 + a4 * y1, e2 = x2 + c4 * y2;
#pragma unroll
      for (int j = 0; j < kGroupTables; ++j) {
        const uint32_t bit = bloom_bit(sbloom + j * kBloomWords, eight[j] ? e1 : x1,
                                       eight[j] ? e2 : x2);
        mask[j] |= (i0 + ii < live[j] ? bit : 0u) << (i0 + ii);
      }
    }
#pragma unroll
    for (int q = 0; q + kProbeBatch / 4 < kWordBytes / 4; ++q) w[q] = w[q + kProbeBatch / 4];
  }
}

// Pass 1: a block takes one group's tables for kProbeRows rows.  It
// stages the group's bitmaps (32 KB a table) in shared memory, and each
// thread then probes whole words of those rows, writing each table's
// mask to the word's slot, masks[b, word_base[t] + k] (live words only).
__global__ void __launch_bounds__(kPhaseAThreads)
match_phase_a_probe_kernel(const TableSet ts, const uint32_t* __restrict__ bloom, int n_rows,
                           uint32_t* __restrict__ masks) {
  extern __shared__ uint4 sbloom4[];  // [kGroupTables][kBloomWords] words
  __shared__ int s_live[kProbeRows][kGroupTables];  // each row's live windows a table
  __shared__ int s_rbase[kProbeRows + 1];            // each row's first word of the block
  const uint32_t* sbloom = reinterpret_cast<const uint32_t*>(sbloom4);
  const int g = blockIdx.y, r0 = blockIdx.x * kProbeRows;
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < kGroupTables; ++j) {
    const int t = ts.group_table[g][j];
    if (t < 0) continue;
    const uint4* src = reinterpret_cast<const uint4*>(bloom + (size_t)t * kBloomWords);
    for (int i = tid; i < kBloomWords / 4; i += kPhaseAThreads) {
      sbloom4[j * (kBloomWords / 4) + i] = __ldg(src + i);
    }
  }
  if (tid < 32) {
    int words = 0;
    if (lane < kProbeRows) {
#pragma unroll
      for (int j = 0; j < kGroupTables; ++j) {
        const int t = ts.group_table[g][j];
        int live = 0;
        if (t >= 0 && r0 + lane < n_rows) live = live_windows(ts, t, r0 + lane);
        s_live[lane][j] = live;
        words = max(words, (live + kWordWindows - 1) / kWordWindows);
      }
    }
    const int inc = warp_scan(words, lane);
    if (lane < kProbeRows) s_rbase[lane] = inc - words;
    if (lane == kProbeRows - 1) s_rbase[kProbeRows] = inc;
  }
  __syncthreads();
  const int total = s_rbase[kProbeRows];
  for (int x = tid; x < total; x += kPhaseAThreads) {
    int r = 0;
    while (s_rbase[r + 1] <= x) ++r;
    const int k = x - s_rbase[r], b = r0 + r;
    int live[kGroupTables];
#pragma unroll
    for (int j = 0; j < kGroupTables; ++j) {
      live[j] = min(max(s_live[r][j] - kWordWindows * k, 0), kWordWindows);
    }
    uint32_t m[kGroupTables];
    probe_group_word(ts, sbloom, g, b, k, live, m);
#pragma unroll
    for (int j = 0; j < kGroupTables; ++j) {
      const int t = ts.group_table[g][j];
      if (t >= 0 && live[j] > 0) masks[(size_t)b * ts.scan_words + ts.word_base[t] + k] = m[j];
    }
  }
}

// Pass 2: a block a row.  The row's live (table, word) slots in
// table-major order, a contiguous run of them a thread, one block-wide
// exclusive scan of the runs' popcounts, then each thread writes its
// fired columns with rank < kclamp, and the -1 tail; n_surv is the total.
__global__ void __launch_bounds__(kPhaseAThreads)
match_phase_a_rank_kernel(const TableSet ts, const uint32_t* __restrict__ masks, int budget,
                          int kclamp, int32_t* __restrict__ col, int32_t* __restrict__ n_surv) {
  __shared__ int s_wbase[kMaxTables + 1];  // each table's first live slot; [n_tables] = all
  __shared__ int s_warp[kPhaseAThreads / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* out = col + (size_t)b * budget;
  const uint32_t* row = masks + (size_t)b * ts.scan_words;
  if (warp == 0) {
    int nw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      nw[h] = 0;
      if (t < ts.n_tables) nw[h] = (live_windows(ts, t, b) + kWordWindows - 1) / kWordWindows;
    }
    exclusive_scan64(nw[0], nw[1], lane, s_wbase);
  }
  __syncthreads();
  const int slots = s_wbase[ts.n_tables];
  const int per = (slots + kPhaseAThreads - 1) / kPhaseAThreads;
  const int j0 = min(slots, tid * per), j1 = min(slots, j0 + per);
  int t0 = 0;
  while (j0 < j1 && s_wbase[t0 + 1] <= j0) ++t0;
  int cnt = 0;
  for (int j = j0, t = t0; j < j1; ++j) {
    while (s_wbase[t + 1] <= j) ++t;
    cnt += __popc(__ldg(row + ts.word_base[t] + j - s_wbase[t]));
  }
  const int inc = warp_scan(cnt, lane);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kPhaseAThreads / 32; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  int rank = before + inc - cnt;
  for (int j = j0, t = t0; j < j1 && rank < kclamp; ++j) {
    while (s_wbase[t + 1] <= j) ++t;
    const int k = j - s_wbase[t];
    const int base = ts.col_start[t] + kWordWindows * k;
    uint32_t m = __ldg(row + ts.word_base[t] + k);
    while (m != 0u && rank < kclamp) {
      out[rank++] = base + __ffs(m) - 1;
      m &= m - 1u;
    }
  }
  for (int r = min(total, kclamp) + tid; r < budget; r += kPhaseAThreads) out[r] = -1;
  if (tid == 0) n_surv[b] = total;
}

// ---------------------------------------------------------------------------
// Phase B: gather-verify

// (h1, h2) of bytes[p, p + q) of row b by the whole warp: lane j < q
// reads byte p + j (zero past the width) times base^j (pw1 / pw2), and
// the 8-lane group sums them
__device__ __forceinline__ void warp_gram_hash(const StreamRef& s, int q, int b, int p,
                                               uint32_t pw1, uint32_t pw2, int lane,
                                               uint32_t& h1, uint32_t& h2) {
  const uint32_t byte = lane < q ? read_byte(s, b, p + lane) : 0u;
  h1 = byte * pw1;
  h2 = byte * pw2;
#pragma unroll
  for (int d = 1; d < kGramLanes; d <<= 1) {
    h1 += __shfl_xor_sync(kFullMask, h1, d);
    h2 += __shfl_xor_sync(kFullMask, h2, d);
  }
  h1 = __shfl_sync(kFullMask, h1, 0);
  h2 = __shfl_sync(kFullMask, h2, 0);
}

// One live candidate column c of row b, by the whole warp.  cs0 / cs1:
// the column starts of tables lane and 32 + lane (INT_MAX past the
// last); pw1 / pw2: base^lane, the lane's power of the window hash.
__device__ __forceinline__ void verify_candidate(const TableSet& ts, const VerifyCorpus& vc,
                                                 int c, int b, int cs0, int cs1, uint32_t pw1,
                                                 uint32_t pw2, int lane, uint8_t* value,
                                                 uint8_t* unc, int plane_width) {
  // its table: the last t with col_start[t] <= c
  const unsigned le0 = __ballot_sync(kFullMask, cs0 <= c);
  const unsigned le1 = __ballot_sync(kFullMask, cs1 <= c);
  const int t = le1 ? 63 - __clz(le1) : 31 - __clz(le0);
  const StreamRef s = ts.s[t];
  const int q = ts.q[t];
  const int cpos = ts.back + c - ts.col_start[t];  // in the view
  const int slen = __ldg(s.len + b);
  const int goff = ts.off[t] - ts.back;  // view position -> global position
  uint32_t h1, h2;
  warp_gram_hash(s, q, b, cpos, pw1, pw2, lane, h1, h2);

  // the lower bound of h1 in group_h1[t, :ng]: 32 pivots a level, one a
  // lane; the lanes whose pivot is below h1 are a prefix, their count
  // picks the interval
  const uint32_t* gh = vc.group_h1 + (size_t)t * vc.gmax;
  const int ng = __ldg(vc.n_groups + t);
  int lo = 0, hi = ng;  // the bound lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + kFanOut - 1) / kFanOut;
    const int i = lo + (lane + 1) * step - 1;
    const bool below = i < hi && __ldg(gh + min(i, vc.gmax - 1)) < h1;
    const int n = __popc(__ballot_sync(kFullMask, below));
    lo += n * step;
    hi = min(lo + step - 1, hi);
  }
  if (lo >= ng) return;
  const int gidx = min(lo, vc.gmax - 1);
  const size_t grow = (size_t)t * vc.gmax + gidx;
  const uint32_t g1 = __ldg(gh + gidx);
  const int e_start = __ldg(vc.entry_start + grow), e_count = __ldg(vc.entry_count + grow);
  if (g1 != h1) return;
  const int n_e = min(vc.max_group, e_count);
  const size_t erow = (size_t)t * vc.emax;
  for (int g0 = 0; g0 < n_e; g0 += 32) {
    // lane g screens entry g0 + g: h2, the suffix gram, the word's bounds
    bool hit = false;
    int start = 0, slot = 0, nv = 0;
    if (g0 + lane < n_e) {
      const size_t e = erow + min(e_start + g0 + lane, vc.emax - 1);
      const uint32_t eh2 = __ldg(vc.entry_h2 + e);
      const int spos = cpos + __ldg(vc.entry_suf_delta + e);
      const uint32_t sh1 = __ldg(vc.entry_suf_h1 + e), sh2 = __ldg(vc.entry_suf_h2 + e);
      const int off = __ldg(vc.entry_off + e), len = __ldg(vc.entry_len + e);
      slot = __ldg(vc.entry_slot + e);
      if (eh2 == h2 && spos >= 0 && spos < s.width) {
        uint32_t s1, s2;
        hash_at(s, q, b, spos, s1, s2);
        start = cpos - off;
        hit = s1 == sh1 && s2 == sh2 && start + goff >= 0 && start + goff + len <= slen &&
              start >= 0 && start + len <= s.width;
        nv = min(len, kVerifyWidth);
      }
    }
    // each entry that passes: its verify bytes across the warp, two a
    // lane, in one load round
    unsigned todo = __ballot_sync(kFullMask, hit);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int st = __shfl_sync(kFullMask, start, src);
      const int n = __shfl_sync(kFullMask, nv, src);
      const int sl = __shfl_sync(kFullMask, slot, src);
      const uint8_t* want = vc.slot_bytes + (size_t)sl * kVerifyWidth;
      bool eq = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 2 * lane + h;
        if (o < n) eq &= read_byte(s, b, st + o) == (uint32_t)__ldg(want + o);
      }
      if (__all_sync(kFullMask, eq) && lane == 0) {
        value[(size_t)b * plane_width + sl] = 1;
        if (__ldg(vc.slot_len + sl) > kVerifyWidth) unc[(size_t)b * plane_width + sl] = 1;
      }
    }
  }
}

// The warps stride over the (candidate, row) slots j * n_rows + b, slot
// s on warp s mod n_warps, 32 of a warp's slots checked with one load a
// lane; the dead ones (-1) leave at once, each live one takes the warp.
// Candidate-major, the live prefixes of all rows fill the low slots and
// land on distinct warps: no kc can line a row's candidates up on one
// warp.
__global__ void __launch_bounds__(32 * kVerifyWarps)
match_verify_kernel(const TableSet ts, const VerifyCorpus vc, const int32_t* __restrict__ col,
                    int col_stride, int kc, int n_rows, uint8_t* __restrict__ value,
                    uint8_t* __restrict__ unc, int plane_width) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kVerifyWarps;
  const long long warp_id = (long long)blockIdx.x * kVerifyWarps + (threadIdx.x >> 5);
  const int cs0 = lane < ts.n_tables ? ts.col_start[lane] : INT_MAX;
  const int cs1 = lane + 32 < ts.n_tables ? ts.col_start[lane + 32] : INT_MAX;
  uint32_t pw1 = 1u, pw2 = 1u;
  for (int j = 0; j < (lane & (kGramLanes - 1)); ++j) {
    pw1 *= kBase1;
    pw2 *= kBase2;
  }
  const long long slots = (long long)n_rows * kc;
  for (long long s0 = warp_id; s0 < slots; s0 += 32 * n_warps) {
    const long long slot = s0 + lane * n_warps;
    int c = -1, b = 0;
    if (slot < slots) {
      b = (int)(slot % n_rows);
      c = __ldg(col + (size_t)b * col_stride + (int)(slot / n_rows));
    }
    unsigned live = __ballot_sync(kFullMask, c >= 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      verify_candidate(ts, vc, __shfl_sync(kFullMask, c, src), __shfl_sync(kFullMask, b, src),
                       cs0, cs1, pw1, pw2, lane, value, unc, plane_width);
    }
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

}  // namespace

extern "C" {

int match_max_tables() { return kMaxTables; }
int match_max_variants() { return kMaxVariants; }

// Phase A over n_rows rows, two launches.  tables: the batch's TableSet
// (kernels.TableSetC), a host struct passed as void* so that no type of
// the unnamed namespace is in the exported signature; bloom int32 [T,
// BLOOM_WORDS]; masks int32 scratch [B, scan_words]; col int32 [B,
// budget]; n_surv int32 [B].
int match_phase_a(const void* tables, int32_t n_rows, const int32_t* bloom, int32_t budget,
                  int32_t kclamp, int32_t* masks, int32_t* col, int32_t* n_surv,
                  void* stream) {
  const TableSet& ts = *static_cast<const TableSet*>(tables);
  if (ts.n_tables < 1 || ts.n_tables > kMaxTables || ts.n_groups < 1 ||
      ts.n_groups > kMaxTables || kclamp < 1 || kclamp > budget)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)kGroupTables * kBloomWords * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(match_phase_a_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_rows + kProbeRows - 1) / kProbeRows, ts.n_groups);
  match_phase_a_probe_kernel<<<grid, kPhaseAThreads, smem, st>>>(
      ts, reinterpret_cast<const uint32_t*>(bloom), n_rows, reinterpret_cast<uint32_t*>(masks));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  match_phase_a_rank_kernel<<<n_rows, kPhaseAThreads, 0, st>>>(
      ts, reinterpret_cast<const uint32_t*>(masks), budget, kclamp, col, n_surv);
  return (int)cudaGetLastError();
}

// Gather-verify of col[:, :kc] (row stride col_stride).  tables: the
// batch's TableSet; corpus: the VerifyCorpus (kernels.VerifyCorpusC),
// both host structs passed as void*; value and unc zeroed bool [B,
// plane_width]; sms, the card's SM count, which the caller reads once.
int match_verify(const void* tables, const void* corpus, int32_t n_rows, const int32_t* col,
                 int32_t col_stride, int32_t kc, uint8_t* value, uint8_t* unc,
                 int32_t plane_width, int32_t sms, void* stream) {
  const TableSet& ts = *static_cast<const TableSet*>(tables);
  const VerifyCorpus& vc = *static_cast<const VerifyCorpus*>(corpus);
  if (ts.n_tables < 1 || ts.n_tables > kMaxTables || vc.n_tables != ts.n_tables ||
      vc.gmax < 1 || vc.emax < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long slots = (long long)n_rows * kc;
  if (slots == 0) return 0;
  const long long warps = std::min<long long>(slots, (long long)kVerifyWarpsPerSm * sms);
  const int blocks = (int)((warps + kVerifyWarps - 1) / kVerifyWarps);
  match_verify_kernel<<<blocks, 32 * kVerifyWarps, 0, (cudaStream_t)stream>>>(
      ts, vc, col, col_stride, kc, n_rows, value, unc, plane_width);
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
