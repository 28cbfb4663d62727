"""Phase A and the gather-verify as kernels ``match_phase_a`` and
``match_verify`` compute them, walked in numpy and held to the JAX package.

Every comparison is exact: the values are int32 columns and bools. The
kernels (``ops/csrc/match.cu``) run only on a card; here each design is
transcribed step by step:

- :func:`walk_phase_a`: the probe pass, per (stream, lowered) group of
  up to ``GROUP_TABLES`` tables, each 32-window word's 40 bytes,
  lowered; the 4-gram hash at 36 positions and the 8-gram as h4(p) +
  base^4 h4(p + 4) (other gram sizes hashed from their bytes); both
  bloom bits a window; fired windows as a mask a (table, word) slot,
  windows past the table's live count masked off. Then the rank pass:
  a row's live slots in table-major order, a contiguous run of them a
  thread of the ``PHASE_A_THREADS``-thread block, one exclusive scan of
  the runs' popcounts, and each run's fired columns written at their
  ranks below kclamp, then the -1 tail.
- :func:`walk_verify`: per live candidate, its table by a ballot over
  the column starts, the window hash one byte a lane summed over
  ``GRAM_LANES`` lanes, the lower bound by a ``FAN_OUT``-way search (one
  pivot a lane, the count of pivots below h1 picks the interval), the
  group's entries screened one a lane (h2, suffix gram, bounds), and
  each surviving entry's bytes compared two a lane across the warp.

Each walk takes the kernel's place and is held to the JAX
``prefilter_counts`` + ``compact_candidates`` and ``verify_candidates``
on the tree and synthetic corpora at every survivor-ladder width, and on
edge cases (``chip_smoke.candidate_edges``): widths that are not a
multiple of 32, gram sizes other than 4 and 8, rows shorter than q, 0
and 1 rows, kclamp below the budget, an overflow row, tables without
groups, groups past emax, slots longer than 64 bytes and suffix grams
outside the width. The tests marked ``cuda`` hold the kernels to their
plain versions on the same cases on the card.
"""

import dataclasses
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarm_tpu.fingerprints.compile as j_compile
from chip_smoke import candidate_edges
from swarm_tpu.ops import match as jm
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.ops import hashing, kernels
from swarm_tpu_torch.ops import match as tm
from test_torch_match import (ENGINE_ENCODE, dense_row, encode_both, jax_streams, jax_tree,
                              load_tree, row_dicts, synthetic, torch_streams)
from test_match_parity import DATA


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines of both packages that walk
    inline (``SWARM_WALK_THREADS=1``) unless a test sets their walk: six
    test processes share the host, and no result depends on either."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


SOURCE = Path(kernels.__file__).parent / "csrc" / "match.cu"
#: the kernels' constants (csrc/match.cu), as the walks take them
PHASE_A_THREADS = 256  # kPhaseAThreads: the rank pass's block, a row
WORD_WINDOWS = 32  # kWordWindows: a thread's word
WORD_BYTES = 40  # kWordBytes: the bytes a word's hashes read
GROUP_TABLES = 2  # kGroupTables
FAN_OUT = 32  # kFanOut: pivots a level of the group search
GRAM_LANES = 8  # kGramLanes: lanes of the window hash
VERIFY_WIDTH = 64  # kVerifyWidth
U32 = np.uint64(0xFFFFFFFF)


def _u32(x) -> np.ndarray:
    """Integer array → uint32 (int32 bit patterns as they are)."""
    return np.asarray(x).astype(np.int64).astype(np.uint64) & U32


def _powers(base: int, n: int) -> np.ndarray:
    out = np.ones(n, dtype=np.uint64)
    for j in range(1, n):
        out[j] = (out[j - 1] * np.uint64(base)) & U32
    return out


P1 = _powers(int(hashing.BASE1), 8)
P2 = _powers(int(hashing.BASE2), 8)


def _lowered(data: np.ndarray, lowered: bool) -> np.ndarray:
    if not lowered:
        return data
    return np.where((data >= 65) & (data <= 90), data + 32, data).astype(np.uint8)


# ---------------------------------------------------------------------------
# Phase A, walked


def _word_bytes(data: np.ndarray, nwords: int) -> np.ndarray:
    """[B, W] bytes → [B, nwords, WORD_BYTES]: word k's bytes [32 k, 32 k
    + 40), zero at or past W (the kernel's 8-byte loads, or its byte
    loads at the edge)."""
    B, W = data.shape
    padded = np.zeros((B, nwords * WORD_WINDOWS + WORD_BYTES), dtype=np.uint64)
    padded[:, :W] = data
    idx = WORD_WINDOWS * np.arange(nwords)[:, None] + np.arange(WORD_BYTES)[None, :]
    return padded[:, idx]


def _gram(wb: np.ndarray, q: int, pw: np.ndarray, start: int, n: int) -> np.ndarray:
    """The q-gram hashes at word positions start .. start + n - 1."""
    h = np.zeros(wb.shape[:2] + (n,), dtype=np.uint64)
    for j in range(q):
        h = (h + wb[..., start + j:start + j + n] * pw[j]) & U32
    return h


def walk_phase_a(views, qs, col_starts, bloom, budget: int, kclamp: int) -> tuple:
    """Phase A as the kernel computes it → (col int32 [B, budget], n_surv
    int32 [B]). The groups are the launch descriptor's
    (``kernels.MatchTables``)."""
    st = kernels.MatchTables(views, qs, col_starts).struct
    T, B = st.n_tables, views[0].data.shape[0]
    bloom = _u32(bloom.numpy())
    lens = np.stack([v.lengths.numpy().astype(np.int64) for v in views], 1)  # [B, T]
    widths = np.array([v.data.shape[1] for v in views])
    q = np.array([st.q[t] for t in range(T)])
    nwin = np.clip(np.minimum(widths[None, :], lens - q[None, :] + 1), 0, None)
    nw = (nwin + WORD_WINDOWS - 1) // WORD_WINDOWS
    masks = {}
    for g in range(st.n_groups):
        group = [t for t in st.group_table[g] if t >= 0]
        v = views[group[0]]
        nwords = (v.data.shape[1] + WORD_WINDOWS - 1) // WORD_WINDOWS
        wb = _word_bytes(_lowered(v.data.numpy(), v.lowered), nwords)
        fast = all(q[t] in (4, 8) for t in group)
        if fast:  # h4 at 36 positions, h8 from it
            h4 = _gram(wb, 4, P1, 0, WORD_WINDOWS + 4), _gram(wb, 4, P2, 0, WORD_WINDOWS + 4)
        for t in group:
            if not fast:
                h = _gram(wb, q[t], P1, 0, WORD_WINDOWS), _gram(wb, q[t], P2, 0, WORD_WINDOWS)
            elif q[t] == 4:
                h = tuple(x[..., :WORD_WINDOWS] for x in h4)
            else:
                h = tuple((x[..., :WORD_WINDOWS] + p[4] * x[..., 4:]) & U32
                          for x, p in zip(h4, (P1, P2)))
            i1, i2 = (x & np.uint64(hashing.BLOOM_BITS - 1) for x in h)
            rows = bloom[t]
            bit = (rows[(i1 >> np.uint64(5)).astype(np.int64)] >> (i1 & np.uint64(31))) & (
                rows[(i2 >> np.uint64(5)).astype(np.int64)] >> (i2 & np.uint64(31))) & np.uint64(1)
            window = WORD_WINDOWS * np.arange(nwords)[:, None] + np.arange(WORD_WINDOWS)
            live = window[None] < nwin[:, t, None, None]
            fired = (bit == 1) & live
            masks[t] = np.bitwise_or.reduce(
                fired.astype(np.uint64) << np.arange(WORD_WINDOWS, dtype=np.uint64), axis=2)
    col = np.full((B, budget), -1, dtype=np.int32)
    n_surv = np.zeros(B, dtype=np.int32)
    for b in range(B):
        # the row's (table, word) slots, table-major
        slots = [(t, k, int(masks[t][b, k])) for t in range(T) for k in range(nw[b, t])]
        per = -(-len(slots) // PHASE_A_THREADS)
        runs = [slots[i * per:(i + 1) * per] for i in range(PHASE_A_THREADS)] if per else []
        counts = [sum(bin(m).count("1") for _, _, m in run) for run in runs]
        ranks = np.concatenate([[0], np.cumsum(counts)]).astype(int)
        for run, rank in zip(runs, ranks):
            for t, k, m in run:
                for i in range(WORD_WINDOWS):
                    if m >> i & 1 and rank < kclamp:
                        col[b, rank] = st.col_start[t] + WORD_WINDOWS * k + i
                        rank += 1
        n_surv[b] = ranks[-1] if len(ranks) else 0
        col[b, min(n_surv[b], kclamp):] = -1
    return col, n_surv


# ---------------------------------------------------------------------------
# The gather-verify, walked


def fan_out_lower_bound(gh: np.ndarray, ng: int, gmax: int, h1: int) -> int:
    """The kernel's group search: the first i < ng with gh[i] >= h1 (ng
    if none), FAN_OUT pivots a level, one a lane; the lanes whose pivot
    is below h1 are a prefix, and their count picks the interval."""
    lo, hi = 0, ng
    while hi > lo:
        step = -(-(hi - lo) // FAN_OUT)
        below = sum(1 for lane in range(FAN_OUT)
                    if (i := lo + (lane + 1) * step - 1) < hi and gh[min(i, gmax - 1)] < h1)
        lo += below * step
        hi = min(lo + step - 1, hi)
    return lo


def walk_verify(views, qs, col_starts, col, kc: int, tab: dict, max_group: int, slot_bytes,
                slot_len, plane_width: int) -> tuple:
    """The verify as the kernel computes it → (value, unc) bool [B,
    plane_width]. A warp a live candidate; the order of the candidates
    does not matter, every write being a 1 into zeroed planes."""
    st = kernels.MatchTables(views, qs, col_starts).struct
    T = st.n_tables
    streams = [_lowered(v.data.numpy(), v.lowered) for v in views]
    lens = [v.lengths.numpy() for v in views]
    t_np = {k: np.asarray(tab[k]) for k in kernels.VERIFY_TABLE_KEYS}
    for k in ("group_h1", "entry_h2", "entry_suf_h1", "entry_suf_h2"):
        t_np[k] = _u32(t_np[k])
    gmax, emax = t_np["group_h1"].shape[1], t_np["entry_h2"].shape[1]
    sb, sl = np.asarray(slot_bytes), np.asarray(slot_len)
    B = col.shape[0]
    value = np.zeros((B, plane_width), dtype=bool)
    unc = np.zeros((B, plane_width), dtype=bool)
    starts = [st.col_start[t] for t in range(T)]

    def window_hash(t: int, b: int, pos: int) -> tuple:
        # lane j < q holds byte pos + j (zero past W), times base^j
        row, q = streams[t][b], st.q[t]
        byte = [int(row[pos + j]) if j < q and 0 <= pos + j < len(row) else 0
                for j in range(GRAM_LANES)]
        return (int(sum(c * int(P1[j]) for j, c in enumerate(byte)) & 0xFFFFFFFF),
                int(sum(c * int(P2[j]) for j, c in enumerate(byte)) & 0xFFFFFFFF))

    for b, j in zip(*np.nonzero(np.asarray(col)[:, :kc] >= 0)):
        c = int(col[b, j])
        t = max(lane for lane in range(T) if starts[lane] <= c)  # the ballot's top bit
        cpos, W = c - starts[t], streams[t].shape[1]
        h1, h2 = window_hash(t, b, cpos)
        gh, ng = t_np["group_h1"][t], int(t_np["n_groups"][t])
        lo = fan_out_lower_bound(gh, ng, gmax, h1)
        if lo >= ng:
            continue
        gidx = min(lo, gmax - 1)
        if gh[gidx] != h1:
            continue
        e_start, e_count = int(t_np["entry_start"][t, gidx]), int(t_np["entry_count"][t, gidx])
        n_e = min(max_group, e_count)
        for g0 in range(0, n_e, 32):
            hits = []  # lane by lane: (start, bytes, slot) of the entries that pass
            for lane in range(min(32, n_e - g0)):
                e = min(e_start + g0 + lane, emax - 1)
                spos = cpos + int(t_np["entry_suf_delta"][t, e])
                if t_np["entry_h2"][t, e] != h2 or not 0 <= spos < W:
                    continue
                s1, s2 = window_hash(t, b, spos)
                start = cpos - int(t_np["entry_off"][t, e])
                n = int(t_np["entry_len"][t, e])
                if (s1 == t_np["entry_suf_h1"][t, e] and s2 == t_np["entry_suf_h2"][t, e]
                        and start >= 0 and start + n <= lens[t][b] and start + n <= W):
                    hits.append((start, min(n, VERIFY_WIDTH), int(t_np["entry_slot"][t, e])))
            for start, n, slot in hits:
                # two bytes a lane, then all lanes agree
                eq = all(streams[t][b, start + o] == sb[slot, o]
                         for lane in range(32) for o in (2 * lane, 2 * lane + 1) if o < n)
                if eq:
                    value[b, slot] = True
                    unc[b, slot] |= bool(sl[slot] > VERIFY_WIDTH)
    return value, unc


# ---------------------------------------------------------------------------
# Inputs: both packages from one set of numpy arrays


class Case:
    """One batch's phase A and verify inputs for both packages, from
    numpy streams (after the "all" synthesis), lengths, gram sizes,
    verify tables and slot lengths."""

    def __init__(self, c, base_p, streams, lengths, table_q, tab_np, slot_bytes, slot_len):
        self.c = c
        self.t_meta = dataclasses.replace(base_p["t_meta"], table_q=tuple(table_q))
        self.j_meta = dataclasses.replace(base_p["j_meta"], table_q=tuple(table_q))
        self.tab_np = dict(base_p["j_np"]["tab"], **tab_np)
        ts = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in streams.items()}
        tl = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lengths.items()}
        self.js = {k: jnp.asarray(v) for k, v in streams.items()}
        self.jl = {k: jnp.asarray(v) for k, v in lengths.items()}
        self.views = tm.table_views(self.t_meta, ts, tl)
        self.cs = tm.col_starts_of(self.t_meta, ts)
        self.tab = tm.to_device(self.tab_np, torch.device("cpu"))
        self.slot_bytes = torch.from_numpy(np.ascontiguousarray(slot_bytes))
        self.slot_len = torch.from_numpy(np.ascontiguousarray(slot_len, dtype=np.int32))
        self.plane_width = max(c.t_db.num_slots, 1)

    @property
    def qs(self):
        return self.t_meta.table_q

    def jax_counts(self) -> np.ndarray:
        meta = self.j_meta
        assert np.array_equal(jm._col_starts_of(meta, self.js), self.cs)
        run = jax.jit(lambda tab, s, ln: jm.prefilter_counts(meta, tab, jm._StreamCtx(s, ln))[0])
        return np.asarray(run(jax_tree(self.tab_np), self.js, self.jl))

    def jax_verify(self, col: np.ndarray) -> tuple:
        meta, cs, ns, db = self.j_meta, self.cs, self.c.j_db.num_slots, self.c.j_db

        @jax.jit
        def run(tab, slot_bytes, slot_len, s, ln, col):
            return jm.verify_candidates(meta, tab, slot_bytes, slot_len,
                                        jm._StreamCtx(s, ln), col, cs, ns)

        v, u = run(jax_tree(self.tab_np), jnp.asarray(self.slot_bytes.numpy()),
                   jnp.asarray(self.slot_len.numpy()), self.js, self.jl, jnp.asarray(col))
        return np.asarray(v), np.asarray(u)

    def verify_args(self, col, kc: int) -> tuple:
        return (self.views, self.qs, self.cs, col, kc, self.tab, self.t_meta.max_group,
                self.slot_bytes, self.slot_len, self.plane_width)


def base_case(c, dicts) -> Case:
    jb, tb = encode_both(dicts, **ENGINE_ENCODE)
    j_meta, j_np = j_compile.build_device_layout(c.j_db)
    t_meta, t_np = t_compile.build_device_layout(c.t_db)
    ts, tl = torch_streams(tb)
    js, _jl = jax_streams(jb)
    assert all(np.array_equal(np.asarray(js[k]), ts[k].numpy()) for k in ts)
    base_p = {"t_meta": t_meta, "j_meta": j_meta, "j_np": j_np}
    return Case(c, base_p, {k: v.numpy() for k, v in ts.items()},
                {k: v.numpy() for k, v in tl.items()}, t_meta.table_q, {},
                c.t_db.slot_bytes, c.t_db.slot_len)


@pytest.fixture(scope="module")
def corpora():
    return {"tree": load_tree(DATA), "synthetic": synthetic()}


@pytest.fixture(scope="module")
def ladder_cases(corpora):
    """Per corpus, the batch test_torch_match's ladder tests use."""
    return {name: base_case(c, row_dicts(c.j_templates, seed=5) + [dense_row(c.j_templates)])
            for name, c in corpora.items()}


@pytest.fixture(scope="module")
def edge_cases(corpora):
    """Per corpus, a smaller batch (an overflow row among them) and its
    edits (``chip_smoke.candidate_edges``)."""
    out = {}
    for name, c in corpora.items():
        base = base_case(c, row_dicts(c.j_templates, seed=6, n=20) + [dense_row(c.j_templates)])
        streams = {k: v.data.numpy() for k, v in zip(base.t_meta.table_stream, base.views)}
        lengths = {k: v.lengths.numpy() for k, v in zip(base.t_meta.table_stream, base.views)}
        edits = candidate_edges(streams, lengths, base.qs, base.tab_np, base.slot_bytes.numpy(),
                                base.slot_len.numpy())
        out[name] = {edge: Case(c, {"t_meta": base.t_meta, "j_meta": base.j_meta,
                                    "j_np": {"tab": base.tab_np}}, *args)
                     for edge, args in edits.items()}
    return out


def ladder(budget: int):
    kc = 8
    while True:
        kc = t_compile.survivor_bucket(kc, budget)
        yield kc
        if kc >= budget:
            return
        kc *= 2


# ---------------------------------------------------------------------------
# The walks against the JAX package


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_phase_a_walk_equals_jax_at_every_ladder_width(ladder_cases, corpus):
    case = ladder_cases[corpus]
    cnt = case.jax_counts()
    budget = 32  # small: the dense row overflows it
    K = max(1, min(budget, int(case.cs[-1])))
    col, n_surv = walk_phase_a(case.views, case.qs, case.cs, case.tab["bloom"], budget, K)
    assert np.array_equal(n_surv, cnt[:, -1]) and (n_surv > K).any()
    for kc in ladder(budget):
        want = np.asarray(jax.jit(jm.compact_candidates, static_argnums=(1, 2))(
            jnp.asarray(cnt), kc, K))
        assert np.array_equal(col[:, :kc], want), kc
    # and the port's plain version (the kernel's other yardstick)
    col_p, n_p = tm.phase_a_plain(case.views, case.qs, case.cs, case.tab["bloom"], budget, K)
    assert np.array_equal(col, col_p.numpy()) and np.array_equal(n_surv, n_p.numpy())


def _phase_b_col(case: Case) -> tuple:
    budget = tm.global_candidate_budget(128, len(case.views))
    K = max(1, min(budget, int(case.cs[-1])))
    col, n_surv = walk_phase_a(case.views, case.qs, case.cs, case.tab["bloom"], budget, K)
    return torch.from_numpy(col), t_compile.survivor_bucket(
        int(np.minimum(n_surv, K).max(initial=0)), budget)


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_verify_walk_equals_jax(ladder_cases, corpus):
    case = ladder_cases[corpus]
    col, kc = _phase_b_col(case)
    value, unc = walk_verify(*case.verify_args(col, kc))
    jv, ju = case.jax_verify(col[:, :kc].numpy())
    assert np.array_equal(value, jv) and np.array_equal(unc, ju)
    assert value.any()
    pv, pu = tm.verify_plain(*case.verify_args(col, kc))
    assert np.array_equal(value, pv.numpy()) and np.array_equal(unc, pu.numpy())


EDGES = ("width_not_32", "generic_q", "short_rows", "no_groups", "past_emax", "long_slots",
         "suffix_outside", "last_byte_differs")


@pytest.mark.parametrize("edge", ("base",) + EDGES[:3])
@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_phase_a_walk_on_edges_equals_jax(edge_cases, corpus, edge):
    case = edge_cases[corpus][edge]
    cnt = case.jax_counts()
    for budget, K in ((64, 16), (512, 512)):  # kclamp below the budget, and at it
        K = max(1, min(K, int(case.cs[-1])))
        col, n_surv = walk_phase_a(case.views, case.qs, case.cs, case.tab["bloom"], budget, K)
        assert np.array_equal(n_surv, cnt[:, -1])
        want = np.asarray(jax.jit(jm.compact_candidates, static_argnums=(1, 2))(
            jnp.asarray(cnt), budget, K))
        assert np.array_equal(col, want), (budget, K)
    if edge == "width_not_32":
        assert all(v.data.shape[1] % 32 for v in case.views)
        assert any((v.lengths.numpy() > v.data.shape[1]).any() for v in case.views)
    if edge == "generic_q":
        assert not set(case.qs) & {4, 8}
    if edge == "short_rows":
        assert any((v.lengths.numpy() < q).any() for v, q in zip(case.views, case.qs))
    if edge == "base":
        assert (n_surv > 16).any()  # an overflow row at the smaller budget


@pytest.mark.parametrize("edge", ("base",) + EDGES)
@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_verify_walk_on_edges_equals_jax(edge_cases, corpus, edge):
    case = edge_cases[corpus][edge]
    col, kc = _phase_b_col(case)
    value, unc = walk_verify(*case.verify_args(col, kc))
    jv, ju = case.jax_verify(col[:, :kc].numpy())
    assert np.array_equal(value, jv) and np.array_equal(unc, ju)
    if edge == "long_slots":
        assert unc.any() and np.array_equal(unc, value)
    if edge == "base":  # slots longer than 32 bytes verify: the compare's second half counts
        assert value.any() and (corpus != "synthetic" or value[:, case.slot_len.numpy() > 32].any())
    if edge == "last_byte_differs":  # a row may hold the changed word itself
        base, _ = walk_verify(*edge_cases[corpus]["base"].verify_args(col, kc))
        assert value.sum() < base.sum()


@pytest.mark.parametrize("rows", [0, 1])
@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_walks_on_0_and_1_rows_equal_plain(edge_cases, corpus, rows):
    """A batch of 0 rows and of 1: the walks and the plain versions (the
    JAX functions take no batch of 0 rows)."""
    case = edge_cases[corpus]["base"]
    views = [kernels.StreamView(v.data[:rows].contiguous(), v.lengths[:rows].contiguous(),
                                v.lowered) for v in case.views]
    col, n_surv = walk_phase_a(views, case.qs, case.cs, case.tab["bloom"], 64, 16)
    col_p, n_p = tm.phase_a_plain(views, case.qs, case.cs, case.tab["bloom"], 64, 16)
    assert col.shape == (rows, 64)
    assert np.array_equal(col, col_p.numpy()) and np.array_equal(n_surv, n_p.numpy())
    kc = t_compile.survivor_bucket(int(np.minimum(n_surv, 16).max(initial=0)), 64)
    args = (views, case.qs, case.cs, torch.from_numpy(col), kc, *case.verify_args(None, 0)[5:])
    for a, b in zip(walk_verify(*args), tm.verify_plain(*args)):
        assert np.array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# The walks' constants and the launch descriptors against the kernel source


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def test_walk_constants_match_the_kernel_source():
    assert _constant("kPhaseAThreads") == PHASE_A_THREADS
    assert _constant("kWordWindows") == WORD_WINDOWS == kernels.WORD_WINDOWS
    assert _constant("kWordBytes") == WORD_BYTES == WORD_WINDOWS + 8
    assert _constant("kGroupTables") == GROUP_TABLES == kernels.GROUP_TABLES
    assert _constant("kFanOut") == FAN_OUT
    assert _constant("kGramLanes") == GRAM_LANES == 8  # the longest gram
    assert _constant("kVerifyWidth") == VERIFY_WIDTH == kernels.VERIFY_WIDTH
    assert _constant("kMaxTables") == kernels.MATCH_MAX_TABLES
    src = SOURCE.read_text()
    assert "constexpr int kBloomBits = 1 << 18;" in src and hashing.BLOOM_BITS == 1 << 18
    assert t_compile.VERIFY_WIDTH == VERIFY_WIDTH


def _c_fields(struct: str) -> list:
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", SOURCE.read_text(), re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if line:
            decl = line.split(None, 1)[1] if not line.startswith("const") else line.split(None, 2)[2]
            names += [re.match(r"\**(\w+)", d.strip()).group(1) for d in decl.split(",")]
    return names


def test_launch_structs_match_the_kernel_source():
    assert _c_fields("TableSet") == [f for f, _ in kernels.TableSetC._fields_]
    assert _c_fields("VerifyCorpus") == [f for f, _ in kernels.VerifyCorpusC._fields_]
    assert _c_fields("StreamRef") == [f for f, _ in kernels.StreamRefC._fields_]


def test_table_groups_and_descriptor(ladder_cases):
    case = ladder_cases["synthetic"]
    tabs = kernels.MatchTables(case.views, case.qs, case.cs)
    st = tabs.struct
    # one group a (stream, lowered) view: its q = 4 and q = 8 tables
    groups = [[t for t in st.group_table[g] if t >= 0] for g in range(st.n_groups)]
    by_view: dict = {}
    for t, key in enumerate(zip(case.t_meta.table_stream, case.t_meta.table_lowered)):
        by_view.setdefault(key, []).append(t)
    assert groups == list(by_view.values()) and max(map(len, groups)) == 2
    assert [st.q[t] for t in range(st.n_tables)] == list(case.qs)
    assert list(st.col_start[: st.n_tables + 1]) == case.cs.tolist()
    assert st.scan_words == sum(-(-v.data.shape[1] // 32) for v in case.views)
    assert (st.s[3].data, st.s[3].width, st.s[3].lowered) == (
        case.views[3].data.data_ptr(), case.views[3].data.shape[1], 1)
    # three tables of one view: a group of two and a group of one
    v = case.views[0]
    assert kernels.table_groups([v, v, v, case.views[2]]) == [[0, 1], [2], [3]]
    # a wrapper given the descriptor takes it as it is
    assert kernels.match_tables(tabs, tabs.qs, tabs.col_starts) is tabs
    assert kernels.match_tables(tabs, list(tabs.qs), tabs.col_starts) is not tabs


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions on the same cases


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ("base",) + EDGES)
@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_candidate_kernels_on_edges_equal_plain_on_card(edge_cases, corpus, edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    case = edge_cases[corpus][edge]
    views = [kernels.StreamView(v.data.cuda(), v.lengths.cuda(), v.lowered) for v in case.views]
    tabs = kernels.MatchTables(views, case.qs, case.cs)
    bloom = case.tab["bloom"].cuda()
    tab = {k: t.cuda() for k, t in case.tab.items()}
    corpus_c = kernels.VerifyCorpus(tab, case.t_meta.max_group, case.slot_bytes.cuda(),
                                    case.slot_len.cuda())
    for budget, K in ((64, 16), (512, 512)):
        K = max(1, min(K, int(case.cs[-1])))
        args = (tabs, tabs.qs, tabs.col_starts, bloom, budget, K)
        col, n_surv = kernels.match_phase_a(*args)
        col_p, n_p = tm.phase_a_plain(*args)
        assert torch.equal(col, col_p) and torch.equal(n_surv, n_p)
        kc = t_compile.survivor_bucket(int(n_surv.clamp(max=K).max()), budget)
        vargs = (tabs, tabs.qs, tabs.col_starts, col, kc, corpus_c, case.t_meta.max_group,
                 corpus_c.slot_bytes, corpus_c.slot_len, case.plane_width)
        for a, b in zip(kernels.match_verify(*vargs), tm.verify_plain(*vargs)):
            assert torch.equal(a, b)
