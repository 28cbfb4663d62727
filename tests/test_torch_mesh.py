"""The port's ``parallel/`` against the JAX package's, on the CPU.

- ``factor_devices``, ``slice_layout`` and ``make_mesh``'s layout
  against the originals;
- ``shard_tables_np``, ``shard_stacked_np`` and ``pad_streams_for_seq``
  array for array equal to the reference's;
- phase A and the verify with seq halos: the plain versions against the
  JAX ``prefilter_counts``, ``compact_candidates``, ``verify_candidates``
  and ``tiny_slot_bits`` on the same halo-extended streams;
- the port's ``ShardedMatcher`` planes exactly equal to the JAX
  ``ShardedMatcher``'s on its 8 virtual CPU devices and to the port's
  ``DeviceDB``, for the grids (2,1,1), (1,2,1), (1,1,2) and (2,2,2) of
  ``cpu`` ranks, on the rows of ``test_sharding.py``'s fixture (OOB
  streams included), with the shard families' deltas equal to JAX's;
- the deferred combine riding behind the next batch's phase A;
- a pipelined mesh engine (two batches in flight) equal to the direct
  single-device engine.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarm_tpu.parallel.mesh as j_mesh
import swarm_tpu.parallel.sharded as j_sharded
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.parallel.mesh as t_mesh
import swarm_tpu_torch.parallel.sharded as t_sharded
import swarm_tpu_torch.telemetry.metrics as t_metrics
from swarm_tpu.fingerprints import compile as j_compile
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.ops import encoding as j_encoding
from swarm_tpu.ops import match as jm
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.ops import encoding as t_encoding
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops import match as tm
from swarm_tpu_torch.ops.engine import MatchEngine

from test_match_parity import DATA, corpus_words, fuzz_rows

GRIDS = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2)]
FIELDS = ("host", "port", "status", "body", "header", "banner", "oob_protocols",
          "oob_requests")

# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_devices_equal_jax(n):
    assert t_mesh.factor_devices(n) == j_mesh.factor_devices(n)


@pytest.mark.parametrize("phys", [(2, 2, 1), (4, 2, 2), (4, 4), (8,), (2, 2, 2), (1, 1),
                                  (3, 2, 4), (2, 4, 2, 2)])
def test_slice_layout_equal_jax(phys):
    assert t_mesh.slice_layout(phys) == j_mesh.slice_layout(phys)


@pytest.mark.parametrize("shape", [None, (2, 2, 2), (4, 1, 2), (1, 8, 1), "4x2", "2x2x2"])
def test_make_mesh_lays_out_ranks_as_jax(shape, monkeypatch):
    """The same grid of device indices as the JAX mesh over its 8
    virtual CPU devices, from a shape, from ``factor_devices`` or from a
    ``SWARM_SLICE_SHAPE`` hint (torch devices have no coordinates)."""
    arg = shape
    if isinstance(shape, str):
        monkeypatch.setenv("SWARM_SLICE_SHAPE", shape)
        arg = None
    want = j_mesh.make_mesh(arg)
    got = t_mesh.make_mesh(arg, [f"cuda:{i}" for i in range(8)])
    assert got.axis_names == tuple(want.axis_names) == t_mesh.AXES
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(np.vectorize(lambda d: d.index)(got.devices), ids)


def test_make_mesh_repeats_one_device():
    mesh = t_mesh.make_mesh((2, 2, 2), ["cpu"] * 8)
    assert mesh.devices.shape == (2, 2, 2)
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="needs 8 devices"):
        t_mesh.make_mesh((2, 2, 2), ["cpu"] * 4)


def test_make_mesh_needs_a_card_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()


# ---------------------------------------------------------------------------
# the world: test_sharding.py's rows, plus rows whose words straddle a
# seq boundary


@pytest.fixture(scope="module")
def world():
    j_templates, _ = j_load_corpus(DATA)
    t_templates, _ = t_load_corpus(DATA)
    rows = fuzz_rows(j_templates, random.Random(23), 16)
    dicts = [{f: getattr(r, f) for f in FIELDS} for r in rows]
    # one row with OOB interaction data: the oobp/oobr streams
    # materialize at real widths
    dicts[3]["oob_protocols"] = ("http", "dns")
    dicts[3]["oob_requests"] = b"GET /si00aa11bb22cc33 HTTP/1.1\r\nHost: cb.test\r\n\r\n" * 3
    # corpus words across the middle of the 512-byte body (seq 2) and
    # across the quarter marks (seq 4)
    words = [w.encode() for w in corpus_words(j_templates, random.Random(5), 40)
             if 8 <= len(w) <= 24]
    for i, cut in enumerate((256, 128, 384)):
        w = words[i % len(words)]
        body = b"x" * (cut - len(w) // 2) + w + b" tail"
        dicts[5 + i] = {"host": f"10.1.0.{i}", "port": 80, "status": 200, "body": body,
                        "header": b"HTTP/1.1 200 OK\r\nX-Word: " + w}
    j_db, t_db = j_compile.compile_corpus(j_templates), t_compile.compile_corpus(t_templates)
    kw = dict(max_body=512, max_header=512, pad_rows_to=16)
    jb = j_encoding.encode_batch([j_model.Response(**d) for d in dicts], **kw)
    tb = t_encoding.encode_batch([t_model.Response(**d) for d in dicts], **kw)
    return {"j_db": j_db, "t_db": t_db, "jb": jb, "tb": tb, "dicts": dicts,
            "t_templates": t_templates, "halo": j_sharded.max_entry_len(j_db)}


def padded(streams: dict, seq: int, halo: int, pad) -> dict:
    out = dict(streams)
    if seq > 1:
        pad(out, seq, halo)
    return out


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_shard_tables_equal_jax(world, ranks):
    got = t_sharded.shard_tables_np(world["t_db"], ranks)
    want = j_sharded.shard_tables_np(world["j_db"], ranks)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    got = t_sharded.shard_stacked_np(world["t_db"], ranks)
    want = j_sharded.shard_stacked_np(world["j_db"], ranks)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert t_sharded.max_entry_len(world["t_db"]) == world["halo"]


@pytest.mark.parametrize("seq", [1, 2, 4, 8])
def test_pad_streams_for_seq_equal_jax(world, seq):
    got = padded(world["tb"].streams, seq, world["halo"], t_sharded.pad_streams_for_seq)
    want = padded(world["jb"].streams, seq, world["halo"], j_sharded.pad_streams_for_seq)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert got[k].shape[1] % seq == 0 and got[k].shape[1] // seq >= world["halo"]


# ---------------------------------------------------------------------------
# phase A, the verify and the tiny slots with seq halos


def seq_rank_views(streams: dict, seq: int, s: int, h: int) -> tuple:
    """Seq rank ``s``'s halo-extended views and offsets, built from the
    whole rows (zeros past both ends) → (ext, local, offsets)."""
    ext, local, offs = {}, {}, {}
    for name, arr in streams.items():
        w = arr.shape[1] // seq
        wide = np.pad(arr, ((0, 0), (h, h)))
        ext[name] = np.ascontiguousarray(wide[:, s * w:s * w + w + 2 * h])
        local[name] = np.ascontiguousarray(arr[:, s * w:(s + 1) * w])
        offs[name] = s * w
    return ext, local, offs


@pytest.fixture(scope="module")
def halo_ranks(world):
    """For each rank of a seq-4 split: the JAX phase A count plane, the
    candidates, the verify's and the tiny slots' planes on its
    halo-extended streams, and the port's plain versions of the same."""
    h, seq = world["halo"], 4
    streams = padded(world["tb"].streams, seq, h, t_sharded.pad_streams_for_seq)
    lengths = world["tb"].lengths
    j_meta, j_np = j_compile.build_device_layout(world["j_db"])
    t_meta, t_np = t_compile.build_device_layout(world["t_db"])
    j_tab = jax.tree_util.tree_map(jnp.asarray, j_np["tab"])
    t_tab = tm.to_device(t_np["tab"], torch.device("cpu"))
    db = world["t_db"]
    ns = max(db.num_slots, 1)
    budget = tm.global_candidate_budget(128, len(t_meta.table_stream))

    @jax.jit
    def j_phase_a(tab, s, ln, offs):
        ctx = jm._StreamCtx(s, ln, offs)
        return jm.prefilter_counts(j_meta, tab, ctx, h, h)[0]

    out = []
    for s in range(seq):
        ext, local, offs = seq_rank_views(streams, seq, s, h)
        js = {k: jnp.asarray(v) for k, v in ext.items()}
        jl = {k: jnp.asarray(v) for k, v in lengths.items()}
        cnt = np.asarray(j_phase_a(j_tab, js, jl, offs))
        cs = tm.col_starts_of(t_meta, local)
        assert np.array_equal(cs, jm._col_starts_of(j_meta, local))
        K = max(1, min(budget, int(cs[-1])))
        ts = {k: torch.from_numpy(v) for k, v in ext.items()}
        tl = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lengths.items()}
        views = tm.table_views(t_meta, ts, tl)
        t_offs = [offs[n] for n in t_meta.table_stream]
        col, n_surv = kernels.match_phase_a(views, t_meta.table_q, cs, t_tab["bloom"], budget,
                                            K, h, h, t_offs)
        kc = t_compile.survivor_bucket(int(n_surv.clamp(max=K).max()), budget)
        want_col = np.asarray(jax.jit(jm.compact_candidates, static_argnums=(1, 2))(
            jnp.asarray(cnt), kc, K))
        value, unc = kernels.match_verify(
            views, t_meta.table_q, cs, col, kc, t_tab, t_meta.max_group,
            torch.from_numpy(db.slot_bytes), torch.from_numpy(db.slot_len), ns, h, h, t_offs)

        def j_verify(tab, slot_bytes, slot_len, s_, ln, col_, offs_):
            ctx = jm._StreamCtx(s_, ln, offs_)
            v, u = jm.verify_candidates(j_meta, tab, slot_bytes, slot_len, ctx, col_, cs, ns,
                                        h, h)
            return v, u, jm.tiny_slot_bits(j_meta, jnp.asarray(db.tiny_bytes),
                                           jnp.asarray(db.tiny_slot), ctx, v, h)

        jv, ju, jt = jax.jit(j_verify)(j_tab, jnp.asarray(db.slot_bytes),
                                       jnp.asarray(db.slot_len), js, jl,
                                       jnp.asarray(col[:, :kc].numpy()), offs)
        tiny = tm.tiny_slot_bits(t_meta, db.tiny_bytes, db.tiny_slot, ts, tl, value, h, offs)
        out.append({"cnt": cnt, "col": col, "n_surv": n_surv, "K": K, "kc": kc,
                    "want_col": want_col, "value": value, "unc": unc, "jv": np.asarray(jv),
                    "ju": np.asarray(ju), "tiny": tiny, "jt": np.asarray(jt)})
    return out


@pytest.mark.parametrize("s", range(4))
def test_phase_a_with_halos_equals_jax(halo_ranks, s):
    r = halo_ranks[s]
    assert np.array_equal(r["n_surv"].numpy(), r["cnt"][:, -1])
    assert np.array_equal(r["col"][:, :r["kc"]].numpy(), r["want_col"])
    assert r["n_surv"].sum() > 0


@pytest.mark.parametrize("s", range(4))
def test_verify_and_tiny_slots_with_halos_equal_jax(halo_ranks, s):
    r = halo_ranks[s]
    assert np.array_equal(r["value"].numpy(), r["jv"])
    assert np.array_equal(r["unc"].numpy(), r["ju"])
    assert np.array_equal(r["tiny"].numpy(), r["jt"])
    assert r["value"].any()


def test_halo_ranks_together_find_every_word(world, halo_ranks):
    """The OR of the four ranks' slot planes is the unsharded plane:
    each word is found by the rank that owns its gram, the straddling
    ones included."""
    t_meta, t_np = t_compile.build_device_layout(world["t_db"])
    db, tb = world["t_db"], world["tb"]
    s = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tb.streams.items()}
    ln = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tb.lengths.items()}
    views = tm.table_views(t_meta, s, ln)
    cs = tm.col_starts_of(t_meta, s)
    t_tab = tm.to_device(t_np["tab"], torch.device("cpu"))
    budget = tm.global_candidate_budget(128, len(t_meta.table_stream))
    K = max(1, min(budget, int(cs[-1])))
    col, n_surv = kernels.match_phase_a(views, t_meta.table_q, cs, t_tab["bloom"], budget, K)
    value, _unc = kernels.match_verify(views, t_meta.table_q, cs, col, budget, t_tab,
                                       t_meta.max_group, torch.from_numpy(db.slot_bytes),
                                       torch.from_numpy(db.slot_len), max(db.num_slots, 1))
    whole = tm.tiny_slot_bits(t_meta, db.tiny_bytes, db.tiny_slot, s, ln, value)
    ored = halo_ranks[0]["tiny"].clone()
    for r in halo_ranks[1:]:
        ored |= r["tiny"]
    assert torch.equal(ored, whole)
    assert sum(int(r["n_surv"].sum()) for r in halo_ranks) == int(n_surv.sum())


# ---------------------------------------------------------------------------
# the sharded matcher


SHARD_FAMILIES = ("swarm_shard_dispatches_total", "swarm_shard_psum_bytes_total",
                  "swarm_shard_halo_bytes_total", "swarm_shard_halo_bytes_saved_total",
                  "swarm_shard_overlapped_dispatches_total", "swarm_shard_mesh_axis_size",
                  "swarm_shard_survivor_max")


def shard_samples(metrics) -> dict:
    return {(n, tuple(sorted(lab.items()))): v
            for n, lab, v in metrics.parse_exposition(metrics.REGISTRY.render())
            if n in SHARD_FAMILIES}


def delta(before: dict, after: dict) -> dict:
    """Counter deltas and the gauges' values after."""
    return {k: (v if "size" in k[0] or "max" in k[0] else v - before.get(k, 0.0))
            for k, v in after.items()}


@pytest.fixture(scope="module")
def grid_runs(world):
    """Per grid: the batch through the JAX ShardedMatcher (8 virtual CPU
    devices), the port's (``cpu`` ranks) and the port's DeviceDB, with
    each package's shard family deltas."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    h = world["halo"]
    jb, tb = world["jb"], world["tb"]
    out = {}
    for shape in GRIDS:
        js = padded(jb.streams, shape[2], h, j_sharded.pad_streams_for_seq)
        ts = padded(tb.streams, shape[2], h, t_sharded.pad_streams_for_seq)
        before = shard_samples(j_metrics)
        want = j_sharded.ShardedMatcher(world["j_db"], j_mesh.make_mesh(shape)).match(
            js, jb.lengths, jb.status, full=True)
        j_delta = delta(before, shard_samples(j_metrics))
        before = shard_samples(t_metrics)
        matcher = t_sharded.ShardedMatcher(world["t_db"],
                                           t_mesh.make_mesh(shape, ["cpu"] * 8))
        got = matcher.match(ts, tb.lengths, tb.status)
        t_delta = delta(before, shard_samples(t_metrics))
        ref = tm.DeviceDB(world["t_db"], device="cpu").match(ts, tb.lengths, tb.status)
        out[shape] = {"want": want, "got": got, "ref": ref, "j_delta": j_delta,
                      "t_delta": t_delta, "matcher": matcher}
    return out


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: "x".join(map(str, s)))
def test_sharded_planes_equal_jax_and_devicedb(grid_runs, shape):
    run = grid_runs[shape]
    want, got, ref = run["want"], run["got"], run["ref"]
    assert len(got) == len(want) == len(ref) == 7
    for i, (w, g, r) in enumerate(zip(want[:6], got[:6], ref[:6])):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w)), i
        assert np.array_equal(g, r), i
    assert (want[6] is None) == (got[6] is None) == (ref[6] is None)
    for w, g, r in zip(want[6] or (), got[6] or (), ref[6] or ()):
        assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, r)
    assert np.unpackbits(got[0]).any()
    lc = run["matcher"].last_compact
    assert lc["verify_k"] >= lc["survivor_max"] > 0


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: "x".join(map(str, s)))
def test_shard_families_equal_jax(grid_runs, shape):
    run = grid_runs[shape]
    assert run["t_delta"] == run["j_delta"]
    assert run["t_delta"][("swarm_shard_dispatches_total", ())] == 1
    for ax, size in zip(("data", "model", "seq"), shape):
        assert run["t_delta"][("swarm_shard_mesh_axis_size", (("axis", ax),))] == size


def test_seq_grid_reads_the_halos(world, grid_runs):
    """On the (1,1,2) grid the two ranks' candidates differ from what
    the same ranks find with the halos cut off: a straddling word is
    found only through them."""
    shape = (1, 1, 2)
    h = world["halo"]
    ts = padded(world["tb"].streams, 2, h, t_sharded.pad_streams_for_seq)
    matcher = t_sharded.ShardedMatcher(world["t_db"], t_mesh.make_mesh(shape, ["cpu"] * 2))
    with kernels.record_calls() as calls:
        matcher.match(ts, world["tb"].lengths, world["tb"].status)
    phase_a = [args for name, args in calls if name == "match_phase_a"]
    verify = [args for name, args in calls if name == "match_verify"]
    assert len(phase_a) == len(verify) == 2
    assert [a[6:8] for a in phase_a] == [(h, h)] * 2
    assert [a[8][0] for a in phase_a] == [0, ts[matcher.meta.table_stream[0]].shape[1] // 2]
    assert all(v[10:12] == (h, h) for v in verify)


def test_deferred_combine_rides_behind_the_next_phase_a(world, grid_runs):
    """Batch N's combine is launched by batch N+1's dispatch, after its
    phase A; the last by collect; ``overlap=False`` launches inline. Both
    packages count one overlapped dispatch for two batches."""
    tb, jb = world["tb"], world["jb"]
    mesh = t_mesh.make_mesh((2, 1, 1), ["cpu"] * 2)
    matcher = t_sharded.ShardedMatcher(world["t_db"], mesh)
    before = shard_samples(t_metrics)
    order = []
    real_combine = matcher._combine
    real_phase_a = kernels.match_phase_a

    def combine(*args):
        order.append("combine")
        return real_combine(*args)

    def phase_a(*args):
        order.append("phase_a")
        return real_phase_a(*args)

    matcher._combine = combine
    kernels.match_phase_a = phase_a
    try:
        first = matcher.dispatch(tb.streams, tb.lengths, tb.status)
        assert first.launched_by is None
        second = matcher.dispatch(tb.streams, tb.lengths, tb.status)
        assert first.launched_by == "dispatch" and second.launched_by is None
        planes = [matcher.collect(first), matcher.collect(second)]
    finally:
        kernels.match_phase_a = real_phase_a
    assert second.launched_by == "collect"
    # two data ranks: each batch's phase A is two calls
    assert order == ["phase_a"] * 4 + ["combine"] + ["combine"]
    t_delta = delta(before, shard_samples(t_metrics))
    for a, b in zip(planes[0][:6], planes[1][:6]):
        assert np.array_equal(a, b)
    want = grid_runs[(2, 1, 1)]["want"]
    assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(planes[0][:6], want[:6]))

    j_matcher = j_sharded.ShardedMatcher(world["j_db"], j_mesh.make_mesh((2, 1, 1)))
    before = shard_samples(j_metrics)
    handles = [j_matcher.dispatch(jb.streams, jb.lengths, jb.status) for _ in range(2)]
    for hd in handles:
        j_matcher.collect(hd)
    j_delta = delta(before, shard_samples(j_metrics))
    assert [hd.launched_by for hd in handles] == [first.launched_by, second.launched_by]
    assert t_delta == j_delta
    assert t_delta[("swarm_shard_overlapped_dispatches_total", ())] == 1

    inline = t_sharded.ShardedMatcher(world["t_db"], mesh, overlap=False)
    handle = inline.dispatch(tb.streams, tb.lengths, tb.status)
    assert handle.launched_by == "inline"
    assert all(np.array_equal(a, b) for a, b in zip(inline.collect(handle)[:6], planes[0][:6]))


def test_a_failed_combine_raises_on_its_own_batch(world):
    tb = world["tb"]
    matcher = t_sharded.ShardedMatcher(world["t_db"], t_mesh.make_mesh((2, 1, 1), ["cpu"] * 2))
    first = matcher.dispatch(tb.streams, tb.lengths, tb.status)

    def broken(*args):
        raise RuntimeError("combine failed")

    first._thunk = broken
    second = matcher.dispatch(tb.streams, tb.lengths, tb.status)
    assert first.launched_by == "dispatch"
    assert matcher.collect(second)[0].shape[0] == tb.status.shape[0]
    with pytest.raises(RuntimeError, match="combine failed"):
        matcher.collect(first)


def test_pending_combine_launches_once_under_contention():
    """Many threads force, launch and take one deferred combine at once
    (the submit thread's dispatch and the walk worker's collect race
    for it): its thunk runs exactly once and every caller gets its
    result."""
    import sys
    import threading

    class Matcher:
        def __init__(self):
            self.cleared = 0

        def _clear_pending(self, handle):
            self.cleared += 1

    calls = []
    handle = t_sharded._PendingShard(Matcher(), lambda: calls.append(1) or "out", {})
    results = []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.append(
                handle.force() if i % 2 else handle.launch("dispatch") or handle.force()))
            for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert calls == [1] and results == ["out"] * 32
    assert handle.launched_by in ("dispatch", "collect") and handle._matcher.cleared == 1


def test_seq_widths_are_checked(world):
    matcher = t_sharded.ShardedMatcher(world["t_db"], t_mesh.make_mesh((1, 1, 8), ["cpu"] * 8))
    tb = world["tb"]
    with pytest.raises(ValueError, match="per-rank width"):
        matcher.dispatch(tb.streams, tb.lengths, tb.status)  # 128 / 8 < the halo
    odd = t_sharded.ShardedMatcher(world["t_db"], t_mesh.make_mesh((3, 1, 1), ["cpu"] * 3))
    with pytest.raises(ValueError, match="data ranks"):
        odd.dispatch(tb.streams, tb.lengths, tb.status)


# ---------------------------------------------------------------------------
# the engine on a mesh


@pytest.fixture(scope="module")
def engine_rows(world):
    j_templates, _ = j_load_corpus(DATA)
    rows = fuzz_rows(j_templates, random.Random(101), 150)
    return [t_model.Response(**{f: getattr(r, f) for f in FIELDS}) for r in rows]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The scheduler's cases run several Python threads of one engine;
    one intra-op torch thread keeps them from oversubscribing a busy
    host (the results do not depend on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def direct_results(world, engine_rows):
    eng = MatchEngine(world["t_templates"], max_body=512, max_header=512, device="cpu",
                      mesh=None, walk_threads=1)
    return eng.match(engine_rows)


def same_results(got, want) -> bool:
    return len(got) == len(want) and all(
        sorted(a.template_ids) == sorted(b.template_ids) and a.extractions == b.extractions
        for a, b in zip(got, want))


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_engine_on_a_mesh_equals_one_device(world, engine_rows, direct_results, shape):
    """An odd row count (a partial bucket: the per-rank placement
    engages) through a mesh engine: the single-device results, the
    rank fill of its placement, and the planner's data ranks."""
    mesh = t_mesh.make_mesh(shape, ["cpu"] * 8)
    eng = MatchEngine(world["t_templates"], max_body=512, max_header=512, device="cpu",
                      mesh=mesh, walk_threads=1)
    assert eng.sharded is not None and eng.data_ranks() == shape[0]
    assert same_results(eng.match(engine_rows[:13]), direct_results[:13])
    rank_fill = [v for n, _lab, v in t_metrics.parse_exposition(t_metrics.REGISTRY.render())
                 if n == "swarm_shard_rank_fill_ratio"]
    assert rank_fill == [6 / 128]  # 13 rows over 2 ranks of 128: 7 and 6


def test_mesh_engine_degrades_a_faulted_dispatch(world, engine_rows, direct_results):
    """The engine's breaker and CPU-oracle redo wrap a mesh dispatch as
    they wrap DeviceDB's: an injected ``device.dispatch`` fault degrades
    its batch, and the results stay the single-device engine's."""
    from swarm_tpu_torch.resilience import faults

    mesh = t_mesh.make_mesh((2, 1, 2), ["cpu"] * 4)
    eng = MatchEngine(world["t_templates"], max_body=512, max_header=512, device="cpu",
                      mesh=mesh, walk_threads=1, batch_rows=8)
    faults.install_plan("device.dispatch:1")
    try:
        got = eng.match(engine_rows[:24])
    finally:
        faults.clear_plan()
    assert same_results(got, direct_results[:24])
    assert (eng.stats.device_faults, eng.stats.degraded_batches) == (1, 1)
    assert eng.stats.batches == 3


def test_auto_mesh_is_one_device_on_the_cpu(world):
    eng = MatchEngine(world["t_templates"], device="cpu")
    assert eng.sharded is None and eng.mesh is None and eng.data_ranks() == 1


def test_pipelined_mesh_engine_equals_direct(world, engine_rows, direct_results,
                                            monkeypatch):
    """The scheduler on a (2,1,1) mesh engine keeps two batches in
    flight on the CPU, so each batch's combine rides behind the next
    one's phase A, and its planner fills buckets per data rank; the
    results are the direct engine's."""
    import swarm_tpu_torch.sched.scheduler as t_scheduler

    planners = []

    class Planner(t_scheduler.BucketPlanner):
        def __init__(self, *args, **kwargs):
            planners.append(kwargs.get("data_ranks"))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(t_scheduler, "BucketPlanner", Planner)
    mesh = t_mesh.make_mesh((2, 1, 1), ["cpu"] * 2)
    eng = MatchEngine(world["t_templates"], max_body=512, max_header=512, device="cpu",
                      mesh=mesh, walk_threads=1, batch_rows=32, pipeline="on")
    before = shard_samples(t_metrics)
    got = eng.match(engine_rows)
    stats = eng.scheduler().stats
    assert same_results(got, direct_results)
    assert planners == [2]
    assert stats.max_inflight >= 2 and stats.device_batches >= 3
    overlapped = delta(before, shard_samples(t_metrics))[
        ("swarm_shard_overlapped_dispatches_total", ())]
    assert overlapped >= 1
