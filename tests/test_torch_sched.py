"""The port's continuous-batching scheduler (swarm_tpu_torch.sched) and
the engine's split submission surface against the JAX package.

- the bucket planner and ``width_class`` equal JAX's on the same rows;
- ``MatchEngine(device="cpu", pipeline="on").match`` equals JAX's
  ``MatchEngine(mesh=None)`` with the pipeline on and off, cold and
  memo-warm, with dead rows, mixed bucket shapes and a workflow corpus;
- ``run(chunks, decode=..., qos=...)`` yields JAX's results in chunk
  order;
- with the overlap forced on (the card's in-flight window on the CPU),
  every ``inflight`` × ``walk_offload`` × ``prefetch`` setting equals the
  direct path and never exceeds its in-flight cap;
- two dispatches in flight each keep their own result and their own
  phase attribution;
- a device fault degrades its batch to the CPU oracle: ``run()`` and
  ``match()`` still give the fault-free results, and JAX's.

Results are compared as ``tests/test_sched.py`` compares them: template
ids and extractions row for row, exact (``confirmed_on_host`` follows
each batch's dedup representative, so it is not compared), plus the
workflow gate planes of every row that carries them.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from chip_smoke import realistic_rows, synthetic_corpus
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.fingerprints import nuclei as j_nuclei
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.sched import BatchScheduler as JaxScheduler
from swarm_tpu.sched import BucketPlanner as JaxPlanner
from swarm_tpu.sched import SchedulerConfig as JaxConfig
from swarm_tpu.sched import width_class as j_width_class
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.ops.encoding import _width_for
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.sched import BatchScheduler, BucketPlanner, SchedulerConfig, width_class
from test_match_parity import DATA
from test_torch_walk import to_port

BATCH = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The cases run several Python threads of one engine; one intra-op
    torch thread keeps them from oversubscribing a busy host (the
    results do not depend on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# (a) the bucket planner


def test_width_class_equals_jax_and_the_ports_encoder():
    for multiple, cap in ((512, 4096), (512, 1024), (128, 2048), (512, 2048)):
        for n in (0, 1, 127, 128, 129, 511, 512, 513, 700, 1100, 1500, 1536, 2047,
                  2048, 3000, 4000, 4096, 9999):
            got = width_class(n, multiple, cap)
            assert got == j_width_class(n, multiple, cap), (n, multiple, cap)
            assert got == _width_for(np.asarray([n]), cap=cap, multiple=multiple), (n, multiple, cap)


def _planner_rows(n: int, seed: int) -> list:
    """Row dicts over the width classes: short and long bodies, banner
    rows, long headers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = b"x" * int(rng.choice([0, 10, 600, 1100, 1600, 2500, 5000]))
        banner = body if rng.random() < 0.2 else None
        out.append({"host": "h", "port": 80, "status": 200,
                    "body": b"" if banner else body, "banner": banner,
                    "header": b"h" * int(rng.choice([5, 700, 1500]))})
    return out


def _planned(pb) -> tuple:
    return (list(pb.ids), pb.bucket, pb.kind, pb.final, pb.qos, pb.deadline,
            pb.oldest_ts, pb.data_ranks, pb.fill_rows, len(pb.rows))


@pytest.mark.parametrize("kw", [
    {"rows_target": 4},
    {"rows_target": 7, "max_body": 2048, "max_header": 512},
    {"rows_target": 5, "qos_deadline_s": 0.05},
    {"rows_target": 6, "max_age_s": 0.2, "qos_deadline_s": 0.05},
    {"rows_target": 6, "data_ranks": 4},
], ids=["target4", "caps", "qos_deadline", "max_age", "ranks"])
def test_bucket_planner_equals_jax(kw):
    """The same arrival sequence (fresh and memo-known rows, bulk and
    interactive, on a clock the test sets) through both planners: every
    flushed batch, the occupancy and the pending count equal at each
    step; then the deadline flushes and the end-of-stream flush."""
    tp, jp = BucketPlanner(**kw), JaxPlanner(**kw)
    dicts = _planner_rows(90, seed=3)
    rng = np.random.default_rng(5)
    now = 100.0
    for gid, d in enumerate(dicts):
        now += 0.01
        qos = "interactive" if rng.random() < 0.3 else "bulk"
        known = rng.random() < 0.25
        add_t = tp.add_known if known else tp.add_fresh
        add_j = jp.add_known if known else jp.add_fresh
        got = add_t(gid, t_model.Response(**d), qos, now)
        want = add_j(gid, j_model.Response(**d), qos, now)
        assert (got is None) == (want is None), gid
        if got is not None:
            assert _planned(got) == _planned(want), gid
        assert tp.occupancy() == jp.occupancy() and tp.pending_rows == jp.pending_rows
        if gid % 15 == 14:
            due_t = [_planned(pb) for pb in tp.flush_due(now)]
            assert due_t == [_planned(pb) for pb in jp.flush_due(now)], gid
    due = [_planned(pb) for pb in tp.flush_due(now + 1.0)]
    assert due == [_planned(pb) for pb in jp.flush_due(now + 1.0)]
    if kw.get("qos_deadline_s") or kw.get("max_age_s"):
        assert due and all(d[5] for d in due)
    tail = [_planned(pb) for pb in tp.flush_all()]
    assert tail == [_planned(pb) for pb in jp.flush_all()]
    assert tp.pending_rows == 0
    assert tp.occupancy() == jp.occupancy() == {}


# ---------------------------------------------------------------------------
# The engines


def scan_rows(n: int, seed: int, salt: bool = True) -> list:
    """``tests/test_sched.py``'s scan rows as dicts: a few pages, bodies
    that cross into the 1024 and 2048 width classes, dead rows
    interleaved; salted so that each row's content is its own."""
    rng = np.random.default_rng(seed)
    bodies = [
        b"<html><head><title>Welcome to nginx!</title></head></html>",
        b"<html><head><title>Grafana</title></head><body>grafana v9.1.0</body></html>",
        b"<html><body>site powered by AcmeCMS, demo-build 3.11</body></html>",
        b"<html>404 Not Found</html>",
        b"",
        b"A" * 900,
        b"B" * 1800,
    ]
    out = []
    for i in range(n):
        body = bodies[i % len(bodies)]
        if salt:
            body = b"<!-- %s -->" % bytes(rng.integers(97, 123, size=24, dtype=np.uint8)) + body
        out.append({"host": f"198.51.100.{i % 254}", "port": (80, 443)[i % 2],
                    "status": (200, 404, 301)[i % 3], "body": body,
                    "header": b"HTTP/1.1 200 OK\r\nServer: nginx\r\nX-Widget-Version: 4.2"})
    for k in (3, 11, n - 2):
        if 0 <= k < n:
            out[k] = {"host": f"dead{k}", "alive": False}
    return out


class Corpus:
    """One corpus on both packages, with its rows."""

    def __init__(self, j_templates, dicts):
        self.j_templates = j_templates
        self.t_templates = [to_port(t) for t in j_templates]
        self.dicts = dicts
        # walk_threads=1: the batched native passes, inline (no pool)
        self.port = MatchEngine(self.t_templates, batch_rows=BATCH, device="cpu",
                                walk_threads=1)
        self.port_on = MatchEngine(self.t_templates, db=self.port.db, batch_rows=BATCH,
                                   device="cpu", pipeline="on", walk_threads=1)

    @functools.cached_property
    def direct(self) -> list:
        """The port's direct path over the rows, cold."""
        self.port.clear_content_memos()
        return self.port.match(self.t_rows())

    @functools.cached_property
    def jax(self) -> tuple:
        """JAX's engines with the pipeline off and on."""
        off = JaxEngine(self.j_templates, mesh=None, batch_rows=BATCH, pipeline="off")
        return off, JaxEngine(self.j_templates, mesh=None, batch_rows=BATCH, pipeline="on",
                              db=off.db)

    def t_rows(self, dicts=None):
        return [t_model.Response(**d) for d in (dicts or self.dicts)]

    def j_rows(self, dicts=None):
        return [j_model.Response(**d) for d in (dicts or self.dicts)]


def _data_corpus() -> Corpus:
    templates, errors = j_load_corpus(DATA)
    assert templates, errors
    return Corpus(templates, scan_rows(100, seed=7))


def _synthetic_corpus() -> Corpus:
    docs, plants = synthetic_corpus(1, 80)
    dicts = realistic_rows(90, seed=3, plants=plants)
    dicts += [dict(d, body=d.get("body", b"") + b"x" * 1200) for d in dicts[:12]]
    for k in (5, 60):
        dicts[k] = {"host": f"dead{k}", "alive": False}
    return Corpus([j_nuclei.parse_template(d) for d in docs], dicts)


@pytest.fixture(scope="module")
def data():
    """``tests/data/templates`` (a workflow among them) over salted scan
    rows: the corpus every case is held to JAX on."""
    return _data_corpus()


@pytest.fixture(scope="module")
def synthetic():
    """A synthetic corpus over the realistic mix (content that repeats
    across rows): held to the port's direct path, which
    tests/test_torch_walk.py and test_torch_engine.py hold to JAX."""
    return _synthetic_corpus()


@pytest.fixture(scope="module", params=["data", "synthetic"])
def corpus(request, data, synthetic):
    return {"data": data, "synthetic": synthetic}[request.param]


def assert_same(got, want, wf_pattern: bool = False) -> None:
    """Template ids and extractions row for row; the gate planes of each
    row both sides carry, equal (with ``wf_pattern``, also which rows
    carry them: on fresh content every live walked row does)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.template_ids == w.template_ids, i
        assert g.extractions == w.extractions, i
        if wf_pattern:
            assert (g.wf is None) == (w.wf is None), i
        if g.wf is not None and w.wf is not None:
            assert all(np.array_equal(a, b) for a, b in zip(g.wf, w.wf)), i


def clones(dicts: list) -> list:
    """The same content in new objects (the memo must key on content)."""
    return [{k: (bytes(bytearray(v)) if isinstance(v, bytes) else v) for k, v in d.items()}
            for d in dicts]


def test_pipelined_match_equals_jax_cold_and_memo_warm(data):
    c = data
    j_off, j_on = c.jax
    for eng in (c.port_on, j_off, j_on):
        eng.clear_content_memos()
    want_off = j_off.match(c.j_rows())
    want_on = j_on.match(c.j_rows())
    direct = c.direct
    got = c.port_on.match(c.t_rows())
    assert_same(got, want_on)
    assert_same(got, want_off)
    assert_same(got, direct, wf_pattern=True)
    sched = c.port_on.scheduler()
    assert sched.stats.fresh_rows > 0
    assert sched.stats.dead_rows == sum(not d.get("alive", True) for d in c.dicts)
    # memo-warm: the same content again, in new objects — the memo lane
    # and the steady-state speculation serve it
    again = clones(c.dicts)
    assert_same(c.port_on.match(c.t_rows(again)), j_on.match(c.j_rows(again)))
    assert_same(c.port_on.match(c.t_rows(again)), direct)
    assert sched.stats.memo_rows > 0
    if c.port.db.wf is not None and c.port.db.wf.num_terms:
        assert sum(r.wf is not None for r in got) > 0


def test_pipelined_match_equals_direct_on_the_realistic_mix(synthetic):
    """Content that repeats across rows and chunks (the memo lane, the
    steady-state speculation, in-batch dedup within width buckets):
    pipeline on equals the direct path, cold and memo-warm."""
    c = synthetic
    c.port_on.clear_content_memos()
    got = c.port_on.match(c.t_rows())
    assert_same(got, c.direct, wf_pattern=True)
    again = clones(c.dicts)
    assert_same(c.port_on.match(c.t_rows(again)), c.direct)
    stats = c.port_on.scheduler().stats
    assert stats.memo_rows > 0 and stats.dead_rows == 4


def test_run_with_decode_and_qos_equals_jax(data):
    """``run`` over (index, dicts) payloads that decode on the prefetch
    stage, with a QoS class per chunk: JAX's results, chunk by chunk in
    chunk order."""
    c = data
    j_on = c.jax[1]
    for eng in (c.port_on, j_on):
        eng.clear_content_memos()
    chunks = [c.dicts[i : i + 20] for i in range(0, len(c.dicts), 20)]
    payloads = list(enumerate(chunks))
    qos = lambda payload: "interactive" if payload[0] % 3 == 1 else "bulk"  # noqa: E731
    seen = []

    def decode_t(payload):
        seen.append(payload[0])
        return [t_model.Response(**d) for d in payload[1]]

    cfg = dict(rows_target=BATCH, prefetch="thread", qos_deadline_ms=0.001)
    got = list(BatchScheduler(c.port_on, SchedulerConfig(**cfg)).run(
        payloads, decode=decode_t, qos=qos))
    want = list(JaxScheduler(j_on, JaxConfig(**cfg)).run(
        payloads, decode=lambda p: [j_model.Response(**d) for d in p[1]], qos=qos))
    assert seen == list(range(len(chunks)))
    assert [len(r) for r in got] == [len(ch) for ch in chunks] == [len(r) for r in want]
    for g, w in zip(got, want):
        assert_same(g, w)
    # a fixed class for every chunk
    c.port_on.clear_content_memos()
    got = list(c.port_on.scheduler().run([c.t_rows(ch) for ch in chunks], qos="interactive"))
    for g, w in zip(got, want):
        assert_same(g, w)


class Counting:
    """Wraps an engine's begin/finish to count batches begun and not yet
    finished (the in-flight window as the engine sees it)."""

    def __init__(self, eng):
        self.eng, self.now, self.max = eng, 0, 0
        self.begin, self.finish = eng.begin_packed, eng.finish_packed
        eng.begin_packed, eng.finish_packed = self._begin, self._finish

    def _begin(self, rows, pre=None):
        handle = self.begin(rows, pre=pre)
        self.now += 1
        self.max = max(self.max, self.now)
        return handle

    def _finish(self, handle):
        out = self.finish(handle)
        self.now -= 1
        return out

    def close(self):
        del self.eng.begin_packed, self.eng.finish_packed


@pytest.mark.parametrize("prefetch", ["thread", "inline"])
@pytest.mark.parametrize("walk_offload", ["on", "off"])
@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_overlap_forced_equals_direct_within_cap(data, inflight, walk_offload, prefetch):
    """The card's in-flight window on the CPU (``_overlap_helps``
    forced): the direct path's results, and no more batches begun and
    not yet finished than the window allows (with the walk offloaded,
    at most 3 in flight plus the one walking)."""
    c = data
    direct = c.direct
    eng = c.port_on
    eng.clear_content_memos()
    sched = BatchScheduler(eng, SchedulerConfig(
        rows_target=BATCH // 2, inflight=inflight, walk_offload=walk_offload, prefetch=prefetch))
    sched._overlap_helps = True
    count = Counting(eng)
    try:
        got = sched.match_rows(c.t_rows())
    finally:
        count.close()
    assert_same(got, direct, wf_pattern=True)
    cap = min(inflight, 3) + 1 if walk_offload == "on" else inflight
    assert count.now == 0 and count.max <= cap
    assert sched.stats.max_inflight <= (min(inflight, 3) if walk_offload == "on" else inflight)
    assert sched.stats.batches >= 6
    if inflight > 1:
        assert sched.stats.max_inflight >= 2
    assert (sched.stats.offloaded_walks > 0) == (walk_offload == "on")


def test_overlap_forced_on_the_realistic_mix(synthetic):
    """The widest window with the walk offloaded and the prefetch
    thread, on content that repeats: the direct path's results."""
    c = synthetic
    c.port_on.clear_content_memos()
    sched = BatchScheduler(c.port_on, SchedulerConfig(
        rows_target=BATCH // 2, inflight=4, walk_offload="on", prefetch="thread"))
    sched._overlap_helps = True
    assert_same(sched.match_rows(c.t_rows()), c.direct, wf_pattern=True)
    assert sched.stats.max_inflight == 3 and sched.stats.offloaded_walks == sched.stats.batches


def test_cpu_engine_collapses_the_window(data):
    """On the CPU the window is 1 whatever ``inflight`` asks for: the
    "device" is the host, whose cores the walk needs."""
    c = data
    c.port_on.clear_content_memos()
    sched = BatchScheduler(c.port_on, SchedulerConfig(rows_target=BATCH // 2, inflight=4,
                                                      walk_offload="off"))
    assert not sched._device_overlap_ok()
    assert_same(sched.match_rows(c.t_rows()), c.direct)
    assert sched.stats.max_inflight == 1 and sched.stats.batches >= 6


def test_two_dispatches_in_flight_keep_their_own_results_and_phases(corpus):
    """begin_packed twice, then finish_packed twice: each batch's packed
    result equals its own match_packed, and its compact dict (survivor
    count, stage seconds, collect seconds) is its own."""
    c = corpus
    eng = c.port
    live = [r for r in c.t_rows() if r.alive]
    b1, b2 = live[:BATCH], live[BATCH : 2 * BATCH]
    eng.clear_content_memos()
    alone = []
    for rows in (b1, b2):
        eng.clear_content_memos()
        p = eng.match_packed(rows)
        alone.append((p.bits[: len(rows)].copy(), p.extractions, eng.device.last_compact))
    eng.clear_content_memos()
    s0 = dataclasses.replace(eng.stats)
    h1 = eng.begin_packed(b1)
    h2 = eng.begin_packed(b2)
    s1 = dataclasses.replace(eng.stats)
    p1 = eng.finish_packed(h1)
    assert eng.device.last_compact is h1[2].compact
    bits1 = p1.bits[: len(b1)].copy()
    p2 = eng.finish_packed(h2)
    assert eng.device.last_compact is h2[2].compact
    for (bits, ext, lc), got_bits, got, h in ((alone[0], bits1, p1, h1), (alone[1], None, p2, h2)):
        assert np.array_equal(got_bits if got_bits is not None else got.bits[: len(bits)], bits)
        assert got.extractions == ext
        mine = h[2].compact
        for key in ("survivor_max", "verify_k", "budget"):
            assert mine.get(key) == lc.get(key), key
        assert "collect_s" in mine and "phase_b_s" in mine
    assert h1[2].compact is not h2[2].compact
    # each launch's interval split once, at begin, into phase A and B
    dev = s1.device_seconds - s0.device_seconds
    split = (s1.phase_a_seconds - s0.phase_a_seconds) + (s1.phase_b_seconds - s0.phase_b_seconds)
    assert dev > 0 and split == pytest.approx(dev)
    assert eng.stats.phase_a_seconds == s1.phase_a_seconds


@pytest.fixture(scope="module")
def jax_degrading(data):
    """One pipelined JAX engine for the fault cases (its kernels compile
    once), its breaker opening at the first fault."""
    return JaxEngine(data.j_templates, mesh=None, batch_rows=BATCH, pipeline="on",
                     db=data.jax[0].db, device_breaker_threshold=1)


@pytest.mark.parametrize("prefetch", ["thread", "inline"])
@pytest.mark.parametrize("walk_offload", ["on", "off"])
@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_device_fault_degrades_out_of_run(data, jax_degrading, monkeypatch, where, walk_offload,
                                          prefetch):
    """A fault raised by ``DeviceDB.dispatch`` or ``collect`` degrades its
    batch to the exact CPU oracle: ``run()`` yields every chunk in
    order, equal to the fault-free direct path's results and to JAX's
    ``run`` under the same fault, and so does ``match()``. The faults
    and degraded batches are counted, and the breaker is open."""
    c = data
    dicts = scan_rows(64, seed=2)
    chunks = [dicts[i : i + 16] for i in range(0, len(dicts), 16)]
    c.port.clear_content_memos()
    want = c.port.match(c.t_rows(dicts))
    eng = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cpu",
                      pipeline="on", walk_threads=1, device_breaker_threshold=1)
    j_eng = jax_degrading
    j_eng.clear_content_memos()
    j_eng._device_breakers.reset_all()

    def fault(*_a, **_k):
        raise RuntimeError(f"device fault in {where}")

    monkeypatch.setattr(eng.device, where, fault)
    monkeypatch.setattr(j_eng.device, where, fault)
    cfg = dict(walk_offload=walk_offload, prefetch=prefetch, inflight=2)
    sched = BatchScheduler(eng, SchedulerConfig(**cfg))
    sched._overlap_helps = True
    got = list(sched.run([c.t_rows(ch) for ch in chunks]))
    j_got = list(JaxScheduler(j_eng, JaxConfig(**cfg)).run([c.j_rows(ch) for ch in chunks]))
    assert [len(r) for r in got] == [len(ch) for ch in chunks] == [len(r) for r in j_got]
    flat = [m for res in got for m in res]
    assert_same(flat, want)
    assert_same(flat, [m for res in j_got for m in res])
    assert eng.stats.device_faults >= 1 and eng.stats.degraded_batches >= 1
    assert eng._device_breakers.any_open()
    eng.clear_content_memos()
    assert_same(eng.match(c.t_rows(dicts)), want)
    j_eng.clear_content_memos()
    assert_same(j_eng.match(c.j_rows(dicts)), want)


def _first_encode_raises(monkeypatch, engine) -> list:
    """Make ``engine``'s first ``encode_packed`` raise ``MemoryError``;
    the returned list counts the calls."""
    real, calls = engine.encode_packed, []

    def encode_packed(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise MemoryError("encode planes exhausted")
        return real(*a, **k)

    monkeypatch.setattr(engine, "encode_packed", encode_packed)
    return calls


@pytest.mark.parametrize("prefetch", ["inline", "thread"])
def test_failed_pre_encode_reencodes_at_submit(data, jax_degrading, monkeypatch, prefetch):
    """A pre-encode that raises leaves its batch without ``pre``, and
    ``begin_packed`` encodes the rows again at submit: ``run()`` yields
    all 64 rows in order, equal to the direct path and to JAX's ``run``
    under the same failure."""
    c = data
    dicts = scan_rows(64, seed=2)
    chunks = [dicts[i : i + 16] for i in range(0, len(dicts), 16)]
    c.port.clear_content_memos()
    want = c.port.match(c.t_rows(dicts))
    eng = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cpu",
                      pipeline="on", walk_threads=1)
    j_eng = jax_degrading
    j_eng.clear_content_memos()
    j_eng._device_breakers.reset_all()
    calls = [_first_encode_raises(monkeypatch, e) for e in (eng, j_eng)]
    cfg = dict(walk_offload="off", prefetch=prefetch, inflight=2)
    sched = BatchScheduler(eng, SchedulerConfig(**cfg))
    sched._overlap_helps = True
    got = list(sched.run([c.t_rows(ch) for ch in chunks]))
    j_got = list(JaxScheduler(j_eng, JaxConfig(**cfg)).run([c.j_rows(ch) for ch in chunks]))
    assert [len(r) for r in got] == [len(ch) for ch in chunks] == [len(r) for r in j_got]
    flat = [m for res in got for m in res]
    assert sum(len(r) for r in got) == 64
    assert_same(flat, want)
    assert_same(flat, [m for res in j_got for m in res])
    assert all(len(n) >= 2 for n in calls)


def test_stats_add_up_across_threads(data):
    """The direct path's pre-encode on a helper thread, then the
    scheduler with its prefetch thread and offloaded walk, each under a
    very short switch interval: every row is counted once by the memo
    lookup (encode threads) and once by the assembly (walk thread), and
    device time is split into its phases without a lost update."""
    import sys

    c = data
    eng = c.port_on
    rows = c.t_rows()
    live = sum(r.alive for r in rows)
    before = dataclasses.replace(eng.stats)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        eng.clear_content_memos()
        c.port.clear_content_memos()
        p0 = dataclasses.replace(c.port.stats)
        c.port.match(rows)
        p1 = c.port.stats
        assert (p1.memo_hits - p0.memo_hits) + (p1.memo_misses - p0.memo_misses) == live
        assert p1.rows - p0.rows == live
        sched = BatchScheduler(eng, SchedulerConfig(rows_target=BATCH // 2, inflight=4,
                                                    walk_offload="on", prefetch="thread"))
        sched._overlap_helps = True
        sched.match_rows(rows)
    finally:
        sys.setswitchinterval(interval)
    st = eng.stats
    assert st.rows - before.rows == live
    assert (st.memo_hits - before.memo_hits) + (st.memo_misses - before.memo_misses) == live
    dev = st.device_seconds - before.device_seconds
    split = (st.phase_a_seconds - before.phase_a_seconds) + (
        st.phase_b_seconds - before.phase_b_seconds)
    assert 0 < split <= dev + 1e-9


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
def test_pipelined_match_equals_direct_on_card(card, corpus):
    """The twin of the CPU parity test on ``cuda``: pipeline on equals
    the card's direct path and JAX's, cold and memo-warm."""
    c = corpus
    on = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cuda",
                     pipeline="on")
    off = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cuda")
    direct = off.match(c.t_rows())
    got = on.match(c.t_rows())
    assert_same(got, direct, wf_pattern=True)
    c.jax[0].clear_content_memos()
    assert_same(got, c.jax[0].match(c.j_rows()))
    again = clones(c.dicts)
    assert_same(on.match(c.t_rows(again)), direct)
    assert on.scheduler()._device_overlap_ok()


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", ["thread", "inline"])
@pytest.mark.parametrize("walk_offload", ["on", "off"])
@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_overlap_equals_direct_within_cap_on_card(card, corpus, inflight, walk_offload, prefetch):
    c = corpus
    off = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cuda")
    direct = off.match(c.t_rows())
    eng = MatchEngine(c.t_templates, db=c.port.db, batch_rows=BATCH, device="cuda")
    sched = BatchScheduler(eng, SchedulerConfig(
        rows_target=BATCH // 2, inflight=inflight, walk_offload=walk_offload, prefetch=prefetch))
    count = Counting(eng)
    try:
        t0 = time.perf_counter()
        got = sched.match_rows(c.t_rows())
        assert time.perf_counter() - t0 < 120
    finally:
        count.close()
    assert_same(got, direct, wf_pattern=True)
    assert count.max <= (min(inflight, 3) + 1 if walk_offload == "on" else inflight)
    if inflight > 1:
        assert sched.stats.max_inflight >= 2
