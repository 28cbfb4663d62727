"""The port's span tracing, flight recorder and waterfall assembler
(``swarm_tpu_torch/telemetry/tracing.py``) against the JAX package's
(``swarm_tpu/telemetry/tracing.py``), on the CPU.

- the module is a copy: every function and class is the reference's
  source with the package name changed;
- the flight ring and its dumps from the same sequence of events,
  synthesized spans, an injected ``device.dispatch`` fault, a breaker
  that opens, a dead letter and a journal recovery are equal (records
  without their ``ts``), and so are the ``swarm_trace_flight_dumps_total``
  deltas;
- ``blob_flight_sink`` writes the same keys with the same bytes and
  keeps the same ones past its retention;
- ``TraceAssembler``'s waterfall documents for the queue-only scripts of
  ``tests/test_trace_waterfall.py`` (a retried job, a journal recovery)
  are equal under one patched clock and one span-id sequence, and so
  are ``waterfall_orphans`` and ``critical_path`` of them and the
  ``_traces/`` blobs;
- a CPU ``MatchEngine`` under ``device.dispatch:1`` dumps the ring with
  the port's own ``device.dispatch`` record (``DeviceDB.dispatch``), as
  the JAX engine's dump holds the JAX one.

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import inspect
import itertools
import json
import random
import re
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from test_torch_queue import FakeTime

import swarm_tpu.config as j_config
import swarm_tpu.datamodel as j_dm
import swarm_tpu.resilience.breaker as j_breaker
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.server.queue as j_queue
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu.telemetry.tracing as j_tracing
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.datamodel as t_dm
import swarm_tpu_torch.resilience.breaker as t_breaker
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.server.queue as t_queue
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics
import swarm_tpu_torch.telemetry.tracing as t_tracing

PKG = {
    "jax": SimpleNamespace(config=j_config, dm=j_dm, breaker=j_breaker, faults=j_faults,
                           queue=j_queue, stores=j_stores, metrics=j_metrics, tracing=j_tracing),
    "torch": SimpleNamespace(config=t_config, dm=t_dm, breaker=t_breaker, faults=t_faults,
                             queue=t_queue, stores=t_stores, metrics=t_metrics,
                             tracing=t_tracing),
}
SIDES = ("jax", "torch")
DATA = Path(__file__).resolve().parent / "data" / "templates"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: six test processes share the host,
    and no result depends on it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_copy_matches_its_original():
    def own(module):
        return {name: obj for name, obj in vars(module).items()
                if (inspect.isfunction(obj) or inspect.isclass(obj))
                and obj.__module__ == module.__name__}

    mine, theirs = own(t_tracing), own(j_tracing)
    assert set(mine) == set(theirs)
    assert {"FlightRecorder", "TraceAssembler", "waterfall_orphans", "critical_path",
            "blob_flight_sink", "flight_event", "flight_dump"} <= set(mine)
    for name, obj in theirs.items():
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert inspect.getsource(mine[name]) == want, name
    assert t_tracing._DUMP_REASONS == j_tracing._DUMP_REASONS
    assert t_tracing.FlightRecorder.RING == j_tracing.FlightRecorder.RING


# ---------------------------------------------------------------------------
# the harness: a clock, a span-id sequence and a fresh flight ring a side


def _dump_samples(metrics) -> dict:
    return {labels["reason"]: value
            for name, labels, value in metrics.parse_exposition(metrics.REGISTRY.render())
            if name == "swarm_trace_flight_dumps_total"}


def _no_ts(payload: dict) -> dict:
    out = {k: v for k, v in payload.items() if k != "ts"}
    if "records" in out:
        out["records"] = [{k: v for k, v in r.items() if k != "ts"} for r in out["records"]]
    return out


def on_side(side: str, monkeypatch, enabled: bool = True) -> SimpleNamespace:
    """Arm one package: its own flight ring, the clock on its queue, data
    model and tracing module, span ids ``s0000``, ``s0001``, … and
    tracing on (or off)."""
    p = PKG[side]
    clock = FakeTime()
    for module in (p.queue, p.dm, p.tracing):
        monkeypatch.setattr(module, "time", clock)
    ids = itertools.count()
    monkeypatch.setattr(p.tracing, "new_span_id", lambda: "s%04d" % next(ids))
    monkeypatch.setattr(p.tracing, "FLIGHT", p.tracing.FlightRecorder())
    p.tracing.set_enabled(enabled)
    p.faults.clear_plan()
    return SimpleNamespace(p=p, clock=clock, tr=p.tracing)


@pytest.fixture(autouse=True)
def _restore():
    yield
    for side in SIDES:
        PKG[side].tracing.set_enabled(None)
        PKG[side].faults.clear_plan()


def _service(p, blobs=None, **cfg_kw):
    return p.queue.JobQueueService(
        p.config.Config(**cfg_kw), p.stores.MemoryStateStore(),
        blobs if blobs is not None else p.stores.MemoryBlobStore(), p.stores.MemoryDocStore())


# ---------------------------------------------------------------------------
# the flight ring


def flight_sequence(s) -> list:
    """Events, spans, an injected fault, a breaker that opens, a dead
    letter and a recovery → what each step returned."""
    p, tr = s.p, s.tr
    seen = []
    tr.flight_event("device.dispatch", rows=4, shape="w448h192")
    tr.flight_event("sched.deadline_flush", qos="interactive", bucket="x:w64h0")
    ctx = tr.TraceContext("ab" * 8, job_id="j_1_0", attempt=1)
    root = ctx.add_synth("execute", s.clock.time(), 0.25)
    ctx.add_synth("device", s.clock.time(), 0.125, parent_id=root, rows=64)
    seen.append([sp["name"] for sp in ctx.finish()])
    p.faults.install_plan("device.dispatch:1")
    with pytest.raises(p.faults.FaultInjected) as e:
        p.faults.fault_point("device.dispatch")
    p.faults.clear_plan()
    seen.append(str(e.value))
    br = p.breaker.CircuitBreaker("trace-test.breaker", threshold=2, cooldown_s=60.0)
    br.record_failure()
    s.clock.advance(1.0)
    br.record_failure()
    seen.append(br.state)
    blobs = p.stores.MemoryBlobStore()
    q = _service(p, blobs=blobs, max_attempts=1, lease_seconds=5.0)
    q.queue_scan({"module": "echo", "file_content": ["t\n"], "batch_size": 1,
                  "scan_id": "fl_1"}, trace_id="cd" * 8)
    job = q.next_job("w1")
    seen.append(q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "w1"}))
    q.queue_scan({"module": "echo", "file_content": ["u\n"], "batch_size": 1,
                  "scan_id": "fl_2"}, trace_id="ef" * 8)
    s.clock.advance(2.0)
    q2 = _service(p, blobs=blobs, max_attempts=1, lease_seconds=5.0)
    seen.append(q2.recovery_summary)
    return seen


def test_flight_ring_and_dumps_equal_jax(monkeypatch):
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch)
        before = _dump_samples(s.p.metrics)
        seen = flight_sequence(s)
        after = _dump_samples(s.p.metrics)
        dumps = s.tr.FLIGHT.last_dumps()
        out[side] = {"seen": seen, "dumps": [_no_ts(d) for d in dumps],
                     "ring": [_no_ts({"records": s.tr.FLIGHT.snapshot()})],
                     "moved": {k: v - before.get(k, 0.0) for k, v in after.items()
                               if v != before.get(k, 0.0)}}
    assert out["torch"] == out["jax"]
    dumps = out["torch"]["dumps"]
    assert [d["reason"] for d in dumps] == ["fault", "breaker_open", "dead_letter",
                                            "journal_recovery"]
    assert dumps[0]["detail"] == "device.dispatch"
    assert any(r["name"] == "device.dispatch" for r in dumps[0]["records"])
    assert out["torch"]["moved"] == {"fault": 1.0, "breaker_open": 1.0, "dead_letter": 1.0,
                                     "journal_recovery": 1.0}


def test_flight_ring_is_bounded_and_keeps_the_last_dumps(monkeypatch):
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch)
        fr = s.tr.FlightRecorder(ring=16)
        for i in range(40):
            fr.record("event", f"e{i}", i=i, skip=None)
        for i in range(11):
            fr.dump("other-%d" % i if i % 2 else "fault", detail=str(i))
        out[side] = ([_no_ts({"records": fr.snapshot()})],
                     [_no_ts(d) for d in fr.last_dumps()])
    assert out["torch"] == out["jax"]
    records, dumps = out["torch"]
    assert [r["name"] for r in records[0]["records"]] == [f"e{i}" for i in range(24, 40)]
    assert [d["seq"] for d in dumps] == list(range(4, 12))


@pytest.mark.parametrize("retain", [1, 3, 20])
def test_blob_flight_sink_keys_and_retention_equal_jax(retain, monkeypatch):
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch)
        blobs = s.p.stores.MemoryBlobStore()
        sink = s.tr.blob_flight_sink(blobs, retain=retain)
        fr = s.tr.FlightRecorder()
        fr.record("event", "device.dispatch")
        for reason in ("fault", "breaker_open", "odd/reason name!", "dead_letter", "x.y-z"):
            sink(fr.dump(reason, detail="d"))
            s.clock.advance(0.5)
        out[side] = {k: blobs.get(k) for k in blobs.list("")}
    assert out["torch"] == out["jax"]
    keys = sorted(out["torch"])
    assert len(keys) == min(retain, 5) and keys[-1] == "_flight/dump_000005_x.y-z.json"


def test_flight_sink_runs_off_the_dumping_thread(monkeypatch):
    """A registered sink gets the dump on a daemon thread; a sink that
    raises never reaches the caller; unsubscribing stops delivery."""
    for side in SIDES:
        s = on_side(side, monkeypatch)
        blobs = s.p.stores.MemoryBlobStore()
        threads = []

        def broken(_payload):
            raise RuntimeError("sink down")

        def noting(payload):
            import threading

            threads.append(threading.current_thread().name)

        remove = [s.tr.FLIGHT.add_sink(fn) for fn in
                  (broken, noting, s.tr.blob_flight_sink(blobs))]
        s.tr.flight_dump("fault", detail="x")
        deadline = time.monotonic() + 5
        while not blobs.list("_flight/") and time.monotonic() < deadline:
            time.sleep(0.005)
        assert blobs.list("_flight/") == ["_flight/dump_000001_fault.json"]
        assert threads == ["flight-dump"]
        for r in remove:
            r()
        s.tr.flight_dump("fault", detail="y")
        time.sleep(0.05)
        assert len(blobs.list("_flight/")) == 1 and threads == ["flight-dump"]


# ---------------------------------------------------------------------------
# the waterfall documents (tests/test_trace_waterfall.py's queue scripts)


def retried_job(s):
    p, tr = s.p, s.tr
    q = _service(p)
    tid = "aa" * 8
    q.queue_scan({"module": "echo", "file_content": ["t\n"], "batch_size": 1,
                  "scan_id": "retry_1"}, trace_id=tid)
    s.clock.advance(0.5)
    job = q.next_job("w1")
    s.clock.advance(0.25)
    t0 = s.clock.time()
    q.update_job(job["job_id"], {
        "status": p.dm.JobStatus.CMD_FAILED, "worker_id": "w1",
        "perf": {"spans": [tr.make_span("attempt", tid, t0 - 0.02, 0.01, attempt=1,
                                        error="boom")]}})
    assert q.job_record(job["job_id"])["status"] == p.dm.JobStatus.QUEUED
    s.clock.advance(0.125)
    job2 = q.next_job("w1")
    assert job2["job_id"] == job["job_id"]
    s.clock.advance(0.25)
    q.update_job(job2["job_id"], {
        "status": p.dm.JobStatus.COMPLETE, "worker_id": "w1",
        "perf": {"spans": [tr.make_span("attempt", tid, s.clock.time() - 0.01, 0.01,
                                        attempt=2)]}})
    doc = q.tracer.get("retry_1")
    assert doc["status"] == "complete" and doc["trace_id"] == tid
    assert sorted(sp["attrs"]["attempt"] for sp in doc["spans"]
                  if sp["name"] == "attempt") == [1, 2]
    assert sum(sp["name"] == "queue-wait" for sp in doc["spans"]) == 2
    return q, ["retry_1"]


def journal_recovery(s):
    p, tr = s.p, s.tr
    blobs = p.stores.MemoryBlobStore()
    svc1 = _service(p, blobs=blobs)
    tid = "bb" * 8
    svc1.queue_scan({"module": "echo", "file_content": ["x\n", "y\n"], "batch_size": 1,
                     "scan_id": "recov_1"}, trace_id=tid)
    s.clock.advance(0.5)
    j1 = svc1.next_job("w1")
    s.clock.advance(0.25)
    svc1.update_job(j1["job_id"], {
        "status": p.dm.JobStatus.COMPLETE, "worker_id": "w1",
        "perf": {"spans": [tr.make_span("attempt", tid, s.clock.time() - 0.01, 0.01,
                                        attempt=1)]}})
    s.clock.advance(3.0)
    svc2 = _service(p, blobs=blobs)
    assert [d["reason"] for d in tr.FLIGHT.last_dumps()] == ["journal_recovery"]
    open_doc = svc2.tracer.get("recov_1")
    assert open_doc["status"] == "open"
    s.clock.advance(0.5)
    j2 = svc2.next_job("w2")
    assert j2["scan_id"] == "recov_1"
    s.clock.advance(0.25)
    svc2.update_job(j2["job_id"], {
        "status": p.dm.JobStatus.COMPLETE, "worker_id": "w2",
        "perf": {"spans": [tr.make_span("attempt", tid, s.clock.time() - 0.01, 0.01,
                                        attempt=1)]}})
    doc = svc2.tracer.get("recov_1")
    assert doc["trace_id"] == tid
    assert "journal-recovery" in {sp["name"] for sp in doc["spans"]}
    return svc2, ["recov_1"]


def short_circuit(s):
    """The zero-dispatch completion the gateway assembles inline."""
    tr = s.tr
    asm = tr.TraceAssembler(s.p.stores.MemoryBlobStore())
    tid = "dd" * 8
    t0 = s.clock.time()
    spans = [tr.make_span("admission", tid, t0, 0.001),
             tr.make_span("cache.lookup", tid, t0 + 0.001, 0.002),
             tr.make_span("completion", tid, t0 + 0.003, 0.001)]
    doc = asm.assemble_short_circuit("probe_2", tid, t0, 0.004, 1, spans, qos="interactive",
                                     tenant="acme")
    assert doc["status"] == "short_circuit"
    asm.flush()
    return SimpleNamespace(tracer=asm, blobs=asm._blobs), ["probe_2"]


SCRIPTS = [retried_job, journal_recovery, short_circuit]


@pytest.mark.parametrize("script", SCRIPTS, ids=[f.__name__ for f in SCRIPTS])
def test_waterfall_documents_equal_jax(script, monkeypatch):
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch)
        before = {k: v for k, _l, v in [(n, lab, val) for n, lab, val in
                  s.p.metrics.parse_exposition(s.p.metrics.REGISTRY.render())
                  if n == "swarm_trace_assembled_total"]}
        holder, scans = script(s)
        docs = [holder.tracer.get(sid) for sid in scans]
        assembled = [v for n, _l, v in s.p.metrics.parse_exposition(
            s.p.metrics.REGISTRY.render()) if n == "swarm_trace_assembled_total"][0]
        out[side] = {
            "docs": docs,
            "orphans": [s.tr.waterfall_orphans(d) for d in docs],
            "critical": [s.tr.critical_path(d) for d in docs],
            "blobs": {k: holder.blobs.get(k) for k in holder.blobs.list("_traces/")},
            "dumps": [_no_ts(d) for d in s.tr.FLIGHT.last_dumps()],
            "assembled": assembled - before["swarm_trace_assembled_total"],
        }
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert all(o == [] for o in got["orphans"]) and got["assembled"] == len(scans)
    assert all(json.loads(v) == d for v, d in zip(got["blobs"].values(), got["docs"]))
    for cp in got["critical"]:
        assert cp and cp[0][1] > 0


def test_waterfall_analysis_on_a_lossy_document_equals_jax():
    """Orphans and the per-name interval union on a hand-built document
    with overlapping siblings and a span whose parent is missing."""
    def doc(tr):
        root = tr.make_span("scan", "t", 10.0, 4.0, span_id="scan-x")
        spans = [tr.make_span("queue-wait", "t", 10.0, 1.0, parent_id="scan-x", span_id="a"),
                 tr.make_span("queue-wait", "t", 10.5, 1.5, parent_id="scan-x", span_id="b"),
                 tr.make_span("attempt", "t", 12.0, 2.0, parent_id="scan-x", span_id="c"),
                 tr.make_span("device", "t", 12.5, 0.5, parent_id="c", span_id="d"),
                 tr.make_span("upload", "t", 13.0, 0.25, parent_id="gone", span_id="e")]
        return {"root": root, "spans": spans}

    got = {side: (PKG[side].tracing.waterfall_orphans(doc(PKG[side].tracing)),
                  PKG[side].tracing.critical_path(doc(PKG[side].tracing))) for side in SIDES}
    assert got["torch"] == got["jax"]
    orphans, cp = got["torch"]
    assert [s["span_id"] for s in orphans] == ["e"]
    assert cp == [("queue-wait", 2.0, 0.5), ("attempt", 2.0, 0.5)]


def test_trace_context_drain_and_flight_records_equal_jax(monkeypatch):
    """``drain`` hands off the spans so far without closing the root;
    every span added lands in the flight ring."""
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch)
        ctx = s.tr.TraceContext("ee" * 8, job_id="d_1_0")
        ctx.add_synth("download", 1.0, 0.5)
        first = ctx.drain()
        ctx.add_synth("execute", 2.0, 0.25)
        rest = ctx.finish()
        out[side] = (first, rest, [_no_ts({"records": s.tr.FLIGHT.snapshot()})])
    assert out["torch"] == out["jax"]
    first, rest, ring = out["torch"]
    assert [sp["name"] for sp in first] == ["download"]
    assert [sp["name"] for sp in rest] == ["attempt", "execute"]
    assert [r["name"] for r in ring[0]["records"]] == ["download", "execute"]


# ---------------------------------------------------------------------------
# the engine's own device.dispatch record


@pytest.fixture(scope="module")
def corpus():
    from swarm_tpu.fingerprints import load_corpus
    from test_match_parity import fuzz_rows
    from test_torch_walk import to_port

    templates, _ = load_corpus(DATA)
    return templates, [to_port(t) for t in templates], fuzz_rows, to_port


def test_engine_dispatch_fault_dump_holds_its_own_record(corpus, monkeypatch):
    """A CPU ``MatchEngine`` under ``device.dispatch:1`` (breaker
    threshold 1): the first dispatch's flight record, then the fault's
    dump, then the breaker's; the batch is redone on the oracle with
    the same matches. The port's records are the port's own
    (``DeviceDB.dispatch`` wrote them into the port's ring)."""
    from swarm_tpu.ops.engine import MatchEngine as JEngine
    from swarm_tpu_torch.ops.engine import MatchEngine as TEngine

    j_templates, t_templates, fuzz_rows, to_port = corpus
    j_rows = fuzz_rows(j_templates, random.Random(9), 12)
    out = {}
    for side in SIDES:
        s = on_side(side, monkeypatch, enabled=False)
        if side == "jax":
            eng = JEngine(j_templates, mesh=None, batch_rows=16, device_breaker_threshold=1,
                          device_breaker_cooldown_s=60.0)
            rows = j_rows
        else:
            eng = TEngine(t_templates, device="cpu", walk_threads=1, batch_rows=16,
                          device_breaker_threshold=1, device_breaker_cooldown_s=60.0)
            rows = [to_port(r) for r in j_rows]
        s.p.faults.install_plan("device.dispatch:1")
        matches = [(m.template_ids, m.extractions) for m in eng.match(rows)]
        s.p.faults.clear_plan()
        out[side] = {"matches": matches, "dumps": [_no_ts(d) for d in s.tr.FLIGHT.last_dumps()],
                     "degraded": eng.stats.degraded_batches}
    assert out["torch"] == out["jax"]
    dumps = out["torch"]["dumps"]
    assert [d["reason"] for d in dumps][:1] == ["fault"]
    assert dumps[0]["detail"] == "device.dispatch"
    assert dumps[0]["records"] == [{"kind": "event", "name": "device.dispatch"}]
    assert out["torch"]["degraded"] >= 1
