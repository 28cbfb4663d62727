"""The server cases of the reference's other test files, each run on the
port's ``SwarmServer`` and on the JAX package's, on the CPU, through the
harness of ``tests/test_torch_server.py``: one patched clock, one uuid
sequence, roots of their own; the scripts' observations, the last
server's state, blob and doc stores and the server families' metric
deltas equal.

- ``tests/test_monitor.py``: the registry over HTTP, an epoch's fire,
  diff, feed and provenance, a paused spec, a feed resumed after a
  disconnect (each package's own ``JobClient``),
  two kill-9 recoveries, the zero-dispatch steady state, and the corpus
  delta's out-of-cadence epoch (each package's own engine, the port's
  on the CPU) with its kill-9 twin;
- ``tests/test_gateway.py``: the rate shed and its ``Retry-After``, a
  bad tenant, a malformed submission that burns no token, ``/tenants``,
  ``/healthz``'s pressure, the gateway families, the saturation feed
  and ``/autoscale``;
- ``tests/test_qos.py``: the QoS header, the gateway cache's
  short-circuit, bulk never short-circuiting, an epoch bump, and the
  latency histogram by class;
- ``tests/test_trace_waterfall.py``: a short-circuit scan's waterfall
  and the ``/spans`` route.

The API key of every script is the harness's (the reference's files use
one each). Everything compared is bytes, strings or numbers:
tolerance 0.
"""

import json
import time
from pathlib import Path

import pytest

from test_torch_server import AUTH, one_torch_thread, run_case  # noqa: F401

MONITOR = dict(monitor_tick_s=3600.0, monitor_feed_poll_s=0.01,
               monitor_feed_idle_timeout_s=1.0)
TEMPLATES = Path(__file__).resolve().parent / "data" / "templates"


# ---------------------------------------------------------------------------
# tests/test_monitor.py


def _register(e, srv, monitor_id, targets, module="monmod", interval_s=3600.0,
              batch_size=1, **extra):
    return e.post(srv, "/monitor", json={
        "monitor_id": monitor_id, "module": module, "targets": targets,
        "interval_s": interval_s, "batch_size": batch_size, **extra})


def _pump(e, srv, out_line, worker="w", limit=64) -> int:
    """Drain the dispatch queue through the HTTP worker surface, one
    content-derived verdict line per input line."""
    done = 0
    for _ in range(limit):
        r = e.get(srv, "/get-job", params={"worker_id": worker})
        if r.status_code != 200:
            break
        job = r.json()
        sid, idx = job["scan_id"], int(job["chunk_index"])
        raw = srv.queue.blobs.get(e.p.dm.chunk_input_key(sid, idx)).decode()
        out = "".join(out_line(line) for line in raw.split("\n"))
        e.post(srv, f"/put-output-chunk/{sid}/{idx}", data=out.encode())
        e.post(srv, f"/update-job/{job['job_id']}", json={"status": "complete"})
        done += 1
    return done


def _drain_epoch(srv, deadline_s=20.0) -> None:
    end = time.time() + deadline_s
    while srv.monitor.drain() == 0:
        if time.time() > end:
            raise AssertionError("epoch diff did not commit before deadline")
        time.sleep(0.02)


def _fire_epoch(e, srv, out_line=lambda ln: f"v:{ln}\n") -> int:
    fired = srv.monitor.tick(now=e.clock.now + 1e6)
    _pump(e, srv, out_line)
    _drain_epoch(srv)
    return fired


def _feed_lines(e, srv, monitor_id, from_seq=0):
    resp = e.get(srv, f"/monitor-feed/{monitor_id}", params={"from": from_seq},
                 stream=True)
    records, control = [], None
    for line in resp.iter_lines():
        rec = json.loads(line)
        if "event" in rec:
            control = rec
            break
        records.append(rec)
    resp.close()
    return records, control


def m_registry_lifecycle_http(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, e.post(srv, "/monitor", json={
        "module": "echo", "targets": ["a\n"], "interval_s": 60}))]
    seen += [e.norm(srv, _register(e, srv, "bad", [], interval_s=60)),
             e.norm(srv, _register(e, srv, "bad", ["a\n"], interval_s=0)),
             e.norm(srv, _register(e, srv, "no.dots", ["a\n"])),
             e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n"])),
             e.norm(srv, e.get(srv, "/monitor"))]
    for op in ("pause", "resume", "sideways", "rm", "rm"):
        seen.append(e.norm(srv, e.post(srv, "/monitor/m1", json={"op": op})))
    seen.append(e.norm(srv, e.get(srv, "/monitor-feed/ghost")))
    seen.append(e.norm(srv, e.get(srv, "/monitor-feed/bad.id")))
    return seen


def test_monitor_registry_lifecycle_http(tmp_path, monkeypatch):
    seen = run_case(m_registry_lifecycle_http, tmp_path, monkeypatch)["seen"]
    assert seen[0]["code"] == 200 and seen[0]["body"]["monitor_id"]
    assert [s["code"] for s in seen[1:5]] == [400, 400, 400, 200]
    m1 = next(m for m in seen[5]["body"]["monitors"] if m["monitor_id"] == "m1")
    assert m1["targets"] == ["a\n", "b\n"] and not m1["paused"]
    assert [s["code"] for s in seen[6:11]] == [200, 200, 400, 200, 404]
    assert [seen[6]["body"]["paused"], seen[7]["body"]["paused"]] == [True, False]
    assert [s["code"] for s in seen[11:]] == [404, 400]


def m_epoch_fire_diff_feed_and_provenance(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n", "c\n"])),
            _fire_epoch(e, srv), _feed_lines(e, srv, "m1"),
            e.p.mfeed.marked_epochs(srv.queue.blobs, "m1")]
    e.clock.advance(1.0)
    seen += [_fire_epoch(e, srv, lambda ln: f"v2:{ln}\n" if ln == "b" else f"v:{ln}\n"),
             _feed_lines(e, srv, "m1"), e.norm(srv, e.get(srv, "/get-statuses"))]
    return seen


def test_epoch_fire_diff_feed_and_provenance(tmp_path, monkeypatch):
    seen = run_case(m_epoch_fire_diff_feed_and_provenance, tmp_path, monkeypatch)["seen"]
    records, _ = seen[2]
    assert seen[1] == 1 and [(r["kind"], r["target"], r["seq"]) for r in records] == [
        ("new", "a", 0), ("new", "b", 1), ("new", "c", 2)]
    assert seen[3] == [1] and seen[4] == 1
    records, _ = seen[5]
    assert [(r["kind"], r["target"], r["seq"]) for r in records[3:]] == [("changed", "b", 3)]
    by_epoch = {s["monitor_epoch"]: s for s in seen[6]["body"]["scans"]
                if s.get("monitor_id") == "m1"}
    assert set(by_epoch) == {1, 2}
    assert all(s["scan_status"] == "complete" for s in by_epoch.values())


def m_paused_monitor_emits_nothing(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n"], paused=True)),
            srv.monitor.tick(now=e.clock.now + 1e6),
            srv.queue.blobs.list(e.p.mfeed.feed_prefix("m1")),
            e.p.mfeed.marked_epochs(srv.queue.blobs, "m1"), srv.queue.get_monitor("m1")]
    e.post(srv, "/monitor/m1", json={"op": "resume"})
    seen += [_fire_epoch(e, srv), e.p.mfeed.marked_epochs(srv.queue.blobs, "m1")]
    return seen


def test_paused_monitor_emits_nothing(tmp_path, monkeypatch):
    seen = run_case(m_paused_monitor_emits_nothing, tmp_path, monkeypatch)["seen"]
    assert seen[1:4] == [0, [], []]
    assert seen[4]["epoch"] == 0 and seen[4]["last_scan_id"] is None
    assert seen[5:] == [1, [1]]


def m_feed_mid_stream_disconnect_resumes_without_dups(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", [f"t{i}\n" for i in range(4)])),
            _fire_epoch(e, srv)]
    resp = e.get(srv, "/monitor-feed/m1", stream=True)
    acked = []
    for line in resp.iter_lines():
        acked.append(json.loads(line))
        if len(acked) == 2:
            break
    resp.close()
    client = e.p.cli.JobClient(e.base(srv), AUTH["Authorization"].split()[1])
    resumed = []
    for rec in client.monitor_feed("m1", from_seq=acked[-1]["seq"] + 1):
        resumed.append(rec)
        if len(resumed) == 2:
            break
    e.post(srv, "/monitor/m1", json={"op": "rm"})
    seen += [acked, resumed, _feed_lines(e, srv, "m1"), list(client.monitor_feed("m1"))]
    return seen


def test_feed_mid_stream_disconnect_resumes_without_dups(tmp_path, monkeypatch):
    seen = run_case(m_feed_mid_stream_disconnect_resumes_without_dups, tmp_path,
                    monkeypatch)["seen"]
    acked, resumed, (records, control), everything = seen[2:]
    assert [r["seq"] for r in acked] == [0, 1] and [r["seq"] for r in resumed] == [2, 3]
    assert [r["target"] for r in acked + resumed] == ["t0", "t1", "t2", "t3"]
    assert len(records) == 4 and control == {"event": "end", "next_seq": 4}
    assert [r["seq"] for r in everything] == [0, 1, 2, 3]


def m_kill9_mid_epoch_resumes_cadence_and_feed(e):
    epoch2 = lambda ln: f"v2:{ln}\n"  # noqa: E731
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n", "c\n"])),
            _fire_epoch(e, srv), _feed_lines(e, srv, "m1")]
    e.clock.advance(1.0)
    seen += [srv.monitor.tick(now=e.clock.now + 1e6), _pump(e, srv, epoch2, limit=1)]
    spec_before = srv.queue.get_monitor("m1")
    seen.append(spec_before)
    # kill -9: no shutdown; a fresh server over the same roots
    srv2 = e.server(**MONITOR)
    seen += [srv2.queue.get_monitor("m1"), srv2.monitor.tick(now=e.clock.now),
             _pump(e, srv2, epoch2)]
    _drain_epoch(srv2)
    seen += [e.p.mfeed.marked_epochs(srv2.queue.blobs, "m1"), _feed_lines(e, srv2, "m1"),
             _feed_lines(e, srv2, "m1", from_seq=3)]
    e.clock.advance(1.0)
    seen += [_fire_epoch(e, srv2, epoch2), srv2.queue.get_monitor("m1"),
             e.p.mfeed.marked_epochs(srv2.queue.blobs, "m1"), _feed_lines(e, srv2, "m1")]
    return seen


def test_kill9_mid_epoch_resumes_cadence_and_feed(tmp_path, monkeypatch):
    seen = run_case(m_kill9_mid_epoch_resumes_cadence_and_feed, tmp_path,
                    monkeypatch)["seen"]
    assert seen[1] == 1 and seen[3:5] == [1, 1] and seen[5]["epoch"] == 2
    spec = seen[6]
    assert spec["epoch"] == 2 and spec["last_scan_id"] == seen[5]["last_scan_id"]
    assert not spec["refire"] and seen[7:9] == [0, 2]
    assert seen[9] == [1, 2]
    records, _ = seen[10]
    assert [r["seq"] for r in records] == list(range(6))
    resumed, control = seen[11]
    assert [r["seq"] for r in resumed] == [3, 4, 5]
    assert control == {"event": "timeout", "next_seq": 6}
    assert seen[12] == 1 and seen[13]["epoch"] == 3 and seen[14] == [1, 2, 3]
    assert len(seen[15][0]) == 6


def m_kill9_between_journal_and_fire_refires_same_epoch(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n"]))]
    boom = RuntimeError("crashed before fire")
    srv.queue.queue_scan = lambda *a, **kw: (_ for _ in ()).throw(boom)
    seen += [srv.monitor.tick(now=e.clock.now + 1e6), srv.queue.get_monitor("m1")]
    srv2 = e.server(**MONITOR)
    seen += [srv2.queue.get_monitor("m1"), srv2.monitor.tick(now=e.clock.now),
             srv2.queue.get_monitor("m1"), _pump(e, srv2, lambda ln: f"v:{ln}\n")]
    _drain_epoch(srv2)
    seen += [e.p.mfeed.marked_epochs(srv2.queue.blobs, "m1"), _feed_lines(e, srv2, "m1")]
    return seen


def test_kill9_between_journal_and_fire_refires_same_epoch(tmp_path, monkeypatch):
    seen = run_case(m_kill9_between_journal_and_fire_refires_same_epoch, tmp_path,
                    monkeypatch)["seen"]
    sid = seen[2]["last_scan_id"]
    assert seen[1] == 0 and seen[2]["epoch"] == 1 and sid
    assert seen[3]["refire"] and seen[3]["next_fire_at"] == 0.0
    assert seen[4] == 1 and seen[5]["epoch"] == 1 and seen[5]["last_scan_id"] == sid
    assert not seen[5]["refire"] and seen[7] == [1]
    assert [(r["kind"], r["target"], r["epoch"]) for r in seen[8][0]] == [
        ("new", "a", 1), ("new", "b", 1)]


def m_steady_state_epoch_is_zero_dispatch(e):
    srv = e.server(cache_backend="memory", qos_cache_max_rows=8, **MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", [f"t{i}\n" for i in range(4)])),
            _fire_epoch(e, srv)]
    e.clock.advance(1.0)
    seen += [srv.monitor.tick(now=e.clock.now + 1e6),
             e.norm(srv, e.get(srv, "/get-job", params={"worker_id": "w"}))]
    _drain_epoch(srv)
    seen += [e.p.mfeed.marked_epochs(srv.queue.blobs, "m1"), _feed_lines(e, srv, "m1"),
             json.loads(srv.queue.blobs.get(e.p.mfeed.mark_key("m1", 2))),
             e.norm(srv, e.get(srv, "/get-statuses"))]
    return seen


def test_steady_state_epoch_is_zero_dispatch(tmp_path, monkeypatch):
    seen = run_case(m_steady_state_epoch_is_zero_dispatch, tmp_path, monkeypatch)["seen"]
    assert seen[1:3] == [1, 1] and seen[3]["code"] != 200
    assert seen[4] == [1, 2] and len(seen[5][0]) == 4 and seen[6]["records"] == 0
    e2 = next(s for s in seen[7]["body"]["scans"]
              if s.get("monitor_id") == "m1" and s.get("monitor_epoch") == 2)
    assert e2["scan_status"] == "complete"


def _refresh_engine(e):
    """A CPU engine of the package over the repo's test corpus,
    refreshed with its own corpus (a no-op delta still notifies)."""
    if e.side == "jax":
        from swarm_tpu.fingerprints import load_corpus
        from swarm_tpu.ops.engine import MatchEngine

        templates, _ = load_corpus(TEMPLATES)
        engine = MatchEngine(templates, mesh=None)
    else:
        from swarm_tpu_torch.fingerprints.nuclei import load_corpus
        from swarm_tpu_torch.ops.engine import MatchEngine

        templates, _ = load_corpus(TEMPLATES)
        engine = MatchEngine(templates, device="cpu")
    engine.refresh_corpus(templates)


def m_corpus_delta_fires_one_out_of_cadence_epoch(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n"])),
            e.norm(srv, _register(e, srv, "mp", ["c\n"])),
            e.norm(srv, e.post(srv, "/monitor/mp", json={"op": "pause"})),
            _fire_epoch(e, srv)]
    e.clock.advance(1.0)
    seen += [srv.queue.get_monitor("m1"), srv.monitor.tick(now=e.clock.now)]
    _refresh_engine(e)
    seen += [srv.queue.get_monitor("m1"), srv.queue.get_monitor("mp"),
             srv.monitor.tick(now=e.clock.now), srv.queue.get_monitor("m1"),
             _pump(e, srv, lambda ln: f"v2:{ln}\n")]
    _drain_epoch(srv)
    seen += [e.p.mfeed.marked_epochs(srv.queue.blobs, "m1"),
             srv.monitor.tick(now=e.clock.now)]
    return seen


def test_corpus_delta_fires_one_out_of_cadence_epoch(tmp_path, monkeypatch):
    seen = run_case(m_corpus_delta_fires_one_out_of_cadence_epoch, tmp_path,
                    monkeypatch)["seen"]
    assert seen[3] == 1 and seen[5] == 0
    assert seen[6]["next_fire_at"] == 0.0 and seen[7]["paused"] is True
    assert seen[8] == 1 and seen[9]["epoch"] == 2
    assert seen[9]["next_fire_at"] > seen[4]["next_fire_at"]
    assert seen[11:] == [[1, 2], 0]


def m_corpus_delta_kill9_between_notify_and_fire(e):
    srv = e.server(**MONITOR)
    seen = [e.norm(srv, _register(e, srv, "m1", ["a\n", "b\n"])), _fire_epoch(e, srv)]
    e.clock.advance(1.0)
    seen += [srv.monitor.on_corpus_delta("deadbeef"), srv.queue.get_monitor("m1")]
    srv2 = e.server(**MONITOR)
    seen += [srv2.queue.get_monitor("m1"), srv2.monitor.tick(now=e.clock.now),
             _pump(e, srv2, lambda ln: f"v2:{ln}\n")]
    _drain_epoch(srv2)
    seen += [e.p.mfeed.marked_epochs(srv2.queue.blobs, "m1"),
             srv2.monitor.tick(now=e.clock.now), srv2.queue.get_monitor("m1")]
    return seen


def test_corpus_delta_kill9_between_notify_and_fire(tmp_path, monkeypatch):
    seen = run_case(m_corpus_delta_kill9_between_notify_and_fire, tmp_path,
                    monkeypatch)["seen"]
    assert seen[1:3] == [1, 1] and seen[3]["next_fire_at"] == 0.0
    spec = seen[4]
    assert spec["next_fire_at"] == 0.0 and spec["epoch"] == 1 and not spec["refire"]
    assert seen[5] == 1 and seen[7:9] == [[1, 2], 0]
    assert seen[9]["next_fire_at"] > 0.0


# ---------------------------------------------------------------------------
# tests/test_gateway.py


GATEWAY = dict(gateway_tenant_rate=0.2, gateway_tenant_burst=2)


def _post_queue(e, srv, tenant=None, scan_id=None):
    headers = {"X-Swarm-Tenant": tenant} if tenant else {}
    return e.post(srv, "/queue", headers=headers, json={
        "module": "echo", "file_content": ["x\n"], "batch_size": 1, "scan_id": scan_id})


def g_rate_shed_429_with_retry_after(e):
    srv = e.server(**GATEWAY)
    seen = [e.norm(srv, _post_queue(e, srv, "noisy", f"noisy_{i}")) for i in range(4)]
    seen += [e.norm(srv, _post_queue(e, srv, "noisy", "noisy_9")),
             e.norm(srv, _post_queue(e, srv, "calm", "calm_1"))]
    return seen


def test_rate_shed_429_with_retry_after(tmp_path, monkeypatch):
    seen = run_case(g_rate_shed_429_with_retry_after, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen] == [200, 200, 429, 429, 429, 200]
    assert int(seen[4]["headers"]["Retry-After"]) >= 1
    assert seen[4]["body"]["reason"] == "rate" and seen[4]["body"]["retry_after_s"] > 0


def g_invalid_tenant_rejected(e):
    srv = e.server(**GATEWAY)
    return [e.norm(srv, _post_queue(e, srv, "../evil", "e_1"))]


def test_invalid_tenant_rejected(tmp_path, monkeypatch):
    [seen] = run_case(g_invalid_tenant_rejected, tmp_path, monkeypatch)["seen"]
    assert seen["code"] == 400


def g_malformed_submission_burns_no_rate_token(e):
    srv = e.server(**GATEWAY)
    seen = [e.norm(srv, e.post(srv, "/queue", headers={"X-Swarm-Tenant": "strict"},
                               json={"file_content": ["x\n"], "batch_size": 1}))
            for _ in range(5)]
    seen += [e.norm(srv, _post_queue(e, srv, "strict", "st_1")),
             e.norm(srv, _post_queue(e, srv, "strict", "st_2")),
             e.norm(srv, e.get(srv, "/tenants"))]
    return seen


def test_malformed_submission_burns_no_rate_token(tmp_path, monkeypatch):
    seen = run_case(g_malformed_submission_burns_no_rate_token, tmp_path,
                    monkeypatch)["seen"]
    assert [s["code"] for s in seen[:7]] == [400] * 5 + [200, 200]
    strict = seen[7]["body"]["tenants"]["strict"]
    assert strict["admitted"] == 2 and strict["shed"] == 0


def g_tenants_endpoint(e):
    srv = e.server(**GATEWAY)
    seen = [e.norm(srv, _post_queue(e, srv, "acme", "acme_5"))]
    seen += [e.norm(srv, _post_queue(e, srv, "noisy", f"nz_{i}")) for i in range(3)]
    seen.append(e.norm(srv, e.get(srv, "/tenants")))
    return seen


def test_tenants_endpoint(tmp_path, monkeypatch):
    """The route part of ``test_tenants_endpoint_and_cli`` (the CLI's
    rendering waits for the port's client)."""
    seen = run_case(g_tenants_endpoint, tmp_path, monkeypatch)["seen"]
    data = seen[-1]["body"]["tenants"]
    assert data["acme"]["admitted"] == 1 and data["acme"]["queue_depth"] == 1
    assert data["noisy"]["shed"] >= 1


def g_healthz_exposes_pressure_not_tenant_ids(e):
    srv = e.server(**GATEWAY)
    _post_queue(e, srv, "acme", "acme_6")
    return [e.norm(srv, e.get(srv, "/healthz", auth=False))]


def test_healthz_exposes_pressure_not_tenant_ids(tmp_path, monkeypatch):
    [seen] = run_case(g_healthz_exposes_pressure_not_tenant_ids, tmp_path,
                      monkeypatch)["seen"]
    hz = seen["body"]
    assert hz["pressure"] >= 0.0 and hz["tenant_count"] >= 2 and "tenants" not in hz


def g_gateway_metric_families_render(e):
    srv = e.server(**GATEWAY)

    def scrape() -> dict:
        by_name: dict = {}
        text = e.get(srv, "/metrics", auth=False).text
        for name, labels, value in e.p.metrics.parse_exposition(text):
            by_name.setdefault(name, []).append((labels, value))
        return by_name

    def admitted(by_name) -> dict:
        return {lb.get("tenant"): v for lb, v in by_name["swarm_gateway_admitted_total"]}

    def shed(by_name) -> float:
        return sum(v for lb, v in by_name["swarm_gateway_shed_total"]
                   if lb.get("tenant") == "noisy")

    before = scrape()
    _post_queue(e, srv, "acme", "acme_7")
    for i in range(4):
        _post_queue(e, srv, "noisy", f"nz2_{i}")
    after = scrape()
    # the counters are process-wide: what this script added
    return [{t: v - admitted(before).get(t, 0.0) for t, v in admitted(after).items()
             if v != admitted(before).get(t, 0.0)},
            shed(after) - shed(before),
            [n in after for n in ("swarm_gateway_pressure", "swarm_gateway_queued_by_tenant",
                                  "swarm_gateway_stream_bytes_total")]]


def test_gateway_metric_families_render(tmp_path, monkeypatch):
    out = run_case(g_gateway_metric_families_render, tmp_path, monkeypatch)
    admitted, shed, present = out["seen"]
    assert admitted == {"acme": 1.0, "noisy": 2.0} and shed == 2.0 and all(present)
    assert out["moved"][("swarm_gateway_shed_total",
                         (("reason", "rate"), ("tenant", "noisy")))] == 2


def g_saturation_reaches_admission_via_heartbeat_and_perf(e):
    srv = e.server(gateway_shed_pressure=0.9)
    post = lambda sid: e.post(srv, "/queue", headers={"X-Swarm-Tenant": "t"}, json={  # noqa: E731
        "module": "echo", "file_content": ["x\n"], "batch_size": 1, "scan_id": sid})
    seen = [e.norm(srv, post("sat_1"))]
    job = e.get(srv, "/get-job", params={"worker_id": "w1"}).json()
    seen.append(e.norm(srv, e.post(srv, f"/renew-lease/{job['job_id']}",
                                   json={"worker_id": "w1", "saturation": 0.95})))
    seen += [srv.gateway.fleet_saturation(), e.norm(srv, post("sat_2"))]
    seen.append(e.norm(srv, e.post(srv, f"/update-job/{job['job_id']}", json={
        "status": "complete", "worker_id": "w1",
        "perf": {"sched": {"wall_seconds": 10.0, "stall_seconds": 1.0}}})))
    seen += [srv.gateway.fleet_saturation(),
             e.norm(srv, e.post(srv, "/deregister", json={"worker_id": "w1"})),
             e.norm(srv, e.post(srv, "/deregister", json={})),
             srv.gateway.fleet_saturation()]
    return seen


def test_saturation_reaches_admission_via_heartbeat_and_perf(tmp_path, monkeypatch):
    seen = run_case(g_saturation_reaches_admission_via_heartbeat_and_perf, tmp_path,
                    monkeypatch)["seen"]
    assert seen[0]["code"] == 200 and seen[2] == pytest.approx(0.95)
    assert seen[3]["code"] == 429 and seen[3]["body"]["reason"] == "pressure"
    assert seen[5] == pytest.approx(0.1)
    assert [seen[6]["code"], seen[7]["code"], seen[8]] == [200, 400, 0.0]


def g_autoscale_route(e):
    srv = e.server(**GATEWAY)
    _post_queue(e, srv, "acme", "auto_3")
    return [e.norm(srv, e.get(srv, "/autoscale")),
            e.norm(srv, e.get(srv, "/autoscale", params={"prefix": "gpu"})),
            e.norm(srv, e.post(srv, "/autoscale", json={"prefix": "n"})),
            e.norm(srv, e.post(srv, "/autoscale", data=b"{oops")),
            e.norm(srv, e.get(srv, "/healthz", auth=False))["body"]["autoscale"]]


def test_autoscale_route(tmp_path, monkeypatch):
    out = run_case(g_autoscale_route, tmp_path, monkeypatch)
    rec, gpu, applied, bad, status = out["seen"]
    assert rec["body"]["dry_run"] and rec["body"]["queue_depth"] >= 1
    assert gpu["body"]["prefix"] == "gpu"
    assert applied["body"]["dry_run"] and "applied" not in applied["body"]
    assert bad["code"] == 400 and status["prefix"] == "n"


def g_drain_route_and_generation_header(e):
    """``POST /drain/<worker>``: the next poll of that worker carries
    ``X-Swarm-Drain``; a second drain is a 409."""
    srv = e.server()
    return [e.norm(srv, e.post(srv, "/drain/w9", json={"reason": "maintenance"})),
            e.norm(srv, e.post(srv, "/drain/w9", json={})),
            e.norm(srv, e.get(srv, "/get-job", params={"worker_id": "w9"})),
            e.norm(srv, e.get(srv, "/get-job", params={"worker_id": "w8"})),
            e.norm(srv, e.get(srv, "/dead-letter")),
            e.norm(srv, e.post(srv, "/requeue-job/none_0")),
            e.norm(srv, e.post(srv, "/renew-lease/none_0", json={"worker_id": "w9"})),
            e.norm(srv, e.post(srv, "/renew-lease/none_0", data=b"{oops"))]


def test_drain_route_and_generation_header(tmp_path, monkeypatch):
    seen = run_case(g_drain_route_and_generation_header, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen] == [200, 409, 204, 204, 200, 404, 409, 400]
    assert seen[2]["headers"]["X-Swarm-Drain"] == "maintenance"
    assert "X-Swarm-Drain" not in seen[3]["headers"]


# ---------------------------------------------------------------------------
# tests/test_qos.py


QOS = dict(cache_backend="memory")


def _post_qos(e, srv, lines, scan_id, qos=None, batch=1):
    headers = {"X-Swarm-QoS": qos} if qos else {}
    return e.post(srv, "/queue", headers=headers, json={
        "module": "echo", "file_content": lines, "batch_size": batch, "scan_id": scan_id,
        "chunk_index": 0})


def _drain_one(e, srv, worker_id="w1", output=b"out\n"):
    job = e.get(srv, "/get-job", params={"worker_id": worker_id}).json()
    e.post(srv, f"/put-output-chunk/{job['scan_id']}/{job['chunk_index']}", data=output)
    e.post(srv, f"/update-job/{job['job_id']}",
           json={"status": "complete", "worker_id": worker_id})
    return job


def q_invalid_qos_header_rejected(e):
    srv = e.server(**QOS)
    return [e.norm(srv, _post_qos(e, srv, ["x\n"], "bad_1", qos="turbo"))]


def test_invalid_qos_header_rejected(tmp_path, monkeypatch):
    [seen] = run_case(q_invalid_qos_header_rejected, tmp_path, monkeypatch)["seen"]
    assert seen["code"] == 400 and "QoS" in seen["body"]


def q_gateway_cache_short_circuit_zero_dispatch(e):
    srv = e.server(**QOS)
    seen = [e.norm(srv, _post_qos(e, srv, ["tgt\n"], "probe_1", qos="interactive")),
            _drain_one(e, srv, output=b"tgt [found]\n")]
    dispatches = []
    orig = srv.queue.next_job

    def spy(worker_id):
        dispatches.append(worker_id)
        return orig(worker_id)

    srv.queue.next_job = spy
    try:
        seen.append(e.norm(srv, _post_qos(e, srv, ["tgt\n"], "probe_2", qos="interactive")))
    finally:
        srv.queue.next_job = orig
    seen += [dispatches, e.norm(srv, e.get(srv, "/raw/probe_2")),
             srv.queue.job_record("probe_2_0"), srv.queue.state.llen("completed")]
    return seen


def test_gateway_cache_short_circuit_zero_dispatch(tmp_path, monkeypatch):
    out = run_case(q_gateway_cache_short_circuit_zero_dispatch, tmp_path, monkeypatch)
    seen = out["seen"]
    assert seen[2]["code"] == 200 and seen[3] == []
    assert seen[4]["body"] == "tgt [found]\n"
    rec = seen[5]
    assert rec["status"] == "complete" and rec["attempts"] == 0
    assert rec["worker_id"] is None and rec["qos"] == "interactive" and seen[6] == 2
    assert out["moved"][("swarm_gateway_cache_short_circuit_total",
                         (("outcome", "hit"),))] == 1


def q_bulk_submission_never_short_circuits(e):
    srv = e.server(**QOS)
    seen = [e.norm(srv, _post_qos(e, srv, ["b\n"], "bk_1", qos="interactive")),
            _drain_one(e, srv, output=b"b [found]\n"),
            e.norm(srv, _post_qos(e, srv, ["b\n"], "bk_2"))]
    return seen + [srv.queue.job_record("bk_2_0")]


def test_bulk_submission_never_short_circuits(tmp_path, monkeypatch):
    seen = run_case(q_bulk_submission_never_short_circuits, tmp_path, monkeypatch)["seen"]
    assert seen[2]["code"] == 200 and seen[3]["status"] == "queued"


def q_short_circuit_invalidated_by_epoch_bump(e):
    srv = e.server(**QOS)
    seen = [e.norm(srv, _post_qos(e, srv, ["e\n"], "ep_1", qos="interactive")),
            _drain_one(e, srv, output=b"e [found]\n")]
    srv.qos_cache._tier.bump_epoch()
    srv.qos_cache._epoch = None
    seen.append(e.norm(srv, _post_qos(e, srv, ["e\n"], "ep_2", qos="interactive")))
    return seen + [srv.queue.job_record("ep_2_0")]


def test_short_circuit_invalidated_by_epoch_bump(tmp_path, monkeypatch):
    seen = run_case(q_short_circuit_invalidated_by_epoch_bump, tmp_path, monkeypatch)["seen"]
    assert seen[2]["code"] == 200 and seen[3]["status"] == "queued"


def q_latency_histogram_observes_by_class(e):
    srv = e.server(**QOS)
    latency = e.p.metrics.REGISTRY.get("swarm_gateway_latency_seconds")

    def count(qos):
        return latency.labels(qos=qos).value["count"]

    b0, i0 = count("bulk"), count("interactive")
    _post_qos(e, srv, ["lat\n"], "latb_1")
    _drain_one(e, srv, output=b"x\n")
    seen = [count("bulk") - b0]
    _post_qos(e, srv, ["lat2\n"], "lati_1", qos="interactive")
    _drain_one(e, srv, output=b"y\n")
    return seen + [count("interactive") - i0]


def test_latency_histogram_observes_by_class(tmp_path, monkeypatch):
    seen = run_case(q_latency_histogram_observes_by_class, tmp_path, monkeypatch)["seen"]
    assert seen == [1, 1]


# ---------------------------------------------------------------------------
# tests/test_trace_waterfall.py (the cases without a worker)


def w_short_circuit_scan_gets_waterfall(e):
    e.p.tracing.set_enabled(True)
    srv = e.server(cache_backend="memory")
    seen = [e.norm(srv, _post_qos(e, srv, ["tgt\n"], "probe_1", qos="interactive")),
            _drain_one(e, srv, output=b"tgt [found]\n")]
    e.clock.advance(0.25)
    seen += [e.norm(srv, _post_qos(e, srv, ["tgt\n"], "probe_2", qos="interactive")),
             srv.queue.job_record("probe_2_0")["status"],
             e.norm(srv, e.get(srv, "/trace/probe_2")),
             e.norm(srv, e.get(srv, "/trace/probe_1")),
             e.norm(srv, e.get(srv, "/trace/bad$id")),
             e.norm(srv, e.get(srv, "/trace/never_1"))]
    return seen


def test_short_circuit_scan_gets_waterfall(tmp_path, monkeypatch):
    seen = run_case(w_short_circuit_scan_gets_waterfall, tmp_path, monkeypatch)["seen"]
    from swarm_tpu_torch.telemetry.tracing import waterfall_orphans

    assert seen[3] == "complete" and seen[4]["code"] == 200
    doc = seen[4]["body"]
    assert doc["status"] == "short_circuit"
    assert {"admission", "cache.lookup", "completion"} <= {s["name"] for s in doc["spans"]}
    assert waterfall_orphans(doc) == []
    assert seen[5]["code"] == 200 and [seen[6]["code"], seen[7]["code"]] == [400, 404]


def w_post_spans_route(e):
    e.p.tracing.set_enabled(True)
    srv = e.server()
    seen = [e.norm(srv, _post_qos(e, srv, ["a\n"], "sp_1"))]
    tid = "cc" * 8
    mk = e.p.tracing.make_span
    seen.append(e.norm(srv, e.post(srv, "/spans", json={
        "scan_id": "sp_1", "spans": [mk("host.extra", tid, e.clock.now, 0.002)]})))
    seen.append(e.norm(srv, e.post(srv, "/spans", json={
        "scan_id": "nope_1", "spans": [mk("x", tid, e.clock.now, 0.001)]})))
    for bad in ({"spans": []}, {"scan_id": "sp_1"}, {"scan_id": "sp_1", "spans": "x"}):
        seen.append(e.norm(srv, e.post(srv, "/spans", json=bad)))
    seen.append(e.norm(srv, e.post(srv, "/spans", data=b"{not json")))
    seen.append(e.norm(srv, e.get(srv, "/trace/sp_1")))
    return seen


def test_post_spans_route(tmp_path, monkeypatch):
    seen = run_case(w_post_spans_route, tmp_path, monkeypatch)["seen"]
    assert seen[1]["body"] == {"added": 1} and seen[2]["body"] == {"added": 0}
    assert [s["code"] for s in seen[3:7]] == [400] * 4
    assert seen[7]["code"] == 200 and seen[7]["body"]["status"] != "complete"
