"""The port's REST server (``swarm_tpu_torch/server/app.py``) against the
JAX package's (``swarm_tpu/server/app.py``), on the CPU.

- the module is a copy: its code is the reference's with the package
  name changed, docstrings and comments aside, and its ``swarm_http_*``
  and scrape-time families are the reference's;
- each case is a script of a reference test file over one package's
  ``SwarmServer``, driven over real HTTP (``requests``) and through the
  server's own objects where the reference's test does so. It runs once
  on each package, each server on roots of its own under ``tmp_path``,
  both under one patched clock (the ``time`` that the server, queue,
  data model, tracing, tier and monitor modules read: it moves only
  when the script moves it, where the reference's tests sleep) and one
  sequence of uuids (trace, span and monitor ids), each with its own
  flight recorder, breaker board, scrape-time collectors and memory
  tier, and the compared families at 0. Then
  - what the script saw — status codes, the JSON or text bodies with
    the bound port written as ``PORT``, the ``X-Swarm-*``, ``Retry-After``
    and content-type headers, ``/raw`` and ``/stream`` bytes — is equal;
  - the last server's state store holds the same hashes and lists, its
    blob store the same keys with the same bytes (chunks, journal,
    flight dumps, trace waterfalls, monitor feeds), its doc store the
    same files;
  - the samples of the server's families (``swarm_http_*``,
    ``swarm_queue_*``, ``swarm_jobs_by_state``, ``swarm_gateway_*``,
    ``swarm_fleet_*``, ``swarm_monitor_*``, ``swarm_journal_*``,
    ``swarm_trace_*``) moved alike, and their gauges that are not 0
    read alike.

The scripts are all 20 cases of ``tests/test_server_api.py``. The other
reference files' server cases are in ``tests/test_torch_server_cases.py``.

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import dataclasses
import json
import os
import re
import threading
import time
import urllib.request
import uuid
from pathlib import Path
from types import SimpleNamespace

import pytest
import requests
import torch

import swarm_tpu.cache.tier as j_tier
import swarm_tpu.client.cli as j_cli
import swarm_tpu.config as j_config
import swarm_tpu.datamodel as j_dm
import swarm_tpu.gateway.qos as j_qos
import swarm_tpu.monitor.diff as j_mdiff
import swarm_tpu.monitor.feed as j_mfeed
import swarm_tpu.monitor.spec as j_mspec
import swarm_tpu.resilience.breaker as j_breaker
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.server.app as j_app
import swarm_tpu.server.fleet as j_fleet
import swarm_tpu.server.queue as j_queue
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu.telemetry.tracing as j_tracing
import swarm_tpu_torch.cache.tier as t_tier
import swarm_tpu_torch.client.cli as t_cli
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.datamodel as t_dm
import swarm_tpu_torch.gateway.qos as t_qos
import swarm_tpu_torch.monitor.diff as t_mdiff
import swarm_tpu_torch.monitor.feed as t_mfeed
import swarm_tpu_torch.monitor.spec as t_mspec
import swarm_tpu_torch.resilience.breaker as t_breaker
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.server.app as t_app
import swarm_tpu_torch.server.fleet as t_fleet
import swarm_tpu_torch.server.queue as t_queue
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics
import swarm_tpu_torch.telemetry.tracing as t_tracing

from test_server_api import _ipv6_loopback_available
from test_torch_fleet import _moved, stripped, zeroed_families

PKG = {
    "jax": SimpleNamespace(name="jax", app=j_app, config=j_config, dm=j_dm, fleet=j_fleet,
                           queue=j_queue, stores=j_stores, metrics=j_metrics,
                           tracing=j_tracing, faults=j_faults, qos=j_qos, tier=j_tier,
                           mfeed=j_mfeed, mdiff=j_mdiff, mspec=j_mspec, breaker=j_breaker,
                           cli=j_cli, worker_pkg="swarm_tpu"),
    "torch": SimpleNamespace(name="torch", app=t_app, config=t_config, dm=t_dm,
                             fleet=t_fleet, queue=t_queue, stores=t_stores,
                             metrics=t_metrics, tracing=t_tracing, faults=t_faults,
                             qos=t_qos, tier=t_tier, mfeed=t_mfeed, mdiff=t_mdiff,
                             mspec=t_mspec, breaker=t_breaker, cli=t_cli,
                             worker_pkg="swarm_tpu_torch"),
}
SIDES = ("jax", "torch")
KEY = "testkey"
AUTH = {"Authorization": f"Bearer {KEY}"}
#: the metric families whose samples must move alike
FAMILIES = ("swarm_http_", "swarm_queue_", "swarm_jobs_by_state", "swarm_gateway_",
            "swarm_fleet_", "swarm_monitor_", "swarm_journal_", "swarm_trace_",
            "swarm_server_uptime_seconds", "swarm_job_phase_seconds")
#: the response headers a script sees
HEADERS = ("Content-Type", "X-Swarm-Generation", "X-Swarm-Drain", "Retry-After",
           "Transfer-Encoding")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines of both packages that walk
    inline (``SWARM_WALK_THREADS=1``): six test processes share the
    host, and no result depends on either. The other server test files
    import it."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


# ---------------------------------------------------------------------------
# the copy


def test_app_is_a_copy_of_the_reference():
    with open(j_app.__file__) as f, open(t_app.__file__) as g:
        assert stripped(g.read()) == stripped(f.read())


def test_app_families_are_the_reference_families():
    handles = [n for n, v in vars(j_app).items() if isinstance(v, j_metrics._Metric)]
    assert sorted(handles) == ["GATEWAY_LATENCY", "GATEWAY_QUEUED", "GATEWAY_SHORT_CIRCUIT",
                               "_HTTP_LATENCY", "_HTTP_REQUESTS", "_JOBS_BY_STATE",
                               "_QUEUE_DEPTH", "_UPTIME"]
    for n in handles:
        a, b = getattr(j_app, n), getattr(t_app, n)
        assert (a.name, a.kind, a.help, a.labelnames, getattr(a, "buckets", None)) == (
            b.name, b.kind, b.help, b.labelnames, getattr(b, "buckets", None))
    assert t_app.SwarmServer.UNAUTHENTICATED == j_app.SwarmServer.UNAUTHENTICATED


# ---------------------------------------------------------------------------
# the harness


class FakeTime:
    """The ``time`` module as the server's modules see it: ``time()``,
    ``monotonic()`` and ``perf_counter()`` read a clock that moves only
    by :meth:`advance`; everything else (``sleep``) is the real one."""

    def __init__(self, t0: float):
        self.now = t0

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def __getattr__(self, name):
        return getattr(time, name)


class Uuids:
    """``uuid.uuid4`` as a counter: the same ids in the same order."""

    def __init__(self):
        self.n = 0
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            self.n += 1
            return uuid.UUID(int=(self.n << 64) | 0x5EED)


class Env:
    """What a script gets: its package ``p``, the clock, its roots, a
    factory of servers (each kept, and shut down after the script; the
    last one's stores are compared) and HTTP helpers that record what
    they saw."""

    def __init__(self, side: str, root: Path, clock: FakeTime):
        self.side = side
        self.p = PKG[side]
        self.root = root
        self.clock = clock
        self.servers: list = []
        self.extra_shutdown: list = []

    def config(self, sub: str = "", **kw):
        kw.setdefault("host", "127.0.0.1")
        kw.setdefault("port", 0)
        kw.setdefault("api_key", KEY)
        kw.setdefault("blob_root", str(self.root / f"blobs{sub}"))
        kw.setdefault("doc_root", str(self.root / f"docs{sub}"))
        return self.p.config.Config(**kw)

    def server(self, start: bool = True, cfg=None, sub: str = "", fleet=None, **kw):
        srv = self.p.app.SwarmServer(cfg if cfg is not None else self.config(sub, **kw),
                                     fleet=fleet)
        if srv.monitor is not None and isinstance(self.clock, FakeTime):
            srv.monitor._clock = self.clock.time  # its default is bound at import
        self.servers.append(srv)
        if start:
            srv.start_background()
        return srv

    def worker(self, cfg, **kw):
        """The package's own worker for the server of ``cfg`` (the
        reference's ``Config(**{**cfg.__dict__, ...})``); the port's on
        the CPU, its ``WorkerConfig`` taking the fields it has."""
        fields = {**cfg.__dict__, **kw}
        if self.side == "jax":
            from swarm_tpu.worker.runtime import JobProcessor

            return JobProcessor(self.p.config.Config(**fields))
        from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

        names = {f.name for f in dataclasses.fields(WorkerConfig)}
        return JobProcessor(WorkerConfig(**{k: v for k, v in fields.items() if k in names}),
                            device="cpu")

    @staticmethod
    def base(srv) -> str:
        return f"http://127.0.0.1:{srv.port}"

    def norm(self, srv, resp) -> dict:
        """A response as compared: the code, the named headers, the body
        (JSON parsed) with the bound port written as ``PORT``."""
        text = resp.content.decode("utf-8", "replace")
        if srv is not None and srv._httpd is not None:
            text = text.replace(f":{srv.port}", ":PORT")
        body = text
        if resp.headers.get("Content-Type", "").startswith("application/json") and text:
            body = json.loads(text)
        return {"code": resp.status_code, "body": body,
                "headers": {h: resp.headers.get(h) for h in HEADERS if h in resp.headers}}

    def get(self, srv, path: str, auth: bool = True, **kw):
        kw.setdefault("headers", AUTH if auth else {})
        kw.setdefault("timeout", 30)
        return requests.get(self.base(srv) + path, **kw)

    def post(self, srv, path: str, auth: bool = True, **kw):
        headers = kw.pop("headers", None)
        kw["headers"] = {**(AUTH if auth else {}), **(headers or {})}
        kw.setdefault("timeout", 30)
        return requests.post(self.base(srv) + path, **kw)


def state_dump(state) -> dict:
    return {"hashes": {n: dict(h) for n, h in state._hashes.items() if h},
            "lists": {n: list(q) for n, q in state._lists.items() if q}}


def blob_dump(blobs) -> dict:
    return {key: blobs.get(key) for key in blobs.list("")}


def tree_dump(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _samples(metrics) -> dict:
    both = set(j_metrics.REGISTRY._metrics) & set(t_metrics.REGISTRY._metrics)
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in metrics.parse_exposition(metrics.REGISTRY.render())
            if name.startswith(FAMILIES) and re.sub(r"_(bucket|sum|count)$", "", name) in both}


#: the modules whose ``time`` the clock replaces
CLOCKED = ("app", "queue", "dm", "tracing", "tier", "mspec")


def run_side(case, side: str, root: Path, t0: float, monkeypatch, clocked: bool = True) -> dict:
    env = Env(side, root, FakeTime(t0) if clocked else time)
    p = env.p
    # the compared families, the flight ring, the breaker board, the
    # scrape-time collectors and the memory tier are process-wide: each
    # side starts them afresh, so what other tests of this process left there (last
    # values, records, open breakers, live servers, cache entries) is
    # not compared
    with monkeypatch.context() as mp, zeroed_families(p.metrics, FAMILIES):
        for mod in CLOCKED if clocked else ():
            mp.setattr(getattr(p, mod), "time", env.clock)
        mp.setattr(uuid, "uuid4", Uuids())
        mp.setattr(p.tracing, "FLIGHT", p.tracing.FlightRecorder())
        mp.setattr(p.breaker, "_BOARD", {})
        mp.setattr(p.metrics.REGISTRY, "_collectors", [])
        mp.setattr(p.tier, "_MEMORY_TIER", None)  # a fresh memory tier
        p.faults.clear_plan()
        saved_tracing = p.tracing._override
        before = _samples(p.metrics)
        try:
            seen = case(env)
            last = env.servers[-1] if env.servers else None
            # a flight dump reaches its blob sink on a thread of its own
            for t in threading.enumerate():
                if t.name == "flight-dump":
                    t.join(timeout=10)
            moved = _moved(p.metrics, before, _samples(p.metrics))
            stores = {}
            if last is not None:
                stores = {"state": state_dump(last.queue.state),
                          "blobs": blob_dump(last.queue.blobs),
                          "docs": tree_dump(last.cfg.doc_root)}
        finally:
            for fn in env.extra_shutdown:
                fn()
            for srv in env.servers:
                try:
                    srv.shutdown()
                except Exception:
                    pass
            p.faults.clear_plan()
            p.tracing.set_enabled(saved_tracing)
    return {"seen": seen, "moved": moved, **stores}


def run_case(case, tmp_path, monkeypatch, compare=("seen", "state", "blobs", "docs",
                                                   "moved"), clocked: bool = True) -> dict:
    """``case(env)`` on each package → the port's side, after every key
    of ``compare`` was found equal. ``clocked=False`` leaves the real
    clock (scripts with real workers, whose perf fields are real
    seconds: they compare what they saw, not the stores)."""
    t0 = float(int(time.time()))
    out = {side: run_side(case, side, tmp_path / side, t0, monkeypatch, clocked)
           for side in SIDES}
    for key in compare:
        assert out["torch"].get(key) == out["jax"].get(key), key
    return out["torch"]


# ---------------------------------------------------------------------------
# tests/test_server_api.py


def _queue_scan(e, srv, lines=30, batch=10, module="echo"):
    return e.post(srv, "/queue", json={
        "module": module, "file_content": [f"10.0.0.{i}\n" for i in range(lines)],
        "batch_size": batch, "scan_id": None, "chunk_index": 0})


def s_auth_required(e):
    srv = e.server(lease_seconds=30)
    return [e.norm(srv, e.get(srv, "/get-statuses", auth=False)),
            e.norm(srv, e.get(srv, "/get-statuses", headers={"Authorization": "Bearer wrong"})),
            e.norm(srv, e.get(srv, "/get-statuses", headers={"Authorization": "Basic x"})),
            e.get(srv, "/healthz", auth=False).status_code,
            e.get(srv, "/metrics", auth=False).status_code]


def test_auth_required(tmp_path, monkeypatch):
    seen = run_case(s_auth_required, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen[:3]] + seen[3:] == [401, 401, 401, 200, 200]
    assert seen[1]["body"] == {"message": "Unauthorized"}


def s_healthz_reports_real_liveness(e):
    srv = e.server(lease_seconds=30)
    seen = [e.norm(srv, e.get(srv, "/healthz", auth=False))]
    _queue_scan(e, srv)
    e.get(srv, "/get-job", params={"worker_id": "hw"})
    e.clock.advance(2.5)
    seen.append(e.norm(srv, e.get(srv, "/healthz", auth=False)))
    return seen


def test_healthz_reports_real_liveness(tmp_path, monkeypatch):
    seen = run_case(s_healthz_reports_real_liveness, tmp_path, monkeypatch)["seen"]
    first, second = (s["body"] for s in seen)
    assert first["status"] == "ok" and first["queue_depth"] == 0
    assert first["jobs_by_state"] == {} and first["uptime_seconds"] == 0.0
    assert second["queue_depth"] == 2 and second["uptime_seconds"] == 2.5
    assert second["jobs_by_state"] == {"queued": 2, "in progress": 1}


def s_metrics_exposition_covers_families(e):
    srv = e.server(lease_seconds=30)
    _queue_scan(e, srv)
    e.get(srv, "/get-job", params={"worker_id": "mw"})
    resp = e.get(srv, "/metrics", auth=False)
    samples = e.p.metrics.parse_exposition(resp.text)
    names = {name for name, _l, _v in samples}
    by_key = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
    return [resp.status_code, resp.headers["Content-Type"],
            sorted(n for n in names if n.startswith(("swarm_http_", "swarm_queue_depth",
                                                     "swarm_server_", "swarm_jobs_")))
            and [f in names for f in (
                "swarm_server_uptime_seconds", "swarm_queue_depth",
                "swarm_http_requests_total", "swarm_http_request_seconds_bucket",
                "swarm_http_request_seconds_sum", "swarm_queue_jobs_queued_total",
                "swarm_queue_jobs_dispatched_total", "swarm_events_total",
                "swarm_fleet_nodes", "swarm_fleet_coldstart_seconds_bucket")],
            by_key[("swarm_queue_depth", ())],
            by_key[("swarm_jobs_by_state", (("status", "in progress"),))]]


def test_metrics_exposition_covers_families(tmp_path, monkeypatch):
    seen = run_case(s_metrics_exposition_covers_families, tmp_path, monkeypatch)["seen"]
    assert seen[0] == 200 and seen[1].startswith("text/plain")
    assert all(seen[2]) and seen[3:] == [2, 1]


def s_queue_honors_trace_header(e):
    srv = e.server(lease_seconds=30)
    r = e.post(srv, "/queue", json={"module": "echo", "file_content": ["t\n"],
                                    "batch_size": 1},
               headers={"X-Swarm-Trace": "feedface" * 4})
    return [e.norm(srv, r), e.norm(srv, e.get(srv, "/get-statuses")),
            e.norm(srv, e.get(srv, "/get-job", params={"worker_id": "tw"}))]


def test_queue_honors_trace_header(tmp_path, monkeypatch):
    seen = run_case(s_queue_honors_trace_header, tmp_path, monkeypatch)["seen"]
    [job] = seen[1]["body"]["jobs"].values()
    assert job["trace_id"] == "feedface" * 4
    assert seen[2]["body"]["trace_id"] == "feedface" * 4


def s_nonfinite_perf_does_not_poison_metrics(e):
    srv = e.server(lease_seconds=30)
    _queue_scan(e, srv, lines=1, batch=1)
    job = e.get(srv, "/get-job", params={"worker_id": "evil"}).json()
    r = e.post(srv, f"/update-job/{job['job_id']}",
               data='{"status": "complete", "perf": {"rows": Infinity, '
                    '"execute_s": NaN, "download_s": 0.5}}',
               headers={"Content-Type": "application/json"})
    snap = e.p.metrics.REGISTRY.snapshot()
    rows_total = snap["swarm_queue_rows_processed_total"]["samples"][0]["value"]
    sums = [s["value"]["sum"] for s in snap["swarm_job_phase_seconds"]["samples"]]
    return [e.norm(srv, r), rows_total != float("inf"), all(x == x for x in sums)]


def test_nonfinite_perf_does_not_poison_metrics(tmp_path, monkeypatch):
    out = run_case(s_nonfinite_perf_does_not_poison_metrics, tmp_path, monkeypatch)
    assert out["seen"][0]["code"] == 200 and out["seen"][1:] == [True, True]
    assert out["moved"][("swarm_job_phase_seconds_count", (("phase", "download"),))] == 1


def s_queue_mints_trace_when_header_absent(e):
    srv = e.server(lease_seconds=30)
    _queue_scan(e, srv, lines=1, batch=1)
    return [e.norm(srv, e.get(srv, "/get-statuses"))]


def test_queue_mints_trace_when_header_absent(tmp_path, monkeypatch):
    seen = run_case(s_queue_mints_trace_when_header_absent, tmp_path, monkeypatch)["seen"]
    [job] = seen[0]["body"]["jobs"].values()
    assert job["trace_id"] and len(job["trace_id"]) == 32


def s_queue_and_dispatch_cycle(e):
    srv = e.server(lease_seconds=30)
    seen = [e.norm(srv, _queue_scan(e, srv))]
    job = e.get(srv, "/get-job", params={"worker_id": "w1"})
    seen.append(e.norm(srv, job))
    scan_id = job.json()["scan_id"]
    seen.append(e.norm(srv, e.get(srv, f"/get-input-chunk/{scan_id}/0")))
    for status in ("starting", "downloading", "executing", "uploading"):
        e.clock.advance(0.1)
        seen.append(e.norm(srv, e.post(srv, f"/update-job/{scan_id}_0",
                                       json={"status": status})))
    seen.append(e.norm(srv, e.post(srv, f"/put-output-chunk/{scan_id}/0",
                                   data=b"result for chunk 0\n")))
    seen.append(e.norm(srv, e.post(srv, f"/update-job/{scan_id}_0",
                                   json={"status": "complete"})))
    for path in ("/get-statuses", "/get-latest-chunk", f"/get-chunk/{scan_id}/0",
                 "/get-latest-chunk", f"/raw/{scan_id}", f"/parse_job/{scan_id}_0"):
        seen.append(e.norm(srv, e.get(srv, path)))
    return seen


def test_queue_and_dispatch_cycle(tmp_path, monkeypatch):
    out = run_case(s_queue_and_dispatch_cycle, tmp_path, monkeypatch)
    seen = out["seen"]
    assert seen[0]["body"] == "Job queued successfully"
    assert seen[1]["body"]["status"] == "in progress" and seen[1]["body"]["worker_id"] == "w1"
    assert seen[2]["body"].splitlines()[0] == "10.0.0.0"
    scan_id = seen[1]["body"]["scan_id"]
    statuses = seen[9]["body"]
    assert statuses["jobs"][f"{scan_id}_0"]["status"] == "complete"
    assert statuses["scans"][0]["chunks_complete"] == 1
    assert seen[10]["body"] == f"{scan_id}_0"
    assert seen[11]["body"] == {"contents": "result for chunk 0\n"}
    assert seen[12]["code"] == 204 and seen[13]["body"] == "result for chunk 0\n"
    assert seen[14]["code"] == 200 and out["docs"]


def s_unknown_job_404(e):
    srv = e.server(lease_seconds=30)
    return [e.norm(srv, e.post(srv, "/update-job/nope_1", json={"status": "x"})),
            e.norm(srv, e.get(srv, "/get-chunk/nope/0")),
            e.norm(srv, e.get(srv, "/no-such-route")),
            e.norm(srv, e.post(srv, "/update-job/nope_1", data=b"{not json"))]


def test_unknown_job_404(tmp_path, monkeypatch):
    seen = run_case(s_unknown_job_404, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen] == [404, 404, 404, 400]


def s_empty_queue_204(e):
    srv = e.server(lease_seconds=30)
    r = e.get(srv, "/get-job", params={"worker_id": "idle1"})
    return [e.norm(srv, r), r.content]


def test_empty_queue_204(tmp_path, monkeypatch):
    seen = run_case(s_empty_queue_204, tmp_path, monkeypatch)["seen"]
    assert seen[0]["code"] == 204 and seen[1] == b""
    assert seen[0]["headers"]["X-Swarm-Generation"] == "1"


def s_queue_requires_module(e):
    srv = e.server(lease_seconds=30)
    return [e.norm(srv, e.post(srv, "/queue", json={"file_content": ["a\n"],
                                                    "batch_size": 1})),
            e.norm(srv, e.post(srv, "/queue", data=b"{bad json"))]


def test_queue_requires_module(tmp_path, monkeypatch):
    seen = run_case(s_queue_requires_module, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen] == [400, 400]


def s_spin_up_down_validation(e):
    srv = e.server(lease_seconds=30)
    return [e.norm(srv, e.post(srv, "/spin-up", json={})),
            e.norm(srv, e.post(srv, "/spin-up", json={"prefix": "x", "nodes": 2})),
            e.norm(srv, e.post(srv, "/spin-down", json={})),
            e.norm(srv, e.post(srv, "/spin-down", json={"prefix": "x"})),
            type(srv.fleet).__name__]


def test_spin_up_down_validation(tmp_path, monkeypatch):
    seen = run_case(s_spin_up_down_validation, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen[:4]] == [400, 202, 400, 202]
    assert seen[4] == "NullProvider"


def s_reset(e):
    srv = e.server(lease_seconds=30)
    _queue_scan(e, srv)
    return [e.norm(srv, e.post(srv, "/reset")), e.norm(srv, e.get(srv, "/get-statuses"))]


def test_reset(tmp_path, monkeypatch):
    seen = run_case(s_reset, tmp_path, monkeypatch)["seen"]
    assert seen[0]["body"]["message"] == "Redis database reset"
    assert seen[1]["body"]["jobs"] == {}


def s_lease_requeue(e):
    srv = e.server(start=False, api_key="k", lease_seconds=0.2, max_attempts=3)
    q = srv.queue
    q.queue_scan({"module": "echo", "file_content": ["t1\n"], "batch_size": 1})
    job = q.next_job("dying-worker")
    seen = [job, q.next_job("other")]
    e.clock.advance(0.25)
    seen.append(q.next_job("healthy-worker"))
    e.clock.advance(0.25)
    seen.append(q.next_job("w3"))
    e.clock.advance(0.25)
    seen.append(q.next_job("w4"))
    seen.append(json.loads(q.state.hget("jobs", job["job_id"])))
    seen.append(q.requeue_dead_letter(job["job_id"]))
    seen.append(q.next_job("w5"))
    seen.append(q.update_job(job["job_id"], {"status": "complete", "worker_id": "w5"}))
    return seen


def test_lease_requeue(tmp_path, monkeypatch):
    seen = run_case(s_lease_requeue, tmp_path, monkeypatch)["seen"]
    job, other, rejob, third, fourth, raw, requeued, redo, done = seen
    assert job["status"] == "in progress" and other is None
    assert rejob["job_id"] == job["job_id"] and rejob["attempts"] == 2
    assert third is not None and fourth is None
    assert raw["status"] == "dead letter" and len(raw["failure_history"]) == 3
    assert requeued and redo["attempts"] == 1 and done


def s_204_keepalive_connection_reuse(e):
    srv = e.server(lease_seconds=30)
    s = requests.Session()
    s.headers.update(AUTH)
    seen = []
    for _ in range(3):
        r = s.get(e.base(srv) + "/get-job", params={"worker_id": "idle-ka"}, timeout=30)
        seen.append((r.status_code, r.content))
    seen.append(s.get(e.base(srv) + "/get-statuses", timeout=30).status_code)
    s.close()
    return seen


def test_204_keepalive_connection_reuse(tmp_path, monkeypatch):
    seen = run_case(s_204_keepalive_connection_reuse, tmp_path, monkeypatch)["seen"]
    assert seen == [(204, b"")] * 3 + [200]


def s_queue_rejects_hostile_scan_id(e):
    srv = e.server(lease_seconds=30)
    seen = [e.norm(srv, e.post(srv, "/queue", json={
        "module": "echo", "file_content": ["t\n"], "batch_size": 1, "scan_id": bad}))
        for bad in ("x$(touch /tmp/pwn)", "../escape", "a b", "x;y", "🦊")]
    seen.append(e.norm(srv, e.post(srv, "/queue", json={
        "module": "e$(x)", "file_content": ["t\n"], "batch_size": 1})))
    return seen


def test_queue_rejects_hostile_scan_id(tmp_path, monkeypatch):
    seen = run_case(s_queue_rejects_hostile_scan_id, tmp_path, monkeypatch)["seen"]
    assert [s["code"] for s in seen] == [400] * 6


def s_update_job_fencing_and_terminal_no_regress(e):
    q = e.server(start=False, api_key="k", lease_seconds=0.15, max_attempts=5).queue
    q.queue_scan({"module": "echo", "file_content": ["t\n"], "batch_size": 1})
    job = q.next_job("zombie")
    e.clock.advance(0.2)
    rejob = q.next_job("fresh")
    return [rejob["worker_id"],
            q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "zombie"}),
            q.update_job(job["job_id"], {"status": "complete", "worker_id": "fresh"}),
            q.update_job(job["job_id"], {"status": "complete", "worker_id": "fresh"}),
            q.state.llen("completed")]


def test_update_job_fencing_and_terminal_no_regress(tmp_path, monkeypatch):
    seen = run_case(s_update_job_fencing_and_terminal_no_regress, tmp_path,
                    monkeypatch)["seen"]
    assert seen == ["fresh", False, True, False, 1]


def s_dangling_queue_ids_drop_in_loop(e):
    q = e.server(start=False, api_key="k").queue
    for i in range(2000):
        q.state.rpush("job_queue", f"ghost_{i}_0")
    q.queue_scan({"module": "echo", "file_content": ["t\n"], "batch_size": 1})
    return [q.next_job("w")]


def test_dangling_queue_ids_drop_in_loop(tmp_path, monkeypatch):
    [job] = run_case(s_dangling_queue_ids_drop_in_loop, tmp_path, monkeypatch)["seen"]
    assert job is not None and not job["job_id"].startswith("ghost")


def s_server_advertises_bound_url(e):
    cfg = e.config(api_key="k")
    srv = e.server(cfg=cfg)
    seen = [cfg.server_url == f"http://127.0.0.1:{srv.port}", cfg.server_url_derived]
    cfg2 = e.config("2", host="0.0.0.0", api_key="k",
                    server_url="http://scan.example.com:8443")
    e.server(cfg=cfg2)
    seen += [cfg2.server_url, cfg2.server_url_derived]
    return seen


def test_server_advertises_bound_url(tmp_path, monkeypatch):
    seen = run_case(s_server_advertises_bound_url, tmp_path, monkeypatch,
                    compare=("seen", "moved"))["seen"]
    assert seen == [True, True, "http://scan.example.com:8443", False]


def s_server_realigns_url_when_config_is_reused(e):
    cfg = e.config(api_key="k")
    srv = e.server(cfg=cfg)
    first_url, first_port = cfg.server_url, srv.port
    srv.shutdown()
    srv2 = e.server(cfg=cfg)
    seen = [cfg.server_url == f"http://127.0.0.1:{srv2.port}",
            cfg.server_url != first_url or srv2.port == first_port]
    cfg2 = e.config("2", api_key="k", server_url=first_url)
    e.server(cfg=cfg2)
    seen.append(cfg2.server_url == first_url)
    return seen


def test_server_realigns_url_when_config_is_reused(tmp_path, monkeypatch):
    seen = run_case(s_server_realigns_url_when_config_is_reused, tmp_path, monkeypatch,
                    compare=("seen", "moved"))["seen"]
    assert seen == [True, True, True]


def s_server_binds_and_advertises_ipv6(e):
    cfg = e.config(host="::1", api_key="k")
    srv = e.server(cfg=cfg)
    req = urllib.request.Request(cfg.server_url + "/get-statuses",
                                 headers={"Authorization": "Bearer k"})
    return [cfg.server_url == f"http://[::1]:{srv.port}", urllib.request.urlopen(req).status]


@pytest.mark.skipif(not _ipv6_loopback_available(), reason="no IPv6 loopback on this host")
def test_server_binds_and_advertises_ipv6(tmp_path, monkeypatch):
    seen = run_case(s_server_binds_and_advertises_ipv6, tmp_path, monkeypatch)["seen"]
    assert seen == [True, 200]
