"""End to end through each package's own server and worker, on the CPU:
the port's ``SwarmServer`` with the port's workers (``device="cpu"``),
held to the JAX package's server with the JAX package's workers on the
same scripts, through the harness of ``tests/test_torch_server.py``.

- ``tests/test_end_to_end.py``: a ``fingerprint`` scan over the repo's
  test corpus, a command module, a failing module's retries into the
  dead letter, and the process fleet (``/spin-up``, a scan, idle
  teardown: the port's ``ProcessProvider`` with ``extra_args=["--device",
  "cpu"]``, so each spawned ``python -m swarm_tpu_torch.worker`` runs on
  the CPU);
- ``tests/test_qos.py``: an interactive probe served ahead of a live
  bulk flood;
- ``tests/test_trace_waterfall.py``: a dispatched scan's waterfall and
  tracing off; ``tests/test_tracing.py``: one trace id at every layer;
- ``tests/test_resilience.py``: a dead server against an idle queue,
  seen by the port's ``ServerClient``;
- state across packages: a scan that one package's server began, with
  a chunk leased, is finished by the other package's server over the
  same blob and doc roots, with ``/raw`` equal to a clean run's.

Real workers run on the real clock and post real seconds, so these
scripts compare what they saw (bytes, codes, statuses, orders), not the
stores. Each side drives its server through its own package's
``JobClient``; the client-rendering cases are in
``tests/test_torch_client.py``. Everything compared is bytes, strings
or numbers: tolerance 0.
"""

import json
import threading
import time
from pathlib import Path

import pytest
import requests

from test_torch_server import KEY, PKG, one_torch_thread, run_case  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TEMPLATES = "tests/data/templates"


@pytest.fixture
def templates_env(monkeypatch):
    monkeypatch.setenv("SWARM_TEMPLATES_DIR", TEMPLATES)


def _modules(e, **extra) -> str:
    """``tests/test_end_to_end.py``'s modules directory: ``fingerprint``
    (the tpu backend on the templates dir) and ``echo``."""
    d = e.root / "modules"
    d.mkdir(parents=True, exist_ok=True)
    (d / "fingerprint.json").write_text(
        json.dumps({"backend": "tpu", "templates": "${SWARM_TEMPLATES_DIR}"}))
    (d / "echo.json").write_text(json.dumps({"command": "cat {input} > {output}"}))
    for name, spec in extra.items():
        (d / f"{name}.json").write_text(json.dumps(spec))
    return str(d)


def _stack(e, **kw):
    cfg = e.config(modules_dir=_modules(e), poll_interval_idle_s=0.05,
                   poll_interval_busy_s=0.01, **kw)
    srv = e.server(cfg=cfg)
    return cfg, srv, e.p.cli.JobClient(cfg.resolve_url(), KEY)


def _scan_file(e, name: str, text: str) -> str:
    path = e.root / name
    path.write_text(text)
    return str(path)


def _run_worker(e, cfg, max_jobs, worker_id="tpu-w0"):
    proc = e.worker(cfg, max_jobs=max_jobs, worker_id=worker_id)
    proc.process_jobs()
    return proc


def _scan_view(statuses: dict) -> list:
    return [{k: s[k] for k in ("scan_id", "total_chunks", "chunks_complete",
                               "percent_complete")} for s in statuses["scans"]]


# ---------------------------------------------------------------------------
# tests/test_end_to_end.py


E2E_ROWS = [
    {"host": "10.0.0.1", "port": 443, "status": 200,
     "body": "<title>Demo Admin</title> demo-build 7.7 page"},
    {"host": "10.0.0.2", "port": 80, "status": 200, "body": "hello world"},
    {"host": "10.0.0.3", "port": 7777, "banner_b64": "REVNT0Q6IDIgc2VydmljZSByZWFkeQ=="},
]


def e_end_to_end_tpu_scan(e):
    cfg, srv, client = _stack(e)
    path = _scan_file(e, "targets.jsonl", "".join(json.dumps(r) + "\n" for r in E2E_ROWS))
    code, text = client.start_scan(path, "fingerprint", 0, 2)
    worker = _run_worker(e, cfg, 2)
    statuses = client.get_statuses()
    scan_id = statuses["scans"][0]["scan_id"]
    return [code, text, worker.jobs_done, _scan_view(statuses)[0]["percent_complete"],
            client.fetch_raw(scan_id)]


def test_end_to_end_tpu_scan(tmp_path, monkeypatch, templates_env):
    seen = run_case(e_end_to_end_tpu_scan, tmp_path, monkeypatch, compare=("seen",),
                    clocked=False)["seen"]
    assert seen[:4] == [200, "Job queued successfully", 2, 100.0]
    by_host = {o["host"]: o for o in map(json.loads, seen[4].strip().splitlines())}
    assert "demo-panel" in by_host["10.0.0.1"]["matches"]
    assert by_host["10.0.0.1"]["extractions"]["demo-panel"] == ["7.7"]
    assert by_host["10.0.0.2"]["matches"] == ["demo-tech"]
    assert "demo-banner" in by_host["10.0.0.3"]["matches"]


def e_end_to_end_command_module(e):
    cfg, srv, client = _stack(e)
    code, _ = client.start_scan(_scan_file(e, "targets.txt", "alpha\nbeta\ngamma\n"),
                                "echo", 0, 3)
    worker = _run_worker(e, cfg, 1)
    scan_id = client.get_statuses()["scans"][0]["scan_id"]
    return [code, worker.jobs_done, client.fetch_raw(scan_id),
            requests.get(f"{e.base(srv)}/stream/{scan_id}", timeout=30,
                         headers={"Authorization": f"Bearer {KEY}"}).content]


def test_end_to_end_command_module(tmp_path, monkeypatch):
    seen = run_case(e_end_to_end_command_module, tmp_path, monkeypatch, compare=("seen",),
                    clocked=False)["seen"]
    assert seen[:3] == [200, 1, "alpha\nbeta\ngamma"]
    records = [json.loads(x) for x in seen[3].splitlines()]
    assert "".join(r["data"] for r in records if "data" in r) == seen[2]
    assert records[-1] == {"event": "end", "next_chunk": 1}


def e_worker_failed_module_retries_then_dead_letters(e):
    cfg, srv, client = _stack(e)
    (Path(cfg.modules_dir) / "boom.json").write_text(json.dumps({"command": "exit 3"}))
    client.start_scan(_scan_file(e, "t.txt", "x\n"), "boom", 0, 1, scan_id="boom_1")
    proc = e.worker(cfg, max_jobs=1, worker_id="w-fail")
    attempts = []
    for _ in range(cfg.max_attempts):
        job = proc.client.get_job("w-fail")
        attempts.append(job["attempts"])
        proc.process_chunk(job)
    [rec] = client.get_statuses()["jobs"].values()
    return [attempts, proc.client.get_job("w-fail"), rec["status"],
            [f["status"] for f in rec["failure_history"]],
            [d["job_id"] for d in client.dead_letter_jobs()]]


def test_worker_failed_module_retries_then_dead_letters(tmp_path, monkeypatch):
    seen = run_case(e_worker_failed_module_retries_then_dead_letters, tmp_path, monkeypatch,
                    compare=("seen",), clocked=False)["seen"]
    attempts, none, status, history, dead = seen
    assert attempts == list(range(1, len(attempts) + 1)) and none is None
    assert status == "dead letter" and history == ["cmd failed"] * len(attempts)
    assert dead == ["boom_1_0"]


def e_fleet_spinup_scan_teardown(e):
    """``/spin-up`` of two process nodes, a 3-chunk scan, idle teardown.
    The port's provider asks its spawned workers for the CPU."""
    modules = _modules(e)
    cfg = e.config(modules_dir=modules, fleet_provider="process",
                   idle_polls_before_teardown=3)
    fleet = (e.p.fleet.ProcessProvider(cfg, extra_args=["--device", "cpu"])
             if e.side == "torch" else None)
    srv = e.server(cfg=cfg, fleet=fleet)
    fleet = srv.fleet
    e.extra_shutdown.append(fleet.shutdown)
    client = e.p.cli.JobClient(cfg.resolve_url(), KEY)
    seen = [type(fleet).__name__, client.spin_up("flt", 2)[0]]
    deadline = time.monotonic() + 30
    while len(fleet.list_nodes("flt")) < 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    seen.append(sorted(fleet.list_nodes("flt")))
    # each node is the package's own worker; the port's asks for the CPU
    extra = ["--device", "cpu"] if e.side == "torch" else []
    with fleet._lock:
        seen.append([p.args[1:3] == ["-m", f"{e.p.worker_pkg}.worker"] and p.args[9:] == extra
                     for p in fleet._procs.values()])
    code, _ = client.start_scan(
        _scan_file(e, "targets.txt", "".join(f"t{i}.example\n" for i in range(6))),
        "echo", 0, 2)
    seen.append(code)
    deadline = time.monotonic() + 90
    scan_id = None
    while time.monotonic() < deadline:
        done = [s for s in client.get_statuses()["scans"] if s["percent_complete"] == 100]
        if done:
            scan_id = done[0]["scan_id"]
            break
        time.sleep(0.2)
    seen.append(client.fetch_raw(scan_id) if scan_id else None)
    deadline = time.monotonic() + 45
    while fleet.list_nodes("flt") and time.monotonic() < deadline:
        time.sleep(0.2)
    seen.append(fleet.list_nodes("flt"))
    return seen


def test_fleet_spinup_scan_teardown(tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_POLL_INTERVAL_IDLE_S", "0.1")
    monkeypatch.setenv("SWARM_POLL_INTERVAL_BUSY_S", "0.02")
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbc"))

    def case(e):
        # spawned workers read their modules directory from the env
        monkeypatch.setenv("SWARM_MODULES_DIR", str(e.root / "modules"))
        return e_fleet_spinup_scan_teardown(e)

    seen = run_case(case, tmp_path, monkeypatch, compare=("seen",), clocked=False)["seen"]
    assert seen[:5] == ["ProcessProvider", 202, ["flt1", "flt2"], [True, True], 200]
    assert seen[5] is not None and all(f"t{i}.example" in seen[5] for i in range(6))
    assert seen[6] == []


# ---------------------------------------------------------------------------
# tests/test_qos.py


def e_interactive_preempts_flood(e):
    cfg = e.config(modules_dir=_modules(e, slow={
        "command": "sleep 0.15 && cat {input} > {output}"}),
        poll_interval_idle_s=0.02, poll_interval_busy_s=0.01)
    srv = e.server(cfg=cfg)

    def submit(scan_id, module, lines, qos=None):
        headers = {"X-Swarm-QoS": qos} if qos else {}
        return e.post(srv, "/queue", headers=headers, json={
            "module": module, "file_content": lines, "batch_size": 1, "scan_id": scan_id,
            "chunk_index": 0}).status_code

    codes = [submit("flood_1", "slow", [f"b{i}\n" for i in range(8)])]
    worker = e.worker(cfg, worker_id="pw", max_jobs=9)
    wt = threading.Thread(target=worker.process_jobs, daemon=True)
    wt.start()
    probe_done_with_flood_pending = False
    try:
        time.sleep(0.2)
        codes.append(submit("fast_1", "echo", ["probe\n"], qos="interactive"))
        deadline = time.time() + 60
        while time.time() < deadline:
            jobs = e.get(srv, "/get-statuses").json()["jobs"]
            flood_waiting = sum(1 for j in jobs.values()
                                if j.get("scan_id") == "flood_1" and j["status"] == "queued")
            if jobs.get("fast_1_0", {}).get("status") == "complete":
                probe_done_with_flood_pending = flood_waiting >= 3
                break
            time.sleep(0.02)
        rec = srv.queue.job_record("fast_1_0")
    finally:
        worker.stop_requested = True
        wt.join(timeout=30)
    return [codes, probe_done_with_flood_pending, rec["qos"],
            rec["completed_at"] - rec["admitted_at"] < 1.0]


def test_interactive_preempts_flood_end_to_end(tmp_path, monkeypatch):
    seen = run_case(e_interactive_preempts_flood, tmp_path, monkeypatch, compare=("seen",),
                    clocked=False)["seen"]
    assert seen == [[200, 200], True, "interactive", True]


# ---------------------------------------------------------------------------
# tests/test_trace_waterfall.py, tests/test_tracing.py (with a worker)


def e_dispatched_scan_waterfall_complete(e):
    e.p.tracing.set_enabled(True)
    cfg, srv, client = _stack(e)
    code, _ = client.start_scan(_scan_file(e, "targets.txt", "alpha\nbeta\n"), "echo", 0, 1,
                                scan_id="wfall_1")
    proc = _run_worker(e, cfg, 2, worker_id="wf-w")
    doc = client.get_trace("wfall_1")
    orphans = e.p.tracing.waterfall_orphans(doc)
    names = sorted({s["name"] for s in doc["spans"]})
    gl, seg = doc["gateway_latency_s"], doc["segments_sum_s"]
    return [code, proc.jobs_done, doc["status"], doc["trace_id"] == client.last_trace_id,
            orphans, [n for n in ("queue-wait", "download", "execute", "upload")
                      if n not in names],
            sum(1 for s in doc["spans"] if s["name"] == "attempt"),
            sum(1 for s in doc["spans"] if s["name"] == "queue-wait"),
            gl > 0 and abs(seg - gl) / gl <= 0.10,
            bool(e.p.tracing.critical_path(doc))]


def test_dispatched_scan_waterfall_complete(tmp_path, monkeypatch):
    seen = run_case(e_dispatched_scan_waterfall_complete, tmp_path, monkeypatch,
                    compare=("seen",), clocked=False)["seen"]
    assert seen == [200, 2, "complete", True, [], [], 2, 2, True, True]


def e_tracing_disabled_preserves_wire(e):
    e.p.tracing.set_enabled(None)
    cfg, srv, client = _stack(e)
    client.start_scan(_scan_file(e, "t.txt", "alpha\n"), "echo", 0, 1, scan_id="off_1")
    _run_worker(e, cfg, 1, worker_id="off-w")
    rec = srv.queue.job_record("off_1_0")
    text = requests.get(f"{e.base(srv)}/metrics", timeout=30).text
    e.p.metrics.parse_exposition(text)
    return [e.p.tracing.enabled(), rec["status"], "spans" in (rec.get("perf") or {}),
            e.get(srv, "/trace/off_1").status_code, " # {" in text]


def test_tracing_disabled_preserves_wire(tmp_path, monkeypatch):
    monkeypatch.delenv("SWARM_TRACE", raising=False)
    monkeypatch.delenv("SWARM_TRACE_ENABLED", raising=False)
    seen = run_case(e_tracing_disabled_preserves_wire, tmp_path, monkeypatch,
                    compare=("seen",), clocked=False)["seen"]
    assert seen == [False, "complete", False, 404, False]


def e_trace_id_propagates_end_to_end(e):
    import swarm_tpu.telemetry as j_telemetry
    import swarm_tpu_torch.telemetry as t_telemetry

    cfg, srv, client = _stack(e)
    events = []
    # the client, the server and the worker of a side are its package's
    unsubscribe = [(t_telemetry if e.side == "torch" else j_telemetry).subscribe(events.append)]
    try:
        code, _ = client.start_scan(_scan_file(e, "targets.txt", "alpha\nbeta\n"),
                                    "echo", 0, 0)
        trace_id = client.last_trace_id
        proc = _run_worker(e, cfg, 1, worker_id="trace-w")
        [job] = client.get_statuses()["jobs"].values()
    finally:
        for u in unsubscribe:
            u()
    by_event = {}
    for ev in events:
        by_event.setdefault(ev["event"], []).append(ev)
    [submit] = by_event["scan.submit"]
    done = [ev for ev in by_event["job.worker_done"]
            if ev["trace_id"] == trace_id and ev["status"] == "complete"]
    samples = {(n, tuple(sorted(lb.items()))): v for n, lb, v in e.p.metrics.parse_exposition(
        requests.get(f"{e.base(srv)}/metrics", timeout=30).text)}
    return [code, proc.jobs_done, submit["trace_id"] == trace_id,
            job["trace_id"] == trace_id, job["status"],
            [(ev["job_id"] == job["job_id"], ev["perf"]["download_s"] >= 0) for ev in done],
            any(ev["trace_id"] == trace_id and ev["status"] == "complete"
                for ev in by_event["job.terminal"]),
            any(ev["trace_id"] == trace_id for ev in by_event["job.queued"]),
            any(ev["trace_id"] == trace_id for ev in by_event["job.dispatch"]),
            # the server's phase histograms on /metrics (the worker's
            # own families are in the worker's registry)
            [samples.get((f"swarm_job_phase_seconds_count", (("phase", ph),)), 0) >= 1
             for ph in ("download", "execute", "upload")]]


def test_trace_id_propagates_end_to_end(tmp_path, monkeypatch):
    seen = run_case(e_trace_id_propagates_end_to_end, tmp_path, monkeypatch,
                    compare=("seen",), clocked=False)["seen"]
    assert seen == [200, 1, True, True, "complete", [(True, True)], True, True, True,
                    [True] * 3]


# ---------------------------------------------------------------------------
# tests/test_resilience.py


def e_transport_error_distinguishes_dead_server_from_idle_queue(e):
    """The port's ``ServerClient`` against each package's server."""
    from swarm_tpu_torch.resilience.transport import TransportError
    from swarm_tpu_torch.worker.runtime import ServerClient

    srv = e.server()
    client = ServerClient(e.base(srv), KEY, timeout=5.0)
    seen = [client.get_job("w-idle"), client.last_server_generation]
    srv.shutdown()
    client.session.close()
    with pytest.raises(TransportError) as err:
        client.get_job("w-idle")
    return seen + [type(err.value).__name__]


def test_transport_error_distinguishes_dead_server_from_idle_queue(tmp_path, monkeypatch):
    seen = run_case(e_transport_error_distinguishes_dead_server_from_idle_queue, tmp_path,
                    monkeypatch, compare=("seen",))["seen"]
    assert seen == [None, 1, "TransportError"]


# ---------------------------------------------------------------------------
# state across packages


CROSS_LINES = [f"10.9.0.{i}\n" for i in range(8)]


def _pump(base: str, n: int, worker: str, complete: bool = True) -> list:
    """``n`` jobs through the HTTP worker surface: each output line is
    its input line, tagged."""
    session = requests.Session()
    session.headers["Authorization"] = f"Bearer {KEY}"
    taken = []
    for _ in range(n):
        r = session.get(base + "/get-job", params={"worker_id": worker}, timeout=30)
        if r.status_code != 200:
            break
        job = r.json()
        taken.append(job["job_id"])
        if not complete:
            continue
        sid, idx = job["scan_id"], int(job["chunk_index"])
        data = session.get(f"{base}/get-input-chunk/{sid}/{idx}", timeout=30).content
        out = "".join(f"seen {ln}\n" for ln in data.decode().split("\n") if ln)
        session.post(f"{base}/put-output-chunk/{sid}/{idx}", data=out.encode(), timeout=30)
        session.post(f"{base}/update-job/{job['job_id']}", timeout=30,
                     json={"status": "complete", "worker_id": worker})
    session.close()
    return taken


def _cross_run(tmp_path: Path, first: str, second: str) -> dict:
    """A 4-chunk scan: ``first``'s server queues it, completes 2 chunks
    and leases a third, then stops; ``second``'s server starts over the
    same roots, and the rest completes there. → what each saw."""
    roots = dict(host="127.0.0.1", port=0, api_key=KEY, lease_seconds=0.5,
                 blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"))
    a = PKG[first].app.SwarmServer(PKG[first].config.Config(**roots))
    a.start_background()
    base = f"http://127.0.0.1:{a.port}"
    try:
        r = requests.post(base + "/queue", headers={"Authorization": f"Bearer {KEY}"},
                          json={"module": "echo", "file_content": CROSS_LINES,
                                "batch_size": 2, "scan_id": "cross_1"}, timeout=30)
        done = _pump(base, 2, "wa")
        leased = _pump(base, 1, "wa", complete=False)
    finally:
        a.shutdown()
    b = PKG[second].app.SwarmServer(PKG[second].config.Config(**roots))
    b.start_background()
    base = f"http://127.0.0.1:{b.port}"
    try:
        health = requests.get(base + "/healthz", timeout=30).json()
        time.sleep(0.6)  # the leased chunk's lease runs out
        rest = _pump(base, 8, "wb")
        statuses = requests.get(base + "/get-statuses", timeout=30,
                                headers={"Authorization": f"Bearer {KEY}"}).json()
        raw = requests.get(base + "/raw/cross_1", timeout=30,
                           headers={"Authorization": f"Bearer {KEY}"}).text
    finally:
        b.shutdown()
    return {"queued": r.status_code, "done": done, "leased": leased,
            "generation": health["generation"], "recovery": health["recovery"],
            "rest": sorted(rest), "scan": _scan_view(statuses), "raw": raw}


def _clean_raw() -> str:
    return "".join("".join(f"seen {ln}" for ln in CROSS_LINES[i:i + 2])
                   for i in range(0, len(CROSS_LINES), 2))


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_scan_begun_on_one_package_finishes_on_the_other(tmp_path, first, second):
    across = _cross_run(tmp_path / "across", first, second)
    same = _cross_run(tmp_path / "same", second, second)
    assert across == same
    assert across["queued"] == 200 and across["generation"] == 2
    assert across["done"] == ["cross_1_0", "cross_1_1"] and across["leased"] == ["cross_1_2"]
    assert across["rest"] == ["cross_1_2", "cross_1_3"]
    assert across["scan"][0]["percent_complete"] == 100.0
    assert across["raw"] == _clean_raw()


def e_threaded_worker_stops_on_request(e):
    """``stop_requested`` ends a worker's poll loop run in a thread (the
    chaos scripts stop theirs so), before its next poll."""
    cfg, srv, client = _stack(e)
    worker = e.worker(cfg, worker_id="idle-w")
    t = threading.Thread(target=worker.process_jobs, daemon=True)
    t.start()
    time.sleep(0.3)
    worker.stop_requested = True
    t.join(timeout=5)
    return [t.is_alive(), worker.jobs_done, worker.drain_requested,
            "idle-w" in client.get_statuses()["workers"]]


def test_threaded_worker_stops_on_request(tmp_path, monkeypatch):
    seen = run_case(e_threaded_worker_stops_on_request, tmp_path, monkeypatch,
                    compare=("seen",), clocked=False)["seen"]
    assert seen == [False, 0, None, True]
