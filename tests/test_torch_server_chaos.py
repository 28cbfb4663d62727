"""The reference's chaos scripts (``tests/test_chaos.py``,
``tests/test_restart_chaos.py``, ``tests/test_gateway_chaos.py``) on the
port's server and the port's workers (``device="cpu"``), at cut sizes,
on the CPU.

Each chaos run's ``/raw`` bytes must equal the JAX package's fault-free
run of the same content: its server and its worker, kept for the module
(:class:`JaxBaseline`), each scan run with the script's chunking when a
case first asks for it. The
fault plans are the reference's, installed in the port's
``resilience.faults`` (the port's workers and server run in this
process; the restart script's server is a ``python -m
swarm_tpu_torch.server`` subprocess with the server plan in its env).

Cuts against the reference, to keep each case under 15 s here:
- rolling restart: 8 + 4 chunks (not 12 + 8), two kill -9s (not three),
  leases of 1.5 s (not 3);
- gateway chaos: 4 compliant tenants (not 8) and a flood of 6 (not 10).
Leases are longer than the reference's where a chunk whose heartbeats
are dead must finish inside one (the soak: 1.0 s, not 0.5, its
over-lease chunk sleeping 2.0 s, not 1.2; the gateway script: 1.5 s,
not 0.8, sleeping 3.0 s, not 1.6): under six test processes a CPU job
of the port took longer than the reference's lease.
The soak, dead-letter and preemption scripts run at the reference's
size (8 rows). Everything compared is bytes: tolerance 0.
"""

import base64
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import requests

import swarm_tpu.config as j_config
import swarm_tpu.server.app as j_app
import swarm_tpu.worker.runtime as j_runtime
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.server.app as t_app
import swarm_tpu_torch.worker.runtime as t_runtime
from swarm_tpu.client.cli import JobClient
from swarm_tpu_torch.resilience.faults import clear_plan, fault_point, install_plan
from swarm_tpu_torch.telemetry import REGISTRY

from test_torch_server import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TEMPLATES = "tests/data/templates"
KEY = "chaoskey"

#: tests/test_chaos.py's plan
FAULT_PLAN = (
    "seed=7;"
    "transport.get_job:2,5;"
    "transport.put_chunk/victimscan_1_0:1-3;"
    "transport.renew_lease/victimscan_1_2:*;"
    "executor.run/poisonscan*:*;"
    "executor.run/victimscan_1_2:1:sleep=2.0;"
    "device.dispatch:1"
)
#: tests/test_restart_chaos.py's worker and server plans
WORKER_PLAN = (
    "seed=7;"
    "transport.get_job:3,9;"
    "transport.put_chunk/rra_1_1:1-3;"
    "executor.run/rr*:*:sleep=0.25"
)
SERVER_PLAN = "seed=7;store.hset/workers:5,11"
N_A, N_B = 8, 4
KILL_AT = (1, 4)
RESTART_LEASE_S = 1.5
#: tests/test_gateway_chaos.py's plan
GATEWAY_PLAN = (
    "seed=7;"
    "transport.get_job:2,5;"
    "transport.renew_lease/chaos3_1_0:*;"
    "executor.run/chaos3_1_0:1:sleep=3.0;"
    "store.hset/workers:3,7"
)
N_TENANTS, N_FLOOD = 4, 6
#: leases of the soak and the gateway script: each over-lease chunk
#: sleeps twice its lease, and every other attempt of a chunk whose
#: renewals are dead must finish inside one, also under a loaded host
SOAK_LEASE_S, GATEWAY_LEASE_S = 1.0, 1.5


@pytest.fixture(autouse=True)
def templates_env(monkeypatch):
    monkeypatch.setenv("SWARM_TEMPLATES_DIR", TEMPLATES)
    yield
    clear_plan()


def _modules(root: Path) -> str:
    d = root / "modules"
    d.mkdir(parents=True, exist_ok=True)
    (d / "fingerprint.json").write_text(
        json.dumps({"backend": "tpu", "templates": "${SWARM_TEMPLATES_DIR}"}))
    return str(d)


def _victim_rows():
    rows = [{"host": f"10.0.0.{i}", "port": 443, "status": 200,
             "body": f"<title>Demo Admin</title> demo-build 7.{i} page {i}"} for i in range(6)]
    rows.append({"host": "10.0.9.1", "port": 7777,
                 "banner_b64": base64.b64encode(b"DEMOD: 2 service ready").decode()})
    rows.append({"host": "10.0.9.2", "port": 80, "status": 200, "body": "hello world"})
    return rows


def _restart_rows(n: int):
    rows = [{"host": f"10.7.0.{i}", "port": 443, "status": 200,
             "body": f"<title>Demo Admin</title> demo-build 9.{i} page {i}"}
            for i in range(n - 1)]
    rows.append({"host": "10.7.9.1", "port": 7777,
                 "banner_b64": base64.b64encode(b"DEMOD: 2 service ready").decode()})
    return rows


def _tenant_rows(i: int, n: int = 3):
    rows = [{"host": f"10.{i}.0.{j}", "port": 443, "status": 200,
             "body": f"<title>Demo Admin</title> demo-build 7.{j} tenant {i}"}
            for j in range(n - 1)]
    rows.append({"host": f"10.{i}.9.1", "port": 7777,
                 "banner_b64": base64.b64encode(f"DEMOD: {i} service ready".encode()).decode()})
    return rows


def _lines(rows) -> list:
    return [json.dumps(r) + "\n" for r in rows]


#: every scan whose fault-free bytes a case compares with: scan id →
#: (rows, batch)
BASELINE_SCANS = {
    "victim_1": (_victim_rows(), 2),
    "victimwhole_1": (_victim_rows(), len(_victim_rows())),
    "rra_1": (_restart_rows(N_A), 1),
    "rrb_1": (_restart_rows(N_B), 1),
    **{f"chaos{i}_1": (_tenant_rows(i), 2) for i in range(N_TENANTS)},
    "noisy_1": (_tenant_rows(99, n=1), 1),
}


def _post(base: str, scan_id: str, rows, batch: int, tenant=None, key=KEY):
    headers = {"Authorization": f"Bearer {key}"}
    if tenant:
        headers["X-Swarm-Tenant"] = tenant
    return requests.post(base + "/queue", headers=headers, timeout=30, json={
        "module": "fingerprint", "file_content": _lines(rows), "batch_size": batch,
        "scan_id": scan_id, "chunk_index": 0})


class JaxBaseline:
    """The JAX package's server and worker, no fault plan: ``/raw`` of
    each scan of :data:`BASELINE_SCANS`, run at its first request (one
    worker, so its engine is built once for the module)."""

    def __init__(self, root: Path):
        self.cfg = j_config.Config(host="127.0.0.1", port=0, api_key=KEY,
                                   blob_root=str(root / "blobs"), doc_root=str(root / "docs"),
                                   modules_dir=_modules(root), poll_interval_idle_s=0.03,
                                   poll_interval_busy_s=0.01)
        self.srv = j_app.SwarmServer(self.cfg)
        self.srv.start_background()
        self.worker = j_runtime.JobProcessor(j_config.Config(**{
            **self.cfg.__dict__, "worker_id": "jax-base"}))
        self.client = JobClient(self.cfg.server_url, KEY)
        self.raw: dict = {}

    def __getitem__(self, scan_id: str) -> str:
        if scan_id not in self.raw:
            rows, batch = BASELINE_SCANS[scan_id]
            assert _post(self.cfg.server_url, scan_id, rows, batch).status_code == 200
            self.worker.jobs_done = 0
            self.worker.cfg.max_jobs = -(-len(rows) // batch)
            self.worker.process_jobs()
            self.raw[scan_id] = self.client.fetch_raw(scan_id)
            assert self.raw[scan_id]
        return self.raw[scan_id]


@pytest.fixture(scope="module")
def jax_baseline(tmp_path_factory):
    saved = os.environ.get("SWARM_TEMPLATES_DIR")
    os.environ["SWARM_TEMPLATES_DIR"] = TEMPLATES
    baseline = JaxBaseline(tmp_path_factory.mktemp("jax_baseline"))
    yield baseline
    baseline.srv.shutdown()
    if saved is None:
        os.environ.pop("SWARM_TEMPLATES_DIR", None)
    else:
        os.environ["SWARM_TEMPLATES_DIR"] = saved


def _same_as_baseline(raw: str, baseline: dict, base_id: str, scan_id: str) -> bool:
    return raw == baseline[base_id].replace(base_id, scan_id)


def _worker_cfg(fields: dict) -> t_runtime.WorkerConfig:
    names = {f.name for f in dataclasses.fields(t_runtime.WorkerConfig)}
    return t_runtime.WorkerConfig(**{k: v for k, v in fields.items() if k in names})


def _worker(cfg, worker_id, **kw):
    return t_runtime.JobProcessor(
        _worker_cfg({**cfg.__dict__, "worker_id": worker_id, **kw}), device="cpu")


def _counters() -> dict:
    out: dict = {}
    for line in REGISTRY.render().splitlines():
        if line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            try:
                out[name] = out.get(name, 0.0) + float(line.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return out


# ---------------------------------------------------------------------------
# tests/test_chaos.py


@pytest.fixture
def stack(tmp_path):
    cfg = t_config.Config(
        host="127.0.0.1", port=0, api_key=KEY,
        blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
        modules_dir=_modules(tmp_path), poll_interval_idle_s=0.03,
        poll_interval_busy_s=0.01, lease_seconds=SOAK_LEASE_S, max_attempts=3,
        transport_retries=2, transport_backoff_s=0.01, transport_backoff_max_s=0.05,
        transport_breaker_threshold=50, transport_breaker_cooldown_s=0.2,
        heartbeat_interval_s=0.1)
    srv = t_app.SwarmServer(cfg)
    srv.start_background()
    yield cfg, srv, tmp_path
    clear_plan()
    srv.shutdown()


def test_chaos_soak_bit_identical_and_quarantines(stack, jax_baseline):
    cfg, srv, tmp_path = stack
    client = JobClient(cfg.resolve_url(), KEY)
    before = _counters()
    plan = install_plan(FAULT_PLAN)
    assert _post(cfg.server_url, "victimscan_1", _victim_rows(), 2).status_code == 200
    assert _post(cfg.server_url, "poisonscan_1",
                 [{"host": "10.1.0.1", "port": 80, "status": 200, "body": "x"}],
                 1).status_code == 200
    workers = [_worker(cfg, "w0"), _worker(cfg, "w1")]
    threads = [threading.Thread(target=w.process_jobs, daemon=True) for w in workers]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 60
        victim_done = poison_dead = False
        while time.time() < deadline and not (victim_done and poison_dead):
            time.sleep(0.1)
            statuses = client.get_statuses()
            for scan in statuses.get("scans", []):
                if scan["scan_id"] == "victimscan_1":
                    victim_done = scan["percent_complete"] == 100.0
            poison = statuses["jobs"].get("poisonscan_1_0")
            poison_dead = bool(poison) and poison["status"] == "dead letter"
        assert victim_done and poison_dead
    finally:
        for w in workers:
            w.stop_requested = True
        for t in threads:
            t.join(timeout=30)
    assert _same_as_baseline(client.fetch_raw("victimscan_1"), jax_baseline, "victim_1",
                             "victimscan_1")
    [dead] = client.dead_letter_jobs()
    assert dead["job_id"] == "poisonscan_1_0"
    assert [f["status"] for f in dead["failure_history"]] == ["cmd failed"] * 3
    snap = plan.snapshot()
    assert snap["transport.get_job"]["fired"] == 2
    assert snap["transport.put_chunk/victimscan_1_0"]["fired"] == 3
    assert snap["transport.renew_lease/victimscan_1_2"]["fired"] >= 1
    assert snap["executor.run/poisonscan*"]["fired"] == 3
    assert snap["executor.run/victimscan_1_2"]["fired"] == 1
    assert snap["device.dispatch"]["fired"] == 1
    after = _counters()
    for name in ("swarm_resilience_spooled_chunks_total", "swarm_resilience_spool_replayed_total"):
        assert after.get(name, 0) - before.get(name, 0) >= 1, name
    health = client.get_healthz()
    assert health["dead_letter_jobs"] == 1 and health["fault_plan"] == FAULT_PLAN
    assert isinstance(health["breakers"], dict)
    clear_plan()
    fault_point("transport.get_job")


def test_dead_letter_requeue_completes_after_poison_lifts(stack):
    cfg, srv, tmp_path = stack
    client = JobClient(cfg.resolve_url(), KEY)
    install_plan("executor.run/poisonscan*:*")
    assert _post(cfg.server_url, "poisonscan_9",
                 [{"host": "10.1.0.2", "port": 80, "status": 200, "body": "y"}],
                 1).status_code == 200
    _worker(cfg, "wq", max_jobs=cfg.max_attempts).process_jobs()
    [dead] = client.dead_letter_jobs()
    assert dead["job_id"] == "poisonscan_9_0"
    clear_plan()
    assert client.requeue_job("poisonscan_9_0")[0] == 200
    _worker(cfg, "wq2", max_jobs=1).process_jobs()
    assert client.get_statuses()["jobs"]["poisonscan_9_0"]["status"] == "complete"
    assert client.dead_letter_jobs() == []


def test_preempted_worker_hard_killed_mid_drain_recovers(stack, jax_baseline):
    cfg, srv, tmp_path = stack
    client = JobClient(cfg.resolve_url(), KEY)
    rows = _victim_rows()
    install_plan("transport.put_chunk/preemptscan_1_0:1-3;worker.drain/doomed:*")
    assert _post(cfg.server_url, "preemptscan_1", rows, len(rows)).status_code == 200
    doomed_fields = {**cfg.__dict__, "worker_id": "doomed", "max_jobs": 1,
                     "spool_dir": str(tmp_path / "doomed_spool")}
    doomed = t_runtime.JobProcessor(_worker_cfg(doomed_fields), device="cpu")
    doomed.process_jobs()
    assert len(doomed.spool) == 1
    assert srv.queue.drain_worker("doomed", reason="preempted")
    doomed.request_drain("preempted")
    assert doomed.drain("preempted") == "aborted"
    assert len(doomed.spool) == 1
    assert srv.queue.draining_workers() == {"doomed": "preempted"}
    rescue = _worker(cfg, "rescue", max_jobs=1)
    rt = threading.Thread(target=rescue.process_jobs, daemon=True)
    rt.start()
    rt.join(timeout=30)
    assert not rt.is_alive(), "rescue never finished"
    chaos_raw = client.fetch_raw("preemptscan_1")
    assert _same_as_baseline(chaos_raw, jax_baseline, "victimwhole_1", "preemptscan_1")
    rec = json.loads(srv.queue.state.hget("jobs", "preemptscan_1_0"))
    assert rec["status"] == "complete" and rec["worker_id"] == "rescue"
    clear_plan()
    doomed2 = t_runtime.JobProcessor(_worker_cfg(doomed_fields), device="cpu")
    assert len(doomed2.spool) == 1
    doomed2._replay_spool()
    assert len(doomed2.spool) == 0
    assert client.fetch_raw("preemptscan_1") == chaos_raw
    rec = json.loads(srv.queue.state.hget("jobs", "preemptscan_1_0"))
    assert rec["status"] == "complete" and rec["worker_id"] == "rescue"


# ---------------------------------------------------------------------------
# tests/test_restart_chaos.py


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_server(port: int, tmp: Path, log_name: str):
    env = {**os.environ, "SWARM_BLOB_ROOT": str(tmp / "blobs"),
           "SWARM_DOC_ROOT": str(tmp / "docs"), "SWARM_FAULT_PLAN": SERVER_PLAN,
           "SWARM_LEASE_SECONDS": str(RESTART_LEASE_S), "SWARM_MAX_ATTEMPTS": "6",
           "SWARM_GATEWAY_STREAM_POLL_S": "0.02"}
    log = open(tmp / log_name, "ab")
    return subprocess.Popen(
        [sys.executable, "-m", "swarm_tpu_torch.server", "--host", "127.0.0.1",
         "--port", str(port), "--api-key", KEY],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def _wait_healthy(port: int, deadline_s: float = 30.0) -> dict:
    end = time.time() + deadline_s
    while time.time() < end:
        try:
            r = requests.get(f"http://127.0.0.1:{port}/healthz", timeout=2)
            if r.status_code == 200:
                return r.json()
        except requests.RequestException:
            pass
        time.sleep(0.05)
    raise AssertionError("server did not become healthy in time")


def _restart_worker_cfg(tmp: Path, port: int, worker_id: str):
    return t_runtime.WorkerConfig(
        server_url=f"http://127.0.0.1:{port}", api_key=KEY, worker_id=worker_id,
        modules_dir=_modules(tmp), poll_interval_idle_s=0.03, poll_interval_busy_s=0.01,
        lease_seconds=RESTART_LEASE_S, heartbeat_interval_s=0.2, transport_retries=2,
        transport_backoff_s=0.02, transport_backoff_max_s=0.1,
        transport_breaker_threshold=500, spool_dir=str(tmp / f"spool-{worker_id}"))


def test_rolling_restart_soak(tmp_path, jax_baseline):
    port = _free_port()
    base_url = f"http://127.0.0.1:{port}"
    live = tmp_path / "live"
    live.mkdir()
    proc = _spawn_server(port, live, "server.log")
    plan = install_plan(WORKER_PLAN)
    client = JobClient(base_url, KEY)
    workers, threads, stream_records, stream_error = [], [], [], []

    def stream_follow():
        try:
            for chunk, text in JobClient(base_url, KEY).stream_results(
                    "rra_1", max_reconnects=100, reconnect_delay_s=0.2):
                stream_records.append((chunk, text))
        except Exception as e:
            stream_error.append(e)

    def completed_count():
        try:
            statuses = client.get_statuses()
        except requests.RequestException:
            return None
        if statuses is None:
            return None
        return sum(1 for j in statuses["jobs"].values() if j["status"] == "complete")

    try:
        assert _wait_healthy(port)["generation"] == 1
        assert _post(base_url, "rra_1", _restart_rows(N_A), 1, tenant="tenantA").status_code == 200
        assert _post(base_url, "rrb_1", _restart_rows(N_B), 1, tenant="tenantB").status_code == 200
        st = threading.Thread(target=stream_follow, daemon=True)
        st.start()
        for wid in ("w0", "w1"):
            w = t_runtime.JobProcessor(_restart_worker_cfg(tmp_path, port, wid), device="cpu")
            workers.append(w)
            t = threading.Thread(target=w.process_jobs, daemon=True)
            threads.append(t)
            t.start()
        deadline = time.time() + 90
        kills = 0
        for threshold in KILL_AT:
            while time.time() < deadline:
                done = completed_count()
                if done is not None and done >= threshold:
                    break
                time.sleep(0.05)
            done = completed_count()
            assert done is None or done < N_A + N_B, "scans finished before the restarts"
            proc.kill()
            proc.wait(timeout=10)
            kills += 1
            proc = _spawn_server(port, live, "server.log")
            health = _wait_healthy(port)
            assert health["generation"] == 1 + kills and health["recovery"]
        pending = {"rra_1", "rrb_1"}
        while time.time() < deadline and pending:
            time.sleep(0.1)
            try:
                statuses = client.get_statuses()
            except requests.RequestException:
                continue
            if statuses is None:
                continue
            pending -= {s["scan_id"] for s in statuses.get("scans", [])
                        if s["percent_complete"] == 100.0}
        assert not pending, f"scans did not complete under chaos: {pending}"
    finally:
        for w in workers:
            w.stop_requested = True
        for t in threads:
            t.join(timeout=30)
        clear_plan()
    try:
        assert client.fetch_raw("rra_1") == jax_baseline["rra_1"]
        assert client.fetch_raw("rrb_1") == jax_baseline["rrb_1"]
        jobs = {j: r for j, r in client.get_statuses()["jobs"].items()
                if r["scan_id"] in ("rra_1", "rrb_1")}
        assert len(jobs) == N_A + N_B
        assert all(r["status"] == "complete" for r in jobs.values())
        assert client.dead_letter_jobs() == []
        st.join(timeout=30)
        assert not st.is_alive() and not stream_error
        assert [c for c, _ in stream_records] == list(range(N_A))
        session = requests.Session()
        session.headers["Authorization"] = f"Bearer {KEY}"
        for chunk, text in stream_records:
            r = session.get(f"{base_url}/get-chunk/rra_1/{chunk}", timeout=10)
            assert r.status_code == 200 and r.json()["contents"] == text
        assert client.get_healthz()["generation"] == 1 + len(KILL_AT)
        snap = plan.snapshot()
        assert snap["transport.get_job"]["fired"] == 2
        assert snap["transport.put_chunk/rra_1_1"]["fired"] == 3
        assert snap["executor.run/rr*"]["fired"] >= N_A + N_B
        assert any((w._seen_generation or 0) >= 2 for w in workers)
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_worker_reregisters_and_breakers_reset_on_generation_change(tmp_path):
    cfg = t_config.Config(host="127.0.0.1", port=0, api_key=KEY,
                          blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"))
    srv = t_app.SwarmServer(cfg)
    srv.start_background()
    port = srv.port
    worker = t_runtime.JobProcessor(_restart_worker_cfg(tmp_path, port, "w-reg"), device="cpu")
    worker.client.get_job("w-reg")
    worker._note_server_generation()
    assert worker._seen_generation == 1
    breaker = worker.client.breakers.get("renew_lease")
    for _ in range(worker.client.breakers.threshold + 1):
        breaker.record_failure()
    assert breaker.state == "open"
    srv.shutdown()
    srv2 = t_app.SwarmServer(t_config.Config(**{**cfg.__dict__, "port": port}))
    srv2.start_background()
    try:
        worker.client.get_job("w-reg")
        worker._note_server_generation()
        assert worker._seen_generation == 2
        assert breaker.state == "closed"
        assert "w-reg" in JobClient(f"http://127.0.0.1:{port}", KEY).get_statuses()["workers"]
    finally:
        srv2.shutdown()


# ---------------------------------------------------------------------------
# tests/test_gateway_chaos.py


def _scan_complete(statuses, scan_id):
    return any(s["scan_id"] == scan_id and s["percent_complete"] == 100.0
               for s in statuses.get("scans", []))


def _wait_scans(client, scan_ids, deadline_s=60.0):
    deadline = time.time() + deadline_s
    pending = set(scan_ids)
    while time.time() < deadline and pending:
        time.sleep(0.1)
        statuses = client.get_statuses()
        if statuses is None:
            continue
        pending = {s for s in pending if not _scan_complete(statuses, s)}
    return pending


def test_gateway_chaos_soak(tmp_path, jax_baseline):
    cfg = t_config.Config(
        host="127.0.0.1", port=0, api_key=KEY,
        blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
        modules_dir=_modules(tmp_path), poll_interval_idle_s=0.03,
        poll_interval_busy_s=0.01, lease_seconds=GATEWAY_LEASE_S, max_attempts=3,
        transport_retries=2, transport_backoff_s=0.01, transport_backoff_max_s=0.05,
        transport_breaker_threshold=50, transport_breaker_cooldown_s=0.2,
        heartbeat_interval_s=0.1, gateway_tenant_rate=5.0, gateway_tenant_burst=3)
    srv = t_app.SwarmServer(cfg)
    srv.start_background()
    client = JobClient(cfg.resolve_url(), KEY)
    workers = [_worker(cfg, "w0"), _worker(cfg, "w1")]
    threads = [threading.Thread(target=w.process_jobs, daemon=True) for w in workers]
    for t in threads:
        t.start()
    try:
        plan = install_plan(GATEWAY_PLAN)
        latencies, submit_codes, noisy_codes = {}, {}, []

        def submit_compliant(i: int) -> None:
            t0 = time.perf_counter()
            resp = _post(cfg.server_url, f"chaos{i}_1", _tenant_rows(i), 2, tenant=f"t{i}")
            latencies[i] = time.perf_counter() - t0
            submit_codes[i] = resp.status_code

        def flood_noisy() -> None:
            for k in range(N_FLOOD):
                noisy_codes.append(_post(cfg.server_url, f"noisy{k}_1", _tenant_rows(99, n=1),
                                         1, tenant="noisy").status_code)

        flood = threading.Thread(target=flood_noisy, daemon=True)
        flood.start()
        submitters = [threading.Thread(target=submit_compliant, args=(i,), daemon=True)
                      for i in range(N_TENANTS)]
        for t in submitters:
            t.start()
        for t in submitters:
            t.join(timeout=30)
        flood.join(timeout=60)
        assert all(code == 200 for code in submit_codes.values()), submit_codes
        assert noisy_codes.count(429) >= 1, noisy_codes
        admitted_noisy = [k for k, code in enumerate(noisy_codes) if code == 200]
        ordered = sorted(latencies.values())
        assert ordered[max(0, int(0.95 * len(ordered)) - 1)] < 10.0
        want = [f"chaos{i}_1" for i in range(N_TENANTS)] + [f"noisy{k}_1" for k in admitted_noisy]
        pending = _wait_scans(client, want)
        assert not pending, f"scans did not complete under chaos: {pending}"
    finally:
        for w in workers:
            w.stop_requested = True
        for t in threads:
            t.join(timeout=30)
        clear_plan()
    try:
        for i in range(N_TENANTS):
            assert client.fetch_raw(f"chaos{i}_1") == jax_baseline[f"chaos{i}_1"], i
        for k in admitted_noisy:
            assert _same_as_baseline(client.fetch_raw(f"noisy{k}_1"), jax_baseline,
                                     "noisy_1", f"noisy{k}_1")
        statuses = client.get_statuses()
        chaos_jobs = {j: r for j, r in statuses["jobs"].items() if r["scan_id"] in want}
        assert len(chaos_jobs) == N_TENANTS * 2 + len(admitted_noisy)
        assert all(r["status"] == "complete" for r in chaos_jobs.values())
        completed = srv.queue.state.lrange("completed", 0, -1)
        assert len(completed) == len(set(completed))
        snap = plan.snapshot()
        assert snap["transport.get_job"]["fired"] == 2
        assert snap["transport.renew_lease/chaos3_1_0"]["fired"] >= 1
        assert snap["executor.run/chaos3_1_0"]["fired"] == 1
        assert snap["store.hset/workers"]["fired"] == 2
        assert statuses["jobs"]["chaos3_1_0"]["attempts"] >= 2
        assert statuses["jobs"]["chaos3_1_0"]["tenant"] == "t3"
        admitted_total = shed_total = 0.0
        from swarm_tpu_torch.telemetry.metrics import parse_exposition

        for name, labels, value in parse_exposition(
                requests.get(f"{cfg.resolve_url()}/metrics", timeout=10).text):
            if name == "swarm_gateway_admitted_total":
                admitted_total += value
            elif name == "swarm_gateway_shed_total":
                shed_total += value
        assert admitted_total >= N_TENANTS + 1 and shed_total >= noisy_codes.count(429)
        tenants = client.get_tenants()
        assert tenants["noisy"]["shed"] >= 1
        assert tenants["t3"]["jobs_by_state"].get("complete", 0) >= 2
    finally:
        srv.shutdown()
