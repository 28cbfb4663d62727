"""The port's jarm worker (swarm_tpu_torch.worker) against the JAX worker.

Local listeners answer every ClientHello with a synthesized ServerHello
(``chip_smoke.SyntheticTlsFleet``: six server shapes, one plain-TCP
listener, one refused port), so no ``openssl`` and no network are
needed. The port runs with ``device="cpu"``; its output must be
byte-identical to the JAX worker's on the same targets.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chip_smoke import SyntheticTlsFleet
from swarm_tpu.client.cli import JobClient
from swarm_tpu.config import Config
from swarm_tpu.server.app import SwarmServer
from swarm_tpu.worker.executor import ProbeExecutor as JaxProbeExecutor
from swarm_tpu.worker.modules import ModuleRegistry as JaxModuleRegistry
from swarm_tpu.worker.runtime import JobProcessor as JaxJobProcessor
from swarm_tpu_torch.datamodel import JobStatus
from swarm_tpu_torch.worker.executor import ProbeExecutor, parse_target
from swarm_tpu_torch.worker.modules import ModuleRegistry
from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

REPO = Path(__file__).resolve().parents[1]
JARM_MODULE = REPO / "modules" / "jarm.json"


@pytest.fixture(scope="module")
def fleet():
    with SyntheticTlsFleet(per_shape=3) as f:
        yield f


def jax_execute_jarm(modules_dir: Path, blob: bytes) -> bytes:
    proc = JaxJobProcessor.__new__(JaxJobProcessor)
    proc.registry = JaxModuleRegistry(str(modules_dir))
    return proc._execute_jarm(proc.registry.load("jarm"), blob)


def test_run_jarm_identical(fleet):
    # an unresolvable name goes to a resolver on localhost only
    spec = {"resolvers": ["127.0.0.1"], "read_timeout_ms": 1000}
    lines = fleet.targets + [
        "unresolvable.invalid:443", "127.0.0.1:99999", "# comment", "",
    ]
    t = ProbeExecutor(spec).run_jarm(lines)
    j = JaxProbeExecutor(spec).run_jarm(lines)
    assert [dataclasses.asdict(fp) for fp in t] == [dataclasses.asdict(fp) for fp in j]
    assert len(t) == len(fleet.targets) + 2
    assert sum(fp.alive for fp in t) == len(fleet.targets) - 2


def test_execute_jarm_identical(fleet):
    blob = ("\n".join(fleet.targets) + "\n").encode()
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"))
    proc = JobProcessor(cfg, device="cpu")
    out = proc._execute_jarm(proc.registry.load("jarm"), blob)
    assert out == jax_execute_jarm(REPO / "modules", blob)
    lines = out.decode().splitlines()
    assert len(lines) == len(fleet.targets)
    assert lines[-2].endswith("[open not-tls]") and lines[-1].endswith("[dead]")
    clusters = {ln.split(" cluster=")[1].split()[0] for ln in lines[:-2]}
    assert len(clusters) == 6
    assert all(" cluster_size=3" in ln for ln in lines[:-2])


def test_parse_target_forms():
    assert parse_target("https://a.test/x") == ("a.test", 443, "/x", "https")
    assert parse_target("10.0.0.1:8443") == ("10.0.0.1", 8443, "/", "")
    assert parse_target("a.test") == ("a.test", None, "/", "")
    assert parse_target("  # c") is None
    with pytest.raises(ValueError):
        parse_target("a.test:70000")


@pytest.fixture
def stack(tmp_path):
    modules_dir = tmp_path / "modules"
    modules_dir.mkdir()
    shutil.copy(JARM_MODULE, modules_dir / "jarm.json")
    shutil.copy(JARM_MODULE, modules_dir / "jarmcli.json")
    (modules_dir / "echo.json").write_text(json.dumps({"command": "cat {input} > {output}"}))
    cfg = Config(
        host="127.0.0.1", port=0, api_key="torchkey",
        blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
        modules_dir=str(modules_dir),
        poll_interval_idle_s=0.05, poll_interval_busy_s=0.01,
    )
    srv = SwarmServer(cfg)
    srv.start_background()
    cfg.server_url = f"http://127.0.0.1:{srv.port}"
    yield cfg, tmp_path
    srv.shutdown()


def _job_of(client: JobClient, scan_id: str) -> dict:
    jobs = client.get_statuses()["jobs"].values()
    [job] = [j for j in jobs if j["scan_id"] == scan_id]
    return job


def _submit(client: JobClient, tmp_path: Path, module: str, blob: bytes) -> str:
    scan_file = tmp_path / f"{module}.txt"
    scan_file.write_bytes(blob)
    code, _ = client.start_scan(str(scan_file), module, 0, 0)
    assert code == 200
    [scan] = [s for s in client.get_statuses()["scans"] if s["scan_id"].startswith(module + "_")]
    return scan["scan_id"]


def test_full_loop_server_to_port_worker(stack, fleet):
    cfg, tmp_path = stack
    blob = ("\n".join(fleet.targets) + "\n").encode()
    client = JobClient(cfg.resolve_url(), cfg.api_key)
    scan_id = _submit(client, tmp_path, "jarm", blob)

    wcfg = WorkerConfig(
        server_url=cfg.resolve_url(), api_key=cfg.api_key, worker_id="torch-w0",
        modules_dir=cfg.modules_dir, max_jobs=1,
        poll_interval_idle_s=0.05, poll_interval_busy_s=0.01,
    )
    worker = JobProcessor(wcfg, device="cpu")
    worker.process_jobs()
    assert worker.jobs_done == 1
    assert _job_of(client, scan_id)["status"] == JobStatus.COMPLETE
    assert client.fetch_raw(scan_id) == jax_execute_jarm(Path(cfg.modules_dir), blob).decode()


def test_worker_command_line(stack, fleet):
    cfg, tmp_path = stack
    blob = ("\n".join(fleet.targets[:4]) + "\n").encode()
    client = JobClient(cfg.resolve_url(), cfg.api_key)
    scan_id = _submit(client, tmp_path, "jarmcli", blob)
    proc = subprocess.run(
        [sys.executable, "-m", "swarm_tpu_torch.worker",
         "--server-url", cfg.resolve_url(), "--api-key", cfg.api_key,
         "--worker-id", "torch-cli", "--modules-dir", cfg.modules_dir,
         "--max-jobs", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert _job_of(client, scan_id)["status"] == JobStatus.COMPLETE
    assert client.fetch_raw(scan_id) == jax_execute_jarm(Path(cfg.modules_dir), blob).decode()


class RecordingClient:
    """In-process stand-in for the server client."""

    def __init__(self, job: dict, data: bytes):
        self.job, self.data = job, data
        self.updates: list[dict] = []
        self.output = None

    def get_job(self, worker_id):
        job, self.job = self.job, None
        return job

    def update_job(self, job_id, changes, worker_id=None):
        self.updates.append(changes)
        return True

    def get_input_chunk(self, scan_id, chunk_index):
        return self.data

    def put_output_chunk(self, scan_id, chunk_index, data):
        self.output = data
        return True


@pytest.mark.parametrize("module", ["echo", "missing"])
def test_unported_backend_fails_job(module):
    job = {"job_id": "s_1_0", "scan_id": "s_1", "chunk_index": 0, "module": module}
    client = RecordingClient(job, b"10.0.0.1\n")
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(REPO / "modules"), device="cpu")
    proc.process_jobs()
    statuses = [u["status"] for u in client.updates]
    assert statuses == ["starting", "downloading", "executing", "cmd failed"]
    assert client.output is None


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JobProcessor(WorkerConfig())


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("SERVER_URL", "http://h:1")
    monkeypatch.setenv("SWARM_MAX_JOBS", "3")
    cfg = WorkerConfig.from_env(worker_id="w9", api_key=None)
    assert (cfg.server_url, cfg.max_jobs, cfg.worker_id, cfg.api_key) == (
        "http://h:1", 3, "w9", "CHANGE_THIS",
    )
