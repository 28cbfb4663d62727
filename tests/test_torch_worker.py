"""The port's jarm worker (swarm_tpu_torch.worker) against the JAX worker.

Local listeners answer every ClientHello with a synthesized ServerHello
(``chip_smoke.SyntheticTlsFleet``: six server shapes, one plain-TCP
listener, one refused port), so no ``openssl`` and no network are
needed. The port runs with ``device="cpu"``; its output must be
byte-identical to the JAX worker's on the same targets.
"""

import dataclasses
import json
import os
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


@pytest.mark.parametrize("module", ["missing"])
def test_unported_backend_fails_job(module, monkeypatch, tmp_path):
    """A module that does not exist ends ``cmd failed``."""
    from test_match_parity import DATA

    monkeypatch.setenv("SWARM_TEMPLATES_DIR", str(DATA))
    job = {"job_id": "s_1_0", "scan_id": "s_1", "chunk_index": 0, "module": module}
    client = RecordingClient(job, b"10.0.0.1\n")
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(REPO / "modules"),
                        device="cpu", work_dir=str(tmp_path / "work"))
    proc.process_jobs()
    statuses = [u["status"] for u in client.updates]
    assert statuses == ["starting", "downloading", "executing", "cmd failed"]
    assert client.output is None


def test_command_backend_runs_echo(tmp_path):
    """The ``echo`` module (a command, no backend) through the worker:
    its output is its input."""
    blob = b"10.0.0.1\nexample.test:8443\n"
    job = {"job_id": "e_1_0", "scan_id": "e_1", "chunk_index": 0, "module": "echo"}
    client = RecordingClient(job, blob)
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(REPO / "modules"),
                        device="cpu", work_dir=str(tmp_path / "work"))
    proc.process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "uploading", "complete"]
    assert client.output == blob
    assert (tmp_path / "work" / "e_1" / "chunk_0.txt").read_bytes() == blob


@pytest.mark.parametrize("spec", [{"command": "cat {input} > {output}; exit 3"},
                                  {"description": "no command"}])
def test_command_backend_failure_fails_job(tmp_path, spec):
    modules = write_modules(tmp_path, {"cmd": spec})
    job = {"job_id": "c_1_0", "scan_id": "c_1", "chunk_index": 0, "module": "cmd"}
    client = RecordingClient(job, b"x\n")
    cfg = WorkerConfig(modules_dir=str(modules), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(modules), device="cpu",
                        work_dir=str(tmp_path / "work"))
    proc.process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "cmd failed"]
    assert client.output is None


def _templates_outcome(spec):
    try:
        return "ok", spec.templates_dir
    except ValueError as e:
        return "error", str(e)


def test_module_registry_equals_jax(monkeypatch, tmp_path):
    """Both registries over ``modules/``: the same ``names()``, every
    ``load`` the same spec, and ``templates_dir`` the same result or
    error text with ``SWARM_TEMPLATES_DIR`` set, set to a missing
    directory, and unset. A spec keeps its first resolution when the
    variable changes after it; a spec that failed resolves later."""
    port, jax = ModuleRegistry(REPO / "modules"), JaxModuleRegistry(REPO / "modules")
    names = port.names()
    assert names == jax.names() and "fingerprint" in names and "echo" in names
    assert ModuleRegistry(tmp_path / "none").names() == JaxModuleRegistry(tmp_path / "none").names() == []
    fields = ("name", "raw", "backend", "command_template", "input_format",
              "output_format", "probe")
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name in names:
        specs = [port.load(name), jax.load(name)]
        assert [getattr(specs[0], f) for f in fields] == [getattr(specs[1], f) for f in fields]
        for env in (None, str(tmp_path / "missing"), str(corpus)):
            if env is None:
                monkeypatch.delenv("SWARM_TEMPLATES_DIR", raising=False)
            else:
                monkeypatch.setenv("SWARM_TEMPLATES_DIR", env)
            got = [_templates_outcome(s) for s in specs]
            assert got[0] == got[1]
        if specs[0]._templates_raw is None:
            assert got[0] == ("ok", None)
            continue
        assert got[0] == ("ok", str(corpus))
        # the first success is kept, as in the reference
        monkeypatch.delenv("SWARM_TEMPLATES_DIR")
        assert [_templates_outcome(s) for s in specs] == [("ok", str(corpus))] * 2
        fresh = [port.load(name), jax.load(name)]
        unset = [_templates_outcome(s) for s in fresh]
        assert unset[0] == unset[1] and unset[0][0] == "error"
        assert "references an unset environment variable" in unset[0][1]


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


# ---------------------------------------------------------------------------
# The tpu job's other forms, the probe and service backends: each job
# through the port's JobProcessor on the CPU, byte-identical to the JAX
# worker's on the same inputs


def jax_processor(modules_dir: Path, tmp_path: Path):
    from swarm_tpu.config import Config as JaxConfig

    cfg = JaxConfig(modules_dir=str(modules_dir))
    return JaxJobProcessor(cfg, client=object(), registry=JaxModuleRegistry(str(modules_dir)),
                           work_dir=str(tmp_path / "jax-worker"))


def run_both(modules_dir: Path, tmp_path: Path, module: str, blob: bytes) -> tuple:
    """One job of ``module`` through the port's worker (``process_jobs``
    on the CPU) and the JAX worker's execute step → (port, JAX) output
    bytes and the port's processor."""
    job = {"job_id": "m_1_0", "scan_id": "m_1", "chunk_index": 0, "module": module}
    client = RecordingClient(job, blob)
    cfg = WorkerConfig(modules_dir=str(modules_dir), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(modules_dir), device="cpu")
    proc.process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "uploading", "complete"], client.updates
    jax = jax_processor(modules_dir, tmp_path)
    backend = jax.registry.load(module).backend
    execute = {"tpu": jax._execute_tpu, "probe": jax._execute_probe,
               "service": jax._execute_service, "active": jax._execute_active,
               "file": jax._execute_file, "ssl": jax._execute_ssl}[backend]
    return client.output, execute(jax.registry.load(module), blob), proc


@pytest.fixture(scope="module")
def wf_corpus(tmp_path_factory):
    """The synthetic corpus at 150 templates plus the workflows that gate
    on it (``chip_smoke.workflow_docs``), as YAML files, and rows that
    trigger them."""
    import yaml

    from chip_smoke import synthetic_corpus, workflow_docs, workflow_rows

    docs, plants = synthetic_corpus(0, 150)
    root = tmp_path_factory.mktemp("wfcorpus")
    for doc in docs + workflow_docs(docs, plants):
        (root / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    return root, workflow_rows(120, plants)


def write_modules(tmp_path: Path, specs: dict) -> Path:
    modules = tmp_path / "modules"
    modules.mkdir(exist_ok=True)
    for name, spec in specs.items():
        (modules / f"{name}.json").write_text(json.dumps(spec))
    return modules


@pytest.mark.parametrize("output_format", ["matches_jsonl", "nuclei"])
def test_tpu_workflow_jobs_identical(wf_corpus, tmp_path, monkeypatch, output_format):
    from chip_smoke import jsonl_rows

    root, rows = wf_corpus
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    modules = write_modules(tmp_path, {"fp": {
        "backend": "tpu", "templates": str(root), "output_format": output_format}})
    port, jax, proc = run_both(modules, tmp_path, "fp", jsonl_rows(rows))
    assert port == jax
    text = port.decode()
    if output_format == "nuclei":
        assert "[workflow]" in text and "[wf-sub-" in text
    else:
        wf = [json.loads(ln) for ln in text.splitlines() if '"workflow"' in ln]
        assert {w["workflow"] for w in wf} == {f"wf-synth-{k}" for k in range(4)}
    assert set(proc.engines) == {str(root), f"wfrunner::{root}"}
    # the engine carries the gate planes the compile lowered
    engine = proc.engines[str(root)]
    assert engine.db.wf is not None and engine.db.wf.num_terms


def test_tpu_pipeline_job_identical(wf_corpus, tmp_path, monkeypatch):
    """A ``tpu`` job with ``pipeline: on`` (the scheduler; lines decode on
    its prefetch stage): byte-identical to the JAX worker's pipelined job
    and to the port's own job with the pipeline off; its perf fields
    carry the mode and the scheduler's snapshot."""
    from chip_smoke import jsonl_rows
    from swarm_tpu.config import Config as JaxConfig

    root, rows = wf_corpus
    rows = rows[:60]
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    modules = write_modules(tmp_path, {"fp": {
        "backend": "tpu", "templates": str(root)}})
    blob = jsonl_rows(rows)
    outs, perfs = {}, {}
    for mode in ("on", "off"):
        job = {"job_id": "m_1_0", "scan_id": "m_1", "chunk_index": 0, "module": "fp"}
        client = RecordingClient(job, blob)
        cfg = WorkerConfig(modules_dir=str(modules), max_jobs=1, poll_interval_busy_s=0,
                           pipeline=mode)
        proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(modules), device="cpu")
        proc.process_jobs()
        assert client.updates[-1]["status"] == "complete", client.updates
        assert proc.engines[str(root)].pipeline == mode
        outs[mode], perfs[mode] = client.output, client.updates[-1]["perf"]
    # a single-device JAX engine, as tests/test_sched.py's worker case
    # builds it (the virtual mesh is tests/test_sharding.py's)
    import swarm_tpu.parallel.mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "make_mesh", lambda *a, **k: None)
    jax = JaxJobProcessor(JaxConfig(modules_dir=str(modules), pipeline="on"), client=object(),
                          registry=JaxModuleRegistry(str(modules)),
                          work_dir=str(tmp_path / "jax-worker"))
    want = jax._execute_tpu(jax.registry.load("fp"), blob)
    assert outs["on"] == want == outs["off"]
    assert "workflow" in outs["on"].decode()
    assert perfs["off"]["pipeline"] == "off" and "sched" not in perfs["off"]
    sched = perfs["on"]["sched"]
    assert perfs["on"]["pipeline"] == "on" and 0 <= perfs["on"]["inflight_saturation"] <= 1
    assert sched["chunks"] == 1 and sched["fresh_rows"] + sched["memo_rows"] + sched[
        "dead_rows"] == len(rows)


def test_sched_knobs_from_env(monkeypatch):
    monkeypatch.setenv("SWARM_PIPELINE", "on")
    monkeypatch.setenv("SWARM_QOS_DEADLINE_MS", "12.5")
    monkeypatch.setenv("SWARM_SCHED_MAX_AGE_MS", "250")
    cfg = WorkerConfig.from_env()
    assert (cfg.pipeline, cfg.qos_deadline_ms, cfg.sched_max_age_ms) == ("on", 12.5, 250.0)
    defaults = WorkerConfig()
    assert (defaults.qos_deadline_ms, defaults.sched_max_age_ms) == (50.0, 0.0)


def test_tpu_nuclei_job_identical(tmp_path, monkeypatch):
    from chip_smoke import jsonl_rows, realistic_rows, synthetic_corpus
    import yaml

    docs, plants = synthetic_corpus(1, 120)
    root = tmp_path / "corpus"
    root.mkdir()
    for doc in docs:
        (root / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    modules = write_modules(tmp_path, {"fpn": {
        "backend": "tpu", "templates": str(root), "output_format": "nuclei"}})
    rows = realistic_rows(160, seed=3, plants=plants)
    port, jax, _proc = run_both(modules, tmp_path, "fpn", jsonl_rows(rows))
    assert port == jax
    lines = port.decode().splitlines()
    assert lines and all(ln.startswith("[synth-") and "] [http] [info] http" in ln for ln in lines)


@pytest.fixture(scope="module")
def http_fleet():
    """HTTP listeners answering the realistic mix, planted with the
    synthetic corpus's fragments."""
    from chip_smoke import BannerFleet, http_reply, realistic_rows, synthetic_corpus

    _docs, plants = synthetic_corpus(1, 120)
    rows = realistic_rows(24, seed=9, plants=plants)
    with BannerFleet([(http_reply(r), False) for r in rows]) as fleet:
        yield fleet


def test_tpu_targets_job_identical(http_fleet, tmp_path, monkeypatch):
    from chip_smoke import synthetic_corpus
    import yaml

    docs, _plants = synthetic_corpus(1, 120)
    root = tmp_path / "corpus"
    root.mkdir()
    for doc in docs:
        (root / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    probe = {"type": "http", "resolvers": ["127.0.0.1"], "read_timeout_ms": 2000}
    modules = write_modules(tmp_path, {"fpt": {
        "backend": "tpu", "templates": str(root), "input_format": "targets",
        "wave_targets": 16, "probe": probe}})
    targets = http_fleet.targets + ["127.0.0.1:1", "not a target:x:99999", "# comment"]
    port, jax, _proc = run_both(modules, tmp_path, "fpt", ("\n".join(targets) + "\n").encode())
    assert port == jax
    lines = [json.loads(ln) for ln in port.decode().splitlines()]
    assert len(lines) == len(http_fleet.targets) + 2
    assert any(ln["matches"] for ln in lines)
    assert sum(ln.get("unreachable", False) for ln in lines) == 2


@pytest.mark.parametrize("module", ["httpx", "httprobe", "dnsx"])
def test_probe_jobs_identical(http_fleet, tmp_path, module):
    spec = json.loads((REPO / "modules" / f"{module}.json").read_text())
    # local resolvers only: the targets are IP literals
    spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 2000}
    modules = write_modules(tmp_path, {module: spec})
    targets = http_fleet.targets + ["127.0.0.1:1", "127.0.0.2"]
    port, jax, _proc = run_both(modules, tmp_path, module, ("\n".join(targets) + "\n").encode())
    assert port == jax
    lines = port.decode().splitlines()
    if module == "dnsx":  # names resolved, each once; IP literals pass through
        assert lines == ["127.0.0.1", "127.0.0.2"]
    else:
        assert len(lines) == len(http_fleet.targets)


@pytest.fixture(scope="module")
def service_fleet():
    """Banner listeners of the recall set's protocols (NULL-probe banners
    greet, the others answer the client's bytes) and one HTTP server
    that only answers a request."""
    from chip_smoke import BannerFleet, service_fleet_replies

    recall = json.loads((REPO / "swarm_tpu" / "data" /
                         "service-probes-large.recall.json").read_text())
    replies = service_fleet_replies(recall, limit=12) + [
        (b"SSH-2.0-OpenSSH_9.6\r\n", True),
        (b"220 (vsFTPd 3.0.3)\r\n", True),
        (b"HTTP/1.1 200 OK\r\nServer: nginx/1.18.0\r\n\r\n<html>", False),
    ]
    with BannerFleet(replies) as fleet:
        yield fleet


def test_servicescan_job_identical(service_fleet, tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    spec = json.loads((REPO / "modules" / "servicescan.json").read_text())
    spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 700}
    spec["probes_db"] = str(REPO / "swarm_tpu_torch" / "data" / "service-probes.txt")
    modules = write_modules(tmp_path, {"servicescan": spec})
    targets = service_fleet.targets + ["127.0.0.1:1"]
    port, jax, proc = run_both(modules, tmp_path, "servicescan",
                               ("\n".join(targets) + "\n").encode())
    assert port == jax
    text = port.decode()
    assert text.startswith("Nmap scan report for 127.0.0.1\nPORT      STATE SERVICE")
    assert "open  ssh            OpenSSH 9.6" in text and "vsftpd 3.0.3" in text
    assert "open  http" in text  # answered the second-round payload probe
    assert list(proc.engines) == [f"svc::{spec['probes_db']}"]


def test_servicescan_lines_output_identical(service_fleet, tmp_path, monkeypatch):
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    spec = json.loads((REPO / "modules" / "servicescan.json").read_text())
    spec.pop("output_format")
    spec["probe"] = {**spec["probe"], "resolvers": ["127.0.0.1"], "read_timeout_ms": 700}
    modules = write_modules(tmp_path, {"svc": spec})
    port, jax, _proc = run_both(modules, tmp_path, "svc",
                                ("\n".join(service_fleet.targets[-3:]) + "\n").encode())
    assert port == jax
    assert port.decode().splitlines()[0].startswith("127.0.0.1:")


def test_probe_executor_equal(http_fleet, service_fleet):
    from swarm_tpu.ops.service import ServiceClassifier as JaxClassifier
    from swarm_tpu.worker import executor as j_executor
    from swarm_tpu_torch.ops.service import ServiceClassifier
    from swarm_tpu_torch.worker import executor as t_executor

    spec = {"resolvers": ["127.0.0.1"], "read_timeout_ms": 700, "ports": [80, 8080]}
    lines = http_fleet.targets[:6] + ["127.0.0.2", "http://127.0.0.1:1/x", "bad:99999"]
    t_rows = t_executor.ProbeExecutor(spec).run(lines)
    j_rows = j_executor.ProbeExecutor(spec).run(lines)
    assert [dataclasses.asdict(r) for r in t_rows] == [dataclasses.asdict(r) for r in j_rows]
    assert t_executor.ProbeExecutor(spec).resolve(lines) == j_executor.ProbeExecutor(
        spec).resolve(lines)
    db = str(REPO / "swarm_tpu_torch" / "data" / "service-probes.txt")
    t_clf = ServiceClassifier(db_path=db, device="cpu")
    j_clf = JaxClassifier(db_path=db)
    svc_lines = service_fleet.targets[:5] + ["127.0.0.1:1"]
    t_rows, t_sent = t_executor.ProbeExecutor(spec).run_service(svc_lines, t_clf)
    j_rows, j_sent = j_executor.ProbeExecutor(spec).run_service(svc_lines, j_clf)
    assert t_sent == j_sent
    assert [dataclasses.asdict(r) for r in t_rows] == [dataclasses.asdict(r) for r in j_rows]
    assert t_executor.top_ports() == j_executor.top_ports()
    assert t_executor.top_ports(7) == j_executor.top_ports(7)
    for raw in (b"HTTP/1.1 301 Moved\r\nA: b\r\n\r\nbody", b"HTTP/1.0 200 OK\n\nx", b"SSH-2.0-x",
                b""):
        assert t_executor.parse_http_response(raw) == j_executor.parse_http_response(raw)
    for scheme, port in (("https", 80), ("http", 443), ("", 8443), ("", 80)):
        assert t_executor.use_tls(scheme, port) == j_executor.use_tls(scheme, port)


def test_formats_identical():
    """Every formatter of ``worker/formats.py``, byte for byte."""
    from swarm_tpu.fingerprints.model import Response as JResponse
    from swarm_tpu.ops.service import ServiceInfo as JInfo
    from swarm_tpu.worker import formats as j_formats
    from swarm_tpu_torch.fingerprints.model import Response as TResponse
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load
    from swarm_tpu_torch.ops.engine import RowMatches
    from swarm_tpu_torch.ops.service import ServiceInfo as TInfo
    from swarm_tpu_torch.worker import formats as t_formats
    from swarm_tpu.fingerprints import load_corpus as j_load
    from test_match_parity import DATA

    fields = [
        dict(host="a.test", port=443, status=200, body=b"<TITLE x=1>\n Hi \xe2\x98\x83</title>",
             header=b"HTTP/1.1 200 OK\r\nServer:  nginx/1.2 \r\nX: y"),
        dict(host="b.test", port=8080, status=0, body=b"SSH-2.0-x", header=b""),
        dict(host="c.test", port=80, status=404, body=b"", header=b"server: caddy"),
        dict(host="d.test", port=8443, alive=False),
        dict(host="e.test", port=0, status=301, tls=False),
        dict(host="f.test", port=9443, status=200, tls=True, body=b"<title></title>"),
    ]
    t_rows = [TResponse(**f) for f in fields]
    j_rows = [JResponse(**f) for f in fields]
    assert t_formats.format_httprobe(t_rows) == j_formats.format_httprobe(j_rows)
    assert t_formats.format_httpx_json(t_rows) == j_formats.format_httpx_json(j_rows)
    assert [t_formats.url_of(r) for r in t_rows] == [j_formats.url_of(r) for r in j_rows]
    res = [("a", ["1.2.3.4", "5.6.7.8"]), ("b", []), ("10.0.0.1", ["10.0.0.1"])]
    for with_a in (False, True):
        assert t_formats.format_dnsx(res, with_a) == j_formats.format_dnsx(res, with_a)
    assert t_formats.format_dnsx([]) == j_formats.format_dnsx([]) == ""
    t_templates, _ = t_load(DATA)
    j_templates, _ = j_load(DATA)
    assert t_formats.severity_index(t_templates) == j_formats.severity_index(j_templates)
    sev, proto = t_formats.severity_index(t_templates)
    ids = sorted(sev)
    results = [RowMatches(template_ids=ids[i % len(ids):][:2], extractions={})
               for i in range(len(fields))]
    assert t_formats.format_nuclei(t_rows, results, sev, proto) == j_formats.format_nuclei(
        j_rows, results, *j_formats.severity_index(j_templates))
    infos = [
        dict(host="h1", port=22, open=True, service="ssh", product="OpenSSH", version="9.6",
             info="protocol 2.0"),
        dict(host="h1", port=21, open=True, service="ftp", soft=True),
        dict(host="h2", port=80, open=True, product="nginx"),
        dict(host="h2", port=81, open=False, service="http"),
        dict(host="h3", port=9, open=False),
        dict(host="h1", port=8080, open=True, service="http", version="1.1", info="x"),
    ]
    t_infos = [TInfo(**i) for i in infos]
    j_infos = [JInfo(**i) for i in infos]
    assert t_formats.format_nmap_report(t_infos) == j_formats.format_nmap_report(j_infos)
    assert [i.line() for i in t_infos] == [i.line() for i in j_infos]
    assert t_formats.format_nmap_report([]) == ""


# ---------------------------------------------------------------------------
# The active, file and ssl backends: a job through the port's worker on
# the CPU, byte-identical to the JAX worker's ``_execute_*`` on the chunk


from test_torch_active import tokens  # noqa: E402,F401


@pytest.fixture
def same_randstr(monkeypatch):
    from swarm_tpu.worker import active as j_active
    from swarm_tpu_torch.worker import active as t_active

    monkeypatch.setattr(j_active, "_RANDSTR", "swarmfixedrandstr")
    monkeypatch.setattr(t_active, "_RANDSTR", "swarmfixedrandstr")


def test_active_job_identical(tmp_path, monkeypatch, same_randstr):
    """Batch requests, a session chain, a workflow gate, the scope lines
    of an OOB template, a headless template the reference does not run
    and a requires-var template; chunk 0 and chunk 1."""
    import textwrap

    from test_active_scan import LOGIN_TEMPLATE, OOB_TEMPLATE, RAW_TEMPLATE, TOKEN_TEMPLATE
    from test_active_scan import _serve
    from test_match_parity import DATA
    from test_sessions import CHAIN_TEMPLATE
    from test_torch_active import HEADLESS_SKIPPED

    corpus = tmp_path / "corpus"
    shutil.copytree(DATA, corpus)
    for name, doc in (("login", LOGIN_TEMPLATE), ("raw", RAW_TEMPLATE), ("oob", OOB_TEMPLATE),
                      ("token", TOKEN_TEMPLATE), ("chain", CHAIN_TEMPLATE),
                      ("headless", HEADLESS_SKIPPED)):
        (corpus / f"{name}.yaml").write_text(textwrap.dedent(doc))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    srv = _serve({"/": "site powered by AcmeCMS, demo-build 3.11",
                  "/admin": "<title>Demo Admin</title> demo-build 2.0",
                  "/admin/login": "the secret-admin-portal awaits",
                  ("POST", "/api/check"): "raw-post-ok indeed",
                  "/login": '<input name="csrf" value="a1b2c3">'})
    try:
        probe = {"type": "http", "resolvers": ["127.0.0.1"], "read_timeout_ms": 2000,
                 "connect_timeout_ms": 1000}
        modules = write_modules(tmp_path, {"act": {
            "backend": "active", "templates": str(corpus), "probe": probe}})
        blob = f"127.0.0.1:{srv.server_address[1]}\n127.0.0.1:1\n".encode()
        port, jax, proc = run_both(modules, tmp_path, "act", blob)
        assert port == jax
        text = port.decode()
        for want in ("[demo-tech] [http] [info] http://127.0.0.1:",
                     "[demo-panel] [http] [info]", "[demo-login-panel]", "[demo-raw-post]",
                     "[demo-workflow] [workflow]", "# [demo-oob-rce] [oob-skipped]",
                     "# [demo-headless] [headless-skipped]", "# [coverage] requires-var: 1"):
            assert want in text, want
        module = proc.registry.load("act")
        jax_proc = jax_processor(modules, tmp_path)
        assert proc._execute_active(module, blob, chunk_index=1) == jax_proc._execute_active(
            jax_proc.registry.load("act"), blob, chunk_index=1)
        assert "# [" not in proc._execute_active(module, blob, chunk_index=1).decode()
        # the scan counters ride the job's perf fields
        perf = proc.client.updates[-1]["perf"]
        assert perf["targets"] == 2 and perf["live_targets"] == 1
        assert perf["hits"] == sum(not ln.startswith("#") for ln in text.splitlines())
        assert perf["pipeline"] == "off" and perf["workflow_hits"] == 1
    finally:
        srv.shutdown()


def test_nuclei_oob_job_identical(tmp_path, monkeypatch, same_randstr, tokens):
    """A ``nuclei-oob`` job (``modules/nuclei-oob.json``'s probe spec on
    fixed listener ports, a 50 ms poll window) over ``chip_smoke``'s OOB
    fleet: SSRF and JNDI templates of both shapes, a token extractor,
    runnable and js-required headless templates. It ends ``complete``;
    its lines and perf counters equal the JAX worker's, each package's
    listener on the same ports in turn."""
    import yaml

    from chip_smoke import OobFleet, active_replies, headless_docs, oob_headless_corpus
    from swarm_tpu.worker import oob as j_oob
    from swarm_tpu_torch.worker import oob as t_oob
    from test_torch_active import HEADLESS_SKIPPED, close_shared, free_ports, oob_spec

    docs, plants, oob = oob_headless_corpus(0)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    picks = [d for d in docs if d["id"] in sorted(oob)[:12]] + headless_docs()[:3] + [
        headless_docs()[-1], yaml.safe_load(HEADLESS_SKIPPED)]
    for doc in picks:
        (corpus / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    http_port, dns_port = free_ports()
    spec = json.loads((REPO / "modules" / "nuclei-oob.json").read_text())
    modules = write_modules(tmp_path, {"nuclei-oob": {
        **spec, "templates": str(corpus), "probe": oob_spec(http_port, dns_port)}})
    with OobFleet(2, active_replies(docs, plants, 2), dns_port, headless=1) as fleet:
        blob = ("\n".join(fleet.targets) + "\n127.0.0.1:1\n").encode()
        job = {"job_id": "o_1_0", "scan_id": "o_1", "chunk_index": 0, "module": "nuclei-oob"}
        client = RecordingClient(job, blob)
        cfg = WorkerConfig(modules_dir=str(modules), max_jobs=1, poll_interval_busy_s=0)
        proc = JobProcessor(cfg, client=client, registry=ModuleRegistry(modules), device="cpu")
        try:
            proc.process_jobs()
        finally:
            close_shared(t_oob, http_port)
        try:
            jax_proc = jax_processor(modules, tmp_path)
            want = jax_proc._execute_active(jax_proc.registry.load("nuclei-oob"), blob)
        finally:
            close_shared(j_oob, http_port)
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "uploading", "complete"]
    assert client.output == want
    text = want.decode()
    assert "/oob-000/fetch?url=http://{{interactsh-url}}/" in text
    assert "# [chip-hl-js-required] [headless-skipped]" in text
    assert "# [demo-headless] [headless-skipped]" in text and "[oob-skipped]" not in text
    assert "[chip-hl-form-login] [headless] [high]" in text
    perf = client.updates[-1]["perf"]
    assert perf["oob_probes"] == 2 * 12 and perf["oob_interactions"] == fleet.callbacks // 2


def test_file_job_identical(tmp_path, monkeypatch):
    from test_file_templates import INLINE_CONF_AUDIT, INLINE_PERLISH, _write

    corpus = tmp_path / "corpus"
    _write(corpus, "perlish.yaml", INLINE_PERLISH)
    _write(corpus, "conf.yaml", INLINE_CONF_AUDIT)
    scan = tmp_path / "scan"
    _write(scan, "x.pl", "open F; eval $y\n")
    _write(scan, "router.conf", "configure terminal\n" + "y" * 5000)
    _write(tmp_path, "outside.pl", "eval $z\n")
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    modules = write_modules(tmp_path, {"files": {
        "backend": "file", "templates": str(corpus), "scan_root": str(scan)}})
    blob = f"{scan}\n{tmp_path / 'outside.pl'}\n".encode()
    port, jax, proc = run_both(modules, tmp_path, "files", blob)
    assert port == jax
    assert port.decode().splitlines() == [
        f"[conf-audit] [file] [high] {scan / 'router.conf'}",
        f"[perlish-scanner] [file] [info] {scan / 'x.pl'} ['eval']"]
    assert list(proc.engines) == [f"file::{corpus}::{scan}"]


def test_ssl_job_identical(tmp_path, monkeypatch):
    from test_ssl_templates import _make_cert, _tls_server
    from test_torch_sslscan import DOCS

    cert, key = _make_cert(tmp_path)
    tls_port, stop = _tls_server(cert, key)
    try:
        corpus = tmp_path / "corpus"
        corpus.mkdir()
        for i, doc in enumerate(DOCS):
            (corpus / f"t{i}.yaml").write_text(doc)
        modules = write_modules(tmp_path, {"tls": {
            "backend": "ssl", "templates": str(corpus),
            "probe": {"concurrency": 4, "connect_timeout_ms": 3000}}})
        blob = f"127.0.0.1:{tls_port}\n127.0.0.1:1\n".encode()
        port, jax, _proc = run_both(modules, tmp_path, "tls", blob)
        assert port == jax
        assert f"[mini-self-signed] [ssl] [low] 127.0.0.1:{tls_port}" in port.decode()
    finally:
        stop.set()
