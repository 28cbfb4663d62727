"""The port's worker starts as the JAX worker starts, and carries the
job's ``qos``.

- a stub ``tpu`` job with ``"qos": "interactive"`` and the pipeline on,
  through both workers with tracing on: the same ``sched`` span
  attributes, the same planner buckets and the same deltas of
  ``swarm_sched_flush_deadline_total{qos}``;
- the JAX ``Config.load`` and the port's ``WorkerConfig.load`` on one
  config file and one environment: the same worker fields, for
  ``--config``, each default file, an empty variable, a bool and a
  malformed file;
- one ``prewarm_modules`` list given to both workers: the same engines
  (corpus key, batch settings) before the first poll;
- a worker configured for several hosts raises.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import signal
from pathlib import Path

import pytest

import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu.telemetry.tracing as j_tracing
import swarm_tpu_torch.telemetry.metrics as t_metrics
import swarm_tpu_torch.telemetry.tracing as t_tracing
import torch
from swarm_tpu.config import Config
from swarm_tpu.worker import runtime as j_runtime
from swarm_tpu_torch import config as t_config
from swarm_tpu_torch.worker import runtime as t_runtime


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
DATA = REPO / "tests" / "data" / "templates"


class StubClient:
    """One job, then an empty queue; records the updates."""

    def __init__(self, job: dict, data: bytes):
        self.job, self.data = job, data
        self.updates: list = []
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

    def post_spans(self, scan_id, spans):
        return True

    def renew_lease(self, *args, **kwargs):
        return True

    def deregister(self, worker_id):
        return True


def jsonl(n: int) -> bytes:
    """``n`` JSONL response rows of a few shapes, each body salted."""
    bodies = [b"<html><head><title>Welcome to nginx!</title></head></html>",
              b"<html><body>site powered by AcmeCMS, demo-build 3.11</body></html>",
              b"<html>404 Not Found</html>", b"A" * 900]
    lines = []
    for i in range(n):
        body = b"<!-- %05d -->" % i + bodies[i % len(bodies)]
        lines.append(json.dumps({
            "host": f"198.51.100.{i % 254}", "port": (80, 443)[i % 2],
            "status": (200, 404)[i % 2], "body_b64": base64.b64encode(body).decode(),
            "header_b64": base64.b64encode(b"HTTP/1.1 200 OK\r\nServer: nginx").decode()}))
    return ("\n".join(lines) + "\n").encode()


def _samples(metrics) -> dict:
    return {(n, tuple(sorted(lab.items()))): v
            for n, lab, v in metrics.parse_exposition(metrics.REGISTRY.render())}


def _delta(before: dict, after: dict, families: tuple) -> dict:
    return {k: after[k] - before.get(k, 0.0) for k in after
            if k[0] in families and after[k] != before.get(k, 0.0)}


@pytest.fixture(scope="module")
def engines():
    """One engine of each package over the small corpus: batches of 32
    rows of at most 512 body and header bytes, the pipeline on, one
    walk thread."""
    from swarm_tpu.fingerprints import load_corpus as j_load_corpus
    from swarm_tpu.ops.engine import MatchEngine as JaxEngine
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.engine import MatchEngine

    return {
        "jax": JaxEngine(j_load_corpus(str(DATA))[0], mesh=None, batch_rows=32,
                         max_body=512, max_header=512, walk_threads=1, pipeline="on"),
        "port": MatchEngine(load_corpus(DATA)[0], device="cpu", batch_rows=32,
                            max_body=512, max_header=512, walk_threads=1, pipeline="on"),
    }


def _run_qos_job(name: str, engine, tmp: Path) -> dict:
    """The stub job through one package's worker, tracing on → its
    completion, the ``sched`` span and the scheduler's family deltas."""
    modules = tmp / "modules"
    modules.mkdir(parents=True, exist_ok=True)
    (modules / "fp.json").write_text(json.dumps({"backend": "tpu", "templates": str(DATA)}))
    job = {"job_id": "q_1_0", "scan_id": "q_1", "chunk_index": 0, "module": "fp",
           "qos": "interactive", "trace_id": "ab" * 16}
    client = StubClient(job, jsonl(48))
    # a deadline far under a chunk's planning time: each chunk's partial
    # interactive buckets flush at its tick
    cfg = dict(modules_dir=str(modules), max_jobs=1, poll_interval_busy_s=0.0,
               poll_interval_idle_s=0.0, pipeline="on", qos_deadline_ms=0.001,
               worker_id=f"{name}-w")
    if name == "jax":
        worker = j_runtime.JobProcessor(Config(**cfg), client=client, work_dir=str(tmp / "wd"))
        worker._engines[str(DATA)] = engine
        metrics, tracing = j_metrics, j_tracing
    else:
        worker = t_runtime.JobProcessor(t_runtime.WorkerConfig(**cfg), client=client,
                                        device="cpu", work_dir=str(tmp / "wd"))
        worker.engines[str(DATA)] = engine
        metrics, tracing = t_metrics, t_tracing
    engine.clear_content_memos()
    families = ("swarm_sched_flush_deadline_total", "swarm_sched_batches_total",
                "swarm_sched_rows_total")
    before = _samples(metrics)
    tracing.set_enabled(True)
    try:
        worker.process_jobs()
    finally:
        tracing.set_enabled(None)
    done = client.updates[-1]
    assert done["status"] == "complete", client.updates
    [sched] = [s for s in done["perf"]["spans"] if s["name"] == "sched"]
    return {"attrs": sched.get("attrs"), "output": client.output,
            "delta": _delta(before, _samples(metrics), families)}


def test_interactive_job_rides_the_express_buckets_as_jax(engines, tmp_path):
    """The job's ``qos`` reaches the scheduler and the ``sched`` span:
    its rows are planned into the interactive (``x:``) buckets, which
    flush on their deadline, as the JAX worker plans them."""
    jax = _run_qos_job("jax", engines["jax"], tmp_path / "jax")
    port = _run_qos_job("port", engines["port"], tmp_path / "port")
    assert port["attrs"] == jax["attrs"] == {"qos": "interactive", "pipeline": "on"}
    assert port["delta"] == jax["delta"]
    assert port["output"] == jax["output"]
    flushes = port["delta"].get(("swarm_sched_flush_deadline_total",
                                 (("qos", "interactive"),)), 0)
    assert flushes > 0
    buckets = [dict(k[1])["bucket"] for k in port["delta"]
               if k[0] == "swarm_sched_batches_total"]
    assert buckets and all(b.startswith("x:") for b in buckets)


# ---------------------------------------------------------------------------
# the config file and the environment


WORKER_FIELDS = [f.name for f in dataclasses.fields(t_runtime.WorkerConfig)]


def _both(path=None, env=None, **overrides):
    """The JAX and the port's config from one file and environment → the
    worker fields of each."""
    env = {} if env is None else env
    jax = Config.load(path=path, env=env, **overrides)
    port = t_runtime.WorkerConfig.load(path=path, env=env, **overrides)
    return ({f: getattr(jax, f) for f in WORKER_FIELDS},
            {f: getattr(port, f) for f in WORKER_FIELDS})


FILE = {"server_url": "http://file:1", "api_key": "from-file", "worker_id": "wf",
        "max_jobs": 4, "poll_interval_idle_s": 3, "pipeline": "on", "lease_seconds": "90",
        "prewarm_modules": "fingerprint", "redis_url": "redis://x:1/0", "unknown_key": 7}


@pytest.fixture
def home(tmp_path, monkeypatch):
    """An empty home directory for the default files."""
    h = tmp_path / "home"
    h.mkdir()
    monkeypatch.setenv("HOME", str(h))
    return h


@pytest.mark.parametrize("case", ["explicit", "default", "legacy", "both_defaults",
                                  "malformed_default", "none"])
def test_config_file_fields_equal_jax(case, home, tmp_path):
    explicit = None
    if case == "explicit":
        explicit = tmp_path / "worker.json"
        explicit.write_text(json.dumps(FILE))
        # a default file is not read when a path is given
        (home / ".swarm_tpu.json").write_text(json.dumps({"api_key": "default"}))
    elif case == "default":
        (home / ".swarm_tpu.json").write_text(json.dumps(FILE))
    elif case == "legacy":
        (home / ".axiom.json").write_text(json.dumps(FILE))
    elif case == "both_defaults":
        (home / ".swarm_tpu.json").write_text(json.dumps(FILE))
        (home / ".axiom.json").write_text(json.dumps({"api_key": "legacy"}))
    elif case == "malformed_default":
        (home / ".swarm_tpu.json").write_text("{not json")
        (home / ".axiom.json").write_text(json.dumps(FILE))
    jax, port = _both(str(explicit) if explicit else None)
    assert port == jax
    want_file = case in ("explicit", "default", "legacy", "both_defaults")
    assert (port["api_key"] == "from-file") == want_file
    if want_file:
        assert (port["max_jobs"], port["poll_interval_idle_s"], port["lease_seconds"]) == (
            4, 3.0, 90.0)
        assert isinstance(port["poll_interval_idle_s"], float)


@pytest.mark.parametrize("content", [None, "{not json"])
def test_explicit_config_must_load(content, tmp_path, home):
    path = tmp_path / "cfg.json"
    if content is not None:
        path.write_text(content)
    for load in (Config.load, t_runtime.WorkerConfig.load):
        with pytest.raises((OSError, ValueError)):
            load(path=str(path), env={})


def test_precedence_file_env_flags_equal_jax(tmp_path, home):
    path = tmp_path / "worker.json"
    path.write_text(json.dumps(FILE))
    env = {"SWARM_API_KEY": "from-env", "WORKER_ID": "alias-w", "SWARM_MAX_JOBS": "9",
           "SWARM_QOS_DEADLINE_MS": "12.5"}
    jax, port = _both(str(path), env, worker_id="from-flag", max_jobs=None)
    assert port == jax
    assert (port["api_key"], port["worker_id"], port["max_jobs"], port["server_url"]) == (
        "from-env", "from-flag", 9, "http://file:1")


@pytest.mark.parametrize("env", [{"SWARM_API_KEY": ""}, {"API_KEY": "", "SWARM_SPOOL_DIR": ""},
                                 {"SWARM_WORKER_ID": "", "WORKER_ID": "alias"}])
def test_empty_variable_counts_as_jax(env, tmp_path, home):
    path = tmp_path / "worker.json"
    path.write_text(json.dumps(FILE))
    jax, port = _both(str(path), env)
    assert port == jax
    if "SWARM_WORKER_ID" in env:
        assert port["worker_id"] == ""  # SWARM_ comes first, empty or not
    else:
        assert port["api_key"] == ""


@dataclasses.dataclass
class Flags:
    """Two bool fields of the JAX config, loaded by the port's loader."""

    trace_enabled: bool = False
    aot_prewarm: bool = True


@pytest.mark.parametrize("raw", ["1", "true", "Yes", " on ", "0", "false", "off", "", "2"])
def test_bool_fields_coerce_as_jax(raw, tmp_path, home):
    env = {"SWARM_TRACE_ENABLED": raw, "SWARM_AOT_PREWARM": raw}
    jax = Config.load(env=env)
    port = t_config.load(Flags, env=env)
    assert (port.trace_enabled, port.aot_prewarm) == (jax.trace_enabled, jax.aot_prewarm)
    path = tmp_path / "flags.json"
    path.write_text(json.dumps({"trace_enabled": True, "aot_prewarm": "no"}))
    jax = Config.load(path=str(path), env={})
    port = t_config.load(Flags, path=str(path), env={})
    assert (port.trace_enabled, port.aot_prewarm) == (jax.trace_enabled, jax.aot_prewarm) == (
        True, False)


def test_main_reads_config_and_prewarms(tmp_path, home, monkeypatch, capsys):
    """``--config`` through the port's ``main``: the file's fields, the
    flags over them, and each prewarmed module printed before the poll
    loop (which the stub ends at once)."""
    modules = tmp_path / "modules"
    modules.mkdir()
    (modules / "fp.json").write_text(json.dumps({"backend": "tpu", "templates": str(DATA)}))
    path = tmp_path / "worker.json"
    path.write_text(json.dumps({**FILE, "modules_dir": str(modules),
                                "prewarm_modules": "fp, echo-missing"}))
    seen = {}

    def process_jobs(self):
        seen["cfg"] = self.cfg
        seen["engines"] = dict(self.engines)

    monkeypatch.setattr(t_runtime.JobProcessor, "process_jobs", process_jobs)
    for key in ("SWARM_COORDINATOR", "SWARM_NUM_PROCESSES", "SWARM_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    saved = signal.getsignal(signal.SIGTERM)  # main installs the drain handler
    try:
        t_runtime.main(["--config", str(path), "--worker-id", "flag-w", "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, saved)
    cfg = seen["cfg"]
    assert (cfg.server_url, cfg.api_key, cfg.worker_id, cfg.pipeline) == (
        "http://file:1", "from-file", "flag-w", "on")
    assert str(DATA) in seen["engines"]
    out = capsys.readouterr().out
    assert "prewarmed module fp" in out
    assert "prewarm echo-missing failed" in out


# ---------------------------------------------------------------------------
# prewarm


def test_prewarm_builds_the_engines_jax_builds(tmp_path, monkeypatch):
    modules = tmp_path / "modules"
    modules.mkdir()
    (modules / "fp.json").write_text(json.dumps({"backend": "tpu", "templates": str(DATA)}))
    (modules / "echo.json").write_text(json.dumps({"command": "cat {input} > {output}"}))
    names = ["fp", "echo", "absent"]
    cfg = dict(modules_dir=str(modules), pipeline="on", prewarm_modules=",".join(names))
    jax = j_runtime.JobProcessor(Config(**cfg), client=StubClient(None, b""),
                                 work_dir=str(tmp_path / "jwd"))
    port = t_runtime.JobProcessor(t_runtime.WorkerConfig(**cfg), client=StubClient(None, b""),
                                  device="cpu", work_dir=str(tmp_path / "twd"))
    # the JAX engine on one device: the test process has 8 virtual CPU
    # devices, and the JAX worker's engine would mesh over them
    import swarm_tpu.ops.engine as j_engine

    class OneDevice(j_engine.MatchEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "mesh": None})

    monkeypatch.setattr(j_engine, "MatchEngine", OneDevice)
    assert [jax.prewarm(n) for n in names] == [port.prewarm(n) for n in names] == [
        True, False, False]

    def engines(built: dict) -> dict:
        return {key: (e.batch_rows, e.max_body, e.max_header, e.pipeline,
                      e.db.num_templates, e.db.num_slots, len(e.templates))
                for key, e in built.items() if hasattr(e, "batch_rows")}

    assert engines(port.engines) == engines(jax._engines)
    assert sorted(port.engines) == sorted(jax._engines)
    assert str(DATA) in port.engines
    # the port's engine has its layout on its device already
    assert port.engines[str(DATA)].device._arrays is not None


# ---------------------------------------------------------------------------
# several hosts


@pytest.mark.parametrize("env", [
    {"SWARM_COORDINATOR": "10.0.0.1:1234"},
    {"SWARM_COORDINATOR": "10.0.0.1:1234", "SWARM_NUM_PROCESSES": "2",
     "SWARM_PROCESS_ID": "0"},
])
def test_multihost_config_raises(env, monkeypatch, tmp_path):
    """A worker given part of the multi-host triplet raises the
    reference's ValueError, from ``main`` and from ``engine_for``; given
    the whole triplet it joins the process group (``init_process_group``
    mocked) in both places, as the JAX worker joins at
    ``worker/runtime.py`` ``_engine_for`` and ``main``."""
    import torch.distributed as dist

    from swarm_tpu_torch.parallel import multihost

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    joins = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: joins.append(kw))
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), [obj] * len(out)))
    monkeypatch.setattr(multihost, "_BACKEND", None)
    monkeypatch.setattr(multihost, "_GROUP", None)
    monkeypatch.delenv("SWARM_DIST_BACKEND", raising=False)
    monkeypatch.setattr(t_runtime.JobProcessor, "process_jobs", lambda self: None)
    sigterm = signal.getsignal(signal.SIGTERM)
    proc = t_runtime.JobProcessor(t_runtime.WorkerConfig(), client=StubClient(None, b""),
                                  device="cpu", work_dir=str(tmp_path / "wd"))
    try:
        if len(env) < 3:
            with pytest.raises(ValueError, match="multi-host config incomplete"):
                t_runtime.main(["--device", "cpu", "--modules-dir", str(tmp_path)])
            with pytest.raises(ValueError, match="multi-host config incomplete"):
                proc.engine_for(str(DATA))
            assert joins == []
            return
        t_runtime.main(["--device", "cpu", "--modules-dir", str(tmp_path)])
        engine = proc.engine_for(str(DATA))
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    want = {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 2,
            "rank": 0}
    assert joins == [want, want]  # the mock leaves the group down: each call joins
    assert multihost.collective_backend() == "gloo"
    assert engine.device.device.type == "cpu"
