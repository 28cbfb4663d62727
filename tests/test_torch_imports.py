"""The port imports torch and nothing of JAX or of the JAX package.

Every module of ``swarm_tpu_torch``, and ``chip_smoke.py``, is imported
in a fresh interpreter, which then must hold no ``jax`` and no
``swarm_tpu`` module.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def port_modules() -> list[str]:
    import swarm_tpu_torch

    names = ["swarm_tpu_torch"]
    for info in pkgutil.walk_packages(swarm_tpu_torch.__path__, "swarm_tpu_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return sorted(names)


def test_module_list_covers_the_slice():
    names = set(port_modules())
    assert {
        "swarm_tpu_torch.ops.cluster", "swarm_tpu_torch.ops.kernels",
        "swarm_tpu_torch.tls.jarm", "swarm_tpu_torch.native.scanio",
        "swarm_tpu_torch.worker.runtime", "swarm_tpu_torch.utils.device",
        # the template-match path
        "swarm_tpu_torch.fingerprints.model", "swarm_tpu_torch.fingerprints.regexlin",
        "swarm_tpu_torch.fingerprints.dslc", "swarm_tpu_torch.fingerprints.nuclei",
        "swarm_tpu_torch.fingerprints.workflows", "swarm_tpu_torch.fingerprints.extractors",
        "swarm_tpu_torch.fingerprints.compile", "swarm_tpu_torch.ops.hashing",
        "swarm_tpu_torch.ops.encoding", "swarm_tpu_torch.ops.cpu_ref",
        "swarm_tpu_torch.ops.md5", "swarm_tpu_torch.ops.regexdev",
        "swarm_tpu_torch.ops.match", "swarm_tpu_torch.ops.engine",
        "swarm_tpu_torch.worker.modules",
        # the engine's host side: the crex regex VM and its front
        "swarm_tpu_torch.native.crex", "swarm_tpu_torch.ops.crexc", "swarm_tpu_torch.ops.fastre",
        # the tpu job's other forms and the probe and service backends
        "swarm_tpu_torch.fingerprints.dbcache", "swarm_tpu_torch.fingerprints.nmap_probes",
        "swarm_tpu_torch.ops.service", "swarm_tpu_torch.ops.workflows",
        "swarm_tpu_torch.worker.executor", "swarm_tpu_torch.worker.formats",
        "swarm_tpu_torch.worker.streaming",
        # the continuous-batching scheduler
        "swarm_tpu_torch.sched", "swarm_tpu_torch.sched.buckets",
        "swarm_tpu_torch.sched.scheduler",
        # the active, file, ssl and command backends
        "swarm_tpu_torch.worker.active", "swarm_tpu_torch.worker.filescan",
        "swarm_tpu_torch.worker.sslscan", "swarm_tpu_torch.worker.sessions",
        "swarm_tpu_torch.worker.dnsquery", "swarm_tpu_torch.worker.headless",
        # the OOB interaction listener
        "swarm_tpu_torch.worker.oob",
        # the worker's resilience layer
        "swarm_tpu_torch.resilience", "swarm_tpu_torch.resilience.faults",
        "swarm_tpu_torch.resilience.breaker", "swarm_tpu_torch.resilience.transport",
        "swarm_tpu_torch.resilience.heartbeat", "swarm_tpu_torch.resilience.spool",
        # tracing and telemetry
        "swarm_tpu_torch.telemetry", "swarm_tpu_torch.telemetry.metrics",
        "swarm_tpu_torch.telemetry.events", "swarm_tpu_torch.telemetry.tracing",
        "swarm_tpu_torch.telemetry.trace_export", "swarm_tpu_torch.telemetry.walk_export",
        "swarm_tpu_torch.telemetry.memo_export", "swarm_tpu_torch.telemetry.device_export",
        "swarm_tpu_torch.telemetry.engine_export", "swarm_tpu_torch.telemetry.sched_export",
        "swarm_tpu_torch.telemetry.workflow_export", "swarm_tpu_torch.telemetry.fleet_export",
        "swarm_tpu_torch.utils.trace",
        # the worker's start-up surface, and several devices
        "swarm_tpu_torch.config", "swarm_tpu_torch.parallel",
        "swarm_tpu_torch.parallel.mesh", "swarm_tpu_torch.parallel.sharded",
        "swarm_tpu_torch.telemetry.shard_export",
        # the corpus refresh's kernel-library families, and several hosts
        "swarm_tpu_torch.telemetry.aot_export", "swarm_tpu_torch.parallel.multihost",
        # the stores and the fleet result tier
        "swarm_tpu_torch.stores", "swarm_tpu_torch.cache", "swarm_tpu_torch.cache.tier",
        # the AOT library cache and the gateway
        "swarm_tpu_torch.aot", "swarm_tpu_torch.aot.store", "swarm_tpu_torch.aot.libcache",
        "swarm_tpu_torch.gateway", "swarm_tpu_torch.gateway.qos",
        "swarm_tpu_torch.gateway.admission", "swarm_tpu_torch.gateway.qoscache",
        "swarm_tpu_torch.gateway.streaming", "swarm_tpu_torch.telemetry.gateway_export",
        # the monitor lane, the whole data model and the queue journal
        "swarm_tpu_torch.datamodel", "swarm_tpu_torch.monitor",
        "swarm_tpu_torch.monitor.spec", "swarm_tpu_torch.monitor.diff",
        "swarm_tpu_torch.monitor.feed", "swarm_tpu_torch.monitor.notify",
        "swarm_tpu_torch.monitor.service", "swarm_tpu_torch.telemetry.monitor_export",
        "swarm_tpu_torch.server", "swarm_tpu_torch.server.journal",
        "swarm_tpu_torch.telemetry.journal_export",
        # the server's queue side, the whole config and the flight recorder
        "swarm_tpu_torch.server.queue", "swarm_tpu_torch.telemetry.trace_export",
        "swarm_tpu_torch.telemetry.tracing",
    } <= names


def _entry_points():
    """Each entry point of the port, built with the given device."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.cluster import density_cluster
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.fingerprints.nmap_probes import load_probes
    from swarm_tpu_torch.ops.match import DeviceDB
    from swarm_tpu_torch.ops.service import ServiceClassifier
    from swarm_tpu_torch.ops.workflows import WorkflowRunner
    from swarm_tpu_torch.fingerprints.nuclei import parse_template
    from swarm_tpu_torch.worker.filescan import FileScanner
    from swarm_tpu_torch.parallel.mesh import make_mesh
    from swarm_tpu_torch.parallel.sharded import ShardedMatcher
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    templates, _ = load_corpus(REPO / "tests" / "data" / "templates" / "http")
    with_workflow, _ = load_corpus(REPO / "tests" / "data" / "templates")
    probes, _ = load_probes(REPO / "swarm_tpu_torch" / "data" / "service-probes.txt")
    return {
        "ServiceClassifier": lambda device: ServiceClassifier(probes=probes, device=device),
        "WorkflowRunner": lambda device: WorkflowRunner(with_workflow, device=device),
        "MatchEngine": lambda device: MatchEngine(templates, device=device),
        "BatchScheduler": lambda device: MatchEngine(
            templates, device=device, pipeline="on").scheduler(),
        "DeviceDB": lambda device: DeviceDB(compile_corpus(templates), device=device),
        "ShardedMatcher": lambda device: ShardedMatcher(
            compile_corpus(templates),
            make_mesh((2, 1, 1), [device] * 2) if device else make_mesh((2, 1, 1))),
        "JobProcessor": lambda device: JobProcessor(WorkerConfig(), device=device),
        "FileScanner": lambda device: FileScanner([parse_template({
            "id": "f", "file": [{"extensions": ["all"], "matchers": [
                {"type": "word", "words": ["secret"]}]}]})], device=device),
        "density_cluster": lambda device: density_cluster(
            np.zeros((2, 16), dtype=np.uint32), 1.0, device=device),
    }


@pytest.mark.parametrize(
    "name", ["MatchEngine", "DeviceDB", "JobProcessor", "density_cluster",
             "ServiceClassifier", "WorkflowRunner", "BatchScheduler", "FileScanner",
             "ShardedMatcher"])
def test_entry_points_run_on_cuda_unless_asked(name):
    build = _entry_points()[name]
    build("cpu")  # the CPU when asked for
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(None)


@pytest.mark.parametrize("module", port_modules() + ["chip_smoke"])
def test_imports_no_jax(module):
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swarm_tpu' or m.startswith('swarm_tpu.'))\n"
        "print(json.dumps({'bad': bad, 'torch': 'torch' in sys.modules}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of ``chip_smoke.py``, its functions' too:
    none names ``jax`` or the JAX package (it reads the package's data
    files as files)."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "swarm_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "swarm_tpu"}
