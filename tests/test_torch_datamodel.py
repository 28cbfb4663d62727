"""The port's data model (``swarm_tpu_torch/datamodel.py``) against the
JAX package's (``swarm_tpu/datamodel.py``), on the CPU.

- every case of ``tests/test_datamodel.py``, run on each package;
- ids, blob keys and chunking over seeded inputs: equal;
- ``Job``, ``WorkerInfo`` and ``ScanSummary`` wires over seeded records:
  equal, and each package reads the other's;
- ``rollup_scans`` over seeded job tables: equal;
- the status classes: the same strings and sets.

Everything compared is strings, numbers, dicts or lists: tolerance 0.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from swarm_tpu import datamodel as j_dm
from swarm_tpu_torch import datamodel as t_dm

PKG = {"jax": j_dm, "torch": t_dm}
SIDES = sorted(PKG)


# ---------------------------------------------------------------------------
# tests/test_datamodel.py, on each package


@pytest.mark.parametrize("side", SIDES)
def test_scan_id_format(side):
    dm = PKG[side]
    sid = dm.generate_scan_id("nmap", timestamp=1700000000)
    assert sid == "nmap_1700000000"
    module, ts = dm.parse_scan_id(sid)
    assert module == "nmap" and ts == 1700000000


@pytest.mark.parametrize("side", SIDES)
def test_job_id_roundtrip_with_underscored_module(side):
    dm = PKG[side]
    sid = dm.generate_scan_id("http_probe", timestamp=123)
    jid = dm.job_id_for(sid, 7)
    scan_id, idx = dm.parse_job_id(jid)
    assert scan_id == sid and idx == 7


@pytest.mark.parametrize("side", SIDES)
def test_chunk_generator_covers_all_rows(side):
    dm = PKG[side]
    rows = [str(i) for i in range(103)]
    chunks = list(dm.chunk_generator(rows, 10))
    assert len(chunks) == 11
    assert sum(len(c) for c in chunks) == 103
    assert chunks[-1] == rows[100:]
    assert list(dm.chunk_generator(rows, 0)) == [rows]
    assert list(dm.chunk_generator([], 0)) == []


@pytest.mark.parametrize("side", SIDES)
def test_chunk_keys_match_reference_layout(side):
    dm = PKG[side]
    assert dm.chunk_input_key("nmap_1", 3) == "nmap_1/input/chunk_3.txt"
    assert dm.chunk_output_key("nmap_1", 3) == "nmap_1/output/chunk_3.txt"


@pytest.mark.parametrize("side", SIDES)
def test_job_wire_roundtrip_ignores_unknown_keys(side):
    dm = PKG[side]
    job = dm.Job.create("nmap_1700000000", 2, "nmap")
    wire = job.to_wire()
    wire["some_future_field"] = "ignored"
    back = dm.Job.from_json(json.dumps(wire))
    assert back == job


@pytest.mark.parametrize("side", SIDES)
def test_status_taxonomy(side):
    dm = PKG[side]
    assert dm.JobStatus.COMPLETE in dm.JobStatus.TERMINAL
    assert dm.JobStatus.CMD_FAILED in dm.JobStatus.FAILED
    assert dm.JobStatus.EXECUTING not in dm.JobStatus.TERMINAL
    assert "upload failed - credentials" in dm.JobStatus.ALL


@pytest.mark.parametrize("side", SIDES)
def test_rollup_scans(side):
    dm = PKG[side]
    jobs = {}
    for i in range(4):
        j = dm.Job.create("nmap_1700000000", i, "nmap")
        j.worker_id = f"w{i % 2}"
        if i < 3:
            j.status = dm.JobStatus.COMPLETE
            j.completed_at = 1700000100.0 + i
        jobs[j.job_id] = j.to_wire()
    [scan] = dm.rollup_scans(jobs)
    assert scan["total_chunks"] == 4
    assert scan["chunks_complete"] == 3
    assert scan["percent_complete"] == 75.0
    assert scan["scan_started"] == 1700000000
    assert scan["completed_at"] == 1700000102.0
    assert set(scan["workers"]) == {"w0", "w1"}

    jobs[dm.job_id_for("nmap_1700000000", 3)]["status"] = "complete"
    [scan] = dm.rollup_scans(jobs)
    assert scan["percent_complete"] == 100.0
    assert scan["scan_status"] == "complete"


# ---------------------------------------------------------------------------
# the two packages on the same seeded inputs


def _constants(cls) -> dict:
    return {k: v for k, v in vars(cls).items() if k.isupper()}


@pytest.mark.parametrize("cls", ["JobStatus", "WorkerStatus"])
def test_status_classes_equal_jax(cls):
    got, want = _constants(getattr(t_dm, cls)), _constants(getattr(j_dm, cls))
    assert got == want and got
    assert t_dm.SCAN_ID_RE.pattern == j_dm.SCAN_ID_RE.pattern


MODULES = ["nmap", "http_probe", "fingerprint", "a_b_c", "x"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ids_keys_and_chunks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        module = MODULES[int(rng.integers(len(MODULES)))]
        ts = int(rng.integers(0, 2**31))
        idx = int(rng.integers(0, 5000))
        out = []
        for dm in (t_dm, j_dm):
            sid = dm.generate_scan_id(module, timestamp=ts)
            jid = dm.job_id_for(sid, idx)
            out.append((sid, jid, dm.parse_job_id(jid), dm.parse_scan_id(sid),
                        dm.chunk_input_key(sid, idx), dm.chunk_output_key(sid, idx)))
        assert out[0] == out[1]
    for n in (0, 1, 7, 103):
        rows = [f"10.0.0.{i}" for i in range(n)]
        for batch in (-3, 0, 1, 2, 10, 103, 200):
            assert list(t_dm.chunk_generator(rows, batch)) == list(
                j_dm.chunk_generator(rows, batch))
    # an unstamped scan id is the current second in both
    before = int(time.time())
    sids = [dm.generate_scan_id("m") for dm in (t_dm, j_dm)]
    after = int(time.time())
    for sid in sids:
        assert before <= t_dm.parse_scan_id(sid)[1] <= after


STATUSES = sorted(j_dm.JobStatus.ALL | {"unknown"})


def _job_dicts(seed: int, n: int) -> dict:
    """Seeded job records over a few scans: every status, workers, times,
    perf samples (some partial), tenants, QoS, monitor provenance, and a
    scan id without a timestamp."""
    rng = np.random.default_rng(seed)
    scans = ["nmap_1700000000", "fingerprint_1700000100", "m-1.e3_1700000200", "oddscan"]
    jobs = {}
    for i in range(n):
        scan = scans[int(rng.integers(len(scans)))]
        rec = {
            "scan_id": scan, "chunk_index": i, "module": scan.rpartition("_")[0] or scan,
            "status": STATUSES[int(rng.integers(len(STATUSES)))],
            "worker_id": [None, "w0", "w1", "w2"][int(rng.integers(4))],
            "attempts": int(rng.integers(0, 4)),
        }
        if rng.random() < 0.7:
            rec["completed_at"] = 1700000000.0 + float(rng.integers(0, 10**6)) / 8
        if rng.random() < 0.5:
            perf = {"rows": int(rng.integers(0, 5000))}
            if rng.random() < 0.8:
                perf["device_s"] = float(rng.integers(0, 10**6)) / 1024
            if rng.random() < 0.8:
                perf["execute_s"] = float(rng.integers(1, 10**6)) / 512
            rec["perf"] = perf
        if scan.startswith("m-1") and rng.random() < 0.8:
            rec["monitor_id"], rec["monitor_epoch"] = "m-1", 3
        for key, values in (("tenant", [None, "t1", "t2"]), ("qos", [None, "interactive"]),
                            ("trace_id", [None, "abc"]), ("chunk_rows", [None, 16, 256])):
            rec[key] = values[int(rng.integers(len(values)))]
        if rng.random() < 0.2:
            rec["failure_history"] = [{"ts": 1.5, "worker_id": "w1", "status": "cmd failed"}]
        if rng.random() < 0.3:
            rec["some_future_field"] = "ignored"
        if rng.random() < 0.3:
            rec["job_id"] = f"{scan}_{i}"
        jobs[f"{scan}_{i}"] = rec
    return jobs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_job_wire_equals_jax(seed):
    """Each seeded record through ``Job.from_wire``: equal wires and JSON
    in both packages, and each package reads the other's JSON back to an
    equal job."""
    for rec in _job_dicts(seed, 40).values():
        t_job, j_job = t_dm.Job.from_wire(dict(rec)), j_dm.Job.from_wire(dict(rec))
        assert t_job.to_wire() == j_job.to_wire()
        assert t_job.to_json() == j_job.to_json()
        assert t_dm.Job.from_json(j_job.to_json()) == t_job
        assert j_dm.Job.from_json(t_job.to_json().encode()) == j_job
    kw = dict(trace_id="t", tenant="acme", qos="interactive", admitted_at=12.5,
              chunk_rows=7, monitor_id="m", monitor_epoch=2)
    assert t_dm.Job.create("s_1", 3, "mod", **kw).to_json() == j_dm.Job.create(
        "s_1", 3, "mod", **kw).to_json()
    assert [f.name for f in dataclasses.fields(t_dm.Job)] == [
        f.name for f in dataclasses.fields(j_dm.Job)]


@pytest.mark.parametrize("seed", [0, 1])
def test_worker_info_equals_jax(seed):
    rng = np.random.default_rng(seed)
    statuses = sorted(_constants(j_dm.WorkerStatus)[k] for k in
                      ("ACTIVE", "PENDING", "INACTIVE", "DRAINING", "PREEMPTED"))
    for i in range(30):
        payload = {"last_contact": None if rng.random() < 0.2 else float(rng.integers(0, 10**9)),
                   "polls_with_no_jobs": int(rng.integers(0, 100)),
                   "status": statuses[int(rng.integers(len(statuses)))]}
        if rng.random() < 0.3:
            payload["future"] = 1
        if rng.random() < 0.2:
            payload.pop("status")
        t_w = t_dm.WorkerInfo.from_wire(f"w{i}", dict(payload))
        j_w = j_dm.WorkerInfo.from_wire(f"w{i}", dict(payload))
        assert t_w.to_wire() == j_w.to_wire() and t_w.worker_id == j_w.worker_id
        assert t_dm.WorkerInfo.from_wire(f"w{i}", j_w.to_wire()) == t_w
    assert t_dm.ScanSummary("s").to_wire() == j_dm.ScanSummary("s").to_wire()


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 12), (2, 60), (3, 200)])
def test_rollup_scans_equals_jax(seed, n):
    """``rollup_scans`` over seeded job tables (and an empty one): the
    same summaries in the same order, key for key."""
    jobs = _job_dicts(seed, n)
    got = t_dm.rollup_scans({k: dict(v) for k, v in jobs.items()})
    want = j_dm.rollup_scans({k: dict(v) for k, v in jobs.items()})
    assert json.dumps(got) == json.dumps(want)
    assert got == want and len(got) >= 1
    assert t_dm.rollup_scans({}) == j_dm.rollup_scans({}) == []
