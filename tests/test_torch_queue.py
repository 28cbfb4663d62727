"""The port's job queue service (``swarm_tpu_torch/server/queue.py``)
against the JAX package's (``swarm_tpu/server/queue.py``), on the CPU.

Each case is a script over one package's ``JobQueueService``: it runs
once on each package, each on stores of its own, under one patched clock
(the queue's and the data model's ``time``: a ``FakeTime`` that moves
only when the script moves it, where the reference's tests sleep through
a lease). Then

- what the script saw (``next_job`` wires, ``update_job`` /
  ``renew_lease`` returns, recovery summaries, error texts) is equal;
- the state stores hold the same hashes and lists, and the blob stores
  the same keys with the same bytes (the journal's segments, snapshots
  and generation among them);
- ``statuses()``, ``jobs_by_state()``, ``jobs_by_tenant()`` and
  ``dead_letter_jobs()`` of the last service are equal;
- the ``swarm_queue_*``, ``swarm_job_phase_seconds``, ``swarm_journal_*``,
  ``swarm_gateway_latency_seconds`` and ``swarm_trace_flight_dumps_total``
  samples moved alike.

The scripts are the queue cases of ``tests/test_journal.py``,
``tests/test_durability.py`` (over its three state backends),
``tests/test_concurrency.py``, ``tests/test_qos.py``,
``tests/test_gateway.py`` and ``tests/test_resilience.py`` (the heartbeat
cases through a queue-backed client). Where threads race (the
concurrency cases, the fencing race) what each thread got is not
deterministic: there the outcomes and the final records, worker ids
aside, are compared. Last, each package's queue recovers the journal
that the other wrote to the state that the writer's own queue recovers.

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import inspect
import json
import re
import sys
import threading
import time
import types
from types import SimpleNamespace

import pytest

from test_real_store_adapters import _FakeRedisClient

import swarm_tpu.config as j_config
import swarm_tpu.datamodel as j_dm
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.resilience.heartbeat as j_heartbeat
import swarm_tpu.server.journal as j_journal
import swarm_tpu.server.queue as j_queue
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.datamodel as t_dm
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.resilience.heartbeat as t_heartbeat
import swarm_tpu_torch.server.journal as t_journal
import swarm_tpu_torch.server.queue as t_queue
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics

PKG = {
    "jax": SimpleNamespace(config=j_config, dm=j_dm, faults=j_faults, heartbeat=j_heartbeat,
                           journal=j_journal, queue=j_queue, stores=j_stores, metrics=j_metrics),
    "torch": SimpleNamespace(config=t_config, dm=t_dm, faults=t_faults, heartbeat=t_heartbeat,
                             journal=t_journal, queue=t_queue, stores=t_stores,
                             metrics=t_metrics),
}
SIDES = ("jax", "torch")
#: the metric families whose samples must move alike
FAMILIES = ("swarm_queue_", "swarm_job_phase_seconds", "swarm_journal_",
            "swarm_gateway_latency_seconds", "swarm_trace_flight_dumps_total")


# ---------------------------------------------------------------------------
# the copy


def _code(source: str) -> list:
    """A source's lines without its comment lines."""
    return [line for line in source.splitlines() if not line.strip().startswith("#")]


def test_copy_matches_its_original():
    """Every function and class of the queue module is the reference's
    code with the package name changed (comments aside), and its
    metric handles are the same families."""
    def own(module):
        return {name: obj for name, obj in vars(module).items()
                if (inspect.isfunction(obj) or inspect.isclass(obj))
                and obj.__module__ == module.__name__}

    mine, theirs = own(t_queue), own(j_queue)
    assert set(mine) == set(theirs) == {"JobQueueService"}
    for name, obj in theirs.items():
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert _code(inspect.getsource(mine[name])) == _code(want), name
    handles = {n for n, v in vars(j_queue).items()
               if n.startswith("_") and isinstance(v, j_metrics._Metric)}
    assert len(handles) == 10
    for n in handles:
        a, b = getattr(j_queue, n), getattr(t_queue, n)
        assert (a.name, a.kind, a.help, a.labelnames) == (b.name, b.kind, b.help, b.labelnames)


# ---------------------------------------------------------------------------
# the harness


class FakeTime:
    """The ``time`` module as the queue (and the tracing module) sees it:
    ``time()``, ``monotonic()`` and ``perf_counter()`` read a clock that
    moves only by :meth:`advance`."""

    T0 = 1_700_000_000.0

    def __init__(self):
        self.now = self.T0

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


class Env:
    """What a script gets: its package, the clock, and a factory of
    services over memory stores (each service it builds is kept; the
    last is the one whose views are compared)."""

    def __init__(self, side: str):
        self.side = side
        self.p = PKG[side]
        self.clock = FakeTime()
        self.services: list = []

    def config(self, **cfg_kw):
        return self.p.config.Config(**cfg_kw)

    def service(self, blobs=None, state=None, journal=None, fleet=None, docs=None, **cfg_kw):
        p = self.p
        svc = p.queue.JobQueueService(
            self.config(**cfg_kw), state if state is not None else p.stores.MemoryStateStore(),
            blobs if blobs is not None else p.stores.MemoryBlobStore(),
            docs if docs is not None else p.stores.MemoryDocStore(), fleet=fleet,
            journal=journal)
        self.services.append(svc)
        return svc

    def raises(self, exc, fn):
        """``fn()`` must raise ``exc``; → its text."""
        with pytest.raises(exc) as e:
            fn()
        return str(e.value)


def _samples(metrics) -> dict:
    """The samples of the compared families that both packages register
    (a process that imported the JAX server's app has its gauges too)."""
    both = set(j_metrics.REGISTRY._metrics) & set(t_metrics.REGISTRY._metrics)
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in metrics.parse_exposition(metrics.REGISTRY.render())
            if name.startswith(FAMILIES) and re.sub(r"_(bucket|sum|count)$", "", name) in both}


def _gauges(metrics) -> set:
    return {name for name, fam in metrics.REGISTRY._metrics.items() if fam.kind == "gauge"}


def _moved(metrics, before: dict, after: dict) -> dict:
    """Each gauge's value, and every other sample that moved."""
    gauges = _gauges(metrics)
    out = {}
    for key, value in after.items():
        if key[0] in gauges:
            out[key] = value
        elif value != before.get(key, 0.0):
            out[key] = value - before.get(key, 0.0)
    return out


def state_dump(state) -> dict:
    """Every non-empty hash and list of a memory or (fake) Redis store."""
    if hasattr(state, "_hashes"):
        hashes = {n: dict(h) for n, h in state._hashes.items() if h}
        lists = {n: list(q) for n, q in state._lists.items() if q}
    else:
        client = state._r
        hashes = {n: {k.decode(): v.decode() for k, v in h.items()}
                  for n, h in client.h.items() if h}
        lists = {n: [v.decode() for v in q] for n, q in client.l.items() if q}
    return {"hashes": hashes, "lists": lists}


def blob_dump(blobs) -> dict:
    return {key: blobs.get(key) for key in blobs.list("")}


def views(svc) -> dict:
    return {"statuses": svc.statuses(), "by_state": svc.jobs_by_state(),
            "by_tenant": svc.jobs_by_tenant(), "dead_letter": svc.dead_letter_jobs(),
            "depth": svc.queue_depth(), "generation": svc.generation,
            "recovery": svc.recovery_summary}


def run_side(case, side: str, monkeypatch) -> dict:
    env = Env(side)
    p = env.p
    monkeypatch.setattr(p.queue, "time", env.clock)
    monkeypatch.setattr(p.dm, "time", env.clock)
    p.faults.clear_plan()
    before = _samples(p.metrics)
    try:
        seen = case(env)
    finally:
        p.faults.clear_plan()
    moved = _moved(p.metrics, before, _samples(p.metrics))
    last = env.services[-1]
    return {"seen": seen, "state": state_dump(last.state), "blobs": blob_dump(last.blobs),
            "views": views(last), "moved": moved}


def run_case(case, monkeypatch) -> dict:
    out = {side: run_side(case, side, monkeypatch) for side in SIDES}
    for key in ("seen", "state", "blobs", "views", "moved"):
        assert out["torch"][key] == out["jax"][key], key
    return out


# ---------------------------------------------------------------------------
# tests/test_journal.py: the queue cases


def _queue(svc, scan_id, n, tenant=None):
    return svc.queue_scan({"module": "echo", "file_content": [f"row{i}\n" for i in range(n)],
                           "batch_size": 1, "scan_id": scan_id}, tenant=tenant)


def _jsvc(e, blobs=None, state=None, **cfg_kw):
    """``tests/test_journal.py``'s ``_service``."""
    cfg_kw.setdefault("lease_seconds", 5.0)
    return e.service(blobs=blobs, state=state, **cfg_kw)


def journal_append_before_ack_ordering(e):
    p = e.p
    log: list = []

    class SpyState(p.stores.MemoryStateStore):
        def hset(self, name, key, value):
            if name == "jobs":
                log.append(("store", key))
            super().hset(name, key, value)

    class SpyJournal(p.journal.QueueJournal):
        def append_many(self, records):
            for r in records:
                if r.get("op") == "job":
                    log.append(("journal", r["job"]["job_id"]))
            super().append_many(records)

    blobs = p.stores.MemoryBlobStore()
    svc = e.service(blobs=blobs, state=SpyState(), journal=SpyJournal(blobs), lease_seconds=5.0)
    _queue(svc, "ord_1", 3)
    job = svc.next_job("w1")
    out = [job, svc.update_job(job["job_id"], {"status": "executing", "worker_id": "w1"}),
           svc.renew_lease(job["job_id"], "w1"),
           svc.update_job(job["job_id"], {"status": "complete", "worker_id": "w1"})]
    assert log
    for i, (kind, job_id) in enumerate(log):
        if kind == "store":
            assert log[i - 1] == ("journal", job_id), log
    return out + [log]


def journal_failed_append_during_dispatch_restores_the_queue_list(e):
    p = e.p
    svc = _jsvc(e)
    _queue(svc, "dsp_1", 2)
    p.faults.install_plan("journal.append:1")
    err = e.raises(p.journal.JournalError, lambda: svc.next_job("w1"))
    p.faults.clear_plan()
    assert svc.queue_depth() == 2
    a, b = svc.next_job("w1"), svc.next_job("w1")
    assert (a["job_id"], b["job_id"]) == ("dsp_1_0", "dsp_1_1")
    return [err, a, b]


def journal_failed_append_during_requeue_keeps_lease_entry_for_retry(e):
    p = e.p
    svc = _jsvc(e, lease_seconds=0.01)
    _queue(svc, "rq_1", 1)
    job = svc.next_job("w1")
    e.clock.advance(0.05)  # the lease lapses
    p.faults.install_plan("journal.append:1")
    err = e.raises(p.journal.JournalError, lambda: svc.next_job("w2"))
    p.faults.clear_plan()
    assert svc.state.hget("leases", job["job_id"]) is not None
    redone = svc.next_job("w2")
    assert redone is not None and redone["job_id"] == job["job_id"]
    return [job, err, redone]


def journal_failed_append_during_worker_failure_retry_keeps_lease_entry(e):
    p = e.p
    svc = _jsvc(e, lease_seconds=0.01)
    _queue(svc, "wf_1", 1)
    job = svc.next_job("w1")
    p.faults.install_plan("journal.append:1")
    err = e.raises(p.journal.JournalError, lambda: svc.update_job(
        job["job_id"], {"status": "failed", "worker_id": "w1"}))
    p.faults.clear_plan()
    assert svc.state.hget("leases", job["job_id"]) is not None
    rec = json.loads(svc.state.hget("jobs", job["job_id"]))
    assert rec["status"] in p.dm.JobStatus.ACTIVE
    e.clock.advance(0.05)
    redone = svc.next_job("w2")
    assert redone is not None and redone["job_id"] == job["job_id"]
    return [job, err, rec, redone]


def journal_failed_append_during_complete_does_not_feed_the_tail(e):
    p = e.p
    svc = _jsvc(e)
    _queue(svc, "cm_1", 1)
    job = svc.next_job("w1")
    svc.put_output_chunk("cm_1", 0, b"out\n")
    p.faults.install_plan("journal.append:1")
    err = e.raises(p.journal.JournalError, lambda: svc.update_job(
        job["job_id"], {"status": "complete", "worker_id": "w1"}))
    p.faults.clear_plan()
    assert svc.latest_completed_job_id() is None
    assert json.loads(svc.state.hget("jobs", job["job_id"]))["status"] != "complete"
    ok = svc.update_job(job["job_id"], {"status": "complete", "worker_id": "w1"})
    assert ok
    tail = [svc.latest_completed_job_id(), svc.latest_completed_job_id()]
    assert tail == [job["job_id"], None]
    return [err, ok, tail]


def journal_reused_scan_id_stale_output_not_adopted_by_recovery(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    _queue(svc, "reuse_1", 1)
    job = svc.next_job("w1")
    svc.put_output_chunk("reuse_1", 0, b"monday-results\n")
    svc.update_job(job["job_id"], {"status": "complete", "worker_id": "w1"})
    svc.reset()
    _queue(svc, "reuse_1", 1)
    svc2 = _jsvc(e, blobs=blobs)
    rec = json.loads(svc2.state.hget("jobs", "reuse_1_0"))
    assert rec["status"] == "queued"
    assert svc2.recovery_summary["completed_from_store"] == 0
    again = svc2.next_job("w1")
    assert again["job_id"] == "reuse_1_0"
    return [rec, svc2.recovery_summary, again]


def journal_failed_append_means_mutation_never_happened(e):
    p = e.p
    blobs = p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    p.faults.install_plan("journal.append:1")
    err = e.raises(p.journal.JournalError, lambda: _queue(svc, "wal_1", 1))
    assert svc.state.hget("jobs", "wal_1_0") is None and svc.queue_depth() == 0
    svc2 = _jsvc(e, blobs=blobs)
    assert svc2.statuses()["jobs"] == {}
    return [err, svc2.recovery_summary]


def journal_recovery_rebuilds_tenant_queues_in_order(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    _queue(svc, "ta_1", 3, tenant="tA")
    _queue(svc, "tb_1", 2, tenant="tB")
    order_a = svc.state.lrange("job_queue:t:tA", 0, -1)
    svc2 = _jsvc(e, blobs=blobs)
    assert svc2.generation == 2
    assert svc2.tenants() == ["default", "tA", "tB"]
    assert svc2.state.lrange("job_queue:t:tA", 0, -1) == order_a
    assert svc2.tenant_depth("tB") == 2
    seen = []
    while True:
        job = svc2.next_job("w")
        if job is None:
            break
        seen.append(job)
    assert len({j["job_id"] for j in seen}) == 5
    return [order_a, svc2.recovery_summary, seen]


def journal_recovery_completes_jobs_whose_output_exists(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    _queue(svc, "rc_1", 2)
    job = svc.next_job("w1")
    svc.put_output_chunk("rc_1", int(job["chunk_index"]), b"done\n")
    svc2 = _jsvc(e, blobs=blobs)
    assert svc2.recovery_summary["completed_from_store"] == 1
    status = json.loads(svc2.state.hget("jobs", job["job_id"]))
    assert status["status"] == "complete"
    late = svc2.update_job(job["job_id"], {"status": "complete", "worker_id": "w1"})
    assert late is False and svc2.latest_completed_job_id() is None
    return [svc2.recovery_summary, status, late]


def journal_recovery_expires_leases_to_grace_and_keeps_fencing(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs, lease_seconds=100.0)
    _queue(svc, "lg_1", 1)
    job = svc.next_job("w1")
    before = e.clock.time()
    svc2 = _jsvc(e, blobs=blobs, lease_seconds=100.0)
    raw = json.loads(svc2.state.hget("jobs", job["job_id"]))
    assert raw["lease_expires_at"] <= before + 51.0 and raw["worker_id"] == "w1"
    mine, other = svc2.renew_lease(job["job_id"], "w1"), svc2.renew_lease(job["job_id"], "other")
    assert mine is not None and other is None
    return [raw, mine, other]


def journal_recovery_preserves_dead_letter_and_attempts(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs, max_attempts=1)
    _queue(svc, "dl_1", 1)
    job = svc.next_job("w1")
    svc.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "w1"})
    assert [d["job_id"] for d in svc.dead_letter_jobs()] == ["dl_1_0"]
    svc2 = _jsvc(e, blobs=blobs, max_attempts=1)
    [dead] = svc2.dead_letter_jobs()
    assert dead["job_id"] == "dl_1_0" and dead["failure_history"]
    assert svc2.recovery_summary["terminal"] == 1
    assert svc2.requeue_dead_letter("dl_1_0")
    again = svc2.next_job("w2")
    assert again["job_id"] == "dl_1_0"
    return [dead, svc2.recovery_summary, again]


def journal_reset_clears_journal_too(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    _queue(svc, "rs_1", 2)
    svc.reset()
    svc2 = _jsvc(e, blobs=blobs)
    assert svc2.recovery_summary is None and svc2.statuses()["jobs"] == {}
    assert svc2.generation == 2
    return [svc2.generation]


def journal_disabled_keeps_legacy_behavior(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs, journal_enabled=False)
    _queue(svc, "off_1", 2)
    assert svc.generation == 0 and blobs.list("_journal/") == []
    svc2 = _jsvc(e, blobs=blobs, journal_enabled=False)
    assert svc2.statuses()["jobs"] == {}
    return [svc.generation]


def journal_opportunistic_checkpoint_bounds_wal_growth(e):
    blobs = e.p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs, journal_compact_segments=8)
    _queue(svc, "cp_1", 20)
    assert svc._journal.segments_pending < 8 + 2 and blobs.list("_journal/snap/")
    svc2 = _jsvc(e, blobs=blobs, journal_compact_segments=8)
    assert svc2.recovery_summary["queued"] == 20 and svc2.queue_depth() == 20
    return [svc._journal.segments_pending, svc2.recovery_summary]


def journal_replay_fault_fails_boot_loudly(e):
    p = e.p
    blobs = p.stores.MemoryBlobStore()
    svc = _jsvc(e, blobs=blobs)
    _queue(svc, "rf_1", 1)
    p.faults.install_plan("journal.replay:1")
    err = e.raises(p.faults.FaultInjected, lambda: _jsvc(e, blobs=blobs))
    p.faults.clear_plan()
    svc2 = _jsvc(e, blobs=blobs)
    assert svc2.recovery_summary["queued"] == 1
    return [err, svc2.recovery_summary]


# ---------------------------------------------------------------------------
# tests/test_qos.py and tests/test_gateway.py: the queue cases


def _submit(svc, scan_id, lines=1, batch=1, tenant=None, qos=None):
    return svc.queue_scan({"module": "echo", "file_content": [f"t{i}\n" for i in range(lines)],
                           "batch_size": batch, "scan_id": scan_id}, tenant=tenant, qos=qos)


def qos_express_preempts_bulk_backlog(e):
    q = e.service()
    _submit(q, "flood_1", lines=20)
    _submit(q, "fast_1", qos="interactive")
    job = q.next_job("w0")
    assert job["scan_id"] == "fast_1" and job["qos"] == "interactive"
    return [job]


def qos_bulk_starvation_bounded(e):
    q = e.service(qos_express_burst=3)
    _submit(q, "flood_1", lines=4)
    _submit(q, "fast_1", lines=9, qos="interactive")
    jobs = [q.next_job("w") for _ in range(13)]
    order = [j["scan_id"] for j in jobs]
    assert order[:8] == ["fast_1"] * 3 + ["flood_1"] + ["fast_1"] * 3 + ["flood_1"], order
    assert order.count("flood_1") == 4
    return jobs


def qos_express_fair_across_tenants(e):
    q = e.service()
    _submit(q, "aa_1", lines=4, tenant="a", qos="interactive")
    _submit(q, "bb_1", lines=4, tenant="b", qos="interactive")
    jobs = [q.next_job("w") for _ in range(4)]
    order = [j["scan_id"] for j in jobs]
    assert order.count("aa_1") == 2 and order.count("bb_1") == 2
    return jobs


def qos_requeue_keeps_qos_class(e):
    q = e.service(lease_seconds=0.05, max_attempts=3, qos_express_burst=8)
    _submit(q, "ix_1", tenant="acme", qos="interactive")
    _submit(q, "bulkacme_1", lines=2, tenant="acme")
    job = q.next_job("dying")
    assert job["scan_id"] == "ix_1" and job["qos"] == "interactive"
    e.clock.advance(0.08)
    rejob = q.next_job("healthy")
    assert rejob["job_id"] == job["job_id"] and rejob["attempts"] == 2
    failed = q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "healthy"})
    assert failed and q.state.llen("job_queue:x:t:acme") == 1
    redo = q.next_job("w3")
    assert redo["job_id"] == job["job_id"] and redo["qos"] == "interactive"
    e.clock.advance(0.08)
    bulk = q.next_job("w4")
    assert bulk["scan_id"] == "bulkacme_1"
    raw = json.loads(q.state.hget("jobs", job["job_id"]))
    assert raw["status"] == e.p.dm.JobStatus.DEAD_LETTER
    assert q.requeue_dead_letter(job["job_id"]) and q.state.llen("job_queue:x:t:acme") == 1
    last = q.next_job("w5")
    assert last["qos"] == "interactive"
    return [job, rejob, failed, redo, bulk, raw, last]


def qos_recovery_preserves_qos_lane(e):
    q = e.service()
    _submit(q, "flood_1", lines=3)
    _submit(q, "fast_1", qos="interactive")
    q2 = e.service(blobs=q.blobs)
    assert q2.recovery_summary is not None and q2.state.llen("job_queue:x") == 1
    job = q2.next_job("w")
    assert job["scan_id"] == "fast_1" and job["qos"] == "interactive"
    return [q2.recovery_summary, job]


def qos_default_submission_wire_unchanged(e):
    q = e.service()
    _submit(q, "legacy_1", lines=2)
    assert q.state.llen("job_queue") == 2 and q.state.llen("job_queue:x") == 0
    raw = json.loads(q.state.hget("jobs", "legacy_1_0"))
    job = q.next_job("w")
    assert raw["qos"] is None and job["qos"] is None
    return [raw, job]


def gateway_fair_dequeue_no_tenant_starvation(e):
    q = e.service()
    _submit(q, "abusive_1", lines=50, tenant="abusive")
    _submit(q, "victim_1", lines=1, tenant="victim")
    served = [q.next_job(f"w{i}") for i in range(3)]
    assert "victim_1" in [j["scan_id"] for j in served]
    rest = []
    while True:
        job = q.next_job("w")
        if job is None:
            break
        rest.append(job["job_id"])
    assert len(rest) == 48
    return [served, rest]


def gateway_fair_dequeue_round_robin_interleaves(e):
    q = e.service()
    _submit(q, "aa_1", lines=4, tenant="a")
    _submit(q, "bb_1", lines=4, tenant="b")
    order = [q.next_job("w")["scan_id"] for _ in range(8)]
    assert order[:4].count("aa_1") == 2 and order[:4].count("bb_1") == 2
    return order


def gateway_requeue_preserves_tenant_queue(e):
    q = e.service(lease_seconds=0.1, max_attempts=3)
    _submit(q, "acmescan_1", tenant="acme")
    job = q.next_job("dying")
    assert job["tenant"] == "acme"
    e.clock.advance(0.15)
    rejob = q.next_job("healthy")
    assert rejob["job_id"] == job["job_id"] and rejob["attempts"] == 2
    assert q.state.llen("job_queue:t:acme") == 0
    zombie = q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "dying"})
    assert not zombie
    e.clock.advance(0.15)
    third = q.next_job("w3")
    e.clock.advance(0.15)
    assert third is not None and q.next_job("w4") is None
    raw = json.loads(q.state.hget("jobs", job["job_id"]))
    assert raw["status"] == e.p.dm.JobStatus.DEAD_LETTER
    assert q.requeue_dead_letter(job["job_id"]) and q.state.llen("job_queue:t:acme") == 1
    redo = q.next_job("w5")
    assert redo["attempts"] == 1 and redo["tenant"] == "acme"
    done = q.update_job(job["job_id"], {"status": "complete", "worker_id": "w5"})
    assert done and q.state.llen("completed") == 1
    return [job, rejob, zombie, third, raw, redo, done]


def gateway_worker_failure_retry_preserves_tenant_queue(e):
    q = e.service(max_attempts=3)
    _submit(q, "acmescan_2", tenant="acme")
    job = q.next_job("w1")
    ok = q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "w1"})
    assert ok and q.state.llen("job_queue:t:acme") == 1
    return [job, ok]


def gateway_jobs_by_tenant_snapshot(e):
    q = e.service()
    _submit(q, "aa_2", lines=2, tenant="a")
    _submit(q, "bb_2", lines=1, tenant="b")
    q.next_job("w")
    by_tenant = q.jobs_by_tenant()
    assert by_tenant["a"] == {"queued": 1, "in progress": 1} and by_tenant["b"] == {"queued": 1}
    assert q.statuses()["tenants"]["a"]["in progress"] == 1
    depths = q.tenant_depths()
    assert depths["a"] == 1 and depths["b"] == 1
    return [by_tenant, depths]


def gateway_default_tenant_keeps_reference_list(e):
    q = e.service()
    _submit(q, "legacy_1")
    assert q.state.llen("job_queue") == 1
    job = q.next_job("w")
    assert job["tenant"] == "default"
    return [job]


# ---------------------------------------------------------------------------
# tests/test_resilience.py: the queue cases and the heartbeat through the
# queue, and tests/test_concurrency.py's fenced zombie


def _queue_one(q, module="echo"):
    return q.queue_scan({"module": module, "file_content": ["t\n"], "batch_size": 1})


def resilience_renew_lease_extends_expiry(e):
    q = e.service(lease_seconds=5.0)
    _queue_one(q)
    job = q.next_job("w0")
    first = json.loads(q.state.hget("jobs", job["job_id"]))["lease_expires_at"]
    e.clock.advance(0.02)
    new_expiry = q.renew_lease(job["job_id"], "w0")
    assert new_expiry is not None and new_expiry > first
    assert float(q.state.hget("leases", job["job_id"])) == new_expiry
    return [job, first, new_expiry]


def resilience_renew_lease_rejected_for_requeued_or_foreign_job(e):
    q = e.service(lease_seconds=0.05, max_attempts=5)
    _queue_one(q)
    job = q.next_job("zombie")
    jid = job["job_id"]
    out = [job, q.renew_lease(jid, "someone-else")]
    e.clock.advance(0.08)
    rejob = q.next_job("healthy")
    assert rejob is not None and rejob["worker_id"] == "healthy"
    out += [rejob, q.renew_lease(jid, "zombie"), q.renew_lease(jid, "healthy")]
    q.update_job(jid, {"status": "complete", "worker_id": "healthy"})
    out += [q.renew_lease(jid, "healthy"), q.renew_lease("nope_0", "w")]
    assert out[1] is None and out[3] is None and out[4] is not None
    assert out[5] is None and out[6] is None
    return out


def resilience_job_dying_mid_execution_still_requeues(e):
    q = e.service(lease_seconds=0.05, max_attempts=5)
    _queue_one(q)
    job = q.next_job("doomed")
    jid = job["job_id"]
    ups = [q.update_job(jid, {"status": st, "worker_id": "doomed"})
           for st in ("starting", "downloading", "executing")]
    assert all(ups)
    e.clock.advance(0.08)
    rejob = q.next_job("rescuer")
    assert rejob["job_id"] == jid and rejob["worker_id"] == "rescuer"
    return [job, ups, rejob]


class QueueClient:
    """The heartbeat's client over a ``JobQueueService``
    (``tests/test_resilience.py``'s ``_QueueClientAdapter``), on the
    patched clock: each renewal first moves the clock by the heartbeat's
    interval. After ``pause_after`` renewals it sets ``paused`` and
    answers every later call with an error (the heartbeat counts it and
    ticks on), so both packages see the same number of renewals."""

    def __init__(self, q, clock, interval_s: float, pause_after: int = 10**9):
        self.q = q
        self.clock = clock
        self.interval_s = interval_s
        self.pause_after = pause_after
        self.calls = 0
        self.paused = threading.Event()

    def renew_lease(self, job_id, worker_id, saturation=None):
        self.calls += 1
        if self.calls > self.pause_after:
            raise ConnectionError("paused")
        self.clock.advance(self.interval_s)
        ok = self.q.renew_lease(job_id, worker_id) is not None
        if self.calls == self.pause_after:
            self.paused.set()
        return ok


def resilience_heartbeat_keeps_long_chunk_leased_and_stops_on_completion(e):
    q = e.service(lease_seconds=0.2, max_attempts=2)
    _queue_one(q)
    job = q.next_job("w0")
    jid = job["job_id"]
    client = QueueClient(q, e.clock, 0.05, pause_after=10)  # 0.5 s, past the raw lease
    hb = e.p.heartbeat.LeaseHeartbeat(client, jid, "w0", interval_s=0.05)
    with hb:
        assert client.paused.wait(10)
        thief = q.next_job("thief")
        assert thief is None and hb.renewals == 10 and hb.lease_ok
        done = q.update_job(jid, {"status": "complete", "worker_id": "w0"})
        assert done
    assert not hb.running
    n = hb.renewals
    time.sleep(0.12)
    assert hb.renewals == n == 10
    return [job, thief, done, n, hb.lease_ok]


def resilience_heartbeat_stops_itself_when_lease_is_no_longer_ours(e):
    q = e.service(lease_seconds=0.05, max_attempts=5)
    _queue_one(q)
    job = q.next_job("zombie")
    e.clock.advance(0.08)
    healthy = q.next_job("healthy")
    assert healthy is not None
    hb = e.p.heartbeat.LeaseHeartbeat(QueueClient(q, e.clock, 0.05), job["job_id"], "zombie",
                                      interval_s=0.05)
    hb.start()
    hb._thread.join(timeout=5)
    assert not hb.running and not hb.lease_ok and hb.renewals == 0
    hb.stop()
    return [job, healthy, hb.lease_ok]


def resilience_worker_reported_failures_requeue_then_quarantine(e):
    q = e.service(max_attempts=3)
    _queue_one(q)
    JobStatus = e.p.dm.JobStatus
    statuses = [JobStatus.CMD_FAILED, JobStatus.UPLOAD_FAILED_UNKNOWN, JobStatus.CMD_FAILED]
    out, jid = [], None
    for i, st in enumerate(statuses, start=1):
        job = q.next_job(f"w{i}")
        assert job["attempts"] == i
        jid = job["job_id"]
        out += [job, q.update_job(jid, {"status": st, "worker_id": f"w{i}"})]
    assert q.next_job("w-last") is None
    [rec] = q.dead_letter_jobs()
    assert rec["job_id"] == jid and [f["status"] for f in rec["failure_history"]] == statuses
    assert q.jobs_by_state()[JobStatus.DEAD_LETTER] == 1
    assert q.requeue_dead_letter(jid) and not q.requeue_dead_letter(jid)
    job = q.next_job("w-re")
    assert job["attempts"] == 1 and len(job["failure_history"]) == 3
    return out + [rec, job]


def resilience_retry_failed_off_preserves_reference_terminal_behavior(e):
    q = e.service(retry_failed=False)
    _queue_one(q)
    job = q.next_job("w0")
    ok = q.update_job(job["job_id"], {"status": "cmd failed", "worker_id": "w0"})
    rec = json.loads(q.state.hget("jobs", job["job_id"]))
    assert ok and rec["status"] == "cmd failed"
    return [job, rec]


def resilience_drain_worker_refuses_dispatch_and_deregister_requeues_once(e):
    q = e.service(lease_seconds=30.0, max_attempts=5)
    _queue_one(q)
    job = q.next_job("pre")
    jid = job["job_id"]
    assert q.drain_worker("pre", reason="preempted") and not q.drain_worker("pre")
    assert q.drain_reason("pre") == "preempted" and q.next_job("pre") is None
    st = q.statuses()
    assert st["workers"]["pre"]["status"] == "preempted" and st["draining"] == {"pre": "preempted"}
    out = q.deregister_worker("pre")
    assert out == {"requeued": 1, "was_draining": True} and q.drain_reason("pre") is None
    rejob = q.next_job("healthy")
    assert rejob["job_id"] == jid and q.next_job("second") is None
    stale = q.update_job(jid, {"status": "complete", "worker_id": "pre"})
    done = q.update_job(jid, {"status": "complete", "worker_id": "healthy"})
    assert not stale and done
    return [job, out, rejob, stale, done]


def resilience_lease_expiry_wins_drain_race_still_exactly_one_requeue(e):
    q = e.service(lease_seconds=0.05, max_attempts=5)
    _queue_one(q)
    job = q.next_job("pre")
    jid = job["job_id"]
    q.drain_worker("pre", reason="preempted")
    e.clock.advance(0.08)
    rejob = q.next_job("healthy")
    assert rejob["job_id"] == jid
    out = q.deregister_worker("pre")
    assert out == {"requeued": 0, "was_draining": True}
    stale = q.update_job(jid, {"status": "complete", "worker_id": "pre"})
    done = q.update_job(jid, {"status": "complete", "worker_id": "healthy"})
    assert not stale and done
    return [job, rejob, out, stale, done]


def resilience_drain_set_survives_journal_recovery_until_deregister(e):
    blobs = e.p.stores.MemoryBlobStore()
    q = e.service(blobs=blobs, lease_seconds=5.0)
    _queue_one(q)
    assert q.next_job("pre") is not None
    q.drain_worker("pre", reason="preempted")
    q2 = e.service(blobs=blobs, lease_seconds=5.0)
    assert q2.drain_reason("pre") == "preempted" and q2.next_job("pre") is None
    out = q2.deregister_worker("pre")
    assert out["was_draining"]
    q3 = e.service(blobs=blobs, lease_seconds=5.0)
    assert q3.drain_reason("pre") is None
    return [q2.recovery_summary, out, q3.recovery_summary]


def resilience_injected_fleet_preempt_gated_on_preemptible_fleet(e):
    e.p.faults.install_plan("fleet.preempt:1")
    q_null = e.service()
    _queue_one(q_null)
    first = q_null.next_job("w-null")
    assert first is not None and q_null.draining_workers() == {}

    class PreemptibleFleet:
        def preempt(self, name):
            return True

    q = e.service(fleet=PreemptibleFleet(), lease_seconds=5.0)
    _queue_one(q)
    polled = q.next_job("w-sim")
    assert polled is None and q.draining_workers() == {"w-sim": "preempted"}
    return [first, polled]


def concurrency_zombie_worker_fenced_after_requeue(e):
    q = e.service(api_key="k", lease_seconds=0.05, max_attempts=5)
    q.queue_scan({"module": "echo", "file_content": ["h0.example\n"], "batch_size": 1,
                  "scan_id": "echo_1000"})
    job = q.next_job("zombie")
    jid = job["job_id"]
    e.clock.advance(0.08)
    job2 = q.next_job("healthy")
    assert job2["job_id"] == jid
    out = [q.update_job(jid, {"status": "complete", "worker_id": "zombie"}),
           q.update_job(jid, {"status": "complete", "worker_id": "healthy"}),
           q.update_job(jid, {"status": "cmd failed", "worker_id": "healthy"})]
    assert out == [False, True, False]
    return [job, job2, out]


CASES = [v for k, v in list(globals().items())
         if k.startswith(("journal_", "qos_", "gateway_", "resilience_", "concurrency_"))
         and callable(v)]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_queue_case_equals_jax(case, monkeypatch):
    run_case(case, monkeypatch)


def test_cases_cover_the_reference_scripts():
    assert len(CASES) == 15 + 6 + 6 + 11 + 1


# ---------------------------------------------------------------------------
# tests/test_durability.py, over its state backends


BACKENDS = ("memory", "fakeredis", "fakeredis-surviving")


def _make_state(p, kind: str, monkeypatch):
    """``tests/test_durability.py``'s ``backend`` fixture for package
    ``p``: a factory of state stores."""
    if kind == "memory":
        return p.stores.MemoryStateStore

    def redis_store(client):
        mod = types.ModuleType("redis")
        mod.Redis = types.SimpleNamespace(from_url=lambda url: client)
        monkeypatch.setitem(sys.modules, "redis", mod)
        return p.stores.RedisStateStore("redis://fake:6379/0")

    if kind == "fakeredis":
        return lambda: redis_store(_FakeRedisClient())
    client = _FakeRedisClient()
    return lambda: redis_store(client)


def _dsvc(e, state, blobs, **cfg_kw):
    cfg_kw.setdefault("lease_seconds", 5.0)
    cfg_kw.setdefault("max_attempts", 2)
    return e.service(blobs=blobs, state=state, **cfg_kw)


def _drive(e, svc) -> list:
    """``tests/test_durability.py``'s ``_drive``: two tenants'
    submissions, dispatch, a status walk, a requeue on failure, a dead
    letter and a completion, each step tolerating the armed journal
    fault. → what each step returned or raised."""
    seen = []

    def step(fn):
        try:
            seen.append(fn())
        except e.p.journal.JournalError as err:
            seen.append(["JournalError", str(err)])

    step(lambda: svc.queue_scan({"module": "echo", "file_content": [f"r{i}\n" for i in range(4)],
                                 "batch_size": 1, "scan_id": "dur_1"}, tenant="tA"))
    step(lambda: svc.queue_scan({"module": "echo", "file_content": ["x\n", "y\n"],
                                 "batch_size": 1, "scan_id": "dur_2"}, tenant="tB"))
    leased = []

    def dispatch():
        job = svc.next_job("w1")
        if job:
            leased.append(job["job_id"])
        return job

    step(dispatch)
    step(dispatch)
    if leased:
        jid = leased[0]
        step(lambda: svc.update_job(jid, {"status": "executing", "worker_id": "w1"}))
        step(lambda: svc.update_job(jid, {"status": "cmd failed", "worker_id": "w1"}))
    if len(leased) > 1:
        jid2 = leased[1]
        step(lambda: svc.update_job(jid2, {"status": "cmd failed", "worker_id": "w1"}))

        def redispatch_and_fail():
            job = svc.next_job("w1")
            if job and job["job_id"] == jid2:
                return [job, svc.update_job(jid2, {"status": "cmd failed", "worker_id": "w1"})]
            if job:
                leased.append(job["job_id"])
            return job

        step(redispatch_and_fail)

    def complete_one():
        job = svc.next_job("w2")
        if job:
            svc.put_output_chunk(job["scan_id"], int(job["chunk_index"]), b"ok\n")
            return [job, svc.update_job(job["job_id"], {"status": "complete", "worker_id": "w2"})]
        return job

    step(complete_one)
    return seen


def _consistent(e, svc) -> list:
    """``tests/test_durability.py``'s ``_assert_consistent``; → the jobs
    its liveness drain dispatched."""
    JobStatus = e.p.dm.JobStatus
    jobs = svc.statuses()["jobs"]
    for rec in jobs.values():
        assert rec.get("status") in JobStatus.ALL
    list_ids = []
    for name in svc._queue_names():
        ids = svc.state.lrange(name, 0, -1)
        list_ids.extend(ids)
        for job_id in ids:
            assert jobs[job_id]["status"] == JobStatus.QUEUED
            assert name == svc._queue_list(jobs[job_id].get("tenant") or "default")
    assert len(list_ids) == len(set(list_ids))
    queued = {j for j, r in jobs.items() if r["status"] == JobStatus.QUEUED}
    assert set(list_ids) == queued
    active = {j for j, r in jobs.items() if r["status"] in JobStatus.ACTIVE}
    assert set(svc.state.hgetall("leases")) == active
    drained = []
    while True:
        job = svc.next_job("drain")
        if job is None:
            break
        drained.append(job)
    assert {j["job_id"] for j in drained} == queued
    return drained


APPEND_FAULT_INDICES = (1, 3, 6, 9, 12, 15)


def test_durability_fault_index_space_covers_the_drive(monkeypatch):
    def case(e):
        svc = _dsvc(e, e.p.stores.MemoryStateStore(), e.p.stores.MemoryBlobStore())
        seen = _drive(e, svc)
        assert svc._journal.segments_pending >= max(APPEND_FAULT_INDICES)
        return [seen, svc._journal.segments_pending]

    run_case(case, monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("index", APPEND_FAULT_INDICES)
def test_durability_interrupted_append_equals_jax(backend, index, monkeypatch):
    def case(e):
        make = _make_state(e.p, backend, monkeypatch)
        blobs = e.p.stores.MemoryBlobStore()
        svc = _dsvc(e, make(), blobs)
        e.p.faults.install_plan(f"journal.append:{index}")
        seen = _drive(e, svc)
        e.p.faults.clear_plan()
        recovered = _dsvc(e, make(), blobs)
        return [seen, recovered.recovery_summary, _consistent(e, recovered)]

    run_case(case, monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_durability_interrupted_compact_equals_jax(backend, monkeypatch):
    def case(e):
        make = _make_state(e.p, backend, monkeypatch)
        blobs = e.p.stores.MemoryBlobStore()
        svc = _dsvc(e, make(), blobs, journal_compact_segments=4)
        e.p.faults.install_plan("journal.compact:*")
        seen = _drive(e, svc)
        e.p.faults.clear_plan()
        assert blobs.list("_journal/snap/") == []
        recovered = _dsvc(e, make(), blobs, journal_compact_segments=4)
        return [seen, recovered.recovery_summary, _consistent(e, recovered)]

    run_case(case, monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_durability_interrupted_replay_then_clean_boot_equals_jax(backend, monkeypatch):
    def case(e):
        make = _make_state(e.p, backend, monkeypatch)
        blobs = e.p.stores.MemoryBlobStore()
        seen = _drive(e, _dsvc(e, make(), blobs))
        e.p.faults.install_plan("journal.replay:1")
        err = e.raises(e.p.faults.FaultInjected, lambda: _dsvc(e, make(), blobs))
        e.p.faults.clear_plan()
        recovered = _dsvc(e, make(), blobs)
        return [seen, err, recovered.recovery_summary, _consistent(e, recovered)]

    run_case(case, monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_durability_fault_free_recovery_equals_jax(backend, monkeypatch):
    def case(e):
        JobStatus = e.p.dm.JobStatus
        make = _make_state(e.p, backend, monkeypatch)
        blobs = e.p.stores.MemoryBlobStore()
        svc = _dsvc(e, make(), blobs)
        seen = _drive(e, svc)
        pre = svc.statuses()["jobs"]
        recovered = _dsvc(e, make(), blobs)
        post = recovered.statuses()["jobs"]
        assert set(post) == set(pre)
        for job_id, rec in pre.items():
            if rec["status"] in JobStatus.TERMINAL:
                assert post[job_id]["status"] == rec["status"]
                assert post[job_id]["attempts"] == rec["attempts"]
        return [seen, pre, post, recovered.recovery_summary, _consistent(e, recovered)]

    run_case(case, monkeypatch)


# ---------------------------------------------------------------------------
# the racing cases: tests/test_concurrency.py and the fencing race


def _without_workers(jobs: dict) -> dict:
    """Job records with what depends on which thread won taken out."""
    drop = ("worker_id", "failure_history")
    return {jid: {k: v for k, v in rec.items() if k not in drop} for jid, rec in jobs.items()}


def _race(run, monkeypatch) -> dict:
    out = {}
    for side in SIDES:
        e = Env(side)
        monkeypatch.setattr(e.p.queue, "time", e.clock)
        monkeypatch.setattr(e.p.dm, "time", e.clock)
        before = _samples(e.p.metrics)
        seen = run(e)
        # the journal's appends count every racing update that landed
        moved = {k: v for k, v in _moved(e.p.metrics, before, _samples(e.p.metrics)).items()
                 if not k[0].startswith("swarm_journal_")}
        svc = e.services[-1]
        st = svc.statuses()
        scans = [{k: v for k, v in scan.items() if k != "workers"} for scan in st["scans"]]
        out[side] = {"seen": seen, "jobs": _without_workers(st["jobs"]), "scans": scans,
                     "by_state": svc.jobs_by_state(), "moved": moved}
    for key in ("seen", "jobs", "scans", "by_state", "moved"):
        assert out["torch"][key] == out["jax"][key], key
    return out


def test_concurrency_exactly_once_dispatch_equals_jax(monkeypatch):
    def run(e):
        q = e.service(api_key="k")
        q.queue_scan({"module": "echo", "file_content": [f"h{i}.example\n" for i in range(64)],
                      "batch_size": 1, "scan_id": "echo_1000"})
        got, lock, start = [], threading.Lock(), threading.Barrier(8)

        def worker(wid):
            start.wait()
            while True:
                job = q.next_job(wid)
                if job is None:
                    return
                with lock:
                    got.append(job["job_id"])

        threads = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(got) == 64 == len(set(got))
        return sorted(got)

    _race(run, monkeypatch)


def test_concurrency_concurrent_updates_and_rollup_equals_jax(monkeypatch):
    def run(e):
        q = e.service(api_key="k")
        q.queue_scan({"module": "echo", "file_content": [f"h{i}.example\n" for i in range(32)],
                      "batch_size": 1, "scan_id": "echo_1000"})
        stop, errors = threading.Event(), []

        def reader():
            while not stop.is_set():
                try:
                    q.statuses()
                except Exception as err:
                    errors.append(err)
                    return

        def worker(wid):
            try:
                while True:
                    job = q.next_job(wid)
                    if job is None:
                        return
                    jid = job["job_id"]
                    for st in ("starting", "downloading", "executing", "uploading"):
                        assert q.update_job(jid, {"status": st, "worker_id": wid})
                    q.put_output_chunk(job["scan_id"], int(job["chunk_index"]), b"done\n")
                    assert q.update_job(jid, {"status": "complete", "worker_id": wid})
            except Exception as err:
                errors.append(err)

        r = threading.Thread(target=reader)
        r.start()
        threads = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        r.join(timeout=10)
        assert not errors, errors
        st = q.statuses()
        [scan] = [s for s in st["scans"] if s["scan_id"] == "echo_1000"]
        assert scan["percent_complete"] == 100 and len(st["jobs"]) == 32
        return {k: v for k, v in scan.items() if k != "workers"}

    _race(run, monkeypatch)


def test_fencing_race_zombie_cannot_complete_equals_jax(monkeypatch):
    """``tests/test_resilience.py``'s fencing race: a zombie spams fenced
    updates while its lease lapses (on the patched clock) and the job
    is re-leased; every zombie write that started after the re-lease
    bounces, and the new assignee owns the job."""
    def run(e):
        q = e.service(lease_seconds=0.03, max_attempts=10_000)
        _queue_one(q)
        job = q.next_job("zombie")
        jid = job["job_id"]
        stop, releases, wins_after, spins = threading.Event(), [], [], [0]

        def zombie():
            while not stop.is_set():
                released = bool(releases)
                ok = q.update_job(jid, {"status": "executing", "worker_id": "zombie"})
                spins[0] += 1
                if ok and released:
                    wins_after.append(1)

        t = threading.Thread(target=zombie, daemon=True)
        t.start()
        try:
            while spins[0] < 20:
                time.sleep(0.001)
            e.clock.advance(0.05)  # the lease lapses
            rejob = q.next_job("healthy")
            releases.append(1)
            assert rejob is not None and rejob["worker_id"] == "healthy"
            n = spins[0]
            while spins[0] < n + 20:
                time.sleep(0.001)
        finally:
            stop.set()
            t.join(timeout=5)
        assert not wins_after
        out = [q.update_job(jid, {"status": "complete", "worker_id": "zombie"}),
               q.update_job(jid, {"status": "complete", "worker_id": "healthy"})]
        assert out == [False, True]
        rec = json.loads(q.state.hget("jobs", jid))
        assert rec["status"] == "complete" and rec["worker_id"] == "healthy"
        return [out, rejob["job_id"], rejob["attempts"]]

    _race(run, monkeypatch)


# ---------------------------------------------------------------------------
# each package's queue recovers the other's journal


def _mixed_script(e, svc):
    """A journal with every record kind: tenants, both lanes, a lease,
    a failure, a dead letter, a completion, a drain, a monitor spec
    and a fired epoch."""
    _submit(svc, "mix_1", lines=5, tenant="acme")
    _submit(svc, "mixx_1", lines=2, tenant="acme", qos="interactive")
    _submit(svc, "mixd_1", lines=1)
    a = svc.next_job("w1")
    svc.update_job(a["job_id"], {"status": "executing", "worker_id": "w1"})
    b = svc.next_job("w2")
    svc.put_output_chunk(b["scan_id"], int(b["chunk_index"]), b"out\n")
    svc.update_job(b["job_id"], {"status": "complete", "worker_id": "w2"})
    c = svc.next_job("w3")
    svc.update_job(c["job_id"], {"status": "cmd failed", "worker_id": "w3"})
    svc.drain_worker("w1", reason="drain")
    spec = {"monitor_id": "mon1", "module": "echo", "targets": ["a", "b", "c"],
            "interval_s": 60.0, "batch_size": 2, "epoch": 0}
    svc.put_monitor(spec)
    svc.fire_monitor_epoch(spec, "mon1_1700000060", 1, cached_outputs={0: b"cached\n"})
    e.clock.advance(7.0)
    svc.next_job("w4")


@pytest.mark.parametrize("writer", SIDES)
def test_each_queue_recovers_the_others_journal(writer, monkeypatch):
    """The writer's queue runs :func:`_mixed_script` with the journal on
    (``max_attempts=1``: the failure dead-letters); then each package's
    queue boots over a copy of its blob store, on a fresh state store
    and the same clock: equal recovery summaries, state, views, and
    what a first dispatch hands out."""
    env = Env(writer)
    for side in SIDES:
        monkeypatch.setattr(PKG[side].queue, "time", env.clock)
        monkeypatch.setattr(PKG[side].dm, "time", env.clock)
    svc = env.service(max_attempts=1, lease_seconds=30.0)
    _mixed_script(env, svc)
    written = blob_dump(svc.blobs)
    assert any(k.startswith("_journal/") for k in written)
    got = {}
    for reader in SIDES:
        p = PKG[reader]
        blobs = p.stores.MemoryBlobStore()
        for key, value in written.items():
            blobs.put(key, value)
        e = Env(reader)
        e.clock = env.clock
        q = e.service(blobs=blobs, max_attempts=1, lease_seconds=30.0)
        got[reader] = {"summary": q.recovery_summary, "state": state_dump(q.state),
                       "views": views(q), "monitors": q.list_monitors(),
                       "draining": q.draining_workers(), "next": q.next_job("w9"),
                       "blobs": blob_dump(q.blobs)}
    assert got["torch"] == got[writer if writer == "jax" else "jax"]
    assert got["torch"]["summary"]["queued"] >= 1 and got["torch"]["monitors"]
