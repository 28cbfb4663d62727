"""Core data model: scans, jobs, chunks, workers — the port's copy of
``swarm_tpu/datamodel.py``, wire-identical to it.

Identifier formats and the status taxonomy follow the reference wire
protocol so the reference client works against this server unchanged:

- scan ids are ``<module>_<unix-ts>`` (reference ``server/server.py:181-183``)
- job ids are ``<scan_id>_<chunk_index>`` (reference ``server/server.py:441``)
- job statuses walk ``queued → in progress → starting → downloading →
  executing → uploading → complete`` with terminal failure statuses
  ``cmd failed`` / ``upload failed - *`` (reference ``server/server.py:454,485``,
  ``worker/worker.py:61-108``).

On top of the reference's model this adds *leases*: a dispatched job
carries a lease deadline and is requeued when the lease expires without
a state transition.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Any, Iterator, Optional

# Scan ids flow into filesystem paths and {input}/{output} command
# substitution on both server and worker — one shared rule so the two
# validation sites cannot drift.
SCAN_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


class JobStatus:
    """Status taxonomy, wire-identical to the reference."""

    QUEUED = "queued"
    IN_PROGRESS = "in progress"
    STARTING = "starting"
    DOWNLOADING = "downloading"
    EXECUTING = "executing"
    UPLOADING = "uploading"
    COMPLETE = "complete"
    CMD_FAILED = "cmd failed"
    UPLOAD_FAILED_NOT_FOUND = "upload failed - file not found"
    UPLOAD_FAILED_CREDENTIALS = "upload failed - credentials"
    UPLOAD_FAILED_UNKNOWN = "upload failed - unknown"
    # Quarantine (new vs reference): a job that exhausted max_attempts
    # parks here WITH its failure history instead of silently going
    # terminal-failed. Operators inspect/requeue via `swarm dead-letter`.
    DEAD_LETTER = "dead letter"

    TERMINAL = frozenset(
        {
            COMPLETE,
            CMD_FAILED,
            UPLOAD_FAILED_NOT_FOUND,
            UPLOAD_FAILED_CREDENTIALS,
            UPLOAD_FAILED_UNKNOWN,
            DEAD_LETTER,
        }
    )
    FAILED = frozenset(TERMINAL - {COMPLETE})
    # leased statuses: dispatched and not yet terminal — lease
    # enforcement must cover ALL of these (a worker dying mid-execute
    # leaves the job in "executing", not "in progress")
    ACTIVE = frozenset(
        {IN_PROGRESS, STARTING, DOWNLOADING, EXECUTING, UPLOADING}
    )
    ALL = frozenset(
        {
            QUEUED,
            IN_PROGRESS,
            STARTING,
            DOWNLOADING,
            EXECUTING,
            UPLOADING,
        }
        | TERMINAL
    )


class WorkerStatus:
    """Worker liveness states (reference ``server/server.py:489-507``).

    ``draining``/``preempted`` are additions for the elastic fleet
    (docs/RESILIENCE.md §Preemption): a draining worker finishes its
    current lease but is offered no new jobs; a preempted worker is a
    draining worker whose drain was initiated by a provider preemption
    notice. Both deregister (or lapse) into ``inactive``.
    """

    ACTIVE = "active"
    PENDING = "pending"
    INACTIVE = "inactive"
    DRAINING = "draining"
    PREEMPTED = "preempted"

    #: states the queue must not offer new jobs to
    NO_DISPATCH = frozenset({DRAINING, PREEMPTED})


def generate_scan_id(module: str, timestamp: Optional[int] = None) -> str:
    """``<module>_<unix-ts>`` — reference ``server/server.py:181-183``."""
    ts = int(time.time()) if timestamp is None else int(timestamp)
    return f"{module}_{ts}"


def job_id_for(scan_id: str, chunk_index: int) -> str:
    """``<scan_id>_<chunk_index>`` — reference ``server/server.py:441``."""
    return f"{scan_id}_{chunk_index}"


def parse_job_id(job_id: str) -> tuple[str, int]:
    """Split a job id back into ``(scan_id, chunk_index)``.

    The reference client splits on ``_`` and assumes exactly three parts
    (``client/swarm:58-63``); this version is robust to modules whose
    names themselves contain underscores by splitting from the right.
    """
    scan_id, _, idx = job_id.rpartition("_")
    return scan_id, int(idx)


def parse_scan_id(scan_id: str) -> tuple[str, int]:
    """Split ``<module>_<ts>`` into ``(module, started_ts)``."""
    module, _, ts = scan_id.rpartition("_")
    return module, int(ts)


def chunk_input_key(scan_id: str, chunk_index: int) -> str:
    """Blob key for an input chunk (reference ``server/server.py:446``)."""
    return f"{scan_id}/input/chunk_{chunk_index}.txt"


def chunk_output_key(scan_id: str, chunk_index: int) -> str:
    """Blob key for an output chunk (reference ``worker/worker.py:96``)."""
    return f"{scan_id}/output/chunk_{chunk_index}.txt"


def chunk_generator(sequence: list, batch_size: int) -> Iterator[list]:
    """Split a target list into fixed-size chunks.

    Mirrors reference ``server/server.py:185-187``; a chunk is the unit
    of dispatch, checkpointing and (on the device path) sharding.
    ``batch_size <= 0`` means one whole-sequence chunk (the reference
    normalizes 0 the same way in ``server/server.py:434-435``).
    """
    batch_size = int(batch_size)
    if batch_size <= 0:
        batch_size = max(1, len(sequence))
    for i in range(0, len(sequence), batch_size):
        yield sequence[i : i + batch_size]


@dataclasses.dataclass
class Job:
    """One chunk of a scan, dispatched to exactly one worker at a time.

    Field names match the reference's Redis job hash payload
    (``server/server.py:198-205``) so serialized jobs are wire-identical;
    ``lease_expires_at`` is an addition (absent fields are simply extra
    keys to the reference client, which ignores unknown keys).
    """

    job_id: str
    scan_id: str
    chunk_index: int
    module: str
    status: str = JobStatus.QUEUED
    worker_id: Optional[str] = None
    started_at: Optional[float] = None
    completed_at: Optional[float] = None
    lease_expires_at: Optional[float] = None
    attempts: int = 0
    # per-job performance sample reported by the worker on completion
    # (download/execute/upload seconds, device rows + seconds — SURVEY.md
    # §5 "tracing": timing exported through the same status API fields).
    # Extra key to the reference client, which ignores unknown fields.
    perf: Optional[dict] = None
    # scan-scoped correlation ID (telemetry.events): minted by the
    # client, carried via the X-Swarm-Trace header into /queue, stored
    # here, and handed back out through /get-job so every layer's event
    # lines for one scan share it. Extra wire key to the reference.
    trace_id: Optional[str] = None
    # failure provenance: one entry per failed attempt / lease expiry
    # ({ts, worker_id, status}), carried into the dead-letter state so
    # quarantined jobs explain themselves. Extra wire key.
    failure_history: Optional[list] = None
    # submitting tenant (gateway PR, docs/GATEWAY.md): None = the
    # default tenant — reference submissions carry no tenant header and
    # land there, so legacy job records round-trip unchanged. Extra
    # wire key the reference client ignores.
    tenant: Optional[str] = None
    # latency class (docs/GATEWAY.md §QoS): None = bulk, the reference
    # wire behavior — submissions without X-Swarm-QoS land here and the
    # record round-trips unchanged. "interactive" rides the express
    # dispatch lane and the scheduler's deadline-flush path. Extra wire
    # key the reference client ignores.
    qos: Optional[str] = None
    # gateway admission stamp (time.time() at queue_scan): the
    # admission-to-verdict latency histograms subtract this from
    # completed_at per QoS class. Extra wire key.
    admitted_at: Optional[float] = None
    # target-line count of this job's input chunk (stamped at
    # submission): the gateway cache's writeback hook reads it to skip
    # over-bound bulk chunks without fetching the blob. Extra wire key.
    chunk_rows: Optional[int] = None
    # standing-monitor provenance (docs/MONITORING.md): jobs fired by
    # a monitor epoch carry the spec id and epoch number so `swarm
    # scans` / /get-statuses can attribute a scan to its monitor. None
    # on every one-shot submission — the reference wire contract is
    # byte-preserved when absent (extra always-present-None keys, the
    # same pattern as tenant/qos). Extra wire keys the reference
    # client ignores.
    monitor_id: Optional[str] = None
    monitor_epoch: Optional[int] = None

    @classmethod
    def create(
        cls,
        scan_id: str,
        chunk_index: int,
        module: str,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
        admitted_at: Optional[float] = None,
        chunk_rows: Optional[int] = None,
        monitor_id: Optional[str] = None,
        monitor_epoch: Optional[int] = None,
    ) -> "Job":
        return cls(
            job_id=job_id_for(scan_id, chunk_index),
            scan_id=scan_id,
            chunk_index=chunk_index,
            module=module,
            trace_id=trace_id,
            tenant=tenant,
            qos=qos,
            admitted_at=admitted_at,
            chunk_rows=chunk_rows,
            monitor_id=monitor_id,
            monitor_epoch=monitor_epoch,
        )

    def to_wire(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, payload: dict[str, Any]) -> "Job":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in payload.items() if k in fields}
        known.setdefault("job_id", job_id_for(payload["scan_id"], payload["chunk_index"]))
        return cls(**known)

    def to_json(self) -> str:
        return json.dumps(self.to_wire())

    @classmethod
    def from_json(cls, blob: str | bytes) -> "Job":
        return cls.from_wire(json.loads(blob))


@dataclasses.dataclass
class WorkerInfo:
    """Per-worker liveness record (reference ``server/server.py:471-508``)."""

    worker_id: str
    last_contact: Optional[float] = None
    polls_with_no_jobs: int = 0
    status: str = WorkerStatus.ACTIVE

    def to_wire(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("worker_id")
        return d

    @classmethod
    def from_wire(cls, worker_id: str, payload: dict[str, Any]) -> "WorkerInfo":
        fields = {f.name for f in dataclasses.fields(cls)} - {"worker_id"}
        return cls(worker_id=worker_id, **{k: v for k, v in payload.items() if k in fields})


@dataclasses.dataclass
class ScanSummary:
    """Per-scan rollup (reference ``server/server.py:239-294``)."""

    scan_id: str
    total_chunks: int = 0
    chunks_complete: int = 0
    percent_complete: float = 0.0
    workers: list = dataclasses.field(default_factory=list)
    module: Optional[str] = None
    scan_started: Optional[int] = None
    scan_completed: Optional[float] = None
    completed_at: Optional[float] = None
    scan_time: Optional[float] = None
    scan_status: Optional[str] = None
    average_scan_time: Optional[float] = None
    # aggregated worker perf samples (None until a job reports perf)
    rows_processed: Optional[int] = None
    device_seconds: Optional[float] = None
    execute_seconds: Optional[float] = None
    rows_per_second: Optional[float] = None
    # standing-monitor provenance (docs/MONITORING.md): set when the
    # scan's jobs were fired by a monitor epoch, None for one-shot
    # scans — the reference rollup shape gains only extra keys
    monitor_id: Optional[str] = None
    monitor_epoch: Optional[int] = None

    def to_wire(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def rollup_scans(jobs: dict[str, dict]) -> list[dict]:
    """Collate per-job records into per-scan summaries.

    Behavior-parity with reference ``server/server.py:239-302``: chunk
    totals, completion percentage, distinct workers, scan_started parsed
    from the scan id timestamp, completed_at = max job completed_at.
    """
    scans: dict[str, ScanSummary] = {}
    for job in jobs.values():
        scan_id = job.get("scan_id")
        summary = scans.get(scan_id)
        if summary is None:
            summary = scans[scan_id] = ScanSummary(scan_id=scan_id, module=job.get("module"))
            try:
                summary.scan_started = parse_scan_id(scan_id)[1]
            except (ValueError, TypeError, AttributeError):
                summary.scan_started = None
        summary.total_chunks += 1
        if job.get("status") == JobStatus.COMPLETE:
            summary.chunks_complete += 1
        if job.get("worker_id") not in summary.workers:
            summary.workers.append(job.get("worker_id"))
        completed = job.get("completed_at")
        if completed is not None and (
            summary.completed_at is None or completed > summary.completed_at
        ):
            summary.completed_at = completed
        if summary.monitor_id is None and job.get("monitor_id"):
            summary.monitor_id = job.get("monitor_id")
            summary.monitor_epoch = job.get("monitor_epoch")
        perf = job.get("perf")
        if isinstance(perf, dict):
            summary.rows_processed = (summary.rows_processed or 0) + int(
                perf.get("rows", 0)
            )
            summary.device_seconds = (summary.device_seconds or 0.0) + float(
                perf.get("device_s", 0.0)
            )
            summary.execute_seconds = (summary.execute_seconds or 0.0) + float(
                perf.get("execute_s", 0.0)
            )
    for summary in scans.values():
        summary.percent_complete = round(
            summary.chunks_complete / summary.total_chunks * 100, 2
        )
        if summary.percent_complete == 100:
            summary.scan_status = "complete"
        if summary.rows_processed and summary.execute_seconds:
            summary.rows_per_second = round(
                summary.rows_processed / summary.execute_seconds, 2
            )
    return [s.to_wire() for s in scans.values()]
