"""Job queue service: chunking, dispatch, status rollup, results — the
port's copy of ``swarm_tpu/server/queue.py``, the same state keys, blob
keys, journal records and wires, so each package's queue recovers the
other's journal.

Wire-behavior matches the reference server routes (``server/server.py``):
the same Redis-role key names (``jobs``/``workers`` hashes, ``job_queue``/
``completed`` lists), the same blob layout (``{scan}/input|output/
chunk_{i}.txt``), the same job/scan id formats and status strings — so
the reference client and worker interoperate unchanged.

Fixes over the reference (which had no retry or requeue):
- **Leases**: a dispatched job carries ``lease_expires_at``; expired
  in-progress jobs are requeued (bounded by ``max_attempts``).
- Failed terminal states can optionally be requeued the same way.
- Worker statuses live in the state store (the reference kept them in a
  process-local dict, losing them on restart).
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Optional

from swarm_tpu_torch.config import Config
from swarm_tpu_torch.datamodel import (
    SCAN_ID_RE,
    Job,
    JobStatus,
    WorkerInfo,
    WorkerStatus,
    chunk_generator,
    chunk_input_key,
    chunk_output_key,
    generate_scan_id,
    job_id_for,
    rollup_scans,
)
from swarm_tpu_torch.gateway.admission import DEFAULT_TENANT
from swarm_tpu_torch.gateway.qos import QOS_INTERACTIVE, qos_class
from swarm_tpu_torch.resilience.faults import FaultInjected, fault_point
from swarm_tpu_torch.server.journal import QueueJournal
from swarm_tpu_torch.stores import BlobStore, DocStore, StateStore
from swarm_tpu_torch.telemetry import REGISTRY, emit_event
from swarm_tpu_torch.telemetry import tracing
from swarm_tpu_torch.telemetry.gateway_export import GATEWAY_LATENCY
from swarm_tpu_torch.telemetry.journal_export import (
    JOURNAL_CORRUPT,
    JOURNAL_REPLAYED,
    QUEUE_GENERATION,
    QUEUE_RECOVERED,
)
from swarm_tpu_torch.telemetry.monitor_export import MONITOR_SPECS

# Queue-service metric families (process-wide; multiple in-process
# services share them, which matches the one-service-per-server reality)
_JOBS_QUEUED = REGISTRY.counter(
    "swarm_queue_jobs_queued_total", "Jobs accepted into the queue"
)
_JOBS_DISPATCHED = REGISTRY.counter(
    "swarm_queue_jobs_dispatched_total", "Jobs leased out to workers"
)
_JOBS_REQUEUED = REGISTRY.counter(
    "swarm_queue_jobs_requeued_total", "Jobs requeued after lease expiry"
)
_JOBS_RETRIED = REGISTRY.counter(
    "swarm_queue_jobs_retried_total",
    "Jobs requeued after a worker-reported failure",
    ("status",),
)
_JOBS_DEAD_LETTER = REGISTRY.counter(
    "swarm_queue_jobs_dead_letter_total",
    "Jobs quarantined after exhausting max_attempts",
)
_LEASE_RENEWALS = REGISTRY.counter(
    "swarm_queue_lease_renewals_total",
    "Lease renewal requests",
    ("outcome",),
)
_EXPRESS_SERVED = REGISTRY.counter(
    "swarm_queue_express_served_total",
    "Jobs dispatched from the interactive express lane "
    "(docs/GATEWAY.md §QoS)",
)
_JOBS_TERMINAL = REGISTRY.counter(
    "swarm_queue_jobs_terminal_total",
    "Jobs reaching a terminal status",
    ("status",),
)
_JOB_PHASE_SECONDS = REGISTRY.histogram(
    "swarm_job_phase_seconds",
    "Per-phase worker seconds as reported in completed jobs' perf",
    ("phase",),
)
_JOB_ROWS = REGISTRY.counter(
    "swarm_queue_rows_processed_total",
    "Rows processed as reported in completed jobs' perf",
)


class JobQueueService:
    def __init__(
        self,
        cfg: Config,
        state: StateStore,
        blobs: BlobStore,
        docs: DocStore,
        fleet=None,
        journal: Optional[QueueJournal] = None,
    ):
        self.cfg = cfg
        self.state = state
        self.blobs = blobs
        self.docs = docs
        self.fleet = fleet
        self._lock = threading.Lock()
        # generation/cache get their OWN lock: _put_job runs inside
        # `with self._lock` on some paths (dispatch and update are
        # atomic) and bare on others — a second small lock avoids both
        # the deadlock and the lost-increment race between request
        # threads (a lost bump could serve a stale by-state cache for
        # a full TTL after a real transition)
        self._gen_lock = threading.Lock()  # guards: _jobs_generation, _by_state_cache
        self._jobs_generation = 0
        self._by_state_cache: tuple[float, int, dict[str, int]] = (0.0, -1, {})
        # weighted-fair dispatch cursor (docs/GATEWAY.md): next_job
        # serves tenant queues round-robin starting AFTER the tenant it
        # served last, so a deep queue from one tenant can never starve
        # the others (equal weights; the cursor only moves on a serve)
        self._rr_cursor = 0  # guarded-by: _lock
        # express-lane twin of the cursor (docs/GATEWAY.md §QoS):
        # interactive tenants rotate fairly among themselves, same rule
        self._rr_cursor_x = 0  # guarded-by: _lock
        # consecutive express serves while bulk work was waiting — the
        # bulk-starvation bound (cfg.qos_express_burst) ticks against
        # this and forces one bulk serve when it trips
        self._express_streak = 0  # guarded-by: _lock
        # durable queue journal (docs/DURABILITY.md): every mutation is
        # journaled BEFORE the state store is touched, so the journal
        # is always a superset of the store and a restart replays it.
        # The journal lock serializes {append → store write} pairs
        # against {snapshot → checkpoint} — without it a checkpoint
        # could fold state that misses an appended-but-unapplied record
        # whose segment it then prunes. It guards an ORDERING, not a
        # field — the journal's own counters carry their own guarded-by
        # annotations (server/journal.py). The acquisition order below
        # is declared for the lockorder pass: checkpoint takes only
        # _journal_lock, so no cycle.
        # lock-order: _lock -> _journal_lock
        self._journal_lock = threading.RLock()
        # drain set (docs/RESILIENCE.md §Preemption): worker id →
        # reason ("drain" | "preempted" | "sigterm"). Dispatch refuses
        # these workers so they can finish their current lease and
        # exit. Guarded by _journal_lock, NOT _lock: every mutation
        # pairs with its WAL append under that lock (append-before-
        # apply, like jobs), and _journal_state() snapshots it while
        # already holding _journal_lock — guarding it with _lock there
        # would invert the declared _lock -> _journal_lock order.
        self._draining: dict[str, str] = {}  # guarded-by: _journal_lock
        if journal is None and cfg.journal_enabled:
            journal = QueueJournal(
                blobs, compact_segments=cfg.journal_compact_segments
            )
        self._journal = journal
        #: monotonic control-plane generation: bumped once per
        #: journal-enabled boot (0 = journal disabled). Rides the
        #: X-Swarm-Generation header so workers detect restarts.
        self.generation = 0
        #: per-scan trace-waterfall assembler (docs/OBSERVABILITY.md
        #: §Tracing). Constructed BEFORE recovery so recovered scans
        #: can re-register and keep their original trace ids; every
        #: method no-ops when tracing is disabled.
        self.tracer = tracing.TraceAssembler(blobs)
        #: summary of the boot-time recovery (None when nothing was
        #: recovered) — surfaced on /healthz for operators
        self.recovery_summary: Optional[dict] = None
        if self._journal is not None:
            self.recovery_summary = self.recover()

    # ------------------------------------------------------------------
    # Tenant queues (docs/GATEWAY.md)
    # ------------------------------------------------------------------
    @staticmethod
    def _queue_list(tenant: Optional[str], qos: Optional[str] = None) -> str:
        """Dispatch-list key for one (tenant, QoS lane). The default
        tenant's bulk lane keeps the reference's bare ``job_queue``
        list so legacy tooling (and a real Redis populated by the
        reference server) interoperates unchanged; other tenants get
        their own bounded list, and the interactive express lane gets
        a ``:x``-prefixed twin per tenant (docs/GATEWAY.md §QoS)."""
        if qos == QOS_INTERACTIVE:
            if not tenant or tenant == DEFAULT_TENANT:
                return "job_queue:x"
            return f"job_queue:x:t:{tenant}"
        if not tenant or tenant == DEFAULT_TENANT:
            return "job_queue"
        return f"job_queue:t:{tenant}"

    def _lane_names(
        self, qos: Optional[str] = None, tenants: Optional[list] = None
    ) -> list[str]:
        """ONE lane's dispatch lists, default tenant first then
        registered tenants in sorted order (a stable rotation order
        for that lane's fair cursor). ``tenants`` lets the dispatch
        hot path reuse one registry read for both lanes."""
        if tenants is None:
            tenants = sorted(self.state.hkeys("tenants"))
        names = [self._queue_list(None, qos)]
        for tenant in tenants:
            if tenant != DEFAULT_TENANT:
                names.append(self._queue_list(tenant, qos))
        return names

    def _queue_names(self) -> list[str]:
        """Every dispatch list across both lanes, express first (the
        order dispatch consults them)."""
        return self._lane_names(QOS_INTERACTIVE) + self._lane_names()

    def tenants(self) -> list[str]:
        """Registered tenants (default always listed first)."""
        rest = sorted(
            t for t in self.state.hkeys("tenants") if t != DEFAULT_TENANT
        )
        return [DEFAULT_TENANT] + rest

    def tenant_depths(self) -> dict[str, int]:
        """Waiting-job depth per tenant, both lanes (two O(1) llens
        per tenant)."""
        return {
            tenant: self.tenant_depth(tenant) for tenant in self.tenants()
        }

    def tenant_depth(self, tenant: Optional[str]) -> int:
        """ONE tenant's waiting-job depth across both lanes — two
        llens, for the admission hot path (the all-tenant map is
        O(tenants) store calls)."""
        return self.state.llen(self._queue_list(tenant)) + self.state.llen(
            self._queue_list(tenant, QOS_INTERACTIVE)
        )

    # ------------------------------------------------------------------
    # Telemetry snapshots (scrape-time: /metrics and /healthz)
    # ------------------------------------------------------------------
    #: jobs_by_state cache TTL — the scan is O(all job records), and it
    #: feeds UNAUTHENTICATED endpoints (/healthz probes every few
    #: seconds, Prometheus scrapes): within the TTL, repeated probes of
    #: an UNCHANGED job table cost zero backend reads. Any local job
    #: mutation bumps the generation and invalidates immediately, so
    #: the cache never hides a transition.
    BY_STATE_TTL_S = 2.0

    def queue_depth(self) -> int:
        """Jobs currently waiting across ALL tenants' dispatch lists
        (O(tenants) llen calls)."""
        return sum(self.state.llen(n) for n in self._queue_names())

    def jobs_by_state(self) -> dict[str, int]:
        """Status → count over every job record (probe-storm-cached)."""
        now = time.monotonic()
        cached_at, gen, counts = self._by_state_cache
        with self._gen_lock:
            fresh = (
                gen == self._jobs_generation
                and now - cached_at < self.BY_STATE_TTL_S
            )
            gen = self._jobs_generation
        if fresh:
            return dict(counts)
        counts = {}
        for _job_id, raw in self.state.hgetall("jobs").items():
            try:
                status = json.loads(raw).get("status") or "unknown"
            except ValueError:
                status = "unparseable"
            counts[status] = counts.get(status, 0) + 1
        with self._gen_lock:
            self._by_state_cache = (now, gen, counts)
        return dict(counts)

    def jobs_by_tenant(self) -> dict[str, dict[str, int]]:
        """Tenant → (status → count) over every job record.

        Snapshot-then-render: the ONE ``hgetall`` copies the raw hash
        under the store's own lock; every ``json.loads`` runs on that
        snapshot afterwards, so neither the dispatch lock nor the
        store lock is ever held across serialization — a huge job
        table cannot stall submits or dispatches while it renders."""
        raw_jobs = self.state.hgetall("jobs")  # the snapshot
        out: dict[str, dict[str, int]] = {}
        for raw in raw_jobs.values():
            try:
                rec = json.loads(raw)
                status = rec.get("status") or "unknown"
                tenant = rec.get("tenant") or DEFAULT_TENANT
            except ValueError:
                status, tenant = "unparseable", DEFAULT_TENANT
            per = out.setdefault(tenant, {})
            per[status] = per.get(status, 0) + 1
        return out

    # ------------------------------------------------------------------
    # Streaming support (gateway/streaming.py reads these; neither may
    # hold queue locks — the stream generator polls them in a loop)
    # ------------------------------------------------------------------
    def scan_chunk_states(self, scan_id: str) -> dict[int, str]:
        """Chunk index → job status for one scan (snapshot-then-render,
        like :meth:`jobs_by_tenant`)."""
        out: dict[int, str] = {}
        for _job_id, raw in self.state.hgetall("jobs").items():
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if rec.get("scan_id") != scan_id:
                continue
            try:
                out[int(rec.get("chunk_index"))] = rec.get("status") or "unknown"
            except (TypeError, ValueError):
                continue
        return out

    def chunk_status(self, scan_id: str, chunk_index: int) -> Optional[str]:
        """ONE chunk's job status — a single hget, the stream
        generator's hot-loop probe (the full scan_chunk_states render
        is O(all jobs) and reserved for the rare gap/end decision)."""
        raw = self.state.hget("jobs", job_id_for(scan_id, chunk_index))
        if raw is None:
            return None
        try:
            return json.loads(raw).get("status") or "unknown"
        except ValueError:
            return "unparseable"

    def stored_output_chunks(self, scan_id: str) -> set[int]:
        """Chunk indices present in the durable output store — the
        restart-resume source of truth for /stream."""
        out: set[int] = set()
        for key in self.blobs.list(f"{scan_id}/output/"):
            m = re.search(r"chunk_(\d+)\.txt$", key)
            if m:
                out.add(int(m.group(1)))
        return out

    # ------------------------------------------------------------------
    # Submission (reference queue_job, server.py:414-461)
    # ------------------------------------------------------------------
    @staticmethod
    def validate_scan(
        job_data: dict, tenant: Optional[str] = None
    ) -> tuple[str, str, str]:
        """Shape-validate one submission WITHOUT side effects; returns
        ``(module, scan_id, tenant)`` or raises ValueError. The
        gateway runs this BEFORE admission so a malformed request
        never burns a tenant's rate token or counts as admitted;
        queue_scan re-uses it so the two sites cannot drift."""
        module = job_data.get("module")
        if not module:
            raise ValueError("Module must be provided")
        if not SCAN_ID_RE.match(str(module)):
            raise ValueError("Invalid module name")
        scan_id = job_data.get("scan_id") or generate_scan_id(module)
        if not SCAN_ID_RE.match(str(scan_id)):
            raise ValueError("Invalid scan_id")
        tenant = tenant or DEFAULT_TENANT
        if not SCAN_ID_RE.match(tenant):
            raise ValueError("Invalid tenant")
        # the numeric fields must coerce exactly the way queue_scan
        # will coerce them — a submission that would 400 downstream
        # must fail HERE, before it can burn an admission token
        try:
            int(float(job_data.get("batch_size") or 0))
            int(job_data.get("chunk_index") or 0)
        except (TypeError, ValueError):
            raise ValueError("Invalid batch_size or chunk_index")
        return str(module), str(scan_id), tenant

    @staticmethod
    def parse_submission(job_data: dict) -> tuple[list, int, int]:
        """``(lines, batch_size, base_index)`` of one submission — the
        ONE normalization site. queue_scan, complete_scan_from_cache
        and the gateway's short-circuit lookup all chunk through this,
        so the cache lookup's digests and the persisted chunks can
        never drift apart (a drift would silently misalign cached
        outputs against chunks)."""
        lines = [
            l.rstrip("\n") for l in (job_data.get("file_content") or [])
        ]
        batch_size = int(float(job_data.get("batch_size") or 0))
        base_index = int(job_data.get("chunk_index") or 0)
        return lines, batch_size, base_index

    # orders: _put_job < state.rpush (journaled record before the dispatch-list push)
    def queue_scan(
        self,
        job_data: dict,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
        monitor_id: Optional[str] = None,
        monitor_epoch: Optional[int] = None,
        cached_outputs: Optional[dict] = None,
    ) -> dict:
        """``monitor_id``/``monitor_epoch`` stamp epoch scans with
        their provenance (extra wire fields, absent for one-shots).
        ``cached_outputs`` maps chunk OFFSET → fleet-known output
        bytes: those chunks complete at the gateway (output persisted,
        record created COMPLETE) while the rest dispatch normally — the
        partial short-circuit a 95%-unchanged monitor epoch rides
        (docs/MONITORING.md §Cost model)."""
        module, scan_id, tenant = self.validate_scan(job_data, tenant)
        lines, batch_size, base_index = self.parse_submission(job_data)

        if self._journal is not None and not self.state.hget("tenants", tenant):
            # tenant-registry op journaled BEFORE the registry write,
            # like every other mutation (recovery rebuilds the registry
            # and the per-tenant dispatch lists from these records)
            with self._journal_lock:
                self._journal.append({"op": "tenant", "tenant": tenant})  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
        self.state.hset("tenants", tenant, "1")
        # QoS lane selection (docs/GATEWAY.md §QoS): interactive scans
        # land on the tenant's express list; qos None (every reference
        # submission) keeps the exact pre-QoS list
        queue_list = self._queue_list(tenant, qos)
        admitted_at = time.time()
        queued = 0
        completed = 0
        total = 0
        for offset, chunk in enumerate(chunk_generator(lines, batch_size)):
            chunk_index = base_index + offset
            self.blobs.put(
                chunk_input_key(scan_id, chunk_index), "\n".join(chunk).encode()
            )
            job = Job.create(
                scan_id, chunk_index, module, trace_id=trace_id,
                tenant=tenant, qos=qos, admitted_at=admitted_at,
                chunk_rows=len(chunk),
                monitor_id=monitor_id, monitor_epoch=monitor_epoch,
            )
            total += 1
            cached = (cached_outputs or {}).get(offset)
            if cached is not None:
                # fleet-known chunk: output BEFORE the COMPLETE record,
                # same ordering contract as complete_scan_from_cache
                self.blobs.put(chunk_output_key(scan_id, chunk_index), cached)
                job.status = JobStatus.COMPLETE
                job.completed_at = time.time()
                self._put_job(job)
                self.state.rpush("completed", job.job_id)
                _JOBS_TERMINAL.labels(status=JobStatus.COMPLETE).inc()
                completed += 1
                emit_event(
                    "job.short_circuit",
                    trace_id=trace_id,
                    job_id=job.job_id,
                    scan_id=scan_id,
                    module=module,
                    chunk_index=chunk_index,
                    tenant=tenant,
                    qos=qos,
                )
                continue
            self._put_job(job)
            self.state.rpush(queue_list, job.job_id)
            queued += 1
            _JOBS_QUEUED.inc()
            emit_event(
                "job.queued",
                trace_id=trace_id,
                job_id=job.job_id,
                scan_id=scan_id,
                module=module,
                chunk_index=chunk_index,
                tenant=tenant,
                qos=qos,
            )
        self.tracer.register_scan(
            scan_id, trace_id, admitted_at, total, qos=qos, tenant=tenant,
            generation=self.generation or None, done=completed,
        )
        self._maybe_checkpoint()
        result = {"scan_id": scan_id, "chunks": total}
        if cached_outputs is not None:
            # extra key only on the monitor epoch path: the one-shot
            # submission response stays byte-identical to the reference
            result["cached_chunks"] = completed
        return result

    # orders: _journal.append < state.hset (append-before-ack, docs/DURABILITY.md)
    # blocking-ok: the WAL append + record write under _journal_lock IS
    # the append->apply atom the durability design requires
    def _put_job(self, job: Job) -> None:
        """Persist one job record, WRITE-AHEAD: the journal append is
        ordered before the state-store write (and therefore before any
        route's 200 — an admitted job is never unjournaled). A journal
        failure raises and the store is left untouched: the mutation
        observably never happened."""
        if self._journal is not None:
            with self._journal_lock:
                self._journal.append(
                    {
                        "op": "job",
                        "job": job.to_wire(),
                        "rr_cursor": self._rr_cursor,
                        "rr_cursor_x": self._rr_cursor_x,
                    }
                )
                self.state.hset("jobs", job.job_id, job.to_json())
        else:
            self.state.hset("jobs", job.job_id, job.to_json())
        with self._gen_lock:
            self._jobs_generation += 1

    def _get_job_record(self, job_id: str) -> Optional[Job]:
        raw = self.state.hget("jobs", job_id)
        return Job.from_json(raw) if raw else None

    def job_record(self, job_id: str) -> Optional[dict]:
        """One job's wire record (public: the gateway's cache-writeback
        hook reads a completed job's module/QoS/chunk coordinates)."""
        job = self._get_job_record(job_id)
        return job.to_wire() if job is not None else None

    # orders: blobs.put < _put_job (output chunk durable before the COMPLETE record —
    # recovery's output-present=>complete reconciliation reads the blob store as truth)
    def complete_scan_from_cache(
        self,
        job_data: dict,
        outputs: list,
        trace_id: Optional[str] = None,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
    ) -> dict:
        """Gateway-tier short-circuit (docs/GATEWAY.md §QoS): persist
        fleet-known outputs and create already-COMPLETE job records —
        the scan finishes without touching a dispatch list or a
        worker. ``outputs`` aligns 1:1 with the submission's chunks
        (the caller looked every one of them up in the shared tier);
        every downstream surface — /raw, /stream, /get-statuses, the
        tail client's ``completed`` pop-list — behaves exactly as if a
        worker had drained the scan."""
        module, scan_id, tenant = self.validate_scan(job_data, tenant)
        lines, batch_size, base_index = self.parse_submission(job_data)
        if self._journal is not None and not self.state.hget("tenants", tenant):
            with self._journal_lock:
                self._journal.append({"op": "tenant", "tenant": tenant})  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
        self.state.hset("tenants", tenant, "1")
        admitted_at = time.time()
        done = 0
        for offset, (chunk, output) in enumerate(
            zip(chunk_generator(lines, batch_size), outputs)
        ):
            chunk_index = base_index + offset
            self.blobs.put(
                chunk_input_key(scan_id, chunk_index),
                "\n".join(chunk).encode(),
            )
            # output BEFORE the record: a COMPLETE record must never
            # exist without its chunk
            self.blobs.put(chunk_output_key(scan_id, chunk_index), output)
            job = Job.create(
                scan_id, chunk_index, module, trace_id=trace_id,
                tenant=tenant, qos=qos, admitted_at=admitted_at,
                chunk_rows=len(chunk),
            )
            job.status = JobStatus.COMPLETE
            job.completed_at = time.time()
            self._put_job(job)
            # the tail client follows the same pop-list a worker-drained
            # completion feeds
            self.state.rpush("completed", job.job_id)
            _JOBS_TERMINAL.labels(status=JobStatus.COMPLETE).inc()
            done += 1
            emit_event(
                "job.short_circuit",
                trace_id=trace_id,
                job_id=job.job_id,
                scan_id=scan_id,
                module=module,
                chunk_index=chunk_index,
                tenant=tenant,
                qos=qos,
            )
        self._maybe_checkpoint()
        return {"scan_id": scan_id, "chunks": done}

    # ------------------------------------------------------------------
    # Monitor registry (docs/MONITORING.md): standing-rescan specs are
    # queue state — journaled like jobs, snapshot like jobs, recovered
    # like jobs. The ticker (monitor/service.py) only READS this
    # registry; every mutation funnels through these three methods.
    # ------------------------------------------------------------------
    def list_monitors(self) -> list[dict]:
        out = []
        for _mid, raw in sorted(self.state.hgetall("monitors").items()):
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        return out

    def get_monitor(self, monitor_id: str) -> Optional[dict]:
        raw = self.state.hget("monitors", monitor_id)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def _monitor_gauge(self) -> None:
        MONITOR_SPECS.labels().set(len(self.state.hkeys("monitors")))

    # orders: _journal.append < state.hset (append-before-ack: a registered
    # spec is never unjournaled, docs/DURABILITY.md)
    # blocking-ok: the WAL append + registry write under _journal_lock IS
    # the append->apply atom the durability design requires
    def put_monitor(self, spec_wire: dict) -> None:
        """Register/update one spec (add, pause, resume, cadence
        advance). WRITE-AHEAD like every queue mutation: a journal
        failure raises and the registry is untouched."""
        monitor_id = str(spec_wire["monitor_id"])
        payload = json.dumps(spec_wire, separators=(",", ":"))
        if self._journal is not None:
            with self._journal_lock:
                self._journal.append({"op": "monitor_spec", "spec": spec_wire})  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
                self.state.hset("monitors", monitor_id, payload)
        else:
            self.state.hset("monitors", monitor_id, payload)
        self._monitor_gauge()
        self._maybe_checkpoint()

    # orders: _journal.append < state.hdel (same append-before-apply atom)
    # blocking-ok: the WAL append + registry delete under _journal_lock IS
    # the append->apply atom the durability design requires
    def remove_monitor(self, monitor_id: str) -> bool:
        if self.state.hget("monitors", monitor_id) is None:
            return False
        if self._journal is not None:
            with self._journal_lock:
                self._journal.append({"op": "monitor_rm", "monitor_id": monitor_id})  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
                self.state.hdel("monitors", monitor_id)
        else:
            self.state.hdel("monitors", monitor_id)
        self._monitor_gauge()
        self._maybe_checkpoint()
        return True

    # orders: _journal.append < queue_scan (append-before-fire: the epoch
    # advance is journaled before any job record exists, so kill-9 leaves
    # either a fired epoch or a journaled-but-unfired one that recovery
    # flags for a single late re-fire — never a double fire)
    # blocking-ok: the WAL append + cadence write under _journal_lock IS
    # the append->apply atom the durability design requires
    def fire_monitor_epoch(
        self,
        spec_wire: dict,
        scan_id: str,
        epoch: int,
        cached_outputs: Optional[dict] = None,
        trace_id: Optional[str] = None,
    ) -> dict:
        """Advance one spec's cadence and submit its epoch scan. The
        journaled spec update (epoch, next_fire_at, last_scan_id) and
        the scan submission are deliberately ordered append-first: the
        journal may claim an epoch whose scan never happened (recovery
        re-fires it once, late, under the same scan id), but a scan can
        never exist that the journal doesn't know about.

        ``next_fire_at = now + interval`` — never ``+= k*interval`` —
        is the fire-once-late rule for missed-while-down epochs."""
        now = time.time()
        spec = dict(spec_wire)
        spec["epoch"] = int(epoch)
        spec["last_scan_id"] = scan_id
        spec["next_fire_at"] = now + float(spec.get("interval_s") or 0.0)
        spec["refire"] = False
        monitor_id = str(spec["monitor_id"])
        payload = json.dumps(spec, separators=(",", ":"))
        if self._journal is not None:
            with self._journal_lock:
                self._journal.append(
                    {
                        "op": "monitor_epoch",
                        "monitor_id": monitor_id,
                        "epoch": int(epoch),
                        "scan_id": scan_id,
                        "spec": spec,
                    }
                )  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
                self.state.hset("monitors", monitor_id, payload)
        else:
            self.state.hset("monitors", monitor_id, payload)
        result = self.queue_scan(
            {
                "module": spec.get("module"),
                "file_content": list(spec.get("targets") or []),
                "batch_size": spec.get("batch_size") or 0,
                "scan_id": scan_id,
            },
            trace_id=trace_id,
            tenant=spec.get("tenant"),
            qos=spec.get("qos"),
            monitor_id=monitor_id,
            monitor_epoch=int(epoch),
            cached_outputs=cached_outputs if cached_outputs is not None else {},
        )
        return result

    # ------------------------------------------------------------------
    # Graceful drain + deregistration (docs/RESILIENCE.md §Preemption)
    # ------------------------------------------------------------------
    def drain_reason(self, worker_id: str) -> Optional[str]:
        """Why this worker is draining, or None (the dispatch-refusal
        probe; also rides the X-Swarm-Drain response header)."""
        with self._journal_lock:
            return self._draining.get(worker_id)

    def draining_workers(self) -> dict[str, str]:
        """Worker id → drain reason snapshot (/healthz, tests)."""
        with self._journal_lock:
            return dict(self._draining)

    # append-before-apply: the WAL append precedes the drain-set write
    # (a worker told to drain is never offered a job by the next boot)
    # blocking-ok: the WAL append + drain-set add under _journal_lock IS
    # the append->apply atom the durability design requires
    def drain_worker(self, worker_id: str, reason: str = "drain") -> bool:
        """Mark one worker draining: dispatch stops offering it jobs
        (it finishes its current lease, uploads or spools, then calls
        :meth:`deregister_worker`). Sources: the operator route
        ``POST /drain/<worker>``, a provider preemption notice, or an
        armed ``fleet.preempt`` chaos clause. Journaled so a server
        restart mid-drain keeps refusing the worker. Returns False if
        the worker was already draining."""
        with self._journal_lock:
            if worker_id in self._draining:
                return False
            if self._journal is not None:
                self._journal.append(
                    {"op": "drain", "worker": worker_id, "reason": reason}
                )  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
            self._draining[worker_id] = reason
        worker = self._load_worker(worker_id)
        worker.status = (
            WorkerStatus.PREEMPTED
            if reason == "preempted"
            else WorkerStatus.DRAINING
        )
        self._save_worker(worker)
        emit_event("worker.drain", worker_id=worker_id, reason=reason)
        self._maybe_checkpoint()
        return True

    # orders: _put_job < state.hdel
    # (record-first requeue, same discipline as _requeue_expired;
    # append-before-apply: the WAL append precedes the drain-set drop)
    # blocking-ok: the lease handback must be atomic against dispatch —
    # a concurrent next_job must see either the old lease or the
    # requeued job, never a half-released one
    def deregister_worker(self, worker_id: str) -> dict:
        """The worker is exiting NOW: drop its drain entry, hand back
        any lease it still holds immediately (no grace-window wait —
        the node is gone, waiting out the lease just delays the
        requeue), and mark it inactive. Runs under the dispatch lock so
        the handback and a concurrent ``_requeue_expired`` serialize:
        whichever runs first requeues the job, the other sees QUEUED /
        a cleared assignee and does nothing — exactly one requeue.
        The caller (the route) also drops the worker's admission
        saturation report. Returns ``{"requeued", "was_draining"}``."""
        requeued = 0
        with self._lock:
            with self._journal_lock:
                was = self._draining.pop(worker_id, None)
                if self._journal is not None:
                    self._journal.append(
                        {"op": "deregister", "worker": worker_id}
                    )  # blocking-ok: WAL append under _journal_lock is the append->apply atom (docs/DURABILITY.md)
            for job_id in list(self.state.hkeys("leases")):
                job = self._get_job_record(job_id)
                if (
                    job is None
                    or job.worker_id != worker_id
                    or job.status not in JobStatus.ACTIVE
                ):
                    continue
                self._record_failure(job, "worker deregistered")
                if job.attempts >= self.cfg.max_attempts:
                    self._quarantine(job, reason="deregistered")
                    continue
                job.status = JobStatus.QUEUED
                job.worker_id = None
                job.lease_expires_at = None
                # journaled record FIRST, lease-index drop after — the
                # same never-strand ordering _requeue_expired documents
                self._put_job(job)
                self.state.hdel("leases", job_id)
                self.state.rpush(
                    self._queue_list(job.tenant, job.qos), job.job_id
                )
                requeued += 1
                _JOBS_REQUEUED.inc()
                emit_event(
                    "job.requeued", trace_id=job.trace_id, job_id=job_id,
                    attempts=job.attempts,
                )
            worker = self._load_worker(worker_id)
            worker.status = WorkerStatus.INACTIVE
            self._save_worker(worker)
        # quarantines above can close a scan's waterfall; persist it
        # now that the dispatch lock is released
        self.tracer.flush()
        self._maybe_checkpoint()
        emit_event(
            "worker.deregistered",
            worker_id=worker_id,
            requeued=requeued,
            was_draining=was is not None,
        )
        return {"requeued": requeued, "was_draining": was is not None}

    # ------------------------------------------------------------------
    # Dispatch (reference get_job, server.py:465-515) + leases
    # ------------------------------------------------------------------
    # orders: _put_job < state.hset (record-first: the lease index follows the journaled record)
    # blocking-ok: dispatch atomicity — the pop->lease transition must be
    # invisible to a concurrent renew/update (docs/DURABILITY.md), so the
    # dispatch lock intentionally spans the control-plane store writes
    def next_job(self, worker_id: str) -> Optional[dict]:
        now = time.time()
        worker = self._load_worker(worker_id)
        worker.last_contact = now

        # chaos injection site (docs/RESILIENCE.md §Preemption): an
        # armed ``fleet.preempt`` clause INJECTS a preemption notice
        # for the polling worker — the dispatch path is the one place
        # every worker is guaranteed to pass, so the plan can target
        # any fleet without knowing node names. Gated on the fleet
        # actually being preemptible (SimulatedProvider & co): a
        # NullProvider server in the same process must not consume the
        # plan's counts on a fleet that cannot be preempted.
        if getattr(self.fleet, "preempt", None) is not None:
            try:
                fault_point("fleet.preempt", detail=worker_id)
            except FaultInjected:
                self.drain_worker(worker_id, reason="preempted")
        reason = self.drain_reason(worker_id)
        if reason is not None:
            # draining worker: no dispatch — and its idle-poll counter
            # must NOT creep toward teardown while it finishes its
            # current lease (the drain path owns the exit)
            worker.status = (
                WorkerStatus.PREEMPTED
                if reason == "preempted"
                else WorkerStatus.DRAINING
            )
            self._save_worker(worker)
            return None

        job: Optional[Job] = None
        express = False
        with self._lock:
            self._requeue_expired(now)
            # lane policy (docs/GATEWAY.md §QoS): the express lane is
            # served ahead of bulk so an interactive job admitted
            # mid-flood pre-empts the backlog — but at most
            # qos_express_burst consecutive times while bulk work is
            # actually waiting, then one bulk serve is forced. With no
            # interactive submissions the express lists are empty and
            # this is byte-identical to the pre-QoS dequeue.
            burst = max(1, int(self.cfg.qos_express_burst))
            # ONE registry read serves both lanes' list names and the
            # starvation check — the dispatch hot path must not scale
            # its store round trips with how many places need the list
            tenants = sorted(self.state.hkeys("tenants"))
            lane_names = {
                QOS_INTERACTIVE: self._lane_names(QOS_INTERACTIVE, tenants),
                None: self._lane_names(None, tenants),
            }
            lanes = [QOS_INTERACTIVE, None]
            if self._express_streak >= burst:
                lanes = [None, QOS_INTERACTIVE]
            for lane in lanes:
                job, name = self._pop_lane(lane, lane_names[lane])
                if job is not None:
                    express = lane == QOS_INTERACTIVE
                    break
            if job is not None:
                if express and any(
                    self.state.llen(n) for n in lane_names[None]
                ):
                    # the streak only grows while bulk work waits — an
                    # idle bulk lane means nothing is being starved
                    self._express_streak += 1
                else:
                    self._express_streak = 0

            if job is not None:
                # lease assignment stays under the store lock: between
                # the pop and the IN_PROGRESS write a concurrent
                # update/renew must not observe a half-dispatched job
                job.status = JobStatus.IN_PROGRESS
                job.started_at = now
                job.worker_id = worker_id
                job.lease_expires_at = now + self.cfg.lease_seconds
                job.attempts += 1
                try:
                    self._put_job(job)
                except Exception:
                    # journal append failed: the dispatch observably
                    # never happened — restore the popped id to the
                    # FRONT of its list so the job isn't stranded
                    # QUEUED-but-unlisted until a restart
                    self.state.lpush(name, job.job_id)
                    raise
                self.state.hset(
                    "leases", job.job_id, str(job.lease_expires_at)
                )

        # lease-expiry quarantines above can finish (degrade) a scan's
        # waterfall; persist it now that the dispatch lock is released
        self.tracer.flush()

        if job is not None:
            worker.polls_with_no_jobs = 0
            worker.status = WorkerStatus.ACTIVE
            self._save_worker(worker)
            _JOBS_DISPATCHED.inc()
            if express:
                _EXPRESS_SERVED.inc()
            # server-stamped enqueue→lease wait for this attempt: both
            # endpoints are this process's own clock, so the waterfall's
            # dominant segment needs no cross-host clock agreement
            self.tracer.record_queue_wait(job, now)
            emit_event(
                "job.dispatch",
                trace_id=job.trace_id,
                job_id=job.job_id,
                worker_id=worker_id,
                attempts=job.attempts,
                qos=job.qos,
            )
            return job.to_wire()

        worker.polls_with_no_jobs += 1
        worker.status = WorkerStatus.PENDING
        if worker.polls_with_no_jobs > self.cfg.idle_polls_before_teardown:
            worker.status = WorkerStatus.INACTIVE
            if self.fleet is not None:
                self.fleet.teardown_async(worker_id)
        self._save_worker(worker)
        return None

    # requires-lock: _lock (runs inside next_job's dispatch transaction)
    # blocking-ok: the lane pop IS the dispatch transaction's first
    # half — the pop->lease transition must be invisible to a
    # concurrent renew/update (the same waiver next_job documents)
    def _pop_lane(
        self, qos: Optional[str], names: list
    ) -> tuple[Optional[Job], Optional[str]]:
        """Weighted-fair dequeue over ONE lane's tenant lists
        (docs/GATEWAY.md): scan round-robin from the lane's cursor,
        serve the first non-empty list, park the cursor AFTER it — one
        tenant's backlog can delay another by at most (tenants - 1)
        serves. Returns ``(job, list_name)`` or ``(None, None)``."""
        is_x = qos == QOS_INTERACTIVE
        cursor = self._rr_cursor_x if is_x else self._rr_cursor
        for k in range(len(names)):
            name = names[(cursor + k) % len(names)]
            # loop (not recursion): drop dangling ids from queue/hash
            # desync (e.g. /reset racing a submit) without blowing the
            # stack
            while True:
                job_id = self.state.lpop(name)
                if job_id is None:
                    break
                job = self._get_job_record(job_id)
                if job is not None and job.status == JobStatus.QUEUED:
                    # dangling ids, or a job that left QUEUED while its
                    # id was still in the list (e.g. completed unfenced
                    # after a lease-expiry requeue), are dropped above —
                    # never re-leased
                    nxt = (cursor + k + 1) % len(names)
                    if is_x:
                        self._rr_cursor_x = nxt
                    else:
                        self._rr_cursor = nxt
                    return job, name
        return None, None

    # requires-lock: _lock (runs inside next_job's dispatch transaction)
    # orders: _put_job < state.rpush; orders: _put_job < state.hdel (record-first requeue)
    # blocking-ok: lease recovery is part of the dispatch transaction
    def _requeue_expired(self, now: float) -> None:
        """Lease enforcement: in-progress jobs whose lease lapsed go back
        to the queue (the reference loses them forever).

        Scans only the ``leases`` index (jobs currently leased), not the
        whole jobs hash, so dispatch latency stays O(in-flight) rather
        than O(all jobs ever)."""
        for job_id, expiry in self.state.hgetall("leases").items():
            try:
                if float(expiry) >= now:
                    continue
            except ValueError:
                pass
            raw = self.state.hget("jobs", job_id)
            if raw is None:
                self.state.hdel("leases", job_id)  # protocol-ok: dangling lease (no job record) — nothing to journal
                continue
            try:
                job = Job.from_json(raw)
            except (ValueError, KeyError, TypeError):
                self.state.hdel("leases", job_id)  # protocol-ok: unparseable record — index hygiene, no record mutation paired
                continue
            # any ACTIVE status is leased: a worker dying mid-execution
            # leaves "executing" (not "in progress"), and its job must
            # still come back — restricting to IN_PROGRESS silently
            # lost every job whose worker died after the first status
            # update (resilience PR regression find)
            if job.status not in JobStatus.ACTIVE or job.lease_expires_at is None:
                self.state.hdel("leases", job_id)  # protocol-ok: terminal/unleased record — index hygiene, no record mutation paired
                continue
            if job.lease_expires_at >= now:
                continue
            self._record_failure(job, "lease expired")
            if job.attempts >= self.cfg.max_attempts:
                # quarantine, not a silent terminal failure: the job
                # parks in dead-letter WITH its failure history and can
                # be inspected/requeued (`swarm dead-letter`)
                self._quarantine(job, reason="lease_exhausted")
                continue
            job.status = JobStatus.QUEUED
            job.worker_id = None
            job.lease_expires_at = None
            # journaled record FIRST, auxiliary keys after: if the
            # append fails the lease-index entry is still present, so
            # the next dispatch retries this requeue — dropping the
            # lease first would strand an ACTIVE job nothing scans
            self._put_job(job)
            self.state.hdel("leases", job_id)
            # a requeue goes back to ITS tenant's list IN ITS LANE:
            # lease recovery must not launder an abusive tenant's jobs
            # into another tenant's dispatch share, and an interactive
            # job must keep its QoS class across retries
            self.state.rpush(
                self._queue_list(job.tenant, job.qos), job.job_id
            )
            _JOBS_REQUEUED.inc()
            emit_event(
                "job.requeued", trace_id=job.trace_id, job_id=job_id,
                attempts=job.attempts,
            )

    @staticmethod
    def _record_failure(job: Job, status: str) -> None:
        history = list(job.failure_history or ())
        history.append(
            {"ts": time.time(), "worker_id": job.worker_id, "status": status}
        )
        job.failure_history = history

    # requires-lock: _lock; orders: _put_job < state.hdel (record-first quarantine)
    # blocking-ok: the terminal transition rides its caller's dispatch transaction
    def _quarantine(self, job: Job, reason: str) -> None:
        """Move a job to the dead-letter state (caller holds the lock
        and has already recorded the triggering failure)."""
        job.status = JobStatus.DEAD_LETTER
        job.worker_id = None
        job.lease_expires_at = None
        self._put_job(job)
        self.state.hdel("leases", job.job_id)
        _JOBS_TERMINAL.labels(status=JobStatus.DEAD_LETTER).inc()
        _JOBS_DEAD_LETTER.inc()
        # a quarantined chunk still closes its scan's waterfall (as
        # degraded), and the flight ring is dumped for the post-mortem.
        # Both are memory-only under this lock: the assembler stages,
        # flush() persists later; the dump's sinks run on a daemon
        # thread (tracing.FlightRecorder contract)
        self.tracer.job_terminal(
            job.scan_id, job.job_id, JobStatus.DEAD_LETTER,
            time.time(),
        )
        tracing.flight_dump(
            "dead_letter", detail=f"{job.job_id} after {job.attempts} attempts"
        )
        emit_event(
            "job.dead_letter",
            trace_id=job.trace_id,
            job_id=job.job_id,
            attempts=job.attempts,
            reason=reason,
            failures=job.failure_history,
        )

    # ------------------------------------------------------------------
    # Lease heartbeats (resilience PR): POST /renew-lease/<job_id>
    # ------------------------------------------------------------------
    # orders: _put_job < state.hset (record-first lease extension)
    # blocking-ok: the fenced renew must be atomic against dispatch/expiry
    def renew_lease(self, job_id: str, worker_id: Optional[str]) -> Optional[float]:
        """Extend a live lease for its current assignee. Returns the
        new expiry, or None when the renewal is rejected — unknown job,
        a job that was requeued/re-leased (fencing), or one already
        terminal. Rejection tells the worker the job is no longer its
        own."""
        now = time.time()
        with self._lock:
            job = self._get_job_record(job_id)
            if (
                job is None
                or job.status in JobStatus.TERMINAL
                or job.status == JobStatus.QUEUED
                or job.lease_expires_at is None
                or worker_id is None
                or job.worker_id != worker_id
            ):
                _LEASE_RENEWALS.labels(outcome="rejected").inc()
                return None
            job.lease_expires_at = now + self.cfg.lease_seconds
            self._put_job(job)
            self.state.hset("leases", job_id, str(job.lease_expires_at))
        # heartbeats are the steadiest journal writer — give them the
        # compaction duty too, or an idle-but-leased fleet would grow
        # the WAL without bound
        self._maybe_checkpoint()
        _LEASE_RENEWALS.labels(outcome="renewed").inc()
        emit_event(
            "job.lease_renewed",
            trace_id=job.trace_id,
            job_id=job_id,
            worker_id=worker_id,
            lease_expires_at=job.lease_expires_at,
        )
        return job.lease_expires_at

    # ------------------------------------------------------------------
    # Dead-letter surface (resilience PR)
    # ------------------------------------------------------------------
    def dead_letter_jobs(self) -> list[dict]:
        """Wire records of every quarantined job (failure history
        included) — the `swarm dead-letter` inspection surface."""
        out = []
        for _job_id, raw in self.state.hgetall("jobs").items():
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if rec.get("status") == JobStatus.DEAD_LETTER:
                out.append(rec)
        return sorted(out, key=lambda r: r.get("job_id") or "")

    # orders: _put_job < state.rpush (journaled record before the dispatch-list push)
    # blocking-ok: the requeue transition must be atomic against dispatch
    def requeue_dead_letter(self, job_id: str) -> bool:
        """Operator action: put a quarantined job back in the queue
        with a fresh attempt budget (history is kept)."""
        with self._lock:
            job = self._get_job_record(job_id)
            if job is None or job.status != JobStatus.DEAD_LETTER:
                return False
            job.status = JobStatus.QUEUED
            job.worker_id = None
            job.lease_expires_at = None
            job.attempts = 0
            self._put_job(job)
            # operator requeue keeps the tenant and the QoS lane too
            self.state.rpush(
                self._queue_list(job.tenant, job.qos), job.job_id
            )
        _JOBS_REQUEUED.inc()
        emit_event(
            "job.dead_letter_requeued", trace_id=job.trace_id, job_id=job_id
        )
        return True

    def _load_worker(self, worker_id: str) -> WorkerInfo:
        raw = self.state.hget("workers", worker_id)
        if raw:
            try:
                return WorkerInfo.from_wire(worker_id, json.loads(raw))
            except (ValueError, TypeError):
                pass
        return WorkerInfo(worker_id=worker_id, polls_with_no_jobs=-1)

    def _save_worker(self, worker: WorkerInfo) -> None:
        self.state.hset("workers", worker.worker_id, json.dumps(worker.to_wire()))

    # ------------------------------------------------------------------
    # Status transitions (reference update_job, server.py:308-335)
    # ------------------------------------------------------------------
    def update_job(self, job_id: str, changes: dict) -> bool:
        # one lock over load → check → write: the fencing decision and
        # the dead-letter/requeue transition must be atomic against a
        # concurrent dispatch or _requeue_expired (satellite: a zombie
        # whose lease expired must never complete a re-leased job)
        with self._lock:
            out = self._update_job_locked(job_id, changes)
        # persist any waterfall the transition just finished — blob IO,
        # so outside the lock (same placement rule as _maybe_checkpoint)
        self.tracer.flush()
        self._maybe_checkpoint()
        return out

    # requires-lock: _lock (update_job wraps; fencing decision + transition atomicity)
    # orders: _put_job < state.hdel; orders: _put_job < state.rpush (record-first, docs/DURABILITY.md)
    # blocking-ok: the fenced status transition rides the dispatch lock by design
    def _update_job_locked(self, job_id: str, changes: dict) -> bool:
        job = self._get_job_record(job_id)
        if job is None:
            return False
        changes = dict(changes)
        # Fencing token (not a mutation): our worker sends its id so a
        # zombie whose lease expired and whose job was reassigned cannot
        # clobber the new assignee's state. Reference workers omit it and
        # stay unfenced, preserving wire behavior.
        fence = changes.pop("worker_id", None)
        if fence is not None and fence != job.worker_id:
            # also rejects fenced updates to a requeued job (worker_id
            # None): a zombie must not touch a job back in the queue
            return False
        if "status" in changes and job.status in JobStatus.TERMINAL:
            # terminal states never regress (duplicate 'completed' pushes
            # would make the client tail re-emit chunks)
            return False
        # Poison-job discipline: a worker-reported failed terminal state
        # consumes one attempt. With budget left the job requeues (the
        # reference went terminal on the first hiccup); an exhausted job
        # is quarantined in dead-letter with its failure history.
        # FENCED updates only: an unfenced (reference-worker) failure
        # can come from a zombie whose job was already re-leased —
        # requeuing it would put an actively-executing job back in the
        # queue and double-execute it. Unfenced failures keep the
        # reference's terminal wire behavior below.
        # worker-shipped span batch rides perf but must NOT persist into
        # the job record (spans are assembly input, and a record that
        # grows with span volume would bloat every journal checkpoint).
        # Extracted BEFORE the retry branch: a failed attempt's spans
        # still belong to the scan's waterfall — a retried job must
        # assemble into ONE trace carrying every attempt.
        spans = None
        perf_in = changes.get("perf")
        if isinstance(perf_in, dict) and "spans" in perf_in:
            perf_in = dict(perf_in)
            spans = perf_in.pop("spans")
            changes["perf"] = perf_in
        new_status = changes.get("status")
        if (
            self.cfg.retry_failed
            and fence is not None
            and new_status in JobStatus.FAILED
            and new_status != JobStatus.DEAD_LETTER
        ):
            if spans:
                self.tracer.add_spans(job.scan_id, spans)
            self._record_failure(job, new_status)
            if job.attempts >= self.cfg.max_attempts:
                self._quarantine(job, reason="attempts_exhausted")
            else:
                job.status = JobStatus.QUEUED
                job.worker_id = None
                job.lease_expires_at = None
                # journaled record FIRST, lease-index drop after: if the
                # append fails the lease entry survives and the expiry
                # scan retries this transition — dropping the lease
                # first would strand an ACTIVE job nothing scans (the
                # same rule _requeue_expired documents; found by the
                # swarmlint protocol pass)
                self._put_job(job)
                self.state.hdel("leases", job_id)
                # retries keep the tenant AND the QoS lane
                self.state.rpush(
                    self._queue_list(job.tenant, job.qos), job.job_id
                )
                _JOBS_RETRIED.labels(status=new_status).inc()
                emit_event(
                    "job.retry",
                    trace_id=job.trace_id,
                    job_id=job_id,
                    attempts=job.attempts,
                    status=new_status,
                )
            return True
        wire = job.to_wire()
        became_complete = False
        for key, value in changes.items():
            if key in wire and key is not None:
                wire[key] = value
                if key == "status" and value == JobStatus.COMPLETE:
                    wire["completed_at"] = time.time()
                    became_complete = True
        updated = Job.from_wire(wire)
        if updated.status in JobStatus.TERMINAL:
            updated.lease_expires_at = None
        # journaled record FIRST (a failed append 500s with nothing
        # half-applied), auxiliary keys after — pushing `completed`
        # before the record write could feed the tail client a
        # completion whose job record never updated, and a retried
        # update would then push it twice
        self._put_job(updated)
        if updated.status in JobStatus.TERMINAL:
            self.state.hdel("leases", job_id)
        if became_complete:
            self.state.rpush("completed", job_id)
        if updated.status in JobStatus.TERMINAL and updated.status != job.status:
            _JOBS_TERMINAL.labels(status=updated.status).inc()
            # fold the worker-reported perf sample into the fleet-wide
            # phase histograms: remote workers' /metrics aren't scraped
            # by this server, but their phase timings flow through the
            # same status API the reference used for timestamps
            perf = updated.perf if isinstance(updated.perf, dict) else {}
            if updated.status == JobStatus.COMPLETE:
                # finiteness-guarded: json.loads accepts Infinity/NaN,
                # and one such perf value from a buggy worker would
                # wedge a monotonic counter / histogram sum for the
                # life of the process
                import math

                for phase in ("download", "execute", "upload"):
                    v = perf.get(f"{phase}_s")
                    if isinstance(v, (int, float)) and math.isfinite(v):
                        # exemplar-carrying observe: the worst recent
                        # observation's trace_id rides the +Inf bucket
                        # line when SWARM_METRICS_EXEMPLARS is set
                        _JOB_PHASE_SECONDS.labels(phase=phase).observe(
                            v, trace_id=updated.trace_id
                        )
                rows = perf.get("rows")
                if (
                    isinstance(rows, (int, float))
                    and math.isfinite(rows)
                    and rows > 0
                ):
                    _JOB_ROWS.inc(rows)
                # admission-to-verdict latency, per QoS class
                # (docs/GATEWAY.md §QoS): one observation per job at
                # its COMPLETE transition. Finiteness/sign-guarded —
                # the stamps ride job records a buggy worker's update
                # could have clobbered
                if isinstance(updated.admitted_at, (int, float)) and isinstance(
                    updated.completed_at, (int, float)
                ):
                    dt = updated.completed_at - updated.admitted_at
                    if math.isfinite(dt) and dt >= 0:
                        GATEWAY_LATENCY.labels(
                            qos=qos_class(updated.qos)
                        ).observe(dt, trace_id=updated.trace_id)
            # waterfall assembly: attach this chunk's span batch and
            # close the scan when its last chunk lands. Memory-only
            # here (caller holds _lock); update_job flushes after.
            self.tracer.job_terminal(
                updated.scan_id, job_id, updated.status,
                updated.completed_at, spans=spans,
            )
            emit_event(
                "job.terminal",
                trace_id=updated.trace_id,
                job_id=job_id,
                status=updated.status,
                worker_id=updated.worker_id,
                perf=perf or None,
            )
        return True

    # ------------------------------------------------------------------
    # Status aggregation (reference get_statuses, server.py:219-305)
    # ------------------------------------------------------------------
    def statuses(self) -> dict:
        # snapshot-then-render: both hgetall calls copy under the
        # store's internal lock only; parsing, rollup and the doc-store
        # writes below run on the snapshots with NO queue/store lock
        # held (a slow doc backend must not stall dispatch)
        raw_workers = self.state.hgetall("workers")
        raw_jobs = self.state.hgetall("jobs")
        workers = {}
        for worker_id, raw in raw_workers.items():
            try:
                workers[worker_id] = json.loads(raw)
            except ValueError:
                continue
        jobs = {}
        for job_id, raw in raw_jobs.items():
            try:
                jobs[job_id] = json.loads(raw)
            except ValueError:
                continue
        scans = rollup_scans(jobs)
        for scan in scans:
            if scan["percent_complete"] == 100:
                self._persist_scan_summary(scan)
        # per-tenant rollup from the SAME snapshot (one parse pass is
        # plenty: the records are already dicts here)
        tenants: dict[str, dict[str, int]] = {}
        for rec in jobs.values():
            tenant = rec.get("tenant") or DEFAULT_TENANT
            status = rec.get("status") or "unknown"
            per = tenants.setdefault(tenant, {})
            per[status] = per.get(status, 0) + 1
        return {
            "workers": workers, "jobs": jobs, "scans": scans,
            "tenants": tenants,
            # worker id → drain reason for the mid-drain set (`swarm
            # workers` annotates the State column with it; authed
            # endpoint, unlike /healthz's bare count)
            "draining": self.draining_workers(),
        }

    def _persist_scan_summary(self, scan: dict) -> None:
        coll = self.docs.collection("scans")
        if coll.find_one({"scan_id": scan["scan_id"]}) is None:
            coll.insert_one(
                {
                    "scan_id": scan["scan_id"],
                    "total_chunks": scan["total_chunks"],
                    "chunks_complete": scan["chunks_complete"],
                    "percent_complete": scan["percent_complete"],
                    "module": scan["module"],
                    "scan_started": scan["scan_started"],
                    "scan_completed": scan["completed_at"],
                    "scan_status": "complete",
                }
            )

    # ------------------------------------------------------------------
    # Results (reference get_chunk / get_latest_chunk / raw / parse_job)
    # ------------------------------------------------------------------
    def output_chunk(self, scan_id: str, chunk_index: int) -> Optional[str]:
        key = chunk_output_key(scan_id, chunk_index)
        try:
            return self.blobs.get(key).decode("utf-8", "replace")
        except (KeyError, FileNotFoundError, OSError):
            return None

    def input_chunk(self, scan_id: str, chunk_index: int) -> Optional[bytes]:
        try:
            return self.blobs.get(chunk_input_key(scan_id, chunk_index))
        except (KeyError, FileNotFoundError, OSError):
            return None

    def put_output_chunk(self, scan_id: str, chunk_index: int, data: bytes) -> None:
        self.blobs.put(chunk_output_key(scan_id, chunk_index), data)

    def latest_completed_job_id(self) -> Optional[str]:
        return self.state.lpop("completed")

    def raw_scan(self, scan_id: str) -> str:
        contents = []
        for key in self.blobs.list(f"{scan_id}/output/"):
            if key.endswith(".txt"):
                contents.append(self.blobs.get(key).decode("utf-8", "replace"))
        return "".join(contents)

    def parse_job(self, job_id: str) -> bool:
        """Parse one output chunk into the per-scan document collection.

        The reference (server.py:362-396) reads job metadata from a Mongo
        ``jobs`` collection nothing populates; this reads the live job
        record instead, keeping the route's observable behavior.
        """
        job = self._get_job_record(job_id)
        if job is None:
            return False
        content = self.output_chunk(job.scan_id, job.chunk_index)
        if content is None:
            return False
        self.docs.collection(job.scan_id).insert_one(
            {
                "scan_id": job.scan_id,
                "chunk_index": job.chunk_index,
                "module": job.module,
                "worker_id": job.worker_id,
                "start_time": job.started_at,
                "end_time": job.completed_at,
                "job_id": job_id,
                "content": content,
            }
        )
        return True

    # ------------------------------------------------------------------
    # blocking-ok: flush + journal clear must be one atom — a mutation
    # interleaved between them would survive into the next boot's replay
    def reset(self) -> None:
        """Flush all queue/scan state (reference /reset, server.py:550-554)."""
        with self._journal_lock:
            self.state.flushall()
            self._draining.clear()
            if self._journal is not None:
                # the journal must die with the state it describes, or
                # the next boot would resurrect a deliberately-flushed
                # queue (the generation counter survives — a reset is
                # an operational event, not a new server identity)
                self._journal.clear()
        with self._lock:
            self._rr_cursor = 0
            self._rr_cursor_x = 0
            self._express_streak = 0
        with self._gen_lock:
            self._jobs_generation += 1
        self._monitor_gauge()

    # ------------------------------------------------------------------
    # Durable journal: recovery + checkpointing (docs/DURABILITY.md)
    # ------------------------------------------------------------------
    # requires-lock: _journal_lock
    # blocking-ok: the snapshot read must exclude concurrent appends —
    # that exclusion is the journal lock's documented purpose
    def _journal_state(self) -> dict:
        """The full queue state in journal-snapshot form. Callers hold
        ``_journal_lock`` so no append can land between this read and
        the checkpoint that prunes the segments it covers."""
        jobs: dict[str, Any] = {}
        for job_id, raw in self.state.hgetall("jobs").items():
            try:
                jobs[job_id] = json.loads(raw)
            except ValueError:
                continue
        queues = {
            name: self.state.lrange(name, 0, -1)
            for name in self._queue_names()
        }
        monitors: dict[str, Any] = {}
        for mid, raw in self.state.hgetall("monitors").items():
            try:
                monitors[mid] = json.loads(raw)
            except ValueError:
                continue
        return {
            "jobs": jobs,
            "queues": queues,
            "tenants": self.tenants(),
            "rr_cursor": self._rr_cursor,
            "rr_cursor_x": self._rr_cursor_x,
            "monitors": monitors,
            "draining": dict(self._draining),
        }

    # blocking-ok: the snapshot->checkpoint pair holds _journal_lock so
    # no append lands between the state read and the segment prune
    def _maybe_checkpoint(self) -> None:
        """Opportunistic compaction: fold the WAL into a snapshot once
        enough segments accumulated. Runs on mutating routes' threads
        (never under ``_lock``); the unlucky caller pays one O(jobs)
        snapshot write — control-plane rates make that cheap, and the
        next boot's replay stays O(snapshot + recent WAL)."""
        journal = self._journal
        if journal is None:
            return
        if journal.segments_pending < journal.compact_segments:
            return
        with self._journal_lock:
            if journal.segments_pending < journal.compact_segments:
                return  # another thread compacted first
            try:
                journal.checkpoint(self._journal_state())
            except Exception as e:
                # compaction is an optimization: a failure must never
                # fail the mutating route that happened to trigger it —
                # the WAL just keeps growing until a checkpoint lands
                print(f"journal checkpoint failed (will retry): {e}")

    # blocking-ok: boot-time recovery runs before any route thread exists;
    # the post-recovery checkpoint holds _journal_lock like every other
    def recover(self) -> Optional[dict]:
        """Boot-time recovery: bump the server generation, replay the
        journal into the state store, reconcile against the idempotent
        chunk-output store, and re-arm leases with a short grace
        window. Returns a summary dict, or None when the journal holds
        no state (fresh deployment)."""
        journal = self._journal
        if journal is None:
            return None
        self.generation = journal.bump_generation()
        QUEUE_GENERATION.set(self.generation)
        if not journal.has_state():
            return None
        now = time.time()
        snapshot, records = journal.replay()

        jobs: dict[str, Job] = {}
        order: dict[str, int] = {}
        tenants: set[str] = set()
        monitors: dict[str, dict] = {}
        draining: dict[str, str] = {}
        cursor = 0
        cursor_x = 0
        idx = 0
        replayed = 0

        def _adopt(job_id: str, wire: dict) -> None:
            nonlocal idx
            try:
                jobs[job_id] = Job.from_wire(wire)
            except (KeyError, TypeError, ValueError):
                JOURNAL_CORRUPT.inc()
                return
            order[job_id] = idx
            idx += 1

        if snapshot:
            for job_id, wire in (snapshot.get("jobs") or {}).items():
                _adopt(job_id, wire)
                replayed += 1
            # the snapshot's queue lists carry the REAL dispatch order;
            # jobs they name sort ahead of later WAL mutations
            for ids in (snapshot.get("queues") or {}).values():
                for job_id in ids:
                    if job_id in order:
                        order[job_id] = idx
                        idx += 1
            tenants.update(
                t for t in (snapshot.get("tenants") or ()) if isinstance(t, str)
            )
            try:
                cursor = int(snapshot.get("rr_cursor") or 0)
            except (TypeError, ValueError):
                cursor = 0
            try:
                cursor_x = int(snapshot.get("rr_cursor_x") or 0)
            except (TypeError, ValueError):
                cursor_x = 0
            for mid, wire in (snapshot.get("monitors") or {}).items():
                if isinstance(wire, dict):
                    monitors[str(mid)] = wire
            for w, why in (snapshot.get("draining") or {}).items():
                if isinstance(w, str):
                    draining[w] = str(why or "drain")
        for rec in records:
            replayed += 1
            if rec.get("op") == "tenant":
                tenant = rec.get("tenant")
                if isinstance(tenant, str):
                    tenants.add(tenant)
                continue
            # monitor ops branch BEFORE the job fallback: an
            # unrecognized op would otherwise count as a corrupt job
            if rec.get("op") in ("monitor_spec", "monitor_epoch"):
                wire = rec.get("spec")
                if isinstance(wire, dict) and wire.get("monitor_id"):
                    monitors[str(wire["monitor_id"])] = wire
                else:
                    JOURNAL_CORRUPT.inc()
                continue
            if rec.get("op") == "monitor_rm":
                monitors.pop(str(rec.get("monitor_id") or ""), None)
                continue
            # drain-set ops branch BEFORE the job fallback too — the
            # same unknown-op-is-not-a-job rule the monitor ops follow
            if rec.get("op") == "drain":
                w = rec.get("worker")
                if isinstance(w, str):
                    draining[w] = str(rec.get("reason") or "drain")
                else:
                    JOURNAL_CORRUPT.inc()
                continue
            if rec.get("op") == "deregister":
                draining.pop(str(rec.get("worker") or ""), None)
                continue
            wire = rec.get("job")
            if not isinstance(wire, dict) or not wire.get("job_id"):
                JOURNAL_CORRUPT.inc()
                continue
            _adopt(str(wire["job_id"]), wire)
            if "rr_cursor" in rec:
                try:
                    cursor = int(rec["rr_cursor"])
                except (TypeError, ValueError):
                    pass
            if "rr_cursor_x" in rec:
                try:
                    cursor_x = int(rec["rr_cursor_x"])
                except (TypeError, ValueError):
                    pass
        JOURNAL_REPLAYED.inc(replayed)

        # tenant registry: journaled tenant ops plus every tenant a job
        # record names (belt and braces — the registry is reconstructed,
        # never trusted to survive)
        for job in jobs.values():
            if job.tenant:
                tenants.add(job.tenant)
        for tenant in sorted(tenants):
            self.state.hset("tenants", tenant, "1")

        # rebuild, never merge: on a backend whose state survived (real
        # Redis) stale dispatch lists / leases would double-push
        for name in set(self._queue_names()) | {"job_queue"}:
            self.state.lclear(name)
        for job_id in self.state.hkeys("leases"):
            self.state.hdel("leases", job_id)
        for mid in self.state.hkeys("monitors"):
            self.state.hdel("monitors", mid)

        # monitor cadence reconciliation (docs/MONITORING.md §Crash
        # points): a journaled epoch whose scan has no job record and no
        # output blob died between append and fire — flag it for ONE
        # late re-fire under its journaled scan id. Everything else
        # resumes its cadence from the journaled next_fire_at (a spec
        # that slept through N intervals is simply due, and the ticker's
        # `now + interval` advance fires it once, not N times).
        scan_ids = {j.scan_id for j in jobs.values()}
        for mid, spec in monitors.items():
            sid = spec.get("last_scan_id")
            if (
                sid
                and int(spec.get("epoch") or 0) > 0
                and sid not in scan_ids
                and not self.blobs.list(f"{sid}/output/")
            ):
                spec = dict(spec)
                spec["refire"] = True
                spec["next_fire_at"] = 0.0
                monitors[mid] = spec
            self.state.hset(
                "monitors", mid, json.dumps(monitors[mid], separators=(",", ":"))
            )
        self._monitor_gauge()

        grace = self.cfg.journal_recovery_grace_s or (
            self.cfg.lease_seconds / 2.0
        )
        counts = {
            "queued": 0, "leased": 0, "terminal": 0,
            "completed_from_store": 0,
        }
        queued: list[str] = []
        for job_id, job in jobs.items():
            # "output present ⇒ complete" only applies to jobs that
            # were actually DISPATCHED at least once (ACTIVE, or
            # requeued with attempts consumed): a never-dispatched
            # QUEUED job whose output key exists is a REUSED scan_id's
            # stale blob (/reset keeps chunk outputs, reference
            # behavior) and must re-execute, not adopt old results
            ran = job.status in JobStatus.ACTIVE or job.attempts > 0
            if (
                job.status not in JobStatus.TERMINAL
                and ran
                and self.blobs.exists(
                    chunk_output_key(job.scan_id, job.chunk_index)
                )
            ):
                # the idempotent chunk store is truth: output present
                # means the chunk WAS completed, whatever the journal
                # tail says — never re-execute finished work. (Not
                # pushed to the legacy `completed` pop-list: replaying
                # a pre-crash push would re-emit the chunk to a tail
                # client — docs/DURABILITY.md.)
                job.status = JobStatus.COMPLETE
                job.completed_at = job.completed_at or now
                job.lease_expires_at = None
                counts["completed_from_store"] += 1
            elif job.status == JobStatus.QUEUED:
                queued.append(job_id)
                counts["queued"] += 1
            elif job.status in JobStatus.ACTIVE:
                # recovered leases are EXPIRED down to a short grace
                # window: a live worker's next heartbeat re-leases its
                # job through the normal fenced renew path; a worker
                # that died with the server lets the grace lapse and
                # the job requeues through _requeue_expired
                job.lease_expires_at = now + grace
                self.state.hset(
                    "leases", job_id, str(job.lease_expires_at)
                )
                counts["leased"] += 1
            else:
                counts["terminal"] += 1
            self.state.hset("jobs", job_id, job.to_json())
        for job_id in sorted(queued, key=lambda j: order.get(j, 0)):
            # rebuilt into the job's OWN (tenant, QoS lane) list — a
            # restart must not demote recovered interactive jobs to
            # the bulk lane
            job = jobs[job_id]
            self.state.rpush(self._queue_list(job.tenant, job.qos), job_id)

        with self._lock:
            self._rr_cursor = cursor
            self._rr_cursor_x = cursor_x
        with self._journal_lock:
            # a worker told to drain before the crash stays refused
            # after it: the drain set survives restarts so a preempted
            # node can't be handed work during its kill-after-grace
            self._draining = dict(draining)
        with self._gen_lock:
            self._jobs_generation += 1
        for outcome, n in counts.items():
            if n:
                QUEUE_RECOVERED.labels(outcome=outcome).inc(n)
        # fold everything into a fresh snapshot so the NEXT boot's
        # replay is O(live state), not O(history). Best-effort:
        # recovery already succeeded, and the un-compacted WAL replays
        # identically next time.
        with self._journal_lock:
            try:
                journal.checkpoint(self._journal_state())
            except Exception as e:
                print(f"post-recovery checkpoint failed (will retry): {e}")
        summary = {
            "generation": self.generation,
            "replayed_records": replayed,
            "monitors": len(monitors),
            "draining": len(draining),
            **counts,
        }
        # re-register unfinished scans with the waterfall assembler
        # under their ORIGINAL trace ids — a kill-9'd scan's recovered
        # attempts land in the same trace the client started, which is
        # what links pre- and post-restart work in `swarm trace`
        if tracing.enabled():
            by_scan: dict[str, list[Job]] = {}
            for job in jobs.values():
                by_scan.setdefault(job.scan_id, []).append(job)
            for scan_id, sjobs in by_scan.items():
                done = sum(
                    1 for j in sjobs if j.status in JobStatus.TERMINAL
                )
                if done >= len(sjobs):
                    continue
                trace_id = next((j.trace_id for j in sjobs if j.trace_id), None)
                admitted = min(
                    (j.admitted_at for j in sjobs
                     if isinstance(j.admitted_at, (int, float))),
                    default=None,
                )
                self.tracer.register_scan(
                    scan_id, trace_id, admitted, len(sjobs),
                    qos=next((j.qos for j in sjobs if j.qos), None),
                    tenant=next((j.tenant for j in sjobs if j.tenant), None),
                    generation=self.generation,
                    done=done,
                )
                if trace_id:
                    self.tracer.add_spans(scan_id, [tracing.make_span(
                        "journal-recovery", trace_id, now, 0.0,
                        generation=self.generation,
                        recovered_jobs=len(sjobs),
                    )])
        # always-on flight dump: the ring captured the pre-replay boot
        # context, and post-mortems of whatever killed the previous
        # generation start here
        tracing.flight_dump(
            "journal_recovery",
            detail=f"generation={self.generation} replayed={replayed}",
        )
        emit_event("queue.recovered", **summary)
        return summary
