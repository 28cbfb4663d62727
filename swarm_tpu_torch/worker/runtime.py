"""Worker poll loop of the port — the backends of
``swarm_tpu/worker/runtime.py``.

Same observable protocol as the JAX worker: poll ``/get-job``, walk the job
through ``starting → downloading → executing → uploading → complete`` (or
``cmd failed`` / ``upload failed - unknown``) via ``/update-job``, with 0.8 s
between jobs and 10 s when idle, and stop after ``max_jobs`` attempts when
that is set. Every backend runs on ``device`` (the card unless the CPU
is asked for) where it has device work, its output byte-identical to the
JAX worker's:

- ``jarm`` probes each target with the ten JARM ClientHellos and clusters
  the fingerprints with the density-peaks kernels;
- ``tpu`` (``fingerprint`` and other template modules) matches response
  rows against the module's template corpus with the port's
  ``MatchEngine``, one engine per templates directory, its corpus served
  by the compile cache (``fingerprints/dbcache.py``). Rows come as
  ``jsonl`` input or are probed from ``targets`` in double-buffered
  waves (``worker/streaming.py``); output is one JSONL hit line per row
  or nuclei's ``[id] [protocol] [severity] url`` lines, followed by the
  lines of any workflow a row's hits trigger (``ops/workflows.py``).
  With ``pipeline: on`` (``SWARM_PIPELINE``) the engine runs the
  continuous-batching scheduler (``sched/``): ``jsonl`` lines decode on
  its prefetch thread, chunk by chunk, and results come back in chunk
  order; the job's perf fields carry ``pipeline``, the scheduler's
  ``sched`` snapshot and ``inflight_saturation``;
- ``probe`` (``dnsx``, ``httpx``, ``http2``, ``httprobe``, ``web``)
  probes the targets with the native front-end, no matching;
- ``service`` (``servicescan``) probes banners with payloads from an
  nmap-service-probes DB and classifies them with the port's
  ``ServiceClassifier`` (the card prefilters every signature);
- ``active`` (``nuclei``, ``active``) issues each template's own
  requests per target in waves and matches the responses on the
  corpus's ``MatchEngine`` (``worker/active.py``), with the DNS,
  network, session, ssl and workflow passes. A probe spec with ``oob``
  (``nuclei-oob``) runs the interaction listener (``worker/oob.py``):
  OOB probes defer until its poll window closes, then match with their
  interactions like any wave. The browserless headless subset runs on
  the host (``worker/headless.py``), overlapped with the waves. Chunk 0
  also carries the scan's scope lines: ``[oob-skipped]`` for OOB
  templates still unplanned, ``[headless-skipped]`` for js-required
  headless templates, and ``[coverage]``;
- ``file`` matches local files against the corpus's ``file`` templates
  (``worker/filescan.py``), ``ssl`` runs its ``ssl`` templates over TLS
  handshakes on the host (``worker/sslscan.py``);
- a module without a backend runs its ``command`` through the shell in
  the worker's ``work_dir`` and ends ``cmd failed`` on a non-zero exit.

The worker survives what the JAX worker survives (``resilience/``):

- the client is a :class:`RetryingServerClient` over
  :class:`ServerClient`: jittered backoff and a breaker per operation;
  a dead server raises :class:`TransportError`, an idle queue is
  ``None``;
- a :class:`LeaseHeartbeat` renews the job's lease every
  ``heartbeat_interval_s`` (``lease_seconds / 3`` when 0) while the
  chunk runs;
- a finished chunk whose upload or completion cannot reach the server
  goes to the :class:`OutputSpool` (``spool_dir``, else
  ``<work_dir>/spool``) and is replayed after the next successful poll;
- a new ``X-Swarm-Generation`` (a restarted server) resets the
  transport breakers;
- SIGTERM or an ``X-Swarm-Drain`` answer drains the worker: it finishes
  the current chunk, replays the spool, deregisters and returns
  (:meth:`JobProcessor.drain`);
- fault points ``transport.<op>``, ``executor.run`` and
  ``worker.drain`` serve the fault harness (``SWARM_FAULT_PLAN``).

The worker reports what the JAX worker reports (``telemetry/``):

- the completed job's ``perf`` fields: the phase seconds
  (``download_s``, ``execute_s``, ``upload_s``), input and output bytes,
  and for the ``tpu`` and ``active`` backends the engine's deltas over
  the job (``rows``, ``device_s``, ``host_confirm_s``; ``phase_a_s`` and
  ``phase_b_s`` only while tracing is on), ``pipeline``, ``sched`` and
  ``inflight_saturation``, then the scan counters and
  ``breakers_open`` — with tracing off, the JAX worker's keys in its
  order. The server rolls ``rows`` and ``device_s`` up into the scan's
  ``rows_processed`` and ``rows_per_second``;
- with tracing on (``SWARM_TRACE``) and a job that carries a
  ``trace_id``, one span batch per attempt: the ``attempt`` root, its
  ``download``, ``execute`` and ``upload`` children, under ``execute``
  the ``device`` span (with ``device.phase_a`` and ``device.phase_b``)
  and the ``walk`` span synthesized from the engine's deltas, and the
  ``sched`` span of a pipelined drive. Up to 256 spans ride the
  completed job's ``perf["spans"]``; a larger batch, or a failed
  attempt's, goes to ``POST /spans``;
- events keyed by the job's trace id: ``job.start``, ``job.phase``,
  ``job.worker_done``, ``job.spooled``, ``worker.server_restarted``,
  ``worker.stopped`` (``SWARM_EVENTS``, or in-process subscribers);
- on the registry: ``swarm_worker_phase_seconds{phase}``,
  ``swarm_worker_jobs_total{outcome}``, the rows counter and rows/s
  gauge, the last-poll gauge, poll errors, the server generation and
  restarts, and the drain's outcome and seconds;
- with ``SWARM_PROFILE_DIR`` set, a ``torch.profiler`` trace of each
  job's execute (``utils/trace.py``).

The worker starts as the JAX worker starts: ``--config <path>`` (or
``~/.swarm_tpu.json``, then ``~/.axiom.json``), then ``SWARM_<FIELD>``,
then the flags (``swarm_tpu_torch/config.py``); the modules of
``prewarm_modules`` (``SWARM_PREWARM_MODULES``) build their engines
before the first poll. A ``tpu`` engine on a host with several cards
shards its batches over all of them (``parallel/``); given the whole
``SWARM_COORDINATOR`` / ``SWARM_NUM_PROCESSES`` / ``SWARM_PROCESS_ID``
triplet the worker joins a process group first
(``parallel/multihost.py``). With ``SWARM_CACHE_BACKEND`` set
(``memory``, or ``redis`` at ``SWARM_CACHE_URL`` / ``SWARM_REDIS_URL``)
every engine the worker builds gets the fleet result tier
(``swarm_tpu_torch/cache``): content any worker resolved is served
without the card. A tier that cannot be built prints why and the engine
runs L1-only, as the JAX worker's does.

Not ported yet (ROADMAP.md): the executable cache.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Union

import requests
import torch

from swarm_tpu_torch import config
from swarm_tpu_torch.aot import build_aot_client
from swarm_tpu_torch.cache import build_result_cache
from swarm_tpu_torch.datamodel import SCAN_ID_RE, JobStatus
from swarm_tpu_torch.fingerprints.dbcache import load_or_compile
from swarm_tpu_torch.fingerprints.model import Response
from swarm_tpu_torch.fingerprints.nuclei import load_corpus
from swarm_tpu_torch.ops import cluster as cl
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.ops.service import ServiceClassifier
from swarm_tpu_torch.ops.workflows import WorkflowRunner
from swarm_tpu_torch.parallel.multihost import maybe_initialize_distributed
from swarm_tpu_torch.resilience.breaker import breaker_states
from swarm_tpu_torch.resilience.faults import FaultInjected, fault_point, install_plan
from swarm_tpu_torch.resilience.heartbeat import LeaseHeartbeat
from swarm_tpu_torch.resilience.spool import OutputSpool
from swarm_tpu_torch.resilience.transport import RetryingServerClient, TransportError
from swarm_tpu_torch.telemetry import REGISTRY, emit_event, tracing
from swarm_tpu_torch.telemetry.fleet_export import WORKER_DRAIN, WORKER_DRAIN_SECONDS
from swarm_tpu_torch.utils.device import resolve_device
from swarm_tpu_torch.utils.trace import PhaseTimer, maybe_device_profile
from swarm_tpu_torch.worker import filescan, formats, sslscan
from swarm_tpu_torch.worker.active import ActiveScanner
from swarm_tpu_torch.worker.executor import ProbeExecutor
from swarm_tpu_torch.worker.streaming import stream_match
from swarm_tpu_torch.worker.modules import (
    ModuleRegistry,
    ModuleSpec,
    format_match_line,
    parse_response_line,
)

# the worker's families (the JAX worker's): remote workers' phase
# timings also reach the server through the job's perf fields
_PHASE_SECONDS = REGISTRY.histogram(
    "swarm_worker_phase_seconds",
    "Per-phase job pipeline seconds measured on the worker",
    ("phase",),
)
_JOBS_PROCESSED = REGISTRY.counter(
    "swarm_worker_jobs_total",
    "Jobs processed by this worker, by outcome",
    ("outcome",),
)
_LAST_POLL = REGISTRY.gauge(
    "swarm_worker_last_poll_timestamp",
    "Unix time of this worker's most recent /get-job poll (heartbeat)",
)
_ROWS_PER_SEC = REGISTRY.gauge(
    "swarm_worker_rows_per_second",
    "Rows/sec of the most recently completed device job",
)
_ROWS_TOTAL = REGISTRY.counter(
    "swarm_worker_rows_total", "Device-engine rows processed by this worker"
)
_POLL_ERRORS = REGISTRY.counter(
    "swarm_worker_poll_errors_total",
    "Polls that failed with a transport error (server down ≠ idle queue)",
)
_SERVER_GENERATION = REGISTRY.gauge(
    "swarm_worker_server_generation",
    "Control-plane generation last observed on a successful poll",
)
_SERVER_RESTARTS = REGISTRY.counter(
    "swarm_worker_server_restarts_total",
    "Control-plane generation changes observed by this worker",
)

#: span batches up to this size ride the completed job's ``perf``
#: field; larger batches (long scans) ship out of band via ``POST /spans``
_SPAN_INLINE_MAX = 256


@dataclasses.dataclass
class WorkerConfig:
    server_url: str = "http://127.0.0.1:5001"
    api_key: str = "CHANGE_THIS"
    worker_id: str = "worker-0"
    modules_dir: str = "modules"
    max_jobs: int = 0  # 0 = unlimited
    poll_interval_idle_s: float = 10.0
    poll_interval_busy_s: float = 0.8
    pipeline: str = "off"  # the continuous-batching flag of tpu engines
    #: an interactive row older than this forces an early partial-bucket
    #: flush in the scheduler's planner (only interactive rows consult it)
    qos_deadline_ms: float = 50.0
    #: max-age flush for every bucket class; 0 = off (a partial bucket
    #: waits for end of stream)
    sched_max_age_ms: float = 0.0
    #: the server's lease on a dispatched job
    lease_seconds: float = 600.0
    #: seeded fault-injection plan (``resilience/faults`` grammar);
    #: empty = fault points are no-ops
    fault_plan: str = ""
    # the retrying transport: jittered exponential backoff and a circuit
    # breaker per operation around the ServerClient
    transport_retries: int = 3
    transport_backoff_s: float = 0.2
    transport_backoff_max_s: float = 5.0
    transport_breaker_threshold: int = 5
    transport_breaker_cooldown_s: float = 10.0
    #: lease renewal cadence while a chunk runs (0 = lease_seconds / 3)
    heartbeat_interval_s: float = 0.0
    #: spool of finished chunks the server could not take
    #: ("" = <work_dir>/spool)
    spool_dir: str = ""
    #: comma-separated modules whose engines or scanners are built
    #: before the first poll (:meth:`JobProcessor.prewarm`)
    prewarm_modules: str = ""
    #: the Redis the tier's ``redis`` backend reaches unless
    #: ``cache_url`` names another
    redis_url: str = "redis://127.0.0.1:6379/0"
    # fleet result cache (swarm_tpu_torch/cache): the shared
    # content-addressed result tier behind each engine's verdict memo.
    #: "off" leaves every path unchanged; "memory" shares one embedded
    #: tier across this process's engines; "redis" goes fleet-wide
    cache_backend: str = "off"
    #: the tier's Redis URL ("" = ``redis_url``)
    cache_url: str = ""
    #: blob-spill directory for oversized values on the redis backend
    #: ("" = state store only; the memory backend spills to an embedded
    #: blob store regardless)
    cache_spill_dir: str = ""
    #: promote the batched walk's confirm cache as the tier's second
    #: value family
    cache_confirm: bool = True
    #: write freshly walked results back (off = read-only consumer)
    cache_writeback: bool = True
    #: breaker around every tier operation: a dead backend degrades the
    #: scan to L1-only, it never blocks it
    cache_breaker_threshold: int = 3
    cache_breaker_cooldown_s: float = 30.0
    #: TTL and size policy of the shared namespaces: 0 = backend
    #: eviction and epoch bumps only; the max-entry bound applies to
    #: each value family's namespace, oldest entries first
    cache_ttl_s: float = 0.0
    cache_max_entries: int = 0
    # AOT library cache (swarm_tpu_torch/aot): ship the built kernel
    # libraries through the shared stores so a joining worker fetches
    # instead of running nvcc. "off" keeps the per-process build;
    # "memory" shares one embedded store across this process (tests);
    # "local" is file-backed under aot_dir (cross-process on one host);
    # "redis" goes fleet-wide (state via aot_url/redis_url, payload
    # blobs in aot_dir)
    aot_backend: str = "off"
    #: the store's Redis URL ("" = ``redis_url``)
    aot_url: str = ""
    #: artifact directory of the local backend / the redis blob side
    aot_dir: str = ""
    #: publish locally built libraries back to the store (off =
    #: read-only consumer)
    aot_publish: bool = True
    #: fetch every published same-group library at engine bring-up
    #: (off = fetched as each library is first loaded)
    aot_prewarm: bool = True
    #: breaker around every store operation: a dead backend degrades to
    #: local builds, it never blocks
    aot_breaker_threshold: int = 3
    aot_breaker_cooldown_s: float = 30.0

    @classmethod
    def load(cls, path: Optional[str] = None, env=None, **overrides) -> "WorkerConfig":
        """Defaults, then the config file (``path``, which must load;
        else ``~/.swarm_tpu.json`` or ``~/.axiom.json``), then the
        environment, then ``overrides`` not None, as the JAX worker's
        ``Config.load`` reads them (``swarm_tpu_torch/config.py``)."""
        return config.load(cls, path=path, env=env, **overrides)

    @classmethod
    def from_env(cls, **overrides) -> "WorkerConfig":
        """:meth:`load` without a config file: defaults, the
        environment, then ``overrides`` not None."""
        return config.load(cls, read_files=False, **overrides)


class ServerClient:
    """HTTP client for the worker-facing server API.

    Connection failures and 5xx answers raise :class:`TransportError`,
    so a caller can tell "server down" from "queue empty" or a contract
    rejection. Each operation declares a ``transport.<op>`` fault point.
    """

    def __init__(self, server_url: str, api_key: str, timeout: float = 30.0):
        self.base = server_url.rstrip("/")
        self.timeout = timeout
        self.session = requests.Session()
        self.session.headers["Authorization"] = f"Bearer {api_key}"
        #: the server's generation from the last /get-job answer's
        #: X-Swarm-Generation header (None until the first successful
        #: poll): the poll loop watches it to see a server restart
        self.last_server_generation: Optional[int] = None
        #: the drain order of the last /get-job answer's X-Swarm-Drain
        #: header (its reason, or None): the poll loop passes it to
        #: :meth:`JobProcessor.request_drain`
        self.last_drain_reason: Optional[str] = None

    def _request(self, op: str, method: str, path: str, detail=None, **kw):
        fault_point(f"transport.{op}", detail=detail, exc=TransportError)
        try:
            resp = self.session.request(
                method, f"{self.base}{path}", timeout=self.timeout, **kw
            )
        except requests.RequestException as e:
            raise TransportError(f"{op}: {e}") from e
        if resp.status_code >= 500:
            raise TransportError(f"{op}: server error {resp.status_code}")
        return resp

    def get_job(self, worker_id: str) -> Optional[dict]:
        resp = self._request(
            "get_job", "GET", "/get-job", params={"worker_id": worker_id}
        )
        gen = resp.headers.get("X-Swarm-Generation")
        if gen is not None:
            try:
                self.last_server_generation = int(gen)
            except ValueError:
                pass
        self.last_drain_reason = resp.headers.get("X-Swarm-Drain")
        return resp.json() if resp.status_code == 200 else None

    def update_job(
        self, job_id: str, changes: dict, worker_id: Optional[str] = None
    ) -> bool:
        if worker_id is not None:
            changes = {**changes, "worker_id": worker_id}  # fencing token
        resp = self._request(
            "update_job", "POST", f"/update-job/{job_id}", json=changes
        )
        return resp.status_code == 200

    def get_input_chunk(self, scan_id: str, chunk_index: int) -> Optional[bytes]:
        resp = self._request(
            "get_chunk", "GET", f"/get-input-chunk/{scan_id}/{chunk_index}"
        )
        return resp.content if resp.status_code == 200 else None

    def put_output_chunk(self, scan_id: str, chunk_index: int, data: bytes) -> bool:
        resp = self._request(
            "put_chunk", "POST", f"/put-output-chunk/{scan_id}/{chunk_index}",
            detail=f"{scan_id}_{chunk_index}", data=data,
        )
        return resp.status_code == 200

    def post_spans(self, scan_id: str, spans: list) -> bool:
        """Ship a span batch out of band: an attempt's batch too large
        to ride the completed job's perf field, or a failed attempt's,
        which has no perf field to ride."""
        resp = self._request(
            "post_spans", "POST", "/spans", detail=scan_id,
            json={"scan_id": scan_id, "spans": spans},
        )
        return resp.status_code == 200

    def renew_lease(
        self, job_id: str, worker_id: str, saturation: Optional[float] = None
    ) -> bool:
        """Renew one lease; False = the lease is no longer ours.
        ``saturation`` (0..1, optional) reports the scheduler's
        in-flight saturation to the server's admission."""
        body = {"worker_id": worker_id}
        if saturation is not None:
            body["saturation"] = saturation
        resp = self._request(
            "renew_lease", "POST", f"/renew-lease/{job_id}",
            detail=job_id, json=body,
        )
        return resp.status_code == 200

    def deregister(self, worker_id: str) -> bool:
        """Tell the server this worker is leaving now: its leases go
        back at once and its saturation report is dropped."""
        resp = self._request(
            "deregister", "POST", "/deregister",
            detail=worker_id, json={"worker_id": worker_id},
        )
        return resp.status_code == 200


class JobProcessor:
    def __init__(
        self,
        cfg: WorkerConfig,
        client: Optional[ServerClient] = None,
        registry: Optional[ModuleRegistry] = None,
        device: Optional[Union[str, torch.device]] = None,
        work_dir: Optional[str] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.fault_plan:
            install_plan(cfg.fault_plan)
        if client is None:
            client = RetryingServerClient(
                ServerClient(cfg.server_url, cfg.api_key),
                retries=cfg.transport_retries,
                backoff_s=cfg.transport_backoff_s,
                backoff_max_s=cfg.transport_backoff_max_s,
                breaker_threshold=cfg.transport_breaker_threshold,
                breaker_cooldown_s=cfg.transport_breaker_cooldown_s,
            )
        self.client = client
        self.registry = registry or ModuleRegistry(cfg.modules_dir)
        #: where a command module's chunk files are written
        self.work_dir = Path(work_dir or tempfile.mkdtemp(prefix="swarm_worker_"))
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.spool = OutputSpool(cfg.spool_dir or self.work_dir / "spool")
        self.jobs_done = 0
        #: what a job builds once and the worker keeps: the MatchEngine
        #: per templates directory, its WorkflowRunner under
        #: ``wfrunner::<dir>`` (with the db it was built over), the ServiceClassifier under
        #: ``svc::<probes_db>``, the ActiveScanner under
        #: ``active::<dir>::<probe spec and vars>``, the FileScanner under
        #: ``file::<dir>::<scan_root>``, the SslScanner under
        #: ``ssl::<dir>::<probe spec>``
        self.engines: dict = {}
        #: (engine, its cumulative counts) at the start of the current
        #: job on a MatchEngine, if any: the job's perf fields report
        #: the deltas (:meth:`_engine_perf_delta`)
        self._engine_stats_mark: Optional[tuple] = None
        #: the current job's scan counters (an active job's), perf fields
        self._scan_perf_extra: dict = {}
        #: the drain order's reason, set by SIGTERM, an X-Swarm-Drain
        #: answer or a caller: the poll loop finishes its current chunk,
        #: then runs :meth:`drain` and returns
        self.drain_requested: Optional[str] = None
        #: how the drain that ended process_jobs went (None until then):
        #: "completed" | "spooled" | "idle" | "aborted"
        self.drain_outcome: Optional[str] = None
        #: True while a leased chunk is processed (decides the drain
        #: outcome: "completed" or "idle")
        self._job_in_flight = False
        #: True when the drain order came mid-chunk: the chunk was
        #: finished first, and the drain reports "completed"
        self._drained_mid_job = False
        #: the heartbeat of the last chunk (its renewals, for callers)
        self._last_heartbeat: Optional[LeaseHeartbeat] = None
        #: the scheduler's last in-flight saturation (0..1; None until a
        #: pipelined engine reports): renewals carry it
        self._last_saturation: Optional[float] = None
        #: the server generation seen on the last successful poll
        self._seen_generation: Optional[int] = None

    def prewarm(self, module_name: str) -> bool:
        """Build a module's engine or scanner before the first job: an
        empty-input execution of its backend runs exactly the
        construction path. For a ``tpu`` module on the card that is the
        kernel libraries' build, the corpus load and the upload of the
        device layout. A failure is printed → False; a command module
        has nothing to warm → False."""
        try:
            module = self.registry.load(module_name)
            dispatch = {
                "tpu": self._execute_tpu,
                "probe": self._execute_probe,
                "service": self._execute_service,
                "jarm": self._execute_jarm,
                "active": self._execute_active,
                "file": self._execute_file,
                "ssl": self._execute_ssl,
            }.get(module.backend)
            if dispatch is None:
                return False
            dispatch(module, b"")
            if module.backend == "tpu":
                self.engine_for(module.templates_dir).prewarm()
            return True
        except Exception as e:
            print(f"prewarm {module_name} failed: {e}")
            return False

    def request_drain(self, reason: str) -> None:
        """Ask the poll loop to drain: finish the current chunk, flush
        or spool, deregister, return. Safe from a signal handler or
        another thread — it only sets a flag. The first reason wins."""
        if self.drain_requested is None:
            self.drain_requested = reason
            if self._job_in_flight:
                self._drained_mid_job = True

    def process_jobs(self) -> None:
        """The poll loop; returns after ``cfg.max_jobs`` chunks that
        returned when set (a chunk whose processing raises is not
        counted, as the JAX worker counts), or after a drain."""
        while True:
            if self.drain_requested is not None:
                # process_chunk is synchronous: reaching this check
                # means no chunk is in flight
                self.drain(self.drain_requested)
                return
            try:
                _LAST_POLL.set(time.time())
                job = self.client.get_job(self.cfg.worker_id)
            except TransportError as e:
                # server down is not "queue empty" (the retrying client
                # already spent its backoff)
                _POLL_ERRORS.inc()
                print(f"server unreachable: {e}")
                time.sleep(self.cfg.poll_interval_idle_s)
                continue
            except Exception as e:
                print(f"error getting job: {e}")
                time.sleep(self.cfg.poll_interval_idle_s)
                continue
            self._note_server_generation()
            # a drain order on the poll's answer: the server offers no
            # more jobs — drain now instead of sleeping an idle interval
            drain = getattr(self.client, "last_drain_reason", None)
            if drain:
                self.request_drain(drain)
                continue
            # the poll proved the server reachable: flush the chunks
            # spooled while it was down (idempotent through fencing)
            self._replay_spool()
            try:
                if job:
                    self._job_in_flight = True
                    try:
                        self.process_chunk(job)
                    finally:
                        self._job_in_flight = False
                    # a chunk that ended (failed jobs included) counts;
                    # one whose processing raised does not
                    self.jobs_done += 1
                    if self.cfg.max_jobs and self.jobs_done >= self.cfg.max_jobs:
                        return
                else:
                    time.sleep(self.cfg.poll_interval_idle_s)
            except Exception as e:
                print(f"error processing job: {e}")
                time.sleep(self.cfg.poll_interval_idle_s)
            time.sleep(self.cfg.poll_interval_busy_s)

    def _note_server_generation(self) -> None:
        """A server restart: a new X-Swarm-Generation on the poll that
        just succeeded. The poll itself re-registered this worker on the
        server; here the transport breakers that the dead process earned
        are closed, so the heartbeat and upload paths resume at once."""
        gen = getattr(self.client, "last_server_generation", None)
        if gen is None or gen == self._seen_generation:
            return
        prior = self._seen_generation
        self._seen_generation = gen
        _SERVER_GENERATION.set(gen)
        if prior is None:
            return  # first contact, not a restart
        _SERVER_RESTARTS.inc()
        breakers = getattr(self.client, "breakers", None)
        if breakers is not None:
            breakers.reset_all()
        emit_event(
            "worker.server_restarted",
            worker_id=self.cfg.worker_id,
            generation=gen,
            prior_generation=prior,
        )
        print(
            f"server restarted (generation {prior} -> {gen}); "
            "re-registered and reset transport breakers"
        )

    def _replay_spool(self) -> None:
        if not len(self.spool):
            return
        try:
            cleared = self.spool.replay(self.client)
        except Exception as e:
            print(f"spool replay failed: {e}")
            return
        if cleared:
            print(f"spool: replayed {cleared} finished chunk(s)")

    def drain(self, reason: str) -> str:
        """The graceful exit. The current chunk already finished
        (process_jobs calls this only between chunks), so what is left
        is flushing the spool while the server is reachable, then
        deregistering (the server hands the leases back at once). An
        armed ``worker.drain`` fault point aborts the sequence: the node
        dies mid-drain, and recovery rides the on-disk spool and the
        fencing instead."""
        t0 = time.monotonic()
        outcome = "completed" if self._drained_mid_job else "idle"
        try:
            fault_point("worker.drain", detail=self.cfg.worker_id)
            self._replay_spool()
            if len(self.spool):
                # the replay could not clear everything (server gone
                # again): the chunks stay spooled for the next process
                outcome = "spooled"
            try:
                self.client.deregister(self.cfg.worker_id)
            except Exception as e:
                print(f"drain: deregister undeliverable: {e}")
        except FaultInjected:
            # injected death mid-drain: no replay, no deregister
            outcome = "aborted"
        self.drain_outcome = outcome
        elapsed = time.monotonic() - t0
        WORKER_DRAIN.labels(outcome=outcome).inc()
        WORKER_DRAIN_SECONDS.labels().observe(elapsed)
        emit_event(
            "worker.stopped",
            worker_id=self.cfg.worker_id,
            reason=reason,
            outcome=outcome,
            jobs_done=self.jobs_done,
            drain_seconds=round(elapsed, 4),
        )
        print(f"worker drained ({reason}): {outcome} in {elapsed:.2f}s")
        return outcome

    def process_chunk(self, job: dict) -> None:
        job_id = job.get("job_id") or f"{job['scan_id']}_{job['chunk_index']}"
        scan_id, chunk_index = job["scan_id"], int(job["chunk_index"])
        trace_id = job.get("trace_id")
        # the server validates scan ids, but they flow into URL paths
        if not SCAN_ID_RE.match(str(scan_id)):
            self.client.update_job(job_id, {"status": JobStatus.CMD_FAILED})
            _JOBS_PROCESSED.labels(outcome=JobStatus.CMD_FAILED).inc()
            return
        timer = PhaseTimer()
        # the attempt's span collector (None when tracing is off or the
        # job carries no trace id: the completed-job payload is then
        # byte-identical to the untraced worker's)
        ctx = tracing.attempt_context(
            trace_id,
            job_id=job_id,
            attempt=job.get("attempts"),
            worker_id=self.cfg.worker_id,
            module=job.get("module"),
        )

        def _ship_spans(extra: dict) -> dict:
            """Close the attempt root; inline the batch on the perf
            field when small, else POST /spans (also the only path for
            a failed attempt, which carries no perf)."""
            spans = ctx.finish()
            if not spans:
                return extra
            perf = extra.get("perf")
            if isinstance(perf, dict) and len(spans) <= _SPAN_INLINE_MAX:
                return {**extra, "perf": {**perf, "spans": spans}}
            try:
                self.client.post_spans(scan_id, spans)
            except Exception as e:
                print(f"span batch undeliverable: {e}")
            return extra

        def update(status: str, **extra) -> Optional[bool]:
            if status in JobStatus.TERMINAL and ctx is not None:
                extra = _ship_spans(extra)
            try:
                ok = self.client.update_job(
                    job_id, {"status": status, **extra}, worker_id=self.cfg.worker_id
                )
            except TransportError as e:
                # server unreachable mid-job: a lost phase update is
                # harmless (the lease covers us); a lost completion is
                # spooled by the caller. None is not False: False means
                # the server refused (fencing)
                print(f"update {status!r} undeliverable: {e}")
                ok = None
            if status not in JobStatus.TERMINAL:
                emit_event(
                    "job.phase",
                    trace_id=trace_id,
                    job_id=job_id,
                    worker_id=self.cfg.worker_id,
                    phase=status,
                )
            else:
                # one observation a phase a job: the job-level latency
                # distributions of the registry
                seconds, _counters = timer.snapshot()
                for phase, secs in seconds.items():
                    _PHASE_SECONDS.labels(phase=phase).observe(secs)
                _JOBS_PROCESSED.labels(outcome=status).inc()
                emit_event(
                    "job.worker_done",
                    trace_id=trace_id,
                    job_id=job_id,
                    worker_id=self.cfg.worker_id,
                    status=status,
                    perf=extra.get("perf"),
                )
            return ok

        self._engine_stats_mark = None
        self._scan_perf_extra = {}
        emit_event(
            "job.start",
            trace_id=trace_id,
            job_id=job_id,
            worker_id=self.cfg.worker_id,
            module=job.get("module"),
        )
        # the lease heartbeat: renewals from a background thread while
        # the chunk runs, so a long chunk never outlives its lease
        hb = LeaseHeartbeat(
            self.client,
            job_id,
            self.cfg.worker_id,
            self.cfg.heartbeat_interval_s or self.cfg.lease_seconds / 3.0,
            saturation_fn=lambda: self._last_saturation,
        )
        self._last_heartbeat = hb
        hb.start()
        try:
            with tracing.activate(ctx):
                self._run_chunk(job, job_id, scan_id, chunk_index, timer, update)
        finally:
            hb.stop()

    def _run_chunk(
        self, job: dict, job_id: str, scan_id: str, chunk_index: int,
        timer: PhaseTimer, update,
    ) -> None:
        """Download → execute → upload under a running heartbeat."""
        update(JobStatus.STARTING)
        update(JobStatus.DOWNLOADING)
        with timer.phase("download"), tracing.span("download"):
            data = self.client.get_input_chunk(scan_id, chunk_index)
        if data is None:
            update(JobStatus.CMD_FAILED)
            return

        update(JobStatus.EXECUTING)
        try:
            module = self.registry.load(job["module"])
        except (OSError, ValueError) as e:
            print(f"module load failed: {e}")
            update(JobStatus.CMD_FAILED)
            return
        execute = {
            "jarm": self._execute_jarm,
            # the job's qos (the server sets it from ``swarm scan --qos``)
            # plans its rows into the scheduler's express or bulk buckets
            "tpu": lambda m, d: self._execute_tpu(m, d, qos=job.get("qos")),
            "probe": self._execute_probe,
            "service": self._execute_service,
            "file": self._execute_file,
            "ssl": self._execute_ssl,
        }.get(module.backend)
        # kept by name: after a successful execute the engine's deltas
        # become device and walk child spans under it
        exec_span = tracing.span("execute", module=job.get("module"))
        try:
            with (timer.phase("execute"),
                  maybe_device_profile(job_id, device=self.device), exec_span):
                # fail (or delay) this chunk's execution; the detail
                # carries the job id, so a plan can poison one job
                fault_point("executor.run", detail=job_id)
                if module.backend == "active":
                    output = self._execute_active(module, data, chunk_index=chunk_index)
                elif execute is None:  # the reference's command fallback
                    output = self._execute_command(module, scan_id, chunk_index, data)
                else:
                    output = execute(module, data)
        except Exception as e:  # one bad chunk must not stop the worker
            print(f"execution failed: {type(e).__name__}: {e}")
            update(JobStatus.CMD_FAILED, message=f"{type(e).__name__}: {e}")
            return
        if output is None:  # a command that exited non-zero
            update(JobStatus.CMD_FAILED)
            return

        update(JobStatus.UPLOADING)
        unreachable = False
        with timer.phase("upload"), tracing.span("upload"):
            try:
                ok = self.client.put_output_chunk(scan_id, chunk_index, output)
            except TransportError:
                # server unreachable after the retries: the chunk's work
                # is paid for — never lose it (spooled below)
                ok = False
                unreachable = True
            except requests.RequestException:
                ok = False
        if not (ok or unreachable):
            update(JobStatus.UPLOAD_FAILED_UNKNOWN)
            return
        perf = timer.perf()
        perf["input_bytes"] = len(data)
        perf["output_bytes"] = len(output)
        perf.update(self._engine_perf_delta())
        perf.update(self._scan_perf_extra)
        ctx = tracing.current_context()
        if ctx is not None:
            self._synth_engine_spans(ctx, perf, exec_span)
        # this worker's breakers that are not closed (transport and
        # device) ride the perf fields to the server
        open_breakers = {k: v for k, v in breaker_states().items() if v != "closed"}
        if open_breakers:
            perf["breakers_open"] = open_breakers
        rows = perf.get("rows")
        exec_s = perf.get("execute_s")
        if isinstance(rows, (int, float)) and math.isfinite(rows) and rows > 0:
            _ROWS_TOTAL.inc(rows)
            if exec_s and math.isfinite(exec_s):
                _ROWS_PER_SEC.set(rows / exec_s)
        done = True
        if ok:
            done = update(JobStatus.COMPLETE, perf=perf)
        if unreachable or done is None:
            # finished work outlives the outage: spool the output and
            # its completion, replayed on reconnect (the fencing token
            # discards it if the job was re-leased)
            self._spool_finished(job_id, scan_id, chunk_index, output, perf)

    def _spool_finished(
        self, job_id: str, scan_id: str, chunk_index: int, output: bytes, perf: dict
    ) -> None:
        self.spool.put(job_id, scan_id, chunk_index, self.cfg.worker_id, output, perf=perf)
        _JOBS_PROCESSED.labels(outcome="spooled").inc()
        emit_event(
            "job.spooled",
            job_id=job_id,
            worker_id=self.cfg.worker_id,
            scan_id=scan_id,
            chunk_index=chunk_index,
        )
        print(f"server unreachable; spooled finished chunk {job_id}")

    def _synth_engine_spans(self, ctx, perf: dict, exec_span) -> None:
        """Fold the engine's device and walk seconds of the job into
        child spans of the execute span. The card holds no wall clock
        of its own, so the phases are laid out one after another from
        the execute span's start; the durations are the EngineStats
        deltas (phase A and B when tracing reported them)."""
        parent = getattr(exec_span, "span_id", None)
        start = getattr(exec_span, "start", None)
        if parent is None or start is None:
            return
        device_s = perf.get("device_s") or 0.0
        walk_s = perf.get("host_confirm_s") or 0.0
        if device_s > 0:
            dev_id = ctx.add_synth(
                "device", start, device_s, parent_id=parent,
                rows=perf.get("rows"), pipeline=perf.get("pipeline"),
            )
            pa = perf.get("phase_a_s") or 0.0
            pb = perf.get("phase_b_s") or 0.0
            if pa > 0:
                ctx.add_synth("device.phase_a", start, pa, parent_id=dev_id)
            if pb > 0:
                ctx.add_synth("device.phase_b", start + pa, pb, parent_id=dev_id)
        if walk_s > 0:
            ctx.add_synth("walk", start + device_s, walk_s, parent_id=parent)

    def _mark_engine_stats(self, engine: MatchEngine) -> None:
        """Take the engine's cumulative counts at job start, so
        :meth:`_engine_perf_delta` reports this job's share."""
        ds = engine.stats
        self._engine_stats_mark = (
            engine, ds.rows, ds.device_seconds, ds.host_confirm_seconds,
            ds.phase_a_seconds, ds.phase_b_seconds,
        )

    def _engine_perf_delta(self) -> dict:
        """The engine's counts over this job (the worker keeps engines
        across jobs), as the JAX worker reports them: ``rows``,
        ``device_s``, ``host_confirm_s``; ``phase_a_s`` and ``phase_b_s``
        only while tracing is on (with tracing off the payload stays
        the untraced worker's); ``pipeline``; once the scheduler has
        run, its cumulative ``sched`` snapshot and
        ``inflight_saturation``, the share of its wall time the submit
        thread waited on the prefetch stage (later renewals carry it).
        The port has no mesh, so no ``mesh``."""
        mark = self._engine_stats_mark
        if mark is None:
            return {}
        engine, rows0, dev0, confirm0, pa0, pb0 = mark
        ds = engine.stats
        out = {
            "rows": ds.rows - rows0,
            "device_s": round(ds.device_seconds - dev0, 6),
            "host_confirm_s": round(ds.host_confirm_seconds - confirm0, 6),
        }
        if tracing.enabled():
            pa = round(ds.phase_a_seconds - pa0, 6)
            pb = round(ds.phase_b_seconds - pb0, 6)
            if pa > 0:
                out["phase_a_s"] = pa
            if pb > 0:
                out["phase_b_s"] = pb
        out["pipeline"] = engine.pipeline
        sched = engine._sched
        if sched is not None:
            snap = sched.stats.snapshot()
            out["sched"] = snap
            wall = snap["wall_seconds"]
            if wall > 0:
                saturation = min(1.0, snap["stall_seconds"] / wall)
                out["inflight_saturation"] = round(saturation, 4)
                self._last_saturation = saturation
        return out

    def _execute_jarm(self, module: ModuleSpec, data: bytes) -> bytes:
        """Active TLS fingerprinting (JARM + JA3S) with density-peaks
        clustering of the fingerprints on ``self.device``. Output: one
        line per target with its fingerprint, cluster label, and cluster
        size."""
        fps = ProbeExecutor(module.probe).run_jarm(
            data.decode("utf-8", "surrogateescape").splitlines()
        )
        alive = [fp for fp in fps if fp.alive]
        lab: list[int] = []
        sizes: dict[int, int] = {}
        if alive:
            radius = float(module.raw.get("cluster_radius", 32.0))
            packed = cl.pack_strings([fp.jarmx for fp in alive])
            labels, _rho = cl.density_cluster(packed, radius, device=self.device)
            lab = [int(x) for x in labels]
            for label in lab:
                sizes[label] = sizes.get(label, 0) + 1
        lines = []
        alive_iter = iter(lab)
        for fp in fps:
            if fp.alive:
                label = next(alive_iter)
                lines.append(
                    f"{fp.line()} cluster={label} cluster_size={sizes[label]}"
                )
            else:
                lines.append(fp.line())
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def engine_for(self, templates_dir: str) -> MatchEngine:
        """The MatchEngine of a corpus, built at first use and kept for
        the worker's lifetime, as the JAX worker keeps its own: its
        verdict memo and content caches serve later jobs' known content,
        and its walk pool is sized as the reference sizes it
        (``SWARM_WALK_THREADS``, else the spare cores up to 4). The
        corpus compile comes from the disk cache when the corpus and
        the port's compiler are unchanged (``dbcache.load_or_compile``).
        The engine takes the reference's mesh default: on a host with
        several cards, a mesh over all of them."""
        engine = self.engines.get(templates_dir)
        if engine is None:
            # multi-host engine bring-up: join the process group BEFORE
            # the engine's auto-mesh resolves, so the mesh spans every
            # process's devices. Idempotent and a no-op without the
            # SWARM_COORDINATOR/-NUM_PROCESSES/-PROCESS_ID triplet —
            # embedded workers (started without main()) get the same
            # bring-up as the CLI path
            maybe_initialize_distributed(devices=_dist_devices(self.device))
            aot = self._attach_aot()
            templates, db = load_or_compile(templates_dir)
            engine = MatchEngine(
                templates, db=db, device=self.device, pipeline=self.cfg.pipeline
            )
            if aot is not None:
                engine.attach_aot(aot)
            # fleet-wide result tier: rows any worker has ever resolved
            # short-circuit before device dispatch.
            # SWARM_CACHE_BACKEND=off (default) skips this entirely; a
            # tier that can't be built must not kill engine bring-up —
            # the cache is an accelerator, never a dependency
            try:
                client = build_result_cache(self.cfg)
                if client is not None:
                    engine.attach_result_cache(client)
            except Exception as e:
                print(f"result cache unavailable ({e}); running L1-only")
            self.engines[templates_dir] = engine
        return engine

    def _attach_aot(self):
        """The AOT library cache at engine bring-up: a joining worker
        FETCHES the kernel libraries the fleet has built instead of
        running nvcc on each. The port's engine loads its libraries when
        it is built, so the client is attached to the process's loader
        and prewarmed here, before the engine. SWARM_AOT_BACKEND=off
        (default) skips this; a store that cannot be built or prewarmed
        must not kill bring-up — the libraries then build locally from
        the same sources (breaker-wrapped, never blocks). → the client,
        or None."""
        try:
            aot = build_aot_client(self.cfg)
            if aot is not None:
                kernels.attach_aot(aot)
                if self.cfg.aot_prewarm:
                    t0 = time.perf_counter()
                    n = kernels.aot_prewarm()
                    if n:
                        print(
                            f"AOT prewarm: {n} executables loaded "
                            f"in {time.perf_counter() - t0:.2f}s"
                        )
            return aot
        except Exception as e:
            print(f"AOT executable cache unavailable ({e}); "
                  "compiling locally")
            return None

    def _execute_tpu(self, module: ModuleSpec, data: bytes, qos: Optional[str] = None) -> bytes:
        """Device-batch path: chunk rows → MatchEngine → JSONL hits (or
        nuclei lines), then the workflow lines.

        ``input_format: targets`` first runs the native probe front-end
        (resolve + connect + banner/HTTP fetch) to build the rows,
        probing wave i+1 while wave i matches. With the engine's
        pipeline on, ``jsonl`` lines decode on the scheduler's prefetch
        thread, a chunk of ``batch_rows`` lines at a time."""
        if not module.templates_dir:
            raise ValueError(f"tpu module {module.name} missing 'templates'")
        engine = self.engine_for(module.templates_dir)
        self._mark_engine_stats(engine)
        text = data.decode("utf-8", "surrogateescape")
        if module.input_format == "targets":
            rows, results, _stats = stream_match(
                engine,
                text.splitlines(),
                probe_spec=module.probe,
                wave_targets=int(module.raw.get("wave_targets", 1024)),
            )
        elif engine.pipeline == "on":
            # continuous-batching path: line decode runs on the
            # scheduler's prefetch stage — chunk i+1 parses while chunk
            # i's batch rides the card — and rows are re-binned into
            # padding buckets with memo short-circuiting. Results are
            # bit-identical to the direct path.
            lines = text.splitlines()
            step = engine.batch_rows
            payloads = [
                (ci, lines[s : s + step])
                for ci, s in enumerate(range(0, len(lines), step))
            ] or [(0, [])]
            rows_by_chunk: dict = {}

            def decode(payload):
                ci, chunk_lines = payload
                out = []
                for line in chunk_lines:
                    row = parse_response_line(line)
                    if row is not None:
                        out.append(row)
                rows_by_chunk[ci] = out
                return out

            rows = []
            results = []
            sched = engine.scheduler()
            # the operator's deadline knobs reach the planner here (the
            # scheduler is engine-lazy; the engine never sees the cfg)
            sched.config.qos_deadline_ms = self.cfg.qos_deadline_ms
            sched.config.max_age_ms = self.cfg.sched_max_age_ms
            # "sched" = the continuous-batching drive window (planning,
            # coalescing, deadline flushes); the engine's device and
            # walk seconds ride the synthesized spans instead
            with tracing.span("sched", qos=qos, pipeline="on"):
                for ci, res in enumerate(sched.run(payloads, decode=decode, qos=qos)):
                    rows.extend(rows_by_chunk.pop(ci))
                    results.extend(res)
        else:
            rows = []
            for line in text.splitlines():
                row = parse_response_line(line)
                if row is not None:
                    rows.append(row)
            results = engine.match(rows)
        # workflow gating over the already-matched rows (ops/workflows):
        # one wf line per row where a trigger gated matching subtemplates
        wf_lines: list[str] = []
        if any(t.protocol == "workflow" for t in engine.templates):
            wkey = f"wfrunner::{module.templates_dir}"
            # kept with the db it was built over: a runner holds its
            # corpus's workflow plan, so after the engine's corpus
            # refresh (a new db) it is built anew
            built_for, runner = self.engines.get(wkey, (None, None))
            if built_for is not engine.db:
                runner = WorkflowRunner(engine.templates, engine=engine)
                self.engines[wkey] = (engine.db, runner)
            jsonl = module.output_format != "nuclei"
            for row, rm in zip(rows, results):
                if not rm.template_ids:
                    continue  # nothing matched: no workflow can trigger
                per = runner.evaluate_hits(
                    set(rm.template_ids), lambda _tid, _r=row: [_r]
                )
                for wid, sub_ids in sorted(per.items()):
                    if jsonl:  # keep the jsonl contract machine-readable
                        wf_lines.append(
                            json.dumps(
                                {
                                    "workflow": wid,
                                    "host": row.host,
                                    "port": row.port,
                                    "matches": sub_ids,
                                },
                                sort_keys=True,
                            )
                        )
                    else:
                        wf_lines.append(
                            f"[{wid}] [workflow] {row.host}:{row.port} "
                            f"[{','.join(sub_ids)}]"
                        )
        if module.output_format == "nuclei":
            sev, proto = formats.severity_index(engine.templates)
            out = formats.format_nuclei(rows, results, sev, proto)
            if wf_lines:
                out = out + "\n".join(wf_lines) + "\n"
            return out.encode()
        out_lines = [format_match_line(row, m) for row, m in zip(rows, results)]
        out_lines += wf_lines
        return ("\n".join(out_lines) + "\n").encode() if out_lines else b""

    def _execute_probe(self, module: ModuleSpec, data: bytes) -> bytes:
        """Native-I/O-only path (dnsx/httprobe/httpx/web module parity):
        probe the targets with the native front-end and emit the
        module's output format — no template matching involved."""
        lines = data.decode("utf-8", "surrogateescape").splitlines()
        executor = ProbeExecutor(module.probe)
        if module.probe.get("type") == "dns":
            resolutions = executor.resolve(lines)
            return formats.format_dnsx(
                resolutions, with_a=bool(module.probe.get("with_a"))
            ).encode()
        rows = executor.run(lines)
        if module.output_format == "httprobe":
            return formats.format_httprobe(rows).encode()
        if module.output_format == "httpx_json":
            return formats.format_httpx_json(rows).encode()
        raise ValueError(
            f"module {module.name}: unknown output_format {module.output_format!r}"
        )

    def _execute_service(self, module: ModuleSpec, data: bytes) -> bytes:
        """Service/version detection (the nmap -sV replacement): native
        banner probing with payloads from the probes DB, the match
        prefilter on ``self.device``, host version extraction. The
        classifier is built once per probes DB and kept for the
        worker's lifetime."""
        key = f"svc::{module.raw.get('probes_db') or ''}"
        classifier = self.engines.get(key)
        if classifier is None:
            classifier = ServiceClassifier(
                db_path=module.raw.get("probes_db"), device=self.device
            )
            self.engines[key] = classifier
        rows, sent = ProbeExecutor(module.probe).run_service(
            data.decode("utf-8", "surrogateescape").splitlines(), classifier
        )
        infos = classifier.classify(rows, sent)
        if module.output_format == "nmap":
            return formats.format_nmap_report(infos).encode()
        lines = [info.line() for info in infos if info.open]
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def _execute_active(
        self, module: ModuleSpec, data: bytes, chunk_index: int = 0
    ) -> bytes:
        """Active template-request scanning (nuclei's execution mode):
        each template's own requests are issued per target, the
        responses matched on the corpus's engine (``self.device``), hits
        attributed per request (``worker/active.py``). The scanner is
        kept per templates directory, probe spec and template vars."""
        if not module.templates_dir:
            raise ValueError(f"active module {module.name} missing 'templates'")
        engine = self.engine_for(module.templates_dir)
        self._mark_engine_stats(engine)
        # keyed by probe spec + vars too: two modules sharing a
        # templates dir but differing in ports/timeouts/concurrency or
        # operator-supplied template vars must not alias
        user_vars = module.raw.get("vars") or None
        probe_key = json.dumps([module.probe or {}, user_vars], sort_keys=True)
        key = f"active::{module.templates_dir}::{probe_key}"
        scanner = self.engines.get(key)
        if scanner is None:
            scanner = ActiveScanner(engine, module.probe, user_vars=user_vars)
            self.engines[key] = scanner
        target_lines = data.decode("utf-8", "surrogateescape").splitlines()
        hits, stats = scanner.run(target_lines)
        sev, proto = formats.severity_index(engine.templates)
        lines = []
        for h in hits:
            p = proto.get(h.template_id, "http")
            target = (
                formats.url_of(Response(host=h.host, port=h.port, tls=h.tls)) + h.path
                if p == "http"
                else f"{h.host}:{h.port}"
            )
            extra = " [" + ",".join(h.extractions) + "]" if h.extractions else ""
            lines.append(
                f"[{h.template_id}] [{p}] [{sev.get(h.template_id, 'info')}] "
                f"{target}{extra}"
            )
        print(
            f"active scan: {stats['rows_probed']} requests over "
            f"{stats.get('live_targets', 0)} live targets, {len(lines)} hits"
        )
        # the scan counters in the job's perf fields, as the JAX worker
        # reports them
        self._scan_perf_extra = {
            k: stats[k]
            for k in (
                "targets", "live_targets", "rows_probed",
                "oob_probes", "oob_interactions", "session_hits",
                "workflow_hits",
            )
            if k in stats
        }
        self._scan_perf_extra["hits"] = len(lines)
        # scope lines, once per scan (chunk 0 only: a sharded scan's
        # merged output would repeat them per chunk)
        if chunk_index == 0:
            for tid in scanner.oob_limited:
                lines.append(
                    f"# [{tid}] [oob-skipped] interactsh-dependent "
                    "checks not evaluated (no out-of-band interaction "
                    "server)"
                )
            for tid in scanner.plan.skipped.get("protocol-headless", []):
                lines.append(
                    f"# [{tid}] [headless-skipped] requires a browser "
                    "engine; not evaluated"
                )
            # one line per remaining skip class (file/ssl run under
            # their own modules; sessions execute the chain classes)
            for reason, ids in sorted(stats["skipped_templates"].items()):
                if reason.startswith("protocol-") or reason == "oob-interactsh":
                    continue  # surfaced above / handled elsewhere
                lines.append(f"# [coverage] {reason}: {ids} templates not executed")
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def _execute_file(self, module: ModuleSpec, data: bytes) -> bytes:
        """File-template scanning: input lines are file or directory
        paths, matched against the corpus's ``file`` templates in one
        batch on ``self.device`` (``worker/filescan.py``)."""
        if not module.templates_dir:
            raise ValueError(f"file module {module.name} missing 'templates'")
        scan_root = module.raw.get("scan_root") or None
        key = f"file::{module.templates_dir}::{scan_root}"
        scanner = self.engines.get(key)
        if scanner is None:
            templates, _errors = load_corpus(module.templates_dir)
            scanner = filescan.FileScanner(
                templates, scan_root=scan_root, device=self.device
            )
            self.engines[key] = scanner
        findings, stats = scanner.scan_paths(
            data.decode("utf-8", "surrogateescape").splitlines()
        )
        print(
            f"file scan: {stats['files_scanned']} files x "
            f"{stats['templates']} templates, {stats['hits']} hits"
        )
        return filescan.format_findings(findings)

    def _execute_ssl(self, module: ModuleSpec, data: bytes) -> bytes:
        """ssl-protocol templates: version-pinned handshakes and matchers
        over the session and certificate document, on the host
        (``worker/sslscan.py``)."""
        if not module.templates_dir:
            raise ValueError(f"ssl module {module.name} missing 'templates'")
        probe = module.probe or {}
        key = f"ssl::{module.templates_dir}::{json.dumps(probe, sort_keys=True)}"
        scanner = self.engines.get(key)
        if scanner is None:
            templates, _errors = load_corpus(module.templates_dir)
            scanner = sslscan.SslScanner(
                templates,
                concurrency=int(probe.get("concurrency", 32)),
                timeout=float(probe.get("connect_timeout_ms", 4000)) / 1000.0,
            )
            self.engines[key] = scanner
        findings, stats = scanner.scan(
            data.decode("utf-8", "surrogateescape").splitlines()
        )
        print(
            f"ssl scan: {stats['targets']} targets x {stats['templates']} "
            f"templates, {stats['hits']} hits"
        )
        return sslscan.format_findings(findings)

    def _execute_command(
        self, module: ModuleSpec, scan_id: str, chunk_index: int, data: bytes
    ) -> Optional[bytes]:
        """The module's command through the shell over the chunk's input
        file → its output file (else its stdout); None on a non-zero
        exit, which fails the job."""
        job_dir = self.work_dir / scan_id
        job_dir.mkdir(parents=True, exist_ok=True)
        input_file = job_dir / f"chunk_{chunk_index}.txt"
        output_file = job_dir / f"chunk_{chunk_index}.out.txt"
        input_file.write_bytes(data)
        command = module.command(str(input_file), str(output_file))
        proc = subprocess.run(
            command, shell=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
        if proc.returncode != 0:
            print(f"Error executing command: {command}")
            print(proc.stderr.decode("utf-8", "replace"))
            return None
        return output_file.read_bytes() if output_file.is_file() else proc.stdout


def _dist_devices(device) -> Optional[list]:
    """The devices a worker on ``device`` runs its ranks on, for the
    process group's backend choice: the CPU for ``cpu``, else None
    (every visible card)."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"]
    return None


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="swarm_tpu_torch worker"
    )
    parser.add_argument("--server-url", default=None)
    parser.add_argument("--api-key", default=None)
    parser.add_argument("--worker-id", default=None)
    parser.add_argument("--modules-dir", default=None)
    parser.add_argument("--max-jobs", type=int, default=None)
    parser.add_argument("--config", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device for the kernels (default: cuda)",
    )
    args = parser.parse_args(argv)
    cfg = WorkerConfig.load(
        path=args.config,
        server_url=args.server_url,
        api_key=args.api_key,
        worker_id=args.worker_id,
        modules_dir=args.modules_dir,
        max_jobs=args.max_jobs,
    )
    # multi-host worker: join the process group when configured
    # (SWARM_COORDINATOR/-NUM_PROCESSES/-PROCESS_ID) so the tpu
    # backend's mesh spans every process's devices; no-op single-host
    if maybe_initialize_distributed(devices=_dist_devices(args.device)):
        print("multi-host: torch.distributed initialized")
    proc = JobProcessor(cfg, device=args.device)
    # SIGTERM drains instead of dying mid-upload: the handler only sets
    # a flag; the poll loop finishes its chunk, flushes or spools, and
    # deregisters. Off the main thread a process cannot own signals.
    try:
        signal.signal(signal.SIGTERM, lambda _sig, _frm: proc.request_drain("sigterm"))
    except ValueError:
        pass
    for name in filter(None, (n.strip() for n in cfg.prewarm_modules.split(","))):
        if proc.prewarm(name):
            print(f"prewarmed module {name}")
    proc.process_jobs()
