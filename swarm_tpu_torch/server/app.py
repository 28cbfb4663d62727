"""HTTP REST C2 server — the port's copy of ``swarm_tpu/server/app.py``.

The same routes, methods, payload shapes, status codes, headers and
bearer-token auth as the JAX package's server, so either package's
client and worker work against either server. It is built on the
stdlib threading HTTP server. Besides the original swarm server's 11
routes, these let workers move chunk data over HTTP instead of needing
direct S3 credentials:

    GET  /get-input-chunk/<scan>/<chunk>     (the original worker hits S3)
    POST /put-output-chunk/<scan>/<chunk>
    GET  /healthz                            (unauthenticated liveness:
                                              uptime, queue depth,
                                              jobs by state)
    GET  /metrics                            (unauthenticated Prometheus
                                              text exposition)
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlparse

from swarm_tpu_torch.config import Config
from swarm_tpu_torch.datamodel import (
    SCAN_ID_RE,
    JobStatus,
    chunk_generator,
    chunk_output_key,
)
from swarm_tpu_torch.gateway.admission import (
    DEFAULT_TENANT,
    AdmissionController,
    PressureSnapshot,
)
from swarm_tpu_torch.gateway.qos import QOS_HEADER, QOS_INTERACTIVE, parse_qos
from swarm_tpu_torch.gateway.qoscache import build_gateway_cache
from swarm_tpu_torch.gateway.streaming import stream_scan
from swarm_tpu_torch.monitor.feed import feed_prefix, stream_feed
from swarm_tpu_torch.monitor.service import MonitorService
from swarm_tpu_torch.monitor.spec import MONITOR_ID_RE, MonitorSpec
from swarm_tpu_torch.server.fleet import AutoscaleAdvisor, build_provider
from swarm_tpu_torch.server.queue import JobQueueService
from swarm_tpu_torch.stores import build_stores
from swarm_tpu_torch.telemetry import REGISTRY
from swarm_tpu_torch.telemetry import tracing
from swarm_tpu_torch.telemetry.events import emit_event, header_trace_id, new_trace_id
from swarm_tpu_torch.telemetry.gateway_export import (
    GATEWAY_LATENCY,
    GATEWAY_QUEUED,
    GATEWAY_SHORT_CIRCUIT,
)
from swarm_tpu_torch.telemetry.metrics import CONTENT_TYPE as _METRICS_CTYPE

_HTTP_REQUESTS = REGISTRY.counter(
    "swarm_http_requests_total",
    "HTTP requests handled by the C2 server",
    ("route", "method", "code"),
)
_HTTP_LATENCY = REGISTRY.histogram(
    "swarm_http_request_seconds",
    "C2 server request handling latency",
    ("route",),
)
_QUEUE_DEPTH = REGISTRY.gauge(
    "swarm_queue_depth", "Jobs waiting in the dispatch queue"
)
_JOBS_BY_STATE = REGISTRY.gauge(
    "swarm_jobs_by_state", "Job records by current status", ("status",)
)
_UPTIME = REGISTRY.gauge(
    "swarm_server_uptime_seconds", "Seconds since the C2 server started"
)


class SwarmServer:
    """Route table + dispatch. Handlers return (status, body, content_type)."""

    def __init__(self, cfg: Config, queue: Optional[JobQueueService] = None, fleet=None):
        self.cfg = cfg
        self.started_at = time.time()
        from swarm_tpu_torch.resilience.faults import active_plan, install_plan

        if cfg.fault_plan:
            install_plan(cfg.fault_plan)  # deterministic chaos (tests/soak)
        else:
            active_plan()  # registers the armed-state gauge for /metrics
        # span tracing (docs/OBSERVABILITY.md §Tracing): config can arm
        # it process-wide but never forces it OFF — an operator's
        # SWARM_TRACE=1 env wins over an unset config field
        if cfg.trace_enabled:
            tracing.set_enabled(True)
        # see _advertise_url: captured before any bind mutates it. A URL
        # a PRIOR server instance derived (cfg.server_url_derived) still
        # counts as defaulted — a supervisor reusing one Config across
        # restarts must get a fresh alignment, not the dead previous
        # port advertised as operator-explicit.
        self._url_was_default = (
            cfg.server_url == Config.server_url or cfg.server_url_derived
        )
        if queue is None:
            state, blobs, docs = build_stores(cfg)
            # flight-recorder persistence (docs/OBSERVABILITY.md
            # §Tracing): the sink must attach BEFORE the queue is
            # constructed — journal recovery fires its flight dump
            # from inside JobQueueService.__init__, and a sink attached
            # after would miss exactly the dump that motivates
            # persisting the ring
            self._flight_unsub = tracing.FLIGHT.add_sink(
                tracing.blob_flight_sink(blobs)
            )
            fleet = fleet if fleet is not None else build_provider(cfg)
            queue = JobQueueService(cfg, state, blobs, docs, fleet=fleet)
        else:
            self._flight_unsub = tracing.FLIGHT.add_sink(
                tracing.blob_flight_sink(queue.blobs)
            )
        self.queue = queue
        self.fleet = fleet if fleet is not None else queue.fleet
        # multi-tenant front door (docs/GATEWAY.md): admission control
        # + the queue-depth-driven autoscale advisor (dry-run default)
        self.gateway = AdmissionController.from_config(cfg)
        self.autoscaler = AutoscaleAdvisor.from_config(
            self.queue, self.fleet, cfg
        )
        # preemption notices close the loop (docs/RESILIENCE.md
        # §Preemption): a provider that issues them (SimulatedProvider)
        # drains the doomed worker server-side, so dispatch stops
        # offering it jobs the moment the notice lands — the worker
        # itself learns via the X-Swarm-Drain header on its next poll
        if (
            hasattr(self.fleet, "on_preempt_notice")
            and self.fleet.on_preempt_notice is None
        ):
            queue_ref = self.queue
            self.fleet.on_preempt_notice = (
                lambda name: queue_ref.drain_worker(name, reason="preempted")
            )
        # the post-grace force-kill deregisters the name authoritatively:
        # leases requeue NOW (not at lease expiry) and the drain entry
        # clears, so a replacement node reusing the name starts clean
        # even when the killed worker was too wedged to drain itself
        if (
            hasattr(self.fleet, "on_kill")
            and self.fleet.on_kill is None
        ):
            queue_ref = self.queue
            self.fleet.on_kill = (
                lambda name: queue_ref.deregister_worker(name)
            )
        # gateway-tier result cache (docs/GATEWAY.md §QoS): interactive
        # submissions whose chunks are fleet-known complete HERE with
        # zero worker dispatch. None (the default: cache_backend=off)
        # keeps the submit path byte-identical; a backend that can't be
        # built must not kill the server — the cache is an accelerator,
        # never a dependency.
        self.qos_cache = None
        try:
            self.qos_cache = build_gateway_cache(cfg)
        except Exception as e:
            print(f"gateway scan cache unavailable ({e}); pass-through")
        # continuous monitoring (docs/MONITORING.md): the ticker thread
        # is server-lifecycle-owned; the DURABLE spec registry lives in
        # the queue (journaled). The verdict-plane store shares the
        # gateway cache's tier instance so both views of the shared
        # tier agree within this process; with no tier it degrades to
        # rebuilding planes from the change feed.
        self.monitor: Optional[MonitorService] = None
        if getattr(cfg, "monitor_enabled", True):
            tier = (
                self.qos_cache._tier if self.qos_cache is not None else None
            )
            if tier is None:
                try:
                    from swarm_tpu_torch.cache.tier import build_tier

                    tier = build_tier(cfg)
                except Exception:
                    tier = None
            self.monitor = MonitorService(
                self.queue, cfg, submit=self._submit_monitor_epoch, tier=tier
            )
            self.monitor.start()
        self._routes: list[tuple[str, re.Pattern, Callable, str]] = []
        self._register_routes()
        self._httpd: Optional[ThreadingHTTPServer] = None
        # scrape-time queue gauges: depth + jobs-by-state read from the
        # state store only when /metrics (or snapshot()) renders, never
        # on the dispatch hot path. Weakref'd so servers a test drops
        # without shutdown() don't stay scrapable forever; removed
        # explicitly on shutdown.
        self._seen_states: set[str] = set()
        self._seen_tenants: set[str] = set()
        import weakref

        ref = weakref.ref(self)

        def _collector() -> None:
            srv = ref()
            if srv is not None:
                srv._collect_queue_gauges()

        self._collector = _collector
        REGISTRY.add_collector(self._collector)

    def _collect_queue_gauges(self) -> None:
        _UPTIME.set(time.time() - self.started_at)
        _QUEUE_DEPTH.set(self.queue.queue_depth())
        counts = self.queue.jobs_by_state()
        for status in self._seen_states - set(counts):
            _JOBS_BY_STATE.labels(status=status).set(0)
        for status, n in counts.items():
            _JOBS_BY_STATE.labels(status=status).set(n)
        self._seen_states |= set(counts)
        depths = self.queue.tenant_depths()
        for tenant in self._seen_tenants - set(depths):
            GATEWAY_QUEUED.labels(tenant=tenant).set(0)
        for tenant, n in depths.items():
            GATEWAY_QUEUED.labels(tenant=tenant).set(n)
        self._seen_tenants |= set(depths)

    # ------------------------------------------------------------------
    def _register_routes(self) -> None:
        def r(method, pattern, handler, name):
            self._routes.append((method, re.compile(pattern), handler, name))

        r("GET", r"^/healthz$", self._healthz, "/healthz")
        r("GET", r"^/metrics$", self._metrics, "/metrics")
        r("GET", r"^/get-statuses$", self._get_statuses, "/get-statuses")
        r("POST", r"^/update-job/(?P<job_id>[^/]+)$", self._update_job, "/update-job")
        r("POST", r"^/renew-lease/(?P<job_id>[^/]+)$", self._renew_lease, "/renew-lease")
        r("GET", r"^/dead-letter$", self._dead_letter, "/dead-letter")
        r("POST", r"^/requeue-job/(?P<job_id>[^/]+)$", self._requeue_job, "/requeue-job")
        r("GET", r"^/get-chunk/(?P<scan_id>[^/]+)/(?P<chunk_id>[^/]+)$", self._get_chunk, "/get-chunk")
        r("GET", r"^/get-latest-chunk$", self._get_latest_chunk, "/get-latest-chunk")
        r("GET", r"^/parse_job/(?P<job_id>[^/]+)$", self._parse_job, "/parse_job")
        r("GET", r"^/raw/(?P<scan_id>[^/]+)$", self._raw, "/raw")
        r("POST", r"^/queue$", self._queue_job, "/queue")
        r("GET", r"^/get-job$", self._get_job, "/get-job")
        r("POST", r"^/spans$", self._post_spans, "/spans")
        r("GET", r"^/trace/(?P<scan_id>[^/]+)$", self._get_trace, "/trace")
        r("GET", r"^/stream/(?P<scan_id>[^/]+)$", self._stream, "/stream")
        r("POST", r"^/monitor$", self._monitor_post, "/monitor")
        r("GET", r"^/monitor$", self._monitor_list, "/monitor")
        r("POST", r"^/monitor/(?P<monitor_id>[^/]+)$", self._monitor_update, "/monitor-update")
        r("GET", r"^/monitor-feed/(?P<monitor_id>[^/]+)$", self._monitor_feed, "/monitor-feed")
        r("GET", r"^/tenants$", self._tenants, "/tenants")
        r("GET", r"^/autoscale$", self._autoscale_recommend, "/autoscale")
        r("POST", r"^/autoscale$", self._autoscale_apply, "/autoscale")
        r("POST", r"^/spin-up$", self._spin_up, "/spin-up")
        r("POST", r"^/spin-down$", self._spin_down, "/spin-down")
        r("POST", r"^/drain/(?P<worker_id>[^/]+)$", self._drain_worker, "/drain")
        r("POST", r"^/deregister$", self._deregister, "/deregister")
        r("POST", r"^/reset$", self._reset, "/reset")
        r("GET", r"^/get-input-chunk/(?P<scan_id>[^/]+)/(?P<chunk_id>[^/]+)$", self._get_input_chunk, "/get-input-chunk")
        r("POST", r"^/put-output-chunk/(?P<scan_id>[^/]+)/(?P<chunk_id>[^/]+)$", self._put_output_chunk, "/put-output-chunk")

    # ------------------------------------------------------------------
    # Handlers — signatures:
    #   (match, query, body_bytes, headers) -> (code, body, ctype)
    # ------------------------------------------------------------------
    @staticmethod
    def _json(code: int, payload: Any) -> tuple[int, bytes, str]:
        return code, json.dumps(payload).encode(), "application/json"

    @staticmethod
    def _text(code: int, text: str) -> tuple[int, bytes, str]:
        return code, text.encode(), "text/html; charset=utf-8"

    def _healthz(self, m, q, body, h):
        # real liveness, not a static ok: load balancers and tests can
        # assert the queue is actually reachable behind this process.
        # Resilience surface (docs/RESILIENCE.md): dead-letter count and
        # in-process breaker states show degradation without Prometheus.
        from swarm_tpu_torch.resilience.breaker import breaker_states
        from swarm_tpu_torch.resilience.faults import active_plan

        by_state = self.queue.jobs_by_state()
        plan = active_plan()
        snap = self._pressure_snapshot()
        return self._json(
            200,
            {
                "status": "ok",
                "uptime_seconds": round(time.time() - self.started_at, 3),
                "queue_depth": self.queue.queue_depth(),
                "jobs_by_state": by_state,
                "dead_letter_jobs": by_state.get(JobStatus.DEAD_LETTER, 0),
                "breakers": breaker_states(),
                "fault_plan": plan.spec if plan is not None else "",
                # gateway surface (docs/GATEWAY.md): load shed starts
                # at pressure >= gateway_shed_pressure. COUNT only —
                # tenant ids are client data and this endpoint is
                # unauthenticated; the id list lives on authenticated
                # GET /tenants
                "pressure": round(self.gateway.pressure(snap), 4),
                "tenant_count": len(self.queue.tenants()),
                # durability surface (docs/DURABILITY.md): the
                # monotonic control-plane generation (0 = journal off)
                # and what boot-time recovery materialized, so "did the
                # restart lose anything" is one curl away
                "generation": self.queue.generation,
                "recovery": self.queue.recovery_summary,
                # elastic-fleet surface (docs/RESILIENCE.md
                # §Preemption): the advisor's last target vs the
                # provider's actual node count, plus which workers are
                # mid-drain — COUNTS and the advisor dict only, no
                # tenant ids (unauthenticated endpoint)
                "autoscale": self.autoscaler.status(),
                "draining_workers": len(self.queue.draining_workers()),
            },
        )

    def _renew_lease(self, m, q, body, h):
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        # heartbeats double as the saturation feed: a worker whose
        # scheduler is stalling on a full in-flight window says so here,
        # and admission pressure rises BEFORE the queue does
        if data.get("worker_id") and "saturation" in data:
            self.gateway.note_saturation(
                data["worker_id"], data.get("saturation")
            )
        expiry = self.queue.renew_lease(m["job_id"], data.get("worker_id"))
        if expiry is None:
            # the lease is not this worker's to renew (requeued,
            # re-leased, terminal, or unknown job)
            return self._json(409, {"message": "Lease not renewable"})
        return self._json(200, {"lease_expires_at": expiry})

    def _dead_letter(self, m, q, body, h):
        return self._json(200, {"jobs": self.queue.dead_letter_jobs()})

    def _requeue_job(self, m, q, body, h):
        if self.queue.requeue_dead_letter(m["job_id"]):
            return self._json(200, {"message": "Job requeued"})
        return self._json(404, {"message": "Job not in dead-letter"})

    def _metrics(self, m, q, body, h):
        return 200, REGISTRY.render().encode(), _METRICS_CTYPE

    def _get_statuses(self, m, q, body, h):
        return self._json(200, self.queue.statuses())

    def _update_job(self, m, q, body, h):
        try:
            changes = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        self._note_perf_saturation(changes)
        if (
            self.qos_cache is not None
            and changes.get("status") == JobStatus.COMPLETE
        ):
            # cache BEFORE the status flip becomes visible: a client
            # that observes "scan complete" and immediately re-submits
            # the content must hit (writeback-after-update left a
            # window where complete-but-uncached raced the re-submit).
            # The output chunk is already durable (the worker uploads
            # before posting COMPLETE), and the chunk store is
            # idempotent by content — caching bytes for an update that
            # then gets fenced stores exactly what /raw serves anyway.
            self._qos_cache_writeback(m["job_id"])
        if self.queue.update_job(m["job_id"], changes):
            return self._json(200, {"message": "Job status updated"})
        return self._json(404, {"message": "Job not found"})

    def _qos_cache_writeback(self, job_id: str) -> None:
        """Feed the gateway-tier cache from a freshly completed chunk
        (docs/GATEWAY.md §QoS): small chunks — interactive probes and
        bulk trickles up to ``qos_cache_max_rows`` target lines — are
        stored under their ``(module, lines)`` content key so a later
        identical interactive submission short-circuits at the gateway.
        Best-effort by design: a failed writeback costs one future
        device round trip, never the 200 this route will earn."""
        max_rows = int(getattr(self.cfg, "qos_cache_max_rows", 0))
        if max_rows <= 0:
            return
        try:
            rec = self.queue.job_record(job_id)
            if rec is None:
                return
            # size fast-path off the job record (queue_scan stamps
            # chunk_rows): a bulk flood's big chunks skip the blob
            # read entirely on this status hot path
            known_rows = rec.get("chunk_rows")
            if isinstance(known_rows, int) and known_rows > max_rows:
                return
            scan_id, chunk_index = rec["scan_id"], int(rec["chunk_index"])
            data = self.queue.input_chunk(scan_id, chunk_index)
            if data is None:
                return
            # size-bail on the raw bytes BEFORE decoding: this hook
            # rides every completed chunk's status POST, and a bulk
            # flood's big chunks must pay a byte count, not a full
            # decode, to learn they're over the bound
            if data.count(b"\n") + 1 > max_rows:
                return
            # the exact inverse of queue_scan's '\n'.join — NOT
            # splitlines(), which also splits on \x0b / \x1c /
            # U+2028 etc. and would alias a one-weird-line chunk's
            # digest with an honest N-line submission's
            lines = data.decode("utf-8", "surrogateescape").split("\n")
            if not any(lines) or len(lines) > max_rows:
                return
            output = self.queue.blobs.get(
                chunk_output_key(scan_id, chunk_index)
            )
            stored = self.qos_cache.writeback(rec["module"], lines, output)
            # trace_id rides the writeback event (the cache entries a
            # short-circuit later answers from are traceable
            # back to the scan that fed them)
            emit_event(
                "cache.writeback",
                trace_id=rec.get("trace_id"),
                job_id=job_id,
                scan_id=scan_id,
                chunk_index=chunk_index,
                module=rec["module"],
                stored=bool(stored),
            )
            tracing.flight_event(
                "cache.writeback", trace_id=rec.get("trace_id"),
                job_id=job_id, stored=bool(stored),
            )
        except Exception as e:
            print(f"gateway cache writeback skipped for {job_id}: {e}")

    def _note_perf_saturation(self, changes: dict) -> None:
        """Fold a completed job's perf fields into the admission
        pressure signal: the worker's explicit ``inflight_saturation``
        when present, else the scheduler snapshot's stall/wall ratio
        (stall = the submit thread waited on a FULL in-flight window —
        i.e. the accelerator is saturated)."""
        worker_id = changes.get("worker_id")
        perf = changes.get("perf")
        if not worker_id or not isinstance(perf, dict):
            return
        saturation = perf.get("inflight_saturation")
        if saturation is None:
            sched = perf.get("sched")
            if isinstance(sched, dict):
                wall = sched.get("wall_seconds")
                stall = sched.get("stall_seconds")
                if (
                    isinstance(wall, (int, float))
                    and isinstance(stall, (int, float))
                    and wall > 0
                ):
                    saturation = stall / wall
        if saturation is not None:
            self.gateway.note_saturation(worker_id, saturation)

    def _post_spans(self, m, q, body, h):
        """Mid-scan span shipping (docs/OBSERVABILITY.md §Tracing): a
        worker whose attempt outgrows the perf-field batch bound posts
        ``{"scan_id": ..., "spans": [...]}`` here instead. Spans for a
        scan the assembler isn't holding are counted as dropped and
        still 200 — tracing is telemetry, not control flow."""
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        scan_id = data.get("scan_id")
        spans = data.get("spans")
        if not scan_id or not SCAN_ID_RE.match(str(scan_id)) or not isinstance(
            spans, list
        ):
            return self._json(
                400, {"message": "scan_id and spans list required"}
            )
        added = self.queue.tracer.add_spans(str(scan_id), spans)
        return self._json(200, {"added": added})

    def _get_trace(self, m, q, body, h):
        """One scan's assembled latency waterfall (memory, blob store,
        or a live partial view of a still-running scan)."""
        scan_id = m["scan_id"]
        if not SCAN_ID_RE.match(scan_id):
            return self._json(400, {"message": "Invalid scan_id"})
        doc = self.queue.tracer.get(scan_id)
        if doc is None:
            return self._json(404, {"message": "No trace for scan"})
        return self._json(200, doc)

    def _get_chunk(self, m, q, body, h):
        content = self.queue.output_chunk(m["scan_id"], int(m["chunk_id"]))
        if content is None:
            return self._json(404, {"message": "Chunk not found"})
        return self._json(200, {"contents": content})

    def _get_latest_chunk(self, m, q, body, h):
        job_id = self.queue.latest_completed_job_id()
        if job_id is None:
            return self._text(204, "")
        return self._text(200, job_id)

    def _parse_job(self, m, q, body, h):
        if self.queue.parse_job(m["job_id"]):
            return self._json(200, {"message": "Job parsed and inserted into mongodb"})
        return self._json(404, {"message": "Job not found"})

    def _raw(self, m, q, body, h):
        return self._text(200, self.queue.raw_scan(m["scan_id"]))

    @staticmethod
    def _header(h: dict, name: str) -> Optional[str]:
        """Case-insensitive header lookup (clients vary in casing)."""
        lname = name.lower()
        for key, value in h.items():
            if key.lower() == lname:
                return value
        return None

    def _pressure_snapshot(self) -> PressureSnapshot:
        """One deterministic observation of the serving tier's load —
        the sole dynamic input of a shed decision (docs/GATEWAY.md)."""
        from swarm_tpu_torch.resilience.breaker import breaker_states

        by_state = self.queue.jobs_by_state()  # probe-storm-cached
        active = sum(
            n for status, n in by_state.items() if status in JobStatus.ACTIVE
        )
        open_breakers = sum(
            1 for state in breaker_states().values() if state != "closed"
        )
        # queue_depth is one llen PER TENANT LIST — only pay for it
        # when the depth component is actually enabled (queue_high 0,
        # the default, disables it); the admission hot path must not
        # scale with tenant count
        depth = (
            self.queue.queue_depth() if self.gateway.queue_high > 0
            else by_state.get(JobStatus.QUEUED, 0)
        )
        return PressureSnapshot(
            queue_depth=depth,
            active_jobs=active,
            saturation=self.gateway.fleet_saturation(),
            open_breakers=open_breakers,
        )

    def _admission_decision(self, tenant: str, qos: Optional[str] = None):
        return self.gateway.decide(
            tenant,
            self._pressure_snapshot(),
            time.monotonic(),
            tenant_depth=self.queue.tenant_depth(tenant),
            qos=qos,
        )

    @staticmethod
    def _shed_response(decision) -> tuple:
        retry_after = max(0.0, decision.retry_after_s)
        import math

        return (
            429,
            json.dumps(
                {
                    "message": "Request shed by admission control",
                    "reason": decision.reason,
                    "retry_after_s": round(retry_after, 3),
                    "pressure": round(decision.pressure, 4),
                }
            ).encode(),
            "application/json",
            {"Retry-After": str(max(1, math.ceil(retry_after)))},
        )

    def _queue_job(self, m, q, body, h):
        t0 = time.perf_counter()
        t_wall = time.time()
        try:
            job_data = json.loads(body or b"{}")
        except ValueError:
            return self._text(400, "Invalid JSON")
        # tenant model (docs/GATEWAY.md): X-Swarm-Tenant names the
        # submitting tenant; absent = the default tenant, preserving
        # the reference wire contract
        tenant = (self._header(h, "X-Swarm-Tenant") or "").strip() or DEFAULT_TENANT
        # QoS class (docs/GATEWAY.md §QoS): X-Swarm-QoS next to the
        # tenant header; absent/"bulk" = None, the reference behavior.
        # An unknown class is a 400, never a silent bulk ride.
        try:
            qos = parse_qos(self._header(h, QOS_HEADER))
        except ValueError as e:
            return self._text(400, str(e))
        # shape-validate BEFORE admission: a malformed submission is a
        # 400, never a consumed rate token or an "admitted" count
        try:
            module, _scan_id, tenant = JobQueueService.validate_scan(
                job_data, tenant
            )
        except ValueError as e:
            return self._text(400, str(e))
        trace_id = header_trace_id(h) or new_trace_id()
        # admission control, ONE decision for every path: shed, never
        # block — a 429 with Retry-After is the overload story, not a
        # growing queue. The decision runs before the cache lookup on
        # purpose: a hit needs the same decision anyway (answering
        # from cache is cheap — no worker, no queue seat — but not
        # free: blobs + a journaled record per chunk, so cached
        # content must not become an unthrottled durable-write path),
        # and under overload the shed skips the digest + tier round
        # trip entirely
        decision = self._admission_decision(tenant, qos=qos)
        if not decision.admitted:
            return self._shed_response(decision)
        # gateway-tier short-circuit (docs/GATEWAY.md §QoS): an
        # admitted interactive submission whose every chunk is
        # fleet-known completes right here — zero worker dispatch.
        # Only chunks the writeback bound (qos_cache_max_rows) can
        # ever have stored are looked up: a big bulk-shaped
        # interactive submission is a guaranteed miss, and must not
        # pay per-chunk digests + a tier round trip to learn it
        if qos == QOS_INTERACTIVE and self.qos_cache is not None:
            lines, batch_size, _base = JobQueueService.parse_submission(
                job_data
            )
            max_rows = int(getattr(self.cfg, "qos_cache_max_rows", 0))
            chunks = (
                list(chunk_generator(lines, batch_size))
                if lines and max_rows > 0 else []
            )
            if any(len(c) > max_rows for c in chunks):
                chunks = []
            lk0 = time.perf_counter()
            lk_wall = time.time()
            outputs = (
                self.qos_cache.lookup_chunks(module, chunks)
                if chunks else None
            )
            lk1 = time.perf_counter()
            if outputs is not None:
                comp_wall = time.time()
                try:
                    result = self.queue.complete_scan_from_cache(
                        job_data, outputs, trace_id=trace_id,
                        tenant=tenant, qos=qos,
                    )
                except ValueError as e:
                    return self._text(400, str(e))
                GATEWAY_SHORT_CIRCUIT.labels(outcome="hit").inc()
                elapsed = time.perf_counter() - t0
                GATEWAY_LATENCY.labels(qos=QOS_INTERACTIVE).observe(
                    elapsed, trace_id=trace_id
                )
                # zero-dispatch waterfall (short-circuit scans are
                # fully traceable): admission → cache.lookup
                # → completion tile the exact window the latency
                # histogram just observed, so the segments-sum gate
                # holds for this path too
                if tracing.enabled():
                    self.queue.tracer.assemble_short_circuit(
                        result["scan_id"], trace_id, t_wall, elapsed,
                        result["chunks"],
                        [
                            tracing.make_span(
                                "admission", trace_id, t_wall, lk0 - t0,
                                tenant=tenant,
                            ),
                            tracing.make_span(
                                "cache.lookup", trace_id, lk_wall,
                                lk1 - lk0, chunks=result["chunks"],
                            ),
                            tracing.make_span(
                                "completion", trace_id, comp_wall,
                                max(0.0, elapsed - (lk1 - t0)),
                            ),
                        ],
                        qos=QOS_INTERACTIVE, tenant=tenant,
                    )
                    self.queue.tracer.flush()
                return self._text(200, "Job queued successfully")
            GATEWAY_SHORT_CIRCUIT.labels(outcome="miss").inc()
        # trace_id minted above (honoring the client's X-Swarm-Trace)
        # so the short-circuit path and the queued path correlate the
        # same way
        adm_s = time.perf_counter() - t0
        try:
            result = self.queue.queue_scan(
                job_data, trace_id=trace_id, tenant=tenant, qos=qos
            )
        except ValueError as e:
            return self._text(400, str(e))
        # inflow feed for the forecasting advisor (docs/RESILIENCE.md
        # §Preemption): only chunks that will consume a worker seat —
        # short-circuited scans never reach dispatch and must not
        # inflate the fleet-size forecast
        if self.autoscaler.forecaster is not None and result["chunks"]:
            self.autoscaler.forecaster.record(
                result["chunks"], tenant=tenant
            )
        if tracing.enabled():
            # pre-admission handler time, recorded OUTSIDE the
            # gateway-latency window (start < admitted_at by
            # construction — the waterfall's segment sum deliberately
            # excludes it; docs/OBSERVABILITY.md §Tracing)
            self.queue.tracer.add_spans(result["scan_id"], [
                tracing.make_span(
                    "admission", trace_id, t_wall, adm_s, tenant=tenant,
                    qos=qos,
                ),
            ])
        return self._text(200, "Job queued successfully")

    def _stream(self, m, q, body, h):
        """Server-push NDJSON results (gateway/streaming.py): the body
        is a GENERATOR — the HTTP layer writes it chunked as records
        arrive, so the client sees chunk i the moment it lands."""
        scan_id = m["scan_id"]
        if not SCAN_ID_RE.match(scan_id):
            return self._json(400, {"message": "Invalid scan_id"})
        try:
            from_chunk = int((q.get("from") or ["0"])[0])
        except ValueError:
            return self._json(400, {"message": "Invalid from cursor"})
        gen = stream_scan(
            self.queue,
            scan_id,
            from_chunk=max(0, from_chunk),
            poll_s=self.cfg.gateway_stream_poll_s,
            idle_timeout_s=self.cfg.gateway_stream_idle_timeout_s,
        )
        return 200, gen, "application/x-ndjson"

    # ------------------------------------------------------------------
    # Continuous monitoring (docs/MONITORING.md)
    # ------------------------------------------------------------------
    def _submit_monitor_epoch(self, spec, scan_id, epoch) -> Optional[dict]:
        """The ticker's epoch-submit callback: one admission decision
        (epoch fires are rate-limited like any submission — a shed
        epoch returns None and the spec retries next tick, late), then
        a PARTIAL gateway-cache lookup so fleet-known targets complete
        with zero dispatch, then the journaled fire."""
        decision = self._admission_decision(spec.tenant, qos=spec.qos)
        if not decision.admitted:
            return None
        cached = None
        max_rows = int(getattr(self.cfg, "qos_cache_max_rows", 0))
        if self.qos_cache is not None and max_rows > 0:
            lines = [t.rstrip("\n") for t in spec.targets]
            chunks = list(chunk_generator(lines, spec.batch_size))
            outs = self.qos_cache.lookup_chunks_partial(spec.module, chunks)
            if outs:
                cached = {
                    i: o
                    for i, o in enumerate(outs)
                    if o is not None and len(chunks[i]) <= max_rows
                }
        try:
            result = self.queue.fire_monitor_epoch(
                spec.to_wire(), scan_id, epoch,
                cached_outputs=cached, trace_id=new_trace_id(),
            )
            dispatched = result["chunks"] - int(
                result.get("cached_chunks") or 0
            )
            if self.autoscaler.forecaster is not None and dispatched > 0:
                self.autoscaler.forecaster.record(
                    dispatched, tenant=spec.tenant
                )
            return result
        except Exception as e:
            # a failed fire (journal down, malformed spec) must not
            # kill the ticker; the spec stays due and retries
            print(f"monitor epoch fire failed for {spec.monitor_id}: {e}")
            return None

    def _monitor_post(self, m, q, body, h):
        """Register or update a standing monitor spec. Tenant and QoS
        ride the same headers as a one-shot submission; an update
        preserves the existing cadence (epoch, next_fire_at) so
        changing targets never re-fires or rewinds a monitor."""
        if self.monitor is None:
            return self._json(503, {"message": "Monitoring disabled"})
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        tenant = (
            self._header(h, "X-Swarm-Tenant") or ""
        ).strip() or DEFAULT_TENANT
        try:
            qos = parse_qos(self._header(h, QOS_HEADER))
        except ValueError as e:
            return self._json(400, {"message": str(e)})
        monitor_id = str(data.get("monitor_id") or "")
        if not monitor_id:
            import uuid

            monitor_id = f"mon-{uuid.uuid4().hex[:12]}"
        try:
            spec = MonitorSpec(
                monitor_id=monitor_id,
                module=str(data.get("module") or ""),
                targets=[str(t) for t in (data.get("targets") or [])],
                interval_s=float(data.get("interval_s") or 0.0),
                tenant=tenant,
                qos=qos,
                batch_size=int(data.get("batch_size") or 0),
                paused=bool(data.get("paused")),
                created_at=time.time(),
            )
        except (TypeError, ValueError) as e:
            return self._json(400, {"message": str(e)})
        problem = spec.validate()
        if problem is not None:
            return self._json(400, {"message": problem})
        existing = self.queue.get_monitor(spec.monitor_id)
        if existing is None:
            limit = int(getattr(self.cfg, "monitor_max_specs", 0))
            if limit > 0 and len(self.queue.list_monitors()) >= limit:
                return self._json(
                    429, {"message": "Monitor registry full"}
                )
        else:
            spec.created_at = float(
                existing.get("created_at") or spec.created_at
            )
            spec.epoch = int(existing.get("epoch") or 0)
            spec.next_fire_at = float(existing.get("next_fire_at") or 0.0)
            spec.last_scan_id = existing.get("last_scan_id")
            spec.refire = bool(existing.get("refire"))
        try:
            self.queue.put_monitor(spec.to_wire())
        except Exception as e:
            return self._json(503, {"message": f"Registration failed: {e}"})
        return self._json(
            200,
            {
                "monitor_id": spec.monitor_id,
                "epoch": spec.epoch,
                "paused": spec.paused,
            },
        )

    def _monitor_list(self, m, q, body, h):
        return self._json(200, {"monitors": self.queue.list_monitors()})

    def _monitor_update(self, m, q, body, h):
        """``{"op": "rm"|"pause"|"resume"}`` — mutations, not a generic
        PATCH; spec changes go through POST /monitor upserts."""
        monitor_id = m["monitor_id"]
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        op = data.get("op")
        existing = self.queue.get_monitor(monitor_id)
        if existing is None:
            return self._json(404, {"message": "Monitor not found"})
        if op == "rm":
            self.queue.remove_monitor(monitor_id)
            return self._json(200, {"message": "Monitor removed"})
        if op in ("pause", "resume"):
            spec = dict(existing)
            spec["paused"] = op == "pause"
            try:
                self.queue.put_monitor(spec)
            except Exception as e:
                return self._json(503, {"message": f"Update failed: {e}"})
            return self._json(
                200, {"monitor_id": monitor_id, "paused": spec["paused"]}
            )
        return self._json(400, {"message": "op must be rm, pause or resume"})

    def _monitor_feed(self, m, q, body, h):
        """Resumable NDJSON change feed (docs/MONITORING.md §Feed
        resume contract): ``?from=N`` skips the first N records; the
        generator long-polls for new ones. A removed monitor's stored
        feed stays readable until drained (then ``end``)."""
        monitor_id = m["monitor_id"]
        if not MONITOR_ID_RE.match(monitor_id):
            return self._json(400, {"message": "Invalid monitor_id"})
        try:
            from_seq = int((q.get("from") or ["0"])[0])
        except ValueError:
            return self._json(400, {"message": "Invalid from cursor"})
        if self.queue.get_monitor(monitor_id) is None and not (
            self.queue.blobs.list(feed_prefix(monitor_id))
        ):
            return self._json(404, {"message": "Monitor not found"})
        gen = stream_feed(
            self.queue.blobs,
            monitor_id,
            from_seq=max(0, from_seq),
            poll_s=self.cfg.monitor_feed_poll_s,
            idle_timeout_s=self.cfg.monitor_feed_idle_timeout_s,
            alive=lambda: self.queue.get_monitor(monitor_id) is not None,
        )
        return 200, gen, "application/x-ndjson"

    def _tenants(self, m, q, body, h):
        """Per-tenant operator surface: queue depth, jobs by state,
        admission counters (`swarm tenants`)."""
        depths = self.queue.tenant_depths()
        by_tenant = self.queue.jobs_by_tenant()
        admission = self.gateway.snapshot()
        out = {}
        for tenant in sorted(set(depths) | set(by_tenant) | set(admission)):
            counts = admission.get(tenant, {})
            out[tenant] = {
                "queue_depth": depths.get(tenant, 0),
                "jobs_by_state": by_tenant.get(tenant, {}),
                "admitted": counts.get("admitted", 0),
                "shed": counts.get("shed", 0),
            }
        return self._json(200, {"tenants": out})

    def _autoscale_recommend(self, m, q, body, h):
        prefix = (q.get("prefix") or ["node"])[0]
        return self._json(200, self.autoscaler.recommend(prefix))

    def _autoscale_apply(self, m, q, body, h):
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        prefix = data.get("prefix") or "node"
        # dry-run unless the operator armed gateway_autoscale_apply —
        # the advisor itself refuses to touch the provider otherwise
        return self._json(200, self.autoscaler.apply(prefix))

    def _get_job(self, m, q, body, h):
        worker_id = (q.get("worker_id") or [None])[0]
        job = self.queue.next_job(worker_id or "unknown")
        # every poll answer carries the control-plane generation
        # (docs/DURABILITY.md): a worker seeing it change knows the
        # server restarted and re-registers / resets its breakers
        gen = {"X-Swarm-Generation": str(self.queue.generation)}
        # drain signal delivery (docs/RESILIENCE.md §Preemption): the
        # poll loop is the one channel every worker already reads, so
        # the drain order rides it as a response header — no reverse
        # connection into the worker needed
        reason = self.queue.drain_reason(worker_id or "unknown")
        if reason is not None:
            gen["X-Swarm-Drain"] = reason
        if job is None:
            code, payload, ctype = self._text(204, "")
            return code, payload, ctype, gen
        code, payload, ctype = self._json(200, job)
        return code, payload, ctype, gen

    def _spin_up(self, m, q, body, h):
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        prefix, nodes = data.get("prefix"), data.get("nodes")
        if prefix is None or nodes is None:
            return self._json(400, {"message": "Both prefix and nodes are required"})
        threading.Thread(
            target=self.fleet.spin_up, args=(prefix, int(nodes)), daemon=True
        ).start()
        return self._json(
            202, {"message": f"Spinning up {nodes} droplets with prefix {prefix}"}
        )

    def _spin_down(self, m, q, body, h):
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        prefix = data.get("prefix")
        if prefix is None:
            return self._json(400, {"message": "Prefix is required"})
        self.fleet.teardown_async(prefix)
        return self._json(202, {"message": f"Spinning down droplets with prefix {prefix}"})

    def _drain_worker(self, m, q, body, h):
        """Operator-initiated graceful drain (docs/RESILIENCE.md
        §Preemption): dispatch stops offering the worker jobs; its next
        poll carries X-Swarm-Drain and the worker finishes its lease,
        uploads or spools, deregisters, and exits."""
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        reason = str(data.get("reason") or "drain")
        if self.queue.drain_worker(m["worker_id"], reason=reason):
            return self._json(
                200, {"message": "Worker draining", "reason": reason}
            )
        return self._json(409, {"message": "Worker already draining"})

    def _deregister(self, m, q, body, h):
        """The worker is exiting NOW: hand back any lease immediately
        (no grace-window wait) and drop its saturation report — a dead
        node's last word must not pin fleet pressure for a TTL."""
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            return self._json(400, {"message": "Invalid JSON"})
        worker_id = str(data.get("worker_id") or "").strip()
        if not worker_id:
            return self._json(400, {"message": "worker_id is required"})
        result = self.queue.deregister_worker(worker_id)
        self.gateway.drop_saturation(worker_id)
        return self._json(200, {"message": "Worker deregistered", **result})

    def _reset(self, m, q, body, h):
        self.queue.reset()
        return self._json(200, {"message": "Redis database reset"})

    def _get_input_chunk(self, m, q, body, h):
        data = self.queue.input_chunk(m["scan_id"], int(m["chunk_id"]))
        if data is None:
            return self._json(404, {"message": "Chunk not found"})
        return 200, data, "application/octet-stream"

    def _put_output_chunk(self, m, q, body, h):
        self.queue.put_output_chunk(m["scan_id"], int(m["chunk_id"]), body or b"")
        return self._json(200, {"message": "stored"})

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    UNAUTHENTICATED = {"/healthz", "/metrics"}

    def dispatch(
        self, method: str, path: str, query: dict, headers: dict, body: bytes
    ) -> tuple[int, Any, str, dict]:
        """Returns ``(code, payload, content_type, extra_headers)``.
        Handlers may return 3- or 4-tuples (``_observed`` normalizes);
        a non-bytes payload is an ITERATOR of byte chunks that the HTTP
        layer writes with chunked transfer encoding (/stream)."""
        t0 = time.perf_counter()
        parsed_path = path.rstrip("/") or "/"
        if parsed_path not in self.UNAUTHENTICATED:
            auth = headers.get("Authorization", "")
            if not auth.startswith("Bearer "):
                return self._observed(
                    "_unauthorized", method, t0,
                    self._json(401, {"message": "Authentication required"}),
                )
            if auth.split(" ", 1)[1] != self.cfg.api_key:
                return self._observed(
                    "_unauthorized", method, t0,
                    self._json(401, {"message": "Unauthorized"}),
                )
        for route_method, pattern, handler, route_name in self._routes:
            if route_method != method:
                continue
            match = pattern.match(path)
            if match:
                try:
                    result = handler(match.groupdict(), query, body, headers)
                except Exception as e:  # route crash → 500, keep serving
                    result = self._json(
                        500, {"message": f"{type(e).__name__}: {e}"}
                    )
                return self._observed(route_name, method, t0, result)
        return self._observed(
            "_unmatched", method, t0, self._json(404, {"message": "Not found"})
        )

    @staticmethod
    def _observed(
        route: str, method: str, t0: float, result: tuple
    ) -> tuple[int, Any, str, dict]:
        """Record request count + latency for one dispatched request
        and normalize the handler result to the 4-tuple form (for a
        streaming body the latency covers dispatch, not the stream's
        lifetime — the generator hasn't run yet)."""
        _HTTP_REQUESTS.labels(
            route=route, method=method, code=str(result[0])
        ).inc()
        _HTTP_LATENCY.labels(route=route).observe(time.perf_counter() - t0)
        if len(result) == 3:
            return (result[0], result[1], result[2], {})
        return result

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def _advertise_url(self) -> None:
        """Align cfg.server_url with the actually-bound port when the
        operator didn't set one: fleet providers hand this URL to the
        workers they spawn (process cmdline / droplet cloud-init), and
        the dataclass default would point them at :5001 regardless of
        --port. An explicit server_url (public address behind NAT)
        always wins; defaulted-ness is captured at construction so a
        restart re-aligns to the newly bound port."""
        if self._url_was_default:
            host = self.cfg.host
            if host == "::":
                # v6 wildcard: stay on the bound address family — the
                # listener may not accept v4-mapped connections
                # (bindv6only), so 127.0.0.1 could be unreachable
                host = "[::1]"
            elif host in ("0.0.0.0", ""):
                host = "127.0.0.1"
            elif ":" in host:  # IPv6 literal needs brackets in a URL
                host = f"[{host}]"
            self.cfg.server_url = f"http://{host}:{self.port}"
            self.cfg.server_url_derived = True

    #: serve_forever's shutdown-check cadence. The stdlib default
    #: (0.5 s) makes every shutdown() block up to half a second —
    #: across a test suite with dozens of server fixtures that is
    #: tens of wasted wall-seconds; 50 ms of idle select cost is
    #: unmeasurable next to request handling.
    POLL_INTERVAL_S = 0.05

    def serve_forever(self) -> None:
        self._httpd = _make_httpd(self)
        self._advertise_url()
        self._httpd.serve_forever(poll_interval=self.POLL_INTERVAL_S)

    def start_background(self) -> threading.Thread:
        self._httpd = _make_httpd(self)
        self._advertise_url()
        httpd = self._httpd  # bind now: shutdown() may None the attr
        thread = threading.Thread(
            target=lambda: httpd.serve_forever(
                poll_interval=self.POLL_INTERVAL_S
            ),
            daemon=True,
        )
        thread.start()
        return thread

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        REGISTRY.remove_collector(self._collector)
        self._flight_unsub()
        # zero the by-state children this server populated: the gauge is
        # process-global, and a later server instance (supervisor
        # restart, sequential test fixtures) must not keep reporting the
        # dead store's counts as live state
        for status in self._seen_states:
            _JOBS_BY_STATE.labels(status=status).set(0)
        self._seen_states.clear()
        for tenant in self._seen_tenants:
            GATEWAY_QUEUED.labels(tenant=tenant).set(0)
        self._seen_tenants.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _make_httpd(server: SwarmServer) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _run(self, method: str) -> None:
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            code, payload, ctype, extra = server.dispatch(
                method, parsed.path, query, dict(self.headers), body
            )
            if code == 204:
                # 204 is bodyless by spec; a body here would linger in the
                # socket and corrupt the next keep-alive request
                payload = b""
            if not isinstance(payload, (bytes, bytearray)):
                self._stream_body(method, code, payload, ctype, extra)
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for key, value in extra.items():
                self.send_header(key, value)
            if code != 204:
                self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            if payload and method != "HEAD":
                self.wfile.write(payload)

        def _stream_body(self, method, code, chunks, ctype, extra) -> None:
            """Write an iterator payload with chunked transfer encoding
            (HTTP/1.1): each yielded record flushes immediately, so a
            /stream client sees results as they land. A client that
            disconnects mid-stream just ends the generator; the broken
            socket is dropped, never reused for keep-alive. (Only GET
            routes produce generator payloads — HEAD requests match no
            GET route in dispatch and 404 before reaching here.)"""
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for key, value in extra.items():
                self.send_header(key, value)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for part in chunks:
                    part = bytes(part)
                    if not part:
                        continue
                    self.wfile.write(
                        f"{len(part):X}\r\n".encode() + part + b"\r\n"
                    )
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionError, OSError):
                self.close_connection = True
            finally:
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()

        def do_GET(self):
            self._run("GET")

        def do_POST(self):
            self._run("POST")

        def do_HEAD(self):
            self._run("HEAD")

    class _Server(ThreadingHTTPServer):
        """ThreadingHTTPServer whose shutdown actually severs clients.

        The stdlib's shutdown() stops the accept loop but keep-alive
        handler threads (daemonized) keep serving the OLD server
        object's routes — a client with a pooled connection would keep
        reading a dead control plane's state across an in-process
        restart (journal recovery made this observable: the stale
        generation kept being served). Track live connections and
        force-close them in server_close(), which is what a real
        process death does to its sockets anyway."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._live_lock = threading.Lock()  # guards: _live_conns (reads)
            self._live_conns: set = set()

        def process_request(self, request, client_address):
            with self._live_lock:
                self._live_conns.add(request)
            super().process_request(request, client_address)

        def shutdown_request(self, request):
            with self._live_lock:
                self._live_conns.discard(request)
            super().shutdown_request(request)

        def server_close(self):
            super().server_close()
            import socket as _socket

            with self._live_lock:
                conns = list(self._live_conns)
                self._live_conns.clear()
            for conn in conns:
                try:
                    conn.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass

        def handle_error(self, request, client_address):
            # a /stream client hanging up mid-push (or any keep-alive
            # peer resetting) is normal operation, not a server error —
            # the stdlib default would dump a traceback per disconnect
            import sys as _sys

            exc = _sys.exc_info()[1]
            if isinstance(exc, (BrokenPipeError, ConnectionError)):
                return
            super().handle_error(request, client_address)

    if ":" in server.cfg.host:  # IPv6 literal (e.g. "::1", "fd00::1")
        import socket

        class _V6Server(_Server):
            address_family = socket.AF_INET6

        return _V6Server((server.cfg.host, server.cfg.port), Handler)
    return _Server((server.cfg.host, server.cfg.port), Handler)


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="swarm_tpu_torch C2 server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--api-key", default=None)
    parser.add_argument("--config", default=None)
    args = parser.parse_args(argv)
    cfg = Config.load(
        path=args.config, host=args.host, port=args.port, api_key=args.api_key
    )
    server = SwarmServer(cfg)
    print(f"swarm_tpu_torch server on {cfg.host}:{cfg.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
