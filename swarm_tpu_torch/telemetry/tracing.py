"""End-to-end span tracing (docs/OBSERVABILITY.md §Tracing): the port's
copy of ``swarm_tpu/telemetry/tracing.py``, the same spans, flight
records, dumps and waterfall documents.

One scan's latency is spent across six processes-and-layers — gateway
admission, queue wait, scheduler coalescing, device dispatch, host
walk, blob upload — and before this module the only decomposition tool
was grep over flat trace_id'd JSON events. This module adds the
missing structure: lightweight SPANS (span_id / parent_id / trace_id /
wall start / monotonic duration / attrs) recorded per attempt on the
worker, stamped server-side for queue wait, shipped back on the
completed-job ``perf`` field (or ``POST /spans`` for long scans), and
assembled by the server into a per-scan WATERFALL blob under
``_traces/<scan_id>.json`` served at ``GET /trace/<scan_id>``.

Three design rules, in priority order:

1. **Near-zero cost when disabled** (the default). ``span()`` is two
   global loads and one thread-local getattr before returning the
   shared no-op span; the completed-job wire payload is byte-identical
   to the untraced build. Enable with ``SWARM_TRACE=1`` (env) or
   ``tracing.set_enabled(True)`` (runtime override, used by tests and
   the bench so they never mutate os.environ).
2. **Spans never block the data path.** Every collection structure is
   bounded (per-attempt list, per-scan assembly state, scan LRU,
   blob retention) and overflow increments
   ``swarm_trace_spans_dropped_total`` instead of growing; blob IO
   happens only in ``TraceAssembler.flush()`` / sink threads, never
   under a queue or breaker lock.
3. **Clocks**: span ``start`` is wall time (``time.time()`` — it must
   line up with server-stamped ``admitted_at``/``completed_at``
   across processes on one host), span ``duration_s`` is a
   ``perf_counter`` delta (monotonic, immune to NTP steps mid-span).

The always-on FLIGHT recorder is separate from the enable gate: a
fixed ring of recent span/event records per process, dumped to the
blob store when a breaker opens, a job dead-letters, journal recovery
runs, or a chaos-plan fault fires — post-mortems of a kill-9'd or
degraded worker get the last N records of context for free.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Iterable, Optional

from swarm_tpu_torch.telemetry.trace_export import (
    TRACE_ASSEMBLED,
    TRACE_FLIGHT_DUMPS,
    TRACE_SPANS,
    TRACE_SPANS_DROPPED,
)

#: either env key arms tracing process-wide; same truthy set as
#: config.py's bool coercion so SWARM_TRACE_ENABLED matches the
#: ``trace_enabled`` config field's env form
_ENV_KEYS = ("SWARM_TRACE", "SWARM_TRACE_ENABLED")
_TRUTHY = ("1", "true", "yes", "on")

_override: Optional[bool] = None  # set_enabled() runtime override
_env_cached: Optional[bool] = None  # lazy one-time env read


def _read_env() -> bool:
    global _env_cached
    val = any(
        os.environ.get(k, "").strip().lower() in _TRUTHY for k in _ENV_KEYS
    )
    _env_cached = val
    return val


def enabled() -> bool:
    """Is tracing armed in this process? Override wins over env."""
    if _override is not None:
        return _override
    env = _env_cached
    return _read_env() if env is None else env


def set_enabled(on: Optional[bool]) -> None:
    """Force tracing on/off at runtime; ``None`` falls back to the env
    gate (re-read, so tests that toggled os.environ see the change)."""
    global _override, _env_cached
    _override = on
    _env_cached = None


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def make_span(
    name: str,
    trace_id: str,
    start: float,
    duration_s: float,
    parent_id: Optional[str] = None,
    span_id: Optional[str] = None,
    **attrs: Any,
) -> dict:
    """One wire-format span dict (the only span shape — live spans,
    server-stamped spans and synthesized spans all converge here)."""
    span = {
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "trace_id": trace_id,
        "name": name,
        "start": start,
        "duration_s": duration_s,
    }
    clean = {k: v for k, v in attrs.items() if v is not None}
    if clean:
        span["attrs"] = clean
    return span


# ambient per-thread state: .ctx = active TraceContext, .span = current
# parent span_id for nesting. threading.local, not a lock.
_tls = threading.local()


class TraceContext:
    """One attempt's span collector.

    Created per job attempt on the worker (``attempt_context``), bound
    to the executing thread with ``activate``; spans opened anywhere
    under that binding — engine, scheduler, cache tier, walk pool
    threads that re-activate it — append here. The list is bounded:
    past MAX_SPANS further spans count into
    ``swarm_trace_spans_dropped_total{reason="context_full"}``.
    """

    MAX_SPANS = 2048

    def __init__(self, trace_id: str, name: str = "attempt", **attrs: Any):
        self.trace_id = trace_id
        self.root_id = new_span_id()
        self._root_name = name
        self._root_attrs = {k: v for k, v in attrs.items() if v is not None}
        self._start_wall = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()  # guards: _spans, _finished
        self._spans: list[dict] = []
        self._finished = False

    def add(self, span: dict) -> None:
        with self._lock:
            if self._finished or len(self._spans) >= self.MAX_SPANS:
                TRACE_SPANS_DROPPED.labels(reason="context_full").inc()
                return
            self._spans.append(span)
        TRACE_SPANS.inc()
        FLIGHT.record(
            "span", span["name"], trace_id=self.trace_id,
            duration_s=span.get("duration_s"),
        )

    def add_synth(
        self,
        name: str,
        start: float,
        duration_s: float,
        parent_id: Optional[str] = None,
        **attrs: Any,
    ) -> str:
        """Record a span synthesized from pre-measured timings (e.g.
        EngineStats phase deltas); returns its span_id so callers can
        hang children off it."""
        span = make_span(
            name, self.trace_id, start, duration_s,
            parent_id=parent_id or self.root_id, **attrs,
        )
        self.add(span)
        return span["span_id"]

    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def drain(self) -> list[dict]:
        """Hand off collected spans mid-attempt (the POST /spans path
        for long scans) without closing the root."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def finish(self) -> list[dict]:
        """Close the attempt root and return the full wire batch
        (root first). Idempotent-ish: a second call returns only spans
        added since the first."""
        duration = time.perf_counter() - self._t0
        with self._lock:
            spans, self._spans = self._spans, []
            first = not self._finished
            self._finished = True
        if not first:
            return spans
        root = make_span(
            self._root_name, self.trace_id, self._start_wall, duration,
            span_id=self.root_id, **self._root_attrs,
        )
        TRACE_SPANS.inc()
        return [root] + spans


class activate:
    """Bind ``ctx`` as the calling thread's ambient trace context for
    the ``with`` body (restores the previous binding on exit). A None
    ctx is a no-op binding — callers never need their own branch for
    the disabled case."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev_ctx: Optional[TraceContext] = None
        self._prev_span: Optional[str] = None

    def __enter__(self) -> Optional[TraceContext]:
        self._prev_ctx = getattr(_tls, "ctx", None)
        self._prev_span = getattr(_tls, "span", None)
        _tls.ctx = self._ctx
        _tls.span = None
        return self._ctx

    def __exit__(self, *exc: Any) -> bool:
        _tls.ctx = self._prev_ctx
        _tls.span = self._prev_span
        return False


def attempt_context(trace_id: Optional[str], **attrs: Any) -> Optional[TraceContext]:
    """Worker entry point: a fresh per-attempt context, or None when
    tracing is off / the job carries no trace id."""
    if not trace_id or not enabled():
        return None
    return TraceContext(trace_id, name="attempt", **attrs)


def current_context() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


class _NullSpan:
    """Shared no-op span: the entire cost of ``with span(...)`` when
    tracing is disabled or no context is bound."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set_attrs(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    #: ``span_id`` and ``start`` are public — callers that need to hang
    #: synthesized children off a live span (the worker's device/walk
    #: spans under "execute") read them after ``__enter__``
    __slots__ = ("_ctx", "_name", "_attrs", "_prev", "span_id", "start", "_t0")

    def __init__(self, ctx: TraceContext, name: str, attrs: dict):
        self._ctx = ctx
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_LiveSpan":
        self.span_id = new_span_id()
        self._prev = getattr(_tls, "span", None)
        _tls.span = self.span_id
        self.start = time.time()
        self._t0 = time.perf_counter()
        return self

    def set_attrs(self, **attrs: Any) -> None:
        self._attrs.update(attrs)

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        duration = time.perf_counter() - self._t0
        _tls.span = self._prev
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self._ctx.add(make_span(
            self._name, self._ctx.trace_id, self.start, duration,
            parent_id=self._prev or self._ctx.root_id,
            span_id=self.span_id, **self._attrs,
        ))
        return False


def span(name: str, **attrs: Any):
    """Open a child span under the thread's ambient context. Returns
    the shared no-op when tracing is off or no context is bound, so
    call sites never branch."""
    on = _override
    if on is None:
        on = _env_cached
        if on is None:
            on = _read_env()
    if not on:
        return _NULL_SPAN
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return _NULL_SPAN
    return _LiveSpan(ctx, name, attrs)


# ---------------------------------------------------------------------------
# flight recorder


#: pre-seeded dump-reason label values; anything else folds into
#: "other" so fault-plan point names can't explode the label space
_DUMP_REASONS = ("breaker_open", "dead_letter", "journal_recovery", "fault", "other")


class FlightRecorder:
    """Per-process fixed ring of recent span/event records, dumped on
    fault firings so post-mortems have the last moments of context.

    ``record`` is always-on and cheap (one bounded deque append under a
    lock); ``dump`` snapshots the ring synchronously — memory only, so
    it is safe to call under a caller's lock (the breaker dumps from
    inside ``_transition``) — and hands the payload to registered sinks
    on a daemon thread, keeping blob IO off the faulting path.
    """

    RING = 512

    def __init__(self, ring: int = RING):
        self._lock = threading.Lock()  # guards: _ring, _sinks, _seq, _dumps
        self._ring: deque = deque(maxlen=ring)
        self._sinks: list[Callable[[dict], None]] = []
        self._seq = 0
        self._dumps: deque = deque(maxlen=8)

    def record(self, kind: str, name: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "kind": kind, "name": name}
        rec.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._ring.append(rec)

    def add_sink(self, fn: Callable[[dict], None]) -> Callable[[], None]:
        """Register a dump consumer; returns its unsubscribe."""
        with self._lock:
            self._sinks.append(fn)

        def _remove() -> None:
            with self._lock:
                try:
                    self._sinks.remove(fn)
                except ValueError:
                    pass

        return _remove

    def dump(self, reason: str, detail: Optional[str] = None) -> dict:
        with self._lock:
            self._seq += 1
            payload = {
                "reason": reason,
                "detail": detail,
                "ts": time.time(),
                "seq": self._seq,
                "records": list(self._ring),
            }
            self._dumps.append(payload)
            sinks = list(self._sinks)
        label = reason if reason in _DUMP_REASONS else "other"
        TRACE_FLIGHT_DUMPS.labels(reason=label).inc()
        if sinks:
            threading.Thread(
                target=self._run_sinks, args=(sinks, payload),
                name="flight-dump", daemon=True,
            ).start()
        return payload

    @staticmethod
    def _run_sinks(sinks: list, payload: dict) -> None:
        for fn in sinks:
            try:
                fn(payload)
            except Exception:
                pass  # a broken sink must never mask the original fault

    def last_dumps(self) -> list[dict]:
        with self._lock:
            return list(self._dumps)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)


FLIGHT = FlightRecorder()


def flight_event(name: str, **fields: Any) -> None:
    """Record an always-on event into the process flight ring."""
    FLIGHT.record("event", name, **fields)


def flight_dump(reason: str, detail: Optional[str] = None) -> dict:
    return FLIGHT.dump(reason, detail)


def blob_flight_sink(blobs: Any, prefix: str = "_flight/", retain: int = 20):
    """A dump sink persisting payloads to a blob store under
    ``prefix`` with bounded retention (oldest keys deleted past
    ``retain``). Runs on the dump daemon thread, never under a lock."""

    def _sink(payload: dict) -> None:
        key = "%sdump_%06d_%s.json" % (
            prefix, payload["seq"],
            "".join(c for c in str(payload["reason"]) if c.isalnum() or c in "._-"),
        )
        blobs.put(key, json.dumps(payload, default=str).encode("utf-8"))
        keys = sorted(blobs.list(prefix))
        for old in keys[: max(0, len(keys) - retain)]:
            try:
                blobs.delete(old)
            except Exception:
                pass

    return _sink


# ---------------------------------------------------------------------------
# server-side waterfall assembly


class TraceAssembler:
    """Per-scan waterfall assembly on the server.

    The queue registers a scan at admission, stamps queue-wait spans at
    dispatch, feeds worker span batches as jobs complete, and when the
    last chunk goes terminal the finished waterfall is STAGED under the
    lock and persisted by ``flush()`` — which the queue calls outside
    its own lock (blob IO never runs under ``JobQueueService._lock``).

    The waterfall root is the scan itself: ``start = admitted_at``,
    ``duration = max(completed_at) - admitted_at`` — by construction
    the same quantity ``swarm_gateway_latency_seconds`` observes, which
    is what makes the smoke gate "segments sum within 10% of the
    gateway latency observation" a structural property rather than a
    tuning exercise.
    """

    MAX_SCANS = 256          # open assembly states (oldest evicted)
    MAX_SPANS_PER_SCAN = 4096
    FINALIZED_CACHE = 64     # recent finished waterfalls kept in memory
    RETAIN = 128             # _traces/ blobs kept on disk
    PREFIX = "_traces/"

    def __init__(self, blobs: Any = None):
        self._blobs = blobs
        self._lock = threading.Lock()  # guards: _scans, _ready, _finalized, _written
        self._scans: dict[str, dict] = {}
        self._ready: list[dict] = []
        self._finalized: dict[str, dict] = {}
        self._written: list[str] = []
        if blobs is not None:
            try:
                self._written = sorted(blobs.list(self.PREFIX))
            except Exception:
                self._written = []

    # -- ingestion ---------------------------------------------------------

    def register_scan(
        self,
        scan_id: str,
        trace_id: Optional[str],
        admitted_at: Optional[float],
        chunks: int,
        qos: Any = None,
        tenant: Any = None,
        generation: Any = None,
        done: int = 0,
    ) -> None:
        if not trace_id or not enabled():
            return
        with self._lock:
            st = self._scans.get(scan_id)
            if st is None:
                while len(self._scans) >= self.MAX_SCANS:
                    self._scans.pop(next(iter(self._scans)))
                st = self._scans[scan_id] = {
                    "scan_id": scan_id,
                    "trace_id": trace_id,
                    "admitted_at": admitted_at,
                    "chunks": int(chunks),
                    "done": int(done),
                    "spans": [],
                    "qos": qos,
                    "tenant": tenant,
                    "completed_at": None,
                    "degraded": False,
                }
            if generation is not None:
                st["generation"] = generation

    def add_spans(self, scan_id: str, spans: Iterable[dict]) -> int:
        """Attach worker/server spans to an open scan; spans for scans
        the assembler never saw (tracing flipped on mid-flight,
        LRU-evicted state) are counted as dropped, not errors."""
        batch = [s for s in (spans or []) if isinstance(s, dict) and s.get("name")]
        if not batch:
            return 0
        with self._lock:
            st = self._scans.get(scan_id)
            if st is None:
                TRACE_SPANS_DROPPED.labels(reason="unregistered").inc(len(batch))
                return 0
            return self._add_locked(st, batch)

    def _add_locked(self, st: dict, batch: list[dict]) -> int:
        # requires-lock: _lock
        added = 0
        for s in batch:
            if len(st["spans"]) >= self.MAX_SPANS_PER_SCAN:
                TRACE_SPANS_DROPPED.labels(reason="scan_limit").inc()
                continue
            st["spans"].append(s)
            added += 1
        return added

    def record_queue_wait(self, job: Any, now: float) -> None:
        """Server-stamped enqueue→lease span for one dispatch attempt.

        Attempt 1 waits from scan admission; attempt N>1 waits from the
        failure that requeued it (``failure_history[-1]["ts"]``) — so a
        retried job's waterfall shows each attempt's wait separately.
        """
        trace_id = getattr(job, "trace_id", None)
        if not trace_id or not enabled():
            return
        start = getattr(job, "admitted_at", None)
        attempt = getattr(job, "attempts", 1)
        history = getattr(job, "failure_history", None)
        if attempt > 1 and history:
            try:
                start = float(history[-1]["ts"])
            except (KeyError, TypeError, ValueError, IndexError):
                pass
        if not isinstance(start, (int, float)):
            start = now
        s = make_span(
            "queue-wait", trace_id, float(start),
            max(0.0, now - float(start)),
            job_id=getattr(job, "job_id", None),
            attempt=attempt,
            qos=getattr(job, "qos", None),
        )
        TRACE_SPANS.inc()
        self.add_spans(job.scan_id, [s])

    def job_terminal(
        self,
        scan_id: str,
        job_id: str,
        status: str,
        completed_at: Optional[float],
        spans: Optional[Iterable[dict]] = None,
    ) -> bool:
        """One chunk reached a terminal state; returns True when the
        whole scan just finished (waterfall staged — call ``flush()``
        once outside any queue lock to persist it)."""
        batch = [s for s in (spans or []) if isinstance(s, dict) and s.get("name")]
        with self._lock:
            st = self._scans.get(scan_id)
            if st is None:
                if batch:
                    TRACE_SPANS_DROPPED.labels(
                        reason="unregistered").inc(len(batch))
                return False
            if batch:
                self._add_locked(st, batch)
            st["done"] += 1
            if isinstance(completed_at, (int, float)):
                prev = st["completed_at"]
                if prev is None or completed_at > prev:
                    st["completed_at"] = float(completed_at)
            if status != "complete":
                st["degraded"] = True
            if st["done"] < st["chunks"]:
                return False
            self._scans.pop(scan_id, None)
            self._ready.append(self._build(st))
        TRACE_ASSEMBLED.inc()
        return True

    def assemble_short_circuit(
        self,
        scan_id: str,
        trace_id: str,
        start: float,
        duration_s: float,
        chunks: int,
        spans: Iterable[dict],
        qos: Any = None,
        tenant: Any = None,
    ) -> Optional[dict]:
        """Zero-dispatch gateway completion: the whole waterfall is
        known inline (admission + cache lookup + completion), so build
        and stage it in one shot. Caller flushes — the gateway handler
        thread holds no queue lock, so it can do so immediately."""
        if not trace_id or not enabled():
            return None
        st = {
            "scan_id": scan_id,
            "trace_id": trace_id,
            "admitted_at": start,
            "chunks": int(chunks),
            "done": int(chunks),
            "spans": [s for s in (spans or []) if isinstance(s, dict)],
            "qos": qos,
            "tenant": tenant,
            "completed_at": start + duration_s,
            "degraded": False,
            "short_circuit": True,
        }
        doc = self._build(st)
        with self._lock:
            self._ready.append(doc)
        TRACE_ASSEMBLED.inc()
        return doc

    # -- assembly ----------------------------------------------------------

    def _build(self, st: dict) -> dict:
        """Finalize one scan's waterfall document. Pure computation on
        an already-detached state dict — no locks, no IO."""
        admitted = st.get("admitted_at")
        completed = st.get("completed_at")
        if not isinstance(admitted, (int, float)):
            admitted = min(
                (s["start"] for s in st["spans"]
                 if isinstance(s.get("start"), (int, float))),
                default=time.time(),
            )
        if not isinstance(completed, (int, float)) or completed < admitted:
            completed = max(
                (s["start"] + s.get("duration_s", 0.0) for s in st["spans"]
                 if isinstance(s.get("start"), (int, float))),
                default=admitted,
            )
        root = make_span(
            "scan", st["trace_id"], float(admitted),
            max(0.0, float(completed) - float(admitted)),
            span_id="scan-" + st["scan_id"],
            scan_id=st["scan_id"], chunks=st["chunks"],
            qos=st.get("qos"), tenant=st.get("tenant"),
        )
        spans = []
        for s in st["spans"]:
            c = dict(s)
            # parentless spans hang off the scan root by design; spans
            # whose declared parent is missing stay orphaned so the
            # smoke clause can detect a lossy assembly
            if not c.get("parent_id"):
                c["parent_id"] = root["span_id"]
            spans.append(c)
        # the acceptance quantity: wall-clock COVERAGE of the gateway-
        # latency window by the root's direct children — an interval
        # union, not a plain sum, because one chunk's attempt
        # legitimately overlaps a later chunk's queue-wait (both are
        # real, concurrent root-level segments) and overlap must not
        # read as >100% coverage. Within 10% of the window ⇒ no
        # unattributed blind spots. A small start grace absorbs
        # cross-process wall-clock quantization; the pre-admission
        # handler span deliberately starts before admitted_at and is
        # excluded here.
        root_end = root["start"] + root["duration_s"]
        ivs = sorted(
            (max(c["start"], root["start"]),
             min(c["start"] + (c.get("duration_s") or 0.0), root_end))
            for c in spans
            if c.get("parent_id") == root["span_id"]
            and isinstance(c.get("start"), (int, float))
            and c["start"] >= root["start"] - 0.005
        )
        seg, cov_end = 0.0, None
        for s0, s1 in ivs:
            if s1 <= s0:
                continue
            if cov_end is None or s0 > cov_end:
                seg += s1 - s0
                cov_end = s1
            elif s1 > cov_end:
                seg += s1 - cov_end
                cov_end = s1
        doc = {
            "scan_id": st["scan_id"],
            "trace_id": st["trace_id"],
            "qos": st.get("qos"),
            "tenant": st.get("tenant"),
            "chunks": st["chunks"],
            "status": (
                "short_circuit" if st.get("short_circuit")
                else "degraded" if st.get("degraded") else "complete"
            ),
            "root": root,
            "spans": spans,
            "gateway_latency_s": root["duration_s"],
            "segments_sum_s": seg,
        }
        if "generation" in st:
            doc["generation"] = st["generation"]
        return doc

    # -- persistence / retrieval ------------------------------------------

    def flush(self) -> int:
        """Persist staged waterfalls (memory cache + ``_traces/`` blobs
        with bounded retention). MUST be called with no queue lock held
        — this is the only ingestion-path method that does blob IO."""
        with self._lock:
            ready, self._ready = self._ready, []
            for doc in ready:
                self._finalized[doc["scan_id"]] = doc
                while len(self._finalized) > self.FINALIZED_CACHE:
                    self._finalized.pop(next(iter(self._finalized)))
        if not ready:
            return 0
        if self._blobs is not None:
            stale: list[str] = []
            with self._lock:
                for doc in ready:
                    key = self.PREFIX + doc["scan_id"] + ".json"
                    if key not in self._written:
                        self._written.append(key)
                while len(self._written) > self.RETAIN:
                    stale.append(self._written.pop(0))
            for doc in ready:
                try:
                    self._blobs.put(
                        self.PREFIX + doc["scan_id"] + ".json",
                        json.dumps(doc, default=str).encode("utf-8"),
                    )
                except Exception:
                    pass  # tracing must never fail the completion path
            for key in stale:
                try:
                    self._blobs.delete(key)
                except Exception:
                    pass
        return len(ready)

    def get(self, scan_id: str) -> Optional[dict]:
        """Finished waterfall (memory, then blob), or a live partial
        view of a still-open scan (status ``open``)."""
        with self._lock:
            doc = self._finalized.get(scan_id)
            st = self._scans.get(scan_id)
            if doc is None and st is not None:
                st = dict(st, spans=list(st["spans"]))
        if doc is not None:
            return doc
        if st is not None:
            partial = self._build(st)
            partial["status"] = "open"
            return partial
        if self._blobs is not None:
            try:
                raw = self._blobs.get(self.PREFIX + scan_id + ".json")
            except Exception:
                raw = None
            if raw:
                try:
                    return json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    return None
        return None


# ---------------------------------------------------------------------------
# waterfall analysis (shared by the CLI renderer and the bench gates)


def waterfall_orphans(doc: dict) -> list[dict]:
    """Spans whose parent_id resolves to no span in the document."""
    ids = {doc["root"]["span_id"]}
    ids.update(s["span_id"] for s in doc.get("spans", ()) if s.get("span_id"))
    return [
        s for s in doc.get("spans", ())
        if s.get("parent_id") not in ids
    ]


def critical_path(doc: dict) -> list[tuple[str, float, float]]:
    """Per-segment attribution: ``(name, seconds, fraction-of-root)``
    for the root's direct children, merged by name, largest first —
    the "queue-wait 61%, device 22%, upload 9%" summary.

    Same-name siblings are merged by interval UNION, not sum: a
    multi-chunk scan's later queue-waits overlap its earlier attempts
    (they all start at admission), and a plain sum would report
    queue-wait at >100% of the scan. The union answers the operator's
    actual question — "for what share of this scan's wall clock was at
    least one chunk waiting / executing?"."""
    root = doc["root"]
    total = root.get("duration_s") or 0.0
    by_name: dict[str, list] = {}
    for s in doc.get("spans", ()):
        if s.get("parent_id") == root["span_id"] and isinstance(
            s.get("start"), (int, float)
        ):
            by_name.setdefault(s["name"], []).append(
                (s["start"], s["start"] + (s.get("duration_s") or 0.0))
            )
    out = []
    for name, ivs in by_name.items():
        ivs.sort()
        secs, cov_end = 0.0, None
        for s0, s1 in ivs:
            if s1 <= s0:
                continue
            if cov_end is None or s0 > cov_end:
                secs += s1 - s0
                cov_end = s1
            elif s1 > cov_end:
                secs += s1 - cov_end
                cov_end = s1
        out.append((name, secs, (secs / total) if total > 0 else 0.0))
    out.sort(key=lambda t: -t[1])
    return out
