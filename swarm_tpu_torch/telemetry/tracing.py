"""Span tracing on the worker side, the port of
``swarm_tpu/telemetry/tracing.py:60-414``.

One scan's latency is spent across processes and layers — queue wait
on the server, then on the worker download, the device match, the host
walk, the scheduler's coalescing and the upload. This module records
lightweight SPANS (span_id / parent_id / trace_id / wall start /
monotonic duration / attrs) per job attempt on the worker; the worker
ships them back on the completed job's ``perf`` field (or ``POST
/spans`` for long scans), and the JAX server assembles them into a
per-scan waterfall served at ``GET /trace/<scan_id>``. The assembler
lives with the server and is not part of the port.

Three design rules, in priority order:

1. **Near-zero cost when disabled** (the default). ``span()`` is two
   global loads and one thread-local getattr before returning the
   shared no-op span; the completed-job wire payload is byte-identical
   to the untraced build. Enable with ``SWARM_TRACE=1`` (env) or
   ``tracing.set_enabled(True)`` (runtime override, used by tests so
   they never mutate os.environ).
2. **Spans never block the data path.** The per-attempt span list is
   bounded, and overflow increments
   ``swarm_trace_spans_dropped_total`` instead of growing.
3. **Clocks**: span ``start`` is wall time (``time.time()`` — it must
   line up with the server-stamped ``admitted_at``/``completed_at``
   across processes on one host), span ``duration_s`` is a
   ``perf_counter`` delta (monotonic, immune to NTP steps mid-span).

The reference's always-on flight recorder is not ported: its dumps go
to sinks that only the server registers (``blob_flight_sink``), so a
port worker's ring would have no reader.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Optional

from swarm_tpu_torch.telemetry.trace_export import TRACE_SPANS, TRACE_SPANS_DROPPED

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
    under that binding — engine, scheduler, walk pool threads that
    re-activate it — append here. The list is bounded:
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

