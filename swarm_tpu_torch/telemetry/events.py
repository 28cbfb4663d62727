"""Correlated structured logging: one JSON line per lifecycle event, the
port of ``swarm_tpu/telemetry/events.py``.

Every scan gets a trace ID minted by the client (:func:`new_trace_id`),
carried in the ``X-Swarm-Trace`` header through ``/queue``, stored on
each job record, handed back out via ``/get-job``, and echoed by the
worker — so every layer's events for one scan share a ``trace_id`` and
``grep <trace_id>`` reconstructs the whole lifecycle:

    {"ts": ..., "event": "scan.submit",     "trace_id": "ab12...", ...}
    {"ts": ..., "event": "job.queued",      "trace_id": "ab12...", "job_id": ...}
    {"ts": ..., "event": "job.dispatch",    "trace_id": "ab12...", "worker_id": ...}
    {"ts": ..., "event": "job.start",       "trace_id": "ab12...", "module": ...}
    {"ts": ..., "event": "job.phase",       "trace_id": "ab12...", "phase": "executing"}
    {"ts": ..., "event": "job.terminal",    "trace_id": "ab12...", "status": "complete"}
    {"ts": ..., "event": "job.worker_done", "trace_id": "ab12...", "perf": {...}}

(``job.terminal`` is the server's view of a terminal transition;
``job.worker_done`` the worker's. ``job.requeued`` /
``job.lease_exhausted`` / ``scan.stream_start`` round out the set.)

Emission sinks, all optional and independent:

- ``SWARM_EVENTS`` env: ``stderr``/``1`` streams lines to stderr; any
  other value is an append-path for a JSONL event log.
- in-process subscribers (:func:`subscribe`) — how tests and embedded
  tooling observe the stream without parsing stderr.
- the ``swarm_events_total{event=...}`` counter, so event volume is
  itself visible on ``/metrics``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import uuid
from typing import Callable, Optional

from swarm_tpu_torch.telemetry import metrics as _metrics

#: Name of the trace-propagation header (client → server → worker).
TRACE_HEADER = "X-Swarm-Trace"

#: What the server accepts from the wire: trace ids are stored into
#: every job record and event line of the scan, so a hostile header
#: must not smuggle multi-KB blobs or control characters through the
#: telemetry plane (same defense-in-depth posture as SCAN_ID_RE).
TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")

ENV_SINK = "SWARM_EVENTS"

_lock = threading.Lock()
_subscribers: list[Callable[[dict], None]] = []  # guarded-by: _lock (reads)

_EVENTS_TOTAL = _metrics.REGISTRY.counter(
    "swarm_events_total", "Structured telemetry events emitted", ("event",)
)


def new_trace_id() -> str:
    """Mint a scan-scoped trace ID (32 hex chars, uuid4)."""
    return uuid.uuid4().hex


def subscribe(fn: Callable[[dict], None]) -> Callable[[], None]:
    """Register an in-process event observer; returns an unsubscribe."""
    with _lock:
        _subscribers.append(fn)

    def unsubscribe() -> None:
        with _lock:
            try:
                _subscribers.remove(fn)
            except ValueError:
                pass

    return unsubscribe


def emit_event(
    event: str,
    trace_id: Optional[str] = None,
    job_id: Optional[str] = None,
    **fields,
) -> dict:
    """Emit one structured event line; returns the record.

    ``None``-valued fields are dropped so records stay grep-friendly
    (absent beats ``"trace_id": null``).
    """
    rec: dict = {"ts": round(time.time(), 6), "event": event}
    if trace_id is not None:
        rec["trace_id"] = trace_id
    if job_id is not None:
        rec["job_id"] = job_id
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    _EVENTS_TOTAL.labels(event=event).inc()

    sink = os.environ.get(ENV_SINK, "")
    if sink:
        try:
            line = json.dumps(rec, sort_keys=True, default=str)
            if sink in ("1", "stderr"):
                print(line, file=sys.stderr, flush=True)
            else:
                with open(sink, "a") as f:
                    f.write(line + "\n")
        except (OSError, TypeError, ValueError):
            pass  # telemetry must never take down the data path

    with _lock:
        subs = list(_subscribers)
    for fn in subs:
        try:
            fn(rec)
        except Exception:
            pass
    return rec


def header_trace_id(headers: dict) -> Optional[str]:
    """Case-insensitive ``X-Swarm-Trace`` lookup in a header dict.

    Returns None for absent, empty, or invalid values (anything not
    matching :data:`TRACE_ID_RE`) — the caller then mints a fresh id,
    so a hostile header degrades to an ignored one."""
    want = TRACE_HEADER.lower()
    for k, v in headers.items():
        if str(k).lower() == want:
            v = str(v).strip()
            return v if TRACE_ID_RE.match(v) else None
    return None
