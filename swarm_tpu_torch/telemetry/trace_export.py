"""Always-registered ``swarm_trace_*`` metric families, the port of
``swarm_tpu/telemetry/trace_export.py``.

The span layer (``telemetry/tracing.py``) reports span production,
drops, waterfall assembly and flight-recorder dumps through these
families, registered at telemetry import time — not on first span — so
every process's exposition carries them with rendered samples. Label
combinations are pre-seeded for the same reason: a labeled family with
no observed combos renders no lines, which would read as "family
missing".
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: spans recorded (live context-manager spans, server-stamped queue-wait
#: spans, and worker-synthesized device/walk children all count here)
TRACE_SPANS = REGISTRY.counter(
    "swarm_trace_spans_total",
    "Trace spans recorded across all layers",
)

#: spans dropped instead of recorded: ``context_full`` = one attempt's
#: bounded span list overflowed, ``scan_limit`` = one scan's assembly
#: state hit its per-scan bound, ``unregistered`` = spans arrived for a
#: scan the assembler never registered (e.g. tracing enabled mid-scan)
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "swarm_trace_spans_dropped_total",
    "Trace spans dropped instead of recorded, by reason",
    ("reason",),
)
for _r in ("context_full", "scan_limit", "unregistered"):
    TRACE_SPANS_DROPPED.labels(reason=_r)
del _r

#: per-scan waterfalls finalized by the server-side assembler
TRACE_ASSEMBLED = REGISTRY.counter(
    "swarm_trace_assembled_total",
    "Per-scan trace waterfalls assembled",
)

#: flight-recorder ring dumps, by triggering fault class
TRACE_FLIGHT_DUMPS = REGISTRY.counter(
    "swarm_trace_flight_dumps_total",
    "Flight-recorder ring dumps, by trigger reason",
    ("reason",),
)
for _d in ("breaker_open", "dead_letter", "journal_recovery", "fault", "other"):
    TRACE_FLIGHT_DUMPS.labels(reason=_d)
del _d
