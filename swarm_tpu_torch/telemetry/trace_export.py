"""Always-registered ``swarm_trace_*`` metric families, the port of
``swarm_tpu/telemetry/trace_export.py`` for the worker side.

The span layer (``telemetry/tracing.py``) reports span production
and drops through these families, registered at
telemetry import time — not on first span — so every process's
exposition carries them with rendered samples. Label combinations are
pre-seeded for the same reason: a labeled family with no observed
combos renders no lines, which would read as "family missing".
``swarm_trace_assembled_total`` belongs to the server's waterfall
assembler, which the port does not have, and
``swarm_trace_flight_dumps_total`` to the flight recorder, which it
does not have either.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: spans recorded (live context-manager spans and worker-synthesized
#: device/walk children all count here)
TRACE_SPANS = REGISTRY.counter(
    "swarm_trace_spans_total",
    "Trace spans recorded across all layers",
)

#: spans dropped instead of recorded: ``context_full`` = one attempt's
#: bounded span list overflowed, ``scan_limit`` = one scan's assembly
#: state hit its per-scan bound, ``unregistered`` = spans arrived for a
#: scan the assembler never registered (the last two on the server)
TRACE_SPANS_DROPPED = REGISTRY.counter(
    "swarm_trace_spans_dropped_total",
    "Trace spans dropped instead of recorded, by reason",
    ("reason",),
)
for _r in ("context_full", "scan_limit", "unregistered"):
    TRACE_SPANS_DROPPED.labels(reason=_r)
del _r
