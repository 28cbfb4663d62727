"""The worker's ``swarm_worker_drain_*`` families, from
``swarm_tpu/telemetry/fleet_export.py``.

The graceful drain (``JobProcessor.drain``) reports its outcome and
its seconds here, registered at telemetry import time with the outcome
labels pre-seeded, so every process's exposition carries them. The
fleet's own families (nodes, target, forecast, scale events,
preemptions, cold starts) belong to the server's elastic fleet, which
the port does not have.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: worker drains by outcome: ``completed`` = finished its lease and
#: uploaded before exit, ``spooled`` = output persisted to the disk
#: spool for replay, ``idle`` = nothing in flight, ``aborted`` = the
#: drain itself failed (injected worker.drain fault / hard kill)
WORKER_DRAIN = REGISTRY.counter(
    "swarm_worker_drain_total",
    "Graceful worker drains by outcome",
    ("outcome",),
)
for _o in ("completed", "spooled", "idle", "aborted"):
    WORKER_DRAIN.labels(outcome=_o)
del _o

#: drain-signal-to-exit wall seconds (finish lease + upload/spool +
#: deregister)
WORKER_DRAIN_SECONDS = REGISTRY.histogram(
    "swarm_worker_drain_seconds",
    "Wall seconds from drain signal to worker exit",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
