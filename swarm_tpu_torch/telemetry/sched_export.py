"""Always-registered ``swarm_sched_*`` QoS families, the port of
``swarm_tpu/telemetry/sched_export.py``.

The scheduler's own feed families (``swarm_sched_batches_total`` etc.)
register when ``swarm_tpu_torch.sched`` first imports. These two — the
deadline flush and the batch age — register at telemetry import time
with both class combos pre-seeded, so they are visible on every
process's exposition, scheduler imported or not;
``sched/scheduler.py`` imports them from here.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: deadline-forced partial-bucket flushes by class: ``interactive`` =
#: a row older than ``qos_deadline_ms`` pre-empted coalescing into an
#: early express batch; ``bulk`` = the optional ``sched_max_age_ms``
#: knob bounded a trickling scan's tail wait
SCHED_FLUSH_DEADLINE = REGISTRY.counter(
    "swarm_sched_flush_deadline_total",
    "Partial-bucket flushes forced by a lapsed deadline, by QoS class",
    ("qos",),
)
for _q in ("bulk", "interactive"):
    SCHED_FLUSH_DEADLINE.labels(qos=_q)
del _q

#: per-batch coalescing wait by class: the OLDEST row's planner-queue
#: age at submit time (the scheduler-side half of the admission-to-
#: verdict story — what the deadline flush actually bounds)
SCHED_BATCH_AGE = REGISTRY.histogram(
    "swarm_sched_batch_age_seconds",
    "Oldest-row planner wait per submitted batch, by QoS class",
    ("qos",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)
for _q in ("bulk", "interactive"):
    SCHED_BATCH_AGE.labels(qos=_q)
del _q
