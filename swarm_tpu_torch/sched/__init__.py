"""Continuous-batching scheduler (docs/PIPELINE.md), the port of
``swarm_tpu/sched``.

The batching-policy layer between the worker runtime and the ops
engine: bounded prefetch (decode the next chunk while the current
batch is on the card), padding-bucket batch planning (a small fixed set
of device shapes, partial chunks coalesced), memo short-circuiting
(known rows never enter device buckets), and a backpressure-aware
submission loop with bounded in-flight device batches. Enabled per
engine with ``pipeline="on"`` (env ``SWARM_PIPELINE``); results are
bit-identical to the direct path.
"""

from swarm_tpu_torch.sched.buckets import (  # noqa: F401
    BucketPlanner,
    PlannedBatch,
    width_class,
)
from swarm_tpu_torch.sched.scheduler import (  # noqa: F401
    BatchScheduler,
    SchedStats,
    SchedulerConfig,
)
