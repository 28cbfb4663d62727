"""The port's telemetry: metrics registry, correlated events and span
tracing, the port of ``swarm_tpu/telemetry`` for the layers the port
has.

- :mod:`~swarm_tpu_torch.telemetry.metrics` — a process-wide,
  thread-safe registry of counters/gauges/histograms with label support
  and Prometheus text-format exposition (``REGISTRY.render()``);
- :mod:`~swarm_tpu_torch.telemetry.events` — structured JSON event
  lines (``ts, trace_id, job_id, phase, …``) keyed by the trace ID the
  client mints per scan and the server hands the worker on each job;
- :mod:`~swarm_tpu_torch.telemetry.tracing` — the worker's span
  collector per job attempt, the always-on flight recorder and the
  queue's per-scan waterfall assembler.

Families, kinds, help strings, label names and buckets are the
reference's, letter for letter: the JAX server and its scrapers read
them. A family of a layer the port does not have yet (the server app's,
the fleet's) is not registered; the queue's own register when
``server/queue.py`` is imported; ``journal_export`` also
registers the queue's recovery families, as the reference's does; the
``swarm_aot_*`` families count the port's kernel libraries
(:mod:`~swarm_tpu_torch.telemetry.aot_export`).
"""

from swarm_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from swarm_tpu_torch.telemetry.events import (  # noqa: F401
    emit_event,
    new_trace_id,
    subscribe,
)

# the walk, device, shard, memo, sched, journal, aot, trace, monitor,
# worker-drain, workflow and gateway families register at import time
# so every process's exposition carries them
from swarm_tpu_torch.telemetry import walk_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import device_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import shard_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import memo_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import sched_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import journal_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import aot_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import trace_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import monitor_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import fleet_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import workflow_export  # noqa: E402,F401
from swarm_tpu_torch.telemetry import gateway_export  # noqa: E402,F401
