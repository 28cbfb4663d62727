"""Always-registered ``swarm_fleet_*`` / ``swarm_worker_drain_*``
families, the port's copy of ``swarm_tpu/telemetry/fleet_export.py``.

The elastic fleet (``server/fleet.py``) — EWMA inflow forecasting,
preemptible simulated nodes — and the worker's graceful drain
(``JobProcessor.drain``) report through these families, registered at
telemetry import time so every process's ``/metrics`` carries them with
rendered samples, also on a server that never scaled. State, action and
outcome label values are pre-seeded for the same reason: a labeled
family with no observed label values renders no lines.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: live fleet nodes by lifecycle state (SimulatedProvider bookkeeping;
#: real providers report only ``ready``): ``booting`` = spun up, still
#: inside its cold-start window; ``ready`` = servable; ``draining`` =
#: preemption notice received, kill-after-grace pending
FLEET_NODES = REGISTRY.gauge(
    "swarm_fleet_nodes",
    "Fleet nodes by lifecycle state",
    ("state",),
)
for _s in ("booting", "ready", "draining"):
    FLEET_NODES.labels(state=_s).set(0)
del _s

#: the advisor's most recent fleet-size target (forecast-driven,
#: clamped, hysteresis applied) — compare against swarm_fleet_nodes
FLEET_TARGET = REGISTRY.gauge(
    "swarm_fleet_target_nodes",
    "AutoscaleAdvisor's most recent target fleet size",
)
FLEET_TARGET.labels().set(0)

#: the EWMA inflow forecast the target was derived from (jobs/second,
#: aggregated across tenants)
FLEET_FORECAST = REGISTRY.gauge(
    "swarm_fleet_forecast_rate",
    "EWMA-forecasted job inflow rate (jobs/s, all tenants)",
)
FLEET_FORECAST.labels().set(0.0)

#: advisor-applied scale actions (``scale_to_zero`` counts a
#: spin-down that parked the whole fleet for an idle tenant set)
FLEET_SCALE_EVENTS = REGISTRY.counter(
    "swarm_fleet_scale_events_total",
    "Autoscale actions applied to the provider",
    ("action",),
)
for _a in ("spin_up", "spin_down", "scale_to_zero"):
    FLEET_SCALE_EVENTS.labels(action=_a)
del _a

#: provider preemption notices issued (SimulatedProvider draws +
#: explicit/injected preemptions)
FLEET_PREEMPTIONS = REGISTRY.counter(
    "swarm_fleet_preemptions_total",
    "Preemption notices issued against fleet nodes",
)

#: node cold-start wall seconds (spin-up to servable) — a joiner that
#: fetches its kernel libraries from the AOT store against one that
#: runs nvcc is the scale-to-zero story
FLEET_COLDSTART = REGISTRY.histogram(
    "swarm_fleet_coldstart_seconds",
    "Node cold-start latency: spin-up to servable",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0),
)

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
