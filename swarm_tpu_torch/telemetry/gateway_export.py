"""Always-registered ``swarm_gateway_*`` metric families (docs/GATEWAY.md).

The port's copy of ``swarm_tpu/telemetry/gateway_export.py``: the
same names, kinds, help strings, labels, buckets and pre-seeded label
values, which the server and its scrapers read.

The multi-tenant gateway (``swarm_tpu_torch/gateway``) fronts the job queue
with admission control: per-tenant token buckets, bounded per-tenant
queues, and composite-pressure load shedding. Every admission decision,
shed, queued-by-tenant depth and streamed result byte reports through
these families, registered at telemetry import time — not on first
gateway construction — so EVERY process's ``/metrics`` carries them
with rendered samples (``tools/check_metrics.py`` requires them on a
server that has not seen a single tenant yet). Label combinations for
the default tenant are pre-seeded for the same reason: a labeled family
with no observed combos renders no lines, which would read as "family
missing" to the exposition check.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: admitted /queue submissions by tenant (one increment per accepted
#: POST, not per chunk — chunk fan-out is the queue's business)
GATEWAY_ADMITTED = REGISTRY.counter(
    "swarm_gateway_admitted_total",
    "Scan submissions admitted through the gateway, by tenant",
    ("tenant",),
)
GATEWAY_ADMITTED.labels(tenant="default")

#: shed /queue submissions by tenant and reason (``rate`` = token
#: bucket empty, ``queue_full`` = per-tenant queue bound, ``pressure``
#: = composite backpressure signal over the shed threshold,
#: ``tenant_limit`` = a NEW tenant id past the gateway_max_tenants
#: cardinality cap — attributed to the default row so client-minted
#: ids can't explode the label space)
GATEWAY_SHED = REGISTRY.counter(
    "swarm_gateway_shed_total",
    "Scan submissions shed (429) by the gateway, by tenant and reason",
    ("tenant", "reason"),
)
for _r in ("rate", "queue_full", "pressure", "tenant_limit"):
    GATEWAY_SHED.labels(tenant="default", reason=_r)
del _r

#: jobs currently waiting in each tenant's dispatch queue (scrape-time
#: collector on the server, like swarm_queue_depth)
GATEWAY_QUEUED = REGISTRY.gauge(
    "swarm_gateway_queued_by_tenant",
    "Jobs waiting in the dispatch queue, by tenant",
    ("tenant",),
)
GATEWAY_QUEUED.labels(tenant="default").set(0)

#: the composite admission pressure signal, 0 = idle, >= shed
#: threshold (default 1.0) = shedding. Deterministic function of the
#: queue/saturation/breaker snapshot (docs/GATEWAY.md)
GATEWAY_PRESSURE = REGISTRY.gauge(
    "swarm_gateway_pressure",
    "Composite gateway admission pressure (0 idle .. >=1 shedding)",
)
GATEWAY_PRESSURE.labels().set(0.0)

#: NDJSON result bytes pushed to /stream/<scan_id> clients
GATEWAY_STREAM_BYTES = REGISTRY.counter(
    "swarm_gateway_stream_bytes_total",
    "Result bytes pushed to /stream clients (NDJSON payload lines)",
)

#: admission-to-verdict latency per QoS class (docs/GATEWAY.md §QoS):
#: observed once per job at its COMPLETE transition (completed_at -
#: admitted_at), and once per gateway-cache short-circuit (the handler
#: elapsed time — the scan completed without a worker). Buckets span
#: the interactive SLO range through bulk batch times. Both class
#: combos pre-seeded so the families render before the first scan.
GATEWAY_LATENCY = REGISTRY.histogram(
    "swarm_gateway_latency_seconds",
    "Admission-to-verdict latency by QoS class",
    ("qos",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0),
)
for _q in ("bulk", "interactive"):
    GATEWAY_LATENCY.labels(qos=_q)
del _q

#: gateway-tier cache short-circuit outcomes (docs/GATEWAY.md §QoS):
#: ``hit`` = every chunk of an interactive submission was fleet-known
#: and the scan completed at the gateway with zero worker dispatch;
#: ``miss`` = at least one chunk unknown, normal admission followed
GATEWAY_SHORT_CIRCUIT = REGISTRY.counter(
    "swarm_gateway_cache_short_circuit_total",
    "Interactive submissions answered (hit) or passed through (miss) "
    "by the gateway-tier result cache",
    ("outcome",),
)
for _o in ("hit", "miss"):
    GATEWAY_SHORT_CIRCUIT.labels(outcome=_o)
del _o
