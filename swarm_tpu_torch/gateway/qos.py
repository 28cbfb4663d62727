"""QoS (latency) classes for latency-tiered serving (docs/GATEWAY.md).

The port's copy of ``swarm_tpu/gateway/qos.py``: its constants and
functions are the reference's, line for line (``tests/test_torch_gateway.py``);
``sched/buckets.py`` keeps the same two class names.

Two classes, threaded end to end — client flag → ``X-Swarm-QoS``
header → ``Job.qos`` wire field → the queue's express dispatch lane →
the scheduler's deadline-flush path:

- **bulk** (the default, and what every reference submission is): rows
  coalesce into full device batches; throughput-optimal, latency
  unbounded by design.
- **interactive**: single-target lookups that want an answer in tens
  of milliseconds. Jobs ride a per-tenant express lane that ``next_job``
  serves ahead of bulk (bounded by ``qos_express_burst`` so bulk can
  never starve), and rows force an early partial-bucket flush once
  older than ``qos_deadline_ms`` in the scheduler's planner.

Absent/None always means bulk — the wire contract the reference client
speaks is untouched.
"""

from __future__ import annotations

from typing import Optional

#: header carrying the class, next to X-Swarm-Tenant
QOS_HEADER = "X-Swarm-QoS"

QOS_BULK = "bulk"
QOS_INTERACTIVE = "interactive"

#: every accepted wire value (anything else is a 400 at the gateway)
QOS_CLASSES = (QOS_BULK, QOS_INTERACTIVE)


def parse_qos(value: Optional[str]) -> Optional[str]:
    """Normalize a header/flag value to a stored class: ``None`` for
    absent/empty/bulk (the record then round-trips byte-identical to a
    pre-QoS submission), ``"interactive"`` for the express class.
    Raises ValueError on anything else — an unknown class must 400 at
    the gateway, not silently ride the bulk lane."""
    if value is None:
        return None
    v = value.strip().lower()
    if v in ("", QOS_BULK):
        return None
    if v == QOS_INTERACTIVE:
        return QOS_INTERACTIVE
    raise ValueError(f"Invalid QoS class {value!r}")


def qos_class(qos: Optional[str]) -> str:
    """The metric-label class of a stored ``Job.qos`` value (None and
    anything unrecognized count as bulk — label space stays bounded
    even against a hand-crafted job record)."""
    return QOS_INTERACTIVE if qos == QOS_INTERACTIVE else QOS_BULK
