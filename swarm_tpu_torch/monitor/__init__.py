"""Continuous monitoring: journaled standing rescans over the existing
engine (docs/MONITORING.md).

The port's copy of ``swarm_tpu/monitor/__init__.py``: the same logic,
records, keys and bytes.

A monitor spec turns a one-shot scan into a standing workload: the
(tenant, module, targets, interval, qos) tuple is registered through
``POST /monitor``, journaled like every queue mutation, and fired as
scan *epochs* on its cadence through the normal admission path. Each
epoch's per-target verdicts are diffed against the prior epoch's and
only the changes flow out — as compact NDJSON records over
``GET /monitor-feed/<monitor_id>`` (resume-from-cursor, durable across
restarts).

One dataflow system, many workloads: monitoring is a control-plane
lane over the existing queue/journal/cache engine, not a second fleet.
"""

from swarm_tpu_torch.monitor.spec import MonitorSpec
from swarm_tpu_torch.monitor.diff import diff_epoch, extract_verdicts
from swarm_tpu_torch.monitor.feed import feed_records, stream_feed

__all__ = [
    "MonitorSpec",
    "diff_epoch",
    "extract_verdicts",
    "feed_records",
    "stream_feed",
]
