"""Always-registered ``swarm_monitor_*`` metric families (docs/MONITORING.md).

The port's copy of ``swarm_tpu/telemetry/monitor_export.py``: the
same names, kinds, help strings, labels and pre-seeded label values.

The continuous-monitoring subsystem (``swarm_tpu_torch/monitor``) turns
one-shot scans into standing rescans: journaled specs, cadence-fired
epochs, per-target verdict diffs and an NDJSON change feed. Every
epoch firing, diff record and steady-state cache outcome reports
through these families, registered at telemetry import time — not on
first monitor registration — so EVERY process's ``/metrics`` carries
them with rendered samples (``tools/check_metrics.py`` requires them
on a server that has never seen a monitor spec). Label combinations
for the diff-record kinds are pre-seeded for the same reason: a
labeled family with no observed combos renders no lines, which would
read as "family missing" to the exposition check.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: epochs actually fired (spec due + admitted + submitted — a shed
#: epoch retries late and only counts when it finally fires)
MONITOR_EPOCHS = REGISTRY.counter(
    "swarm_monitor_epochs_fired_total",
    "Monitor epochs fired through the admission path",
)

#: diff records appended to monitors' change feeds, by kind (``new`` =
#: first verdict for a target, ``changed`` = verdict differs from the
#: prior epoch's, ``resolved`` = a previously reported verdict went
#: empty / the target left the spec)
MONITOR_DIFF_RECORDS = REGISTRY.counter(
    "swarm_monitor_diff_records_total",
    "Change-feed diff records emitted, by kind",
    ("kind",),
)
for _k in ("new", "changed", "resolved"):
    MONITOR_DIFF_RECORDS.labels(kind=_k)
del _k

#: fraction of the most recent completed epoch's targets answered from
#: the shared tier without worker dispatch (the steady-state cost
#: story: ~1.0 on an unchanged fleet, docs/MONITORING.md §Cost model)
MONITOR_RESCAN_HIT_RATIO = REGISTRY.gauge(
    "swarm_monitor_rescan_cache_hit_ratio",
    "Per-epoch fraction of monitor targets served from cache",
)
MONITOR_RESCAN_HIT_RATIO.labels().set(0.0)

#: registered standing monitor specs (paused specs included — they
#: hold a registry slot even while emitting nothing)
MONITOR_SPECS = REGISTRY.gauge(
    "swarm_monitor_standing_specs",
    "Registered standing monitor specs (paused included)",
)
MONITOR_SPECS.labels().set(0)
