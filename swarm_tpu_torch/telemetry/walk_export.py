"""Always-registered ``swarm_walk_*`` metric families, the port of
``swarm_tpu/telemetry/walk_export.py``.

The host walk's batched-confirm counters live in ``EngineStats`` (the
hot path never touches a real metric); these gauges are the scrape-time
surface. They are created at telemetry import time — not on first
engine registration — so every process's exposition carries the
families with a rendered sample. Values are aggregated from live
engines by the collector in :mod:`swarm_tpu_torch.telemetry.engine_export`
at scrape time.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: widest live walk pool in the process (0 = batching runs inline on
#: the walk thread, or the serial reference walk is pinned)
WALK_POOL_THREADS = REGISTRY.gauge(
    "swarm_walk_pool_threads",
    "Widest live engine walk pool (SWARM_WALK_THREADS; 0 = inline or "
    "serial)",
)
#: (row, matcher) / (row, op) confirm pairs resolved by the grouped
#: GIL-released native passes instead of the per-pair serial path
WALK_BATCHED_PAIRS = REGISTRY.gauge(
    "swarm_walk_batched_pairs",
    "Confirm pairs resolved by the walk's batched native passes",
)
WALK_BATCH_ROUNDS = REGISTRY.gauge(
    "swarm_walk_batch_rounds",
    "Walk batches that dispatched at least one grouped confirm pass",
)
WALK_PRECOMPUTE_SECONDS = REGISTRY.gauge(
    "swarm_walk_precompute_seconds",
    "Seconds in the walk's confirm plan+dispatch (subset of "
    "host_confirm_seconds)",
)
#: host-walk sub-phase attribution (all subsets of
#: ``swarm_engine_host_confirm_seconds``): uncertainty resolution, the
#: extraction pass, memo inserts, member fan-out/fixup
WALK_PHASE_SECONDS = REGISTRY.gauge(
    "swarm_walk_phase_seconds",
    "Host-walk sub-phase seconds across live engines",
    ("phase",),
)
# pre-seed every phase label so the family always renders samples
# (a labeled family with no observed combos renders no lines, which
# would read as "family missing" to the exposition check)
for _ph in ("unc", "ext", "insert", "fixup"):
    WALK_PHASE_SECONDS.labels(phase=_ph).set(0.0)
del _ph
