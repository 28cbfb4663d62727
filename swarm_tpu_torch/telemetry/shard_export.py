"""Always-registered ``swarm_shard_*`` metric families, the port of
``swarm_tpu/telemetry/shard_export.py``.

The mesh serving path's counters are the scrape-time surface of
:class:`~swarm_tpu_torch.parallel.sharded.ShardedMatcher`. They are
created at telemetry import time — not on first sharded dispatch — so
every process's exposition carries the families with a rendered sample
(an operator can then tell "no mesh configured" from "family missing").
Names, help strings and labels are the reference's: its server and
scrapers read them. "ICI", "psum" and "ppermute" in the help strings
are the reference's words for the combine across ranks and the halo
copies.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: mesh axis sizes of the most recently constructed ShardedMatcher
#: (data × model × seq — docs/SHARDING.md; 0 = no mesh in this process)
MESH_AXIS = REGISTRY.gauge(
    "swarm_shard_mesh_axis_size",
    "Mesh axis size of the live sharded matcher (0 = unsharded)",
    ("axis",),
)
#: min per-data-rank real-row occupancy of the most recent sharded
#: batch (the scheduler-aware placement target: every rank should hold
#: ~1/R of the batch's REAL rows, not one rank all-real + R-1 all-pad)
RANK_FILL = REGISTRY.gauge(
    "swarm_shard_rank_fill_ratio",
    "Min per-data-rank real-row fill of the most recent sharded batch",
)
#: slot/overflow plane bytes entering the cross-rank psum per dispatch
#: (global rows × (2·slots + overflow) int32 lanes; 0 when the mesh has
#: no communicating model/seq axis)
PSUM_BYTES = REGISTRY.counter(
    "swarm_shard_psum_bytes_total",
    "Bit-plane bytes combined over ICI by the sharded match psum",
)
#: ppermute halo-exchange bytes per dispatch (2 × halo × rows per
#: stream; 0 on seq-unsharded meshes), labeled by the PHASE whose
#: kernel paid the round — the compacted path fuses the exchange into
#: phase a and carries extended views, so phase="b" stays flat there
#: and only the fused reference twin would ever have charged it
HALO_BYTES = REGISTRY.counter(
    "swarm_shard_halo_bytes_total",
    "Response-stream bytes exchanged as seq-axis ppermute halos",
    ("phase",),
)
#: halo bytes the single-round fused exchange did NOT ship (the
#: historical phase-B re-exchange, charged here instead of to
#: swarm_shard_halo_bytes_total — the fusion win, directly scrapeable)
HALO_SAVED = REGISTRY.counter(
    "swarm_shard_halo_bytes_saved_total",
    "Halo bytes avoided by fusing the seq-axis exchange into phase A",
)
SHARD_DISPATCHES = REGISTRY.counter(
    "swarm_shard_dispatches_total",
    "Batches dispatched through the sharded mesh matcher",
)
#: compacted dispatches whose predecessor's deferred cross-rank
#: reduction was flushed behind this dispatch's phase A — the
#: double-buffered overlap actually happening (collect-forced and
#: inline launches don't count)
OVERLAPPED = REGISTRY.counter(
    "swarm_shard_overlapped_dispatches_total",
    "Sharded dispatches that overlapped the previous batch's deferred "
    "reduction behind their own phase A",
)
#: wall seconds collect() spent blocked on the deferred reduction
#: (launch-if-needed + device wait + the fused host read); ≈0 per
#: batch when the in-flight window keeps the overlap fed
REDUCTION_WAIT = REGISTRY.counter(
    "swarm_shard_reduction_wait_seconds",
    "Seconds collect() stalled waiting on deferred sharded reductions",
)
#: the most recent compacted sharded batch's global max per-row
#: survivor count (the host-read maxima that size the probe rung)
SURVIVOR_MAX = REGISTRY.gauge(
    "swarm_shard_survivor_max",
    "Max per-row prefilter survivors (global pmax) in the most recent "
    "compacted sharded batch",
)

# pre-seed the axis/phase labels so the families always render samples
# (a labeled family with no observed combos renders no lines, which
# would read as "family missing" to the exposition check)
for _ax in ("data", "model", "seq"):
    MESH_AXIS.labels(axis=_ax).set(0)
del _ax
for _ph in ("a", "b"):
    HALO_BYTES.labels(phase=_ph).inc(0)
del _ph
