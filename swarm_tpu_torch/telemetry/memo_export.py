"""Always-registered ``swarm_memo_*`` metric families, the port of
``swarm_tpu/telemetry/memo_export.py``.

The result cache is a two-level hierarchy: the engine's native verdict
memo is the L1, the shared result tier (``swarm_tpu_torch/cache``, over
the state and blob stores of ``swarm_tpu_torch/stores.py``) sits behind
it. Both levels report through these families, registered at telemetry
import time — not on first cache construction — so every process's
exposition carries them with rendered samples. Names, help strings,
labels, buckets and the pre-seeded label combinations are the
reference's: a labeled family with no observed combination renders no
lines, which would read as "family missing" to a scraper.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: per-level lookup outcomes. ``tier="l1"`` is the engine's native
#: verdict memo (counted per batch at encode time, rows as the unit);
#: ``tier="shared"`` is the remote tier (counted per DISTINCT content
#: digest actually queried — suppressed re-lookups of a recent miss
#: are not counted, they never left the process).
MEMO_LOOKUPS = REGISTRY.counter(
    "swarm_memo_lookups_total",
    "Result-cache lookups by level (l1 = native memo rows, shared = "
    "remote tier digests) and outcome",
    ("tier", "outcome"),
)
L1_HITS = MEMO_LOOKUPS.labels(tier="l1", outcome="hit")
L1_MISSES = MEMO_LOOKUPS.labels(tier="l1", outcome="miss")
SHARED_HITS = MEMO_LOOKUPS.labels(tier="shared", outcome="hit")
SHARED_MISSES = MEMO_LOOKUPS.labels(tier="shared", outcome="miss")

#: shared-tier writeback outcomes per value family. ``fenced`` =
#: rejected by the tier's fencing-token check (a superseded writer —
#: the poisoning case the discipline exists for); ``error`` = the
#: breaker-wrapped store op failed (tier degraded, entry dropped).
MEMO_WRITEBACKS = REGISTRY.counter(
    "swarm_memo_writebacks_total",
    "Shared result-tier writebacks by value family and outcome",
    ("family", "outcome"),
)
for _f in ("verdict", "confirm"):
    for _o in ("stored", "fenced", "error"):
        MEMO_WRITEBACKS.labels(family=_f, outcome=_o)
del _f, _o

#: TTL/size-policy evictions (docs/CACHING.md): ``ttl`` = an entry
#: whose age exceeded ``cache_ttl_s`` was dropped at lookup (lazy
#: expiry, counted as a miss), ``size`` = the oldest entries were
#: dropped at write time to honor ``cache_max_entries`` per family
#: namespace. Zero forever under the default policy-off config.
MEMO_EVICTIONS = REGISTRY.counter(
    "swarm_memo_evictions_total",
    "Shared result-tier entries evicted by the TTL/size policy",
    ("reason",),
)
for _r in ("ttl", "size"):
    MEMO_EVICTIONS.labels(reason=_r)
del _r

#: process-lifetime shared hit ratio (hits / (hits + misses) over
#: every client in the process; 0 until the first shared lookup)
MEMO_HIT_RATIO = REGISTRY.gauge(
    "swarm_memo_shared_hit_ratio",
    "Shared result-tier hit ratio over this process's lifetime",
)
MEMO_HIT_RATIO.labels().set(0.0)

#: latency of one batched shared-tier lookup round trip (unlabeled so
#: the family renders bucket/sum/count lines even before a tier is
#: attached). Buckets sized for embedded-store (~us) through remote
#: Redis (~ms) round trips.
MEMO_LOOKUP_SECONDS = REGISTRY.histogram(
    "swarm_memo_shared_lookup_seconds",
    "Wall seconds per batched shared result-tier lookup",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
)

#: the tier's invalidation epoch GENERATION (the operator-bump half of
#: the epoch; the corpus-digest half is a hash, not a number). -1 until
#: a client binds.
MEMO_EPOCH = REGISTRY.gauge(
    "swarm_memo_epoch_generation",
    "Shared result-tier epoch generation this process is bound to "
    "(-1 = no tier attached)",
)
MEMO_EPOCH.labels().set(-1.0)
