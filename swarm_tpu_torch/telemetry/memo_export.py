"""Always-registered ``swarm_memo_*`` lookup family, the port of
``swarm_tpu/telemetry/memo_export.py`` for the level the port has.

The engine's native verdict memo is the result cache's L1. Its lookups
report through ``swarm_memo_lookups_total``, registered at telemetry
import time — not on first engine construction — so every process's
exposition carries it with rendered samples. The shared result tier
behind the L1 (``swarm_tpu/cache``) is not ported, and neither are its
families (writebacks, evictions, hit ratio, lookup seconds, epoch
generation) nor the ``tier="shared"`` lookups.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: per-level lookup outcomes. ``tier="l1"`` is the engine's native
#: verdict memo (counted per batch at encode time, rows as the unit).
MEMO_LOOKUPS = REGISTRY.counter(
    "swarm_memo_lookups_total",
    "Result-cache lookups by level (l1 = native memo rows, shared = "
    "remote tier digests) and outcome",
    ("tier", "outcome"),
)
L1_HITS = MEMO_LOOKUPS.labels(tier="l1", outcome="hit")
L1_MISSES = MEMO_LOOKUPS.labels(tier="l1", outcome="miss")
