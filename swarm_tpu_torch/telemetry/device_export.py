"""Always-registered ``swarm_device_*`` staging/compaction families, the
port of ``swarm_tpu/telemetry/device_export.py``.

:meth:`~swarm_tpu_torch.ops.match.DeviceDB.dispatch` counts each batch
it stages to the card and, for a corpus with word tables, the
survivor-compacted phase B it launches; these are the scrape-time
surface, created at telemetry import time — not on first dispatch — so
every process's exposition carries the families with a rendered sample.
Left out, as nothing in the port would set them: the reference's
``swarm_device_donated_dispatches_total`` (XLA buffer donation) and its
lazily created compile families (``swarm_device_compile_*``,
``swarm_device_phase_ms``).
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: batches staged to the device (every dispatch stages exactly once)
STAGED_BATCHES = REGISTRY.counter(
    "swarm_device_staged_batches_total",
    "Batches staged to the device through the dispatch staging pool",
)
STAGED_BYTES = REGISTRY.counter(
    "swarm_device_staged_bytes_total",
    "Host bytes staged to the device (streams + lengths + status)",
)
#: dispatches through the survivor-compacted split-phase path (phase
#: A, the survivor read, phase B at the ladder width); a corpus with no
#: word tables has nothing to compact
COMPACTED_DISPATCHES = REGISTRY.counter(
    "swarm_device_compacted_dispatches_total",
    "Dispatches through the survivor-compacted split-phase kernel",
)
#: the most recent compacted batch's max per-row survivor count — what
#: the ladder rounded up to pick the phase-B width
SURVIVOR_MAX = REGISTRY.gauge(
    "swarm_device_survivor_max",
    "Max per-row prefilter survivors in the most recent compacted "
    "batch",
)
#: the most recent compacted batch's phase-B candidate width (ladder
#: rung); compare against the global candidate budget to see the
#: compaction win
VERIFY_K = REGISTRY.gauge(
    "swarm_device_verify_k",
    "Phase-B candidate width (survivor ladder rung) of the most "
    "recent compacted batch",
)
