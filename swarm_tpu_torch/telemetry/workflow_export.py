"""Always-registered ``swarm_workflow_*`` metric families, the port of
``swarm_tpu/telemetry/workflow_export.py``.

Device-plane workflow gating surfaces: how much of the workflow corpus
the compiler lowered onto the device, how often the vectorized
gate-apply stage ran, how the per-content step memo is performing, and
how often a row fell back to the host-loop reference twin. Created at
telemetry import time — not on first runner construction — so every
process's exposition carries the families with a rendered sample. The
step memo's hits are labelled by level: the runner's ``l1``, and the
fleet result tier's ``"w"`` family (``shared``).
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

#: workflow steps the compiler lowered into device gate planes for the
#: live corpus (plan ``steps_compiled``; host-only workflows excluded)
WORKFLOW_STEPS_COMPILED = REGISTRY.gauge(
    "swarm_workflow_steps_compiled",
    "Workflow steps lowered into device gate planes (live corpus)",
)
#: batches whose verdict tail ran the vectorized gate-apply stage and
#: shipped per-row workflow planes back to the host
WORKFLOW_GATE_PLANE_BATCHES = REGISTRY.counter(
    "swarm_workflow_gate_plane_batches_total",
    "Match batches decoded through device workflow gate planes",
)
#: per-content workflow gating results served without evaluation, by
#: memo tier (l1 = runner-local dict, shared = tier family "w")
WORKFLOW_STEP_MEMO_HITS = REGISTRY.counter(
    "swarm_workflow_step_memo_hits_total",
    "Workflow gating results served from the step memo",
    ("tier",),
)
WORKFLOW_STEP_MEMO_MISSES = REGISTRY.counter(
    "swarm_workflow_step_memo_misses_total",
    "Workflow gating lookups the step memo could not serve",
)
#: rows gated by the host-loop reference twin instead of device planes
#: (host-only workflows, plane-less rows, or the twin flag)
WORKFLOW_HOST_TWIN_FALLBACKS = REGISTRY.counter(
    "swarm_workflow_host_twin_fallbacks_total",
    "Workflow rows gated by the host-loop twin instead of device planes",
)
# pre-seed both tier labels so the family always renders samples (a
# labeled family with no observed combos renders no lines, which would
# read as "family missing" to the exposition check)
for _tier in ("l1", "shared"):
    WORKFLOW_STEP_MEMO_HITS.labels(tier=_tier).inc(0)
del _tier
