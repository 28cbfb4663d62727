"""The worker's resilience layer, the port of ``swarm_tpu/resilience``.

Five cooperating pieces, each testable on the CPU through the
deterministic fault harness:

- :mod:`~swarm_tpu_torch.resilience.faults` — named fault points in the
  worker, the scheduler and the device dispatch, driven by a seeded
  plan (``SWARM_FAULT_PLAN``); no-ops when unset;
- :mod:`~swarm_tpu_torch.resilience.breaker` — circuit breakers on a
  process-wide board;
- :mod:`~swarm_tpu_torch.resilience.transport` — the typed
  :class:`TransportError` and :class:`RetryingServerClient` (jittered
  exponential backoff, per-operation breakers);
- :mod:`~swarm_tpu_torch.resilience.spool` — a disk spool of completed
  output chunks: an unreachable server never loses finished work, and
  a replay is idempotent through the queue's fencing token;
- :mod:`~swarm_tpu_torch.resilience.heartbeat` — background lease
  renewal, so a long chunk keeps its lease.

Each piece reports through the reference's ``swarm_resilience_*``
families on the port's registry (``telemetry/``) and keeps its counts
on the object too (``FaultPlan.snapshot()``, a breaker's ``state``,
``LeaseHeartbeat.renewals``, ``OutputSpool.replayed``).
"""

from swarm_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    CircuitBreaker,
    breaker_states,
    reset_board,
)
from swarm_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjected,
    FaultPlan,
    active_plan,
    clear_plan,
    fault_point,
    install_plan,
)
from swarm_tpu_torch.resilience.heartbeat import LeaseHeartbeat  # noqa: F401
from swarm_tpu_torch.resilience.spool import OutputSpool  # noqa: F401
from swarm_tpu_torch.resilience.transport import (  # noqa: F401
    CircuitOpenError,
    RetryingServerClient,
    TransportError,
)
