"""Deterministic fault-injection harness, the port of
``swarm_tpu/resilience/faults.py``.

Named fault points are threaded through the worker (transport,
executor, drain), the scheduler's submit loop and the device dispatch,
and driven by a seeded plan so every failure mode is reproducible:

    SWARM_FAULT_PLAN="transport.get_job:2,5;device.dispatch:1;executor.run/poison*:*"

Grammar (``;``-separated clauses)::

    clause       := 'seed=' INT | pattern ':' occurrences [':' action]
    pattern      := point-name [ '/' detail ]     (fnmatch wildcards ok)
    occurrences  := '*' | item (',' item)*
    item         := N | N '-' M | 'p' FLOAT       (1-based call index;
                                                   'p0.3' fires with
                                                   probability 0.3 from
                                                   the seeded RNG)
    action       := 'err' | 'err=' MESSAGE | 'sleep=' SECONDS

A clause counts only the calls it *matches* (pattern match against
``name`` or ``name/detail``), so ``transport.put_chunk:1-3`` means "the
first three uploads fail" regardless of unrelated traffic. ``sleep``
delays instead of raising — the lease-expiry lever.

When no plan is set, :func:`fault_point` is one global load and an
``is None`` test (the environment variable is read once, lazily). The
counts of a plan are :meth:`FaultPlan.snapshot`; each fired fault also
counts in ``swarm_resilience_faults_injected_total{point}``.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from typing import Optional

from swarm_tpu_torch.telemetry import REGISTRY

ENV_VAR = "SWARM_FAULT_PLAN"

_FAULTS_INJECTED = REGISTRY.counter(
    "swarm_resilience_faults_injected_total",
    "Faults fired by the injection harness, by fault point",
    ("point",),
)
_PLAN_ACTIVE = REGISTRY.gauge(
    "swarm_resilience_fault_plan_active",
    "1 while a fault-injection plan is installed in this process",
)


class FaultInjected(RuntimeError):
    """Default exception raised at a firing fault point."""


class _Clause:
    __slots__ = (
        "pattern", "always", "indices", "ranges", "prob", "action",
        "arg", "calls", "seen", "fired",
    )

    def __init__(self, pattern: str, occ: str, action: str):
        self.pattern = pattern
        self.always = occ == "*"
        self.indices: set[int] = set()
        self.ranges: list[tuple[int, int]] = []
        self.prob: Optional[float] = None
        if not self.always:
            for item in occ.split(","):
                item = item.strip()
                if not item:
                    continue
                if item.startswith("p"):
                    self.prob = float(item[1:])
                elif "-" in item:
                    a, b = item.split("-", 1)
                    self.ranges.append((int(a), int(b)))
                else:
                    self.indices.add(int(item))
        self.action, _, arg = action.partition("=")
        self.arg = arg
        self.calls = 0  # matching calls
        self.seen = 0   # eligible matching calls (occurrence index base)
        self.fired = 0

    def matches(self, name: str, detail: Optional[str]) -> bool:
        if self.pattern == name:
            return True
        full = f"{name}/{detail}" if detail is not None else name
        return fnmatch.fnmatchcase(full, self.pattern) or fnmatch.fnmatchcase(
            name, self.pattern
        )

    def should_fire(self, rng: random.Random, eligible: bool) -> bool:
        """Count this matching call; decide firing only when
        ``eligible`` (no earlier clause already fired for the same
        call). Occurrence indices count ELIGIBLE calls, so an earlier
        clause's fire never consumes a later clause's declared
        occurrence, and probabilistic clauses draw only on calls they
        could win. At most one clause fires per fault-point call."""
        self.calls += 1
        if not eligible:
            return False
        self.seen += 1
        if self.always:
            return True
        if self.seen in self.indices:
            return True
        if any(a <= self.seen <= b for a, b in self.ranges):
            return True
        if self.prob is not None and rng.random() < self.prob:
            return True
        return False


class FaultPlan:
    """A parsed, seeded fault plan. Thread-safe."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self._clauses: list[_Clause] = []
        self._lock = threading.Lock()  # guards: _rng, the clauses' counts
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                self.seed = int(raw[5:])
                continue
            parts = raw.split(":")
            if len(parts) == 1:
                pattern, occ, action = parts[0], "*", "err"
            elif len(parts) == 2:
                pattern, occ, action = parts[0], parts[1], "err"
            else:
                pattern, occ, action = parts[0], parts[1], ":".join(parts[2:])
            self._clauses.append(_Clause(pattern.strip(), occ.strip(), action.strip()))
        self._rng = random.Random(self.seed)

    def check(self, name: str, detail: Optional[str], exc: Optional[type]) -> None:
        """Evaluate one fault-point call; raises or sleeps when a clause
        fires."""
        fire: Optional[_Clause] = None
        with self._lock:
            for clause in self._clauses:
                if not clause.matches(name, detail):
                    continue
                if clause.should_fire(self._rng, eligible=fire is None):
                    clause.fired += 1
                    fire = clause
        if fire is None:
            return
        _FAULTS_INJECTED.labels(point=name).inc()
        # flight recorder (docs/OBSERVABILITY.md): every injected fault
        # dumps the last moments of process context. Memory-only +
        # daemon-thread sinks, so safe here outside self._lock and
        # cheap enough for chaos soaks.
        from swarm_tpu_torch.telemetry import tracing

        tracing.flight_dump("fault", detail=name)
        if fire.action == "sleep":
            time.sleep(float(fire.arg or "0"))
            return
        msg = fire.arg or (
            f"injected fault at {name}"
            + (f"/{detail}" if detail is not None else "")
        )
        raise (exc or FaultInjected)(msg)

    def snapshot(self) -> dict:
        """Per-clause counts (matched calls, fired) for assertions."""
        with self._lock:
            return {
                c.pattern: {"calls": c.calls, "fired": c.fired}
                for c in self._clauses
            }


# Process-wide plan state. ``_UNSET`` means "environment not read yet":
# the first fault_point call resolves SWARM_FAULT_PLAN exactly once,
# after which the unset fast path is one global load and ``is None``.
_UNSET = object()
# written under _state_lock; fault_point() and active_plan() read it
# without the lock by design (a stale read costs one extra _resolve_env
# round, never a wrong verdict)
_active = _UNSET
_state_lock = threading.Lock()


def install_plan(spec: str) -> FaultPlan:
    """Parse and activate a fault plan for this process."""
    global _active
    plan = FaultPlan(spec)
    with _state_lock:
        _active = plan
    _PLAN_ACTIVE.set(1)
    return plan


def clear_plan() -> None:
    """Deactivate fault injection (fault points become no-ops)."""
    global _active
    with _state_lock:
        _active = None
    _PLAN_ACTIVE.set(0)


def active_plan() -> Optional[FaultPlan]:
    plan = _active
    if plan is _UNSET:
        plan = _resolve_env()
    _PLAN_ACTIVE.set(1 if plan is not None else 0)
    return plan


def _resolve_env() -> Optional[FaultPlan]:
    global _active
    with _state_lock:
        if _active is not _UNSET:  # raced with install/clear
            return _active
        spec = os.environ.get(ENV_VAR, "").strip()
        _active = FaultPlan(spec) if spec else None
    if _active is not None:
        _PLAN_ACTIVE.set(1)
    return _active


def fault_point(
    name: str, detail: Optional[str] = None, exc: Optional[type] = None
) -> None:
    """Declare a named fault point. A no-op (one global load and an
    ``is None`` test) unless a plan is installed; a firing clause raises
    ``exc`` (default :class:`FaultInjected`) or sleeps."""
    plan = _active
    if plan is None:
        return
    if plan is _UNSET:
        plan = _resolve_env()
        if plan is None:
            return
    plan.check(name, detail, exc)
