"""Circuit breakers with a process-wide board, the port of
``swarm_tpu/resilience/breaker.py``.

Closed → (``threshold`` consecutive failures) → open → (``cooldown_s``
elapses) → half-open: exactly one probe call is allowed through; its
outcome closes or re-opens the breaker. Breakers register on a global
board, so :func:`breaker_states` shows every breaker of the process;
state changes also drive the ``swarm_resilience_breaker_open`` gauge
and the transitions counter.
"""

from __future__ import annotations

import threading
import time
import weakref

from swarm_tpu_torch.telemetry import REGISTRY

_BOARD_LOCK = threading.Lock()  # guards: _BOARD
# name → live instances: several objects may share a name (two workers'
# transport boards, two engines with the same batch shape), and the
# board must not let the last registration hide an open earlier one.
# A WeakSet, so the board never extends a breaker's lifetime.
_BOARD: dict[str, "weakref.WeakSet[CircuitBreaker]"] = {}

#: severity order for same-named aggregation (worst state wins)
_SEVERITY = {"closed": 0, "half-open": 1, "open": 2}

_BREAKER_OPEN = REGISTRY.gauge(
    "swarm_resilience_breaker_open",
    "1 while the named circuit breaker is open (0 closed/half-open)",
    ("name",),
)
_BREAKER_TRANSITIONS = REGISTRY.counter(
    "swarm_resilience_breaker_transitions_total",
    "Circuit-breaker state transitions",
    ("name", "state"),
)


def breaker_states(prefix: str = "") -> dict[str, str]:
    """Name → state of every registered breaker in this process.
    Same-named instances aggregate to the worst state, so one open
    breaker cannot hide behind a later-registered closed twin."""
    with _BOARD_LOCK:
        items = [(name, list(refs)) for name, refs in _BOARD.items()]
    out: dict[str, str] = {}
    for name, brs in items:
        if not name.startswith(prefix) or not brs:
            continue
        out[name] = max((br.state for br in brs), key=_SEVERITY.__getitem__)
    return out


def reset_board() -> None:
    """Drop all registered breakers (test isolation)."""
    with _BOARD_LOCK:
        _BOARD.clear()


class CircuitBreaker:
    """One named breaker. ``allow()`` gates the protected call;
    ``record_success``/``record_failure`` report its outcome."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(
        self,
        name: str,
        threshold: int = 5,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.name = name
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()  # guards: _failures, _state, _opened_at, _probe_out
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probe_out = False  # half-open: one probe in flight
        with _BOARD_LOCK:
            _BOARD.setdefault(name, weakref.WeakSet()).add(self)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:  # requires-lock: _lock
        if (
            self._state == self.OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._transition(self.HALF_OPEN)
            self._probe_out = False

    def _transition(self, state: str) -> None:  # requires-lock: _lock
        """Every change of state goes through here."""
        if state == self._state:
            return
        self._state = state
        _BREAKER_OPEN.labels(name=self.name).set(1 if state == self.OPEN else 0)
        _BREAKER_TRANSITIONS.labels(name=self.name, state=state).inc()
        if state == self.OPEN:
            # flight recorder (docs/OBSERVABILITY.md): a breaker opening
            # is a post-mortem moment — dump the recent span/event ring.
            # FlightRecorder.dump is memory-only (sinks run on a daemon
            # thread), so it is safe under self._lock.
            from swarm_tpu_torch.telemetry import tracing

            tracing.flight_dump("breaker_open", detail=self.name)

    def allow(self) -> bool:
        """Whether the protected call may proceed right now. In
        half-open state exactly one caller gets True (the probe)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_out = False
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_out = False
            if self._state == self.HALF_OPEN or self._failures >= self.threshold:
                self._opened_at = self._clock()
                self._transition(self.OPEN)

    def reset(self) -> None:
        """Force-close and forget the failure streak: the failing peer
        is known to have been replaced (a worker that sees the server's
        generation change closes its transport breakers)."""
        with self._lock:
            self._failures = 0
            self._probe_out = False
            self._transition(self.CLOSED)


class BreakerBoard:
    """Lazily-created breakers sharing one config, keyed by name
    suffix: the per-operation transport breakers and the engine's
    per-shape-class device breakers."""

    def __init__(self, prefix: str, threshold: int = 5, cooldown_s: float = 30.0):
        self.prefix = prefix
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()  # guards: _breakers
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    f"{self.prefix}.{key}",
                    threshold=self.threshold,
                    cooldown_s=self.cooldown_s,
                )
            return br

    def states(self) -> dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {k: br.state for k, br in items}

    def any_open(self) -> bool:
        return any(s != CircuitBreaker.CLOSED for s in self.states().values())

    def reset_all(self) -> None:
        """Force-close every breaker on this board (see
        :meth:`CircuitBreaker.reset`)."""
        with self._lock:
            breakers = list(self._breakers.values())
        for br in breakers:
            br.reset()
