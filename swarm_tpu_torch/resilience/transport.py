"""Retrying transport: typed errors, backoff, per-operation breakers —
the port of ``swarm_tpu/resilience/transport.py``.

:class:`TransportError` tells a dead server from an idle queue: the
worker's ``ServerClient`` raises it on connection failures and 5xx
answers, while "no job" stays a clean ``None``.

:class:`RetryingServerClient` wraps any object with the
``ServerClient`` surface: every operation retries with jittered
exponential backoff and is guarded by its own circuit breaker (per
operation, so a dead ``renew-lease`` path cannot starve ``get-job``
polls). The jitter RNG is seeded per client, so retry schedules are
reproducible under the fault harness.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from swarm_tpu_torch.resilience.breaker import BreakerBoard
from swarm_tpu_torch.telemetry import REGISTRY

_RETRIES = REGISTRY.counter(
    "swarm_resilience_transport_retries_total",
    "Transport operations retried after a TransportError",
    ("op",),
)
_FAILURES = REGISTRY.counter(
    "swarm_resilience_transport_failures_total",
    "Transport operations that exhausted retries (or hit an open breaker)",
    ("op",),
)


class TransportError(RuntimeError):
    """Server unreachable or server-side failure (connection error or
    5xx) — NOT "no job available" or a 4xx contract rejection."""


class CircuitOpenError(TransportError):
    """Fast fail: the operation's circuit breaker is open."""


class RetryingServerClient:
    """Backoff and breaker facade over a ``ServerClient``-shaped inner
    transport. Only :class:`TransportError` is retried — typed 4xx
    outcomes (``None`` / ``False``) pass straight through."""

    #: operations this facade proxies with retry protection
    OPS = (
        "get_job",
        "update_job",
        "get_input_chunk",
        "put_output_chunk",
        "renew_lease",
        "deregister",
    )

    def __init__(
        self,
        inner,
        retries: int = 3,
        backoff_s: float = 0.2,
        backoff_max_s: float = 5.0,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 10.0,
        seed: int = 0,
        sleep=time.sleep,
    ):
        self.inner = inner
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.breakers = BreakerBoard(
            "transport",
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
        )
        self._rng = random.Random(seed)  # guarded-by: _rng_lock
        self._rng_lock = threading.Lock()
        self._sleep = sleep

    def _delay(self, attempt: int) -> float:
        base = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        with self._rng_lock:
            return base * (0.5 + self._rng.random())  # 0.5x..1.5x jitter

    def _call(self, op: str, *args, **kw):
        breaker = self.breakers.get(op)
        if not breaker.allow():
            _FAILURES.labels(op=op).inc()
            raise CircuitOpenError(f"transport breaker open for {op}")
        fn = getattr(self.inner, op)
        attempt = 0
        while True:
            try:
                out = fn(*args, **kw)
            except TransportError:
                breaker.record_failure()
                if attempt >= self.retries or not breaker.allow():
                    _FAILURES.labels(op=op).inc()
                    raise
                _RETRIES.labels(op=op).inc()
                self._sleep(self._delay(attempt))
                attempt += 1
                continue
            breaker.record_success()
            return out

    def get_job(self, worker_id: str) -> Optional[dict]:
        return self._call("get_job", worker_id)

    def update_job(self, job_id, changes, worker_id=None) -> bool:
        return self._call("update_job", job_id, changes, worker_id=worker_id)

    def get_input_chunk(self, scan_id, chunk_index) -> Optional[bytes]:
        return self._call("get_input_chunk", scan_id, chunk_index)

    def put_output_chunk(self, scan_id, chunk_index, data) -> bool:
        return self._call("put_output_chunk", scan_id, chunk_index, data)

    def renew_lease(self, job_id, worker_id, **kw) -> bool:
        return self._call("renew_lease", job_id, worker_id, **kw)

    def deregister(self, worker_id) -> bool:
        return self._call("deregister", worker_id)

    def __getattr__(self, name):
        # other attributes (base, session, timeout, last_drain_reason,
        # ...) proxy through
        return getattr(self.inner, name)
