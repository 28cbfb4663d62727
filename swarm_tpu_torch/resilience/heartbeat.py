"""Lease heartbeats: background renewal while a chunk executes, the
port of ``swarm_tpu/resilience/heartbeat.py``.

The server requeues an in-progress job whose lease lapsed. A long chunk
could outlive its lease and run twice; the heartbeat renews the lease
from a daemon thread (``POST /renew-lease/<job_id>``) for as long as
the chunk runs, and stops when the chunk ends — or when the server says
the lease is no longer ours (a renewal of a requeued or re-leased job
is refused; running on is wasted work the fencing token will discard).
"""

from __future__ import annotations

import threading
from typing import Optional

from swarm_tpu_torch.telemetry import REGISTRY

_RENEWALS = REGISTRY.counter(
    "swarm_resilience_lease_renewals_total",
    "Lease-heartbeat renewal attempts",
    ("outcome",),
)


class LeaseHeartbeat:
    """Context manager: renew ``job_id``'s lease every ``interval_s``
    until exit (or until the server refuses a renewal)."""

    def __init__(
        self,
        client,
        job_id: str,
        worker_id: str,
        interval_s: float,
        saturation_fn=None,
    ):
        self.client = client
        self.job_id = job_id
        self.worker_id = worker_id
        self.interval_s = max(0.05, float(interval_s))
        #: optional 0..1 in-flight saturation provider: when set (and
        #: returning a value), each renewal carries it. None keeps the
        #: plain wire shape, so clients without the keyword still work.
        self.saturation_fn = saturation_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: False once the server refused a renewal: the lease is no
        #: longer ours (expired and re-leased, or the job went terminal)
        self.lease_ok = True
        self.renewals = 0
        #: renewals that raised (server unreachable): the ticker goes on
        self.errors = 0

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            kw = {}
            if self.saturation_fn is not None:
                try:
                    saturation = self.saturation_fn()
                except Exception:
                    saturation = None
                if saturation is not None:
                    kw["saturation"] = saturation
            try:
                ok = self.client.renew_lease(self.job_id, self.worker_id, **kw)
            except Exception:
                # server unreachable: keep ticking — the lease may still
                # be live on the server, and the next tick may land
                self.errors += 1
                _RENEWALS.labels(outcome="error").inc()
                continue
            if ok:
                self.renewals += 1
                _RENEWALS.labels(outcome="renewed").inc()
            else:
                self.lease_ok = False
                _RENEWALS.labels(outcome="rejected").inc()
                return  # not ours anymore; stop renewing

    def start(self) -> "LeaseHeartbeat":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run,
                name=f"lease-hb-{self.job_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "LeaseHeartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
