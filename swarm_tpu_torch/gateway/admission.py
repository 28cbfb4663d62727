"""Tenant model + admission control (docs/GATEWAY.md).

The port's copy of ``swarm_tpu/gateway/admission.py``: its classes are
the reference's, line for line (``tests/test_torch_gateway.py``). The
``gateway_*`` config fields are read through ``getattr`` with the
reference's defaults; the port's server slice adds them to its config.

One global FIFO in front of the fleet means one abusive tenant starves
every other scan and overload turns into unbounded queue growth. The
gateway replaces that front door with three deterministic mechanisms:

- **Per-tenant token buckets** — ``gateway_tenant_rate`` submissions/s
  with ``gateway_tenant_burst`` burst capacity (0 rate = unlimited, the
  default, so single-operator deployments are unchanged).
- **Bounded per-tenant queues** — a tenant whose waiting-job depth
  reaches ``gateway_tenant_queue_max`` is shed, not buffered (0 =
  unbounded default).
- **Composite pressure load shed** — admission consults one
  :class:`PressureSnapshot` (queue depth by state, worker-reported
  scheduler in-flight saturation, open breaker count) folded into a
  single scalar; at/over ``gateway_shed_pressure`` every non-empty
  submission sheds with ``429 + Retry-After``. Shed, never block: the
  client owns the retry schedule. Per-class overrides
  (``gateway_shed_pressure_bulk`` / ``_interactive``, 0 = use the
  global knob) let bulk shed first so interactive latency survives a
  pressure ramp.

Every decision is a PURE function of ``(tenant state, snapshot, now)``
— :meth:`AdmissionController.decide` takes both explicitly so tests
can replay any overload scenario byte-for-byte.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

from swarm_tpu_torch.telemetry.gateway_export import (
    GATEWAY_ADMITTED,
    GATEWAY_PRESSURE,
    GATEWAY_SHED,
)

DEFAULT_TENANT = "default"


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/s refill up to
    ``burst`` capacity; ``take(now)`` consumes one token or reports the
    seconds until one is available. Time is an explicit argument — the
    bucket holds no clock, so decisions replay exactly."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._stamp: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._stamp is not None and now > self._stamp:
            self._tokens = min(
                float(self.burst), self._tokens + (now - self._stamp) * self.rate
            )
        self._stamp = now if self._stamp is None else max(self._stamp, now)

    def take(self, now: float) -> tuple[bool, float]:
        """``(True, 0.0)`` and one token consumed, or ``(False,
        retry_after_s)`` — the exact wait until the next whole token."""
        if self.rate <= 0:
            return True, 0.0  # unlimited
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        return self._tokens


@dataclasses.dataclass(frozen=True)
class PressureSnapshot:
    """One observation of the serving tier's load, the sole input of
    the shed decision (beyond the tenant's own bucket/queue state)."""

    #: jobs waiting in dispatch queues, all tenants (queued state)
    queue_depth: int = 0
    #: jobs currently leased out (any ACTIVE status)
    active_jobs: int = 0
    #: worker-reported scheduler in-flight saturation, 0..1 (the
    #: fraction of wall time the submit thread stalled on a full
    #: in-flight window — see worker heartbeat/perf plumbing)
    saturation: float = 0.0
    #: process-wide circuit breakers not in the closed state
    open_breakers: int = 0


@dataclasses.dataclass(frozen=True)
class Decision:
    admitted: bool
    reason: str = "ok"  # "ok" | "rate" | "queue_full" | "pressure"
    retry_after_s: float = 0.0
    pressure: float = 0.0


class AdmissionController:
    """Per-tenant admission state + the deterministic decision rule.

    Thread contract: ``decide``/``note_saturation``/``snapshot`` are
    called from server request threads; all mutable state sits under
    ``_lock``."""

    def __init__(
        self,
        tenant_rate: float = 0.0,
        tenant_burst: int = 64,
        tenant_queue_max: int = 0,
        queue_high: int = 0,
        shed_pressure: float = 1.0,
        retry_after_s: float = 1.0,
        breaker_pressure: float = 0.5,
        max_tenants: int = 1024,
        saturation_ttl_s: float = 60.0,
        tenant_ttl_s: float = 3600.0,
        shed_pressure_bulk: float = 0.0,
        shed_pressure_interactive: float = 0.0,
    ):
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = int(tenant_burst)
        self.tenant_queue_max = int(tenant_queue_max)
        self.queue_high = int(queue_high)
        self.shed_pressure = float(shed_pressure)
        # per-class shed thresholds (docs/GATEWAY.md §QoS): bulk sheds
        # at a LOWER pressure than interactive so background work makes
        # room before foreground work feels anything. 0 = fall back to
        # the single shed_pressure knob — the pre-QoS wire behavior.
        self.shed_pressure_bulk = float(shed_pressure_bulk)
        self.shed_pressure_interactive = float(shed_pressure_interactive)
        self.retry_after_s = float(retry_after_s)
        self.breaker_pressure = float(breaker_pressure)
        # tenant-id cardinality bound: tenant names are CLIENT data, so
        # without a cap a flooder rotating fresh ids would mint a fresh
        # full token bucket per request (defeating the rate limit) and
        # grow per-tenant state without bound. A NEW tenant past the
        # cap sheds with reason "tenant_limit".
        self.max_tenants = max(1, int(max_tenants))
        # a worker's saturation report decays after this long: a dead
        # or idle worker's last report must not pin fleet pressure
        # (heartbeats only tick while a chunk runs, so nothing would
        # ever overwrite it)
        self.saturation_ttl_s = float(saturation_ttl_s)
        # registry slots free again after this much tenant INACTIVITY:
        # without expiry, one rotation flood would fill the cap and
        # lock out every genuinely new tenant until restart; with it,
        # a flooder's dead ids age out while the lockout worst case
        # for a new tenant is bounded by one TTL. A rotation attack
        # regains fresh buckets only at slots/TTL — a bounded trickle.
        self.tenant_ttl_s = float(tenant_ttl_s)
        self._lock = threading.Lock()  # guards: _buckets, _counts (reads), _saturation, _last_seen
        self._buckets: dict[str, TokenBucket] = {}
        # tenant -> {"admitted": n, "shed": n, "shed_rate": n, ...}
        self._counts: dict[str, dict[str, int]] = {}
        # tenant -> last decide() stamp (the idle-expiry clock)
        self._last_seen: dict[str, float] = {}
        # worker id -> (last reported in-flight saturation 0..1,
        # monotonic stamp); the snapshot folds live entries with max()
        # so one saturated worker is visible even in a mixed fleet
        self._saturation: dict[str, tuple[float, float]] = {}

    @classmethod
    def from_config(cls, cfg) -> "AdmissionController":
        return cls(
            tenant_rate=getattr(cfg, "gateway_tenant_rate", 0.0),
            tenant_burst=getattr(cfg, "gateway_tenant_burst", 64),
            tenant_queue_max=getattr(cfg, "gateway_tenant_queue_max", 0),
            queue_high=getattr(cfg, "gateway_queue_high", 0),
            shed_pressure=getattr(cfg, "gateway_shed_pressure", 1.0),
            retry_after_s=getattr(cfg, "gateway_retry_after_s", 1.0),
            max_tenants=getattr(cfg, "gateway_max_tenants", 1024),
            saturation_ttl_s=getattr(cfg, "gateway_saturation_ttl_s", 60.0),
            tenant_ttl_s=getattr(cfg, "gateway_tenant_ttl_s", 3600.0),
            shed_pressure_bulk=getattr(cfg, "gateway_shed_pressure_bulk", 0.0),
            shed_pressure_interactive=getattr(
                cfg, "gateway_shed_pressure_interactive", 0.0
            ),
        )

    def shed_threshold(self, qos: Optional[str]) -> float:
        """The pressure at/over which this QoS class sheds. The
        per-class knobs default to 0 = "use the global threshold", so
        deployments that never set them keep the single-knob rule."""
        if qos == "bulk" and self.shed_pressure_bulk > 0:
            return self.shed_pressure_bulk
        if qos == "interactive" and self.shed_pressure_interactive > 0:
            return self.shed_pressure_interactive
        return self.shed_pressure

    # ------------------------------------------------------------------
    def pressure(self, snap: PressureSnapshot) -> float:
        """Fold one snapshot into the composite scalar. max() of the
        component signals, each normalized so 1.0 means "shed" under
        the default threshold: queue depth against ``queue_high`` (0
        disables the component), reported in-flight saturation as-is,
        and any open breaker contributing a fixed ``breaker_pressure``
        floor (degraded, not yet shedding on its own)."""
        parts = [0.0]
        if self.queue_high > 0:
            parts.append(snap.queue_depth / float(self.queue_high))
        parts.append(min(1.0, max(0.0, float(snap.saturation))))
        if snap.open_breakers > 0:
            parts.append(self.breaker_pressure)
        return max(parts)

    def note_saturation(self, worker_id: str, value, now=None) -> None:
        """Record one worker's reported in-flight saturation (from the
        lease-heartbeat body or a completed job's perf fields)."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            return
        import time

        stamp = time.monotonic() if now is None else float(now)
        with self._lock:
            self._saturation[worker_id] = (min(1.0, max(0.0, v)), stamp)

    def drop_saturation(self, worker_id: str) -> None:
        """Forget a worker's saturation report NOW. A deregistered or
        preempted worker is gone — waiting out ``saturation_ttl_s``
        would let its final (often maximal: it was draining under
        load) report pin fleet pressure for up to a minute after the
        node died."""
        with self._lock:
            self._saturation.pop(worker_id, None)

    def fleet_saturation(self, now=None) -> float:
        """max() over reports younger than ``saturation_ttl_s`` —
        stale ones are dropped (a dead worker's last word must not
        shed traffic on an idle fleet forever)."""
        import time

        cutoff = (time.monotonic() if now is None else float(now))
        cutoff -= self.saturation_ttl_s
        with self._lock:
            for worker_id in [
                w for w, (_v, ts) in self._saturation.items() if ts < cutoff
            ]:
                del self._saturation[worker_id]
            return max(
                (v for v, _ts in self._saturation.values()), default=0.0
            )

    # ------------------------------------------------------------------
    def decide(
        self,
        tenant: str,
        snap: PressureSnapshot,
        now: float,
        tenant_depth: int = 0,
        qos: Optional[str] = None,
    ) -> Decision:
        """Admit or shed one submission for ``tenant``. Deterministic
        given ``(snapshot, now, tenant_depth, qos)`` and the tenant's
        bucket fill; counters and gauges update as a side effect."""
        pressure = self.pressure(snap)
        shed_at = self.shed_threshold(qos)
        GATEWAY_PRESSURE.labels().set(pressure)
        with self._lock:
            if tenant not in self._counts and tenant != DEFAULT_TENANT:
                # the default tenant is the reference wire contract —
                # it can NEVER be locked out by the cardinality cap
                if len(self._counts) >= self.max_tenants:
                    # slots free again after tenant_ttl_s of
                    # inactivity, so a past rotation flood doesn't
                    # deny new tenants forever
                    cutoff = now - self.tenant_ttl_s
                    for stale in [
                        t for t, seen in self._last_seen.items()
                        if seen < cutoff and t != DEFAULT_TENANT
                    ]:
                        self._counts.pop(stale, None)
                        self._buckets.pop(stale, None)
                        self._last_seen.pop(stale, None)
                if len(self._counts) >= self.max_tenants:
                    # tenant-rotation defense: a flooder minting fresh
                    # ids must not get a fresh token bucket per
                    # request, and per-tenant state must stay bounded.
                    # Counted against the shared "default" row so the
                    # metric label space stays bounded too.
                    GATEWAY_SHED.labels(
                        tenant=DEFAULT_TENANT, reason="tenant_limit"
                    ).inc()
                    return Decision(
                        False, "tenant_limit", self.retry_after_s, pressure
                    )
            self._last_seen[tenant] = now
            counts = self._counts.setdefault(
                tenant, {"admitted": 0, "shed": 0}
            )
            if pressure >= shed_at:
                decision = Decision(
                    False, "pressure", self.retry_after_s, pressure
                )
            elif (
                self.tenant_queue_max > 0
                and tenant_depth >= self.tenant_queue_max
            ):
                decision = Decision(
                    False, "queue_full", self.retry_after_s, pressure
                )
            else:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = TokenBucket(
                        self.tenant_rate, self.tenant_burst
                    )
                ok, wait = bucket.take(now)
                if ok:
                    decision = Decision(True, "ok", 0.0, pressure)
                else:
                    decision = Decision(False, "rate", wait, pressure)
            if decision.admitted:
                counts["admitted"] += 1
            else:
                counts["shed"] += 1
                counts[f"shed_{decision.reason}"] = (
                    counts.get(f"shed_{decision.reason}", 0) + 1
                )
        if decision.admitted:
            GATEWAY_ADMITTED.labels(tenant=tenant).inc()
        else:
            GATEWAY_SHED.labels(tenant=tenant, reason=decision.reason).inc()
        return decision

    def snapshot(self) -> dict:
        """Per-tenant admitted/shed counters (the /tenants surface)."""
        with self._lock:
            return {t: dict(c) for t, c in self._counts.items()}
