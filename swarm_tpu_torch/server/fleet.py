"""Elastic worker-fleet orchestration behind a provider interface —
the port's copy of ``swarm_tpu/server/fleet.py``.

DigitalOcean droplet create/delete with a 250-req/min thread limiter
and idle auto-teardown sit behind ``FleetProvider``:

- ``NullProvider`` — no-op (GPU hosts are typically statically
  provisioned; elastic scale means releasing queued shards, not
  hardware).
- ``ProcessProvider`` — spawns/kills local ``swarm_tpu_torch.worker``
  *processes*; the embedded single-host analog of a droplet fleet and
  what tests use. A spawned worker runs on the card unless
  ``extra_args`` asks for the CPU (``["--device", "cpu"]``).
- ``DigitalOceanProvider`` — wire-equivalent of the reference: same
  API endpoints, name-prefix selection, cloud-init user_data boot.

All providers share the token-bucket rate limiter and run create/delete
in background threads like the reference's ``/spin-up`` handler.
"""

from __future__ import annotations

import math
import os
import random
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from swarm_tpu_torch.telemetry.fleet_export import (
    FLEET_COLDSTART,
    FLEET_FORECAST,
    FLEET_NODES,
    FLEET_PREEMPTIONS,
    FLEET_SCALE_EVENTS,
    FLEET_TARGET,
)


class RateLimiter:
    """Token bucket: at most ``per_minute`` acquisitions per rolling minute."""

    def __init__(self, per_minute: int):
        self.per_minute = max(1, per_minute)
        self._lock = threading.Lock()  # guards: _stamps (reads)
        self._stamps: list[float] = []

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = time.time()
                self._stamps = [s for s in self._stamps if now - s < 60.0]
                if len(self._stamps) < self.per_minute:
                    self._stamps.append(now)
                    return
                sleep_for = 60.0 - (now - self._stamps[0])
            time.sleep(max(0.05, sleep_for))


def generate_node_names(prefix: str, nodes: int) -> list[str]:
    """``prefix1..prefixN``."""
    return [f"{prefix}{i}" for i in range(1, nodes + 1)]


class FleetProvider:
    def spin_up(self, prefix: str, nodes: int) -> None:
        raise NotImplementedError

    def spin_down(self, prefix: str) -> None:
        raise NotImplementedError

    def list_nodes(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def teardown_async(self, prefix: str) -> None:
        t = threading.Thread(target=self.spin_down, args=(prefix,), daemon=True)
        t.start()


class NullProvider(FleetProvider):
    def spin_up(self, prefix, nodes):
        pass

    def spin_down(self, prefix):
        pass

    def list_nodes(self, prefix):
        return []


class ProcessProvider(FleetProvider):
    """Local worker processes as fleet nodes (embedded / test provider)."""

    def __init__(self, cfg, extra_args: Optional[list[str]] = None):
        self.cfg = cfg
        self.extra_args = extra_args or []
        self._lock = threading.Lock()  # guards: _procs (reads)
        self._procs: dict[str, subprocess.Popen] = {}

    def spin_up(self, prefix, nodes):
        for name in generate_node_names(prefix, nodes):
            with self._lock:
                if name in self._procs and self._procs[name].poll() is None:
                    continue
                cmd = [
                    sys.executable,
                    "-m",
                    "swarm_tpu_torch.worker",
                    "--server-url",
                    self.cfg.resolve_url(),
                    "--api-key",
                    self.cfg.api_key,
                    "--worker-id",
                    name,
                ] + self.extra_args
                self._procs[name] = subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
                )

    def spin_down(self, prefix):
        with self._lock:
            for name, proc in list(self._procs.items()):
                if name.startswith(prefix) and proc.poll() is None:
                    proc.terminate()
                    self._procs.pop(name, None)

    def list_nodes(self, prefix):
        with self._lock:
            return [
                n
                for n, p in self._procs.items()
                if n.startswith(prefix) and p.poll() is None
            ]

    def shutdown(self):
        self.spin_down("")


class DigitalOceanProvider(FleetProvider):
    """Droplet cloud provider (requires network egress)."""

    API = "https://api.digitalocean.com/v2"

    def __init__(self, cfg, worker_image: str = "pry0cc/axiom-worker"):
        import requests  # stdlib-adjacent; baked in

        self._requests = requests
        self.cfg = cfg
        self.worker_image = worker_image
        self.limiter = RateLimiter(cfg.fleet_rate_limit_per_min)

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.cfg.fleet_api_token}"}

    def _user_data(self, name: str) -> str:
        env = (
            f"-e SERVER_URL={self.cfg.resolve_url()} -e API_KEY={self.cfg.api_key} "
            f"-e WORKER_ID={name}"
        )
        return f"#cloud-config\nruncmd:\n  - \"docker run -d {env} {self.worker_image}\"\n"

    def _create_one(self, name: str) -> None:
        self.limiter.acquire()
        self._requests.post(
            f"{self.API}/droplets",
            headers=self._headers(),
            json={
                "name": name,
                "region": self.cfg.fleet_region,
                "size": self.cfg.fleet_size,
                "image": self.cfg.fleet_image,
                "user_data": self._user_data(name),
            },
            timeout=30,
        )

    def _delete_one(self, droplet_id: int) -> None:
        self.limiter.acquire()
        self._requests.delete(
            f"{self.API}/droplets/{droplet_id}", headers=self._headers(), timeout=30
        )

    def _droplets(self, prefix: str) -> list[dict]:
        resp = self._requests.get(
            f"{self.API}/droplets?per_page=200", headers=self._headers(), timeout=30
        )
        if resp.status_code != 200:
            return []
        return [
            d
            for d in resp.json().get("droplets", [])
            if d.get("name", "").startswith(prefix)
        ]

    def spin_up(self, prefix, nodes):
        # ensure-up like ProcessProvider: DO allows duplicate droplet
        # names, so re-creating a live name would double-bill and
        # corrupt list_nodes/scale-down arithmetic — skip names that
        # already exist (one listing call per spin_up)
        live = set(self.list_nodes(prefix))
        threads = [
            threading.Thread(target=self._create_one, args=(n,), daemon=True)
            for n in generate_node_names(prefix, nodes)
            if n not in live
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def spin_down(self, prefix):
        droplets = self._droplets(prefix)
        threads = [
            threading.Thread(target=self._delete_one, args=(d["id"],), daemon=True)
            for d in droplets
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def list_nodes(self, prefix):
        return [d["name"] for d in self._droplets(prefix)]


class InflowForecaster:
    """EWMA job-inflow forecaster over the per-tenant admission history.

    The gateway reports every admitted submission's chunk count
    (:meth:`record`); the forecaster folds them into fixed windows and
    keeps one EWMA jobs/second rate per tenant. :meth:`rate` folds any
    elapsed empty windows first, so a tenant that went quiet decays
    toward zero instead of pinning its last spike forever — that decay
    is what lets scale-to-zero park an idle fleet. Deterministic under
    an injected clock (tests/bench pass ``now`` explicitly).
    """

    def __init__(
        self,
        alpha: float = 0.3,
        window_s: float = 1.0,
        clock=time.monotonic,
    ):
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.window_s = max(0.05, float(window_s))
        self._clock = clock
        self._lock = threading.Lock()  # guards: _rates, _buckets (reads)
        #: tenant -> EWMA jobs/s
        self._rates: dict[str, float] = {}
        #: tenant -> [window_start, jobs_in_window]
        self._buckets: dict[str, list] = {}

    # requires-lock: _lock (record/rate fold under the forecaster lock)
    def _fold_locked(self, tenant: str, now: float) -> None:
        bucket = self._buckets.get(tenant)
        if bucket is None:
            return
        start, count = bucket
        elapsed = now - start
        if elapsed < self.window_s:
            return
        rate = self._rates.get(tenant, 0.0)
        # the closed window's observed rate, then one zero-window blend
        # per fully elapsed empty window since — bounded so a long
        # quiet gap costs O(1), not O(gap)
        rate = rate + self.alpha * (count / self.window_s - rate)
        idle_windows = min(64, int(elapsed / self.window_s) - 1)
        for _ in range(idle_windows):
            rate += self.alpha * (0.0 - rate)
        if rate < 1e-6:
            rate = 0.0
        self._rates[tenant] = rate
        self._buckets[tenant] = [now, 0]

    def record(self, jobs: int, tenant: str = "default", now=None) -> None:
        """Fold ``jobs`` admitted chunks into the tenant's window."""
        now = self._clock() if now is None else now
        with self._lock:
            self._fold_locked(tenant, now)
            bucket = self._buckets.setdefault(tenant, [now, 0])
            bucket[1] += int(jobs)

    def rate(self, tenant: Optional[str] = None, now=None) -> float:
        """EWMA jobs/s — one tenant, or summed across all tenants."""
        now = self._clock() if now is None else now
        with self._lock:
            tenants = [tenant] if tenant else list(
                set(self._rates) | set(self._buckets)
            )
            total = 0.0
            for t in tenants:
                self._fold_locked(t, now)
                total += self._rates.get(t, 0.0)
        return total

    def tenant_rates(self, now=None) -> dict:
        now = self._clock() if now is None else now
        with self._lock:
            for t in list(set(self._rates) | set(self._buckets)):
                self._fold_locked(t, now)
            return {t: r for t, r in self._rates.items() if r > 0.0}


class SimulatedProvider(FleetProvider):
    """Deterministic preemptible-instance provider for tests and bench.

    Models the spot-capacity lifecycle real clouds impose: a spun-up
    node pays a cold-start latency before it is servable (the
    defaults, 4.2 s cold vs 0.23 s warm, are the reference's, kept so
    that ``Config`` equals it field for field; on an NVIDIA H100 80GB
    HBM3 at 700 W a cold port worker's first job took 13.29–20.68 s
    with its nvcc builds, and a joiner that fetched its kernel
    libraries from the AOT store 4.10–4.39 s), a preemption arrives
    as a *notice* first, and the
    node is force-killed ``preempt_grace_s`` after the notice if it
    has not gone away on its own. All transitions advance through
    :meth:`poll` against an injectable clock — no background threads —
    so a seeded run replays bit-identically.

    ``node_factory(name)`` (optional) attaches a real worker to each
    node once its cold-start elapses; the returned handle's ``stop()``
    is called on graceful spin-down and ``kill()`` (fallback
    ``stop()``) on a post-grace preemption kill. ``on_preempt_notice``
    is how the control plane learns a node must drain.
    """

    def __init__(
        self,
        cfg=None,
        seed: int = 0,
        preempt_grace_s: float = 5.0,
        coldstart_cold_s: float = 4.2,
        coldstart_warm_s: float = 0.23,
        aot_warm: bool = True,
        auto_preempt_p: float = 0.0,
        clock=time.monotonic,
        node_factory: Optional[Callable] = None,
        on_preempt_notice: Optional[Callable] = None,
        on_kill: Optional[Callable] = None,
    ):
        if cfg is not None:
            seed = getattr(cfg, "fleet_sim_seed", seed)
            preempt_grace_s = getattr(
                cfg, "fleet_sim_preempt_grace_s", preempt_grace_s
            )
            coldstart_cold_s = getattr(
                cfg, "fleet_sim_coldstart_cold_s", coldstart_cold_s
            )
            coldstart_warm_s = getattr(
                cfg, "fleet_sim_coldstart_warm_s", coldstart_warm_s
            )
            aot_warm = getattr(cfg, "fleet_sim_aot_warm", aot_warm)
        self.preempt_grace_s = float(preempt_grace_s)
        self.coldstart_s = (
            float(coldstart_warm_s) if aot_warm else float(coldstart_cold_s)
        )
        self.auto_preempt_p = float(auto_preempt_p)
        self._rng = random.Random(seed)  # guarded-by: _lock (reads)
        self._clock = clock
        self.node_factory = node_factory
        self.on_preempt_notice = on_preempt_notice
        self.on_kill = on_kill
        self._lock = threading.RLock()  # guards: _nodes, events (reads)
        #: name -> {"state": booting|ready|draining, "ready_at": float,
        #:          "spun_at": float, "kill_at": float|None, "handle": obj}
        self._nodes: dict[str, dict] = {}
        #: audit trail of (t, event, name) — bench/tests assert on it
        self.events: list[tuple] = []

    # -- lifecycle -----------------------------------------------------
    def spin_up(self, prefix, nodes):
        now = self._clock()
        notices = []
        with self._lock:
            for name in generate_node_names(prefix, nodes):
                # ensure-up: live names are skipped — INCLUDING
                # draining ones. A preemption-doomed node dies at
                # kill_at no matter what; re-provisioning its name
                # early would cancel the pending kill while the old
                # (possibly wedged) worker still owns the name's drain
                # state, poisoning the replacement. Capacity returns
                # once the kill lands and deregisters the name.
                if name in self._nodes:
                    continue
                self._nodes[name] = {
                    "state": "booting",
                    "spun_at": now,
                    "ready_at": now + self.coldstart_s,
                    "kill_at": None,
                    "handle": None,
                }
                self.events.append((now, "spin_up", name))
                if (
                    self.auto_preempt_p > 0.0
                    and self._rng.random() < self.auto_preempt_p
                ):
                    notices.append(name)
            self._export_states_locked()
        for name in notices:
            self.preempt(name, now=now)
        self.poll(now)

    def spin_down(self, prefix):
        handles = []
        with self._lock:
            for name, node in list(self._nodes.items()):
                if name.startswith(prefix):
                    if node["handle"] is not None:
                        handles.append(node["handle"])
                    self._nodes.pop(name)
                    self.events.append((self._clock(), "spin_down", name))
            self._export_states_locked()
        for h in handles:
            stop = getattr(h, "stop", None)
            if stop:
                stop()

    def list_nodes(self, prefix):
        with self._lock:
            return [n for n in self._nodes if n.startswith(prefix)]

    def ready_nodes(self, prefix: str = "") -> list[str]:
        self.poll()
        with self._lock:
            return [
                n
                for n, node in self._nodes.items()
                if n.startswith(prefix) and node["state"] != "booting"
            ]

    def shutdown(self):
        self.spin_down("")

    # -- preemption ----------------------------------------------------
    def preempt(self, name: str, now=None) -> bool:
        """Issue a preemption notice; the node is force-killed
        ``preempt_grace_s`` later unless it spun down first. (The
        ``fleet.preempt`` fault point lives on the server's dispatch
        path, where an armed chaos plan *injects* preemptions — see
        ``JobQueueService.next_job``.)"""
        now = self._clock() if now is None else now
        with self._lock:
            node = self._nodes.get(name)
            if node is None or node["state"] == "draining":
                return False
            node["state"] = "draining"
            node["kill_at"] = now + self.preempt_grace_s
            self.events.append((now, "preempt_notice", name))
            self._export_states_locked()
        FLEET_PREEMPTIONS.labels().inc()
        if self.on_preempt_notice is not None:
            try:
                self.on_preempt_notice(name)
            except Exception:
                pass
        return True

    # -- clock advance -------------------------------------------------
    def poll(self, now=None) -> None:
        """Apply due transitions: boots complete, post-grace kills."""
        now = self._clock() if now is None else now
        started, killed = [], []
        with self._lock:
            for name, node in list(self._nodes.items()):
                if node["state"] == "booting" and now >= node["ready_at"]:
                    node["state"] = "ready"
                    FLEET_COLDSTART.labels().observe(
                        node["ready_at"] - node["spun_at"]
                    )
                    self.events.append((now, "ready", name))
                    started.append((name, node))
                if (
                    node["kill_at"] is not None
                    and now >= node["kill_at"]
                ):
                    killed.append((name, node))
                    self._nodes.pop(name)
                    self.events.append((now, "killed", name))
            self._export_states_locked()
        for name, node in started:
            if self.node_factory is not None and node["handle"] is None:
                node["handle"] = self.node_factory(name)
        for name, node in killed:
            h = node["handle"]
            if h is not None:
                kill = getattr(h, "kill", None) or getattr(h, "stop", None)
                if kill:
                    kill()
            # the post-grace kill is the control plane's authoritative
            # "this node is dead NOW": the wired callback (app.py →
            # deregister_worker) hands its leases back immediately and
            # clears the name's drain state, so a wedged worker that
            # never saw its notice cannot poison the name — its
            # eventual stale upload is fenced off by the requeue
            if self.on_kill is not None:
                try:
                    self.on_kill(name)
                except Exception:
                    pass

    # -- telemetry -----------------------------------------------------
    def _export_states_locked(self) -> None:
        # requires-lock: _lock
        counts = {"booting": 0, "ready": 0, "draining": 0}
        for node in self._nodes.values():
            counts[node["state"]] = counts.get(node["state"], 0) + 1
        for state, n in counts.items():
            FLEET_NODES.labels(state=state).set(n)


class AutoscaleAdvisor:
    """Forecast-driven worker autoscaling.

    The advisor closes the loop and scales *ahead* of the spike, not
    only on depth: the sizing demand is current depth
    plus ``forecast_horizon_s`` seconds of EWMA-forecasted inflow (the
    :class:`InflowForecaster` fed from the admission path), divided by
    the jobs-per-node ratio, clamped to ``[min_nodes, max_nodes]``.
    Scale-up is immediate; scale-down waits out
    ``scaledown_hysteresis`` consecutive below-current recommendations
    so a between-waves trough doesn't thrash the fleet. With
    ``scale_to_zero_after_s`` set, a fleet whose tenants have shown
    zero depth AND zero forecasted inflow for that long parks to zero
    nodes regardless of ``min_nodes`` — the AOT-warm cold-start path
    re-warms it within the SLO when traffic returns.

    DRY-RUN BY DEFAULT — ``recommend()``/``status()`` only read;
    ``apply()`` touches the provider exclusively when the operator set
    ``gateway_autoscale_apply`` (scale-down tears down the
    highest-numbered nodes by name, matching ``generate_node_names``'s
    ``prefix1..prefixN`` scheme)."""

    def __init__(
        self,
        queue,
        provider: FleetProvider,
        jobs_per_node: int = 4,
        min_nodes: int = 0,
        max_nodes: int = 8,
        apply_enabled: bool = False,
        forecaster: Optional[InflowForecaster] = None,
        forecast_horizon_s: float = 30.0,
        scaledown_hysteresis: int = 3,
        scale_to_zero_after_s: float = 0.0,
        clock=time.monotonic,
    ):
        self.queue = queue
        self.provider = provider
        self.jobs_per_node = max(1, int(jobs_per_node))
        self.min_nodes = max(0, int(min_nodes))
        self.max_nodes = max(self.min_nodes, int(max_nodes))
        self.apply_enabled = bool(apply_enabled)
        self.forecaster = forecaster
        self.forecast_horizon_s = max(0.0, float(forecast_horizon_s))
        self.scaledown_hysteresis = max(0, int(scaledown_hysteresis))
        self.scale_to_zero_after_s = max(0.0, float(scale_to_zero_after_s))
        self._clock = clock
        self._lock = threading.Lock()  # guards: _below_streak, _idle_since, last_recommendation (reads)
        self._below_streak = 0
        self._idle_since: Optional[float] = None
        #: most recent recommend()/apply() output — /healthz's
        #: target-vs-actual readout without re-running the control law
        self.last_recommendation: Optional[dict] = None

    @classmethod
    def from_config(cls, queue, provider, cfg) -> "AutoscaleAdvisor":
        return cls(
            queue,
            provider,
            jobs_per_node=getattr(cfg, "gateway_autoscale_jobs_per_node", 4),
            min_nodes=getattr(cfg, "gateway_autoscale_min_nodes", 0),
            max_nodes=getattr(cfg, "gateway_autoscale_max_nodes", 8),
            apply_enabled=getattr(cfg, "gateway_autoscale_apply", False),
            forecaster=InflowForecaster(
                alpha=getattr(cfg, "fleet_forecast_alpha", 0.3)
            ),
            forecast_horizon_s=getattr(cfg, "fleet_forecast_horizon_s", 30.0),
            scaledown_hysteresis=getattr(
                cfg, "fleet_scaledown_hysteresis", 3
            ),
            scale_to_zero_after_s=getattr(
                cfg, "fleet_scale_to_zero_after_s", 0.0
            ),
        )

    def recommend(self, prefix: str = "node") -> dict:
        """One control-law step against the live queue gauges.

        Reads the world and advances the hysteresis/idle trackers; it
        never touches the provider. Use :meth:`status` for a readout
        that doesn't advance the trackers."""
        now = self._clock()
        depth = self.queue.queue_depth()
        current = len(self.provider.list_nodes(prefix))
        forecast_rate = (
            self.forecaster.rate(now=now) if self.forecaster else 0.0
        )
        forecast_jobs = forecast_rate * self.forecast_horizon_s
        demand = depth + forecast_jobs
        target = min(
            max(math.ceil(demand / self.jobs_per_node), self.min_nodes),
            self.max_nodes,
        )
        scale_to_zero = False
        with self._lock:
            if self.scale_to_zero_after_s > 0.0:
                if depth == 0 and forecast_rate <= 0.0:
                    if self._idle_since is None:
                        self._idle_since = now
                    elif now - self._idle_since >= self.scale_to_zero_after_s:
                        target = 0
                        scale_to_zero = current > 0
                else:
                    self._idle_since = None
            if target < current:
                self._below_streak += 1
                held_down = (
                    not scale_to_zero
                    and self._below_streak < self.scaledown_hysteresis
                )
            else:
                self._below_streak = 0
                held_down = False
        if target > current:
            action = "spin-up"
        elif target < current:
            action = "hold" if held_down else "spin-down"
        else:
            action = "hold"
        rec = {
            "prefix": prefix,
            "queue_depth": depth,
            "forecast_rate": round(forecast_rate, 4),
            "forecast_jobs": round(forecast_jobs, 2),
            "current_nodes": current,
            "target_nodes": target,
            "action": action,
            "scale_to_zero": scale_to_zero,
            "dry_run": not self.apply_enabled,
        }
        FLEET_TARGET.labels().set(target)
        FLEET_FORECAST.labels().set(forecast_rate)
        with self._lock:
            self.last_recommendation = rec
        return rec

    def status(self, prefix: str = "node") -> dict:
        """Target-vs-actual readout for /healthz and `swarm workers`:
        the last recommendation (if any) refreshed with the live node
        count — no control-law state is advanced."""
        current = len(self.provider.list_nodes(prefix))
        with self._lock:
            rec = dict(self.last_recommendation or {})
        rec.setdefault("prefix", prefix)
        rec.setdefault("target_nodes", None)
        rec["current_nodes"] = current
        rec.setdefault("dry_run", not self.apply_enabled)
        return rec

    def apply(self, prefix: str = "node") -> dict:
        """Execute the recommendation (no-op while dry-run).

        Scale-up passes the TARGET, not the delta: ``spin_up(prefix,
        N)`` generates the fixed names ``prefix1..prefixN`` (reference
        naming scheme), so providers ensure-up to N — already-live
        names are skipped, never duplicated. Passing a delta would
        regenerate ``prefix1..prefixΔ`` and collide with the live
        nodes instead of adding new ones."""
        rec = self.recommend(prefix)
        if not self.apply_enabled or rec["action"] == "hold":
            return rec
        if rec["action"] == "spin-up":
            self.provider.spin_up(prefix, rec["target_nodes"])
            FLEET_SCALE_EVENTS.labels(action="spin_up").inc()
        else:
            for i in range(rec["target_nodes"] + 1, rec["current_nodes"] + 1):
                self.provider.teardown_async(f"{prefix}{i}")
            FLEET_SCALE_EVENTS.labels(
                action="scale_to_zero" if rec["scale_to_zero"] else "spin_down"
            ).inc()
        rec["applied"] = True
        with self._lock:
            self.last_recommendation = rec
        return rec


def build_provider(cfg) -> FleetProvider:
    if cfg.fleet_provider == "digitalocean":
        return DigitalOceanProvider(cfg)
    if cfg.fleet_provider == "process":
        return ProcessProvider(cfg)
    if cfg.fleet_provider in ("sim", "simulated"):
        return SimulatedProvider(cfg)
    return NullProvider()
