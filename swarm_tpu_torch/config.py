"""One typed config layer for the port's server side and worker: the
port's copy of ``swarm_tpu/config.py``.

:class:`Config` has every field of the JAX package's ``Config``, with the
same name, type and default; the queue (``server/queue.py``), the
gateway, the result tier, the AOT store and the monitor lane read it.
The worker reads its own :class:`~swarm_tpu_torch.worker.runtime.WorkerConfig`
(the fields it has) through the same :func:`load`.

In increasing precedence: the dataclass's defaults, then a config file,
then the environment, then explicit overrides (the CLI's flags).

- An explicit path must load: a missing file or bad JSON raises, so a
  typo never starts a worker that polls the default URL with the
  placeholder key. Without one, the first of ``~/.swarm_tpu.json`` and
  ``~/.axiom.json`` that exists is read, and a malformed one is
  ignored.
- ``SWARM_<FIELD>``, then the reference worker's aliases
  (``SERVER_URL``, ``API_KEY``, ``WORKER_ID``); a variable that is set
  but empty counts.
- Values are coerced to each field's type, bools from ``1`` / ``true``
  / ``yes`` / ``on``; keys of the file that the dataclass lacks are
  ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

DEFAULT_CONFIG_FILE = "~/.swarm_tpu.json"
#: also read, for the reference CLI's config
LEGACY_CONFIG_FILE = "~/.axiom.json"

ENV_PREFIX = "SWARM_"
#: the reference worker's environment names, besides ``SWARM_<FIELD>``
ENV_ALIASES = {
    "server_url": ("SERVER_URL",),
    "api_key": ("API_KEY",),
    "worker_id": ("WORKER_ID",),
}


def read_config_file(path: Optional[str] = None) -> dict:
    """The values of the config file: ``path``'s (which must load), else
    the first default file that exists ({} when it is malformed or
    there is none)."""
    if path:
        return json.loads(Path(path).expanduser().read_text())
    for candidate in (DEFAULT_CONFIG_FILE, LEGACY_CONFIG_FILE):
        p = Path(candidate).expanduser()
        if p.is_file():
            try:
                return json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                return {}
    return {}


def load(cls, path: Optional[str] = None, env: Optional[Mapping[str, str]] = None,
         read_files: bool = True, **overrides: Any):
    """An instance of the dataclass ``cls`` from its defaults, the
    config file (when ``read_files``), the environment (``os.environ``
    unless ``env``) and the overrides that are not None."""
    env = os.environ if env is None else env
    values: dict = dict(read_config_file(path)) if read_files else {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name in fields:
        for key in (ENV_PREFIX + name.upper(),) + ENV_ALIASES.get(name, ()):
            if key in env:
                values[name] = env[key]
                break
    values.update({k: v for k, v in overrides.items() if v is not None})
    coerced: dict = {}
    for name, value in values.items():
        field = fields.get(name)
        if field is None:
            continue
        if field.type in ("int", int) and not isinstance(value, int):
            value = int(value)
        elif field.type in ("float", float) and not isinstance(value, float):
            value = float(value)
        elif field.type in ("bool", bool) and not isinstance(value, bool):
            value = str(value).strip().lower() in ("1", "true", "yes", "on")
        coerced[name] = value
    return cls(**coerced)


@dataclasses.dataclass
class Config:
    # --- control plane ---
    server_url: str = "http://127.0.0.1:5001"
    # True when server_url was derived from the actually-bound port by a
    # SwarmServer (server/app.py _advertise_url) rather than set by the
    # operator — a later server instance reusing this Config re-derives
    # instead of advertising the prior (possibly dead) ephemeral port.
    # A regular init field so dict-copied Configs keep their derived-ness.
    server_url_derived: bool = False
    api_key: str = "CHANGE_THIS"
    host: str = "0.0.0.0"
    port: int = 5001

    # --- stores (embedded by default; URLs switch to real backends) ---
    state_backend: str = "memory"  # "memory" | "redis"
    redis_url: str = "redis://127.0.0.1:6379/0"
    blob_backend: str = "local"  # "local" | "s3"
    blob_root: str = "uploads"  # local blob directory (doubles as S3 layout)
    s3_bucket: str = "bucket_name"
    doc_backend: str = "local"  # "local" | "mongo"
    doc_root: str = "docdb"
    mongo_url: str = "mongodb://localhost:27017"
    mongo_db: str = "asm"

    # --- worker ---
    worker_id: str = "worker-0"
    poll_interval_idle_s: float = 10.0
    poll_interval_busy_s: float = 0.8
    modules_dir: str = "modules"
    max_jobs: int = 0  # 0 = unlimited (the reference accepted but ignored this)
    # comma-separated module names whose engines are built before the
    # poll loop starts (with the compiled-corpus cache, a prewarmed
    # worker serves its first job at steady-state latency)
    prewarm_modules: str = ""

    # --- dispatch leases (new vs reference: requeue-on-expiry) ---
    lease_seconds: float = 600.0
    max_attempts: int = 3

    # --- resilience (docs/RESILIENCE.md) ---
    # seeded fault-injection plan (resilience/faults grammar); empty =
    # fault points are no-ops. Env: SWARM_FAULT_PLAN.
    fault_plan: str = ""
    # worker-reported failed terminal states requeue (bounded by
    # max_attempts) instead of going terminal on the first attempt;
    # exhausted jobs land in dead-letter quarantine either way
    retry_failed: bool = True
    # retrying transport (jittered exponential backoff + per-operation
    # circuit breakers around the worker's ServerClient)
    transport_retries: int = 3
    transport_backoff_s: float = 0.2
    transport_backoff_max_s: float = 5.0
    transport_breaker_threshold: int = 5
    transport_breaker_cooldown_s: float = 10.0
    # lease heartbeat: renewal cadence while a chunk executes
    # (0 = lease_seconds / 3)
    heartbeat_interval_s: float = 0.0
    # disk spool for completed output chunks when the server is
    # unreachable ("" = <worker work_dir>/spool)
    spool_dir: str = ""

    # --- durable queue journal (docs/DURABILITY.md) ---
    # write-ahead journal of queue mutations in the blob store: every
    # mutation is journaled BEFORE the state store (and before the
    # client's 200), and a restarting server replays it — the embedded
    # MemoryStateStore deployment becomes crash-consistent. Off keeps
    # the pre-journal behavior (state dies with the process).
    journal_enabled: bool = True
    # WAL segments accumulated before an opportunistic checkpoint
    # folds them into a snapshot
    journal_compact_segments: int = 512
    # re-lease grace: recovered leases are EXPIRED down to this window
    # (0 = lease_seconds / 2) — long enough for a live worker's next
    # heartbeat to re-lease its job through the normal fencing path,
    # short enough that a dead worker's job requeues quickly
    journal_recovery_grace_s: float = 0.0

    # --- fleet result cache (docs/CACHING.md) ---
    # shared content-addressed result tier behind the per-engine memo:
    # "off" (default) leaves every path unchanged; "memory" shares one
    # embedded tier across this process's engines; "redis" goes
    # fleet-wide over the state-store adapter. Env: SWARM_CACHE_BACKEND.
    cache_backend: str = "off"
    # tier Redis URL ("" = reuse redis_url)
    cache_url: str = ""
    # blob-spill directory for oversized values on the redis backend
    # ("" = state store only; the memory backend spills to an embedded
    # blob store regardless)
    cache_spill_dir: str = ""
    # promote the batched walk's confirm cache as the tier's second
    # value family
    cache_confirm: bool = True
    # write freshly walked results back to the tier (off = read-only
    # consumer)
    cache_writeback: bool = True
    # breaker around every tier op: a dead backend degrades the scan
    # to L1-only, it never blocks it
    cache_breaker_threshold: int = 3
    cache_breaker_cooldown_s: float = 30.0
    # TTL/size policy for the shared namespaces (docs/CACHING.md): 0 =
    # today's behavior (backend eviction + epoch bumps only). TTL is
    # per entry; the max-entry bound applies to EACH value-family
    # namespace independently, oldest entries evicted first.
    cache_ttl_s: float = 0.0
    cache_max_entries: int = 0

    # --- AOT kernel-library cache (docs/AOT.md) ---
    # ship built kernel libraries through the shared stores so a
    # joining worker fetches instead of compiling: "off" (default)
    # keeps today's per-process compile path; "memory" shares one
    # embedded store across this process's engines (tests); "local"
    # is file-backed under aot_dir (cross-process on one host, zero
    # side-cars); "redis" goes fleet-wide (state via aot_url/
    # redis_url, payload blobs via the S3 role when s3_bucket is set,
    # else a shared directory). Env: SWARM_AOT_BACKEND.
    aot_backend: str = "off"
    # store Redis URL ("" = reuse redis_url)
    aot_url: str = ""
    # artifact directory for the local backend / redis blob side
    aot_dir: str = ""
    # publish locally compiled executables back to the store (off =
    # read-only consumer)
    aot_publish: bool = True
    # fetch-and-load every published same-group executable at engine
    # bring-up (the cold-start win; off = lazy per-dispatch fetch)
    aot_prewarm: bool = True
    # breaker around every store op: a dead backend degrades to
    # compile-only, it never blocks a dispatch
    aot_breaker_threshold: int = 3
    aot_breaker_cooldown_s: float = 30.0

    # --- multi-tenant gateway (docs/GATEWAY.md) ---
    # per-tenant token bucket: submissions/second refill (0 = unlimited,
    # the single-operator default) and burst capacity
    gateway_tenant_rate: float = 0.0
    gateway_tenant_burst: int = 64
    # max jobs waiting in ONE tenant's dispatch queue before its
    # submissions shed (0 = unbounded)
    gateway_tenant_queue_max: int = 0
    # queue depth that maps to composite pressure 1.0 (0 disables the
    # depth component)
    gateway_queue_high: int = 0
    # composite pressure at/over which every submission sheds
    gateway_shed_pressure: float = 1.0
    # Retry-After seconds advertised on pressure/queue-full sheds
    # (rate sheds compute the exact token wait instead)
    gateway_retry_after_s: float = 1.0
    # tenant-id cardinality cap: a NEW tenant past this sheds with
    # reason "tenant_limit" (tenant ids are client data — without a
    # bound, rotating fresh ids would mint a fresh token bucket per
    # request and grow per-tenant state without limit)
    gateway_max_tenants: int = 1024
    # a worker's reported in-flight saturation decays after this many
    # seconds (a dead worker's last report must not pin pressure)
    gateway_saturation_ttl_s: float = 60.0
    # registry slots free after this much tenant inactivity, so a past
    # id-rotation flood can't deny new tenants until restart
    gateway_tenant_ttl_s: float = 3600.0
    # /stream/<scan_id>: poll cadence for new chunks and the idle
    # window after which the server closes the stream (client resumes
    # with ?from=<cursor>)
    gateway_stream_poll_s: float = 0.05
    gateway_stream_idle_timeout_s: float = 300.0
    # --- latency-tiered serving (docs/GATEWAY.md §QoS) ---
    # bulk-starvation bound for the express dispatch lane: at most this
    # many consecutive interactive serves while bulk work is waiting,
    # then one bulk job is served unconditionally. With no interactive
    # submissions the express lists stay empty and dispatch order is
    # byte-identical to the pre-QoS queue.
    qos_express_burst: int = 4
    # an interactive row older than this forces an early partial-bucket
    # flush in the scheduler's planner (the deadline that bounds
    # express-lane tail latency; only rows of the interactive class
    # consult it, so bulk-only feeds are untouched)
    qos_deadline_ms: float = 50.0
    # max-age flush for EVERY bucket class (the bulk trickle-tail fix):
    # 0 = off, today's behavior — a partial bucket waits for end of
    # stream; >0 bounds how long any planned row can sit unflushed
    sched_max_age_ms: float = 0.0
    # answer fleet-known interactive submissions at the gateway tier
    # (content-key lookup against the shared result cache BEFORE
    # admission — zero worker dispatch on a hit). Requires
    # cache_backend != off; bulk submissions never consult it.
    qos_gateway_cache: bool = True
    # completed chunks at or under this many target lines are written
    # back to the gateway cache (the short-circuit's feed; 0 disables
    # writeback). Small by design: interactive probes are single-target
    # and the gateway tier must not mirror whole bulk scans.
    qos_cache_max_rows: int = 16
    # queue-depth-driven autoscale advisor (server/fleet.py): target
    # waiting-jobs-per-node ratio, node bounds, and whether POST
    # /autoscale may actually apply the recommendation (default:
    # dry-run — recommend only)
    gateway_autoscale_jobs_per_node: int = 4
    gateway_autoscale_min_nodes: int = 0
    gateway_autoscale_max_nodes: int = 8
    gateway_autoscale_apply: bool = False
    # --- closed-loop elastic fleet (docs/RESILIENCE.md §Preemption) ---
    # EWMA smoothing factor for the inflow forecaster over the
    # admission history (higher = reacts faster to a spike shoulder)
    fleet_forecast_alpha: float = 0.3
    # forecast horizon: how many seconds of forecasted inflow are added
    # to the current depth when the advisor sizes the fleet (scale
    # AHEAD of the spike; 0 = depth-reactive, no forecast)
    fleet_forecast_horizon_s: float = 30.0
    # scale-down hysteresis: the advisor must see a below-target fleet
    # for this many consecutive recommendations before it shrinks
    # (scale-up is always immediate)
    fleet_scaledown_hysteresis: int = 3
    # park an idle tenant fleet entirely (target 0) after this many
    # seconds with zero depth and zero forecasted inflow; 0 disables
    # scale-to-zero and min_nodes is the floor
    fleet_scale_to_zero_after_s: float = 0.0
    # simulated provider (tests/bench): RNG seed for preemption draws
    # and the preemption notice → forced-kill grace window
    fleet_sim_seed: int = 0
    fleet_sim_preempt_grace_s: float = 5.0
    # simulated cold-start latency per node, drawn from the measured
    # AOT bring-up numbers (docs/AOT.md: 4.2 s cold compile vs 0.23 s
    # AOT-warm fetch) — aot_warm picks which one a booting sim node pays
    fleet_sim_coldstart_cold_s: float = 4.2
    fleet_sim_coldstart_warm_s: float = 0.23
    fleet_sim_aot_warm: bool = True
    # cold-start SLO the bench autoscale phase gates on: a parked
    # (scale-to-zero) tenant's first node must be servable within this
    # wall-clock budget when the store is AOT-warm
    fleet_coldstart_slo_s: float = 2.0
    # graceful drain: how long a draining worker keeps polling for the
    # drain signal to settle before exiting, and how long the server
    # waits for a draining worker's lease before force-requeueing
    worker_drain_timeout_s: float = 30.0
    # --- per-class shed (docs/GATEWAY.md §QoS) ---
    # composite pressure at/over which BULK submissions shed; 0 = use
    # gateway_shed_pressure for both classes (one threshold)
    gateway_shed_pressure_bulk: float = 0.0
    # composite pressure at/over which INTERACTIVE submissions shed;
    # 0 = use gateway_shed_pressure. Set bulk < interactive to shed
    # bulk first under rising pressure.
    gateway_shed_pressure_interactive: float = 0.0
    # --- continuous monitoring (docs/MONITORING.md) ---
    # standing rescan subsystem: registered monitor specs fire epochs
    # on a cadence through the admission path, diff verdicts against
    # the prior epoch and push changes over /monitor-feed. Off = the
    # routes 404-equivalent (registration rejected) and no ticker
    # thread starts.
    monitor_enabled: bool = True
    # scheduler ticker cadence: how often due specs are checked. The
    # cadence floor for spec intervals too — an interval below one
    # tick can never fire more often than the ticker runs.
    monitor_tick_s: float = 0.25
    # registry bound: a POST /monitor past this many standing specs is
    # rejected (specs are journaled state — an unbounded registry
    # would grow every snapshot)
    monitor_max_specs: int = 256
    # /monitor-feed/<id>: poll cadence for new diff records and the
    # idle window after which the server closes the stream (client
    # resumes with ?from=<cursor>)
    monitor_feed_poll_s: float = 0.1
    monitor_feed_idle_timeout_s: float = 300.0
    # end-to-end span tracing (docs/OBSERVABILITY.md §Tracing): off by
    # default — disabled tracing keeps wire payloads byte-identical to
    # the untraced build. Env: SWARM_TRACE_ENABLED (SWARM_TRACE also
    # arms the tracing module directly, process-wide).
    trace_enabled: bool = False

    # --- fleet orchestration ---
    fleet_provider: str = "null"  # "null"|"digitalocean"|"process"|"sim"
    fleet_api_token: str = ""
    fleet_rate_limit_per_min: int = 250
    fleet_region: str = "nyc3"
    fleet_size: str = "s-1vcpu-1gb"
    fleet_image: str = ""
    idle_polls_before_teardown: int = 15

    # --- match engine ---
    templates_dir: str = ""
    engine_batch_rows: int = 2048
    engine_row_width: int = 1024
    mesh_data_axis: int = 0  # 0 = all available devices on the data axis
    # continuous-batching scheduler (swarm_tpu_torch/sched, docs/PIPELINE.md):
    # "on" routes device-batch execution through prefetch + padding
    # buckets + bounded in-flight submission; "off" keeps the direct
    # path. Env: SWARM_PIPELINE. Results are bit-identical either way.
    pipeline: str = "off"

    def resolve_url(self) -> str:
        return self.server_url.rstrip("/")

    @classmethod
    def load(
        cls,
        path: Optional[str] = None,
        env: Optional[Mapping[str, str]] = None,
        **overrides: Any,
    ) -> "Config":
        """Defaults, then the config file, then the environment, then
        the overrides that are not None (the module's :func:`load`)."""
        return load(cls, path=path, env=env, **overrides)

    def save(self, path: Optional[str] = None) -> Path:
        p = Path(path or DEFAULT_CONFIG_FILE).expanduser()
        p.write_text(json.dumps(dataclasses.asdict(self), indent=4))
        return p
