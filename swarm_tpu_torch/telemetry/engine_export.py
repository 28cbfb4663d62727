"""Match-engine stats → metrics registry bridge, the port of
``swarm_tpu/telemetry/engine_export.py``.

``MatchEngine`` keeps its hot-path counters in a plain
:class:`~swarm_tpu_torch.ops.engine.EngineStats` dataclass (mutating a
real metric per batch would tax the walk). This module registers ONE
scrape-time collector that aggregates the stats of every live engine in
the process into ``swarm_engine_*`` gauges — device seconds, host
confirm work, memo hit rate, batch fill — so the kernel layer shows up
on an exposition without touching engine hot paths. The reference's
``swarm_engine_device_compile_seconds`` (XLA compiles of new batch
shapes) is left out: the port's kernels are built once, at first use.

Engines are held through a ``WeakSet``: telemetry must never extend an
engine's lifetime (tests construct hundreds).
"""

from __future__ import annotations

import threading
import weakref

from swarm_tpu_torch.telemetry import walk_export as we
from swarm_tpu_torch.telemetry.metrics import REGISTRY

_lock = threading.Lock()
_engines: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _lock
_collector_added = False  # guarded-by: _lock

_G = {}


def _gauges() -> dict:
    if not _G:
        g = REGISTRY.gauge
        _G.update(
            engines=g("swarm_engine_instances", "Live MatchEngine instances"),
            rows=g("swarm_engine_rows", "Rows matched by all live engines"),
            batches=g("swarm_engine_batches", "Device batches dispatched"),
            device_seconds=g(
                "swarm_engine_device_seconds",
                "Seconds spent in device kernel dispatch",
            ),
            host_confirm_seconds=g(
                "swarm_engine_host_confirm_seconds",
                "Seconds spent in the sparse host confirmation walk",
            ),
            host_confirm_pairs=g(
                "swarm_engine_host_confirm_pairs",
                "(row, matcher) pairs re-checked on the host",
            ),
            host_always_pairs=g(
                "swarm_engine_host_always_pairs",
                "(row, template) hits from the host-only template tail",
            ),
            overflow_rows=g(
                "swarm_engine_overflow_rows",
                "Rows re-run end to end on the host (overflow/truncation)",
            ),
            memo_rows=g(
                "swarm_engine_memo_rows",
                "Rows served by the cross-batch verdict memo",
            ),
            memo_hit_rate=g(
                "swarm_engine_memo_hit_rate",
                "Fraction of rows served by the verdict memo",
            ),
            batch_fill=g(
                "swarm_engine_batch_fill",
                "Mean fraction of batch capacity actually filled",
            ),
            degraded=g(
                "swarm_engine_degraded",
                "Engines currently running with an open device breaker "
                "(CPU-oracle fallback; results stay exact)",
            ),
            degraded_batches=g(
                "swarm_engine_degraded_batches",
                "Batches served by the CPU-oracle fallback after a "
                "device-path failure",
            ),
            device_faults=g(
                "swarm_engine_device_faults",
                "Device-path failures observed (compile/OOM/dispatch)",
            ),
        )
    return _G


def register_engine(engine) -> None:
    """Track a MatchEngine for the aggregate ``swarm_engine_*`` gauges."""
    global _collector_added
    with _lock:
        _engines.add(engine)
        if not _collector_added:
            REGISTRY.add_collector(_collect)
            _collector_added = True


def _collect() -> None:
    g = _gauges()
    with _lock:
        engines = list(_engines)
    rows = batches = confirm_pairs = always_pairs = overflow = memo = 0
    degraded = degraded_batches = device_faults = 0
    dev_s = confirm_s = 0.0
    capacity = 0
    walk_pairs = walk_rounds = walk_pool = 0
    walk_pre_s = 0.0
    phase_s = {"unc": 0.0, "ext": 0.0, "insert": 0.0, "fixup": 0.0}
    for eng in engines:
        s = eng.stats
        rows += s.rows
        batches += s.batches
        confirm_pairs += s.host_confirm_pairs
        always_pairs += s.host_always_pairs
        overflow += s.overflow_rows
        memo += s.memo_slots
        dev_s += s.device_seconds
        confirm_s += s.host_confirm_seconds
        capacity += s.batches * eng.batch_rows
        degraded_batches += s.degraded_batches
        device_faults += s.device_faults
        walk_pairs += s.walk_batched_pairs
        walk_rounds += s.walk_batch_rounds
        walk_pre_s += s.walk_precompute_seconds
        walk_pool = max(walk_pool, s.walk_pool_threads)
        phase_s["unc"] += s.unc_seconds
        phase_s["ext"] += s.ext_seconds
        phase_s["insert"] += s.insert_seconds
        phase_s["fixup"] += s.fixup_seconds
        if eng._device_breakers.any_open():
            degraded += 1
    we.WALK_POOL_THREADS.set(walk_pool)
    we.WALK_BATCHED_PAIRS.set(walk_pairs)
    we.WALK_BATCH_ROUNDS.set(walk_rounds)
    we.WALK_PRECOMPUTE_SECONDS.set(walk_pre_s)
    for ph, v in phase_s.items():
        we.WALK_PHASE_SECONDS.labels(phase=ph).set(v)
    g["engines"].set(len(engines))
    g["rows"].set(rows)
    g["batches"].set(batches)
    g["device_seconds"].set(dev_s)
    g["host_confirm_seconds"].set(confirm_s)
    g["host_confirm_pairs"].set(confirm_pairs)
    g["host_always_pairs"].set(always_pairs)
    g["overflow_rows"].set(overflow)
    g["memo_rows"].set(memo)
    g["memo_hit_rate"].set(memo / rows if rows else 0.0)
    g["batch_fill"].set(rows / capacity if capacity else 0.0)
    g["degraded"].set(degraded)
    g["degraded_batches"].set(degraded_batches)
    g["device_faults"].set(device_faults)
