"""Monitor ticker: cadence firing, epoch completion tracking, diff
dispatch (docs/MONITORING.md §Epoch lifecycle).

The port's copy of ``swarm_tpu/monitor/service.py``: the same logic,
records, keys and bytes.

Ownership split: DURABLE state (the spec registry with its cadence
progress) is queue-owned and journaled — ``JobQueueService`` holds the
``put_monitor``/``fire_monitor_epoch`` mutations. This service owns
only the VOLATILE loop around it: a daemon ticker that fires due specs
tenant-fairly through the server's admission callback, watches fired
epochs for completion, and runs the diff → feed → plane → mark
pipeline when they finish. Everything here can die with the process;
``start()`` reconstructs it all from the journal-recovered specs and
the blob-store feed.

``queue`` is any object with the queue service's monitor surface:
``list_monitors``, ``get_monitor``, ``put_monitor``, ``chunk_status``
and ``blobs``. ``cfg`` is read for ``worker_id`` and
``monitor_tick_s`` through ``getattr``, so any object serves.

Firing discipline (the no-double-fire contract):

- a spec is due when ``now >= next_fire_at``; firing sets
  ``next_fire_at = now + interval`` (never ``+= k*interval``), so a
  monitor that slept through N intervals fires ONCE, late;
- the epoch advance is journaled before any job exists
  (``fire_monitor_epoch``), so kill-9 leaves either a fired epoch
  (recovery resumes its diff) or a journaled-but-unfired one (recovery
  flags ``refire``; the next tick re-fires the SAME epoch under the
  SAME scan id — once, late, onto the same blobs);
- a shed admission fires nothing and advances nothing: the spec stays
  due and retries next tick, rate-limited like any submission.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

from swarm_tpu_torch.datamodel import JobStatus, chunk_generator, chunk_output_key
from swarm_tpu_torch.monitor import feed as monitor_feed
from swarm_tpu_torch.monitor import notify as monitor_notify
from swarm_tpu_torch.monitor.diff import (
    MonitorPlaneStore,
    diff_epoch,
    extract_verdicts,
    plane_from_records,
)
from swarm_tpu_torch.monitor.spec import MonitorSpec
from swarm_tpu_torch.telemetry.events import emit_event
from swarm_tpu_torch.telemetry.monitor_export import (
    MONITOR_DIFF_RECORDS,
    MONITOR_EPOCHS,
    MONITOR_RESCAN_HIT_RATIO,
)


class MonitorService:
    """One per server process. ``submit`` is the server's epoch-submit
    callback: admission + per-target cache lookup + journaled fire,
    returning ``{"chunks": n, "cached_chunks": k}`` or None on shed."""

    def __init__(
        self,
        queue,
        cfg,
        submit: Callable[[MonitorSpec, str, int], Optional[dict]],
        tier=None,
        clock: Callable[[], float] = time.time,
    ):
        self._queue = queue
        self._cfg = cfg
        self._submit = submit
        self._clock = clock
        self._plane = MonitorPlaneStore(
            tier, writer_id=getattr(cfg, "worker_id", None) or "server"
        )
        self._lock = threading.Lock()  # guards: _pending, _tenant_cursor
        # serializes whole tick()/drain() passes: the ticker thread and
        # a test/bench driving the service directly must not both read
        # the same due spec and fire it twice under different scan ids
        self._pass_lock = threading.Lock()  # guards: (tick/drain pass exclusion)
        # monitor_id -> {"epoch","scan_id","n_chunks","cached_chunks"} for
        # fired epochs whose diff has not been committed (mark absent)
        self._pending: dict = {}
        self._tenant_cursor = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self, run_thread: bool = True) -> None:
        """Reconcile recovered state, then (optionally) spawn the
        ticker thread. Tests and the bench drive ``tick``/``drain``
        directly with ``run_thread=False``."""
        self._reconcile()
        # corpus-delta subscription: a live engine's refresh_corpus in
        # this process turns into a journaled due-now touch (below)
        monitor_notify.register(self)
        if run_thread and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="monitor-ticker", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        monitor_notify.unregister(self)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------------
    # corpus-delta out-of-cadence re-evaluation
    # ------------------------------------------------------------------
    def on_corpus_delta(self, digest: Optional[str] = None) -> int:
        """A corpus refresh can change any template's verdict, so every
        unpaused standing spec is affected: persist a due-now touch
        (``next_fire_at = 0.0``) through the journaled ``put_monitor``
        path, and the next normal ``tick()`` fires one immediate diff
        epoch per spec under the usual admission/shed/journal
        discipline — the fire itself restores the cadence
        (``next_fire_at = now + interval``), so one delta costs one
        epoch, not a faster schedule.

        Nothing fires here. The touch being DURABLE before any fire is
        the crash contract: kill-9 between notify and fire recovers a
        spec that is merely due — the next server's first tick fires
        it once, late, exactly like a missed cadence. Returns the
        number of specs touched."""
        now = self._clock()
        touched = 0
        for spec in self.list_specs():
            if spec.paused or spec.due(now):
                continue  # paused stays parked; already-due fires anyway
            wire = spec.to_wire()
            wire["next_fire_at"] = 0.0
            self._queue.put_monitor(wire)
            touched += 1
            emit_event(
                "monitor.corpus_delta_touch",
                monitor_id=spec.monitor_id,
                tenant=spec.tenant,
                corpus_digest=digest,
            )
        return touched

    def _run(self) -> None:
        tick_s = max(0.01, float(getattr(self._cfg, "monitor_tick_s", 0.25)))
        while not self._stop.wait(tick_s):
            try:
                self.tick()
                self.drain()
            except Exception:
                # the ticker must outlive any single bad epoch — a
                # monitor bug degrades that monitor, never the server
                traceback.print_exc()

    def _reconcile(self) -> None:
        """Post-recovery bootstrap: every spec whose last epoch has no
        mark is either pending (scan exists — resume its diff) or a
        dead fire (no scan materialized — recovery already flagged
        ``refire``, nothing to track here)."""
        for spec in self.list_specs():
            if spec.epoch <= 0 or spec.last_scan_id is None or spec.refire:
                continue
            if monitor_feed.epoch_marked(
                self._queue.blobs, spec.monitor_id, spec.epoch
            ):
                continue
            n_chunks = sum(
                1 for _ in chunk_generator(list(spec.targets), spec.batch_size)
            )
            with self._lock:
                self._pending[spec.monitor_id] = {
                    "epoch": spec.epoch,
                    "scan_id": spec.last_scan_id,
                    "n_chunks": n_chunks,
                    "cached_chunks": 0,
                }

    # ------------------------------------------------------------------
    # spec registry views
    # ------------------------------------------------------------------
    def list_specs(self) -> list:
        return [
            MonitorSpec.from_wire(w) for w in self._queue.list_monitors()
        ]

    # ------------------------------------------------------------------
    # firing
    # ------------------------------------------------------------------
    # blocking-ok: the pass lock exists to serialize whole firing passes
    # (ticker thread vs direct tick callers) — holding it across the
    # journaled fire IS the exclusion this service needs
    def tick(self, now: Optional[float] = None) -> int:
        """Fire every due spec, tenant-fairly: due specs are grouped by
        tenant and fired round-robin across tenants from a rotating
        cursor, so one tenant's thousand monitors cannot starve another
        tenant's one when a backlog of due epochs drains."""
        with self._pass_lock:
            return self._tick_locked(
                self._clock() if now is None else now
            )

    def _tick_locked(self, now: float) -> int:
        due = [s for s in self.list_specs() if s.due(now)]
        if not due:
            return 0
        by_tenant: dict = {}
        for spec in due:
            by_tenant.setdefault(spec.tenant, []).append(spec)
        tenants = sorted(by_tenant)
        with self._lock:
            start = self._tenant_cursor % len(tenants)
            self._tenant_cursor += 1
        ordered: list = []
        lanes = [by_tenant[t] for t in tenants[start:] + tenants[:start]]
        while any(lanes):
            for lane in lanes:
                if lane:
                    ordered.append(lane.pop(0))
        fired = 0
        for spec in ordered:
            with self._lock:
                if spec.monitor_id in self._pending:
                    continue  # prior epoch's diff still in flight
            if self._fire(spec, now):
                fired += 1
        return fired

    def _fire(self, spec: MonitorSpec, now: float) -> bool:
        if spec.refire and spec.last_scan_id:
            # re-fire the journaled-but-unfired epoch under its
            # journaled identity: once, late, same blobs
            epoch, scan_id = spec.epoch, spec.last_scan_id
        else:
            epoch, scan_id = spec.epoch + 1, spec.scan_id_for(spec.epoch + 1, now)
        result = self._submit(spec, scan_id, epoch)
        if result is None:
            return False  # shed: still due, retries next tick
        MONITOR_EPOCHS.inc()
        with self._lock:
            self._pending[spec.monitor_id] = {
                "epoch": epoch,
                "scan_id": scan_id,
                "n_chunks": int(result.get("chunks") or 0),
                "cached_chunks": int(result.get("cached_chunks") or 0),
            }
        emit_event(
            "monitor.epoch_fired",
            monitor_id=spec.monitor_id,
            epoch=epoch,
            scan_id=scan_id,
            tenant=spec.tenant,
            chunks=result.get("chunks"),
            cached_chunks=result.get("cached_chunks"),
        )
        return True

    # ------------------------------------------------------------------
    # diffing
    # ------------------------------------------------------------------
    # blocking-ok: same pass-exclusion story as tick — two concurrent
    # drains would commit the same epoch twice (idempotent but wasteful)
    def drain(self) -> int:
        """Run the diff pipeline for every fired epoch whose scan has
        reached a terminal state. Returns committed epoch count."""
        with self._pass_lock:
            return self._drain_locked()

    def _drain_locked(self) -> int:
        with self._lock:
            pending = dict(self._pending)
        done = 0
        for monitor_id, entry in pending.items():
            spec_wire = self._queue.get_monitor(monitor_id)
            if spec_wire is None:
                with self._lock:
                    self._pending.pop(monitor_id, None)
                continue
            outputs = self._epoch_outputs(entry)
            if outputs is None:
                continue  # still running
            self._commit_epoch(
                MonitorSpec.from_wire(spec_wire), entry, outputs
            )
            with self._lock:
                self._pending.pop(monitor_id, None)
            done += 1
        return done

    def _epoch_outputs(self, entry: dict) -> Optional[dict]:
        """Chunk offset → output bytes once every chunk is terminal;
        None while any chunk is still live. Failed / dead-lettered
        chunks land with no output entry (their targets carry prior
        state through the diff)."""
        scan_id = entry["scan_id"]
        n_chunks = entry["n_chunks"]
        blobs = self._queue.blobs
        outputs: dict = {}
        for i in range(n_chunks):
            key = chunk_output_key(scan_id, i)
            if blobs.exists(key):
                try:
                    outputs[i] = blobs.get(key)
                    continue
                except (FileNotFoundError, KeyError):
                    pass
            status = self._queue.chunk_status(scan_id, i)
            if status is None or status not in JobStatus.TERMINAL:
                return None
        return outputs

    def _commit_epoch(
        self, spec: MonitorSpec, entry: dict, outputs: dict
    ) -> None:
        """records → plane → mark, in that order (docs/MONITORING.md
        §Crash points): every prefix of that sequence re-runs to the
        same bytes, so recovery after any kill point is idempotent."""
        monitor_id, epoch = spec.monitor_id, entry["epoch"]
        blobs = self._queue.blobs
        targets = [t.rstrip("\n") for t in spec.targets]
        chunks = list(chunk_generator(targets, spec.batch_size))
        verdicts = extract_verdicts(chunks, outputs)
        prev_plane = self._prior_plane(spec, epoch)
        records, next_plane = diff_epoch(
            monitor_id,
            epoch,
            prev_plane,
            verdicts,
            targets,
            monitor_feed.seq_base(blobs, monitor_id, epoch),
        )
        monitor_feed.write_records(blobs, monitor_id, records)
        self._plane.store(
            monitor_id,
            spec.module,
            next_plane,
            [r["target"] for r in records],
            epoch,
        )
        monitor_feed.write_mark(
            blobs, monitor_id, epoch, len(records), entry["scan_id"]
        )
        kinds: dict = {}
        for r in records:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        for kind, n in kinds.items():
            MONITOR_DIFF_RECORDS.labels(kind=kind).inc(n)
        n_chunks = max(1, entry["n_chunks"])
        MONITOR_RESCAN_HIT_RATIO.labels().set(
            entry["cached_chunks"] / n_chunks
        )
        emit_event(
            "monitor.epoch_diffed",
            monitor_id=monitor_id,
            epoch=epoch,
            scan_id=entry["scan_id"],
            records=len(records),
            **{f"records_{k}": v for k, v in kinds.items()},
        )

    def _prior_plane(self, spec: MonitorSpec, epoch: int) -> dict:
        """The plane as of epoch-1: the tier copy when it is provably
        that epoch's (fast path), else a fold of the feed's MARKED
        records (authoritative; also the cold-tier / crash-re-run
        path — a partially committed epoch N must never see its own
        partial plane as 'prior')."""
        loaded = self._plane.load(spec.monitor_id, spec.module)
        if loaded is not None:
            plane, plane_epoch = loaded
            if plane_epoch == epoch - 1:
                return plane
        return plane_from_records(
            monitor_feed.feed_records(
                self._queue.blobs, spec.monitor_id, marked_only=True
            )
        )
