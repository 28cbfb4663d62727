"""Continuous-batching scheduler: prefetch → buckets → bounded submit
(the port of ``swarm_tpu/sched/scheduler.py``).

Sits between the worker runtime and the ops engine (the single place
batching policy lives). Host chunk decode, memo resolution and device
dispatch would otherwise run serially, one chunk-shaped batch at a
time; the scheduler turns that into a three-stage pipeline over a
stream of chunks:

1. **Prefetch**: decode/normalize the NEXT chunk's rows while the
   current batch is on device, classify each row — dead rows resolve
   immediately (they match nothing by contract), memo-known rows
   short-circuit out of device batches BEFORE padding, fresh rows go
   to the padding-bucket planner (sched/buckets.py) — and pre-encode
   planned batches (``encode_packed(reuse_buffers=True)``, drawing
   matrices from ``encoding._RotatingPool`` per bucket shape). With a
   fleet result tier on the engine, the chunk's L1 misses are first
   looked up in the tier (``engine.prefetch_shared_memo``), so rows
   another worker resolved take the memo lane too. Runs on
   a host thread when the host has cores to spare
   (``prefetch="auto"``); on starved hosts the same stage runs inline.
   The stage is numpy and the PyDLL passes of libfastpack only: it
   makes no torch call, so its thread never touches the card.
2. **Submission** (caller's thread): ``engine.begin_packed`` uploads
   the batch and launches its kernels on the card (the one 4-byte
   survivor read between the phases blocks on this batch's phase A),
   then queues the fused output's copy into pinned host memory behind
   a CUDA event; up to ``inflight`` batches are begun and not yet
   walked, so the sparse host walk of batch i overlaps the device work
   of batch i+1. On the CPU the depth collapses to 1 — there the
   "device" is the host, and an in-flight batch would steal exactly
   the cores the walk needs.
3. **Backpressure**: the encoded-batch queue is bounded
   (``queue_depth``) and the prefetch stage blocks on it — a slow
   extraction pass stalls intake (the chunk iterator simply isn't
   advanced) instead of ballooning host RSS. Peak footprint is
   ``queue_depth + inflight + 1`` encoded batches plus one bucket tail
   per live shape.

Results are exact and bit-identical to the direct path: every batch
goes through the same ``match_packed`` walk, only the batching/overlap
changes (pinned by tests/test_torch_sched.py against the JAX package).

Stage 2's walk half can additionally be OFFLOADED (docs/HOST_WALK.md):
with ``walk_offload`` on (auto: spare core + the engine's batched walk
enabled), ``finish_packed`` runs on a dedicated walk worker — batch
N's collect (a wait on its own CUDA event, then the read of its pinned
buffer) and its sparse confirm/extract walk run there while THIS
thread already encodes and dispatches batch N+1.

A device fault in ``begin_packed`` or ``finish_packed`` degrades that
batch to the engine's exact CPU oracle (``MatchEngine``'s device
breaker): the run's results stay bit-identical. Only a fault at the
``sched.submit`` fault point propagates out of :meth:`BatchScheduler.run`.

Each stage runs in a ``torch.profiler`` span (``sched.plan``,
``sched.encode``, ``sched.wait``, ``sched.submit``, ``sched.finish``);
:class:`SchedStats` counts rows by source, batches, fill, stalls,
offloaded walks and the deepest in-flight window reached.

Telemetry (the port's ``REGISTRY``, the reference's families):
- ``swarm_sched_batches_total{bucket,kind}`` — bucket occupancy
- ``swarm_sched_rows_total{source}`` — fresh / memo / dead split
- ``swarm_sched_fill_ratio`` — rows ÷ padded rows per device batch
- ``swarm_sched_prefetch_stall_seconds_total`` — submit loop starved
- ``swarm_sched_inflight_depth`` — current in-flight device batches
- ``swarm_sched_bucket_rows{bucket}`` — pending rows per bucket
- ``swarm_sched_walk_offloaded_total`` — walks run on the walk worker
- ``swarm_sched_flush_deadline_total{qos}`` and
  ``swarm_sched_batch_age_seconds{qos}`` from ``telemetry/sched_export``
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Sequence

from torch.profiler import record_function

from swarm_tpu_torch.resilience.faults import fault_point
from swarm_tpu_torch.sched.buckets import (
    QOS_BULK,
    QOS_INTERACTIVE,
    BucketPlanner,
    PlannedBatch,
)
from swarm_tpu_torch.telemetry import REGISTRY, tracing
from swarm_tpu_torch.telemetry.sched_export import (
    SCHED_BATCH_AGE,
    SCHED_FLUSH_DEADLINE,
)

_BATCHES = REGISTRY.counter(
    "swarm_sched_batches_total",
    "Scheduler batches submitted, by padding bucket and kind",
    ("bucket", "kind"),
)
_ROWS = REGISTRY.counter(
    "swarm_sched_rows_total",
    "Rows through the scheduler, by resolution source",
    ("source",),  # fresh | memo | dead
)
_FILL = REGISTRY.histogram(
    "swarm_sched_fill_ratio",
    "Real rows / padded rows per submitted device batch",
    buckets=(0.125, 0.25, 0.5, 0.75, 0.9, 1.0),
)
_STALL = REGISTRY.counter(
    "swarm_sched_prefetch_stall_seconds_total",
    "Seconds the submission loop waited on the prefetch stage",
)
_INFLIGHT = REGISTRY.gauge(
    "swarm_sched_inflight_depth",
    "Device batches currently in flight (begun, not yet walked)",
)
_BUCKET_ROWS = REGISTRY.gauge(
    "swarm_sched_bucket_rows",
    "Rows pending in each padding bucket (set at plan time)",
    ("bucket",),
)
_WALK_OFFLOADED = REGISTRY.counter(
    "swarm_sched_walk_offloaded_total",
    "Host walks handed to the scheduler's walk worker instead of "
    "blocking the device-submit thread (docs/HOST_WALK.md)",
)


@dataclasses.dataclass
class SchedulerConfig:
    #: rows per planned batch; 0 = the engine's batch_rows
    rows_target: int = 0
    #: device batches in flight (begun, not yet walked). Bounded so the
    #: recycled encode buffers (_RotatingPool depth 8 / verdict planes
    #: depth 8) can never alias an unconsumed batch. On the card the
    #: effective depth stays ≥2 even with the walk offload armed (the
    #: whole point: device batches hide the host walk); on the CPU it
    #: collapses to 1 (see _device_overlap_ok).
    inflight: int = 2
    #: encoded batches buffered between prefetch and submission — the
    #: backpressure bound intake stalls against
    queue_depth: int = 2
    #: probe the cross-batch verdict memo at plan time and route known
    #: rows around the device buckets
    memo_split: bool = True
    #: encode-first speculation once the stream looks steady (two
    #: fresh-free chunks in a row): the lookup that classifies the
    #: chunk IS the batch's pre-encode. Chunk-shaped batches trade the
    #: memo-lane coalescing for a single content pass — right when
    #: chunks are big; for tiny chunks coalescing wins (see plan()).
    speculate: bool = True
    #: "thread" = decode/encode on a prefetch thread; "inline" = same
    #: stage on the caller's thread (no GIL ping-pong — the device
    #: in-flight overlap still applies); "auto" = thread only when the
    #: host has a core to give it
    prefetch: str = "auto"
    #: "on" = hand each batch's host walk (finish_packed) to a
    #: dedicated walk worker so the submit thread keeps dispatching
    #: device batches while batch N's walk runs (docs/HOST_WALK.md);
    #: "off" = walk on the submit thread; "auto" = offload when a spare
    #: core exists and the engine's batched walk is enabled
    walk_offload: str = "auto"
    #: interactive-row coalescing deadline (docs/GATEWAY.md §QoS): an
    #: interactive row older than this forces an early partial-bucket
    #: flush. Only consulted for streams that actually carry
    #: interactive rows; 0 disables.
    qos_deadline_ms: float = 50.0
    #: max-age flush for EVERY bucket (the bulk trickle-tail bound);
    #: 0 = off, the hold-until-end-of-stream behavior
    max_age_ms: float = 0.0

    def __post_init__(self):
        # queue_depth (≤2) + inflight (≤4) + the offloaded walk (1) +
        # the encode in progress (1) must stay at or under the
        # recycled-pool depth 8 (see encoding._RotatingPool; the walk
        # slot is charged against inflight in run(), which caps the
        # offloaded total at 2+3+1+1=7)
        self.inflight = max(1, min(int(self.inflight), 4))
        self.queue_depth = max(1, min(int(self.queue_depth), 2))


@dataclasses.dataclass
class SchedStats:
    chunks: int = 0
    batches: int = 0
    fresh_rows: int = 0
    memo_rows: int = 0
    dead_rows: int = 0
    fill_sum: float = 0.0  # sum of per-device-batch row-fill ratios
    device_batches: int = 0
    stall_seconds: float = 0.0
    wall_seconds: float = 0.0
    offloaded_walks: int = 0  # walks run on the walk worker
    #: the deepest in-flight window reached (batches begun and not yet
    #: handed to the walk)
    max_inflight: int = 0

    @property
    def fill_ratio(self) -> float:
        return self.fill_sum / self.device_batches if self.device_batches else 0.0

    def snapshot(self) -> dict:
        return {
            "chunks": self.chunks,
            "batches": self.batches,
            "fresh_rows": self.fresh_rows,
            "memo_rows": self.memo_rows,
            "dead_rows": self.dead_rows,
            "fill_ratio": round(self.fill_ratio, 4),
            "stall_seconds": round(self.stall_seconds, 4),
            "wall_seconds": round(self.wall_seconds, 4),
            "offloaded_walks": self.offloaded_walks,
            "max_inflight": self.max_inflight,
        }


_DONE = object()


class BatchScheduler:
    """Drives one MatchEngine with continuous batching. One scheduler
    per engine; calls are serialized (the worker's job loop calls from
    a single thread)."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self.stats = SchedStats()
        self._lock = threading.Lock()  # guards run()'s chunk/result tables
        self._overlap_helps: Optional[bool] = None
        # steady-regime streak persists ACROSS run() calls: a worker's
        # job stream is one logical feed, so a new run over known
        # content speculates from its first chunk
        self._steady_streak = 0

    def _device_overlap_ok(self) -> bool:
        """Whether keeping >1 batch in flight can hide device time:
        decided by the engine's torch device. On ``cuda`` the kernels
        run off-host, so walking batch i while the card crunches i+1 is
        free; on the CPU the "device" IS the host — an in-flight
        batch's torch threads steal exactly the cores the walk needs,
        so the depth collapses to 1.

        Except on a mesh of more than one rank: the sharded matcher's
        deferred combine (``parallel/sharded.py``, ``_PendingShard``)
        only rides behind the next batch's phase A when dispatch N+1
        comes before collect N, so the window stays open even on the
        CPU."""
        if self._overlap_helps is None:
            ok = self.engine.device.device.type == "cuda"
            mesh = getattr(getattr(self.engine, "sharded", None), "mesh", None)
            if mesh is not None and int(mesh.devices.size) > 1:
                ok = True
            self._overlap_helps = ok
        return self._overlap_helps

    def _walk_offload_ok(self) -> bool:
        """Whether to hand each batch's host walk to a dedicated walk
        worker (docs/HOST_WALK.md). Explicit on/off wins; auto offloads
        when a spare core exists and the engine's batched walk is
        enabled (``walk_threads`` 0 means the operator pinned the serial
        reference walk — honor it end to end)."""
        mode = self.config.walk_offload
        if mode == "on":
            return True
        if mode == "off":
            return False
        return (os.cpu_count() or 1) >= 3 and getattr(
            self.engine, "walk_threads", 0
        ) != 0

    def _use_thread(self) -> bool:
        """Prefetch-thread policy: threading buys decode/encode overlap
        only when a spare core can actually run the thread; on 1-2 core
        hosts two Python-bound threads just ping-pong the GIL."""
        mode = self.config.prefetch
        if mode == "thread":
            return True
        if mode == "inline":
            return False
        return (os.cpu_count() or 1) >= 3

    # ------------------------------------------------------------------
    def match_rows(self, rows: Sequence) -> list:
        """All rows' RowMatches, in input order — the drop-in
        replacement for ``engine.match`` (bit-identical results)."""
        rows = list(rows)
        target = self.config.rows_target or self.engine.batch_rows
        chunks = [
            rows[i : i + target] for i in range(0, len(rows), target)
        ] or [[]]
        out: list = []
        for res in self.run(chunks):
            out.extend(res)
        return out

    # ------------------------------------------------------------------
    def run(
        self,
        chunks: Iterable,
        decode: Optional[Callable[[object], Sequence]] = None,
        qos=None,
    ) -> Iterator[list]:
        """Stream chunks through the pipeline; yield each chunk's
        RowMatches list in chunk order as it completes.

        ``chunks`` yields row sequences — or arbitrary payloads when
        ``decode`` is given, in which case decoding runs on the
        prefetch stage (on its thread when one is used). Buckets
        accumulate across chunk boundaries; a chunk's results surface
        once every bucket holding one of its rows has been walked (at
        the latest, at end of stream when partial buckets flush).

        ``qos`` classifies chunks for the express lane
        (docs/GATEWAY.md §QoS): None = all bulk, a class string applies
        to every chunk (the worker's one-job-one-class feed), a
        callable maps each raw chunk payload to its class. Interactive
        rows coalesce in their own buckets and flush early once older
        than ``qos_deadline_ms`` — results stay bit-identical, only
        the batching changes."""
        engine = self.engine
        cfg = self.config
        stats = self.stats
        if callable(qos):
            qos_of = qos
        else:
            fixed_qos = (
                QOS_INTERACTIVE if qos == QOS_INTERACTIVE else QOS_BULK
            )
            qos_of = lambda _payload: fixed_qos  # noqa: E731
        target = cfg.rows_target or engine.batch_rows
        # a mesh's bucket targets round up to its 'data' axis, so full
        # buckets fill per rank; one device (and stub engines) report 1
        data_ranks = getattr(engine, "data_ranks", lambda: 1)()
        planner = BucketPlanner(
            rows_target=target,
            max_body=engine.max_body,
            max_header=engine.max_header,
            data_ranks=data_ranks,
            qos_deadline_s=max(0.0, cfg.qos_deadline_ms) / 1000.0,
            max_age_s=max(0.0, cfg.max_age_ms) / 1000.0,
        )
        # chunk bookkeeping (prefetch registers, submission completes;
        # the lock only matters in threaded mode)
        chunk_start: list = []  # gid of each chunk's first row
        chunk_len: list = []
        chunk_left: list = []
        results: dict = {}  # gid -> RowMatches
        chunk_results: dict = {}  # cid -> whole-chunk RowMatches list
        t_run0 = time.perf_counter()

        def plan(register_dead) -> Iterator[tuple]:
            """The prefetch stage as a generator: decode, classify,
            bucket — yields ``(PlannedBatch, pre_encode_or_None)`` in
            submission order. ``register_dead(cid, gids)`` resolves
            dead rows.

            Steady-state regime detection: after two consecutive
            fresh-free chunks the stage speculates ENCODE-FIRST — one
            native lookup both classifies the chunk and, when every
            row is served (or dead), IS the batch's pre-encode. A chunk
            with misses re-classifies from the lookup's ``state`` array
            (still no extra probe) and resets the regime."""
            gid = 0
            memo_split = cfg.memo_split
            add_known = planner.add_known
            add_fresh = planner.add_fresh
            # fleet result tier: when the engine has one attached, the
            # shared lookup rides THIS stage — rows the tier knows are
            # in the L1 before classification, so they take the memo
            # lane (no bucket, no device slot) and the remote round
            # trip overlaps the in-flight batches rather than the
            # dispatch path. Stub engines (tests) may not expose the
            # hook.
            prefetch_shared = getattr(
                engine, "prefetch_shared_memo", None
            )
            for chunk in chunks:
                # classify from the RAW payload (decode may consume it)
                chunk_qos = qos_of(chunk)
                if chunk_qos != QOS_INTERACTIVE:
                    chunk_qos = QOS_BULK
                with record_function("sched.plan"):
                    rows = list(decode(chunk) if decode else chunk)
                now_chunk = time.monotonic()
                with self._lock:
                    cid = len(chunk_start)
                    chunk_start.append(gid)
                    chunk_len.append(len(rows))
                    chunk_left.append(len(rows))
                stats.chunks += 1
                if memo_split and rows and prefetch_shared is not None:
                    prefetch_shared(rows)
                known = None
                state = None
                if memo_split and rows:
                    if (
                        cfg.speculate
                        and self._steady_streak >= 2
                        # tiny chunks: per-batch fixed costs dominate,
                        # so the memo-lane coalescing below beats a
                        # chunk-shaped speculative batch
                        and len(rows) >= target // 4
                    ):
                        with record_function("sched.encode"):
                            spec_pre = engine.encode_packed(
                                rows, reuse_buffers=True
                            )
                        # native enc tuple: [1]=batch (None = no
                        # misses), [4]=state (-1 known, -2 dead, else
                        # miss slot)
                        state = spec_pre[4]
                        if spec_pre[1] is None:
                            n_dead = int((state == -2).sum())
                            n_memo = len(rows) - n_dead
                            stats.memo_rows += n_memo
                            stats.dead_rows += n_dead
                            if n_memo:
                                _ROWS.labels(source="memo").inc(n_memo)
                            if n_dead:
                                _ROWS.labels(source="dead").inc(n_dead)
                            pb = PlannedBatch(
                                ids=range(gid, gid + len(rows)),
                                rows=rows,
                                bucket=BucketPlanner._memo_label(chunk_qos),
                                kind="memo", qos=chunk_qos,
                            )
                            gid += len(rows)
                            yield pb, spec_pre
                            continue
                        # misses present: fall through, classifying
                        # from state (the speculative encode is
                        # discarded — its buffers recycle via the pool)
                        self._steady_streak = 0
                    else:
                        # ONE native pass classifies the chunk's memo
                        # residency
                        known = engine.memo_known_mask(rows)
                n_memo = n_fresh = 0
                dead_ids: list = []
                for j, row in enumerate(rows):
                    i = gid
                    gid += 1
                    if state is not None:
                        st = state[j]
                        if st == -2:
                            dead_ids.append(i)
                            continue
                        is_known = st == -1
                    else:
                        if not getattr(row, "alive", True):
                            # dead rows match nothing by contract — no
                            # bucket, no device, no memo traffic
                            dead_ids.append(i)
                            continue
                        is_known = known is not None and known[j]
                    if is_known:
                        n_memo += 1
                        pb = add_known(i, row, chunk_qos, now_chunk)
                    else:
                        n_fresh += 1
                        pb = add_fresh(i, row, chunk_qos, now_chunk)
                    if pb is not None:
                        yield pb, None
                if dead_ids:
                    register_dead(cid, dead_ids)
                    _ROWS.labels(source="dead").inc(len(dead_ids))
                stats.dead_rows += len(dead_ids)
                stats.memo_rows += n_memo
                stats.fresh_rows += n_fresh
                if n_memo:
                    _ROWS.labels(source="memo").inc(n_memo)
                if n_fresh:
                    _ROWS.labels(source="fresh").inc(n_fresh)
                self._steady_streak = (
                    0 if n_fresh else self._steady_streak + 1
                )
                # deadline-forced flushes (docs/GATEWAY.md §QoS): an
                # interactive row older than qos_deadline_ms preempts
                # further coalescing as a small express batch; with
                # max_age_ms set, bulk tails get the same bound.
                # Checked once per chunk — the feed's natural tick.
                for pb in planner.flush_due(time.monotonic()):
                    SCHED_FLUSH_DEADLINE.labels(qos=pb.qos).inc()
                    # always-on flight-ring record: a deadline preempt
                    # is exactly the context a post-mortem wants
                    tracing.flight_event(
                        "sched.deadline_flush", qos=pb.qos, bucket=pb.bucket
                    )
                    yield pb, None
            for pb in planner.flush_all():
                yield pb, None

        def register_dead(cid: int, dead_ids: list) -> None:
            from swarm_tpu_torch.ops.engine import RowMatches

            with self._lock:
                for i in dead_ids:
                    results[i] = RowMatches(template_ids=[], extractions={})
                chunk_left[cid] -= len(dead_ids)

        def encode_of(pb: PlannedBatch):
            with record_function("sched.encode"):
                try:
                    pre = engine.encode_packed(pb.rows, reuse_buffers=True)
                except Exception:
                    pre = None  # begin_packed re-encodes; never lose the rows
            occ = planner.occupancy()
            occ.setdefault(pb.bucket, 0)  # flushed bucket reads 0
            for bucket, rows_pending in occ.items():
                _BUCKET_ROWS.labels(bucket=bucket).set(rows_pending)
            return pre

        inflight: list = []  # FIFO of (PlannedBatch, handle)
        inflight_cap = cfg.inflight if self._device_overlap_ok() else 1
        walk_exec = None
        walking: list = []  # FIFO of (PlannedBatch, Future) — offloaded
        if self._walk_offload_ok():
            from concurrent.futures import ThreadPoolExecutor

            walk_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="swarm-sched-walk"
            )
            # the offloaded walk keeps one extra encoded batch alive:
            # its slot is charged against the in-flight budget so the
            # recycled encode planes (encoding._RotatingPool depth 8)
            # can never rotate back under an unwalked batch (queue 2 +
            # inflight 3 + walk 1 + encode 1 = 7 ≤ 8)
            inflight_cap = max(1, min(inflight_cap, 3))

        next_yield = [0]

        def finish_batch(pb: PlannedBatch, handle) -> None:
            with record_function("sched.finish"):
                packed = engine.finish_packed(handle)
                per = engine.rowmatches_from_packed(packed, len(pb.ids))
            ids = pb.ids  # ascending (arrival order within the bucket)
            with self._lock:
                if isinstance(ids, range) and ids:
                    # whole-chunk batch (the steady-state speculative
                    # path): adopt the assembled list as the chunk's
                    # result — no per-row dict traffic
                    cid = bisect.bisect_right(chunk_start, ids.start) - 1
                    if (
                        chunk_start[cid] == ids.start
                        and chunk_len[cid] == len(ids)
                    ):
                        chunk_results[cid] = per
                        chunk_left[cid] = 0
                        return
                results.update(zip(ids, per))
                # group the batch's rows by chunk in runs instead of a
                # per-row bisect — batches usually span 1-4 chunks
                k, n = 0, len(ids)
                while k < n:
                    cid = bisect.bisect_right(chunk_start, ids[k]) - 1
                    end_gid = chunk_start[cid] + chunk_len[cid]
                    k2 = k + 1
                    while k2 < n and ids[k2] < end_gid:
                        k2 += 1
                    chunk_left[cid] -= k2 - k
                    k = k2

        def drain_walks(limit: int) -> None:
            # .result() re-raises a walk failure on the submit thread —
            # a failing walk must fail the run, not vanish in a worker
            while len(walking) > limit:
                _pb, fut = walking.pop(0)
                fut.result()

        def finish_oldest() -> None:
            pb, handle = inflight.pop(0)
            _INFLIGHT.set(len(inflight))
            if walk_exec is not None:
                # batch N's walk runs on the walk worker while this
                # thread keeps encoding + dispatching batch N+1. One
                # walk in flight: the worker serializes walks, and the
                # bound keeps the encode-plane budget exact.
                walking.append((pb, walk_exec.submit(finish_batch, pb,
                                                     handle)))
                stats.offloaded_walks += 1
                _WALK_OFFLOADED.inc()
                drain_walks(1)
            else:
                finish_batch(pb, handle)

        def ready_chunks() -> list:
            out = []
            with self._lock:
                while (
                    next_yield[0] < len(chunk_start)
                    and chunk_left[next_yield[0]] == 0
                ):
                    cid = next_yield[0]
                    res = chunk_results.pop(cid, None)
                    if res is None:
                        s, n = chunk_start[cid], chunk_len[cid]
                        res = [results.pop(g) for g in range(s, s + n)]
                    out.append(res)
                    next_yield[0] += 1
            return out

        def submit(pb: PlannedBatch, pre) -> Iterator[list]:
            # a failing submission propagates to the caller (the
            # worker's execute fails the job); device faults inside
            # begin_packed degrade in the engine
            fault_point("sched.submit", detail=pb.kind)
            with record_function("sched.submit"):
                handle = engine.begin_packed(pb.rows, pre=pre)
            inflight.append((pb, handle))
            _INFLIGHT.set(len(inflight))
            stats.max_inflight = max(stats.max_inflight, len(inflight))
            stats.batches += 1
            _BATCHES.labels(bucket=pb.bucket, kind=pb.kind).inc()
            if pb.oldest_ts is not None:
                # the oldest row's coalescing wait — what the deadline
                # flush bounds per class
                SCHED_BATCH_AGE.labels(qos=pb.qos).observe(
                    max(0.0, time.monotonic() - pb.oldest_ts)
                )
            if pb.kind == "fresh":
                stats.device_batches += 1
                stats.fill_sum += pb.fill_rows
                _FILL.labels().observe(pb.fill_rows)
            while len(inflight) >= inflight_cap:
                finish_oldest()
            yield from ready_chunks()

        use_thread = self._use_thread()
        if use_thread and isinstance(chunks, (list, tuple)) and len(chunks) <= 1:
            # single-chunk call (per-wave engine.match): there is no
            # "next chunk" to prefetch — a thread would be pure
            # startup/handoff overhead per wave
            use_thread = False
        try:
            if not use_thread:
                # inline prefetch: same stages, caller's thread. Device
                # in-flight overlap (begin before finish) still applies;
                # only the decode/encode-vs-walk overlap is given up.
                for pb, pre in plan(register_dead):
                    yield from submit(
                        pb, pre if pre is not None else encode_of(pb)
                    )
                while inflight:
                    finish_oldest()
                drain_walks(0)
                for res in ready_chunks():
                    yield res
                return

            q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
            stop = threading.Event()
            errors: list = []

            def put(item) -> None:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return
                    except queue.Full:
                        continue

            def producer() -> None:
                try:
                    for pb, pre in plan(register_dead):
                        put((pb, pre if pre is not None else encode_of(pb)))
                        if stop.is_set():
                            return
                except BaseException as e:
                    errors.append(e)
                finally:
                    put(_DONE)

            thread = threading.Thread(
                target=producer, daemon=True, name="swarm-sched-prefetch"
            )
            thread.start()
            try:
                while True:
                    t0 = time.perf_counter()
                    with record_function("sched.wait"):
                        item = q.get()
                    dt = time.perf_counter() - t0
                    stats.stall_seconds += dt
                    _STALL.inc(dt)
                    if item is _DONE:
                        break
                    pb, pre = item
                    yield from submit(pb, pre)
                while inflight:
                    finish_oldest()
                drain_walks(0)
                # the producer put(_DONE) after flush_all, so joining
                # here is bounded
                thread.join()
                if errors:
                    raise errors[0]
                for res in ready_chunks():
                    yield res
            finally:
                stop.set()
                thread.join()
        finally:
            if walk_exec is not None:
                # bounded: at most one walk is ever queued on the worker
                walk_exec.shutdown(wait=True)
            stats.wall_seconds += time.perf_counter() - t_run0
