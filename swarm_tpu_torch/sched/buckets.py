"""Padding-bucket batch planner for the continuous-batching scheduler
(the port of ``swarm_tpu/sched/buckets.py``).

Every row in a device batch pays the batch's padded width, so a
chunk-shaped feed leaks time two ways: a single long row drags every
short row up to the cap width, and partial final chunks ship
mostly-padding batches. The planner re-bins incoming rows into a SMALL
FIXED set of (rows × max-stream-length) shapes:

- width classes are multiples of ``width_multiple`` (512 → 1024 →
  1536 → …, capped at the engine's stream caps), keyed by the row's
  body/banner length and header length — the same rounding as the
  port's ``encoding._width_for``, so a bucket's encoded width IS its
  class and each bucket pins exactly one batch shape;
- a bucket flushes when it reaches ``rows_target`` rows (a full,
  width-homogeneous device batch) or at end of stream (the partial
  final flush, which pays padding only once per bucket per scan
  instead of once per chunk);
- memo-known rows never enter width buckets at all — their content
  won't ride the device, so they queue in arrival order and flush as
  lookup-only batches (``kind="memo"``).

The encode path draws its matrices from ``encoding._RotatingPool``
keyed per (rows, width, role) — each bucket shape rotates its own
recycled buffers, so alternating buckets never re-fault fresh pages.
Bucket labels are ``w<body>h<header>`` (``x:`` prefixed for the
interactive QoS lane).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional


def width_class(n: int, multiple: int = 512, cap: int = 4096) -> int:
    """Smallest multiple of ``multiple`` that holds ``n`` bytes, capped
    at ``cap`` (rows past the cap truncate on device and host-redo
    exactly — same contract as encoding). EXACTLY mirrors the port's
    ``encoding._width_for`` for a batch whose longest row is ``n``:
    every row in a bucket has length ≤ the class and > class-multiple
    (for the batch max), so the encoded width IS the class — the
    planned bucket pins the batch shape. (A coarser ladder, e.g.
    powers of two, would NOT pin it: a w2048 bucket whose batch max
    happened to be 1100 would encode at 1536.)"""
    if n <= multiple:
        return multiple
    w = ((n + multiple - 1) // multiple) * multiple
    return min(w, cap)


@dataclasses.dataclass
class PlannedBatch:
    """One scheduler submission: rows + their global ids, in arrival
    order within the batch."""

    # scheduler-global row ids aligned with rows, ascending; a range
    # marks a whole-chunk batch (the speculative steady-state path —
    # the scheduler then adopts results per chunk with no per-row
    # bookkeeping)
    ids: object  # list[int] | range
    rows: list
    bucket: str  # "w<body>h<header>" | "memo" (interactive: "x:" prefix)
    kind: str  # "fresh" | "memo"
    final: bool = False  # end-of-stream partial flush
    #: 'data' mesh-axis size of the engine backend (docs/SHARDING.md):
    #: the engine rounds the padded batch up to a multiple of it, and
    #: fill accounting must charge that mesh padding too
    data_ranks: int = 1
    #: latency class (docs/GATEWAY.md §QoS): interactive batches are
    #: the express lane's small early flushes, bulk is everything else
    qos: str = "bulk"
    #: True when a lapsed deadline (qos_deadline_s / max_age_s) forced
    #: this flush before the bucket filled
    deadline: bool = False
    #: monotonic stamp of the batch's OLDEST row entering the planner
    #: (None on the speculative whole-chunk path, which never waits)
    oldest_ts: Optional[float] = None

    @property
    def fill_rows(self) -> float:
        """Row occupancy of the padded device batch this will become
        (the engine pads unique rows up to a 256 multiple, then up to
        a multiple of the 'data' axis on a mesh backend)."""
        n = len(self.rows)
        padded = max(256, ((n + 255) // 256) * 256)
        r = max(1, int(self.data_ranks))
        padded = ((padded + r - 1) // r) * r
        return n / padded


#: QoS classes a planner bucket can carry (docs/GATEWAY.md §QoS) —
#: interactive buckets coalesce separately from bulk and flush early
#: once their oldest row is ``qos_deadline_s`` old
QOS_BULK = "bulk"
QOS_INTERACTIVE = "interactive"


def _label(key: tuple) -> str:
    """Bucket telemetry label: bulk keeps the pre-QoS ``w<b>h<h>``
    form, interactive buckets prefix ``x:`` (the express lane)."""
    wb, wh, qos = key
    base = f"w{wb}h{wh}"
    return base if qos == QOS_BULK else f"x:{base}"


class BucketPlanner:
    """Stateful binner: ``add_fresh``/``add_known`` return a full
    :class:`PlannedBatch` when a bucket fills; ``flush_due`` drains
    buckets whose deadline lapsed (the express-lane preemption);
    ``flush_all`` drains the partial tails at end of stream. Buckets
    accumulate ACROSS chunk boundaries — that is the continuous-
    batching part; the scheduler re-associates results with chunks
    afterwards. Buckets are keyed per QoS class too, so a small
    interactive flush never carries bulk rows with it."""

    def __init__(
        self,
        rows_target: int = 1024,
        width_multiple: int = 512,
        max_body: int = 4096,
        max_header: int = 1024,
        data_ranks: int = 1,
        qos_deadline_s: float = 0.0,
        max_age_s: float = 0.0,
    ):
        self.data_ranks = max(1, int(data_ranks))
        # mesh-aware placement (docs/SHARDING.md): a full bucket must
        # divide evenly over the 'data' axis so every rank's block is
        # the same share of REAL rows — a 2048-row bucket on an 8-way
        # data axis flushes at 2048 (256 real rows per rank), never at
        # a count that leaves one rank mostly padding
        self.rows_target = max(1, int(rows_target))
        r = self.data_ranks
        self.rows_target = ((self.rows_target + r - 1) // r) * r
        self.width_multiple = width_multiple
        self.max_body = max_body
        self.max_header = max_header
        #: interactive rows older than this force an early partial
        #: flush of their bucket (0 = off; docs/GATEWAY.md §QoS)
        self.qos_deadline_s = float(qos_deadline_s)
        #: max age for ANY bucket — the bulk trickle-tail bound
        #: (0 = off, today's hold-until-flush_all behavior)
        self.max_age_s = float(max_age_s)
        self._fresh: dict = {}  # (wb, wh, qos) -> [ids, rows, first_ts]
        self._memo: dict = {}  # qos -> [ids, rows, first_ts]

    # ------------------------------------------------------------------
    def bucket_of(self, row) -> tuple:
        """(body width class, header width class) — in lockstep with
        ``encoding.encode_batch`` part semantics ("body" is the banner
        when one is set)."""
        blob = row.body if row.banner is None else row.banner
        wb = width_class(len(blob), self.width_multiple, self.max_body)
        wh = width_class(
            len(row.header), self.width_multiple, self.max_header
        )
        return wb, wh

    # ------------------------------------------------------------------
    def add_fresh(
        self, gid: int, row, qos: str = QOS_BULK,
        now: Optional[float] = None,
    ) -> Optional[PlannedBatch]:
        wb, wh = self.bucket_of(row)
        key = (wb, wh, qos)
        slot = self._fresh.get(key)
        if slot is None:
            slot = self._fresh[key] = ([], [], now)
        slot[0].append(gid)
        slot[1].append(row)
        if len(slot[0]) >= self.rows_target:
            del self._fresh[key]
            return PlannedBatch(
                ids=slot[0], rows=slot[1],
                bucket=_label(key), kind="fresh",
                data_ranks=self.data_ranks, qos=qos, oldest_ts=slot[2],
            )
        return None

    def add_known(
        self, gid: int, row, qos: str = QOS_BULK,
        now: Optional[float] = None,
    ) -> Optional[PlannedBatch]:
        slot = self._memo.get(qos)
        if slot is None:
            slot = self._memo[qos] = ([], [], now)
        slot[0].append(gid)
        slot[1].append(row)
        if len(slot[0]) >= self.rows_target:
            del self._memo[qos]
            return PlannedBatch(
                ids=slot[0], rows=slot[1],
                bucket=self._memo_label(qos), kind="memo",
                data_ranks=self.data_ranks, qos=qos, oldest_ts=slot[2],
            )
        return None

    @staticmethod
    def _memo_label(qos: str) -> str:
        return "memo" if qos == QOS_BULK else "x:memo"

    # ------------------------------------------------------------------
    def _due(self, slot, qos: str, now: float) -> bool:
        first_ts = slot[2]
        if first_ts is None:
            return False
        age = now - first_ts
        if (
            qos == QOS_INTERACTIVE
            and self.qos_deadline_s > 0
            and age >= self.qos_deadline_s
        ):
            return True
        return self.max_age_s > 0 and age >= self.max_age_s

    def flush_due(self, now: float) -> Iterator[PlannedBatch]:
        """Deadline-forced partial flushes (docs/GATEWAY.md §QoS,
        docs/PIPELINE.md): an interactive bucket whose oldest row is
        ``qos_deadline_s`` old flushes NOW as a small express batch —
        the scheduler's in-flight window lets it ride the device ahead
        of further coalescing without draining bulk batches already in
        flight. With ``max_age_s`` set, bulk buckets get the same
        treatment (the trickling-scan tail bound); by default they
        keep waiting for ``flush_all``."""
        for key in [
            k for k, s in self._fresh.items() if self._due(s, k[2], now)
        ]:
            ids, rows, first_ts = self._fresh.pop(key)
            yield PlannedBatch(
                ids=ids, rows=rows, bucket=_label(key), kind="fresh",
                data_ranks=self.data_ranks, qos=key[2], deadline=True,
                oldest_ts=first_ts,
            )
        for qos in [
            q for q, s in self._memo.items() if self._due(s, q, now)
        ]:
            ids, rows, first_ts = self._memo.pop(qos)
            yield PlannedBatch(
                ids=ids, rows=rows, bucket=self._memo_label(qos),
                kind="memo", data_ranks=self.data_ranks, qos=qos,
                deadline=True, oldest_ts=first_ts,
            )

    # ------------------------------------------------------------------
    def flush_all(self) -> Iterator[PlannedBatch]:
        """Drain every partial bucket (end of stream). Interactive
        tails first (they are latency-bound even here), then bulk
        fresh tails largest-first so the widest compiled shape warms
        before narrower ones reuse its row-pad class."""
        for key in sorted(
            self._fresh,
            key=lambda k: (k[2] != QOS_INTERACTIVE, -k[0], -k[1]),
        ):
            ids, rows, first_ts = self._fresh.pop(key)
            yield PlannedBatch(
                ids=ids, rows=rows,
                bucket=_label(key), kind="fresh", final=True,
                data_ranks=self.data_ranks, qos=key[2],
                oldest_ts=first_ts,
            )
        for qos in list(self._memo):
            ids, rows, first_ts = self._memo.pop(qos)
            yield PlannedBatch(
                ids=ids, rows=rows,
                bucket=self._memo_label(qos), kind="memo", final=True,
                data_ranks=self.data_ranks, qos=qos, oldest_ts=first_ts,
            )

    # ------------------------------------------------------------------
    def occupancy(self) -> dict:
        """bucket label -> rows currently pending (telemetry gauge)."""
        out = {_label(k): len(v[0]) for k, v in self._fresh.items()}
        for qos, slot in self._memo.items():
            if slot[0]:
                out[self._memo_label(qos)] = len(slot[0])
        return out

    @property
    def pending_rows(self) -> int:
        return sum(len(v[0]) for v in self._fresh.values()) + sum(
            len(v[0]) for v in self._memo.values()
        )
