"""Durable queue journal: write-ahead log + snapshots in the blob store.

The port's copy of ``swarm_tpu/server/journal.py``: the same keys,
records and bytes, so each package replays the other's journal.

The control plane's job table, tenant dispatch lists, attempt counts,
dead-letter history and RR cursor live in a ``MemoryStateStore`` by
default — a ``kill -9`` on the server would orphan every queued and
in-flight job while workers kept scanning into the void (the reference
lost state the same way; the worker side has its own spool).
This module is the server-side fix (docs/DURABILITY.md):

- **Append-only WAL segments**: every queue mutation is serialized as
  one JSON record and written — *before* the state store is touched,
  and therefore before the client's 200 — as a segment blob
  ``_journal/seg/<seq>.jsonl``. Blob puts are crash-atomic
  (``LocalBlobStore`` writes temp + rename), so a segment either
  exists whole or not at all; an admitted job is never unjournaled.
- **Snapshots**: a checkpoint folds the full queue state into
  ``_journal/snap/<seq>.json`` and prunes the segments it covers.
  Replay = latest snapshot + segments with a later sequence number.
  A crash between the snapshot write and the prune leaves stale
  segments behind; the sequence filter skips them, so compaction is
  crash-safe at every step.
- **Generation**: ``_journal/generation`` holds a monotonic counter
  bumped once per journal-enabled boot. It rides the
  ``X-Swarm-Generation`` header so workers can tell "the server I'm
  talking to forgot nothing" from "the control plane restarted and
  recovered" (worker re-registration, docs/DURABILITY.md).

The journal deliberately uses the *existing* store roles: on the
embedded deployment it lands next to the chunk blobs on disk; on S3 it
is just more keys in the bucket. One writer at a time is assumed — the
single C2 server process — which is the same assumption the dispatch
lock already makes.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator, Optional

from swarm_tpu_torch.resilience.faults import fault_point
from swarm_tpu_torch.stores import BlobStore
from swarm_tpu_torch.telemetry.journal_export import (
    JOURNAL_APPENDS,
    JOURNAL_COMPACTIONS,
    JOURNAL_CORRUPT,
    JOURNAL_SEGMENTS,
)

#: zero-padded sequence width: blob listings sort lexically, so the
#: numeric replay order must survive string sorting
_SEQ_DIGITS = 12


class JournalError(RuntimeError):
    """A journal append/replay/compact failure. On the append path the
    caller (queue service) lets it propagate: the route 500s and the
    client retries — an unjournaled mutation is never acked."""


class QueueJournal:
    """Write-ahead journal over a :class:`BlobStore`.

    Thread-safe: sequence allocation and checkpoint bookkeeping run
    under one lock; the blob writes themselves happen outside it
    (distinct keys — replay order is the *sequence* order, which is
    assigned under the lock, and per-job mutation order is already
    serialized by the queue's dispatch lock).
    """

    PREFIX = "_journal"

    def __init__(
        self,
        blobs: BlobStore,
        prefix: str = PREFIX,
        compact_segments: int = 512,
    ):
        self.blobs = blobs
        self.prefix = prefix.rstrip("/")
        self.compact_segments = max(2, int(compact_segments))
        self._lock = threading.Lock()  # guards: _next_seq, _snap_seq, _segments
        # boot-time discovery: resume the sequence after the highest
        # existing segment/snapshot so a restarted writer never reuses
        # (and silently shadows) a predecessor's sequence number
        snap_seq = self._latest_snapshot_seq()
        seg_seqs = self._segment_seqs()
        self._snap_seq = snap_seq  # guarded-by: _lock
        self._segments = len([s for s in seg_seqs if s > (snap_seq or -1)])  # guarded-by: _lock
        self._next_seq = max([snap_seq or 0] + seg_seqs + [0]) + 1  # guarded-by: _lock
        JOURNAL_SEGMENTS.set(self._segments)

    # ------------------------------------------------------------------
    # Key layout
    # ------------------------------------------------------------------
    def _seg_key(self, seq: int) -> str:
        return f"{self.prefix}/seg/{seq:0{_SEQ_DIGITS}d}.jsonl"

    def _snap_key(self, seq: int) -> str:
        return f"{self.prefix}/snap/{seq:0{_SEQ_DIGITS}d}.json"

    @property
    def _gen_key(self) -> str:
        return f"{self.prefix}/generation"

    @staticmethod
    def _seq_of(key: str) -> Optional[int]:
        stem = key.rsplit("/", 1)[-1].split(".", 1)[0]
        try:
            return int(stem)
        except ValueError:
            return None

    def _segment_seqs(self) -> list[int]:
        return sorted(
            s
            for s in (
                self._seq_of(k) for k in self.blobs.list(f"{self.prefix}/seg/")
            )
            if s is not None
        )

    def _latest_snapshot_seq(self) -> Optional[int]:
        seqs = [
            s
            for s in (
                self._seq_of(k) for k in self.blobs.list(f"{self.prefix}/snap/")
            )
            if s is not None
        ]
        return max(seqs) if seqs else None

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------
    def append(self, record: dict) -> None:
        self.append_many([record])

    def append_many(self, records: list[dict]) -> None:
        """Persist one WAL segment holding ``records`` (in order).

        Ordering invariant (append-before-ack): callers invoke this
        BEFORE mutating the state store, so the journal is always a
        superset of the store and a crash at any point leaves either
        "mutation journaled" or "mutation never happened" — never a
        stored-but-unjournaled job. A failure raises (wrapped as
        :class:`JournalError` unless it already is one) and the caller
        must NOT apply the mutation.
        """
        if not records:
            return
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        data = b"".join(
            json.dumps(r, separators=(",", ":")).encode() + b"\n"
            for r in records
        )
        try:
            # chaos lever (docs/RESILIENCE.md): a failing append must
            # surface as a 500 from the mutating route, never as a
            # silently-acked-but-unjournaled mutation
            fault_point("journal.append", detail=records[0].get("op"))
            self.blobs.put(self._seg_key(seq), data)
        except Exception as e:
            raise JournalError(f"journal append failed: {e}") from e
        with self._lock:
            self._segments += 1
            segments = self._segments
        for r in records:
            JOURNAL_APPENDS.labels(op=str(r.get("op") or "job")).inc()
        JOURNAL_SEGMENTS.set(segments)

    # ------------------------------------------------------------------
    # Replay path
    # ------------------------------------------------------------------
    def has_state(self) -> bool:
        """True when a snapshot or any WAL segment exists."""
        return (
            self._latest_snapshot_seq() is not None
            or bool(self._segment_seqs())
        )

    def replay(self) -> tuple[Optional[dict], Iterator[dict]]:
        """Return ``(snapshot, records)``: the latest snapshot payload
        (or None) and an iterator over every WAL record with a sequence
        number past it, in append order. Unparseable records are
        counted (``swarm_journal_corrupt_records_total``) and skipped —
        see the corrupt-journal runbook in docs/DURABILITY.md."""
        fault_point("journal.replay")
        snap_seq = self._latest_snapshot_seq()
        snapshot: Optional[dict] = None
        if snap_seq is not None:
            try:
                snapshot = json.loads(self.blobs.get(self._snap_key(snap_seq)))
            except (ValueError, KeyError, FileNotFoundError, OSError):
                # damaged snapshot: fall back to full-WAL replay of
                # whatever segments survive (runbook case)
                JOURNAL_CORRUPT.inc()
                snapshot = None
                snap_seq = None

        def _records() -> Iterator[dict]:
            for seq in self._segment_seqs():
                if snap_seq is not None and seq <= snap_seq:
                    continue  # compaction crashed before the prune
                try:
                    raw = self.blobs.get(self._seg_key(seq))
                except (KeyError, FileNotFoundError, OSError):
                    continue
                for line in raw.splitlines():
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        JOURNAL_CORRUPT.inc()
                        continue
                    if isinstance(rec, dict):
                        yield rec
                    else:
                        JOURNAL_CORRUPT.inc()

        return snapshot, _records()

    # ------------------------------------------------------------------
    # Checkpoint / compaction
    # ------------------------------------------------------------------
    @property
    def segments_pending(self) -> int:
        with self._lock:
            return self._segments

    # orders: blobs.put < blobs.delete (snapshot durably lands before the segments it covers are pruned)
    def checkpoint(self, state: dict) -> int:
        """Fold ``state`` (the full queue state, journal-format) into a
        snapshot and prune the WAL segments it covers. Crash-safe:
        snapshot first, prune after — leftovers are skipped by replay's
        sequence filter. Returns the snapshot's sequence number."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        try:
            fault_point("journal.compact")
            self.blobs.put(
                self._snap_key(seq),
                json.dumps(state, separators=(",", ":")).encode(),
            )
        except Exception as e:
            raise JournalError(f"journal checkpoint failed: {e}") from e
        JOURNAL_APPENDS.labels(op="checkpoint").inc()
        # prune: segments covered by the new snapshot, then superseded
        # snapshots (best-effort — a failure here only leaves garbage
        # that the next successful checkpoint removes)
        for s in self._segment_seqs():
            if s < seq:
                self.blobs.delete(self._seg_key(s))
        for key in self.blobs.list(f"{self.prefix}/snap/"):
            s = self._seq_of(key)
            if s is not None and s < seq:
                self.blobs.delete(self._snap_key(s))
        with self._lock:
            self._snap_seq = seq
            self._segments = 0
        JOURNAL_COMPACTIONS.inc()
        JOURNAL_SEGMENTS.set(0)
        return seq

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------
    def generation(self) -> int:
        try:
            return int(self.blobs.get(self._gen_key).decode().strip())
        except (KeyError, FileNotFoundError, OSError, ValueError):
            return 0

    def bump_generation(self) -> int:
        """Advance the monotonic server generation (once per boot).
        Single-writer by assumption: exactly one C2 server owns a
        journal prefix at a time."""
        gen = self.generation() + 1
        self.blobs.put(self._gen_key, str(gen).encode())
        return gen

    # ------------------------------------------------------------------
    def clear(self) -> None:
        """Drop every segment and snapshot (``/reset``). The generation
        counter survives — resets are operational events, not new
        server identities."""
        for key in self.blobs.list(f"{self.prefix}/seg/") + self.blobs.list(
            f"{self.prefix}/snap/"
        ):
            self.blobs.delete(key)
        with self._lock:
            self._snap_seq = None
            self._segments = 0
        JOURNAL_SEGMENTS.set(0)
