"""Durable change feed: record blobs, epoch marks, resumable NDJSON
streaming (docs/MONITORING.md §Feed resume contract).

The port's copy of ``swarm_tpu/monitor/feed.py``: the same logic,
records, keys and bytes.

Diff records are ordinary blobs —
``_monitor/<id>/feed/e<epoch:08>.<idx:06>.json`` — so the feed rides
whatever durability the blob store already has: a server restart loses
nothing, and ``GET /monitor-feed`` resume is "re-list, skip the first
N keys", the same shape as scan-output streaming.

Each completed epoch also writes a MARK blob
(``_monitor/<id>/mark/e<epoch:08>.json``) *after* its records and its
plane update. The mark is the commit point: an epoch with records but
no mark was interrupted and will be re-run — deterministically, so the
re-run rewrites byte-identical record blobs (no duplicates, no gaps in
``seq``). Zero-change epochs write only the mark, which is how cadence
progress stays observable on an unchanged fleet.

Record ``seq`` equals the record's position in the key-sorted feed
(epochs zero-padded so string order is epoch order), which makes the
cursor trivially stable across disconnects AND restarts.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterator, Optional

#: blob-key namespace; underscore prefix keeps it disjoint from scan-id
#: keys (SCAN_ID_RE admits no leading context, but scan blob keys start
#: with the scan id, which cannot begin a ``_monitor/`` path)
FEED_PREFIX = "_monitor"


def feed_prefix(monitor_id: str) -> str:
    return f"{FEED_PREFIX}/{monitor_id}/feed/"


def record_key(monitor_id: str, epoch: int, idx: int) -> str:
    return f"{feed_prefix(monitor_id)}e{epoch:08d}.{idx:06d}.json"


def mark_key(monitor_id: str, epoch: int) -> str:
    return f"{FEED_PREFIX}/{monitor_id}/mark/e{epoch:08d}.json"


def _key_epoch(monitor_id: str, key: str) -> Optional[int]:
    name = key[len(feed_prefix(monitor_id)):]
    try:
        return int(name[1:9])
    except (ValueError, IndexError):
        return None


# ----------------------------------------------------------------------
def epoch_marked(blobs, monitor_id: str, epoch: int) -> bool:
    return blobs.exists(mark_key(monitor_id, epoch))


def marked_epochs(blobs, monitor_id: str) -> list:
    out = []
    prefix = f"{FEED_PREFIX}/{monitor_id}/mark/"
    for key in blobs.list(prefix):
        name = key[len(prefix):]
        try:
            out.append(int(name[1:9]))
        except (ValueError, IndexError):
            continue
    return sorted(out)


def seq_base(blobs, monitor_id: str, epoch: int) -> int:
    """Records in epochs strictly before ``epoch`` — the first seq of
    this epoch. Counting by epoch (not raw blob count) keeps a re-run
    of a crash-interrupted epoch at the same base even when some of its
    own record blobs already landed."""
    n = 0
    for key in blobs.list(feed_prefix(monitor_id)):
        ep = _key_epoch(monitor_id, key)
        if ep is not None and ep < epoch:
            n += 1
    return n


def feed_records(
    blobs, monitor_id: str, marked_only: bool = False
) -> list:
    """All feed records, oldest first. ``marked_only`` restricts to
    completed epochs — the form plane rebuilds fold over."""
    marks = set(marked_epochs(blobs, monitor_id)) if marked_only else None
    out = []
    for key in blobs.list(feed_prefix(monitor_id)):
        if marks is not None:
            ep = _key_epoch(monitor_id, key)
            if ep is None or ep not in marks:
                continue
        try:
            out.append(json.loads(blobs.get(key)))
        except (FileNotFoundError, KeyError, ValueError):
            continue
    return out


def write_records(blobs, monitor_id: str, records) -> None:
    """Persist one epoch's record blobs (idempotent: deterministic
    content under deterministic keys — a re-run overwrites with the
    same bytes)."""
    from swarm_tpu_torch.monitor.diff import encode_record

    for idx, rec in enumerate(records):
        blobs.put(
            record_key(monitor_id, int(rec["epoch"]), idx), encode_record(rec)
        )


def write_mark(
    blobs, monitor_id: str, epoch: int, n_records: int, scan_id: str
) -> None:
    """Commit the epoch. Callers MUST order: records → plane → mark."""
    blobs.put(
        mark_key(monitor_id, epoch),
        json.dumps(
            {"epoch": epoch, "records": n_records, "scan_id": scan_id},
            separators=(",", ":"),
        ).encode("utf-8"),
    )


# ----------------------------------------------------------------------
def stream_feed(
    blobs,
    monitor_id: str,
    from_seq: int = 0,
    poll_s: float = 0.1,
    idle_timeout_s: float = 300.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    alive: Optional[Callable[[], bool]] = None,
) -> Iterator[bytes]:
    """Ordered NDJSON over the feed from cursor ``from_seq``, then
    long-poll for more — the monitor twin of ``gateway.streaming
    .stream_scan``. Every data line is a stored record verbatim; the
    terminal control line is either ``{"event":"timeout","next_seq":N}``
    (idle too long — reconnect with ``?from=N`` to resume losslessly)
    or ``{"event":"end","next_seq":N}`` (the monitor was removed and
    the feed is fully drained). A feed has no natural end otherwise:
    standing monitors emit forever."""
    cursor = max(0, int(from_seq))
    last_progress = clock()
    while True:
        keys = blobs.list(feed_prefix(monitor_id))
        if cursor < len(keys):
            progressed = False
            for key in keys[cursor:]:
                try:
                    raw = blobs.get(key)
                except (FileNotFoundError, KeyError):
                    break  # racing writer: re-list and retry
                yield raw if raw.endswith(b"\n") else raw + b"\n"
                cursor += 1
                progressed = True
            if progressed:
                last_progress = clock()
                continue
        if alive is not None and not alive():
            yield (
                json.dumps(
                    {"event": "end", "next_seq": cursor},
                    separators=(",", ":"),
                ).encode("utf-8")
                + b"\n"
            )
            return
        if clock() - last_progress >= idle_timeout_s:
            yield (
                json.dumps(
                    {"event": "timeout", "next_seq": cursor},
                    separators=(",", ":"),
                ).encode("utf-8")
                + b"\n"
            )
            return
        sleep(poll_s)
