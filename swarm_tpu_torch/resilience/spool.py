"""Disk spool for completed output chunks, the port of
``swarm_tpu/resilience/spool.py``.

When the server is unreachable at upload time the worker has already
paid for the chunk's work; dropping the bytes wastes it and forces a
second execution after the lease expires. The spool keeps the finished
chunk (payload and completion fields) and replays it on the next
successful contact with the server:

- ``put_output_chunk`` overwrites the same blob key, and the completion
  update carries the worker's fencing token — if the lease expired and
  the job was re-leased elsewhere, the queue refuses the stale
  completion and the entry is dropped (the new assignee redid the
  work). Replaying an entry twice is therefore a no-op;
- entries survive worker restarts (files under the spool's root).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

from swarm_tpu_torch.resilience.transport import TransportError
from swarm_tpu_torch.telemetry import REGISTRY, emit_event

_SPOOLED = REGISTRY.counter(
    "swarm_resilience_spooled_chunks_total",
    "Completed output chunks spooled to disk (server unreachable)",
)
_REPLAYED = REGISTRY.counter(
    "swarm_resilience_spool_replayed_total",
    "Spool replay outcomes",
    ("outcome",),
)


class OutputSpool:
    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        #: chunks spooled, and replay outcomes, by this instance
        self.spooled = 0
        self.replayed = {"completed": 0, "fenced": 0, "deferred": 0}

    def put(
        self,
        job_id: str,
        scan_id: str,
        chunk_index: int,
        worker_id: str,
        data: bytes,
        perf: Optional[dict] = None,
    ) -> None:
        """Persist one finished chunk. Data first, then meta — a replay
        only trusts entries whose meta file exists, so a crash mid-put
        leaves no half entry visible."""
        (self.root / f"{job_id}.bin").write_bytes(data)
        meta = {
            "job_id": job_id,
            "scan_id": scan_id,
            "chunk_index": int(chunk_index),
            "worker_id": worker_id,
            "perf": perf,
            "spooled_at": time.time(),
        }
        (self.root / f"{job_id}.json").write_text(json.dumps(meta))
        self.spooled += 1
        _SPOOLED.inc()

    def entries(self) -> list[dict]:
        """Spooled entries in (scan_id, chunk_index) order: numeric
        chunk order (a lexical file-name sort puts ``scan_10`` before
        ``scan_2``), so two replays of one spool reach the server in
        the same sequence."""
        out = []
        for meta_path in sorted(self.root.glob("*.json")):
            try:
                out.append(json.loads(meta_path.read_text()))
            except (ValueError, OSError):
                continue
        return sorted(
            out,
            key=lambda m: (
                str(m.get("scan_id") or ""),
                int(m.get("chunk_index") or 0),
            ),
        )

    def __len__(self) -> int:
        return len(list(self.root.glob("*.json")))

    def _drop(self, job_id: str) -> None:
        for suffix in (".json", ".bin"):
            try:
                (self.root / f"{job_id}{suffix}").unlink()
            except FileNotFoundError:
                pass

    def replay(self, client, status_complete: str = "complete") -> int:
        """Push every spooled chunk through ``client`` in per-scan
        chunk order → the number of entries cleared. Stops early on
        TransportError (the server went away again — the rest stay for
        next time). Prints one summary line per scan, so an operator can
        reconcile what the spool replayed."""
        cleared = 0
        per_scan: dict[str, dict[str, list[int]]] = {}
        for meta in self.entries():
            job_id = meta["job_id"]
            data_path = self.root / f"{job_id}.bin"
            try:
                data = data_path.read_bytes()
            except OSError:
                self._drop(job_id)  # orphan meta: nothing to upload
                continue
            try:
                # ownership probe BEFORE touching the blob: renewing the
                # lease succeeds only while the job is still ours — a
                # re-leased or terminal job must not have its stored
                # chunk overwritten with our stale bytes. A successful
                # renewal also covers the replay against expiry.
                ok = client.renew_lease(job_id, meta.get("worker_id"))
                if ok:
                    ok = client.put_output_chunk(
                        meta["scan_id"], meta["chunk_index"], data
                    )
                if ok:
                    # the fencing token rides along: a re-leased job's
                    # record refuses this stale completion (False) and
                    # the entry is dropped — the new assignee owns it
                    changes = {"status": status_complete}
                    if meta.get("perf"):
                        changes["perf"] = meta["perf"]
                    ok = client.update_job(
                        job_id, changes, worker_id=meta.get("worker_id")
                    )
            except TransportError:
                self.replayed["deferred"] += 1
                _REPLAYED.labels(outcome="deferred").inc()
                break
            self._drop(job_id)
            cleared += 1
            outcome = "completed" if ok else "fenced"
            self.replayed[outcome] += 1
            _REPLAYED.labels(outcome=outcome).inc()
            per_scan.setdefault(
                str(meta.get("scan_id")), {"completed": [], "fenced": []}
            )[outcome].append(int(meta.get("chunk_index") or 0))
        for scan_id in sorted(per_scan):
            summary = per_scan[scan_id]
            print(
                f"spool replay [{scan_id}]: "
                f"completed chunks {summary['completed']}, "
                f"fenced chunks {summary['fenced']}"
            )
            emit_event(
                "spool.scan_replayed",
                scan_id=scan_id,
                completed=summary["completed"],
                fenced=summary["fenced"],
            )
        return cleared
