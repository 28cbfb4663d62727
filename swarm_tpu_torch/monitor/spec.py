"""Monitor spec model: the durable unit of the monitoring control
plane (docs/MONITORING.md §Spec model).

The port's copy of ``swarm_tpu/monitor/spec.py``: the same logic,
records, keys and bytes.

A spec is a plain wire dict everywhere it moves — journal records,
state-store hash entries, HTTP bodies — and a :class:`MonitorSpec`
dataclass wherever code reasons about it. The wire form follows the
``Job`` discipline: unknown keys are ignored on read, absent keys get
defaults, so specs journaled by an older server replay cleanly on a
newer one.

Cadence state (``epoch``, ``next_fire_at``, ``last_scan_id``,
``refire``) lives ON the spec rather than beside it so a single
journal record captures both the schedule and its progress — kill-9
recovery reads one hash and knows exactly which epoch fired last and
when the next one is owed.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

from swarm_tpu_torch.datamodel import SCAN_ID_RE

#: monitor ids are a strict subset of scan-id grammar (no dots) so the
#: derived epoch scan id ``<monitor_id>.e<epoch>_<ts>`` still matches
#: SCAN_ID_RE and ``parse_scan_id`` splits its timestamp cleanly
MONITOR_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")

#: floor on the rescan cadence — protects the queue from a zero/negative
#: interval turning a monitor into a tight submission loop
MIN_INTERVAL_S = 0.05


@dataclasses.dataclass
class MonitorSpec:
    """One standing rescan: WHAT to scan (module + targets), AS WHOM
    (tenant + qos), HOW OFTEN (interval), plus journaled cadence
    progress. ``targets`` are raw target lines exactly as a one-shot
    ``POST /queue-scan`` file body would carry them."""

    monitor_id: str
    module: str
    targets: list
    interval_s: float
    tenant: str = "default"
    qos: Optional[str] = None  # None = bulk, the standing-workload default
    batch_size: int = 0  # 0 = server default, same contract as submissions
    paused: bool = False
    created_at: float = 0.0
    # --- cadence progress (mutated only through the journal) ---
    epoch: int = 0  # last epoch FIRED (0 = never)
    next_fire_at: float = 0.0  # 0 = due immediately
    last_scan_id: Optional[str] = None
    # set by recovery when the last epoch was journaled but its scan
    # never materialized (kill-9 between append and fire): the next
    # tick re-fires the SAME epoch under the SAME scan id, once, late
    refire: bool = False

    # ------------------------------------------------------------------
    def validate(self) -> Optional[str]:
        """Problem description, or None when the spec is well-formed."""
        if not MONITOR_ID_RE.match(self.monitor_id or ""):
            return "monitor_id must match [A-Za-z0-9_-]{1,64}"
        if not self.module or not SCAN_ID_RE.match(self.module):
            return "module is required"
        if not isinstance(self.targets, list) or not self.targets:
            return "targets must be a non-empty list"
        if not all(isinstance(t, str) for t in self.targets):
            return "targets must be strings"
        if not isinstance(self.interval_s, (int, float)) or (
            self.interval_s < MIN_INTERVAL_S
        ):
            return f"interval_s must be >= {MIN_INTERVAL_S}"
        if self.batch_size < 0:
            return "batch_size must be >= 0"
        return None

    def scan_id_for(self, epoch: int, now: Optional[float] = None) -> str:
        """Deterministic-per-fire scan id: ``<id>.e<epoch>_<ts>``.
        Recovery re-fires use the JOURNALED id (``last_scan_id``), not
        a fresh one, so a re-fired epoch lands on the same blobs."""
        ts = int(now if now is not None else time.time())
        return f"{self.monitor_id}.e{epoch}_{ts}"

    def due(self, now: float) -> bool:
        return (not self.paused) and now >= self.next_fire_at

    # --- wire round trip (journal / state store / HTTP) ---------------
    def to_wire(self) -> dict:
        return {
            "monitor_id": self.monitor_id,
            "module": self.module,
            "targets": list(self.targets),
            "interval_s": float(self.interval_s),
            "tenant": self.tenant,
            "qos": self.qos,
            "batch_size": int(self.batch_size),
            "paused": bool(self.paused),
            "created_at": float(self.created_at),
            "epoch": int(self.epoch),
            "next_fire_at": float(self.next_fire_at),
            "last_scan_id": self.last_scan_id,
            "refire": bool(self.refire),
        }

    @classmethod
    def from_wire(cls, data: dict) -> "MonitorSpec":
        """Lenient read: unknown keys ignored, absent keys defaulted —
        the same forward/backward tolerance as ``Job.from_wire``."""
        return cls(
            monitor_id=str(data.get("monitor_id") or ""),
            module=str(data.get("module") or ""),
            targets=list(data.get("targets") or []),
            interval_s=float(data.get("interval_s") or 0.0),
            tenant=str(data.get("tenant") or "default"),
            qos=data.get("qos") or None,
            batch_size=int(data.get("batch_size") or 0),
            paused=bool(data.get("paused")),
            created_at=float(data.get("created_at") or 0.0),
            epoch=int(data.get("epoch") or 0),
            next_fire_at=float(data.get("next_fire_at") or 0.0),
            last_scan_id=data.get("last_scan_id") or None,
            refire=bool(data.get("refire")),
        )
