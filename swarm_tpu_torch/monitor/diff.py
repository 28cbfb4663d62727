"""Verdict-diff engine: per-target planes, epoch deltas, deterministic
records (docs/MONITORING.md §Diff records).

The port's copy of ``swarm_tpu/monitor/diff.py``: the same logic,
records, keys and bytes.

Each epoch the engine holds two things: the PRIOR plane — one
``{"v": verdict, "fs": first_seen_epoch}`` entry per target that
currently has a finding — and the CURRENT epoch's extracted verdicts.
The delta between them is the entire feed output: unchanged targets
produce nothing, which is what makes a 95%-unchanged fleet's rescan
cost a cache lookup instead of a report.

Determinism is the load-bearing property. ``diff_epoch`` is a pure
function of (prior plane, current verdicts, target order), record
``seq`` numbers are positional, and JSON key order is fixed — so a
crash-interrupted epoch re-run rewrites byte-identical record blobs
(idempotent recovery, no duplicate or lost records) and a brute-force
replay over the stored outputs reproduces the feed exactly (what
``chip_smoke.py``'s ``monitor`` phase checks on the card).

Planes persist through the shared result tier under family ``"m"``
(fenced, epoch-scoped per monitor) with the change feed itself as the
authoritative rebuild source: folding every *marked* epoch's records
reconstructs the plane from nothing, which is exactly what recovery
and cold-tier starts do.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Optional, Sequence

from swarm_tpu_torch.cache.tier import (
    SharedResultTier,
    _FORMAT,
    _lp,
    _process_token,
)
from swarm_tpu_torch.gateway.qoscache import split_output_segments

#: tier value family for monitor verdict planes ("v" = verdict planes,
#: "c" = confirm verdicts, "g" = gateway scan entries — docs/CACHING.md)
FAMILY = "m"


def target_digest(module: str, target: str) -> str:
    """Content address of one (module, target) verdict-plane entry —
    same length-prefixed discipline as every other tier key."""
    out = bytearray(_FORMAT)
    _lp(out, b"montarget")
    _lp(out, module.encode("utf-8", "surrogateescape"))
    _lp(out, target.encode("utf-8", "surrogateescape"))
    return hashlib.sha256(bytes(out)).hexdigest()


def _index_digest(monitor_id: str) -> str:
    """Per-monitor plane index entry: which targets currently hold a
    finding, and through which epoch the plane is valid."""
    out = bytearray(_FORMAT)
    _lp(out, b"monindex")
    _lp(out, monitor_id.encode("utf-8", "surrogateescape"))
    return hashlib.sha256(bytes(out)).hexdigest()


# ----------------------------------------------------------------------
def extract_verdicts(
    chunks: Sequence[Sequence[str]],
    outputs: dict,
) -> dict:
    """Per-target verdict text from a completed epoch's chunk outputs.

    ``outputs`` maps chunk offset -> raw output bytes; offsets with no
    output (failed / dead-lettered chunks) contribute no verdicts, so
    their targets keep the prior epoch's state rather than flapping.
    When a chunk's output carries exactly one line per input target the
    verdict is that target's line; otherwise the whole chunk output is
    the coarse verdict for each of its targets (still deterministic,
    just chunk-granular). Duplicate targets keep the first occurrence.
    """
    verdicts: dict = {}
    for offset, chunk in enumerate(chunks):
        raw = outputs.get(offset)
        if raw is None:
            continue
        segments = split_output_segments(raw, len(chunk))
        for i, target in enumerate(chunk):
            if target in verdicts:
                continue
            seg = segments[i] if segments is not None else raw
            text = seg.decode("utf-8", "surrogateescape")
            if text.endswith("\n"):
                text = text[:-1]
            verdicts[target] = text
    return verdicts


def diff_epoch(
    monitor_id: str,
    epoch: int,
    prev_plane: dict,
    verdicts: dict,
    target_order: Sequence[str],
    seq_base: int,
) -> tuple[list, dict]:
    """Pure epoch delta: ``(records, next_plane)``.

    Record order is fixed — spec-order for targets still in the spec,
    then lexicographic for targets that left it — and ``seq`` is
    ``seq_base + position``, so identical inputs always yield
    byte-identical records (the idempotent-recovery contract).

    An empty verdict means "no finding": empty-on-first-sight emits
    nothing, empty-after-a-finding emits ``resolved`` and drops the
    plane entry (a later reappearance is ``new`` again with a fresh
    ``first_seen``).
    """
    next_plane = dict(prev_plane)
    seen: set = set()
    order: list = []
    for t in target_order:
        if t not in seen:
            seen.add(t)
            order.append(t)
    staged: list = []  # (kind, target, verdict, prev, first_seen)
    for t in order:
        if t not in verdicts:
            continue  # no output this epoch: carry prior state, no record
        v = verdicts[t]
        prior = prev_plane.get(t)
        if prior is None:
            if v == "":
                continue
            staged.append(("new", t, v, "", epoch))
            next_plane[t] = {"v": v, "fs": epoch}
        elif v == "":
            staged.append(("resolved", t, "", prior["v"], prior["fs"]))
            next_plane.pop(t, None)
        elif v != prior["v"]:
            staged.append(("changed", t, v, prior["v"], prior["fs"]))
            next_plane[t] = {"v": v, "fs": prior["fs"]}
    for t in sorted(t for t in prev_plane if t not in seen):
        prior = prev_plane[t]
        staged.append(("resolved", t, "", prior["v"], prior["fs"]))
        next_plane.pop(t, None)
    records = [
        {
            "seq": seq_base + i,
            "monitor_id": monitor_id,
            "epoch": epoch,
            "kind": kind,
            "target": t,
            "verdict": v,
            "prev": prev,
            "first_seen": fs,
            "last_seen": epoch,
        }
        for i, (kind, t, v, prev, fs) in enumerate(staged)
    ]
    return records, next_plane


def encode_record(record: dict) -> bytes:
    """The canonical NDJSON line: compact separators, insertion key
    order — the byte form stored in the feed AND sent on the wire."""
    return json.dumps(record, separators=(",", ":")).encode("utf-8") + b"\n"


def plane_from_records(records) -> dict:
    """Fold feed records (oldest first) back into a plane — the
    brute-force inverse of ``diff_epoch``, used for cold-tier rebuilds
    and crash re-runs. Only pass records of MARKED (completed) epochs:
    a crash-interrupted epoch's partial records must not leak into the
    prior plane its re-run diffs against."""
    plane: dict = {}
    for rec in records:
        if rec.get("kind") == "resolved":
            plane.pop(rec.get("target"), None)
        else:
            plane[rec["target"]] = {
                "v": rec["verdict"],
                "fs": rec["first_seen"],
            }
    return plane


# ----------------------------------------------------------------------
class MonitorPlaneStore:
    """Tier adapter for monitor verdict planes: fenced, epoch-scoped
    per monitor (``mon.g<generation>.<monitor_id>``), fail-open — a
    dead or cold tier degrades to the feed-rebuild path, never to an
    error. Thread contract mirrors ``GatewayScanCache``: bind state
    under ``_lock``, tier IO outside it."""

    _EPOCH_TTL_S = 60.0

    def __init__(self, tier: Optional[SharedResultTier], writer_id: str = "monitor"):
        self._tier = tier
        self._writer = f"mon:{writer_id}"
        self._lock = threading.Lock()  # guards: _gen, _gen_read_at, _token
        self._gen: Optional[int] = None
        self._gen_read_at = 0.0
        self._token: Optional[int] = None

    def _ensure_bound(self) -> Optional[tuple[int, int]]:
        import time

        if self._tier is None:
            return None
        now = time.monotonic()
        with self._lock:
            if (
                self._gen is not None
                and self._token is not None
                and now - self._gen_read_at < self._EPOCH_TTL_S
            ):
                return self._gen, self._token
        try:
            gen = self._tier.epoch_generation()
            token = _process_token(self._tier, self._writer)
        except Exception:
            return None
        with self._lock:
            self._gen = gen
            self._gen_read_at = now
            self._token = token
        return gen, token

    @staticmethod
    def _epoch_ns(gen: int, monitor_id: str) -> str:
        return f"mon.g{gen}.{monitor_id}"

    def load(self, monitor_id: str, module: str) -> Optional[tuple[dict, int]]:
        """``(plane, plane_epoch)`` from the tier, or None when cold /
        unreachable / partially evicted — the caller rebuilds from the
        feed instead. ~Two batched reads per epoch (index + entries):
        the whole steady-state lookup cost."""
        bound = self._ensure_bound()
        if bound is None:
            return None
        gen, _token = bound
        ns = self._epoch_ns(gen, monitor_id)
        try:
            got = self._tier.get_many(FAMILY, ns, [_index_digest(monitor_id)])
        except Exception:
            return None
        raw = got.get(_index_digest(monitor_id))
        if raw is None:
            return None
        try:
            idx = json.loads(raw)
            targets = list(idx["targets"])
            plane_epoch = int(idx["epoch"])
        except (ValueError, KeyError, TypeError):
            return None
        if not targets:
            return {}, plane_epoch
        digests = [target_digest(module, t) for t in targets]
        try:
            entries = self._tier.get_many(FAMILY, ns, digests)
        except Exception:
            return None
        plane: dict = {}
        for t, d in zip(targets, digests):
            v = entries.get(d)
            if v is None:
                return None  # evicted entry: the plane is no longer whole
            try:
                plane[t] = json.loads(v)
            except (ValueError, TypeError):
                return None
        return plane, plane_epoch

    def store(
        self,
        monitor_id: str,
        module: str,
        plane: dict,
        changed_targets: Sequence[str],
        epoch: int,
    ) -> bool:
        """Write the changed entries plus the index (fenced,
        best-effort). A zero-change epoch writes only the one index
        entry — that advance is what keeps the next epoch's prior-plane
        fast path warm (``plane_epoch == epoch-1``)."""
        bound = self._ensure_bound()
        if bound is None:
            return False
        gen, token = bound
        ns = self._epoch_ns(gen, monitor_id)
        pairs = [
            (target_digest(module, t), json.dumps(plane[t], separators=(",", ":")))
            for t in changed_targets
            if t in plane
        ]
        pairs.append(
            (
                _index_digest(monitor_id),
                json.dumps(
                    {"targets": sorted(plane), "epoch": epoch},
                    separators=(",", ":"),
                ),
            )
        )
        try:
            outcome, _stored = self._tier.put_many(
                FAMILY, ns, pairs, self._writer, token
            )
        except Exception:
            return False
        return outcome == "stored"
