"""``swarm`` CLI, the port's copy of ``swarm_tpu/client/cli.py``: the
controller of actions performed within the swarm.

The action set and its semantics are the original swarm client's
(``client/swarm``): ``scan, workers, scans, jobs, spinup, terminate,
recycle, cat, stream, reset``, plus ``--tail`` live following,
``--autoscale`` pre-spinup with auto batch-size = lines/(nodes×1.8)
(``client/swarm:140-150``), the ECT estimator in the scans view
(``client/swarm:225-246``), and ``--configure`` persistence. The
wire is the JAX package's, so either package's client drives either
package's server. The client touches no device: importing it loads
neither ``torch`` nor ``jax``. Run it as ``python -m
swarm_tpu_torch.client <action>``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import requests

from swarm_tpu_torch.client.tables import Table
from swarm_tpu_torch.config import Config
from swarm_tpu_torch.datamodel import parse_job_id
from swarm_tpu_torch.telemetry import emit_event, new_trace_id
from swarm_tpu_torch.telemetry.events import TRACE_HEADER
from swarm_tpu_torch.telemetry.metrics import parse_exposition


class JobClient:
    def __init__(
        self,
        server_url: str,
        api_key: str,
        timeout: float = 60.0,
        tenant: Optional[str] = None,
        qos: Optional[str] = None,
    ):
        self.base = server_url.rstrip("/")
        self.timeout = timeout
        self.session = requests.Session()
        self.session.headers["Authorization"] = f"Bearer {api_key}"
        if tenant:
            # tenant identity rides every request (docs/GATEWAY.md);
            # absent = the server's default tenant, the original wire
            # behavior
            self.session.headers["X-Swarm-Tenant"] = tenant
        if qos:
            # latency class next to the tenant header (docs/GATEWAY.md
            # §QoS): "interactive" rides the express lane + gateway
            # cache; absent/"bulk" is the original wire behavior
            self.session.headers["X-Swarm-QoS"] = qos
        #: trace ID of the most recent submission (scan/stream): the
        #: correlation key every layer's event lines carry for it
        self.last_trace_id: Optional[str] = None

    # ------------------------------------------------------------------
    def start_scan(
        self,
        path: str,
        module: str,
        chunk_index: int,
        batch_size,
        scan_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> tuple[int, str]:
        with open(path, "r") as f:
            file_content = f.readlines()
        data = {
            "module": module,
            "file_content": file_content,
            "batch_size": int(float(batch_size)),
            "scan_id": scan_id,
            "chunk_index": chunk_index,
        }
        trace_id = trace_id or new_trace_id()
        self.last_trace_id = trace_id
        emit_event(
            "scan.submit",
            trace_id=trace_id,
            module=module,
            lines=len(file_content),
            batch_size=int(float(batch_size)),
        )
        resp = self.session.post(
            f"{self.base}/queue",
            json=data,
            headers={TRACE_HEADER: trace_id},
            timeout=self.timeout,
        )
        return resp.status_code, resp.text

    def get_metrics_text(self) -> Optional[str]:
        resp = self.session.get(f"{self.base}/metrics", timeout=self.timeout)
        return resp.text if resp.status_code == 200 else None

    def get_statuses(self) -> Optional[dict]:
        resp = self.session.get(f"{self.base}/get-statuses", timeout=self.timeout)
        return resp.json() if resp.status_code == 200 else None

    def fetch_raw(self, scan_id: str) -> str:
        resp = self.session.get(f"{self.base}/raw/{scan_id}", timeout=self.timeout)
        if resp.status_code == 200:
            return resp.text
        return f"Error: {resp.status_code} - {resp.text}"

    def get_latest_chunk_raw(self) -> Optional[str]:
        resp = self.session.get(f"{self.base}/get-latest-chunk", timeout=self.timeout)
        if resp.status_code != 200 or not resp.text:
            return None
        scan_id, chunk_id = parse_job_id(resp.text.strip())
        resp2 = self.session.get(
            f"{self.base}/get-chunk/{scan_id}/{chunk_id}", timeout=self.timeout
        )
        if resp2.status_code == 200:
            return resp2.json()["contents"].strip()
        return None

    def tail(self, timeout_polls: int = 36000) -> None:
        """Live-follow completed chunks (the original client/swarm:72-82)."""
        empty_polls = 0
        while empty_polls <= timeout_polls:
            chunk = self.get_latest_chunk_raw()
            if chunk is not None:
                sys.stdout.write(chunk + "\n")
                sys.stdout.flush()
            else:
                empty_polls += 1
                time.sleep(0.05)

    def spin_up(self, prefix: str, nodes: int) -> tuple[int, str]:
        resp = self.session.post(
            f"{self.base}/spin-up",
            json={"prefix": prefix, "nodes": nodes},
            timeout=self.timeout,
        )
        return resp.status_code, resp.text

    def spin_down(self, prefix: str) -> tuple[int, str]:
        resp = self.session.post(
            f"{self.base}/spin-down", json={"prefix": prefix}, timeout=self.timeout
        )
        return resp.status_code, resp.text

    def reset(self) -> tuple[int, str]:
        resp = self.session.post(f"{self.base}/reset", timeout=self.timeout)
        return resp.status_code, resp.text

    def get_healthz(self) -> Optional[dict]:
        resp = self.session.get(f"{self.base}/healthz", timeout=self.timeout)
        return resp.json() if resp.status_code == 200 else None

    def dead_letter_jobs(self) -> Optional[list]:
        resp = self.session.get(f"{self.base}/dead-letter", timeout=self.timeout)
        return resp.json()["jobs"] if resp.status_code == 200 else None

    def get_tenants(self) -> Optional[dict]:
        resp = self.session.get(f"{self.base}/tenants", timeout=self.timeout)
        return resp.json()["tenants"] if resp.status_code == 200 else None

    # ------------------------------------------------------------------
    def stream_results(
        self,
        scan_id: str,
        from_chunk: int = 0,
        max_reconnects: int = 8,
        reconnect_delay_s: float = 0.5,
    ):
        """Follow a scan's results as the server pushes them: yields
        ``(chunk_index, text)`` in chunk order from ``GET /stream/
        <scan_id>`` (NDJSON, docs/GATEWAY.md).

        Resume discipline: the cursor is "last delivered chunk + 1".
        On ANY disconnect — server restart, idle-timeout record, a
        dropped connection — the client reconnects with ``?from=
        <cursor>`` and continues from exactly the last acked chunk;
        the server serves already-stored chunks from the idempotent
        chunk store, so nothing is lost or duplicated. The reconnect
        budget resets on every delivered chunk (progress heals it)."""
        cursor = int(from_chunk)
        failures = 0
        while True:
            ended = saw_timeout = False
            try:
                resp = self.session.get(
                    f"{self.base}/stream/{scan_id}",
                    params={"from": cursor},
                    stream=True,
                    timeout=self.timeout,
                )
                if resp.status_code != 200:
                    raise requests.HTTPError(f"/stream: {resp.status_code}")
                for line in resp.iter_lines():
                    if not line:
                        continue
                    rec = json.loads(line)
                    event = rec.get("event")
                    if event == "end":
                        ended = True
                        break
                    if event == "timeout":
                        saw_timeout = True
                        break  # reconnect from the cursor
                    if event == "skipped":
                        cursor = int(rec["chunk"]) + 1
                        continue
                    if "chunk" in rec and "data" in rec:
                        cursor = int(rec["chunk"]) + 1
                        failures = 0
                        yield rec["chunk"], rec["data"]
            except requests.exceptions.ReadTimeout:
                # inter-record silence past OUR read timeout, on a
                # connection the server accepted: a healthy-but-slow
                # scan, not a failure (the server's own idle record
                # may be minutes away) — reconnect without burning the
                # budget; a truly dead server fails the reconnect with
                # a ConnectionError and burns it there
                time.sleep(reconnect_delay_s)
                continue
            except (requests.RequestException, ValueError, OSError):
                failures += 1
                if failures > max_reconnects:
                    raise
                time.sleep(reconnect_delay_s)
                continue
            if ended:
                return
            if saw_timeout:
                # a HEALTHY server bounding its handler lifetime while
                # the scan is simply slow — follow indefinitely (tail
                # -f semantics); only real disconnects burn the budget
                time.sleep(reconnect_delay_s)
                continue
            # server closed WITHOUT an end/timeout record (restart,
            # dropped connection): that's a failure — never silently
            # truncate a live stream with a clean exit
            failures += 1
            if failures > max_reconnects:
                raise requests.ConnectionError(
                    f"/stream/{scan_id}: disconnected without an end "
                    f"record after {max_reconnects} reconnects "
                    f"(next chunk {cursor})"
                )
            time.sleep(reconnect_delay_s)

    def requeue_job(self, job_id: str) -> tuple[int, str]:
        resp = self.session.post(
            f"{self.base}/requeue-job/{job_id}", timeout=self.timeout
        )
        return resp.status_code, resp.text

    def get_trace(self, scan_id: str) -> Optional[dict]:
        """Assembled per-scan span waterfall (``swarm trace`` —
        docs/OBSERVABILITY.md §Tracing); None = unknown scan, retention
        expired, or tracing was off when the scan ran."""
        resp = self.session.get(
            f"{self.base}/trace/{scan_id}", timeout=self.timeout
        )
        return resp.json() if resp.status_code == 200 else None

    def post_spans(self, scan_id: str, spans: list) -> bool:
        """Attach an out-of-band span batch to an open scan."""
        resp = self.session.post(
            f"{self.base}/spans",
            json={"scan_id": scan_id, "spans": spans},
            timeout=self.timeout,
        )
        return resp.status_code == 200

    # ------------------------------------------------------------------
    def monitor_add(
        self,
        path: str,
        module: str,
        interval_s: float,
        monitor_id: Optional[str] = None,
        batch_size: int = 0,
        paused: bool = False,
    ) -> tuple[int, str]:
        """Register (or upsert) a standing monitor over the targets in
        ``path`` — tenant/QoS ride the session headers exactly like a
        one-shot scan (docs/MONITORING.md)."""
        with open(path, "r") as f:
            targets = f.readlines()
        data = {
            "module": module,
            "targets": targets,
            "interval_s": interval_s,
            "batch_size": int(batch_size),
            "paused": paused,
        }
        if monitor_id:
            data["monitor_id"] = monitor_id
        resp = self.session.post(
            f"{self.base}/monitor", json=data, timeout=self.timeout
        )
        return resp.status_code, resp.text

    def monitor_list(self) -> Optional[list]:
        resp = self.session.get(f"{self.base}/monitor", timeout=self.timeout)
        return resp.json()["monitors"] if resp.status_code == 200 else None

    def monitor_update(self, monitor_id: str, op: str) -> tuple[int, str]:
        """``op`` is rm | pause | resume."""
        resp = self.session.post(
            f"{self.base}/monitor/{monitor_id}",
            json={"op": op},
            timeout=self.timeout,
        )
        return resp.status_code, resp.text

    def monitor_feed(
        self,
        monitor_id: str,
        from_seq: int = 0,
        max_reconnects: int = 8,
        reconnect_delay_s: float = 0.5,
    ):
        """Follow a monitor's change feed: yields diff-record dicts in
        ``seq`` order from ``GET /monitor-feed/<id>`` (NDJSON).

        Same resume discipline as :meth:`stream_results`, with the
        record ``seq`` as the cursor: on any disconnect — server
        restart, idle-timeout record, dropped connection — reconnect
        with ``?from=<last seq + 1>`` and continue from exactly the
        last acked record (the feed store is idempotent, so nothing
        duplicates or drops). Timeout records reconnect for free; the
        budget burns only on real failures and resets on progress."""
        cursor = int(from_seq)
        failures = 0
        while True:
            ended = saw_timeout = False
            try:
                resp = self.session.get(
                    f"{self.base}/monitor-feed/{monitor_id}",
                    params={"from": cursor},
                    stream=True,
                    timeout=self.timeout,
                )
                if resp.status_code != 200:
                    raise requests.HTTPError(
                        f"/monitor-feed: {resp.status_code}"
                    )
                for line in resp.iter_lines():
                    if not line:
                        continue
                    rec = json.loads(line)
                    event = rec.get("event")
                    if event == "end":
                        ended = True
                        break
                    if event == "timeout":
                        saw_timeout = True
                        break  # reconnect from the cursor
                    if "seq" in rec:
                        cursor = int(rec["seq"]) + 1
                        failures = 0
                        yield rec
            except requests.exceptions.ReadTimeout:
                # healthy-but-quiet monitor (see stream_results): the
                # server's own idle record may be minutes away —
                # reconnect without burning the budget
                time.sleep(reconnect_delay_s)
                continue
            except (requests.RequestException, ValueError, OSError):
                failures += 1
                if failures > max_reconnects:
                    raise
                time.sleep(reconnect_delay_s)
                continue
            if ended:
                return
            if saw_timeout:
                time.sleep(reconnect_delay_s)
                continue
            failures += 1
            if failures > max_reconnects:
                raise requests.ConnectionError(
                    f"/monitor-feed/{monitor_id}: disconnected without "
                    f"an end record after {max_reconnects} reconnects "
                    f"(next seq {cursor})"
                )
            time.sleep(reconnect_delay_s)


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------


def estimate_completion_time(scan_started, total_chunks, chunks_complete, completed_at):
    """ECT = remaining% × elapsed/complete% (the original client/swarm:225-246)."""
    if not chunks_complete or not scan_started:
        return None
    now = time.time()
    elapsed = now - scan_started
    frac = chunks_complete / total_chunks
    if elapsed <= 0:
        return None
    if frac >= 1:
        eta = completed_at or now
    else:
        eta = now + (1 - frac) * (elapsed / frac)
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(eta))


def _fmt_ts(ts) -> str:
    if not ts:
        return ""
    return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ts))


def _fmt_age(ts, now=None) -> str:
    if not ts:
        return ""
    age = max(0.0, (now if now is not None else time.time()) - ts)
    if age < 120:
        return f"{age:.1f}s"
    if age < 7200:
        return f"{age / 60:.1f}m"
    return f"{age / 3600:.1f}h"


def render_workers(statuses: dict, health: Optional[dict] = None) -> str:
    """Per-worker fleet readout: state (active / draining / preempted /
    inactive), last-heartbeat age, poll counters — plus the autoscale
    advisor's target vs actual when /healthz carries a recommendation
    (docs/RESILIENCE.md §Preemption)."""
    draining = statuses.get("draining") or {}
    table = Table(
        ["Worker ID", "State", "Heartbeat Age", "Last Contacted",
         "Polls with No Jobs"]
    )
    for worker_id, w in statuses.get("workers", {}).items():
        state = w.get("status") or ""
        reason = draining.get(worker_id)
        if reason:
            state = f"{state} ({reason})"
        table.add_row(
            [worker_id, state, _fmt_age(w.get("last_contact")),
             _fmt_ts(w.get("last_contact")), w.get("polls_with_no_jobs")]
        )
    lines = [str(table)]
    auto = (health or {}).get("autoscale")
    # before the advisor's first control-law tick the status dict
    # carries None fields — nothing worth a line yet
    if auto and auto.get("action") is not None:
        lines.append(
            f"autoscale[{auto.get('prefix')}]: "
            f"target {auto.get('target_nodes')} vs "
            f"actual {auto.get('current_nodes')} nodes "
            f"({auto.get('action')}"
            + (", dry-run" if auto.get("dry_run") else "")
            + f"); queue depth {auto.get('queue_depth')}, "
            f"forecast {auto.get('forecast_jobs')} jobs"
        )
    return "\n".join(lines)


def render_jobs(statuses: dict) -> str:
    table = Table(
        ["Job ID", "Scan ID", "Chunk", "Status", "Worker ID", "Started", "Completed", "Seconds"]
    )
    jobs = sorted(
        statuses.get("jobs", {}).items(), key=lambda kv: int(kv[1].get("chunk_index", 0))
    )
    for job_id, j in jobs:
        started, completed = j.get("started_at"), j.get("completed_at")
        duration = f"{completed - started:.1f}" if started and completed else ""
        table.add_row(
            [job_id, j.get("scan_id"), j.get("chunk_index"), j.get("status"),
             j.get("worker_id"), _fmt_ts(started), _fmt_ts(completed), duration]
        )
    return str(table)


def render_metrics(text: str) -> str:
    """Pretty-print a /metrics exposition body as tables: one row per
    sample, histograms summarized to count/sum/p-ish buckets."""
    samples = parse_exposition(text)
    table = Table(["Metric", "Labels", "Value"])
    for name, labels, value in samples:
        label_str = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        if isinstance(value, float) and value.is_integer():
            shown = str(int(value))
        else:
            shown = f"{value:.6g}"
        table.add_row([name, label_str, shown])
    return str(table)


def render_dead_letter(jobs: list) -> str:
    """Quarantined jobs with their failure provenance (one line per
    job; the history is compacted to status×count)."""
    table = Table(
        ["Job ID", "Module", "Attempts", "Failure History"]
    )
    for j in jobs:
        history = j.get("failure_history") or []
        counts: dict[str, int] = {}
        for f in history:
            counts[f.get("status", "?")] = counts.get(f.get("status", "?"), 0) + 1
        summary = ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))
        table.add_row(
            [j.get("job_id"), j.get("module"), j.get("attempts"), summary]
        )
    return str(table)


def render_resilience_summary(health: dict) -> str:
    """One-glance degradation readout (dead-letter depth + breaker
    states) from unauthenticated /healthz — no Prometheus needed."""
    breakers = health.get("breakers") or {}
    not_closed = {k: v for k, v in breakers.items() if v != "closed"}
    lines = [
        f"dead-letter jobs: {health.get('dead_letter_jobs', 0)}",
        "breakers: "
        + (
            ", ".join(f"{k}={v}" for k, v in sorted(not_closed.items()))
            or f"all closed ({len(breakers)} tracked)"
        ),
    ]
    plan = health.get("fault_plan")
    if plan:
        lines.append(f"fault plan ACTIVE: {plan}")
    return "\n".join(lines)


def render_tenants(tenants: dict) -> str:
    """Per-tenant gateway readout: depth, admission outcomes, states
    (`swarm tenants` — docs/GATEWAY.md)."""
    table = Table(
        ["Tenant", "Queue Depth", "Admitted", "Shed", "Jobs by State"]
    )
    for tenant, t in sorted(tenants.items()):
        states = ", ".join(
            f"{s}: {n}" for s, n in sorted((t.get("jobs_by_state") or {}).items())
        )
        table.add_row(
            [tenant, t.get("queue_depth"), t.get("admitted"), t.get("shed"),
             states]
        )
    return str(table)


def render_trace(doc: dict) -> str:
    """One scan's latency waterfall as a parent-linked tree with
    per-segment percentages, plus the critical-path summary
    ("queue-wait 61%, device 22%, upload 9%") —
    docs/OBSERVABILITY.md §Tracing."""
    from swarm_tpu_torch.telemetry import tracing

    root = doc["root"]
    total = root.get("duration_s") or 0.0
    spans = doc.get("spans") or []
    children: dict = {}
    for s in sorted(spans, key=lambda sp: sp.get("start") or 0.0):
        children.setdefault(s.get("parent_id"), []).append(s)

    lines = [
        f"scan {doc.get('scan_id')}  trace {doc.get('trace_id')}  "
        f"status {doc.get('status')}  chunks {doc.get('chunks')}"
        + (f"  qos {doc['qos']}" if doc.get("qos") else ""),
        f"gateway latency {total * 1000:.1f} ms; "
        f"segments sum {doc.get('segments_sum_s', 0.0) * 1000:.1f} ms"
        + (
            f" ({doc.get('segments_sum_s', 0.0) / total * 100:.1f}%)"
            if total > 0 else ""
        ),
    ]
    shown_attrs = (
        "attempt", "qos", "worker_id", "module", "rows", "error", "tenant"
    )

    def walk(span_id, prefix: str) -> None:
        kids = children.get(span_id, [])
        for i, s in enumerate(kids):
            last = i == len(kids) - 1
            dur = s.get("duration_s") or 0.0
            pct = (dur / total * 100.0) if total > 0 else 0.0
            attrs = s.get("attrs") or {}
            extra = " ".join(
                f"{k}={attrs[k]}" for k in shown_attrs if k in attrs
            )
            lines.append(
                f"{prefix}{'└─ ' if last else '├─ '}"
                f"{s.get('name', '?'):<18} {dur * 1000:9.1f} ms {pct:5.1f}%"
                + (f"  {extra}" if extra else "")
            )
            walk(s.get("span_id"), prefix + ("   " if last else "│  "))

    walk(root.get("span_id"), "")
    orphans = tracing.waterfall_orphans(doc)
    if orphans:
        names = ", ".join(sorted({s.get("name", "?") for s in orphans}))
        lines.append(f"! {len(orphans)} orphan span(s) (lost parents): {names}")
    cp = tracing.critical_path(doc)
    if cp:
        lines.append(
            "critical path: "
            + ", ".join(f"{name} {frac * 100.0:.0f}%" for name, _s, frac in cp)
        )
    return "\n".join(lines)


def render_scans(statuses: dict) -> str:
    table = Table(
        ["Scan ID", "Chunks", "Complete", "%", "Workers", "Module", "Monitor",
         "Started", "Completed", "ECT", "Rows/s"]
    )
    for s in statuses.get("scans", []):
        ect = estimate_completion_time(
            s.get("scan_started"), s.get("total_chunks") or 1,
            s.get("chunks_complete") or 0, s.get("completed_at"),
        )
        # monitor provenance: which standing spec fired this scan, and
        # as which epoch (blank for one-shot scans — docs/MONITORING.md)
        mon = (
            f"{s['monitor_id']}@e{s.get('monitor_epoch')}"
            if s.get("monitor_id") else ""
        )
        table.add_row(
            [s.get("scan_id"), s.get("total_chunks"), s.get("chunks_complete"),
             s.get("percent_complete"), len(s.get("workers") or []), s.get("module"),
             mon, _fmt_ts(s.get("scan_started")), _fmt_ts(s.get("completed_at")),
             ect or "", s.get("rows_per_second") or ""]
        )
    return str(table)


def render_monitors(monitors: list) -> str:
    """Standing-spec registry readout (`swarm monitor ls` —
    docs/MONITORING.md)."""
    table = Table(
        ["Monitor ID", "Module", "Targets", "Interval", "Tenant", "QoS",
         "Epoch", "Paused", "Last Scan"]
    )
    for m in monitors:
        table.add_row(
            [m.get("monitor_id"), m.get("module"),
             len(m.get("targets") or []),
             f"{float(m.get('interval_s') or 0):g}s",
             m.get("tenant"), m.get("qos"), m.get("epoch"),
             "yes" if m.get("paused") else "",
             m.get("last_scan_id") or ""]
        )
    return str(table)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

ACTIONS = [
    "scan", "workers", "scans", "jobs", "metrics", "dead-letter", "tenants",
    "spinup", "terminate", "cat", "stream", "trace", "monitor", "recycle",
    "reset",
]

#: second-level verbs for ``swarm monitor`` (default: ls)
MONITOR_SUBACTIONS = ["add", "rm", "ls", "pause", "resume", "follow"]


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Swarm Scan Client")
    parser.add_argument("action", nargs="?", choices=ACTIONS)
    parser.add_argument("subaction", nargs="?", default=None,
                        help="monitor subverb: " + "|".join(MONITOR_SUBACTIONS))
    parser.add_argument("--server-url", default=None)
    parser.add_argument("--api-key", default=None)
    parser.add_argument("--config", default=None)
    parser.add_argument("--configure", action="store_true",
                        help="persist server URL and API key to the config file")
    parser.add_argument("--file", help="targets file (scan)")
    parser.add_argument("--module", help="scan module name")
    parser.add_argument("--batch-size", default="auto")
    parser.add_argument("--prefix", help="node name prefix (spinup/terminate)")
    parser.add_argument("--nodes", type=int, help="node count (spinup)")
    parser.add_argument("--scan-id", help="scan id (cat/stream/trace)")
    parser.add_argument("--tenant", default=None,
                        help="tenant id sent as X-Swarm-Tenant (gateway)")
    parser.add_argument("--qos", default=None,
                        choices=["bulk", "interactive"],
                        help="latency class sent as X-Swarm-QoS: "
                             "'interactive' rides the express lane with "
                             "deadline-bounded batching (scan/stream)")
    parser.add_argument("--from-chunk", type=int, default=0,
                        help="resume cursor for stream follow mode")
    parser.add_argument("--interval", type=float, default=None,
                        help="rescan cadence in seconds (monitor add)")
    parser.add_argument("--monitor-id", default=None,
                        help="monitor id (monitor add/rm/pause/resume/follow)")
    parser.add_argument("--from-seq", type=int, default=0,
                        help="resume cursor for monitor follow mode")
    parser.add_argument("--job-id", help="job id (dead-letter --requeue)")
    parser.add_argument("--requeue", action="store_true",
                        help="requeue the quarantined --job-id (dead-letter)")
    parser.add_argument("--autoscale", action="store_true")
    parser.add_argument("--tail", action="store_true", help="follow completed chunks")
    args = parser.parse_args(argv)

    cfg = Config.load(path=args.config, server_url=args.server_url, api_key=args.api_key)
    client = JobClient(
        cfg.resolve_url(), cfg.api_key, tenant=args.tenant, qos=args.qos
    )

    if args.configure:
        cfg.save(args.config)
        print(f"Configuration saved")

    try:
        rc = _run_action(args, cfg, client)
    except requests.ConnectionError:
        print(f"Cannot reach server at {cfg.resolve_url()}")
        return 2

    if args.tail:
        client.tail()
    return rc


def _run_action(args, cfg: Config, client: JobClient) -> int:
    if args.action == "scan":
        if not args.file or not args.module:
            print("Both file and module are required for starting a scan")
            return 1
        total_workers = args.nodes or 1
        if args.autoscale:
            if not args.prefix or not args.nodes:
                print("Both prefix and nodes are required for autoscale")
                return 1
            code, text = client.spin_up(args.prefix, args.nodes)
            print(code, text)
        if args.batch_size != "auto":
            batch_size = int(float(args.batch_size))
        else:
            with open(args.file) as f:
                lines = sum(1 for _ in f)
            batch_size = max(1, int(lines / (total_workers * 1.8)))
        code, text = client.start_scan(args.file, args.module, 0, batch_size)
        print(f"Start Scan Status Code: {code}")
        print(f"Start Scan Response: {text}")
        return 0 if code == 200 else 1

    if args.action == "metrics":
        text = client.get_metrics_text()
        if text is None:
            print("Failed to retrieve metrics")
            return 1
        # degradation at a glance (dead-letter depth, breaker states)
        # before the full exposition table — docs/RESILIENCE.md
        health = client.get_healthz()
        if health is not None:
            print(render_resilience_summary(health))
        try:
            print(render_metrics(text))
        except ValueError as e:
            print(f"Malformed metrics exposition: {e}")
            return 1
        return 0

    if args.action == "dead-letter":
        if args.requeue:
            if not args.job_id:
                print("--job-id is required for dead-letter --requeue")
                return 1
            code, text = client.requeue_job(args.job_id)
            print(code, text)
            return 0 if code == 200 else 1
        jobs = client.dead_letter_jobs()
        if jobs is None:
            print("Failed to retrieve dead-letter jobs")
            return 1
        print(f"Dead-letter jobs: {len(jobs)}")
        print(render_dead_letter(jobs))
        return 0

    if args.action in ("workers", "scans", "jobs"):
        statuses = client.get_statuses()
        if statuses is None:
            print("Failed to retrieve statuses")
            return 1
        if args.action == "workers":
            print("Worker Statuses:")
            # the advisor's target-vs-actual line rides the same view;
            # a dead /healthz just drops it (the table still renders)
            try:
                health = client.get_healthz()
            except requests.RequestException:
                health = None
            print(render_workers(statuses, health))
        elif args.action == "jobs":
            print("Job Statuses:")
            print(render_jobs(statuses))
        else:
            print("Scan Information:")
            print(render_scans(statuses))
        return 0

    if args.action == "spinup":
        if not args.prefix or not args.nodes:
            print("Both prefix and nodes are required for spinning up")
            return 1
        code, _text = client.spin_up(args.prefix, args.nodes)
        if code == 202:
            print(f"Successfully issued spinup for prefix {args.prefix}")
            return 0
        return 1

    if args.action == "terminate":
        if not args.prefix:
            print("Prefix is required for spinning down")
            return 1
        code, text = client.spin_down(args.prefix)
        print(code, text)
        return 0 if code == 202 else 1

    if args.action == "recycle":
        if not args.prefix or not args.nodes:
            print("Both prefix and nodes are required for recycle")
            return 1
        print(client.spin_down(args.prefix))
        print("Waiting 10 seconds to spin fleet back up")
        time.sleep(10)
        print(client.spin_up(args.prefix, args.nodes))
        return 0

    if args.action == "tenants":
        tenants = client.get_tenants()
        if tenants is None:
            print("Failed to retrieve tenants")
            return 1
        print(f"Tenants: {len(tenants)}")
        print(render_tenants(tenants))
        return 0

    if args.action == "stream":
        if not args.scan_id:
            print("scan-id is required for stream")
            return 1
        if not args.module:
            # FOLLOW mode (docs/GATEWAY.md): real server-push result
            # streaming over /stream/<scan_id> — chunks print the
            # moment they land, resumable via --from-chunk (the old
            # behavior polled `cat`; submission mode below is the
            # original client's stdin contract and still requires --module)
            for _chunk, text in client.stream_results(
                args.scan_id, from_chunk=args.from_chunk
            ):
                sys.stdout.write(text if text.endswith("\n") else text + "\n")
                sys.stdout.flush()
            return 0
        chunk: list[str] = []
        chunk_index = 0
        batch = 0 if args.batch_size == "auto" else int(float(args.batch_size))
        # one trace for the whole streamed scan: every flushed chunk's
        # jobs correlate under it
        trace_id = new_trace_id()
        client.last_trace_id = trace_id
        emit_event(
            "scan.stream_start", trace_id=trace_id,
            scan_id=args.scan_id, module=args.module,
        )

        def flush(lines: list[str]) -> None:
            nonlocal chunk_index
            chunk_index += 1
            resp = client.session.post(
                f"{client.base}/queue",
                json={
                    "module": args.module,
                    "file_content": lines,
                    "batch_size": batch,
                    "scan_id": args.scan_id,
                    "chunk_index": chunk_index,
                },
                headers={TRACE_HEADER: trace_id},
                timeout=client.timeout,
            )
            print(f"Uploading chunk {chunk_index}: {resp.status_code}")

        for line in sys.stdin:
            chunk.append(line)
            if len(chunk) >= 10:
                flush(chunk)
                chunk = []
                time.sleep(0.3)
        if chunk:  # the original dropped the trailing partial chunk
            flush(chunk)
        return 0

    if args.action == "cat":
        if not args.scan_id:
            print("scan-id is required for cat")
            return 1
        print(client.fetch_raw(args.scan_id))
        return 0

    if args.action == "trace":
        if not args.scan_id:
            print("scan-id is required for trace")
            return 1
        doc = client.get_trace(args.scan_id)
        if doc is None:
            print(
                f"No trace for scan {args.scan_id} (tracing disabled, "
                "retention expired, or unknown scan)"
            )
            return 1
        print(render_trace(doc))
        return 0

    if args.action == "monitor":
        sub = args.subaction or "ls"
        if sub not in MONITOR_SUBACTIONS:
            print(f"monitor subaction must be one of: "
                  f"{', '.join(MONITOR_SUBACTIONS)}")
            return 1
        if sub == "ls":
            monitors = client.monitor_list()
            if monitors is None:
                print("Failed to retrieve monitors")
                return 1
            print(f"Monitors: {len(monitors)}")
            print(render_monitors(monitors))
            return 0
        if sub == "add":
            if not args.file or not args.module or args.interval is None:
                print("file, module and --interval are required for "
                      "monitor add")
                return 1
            batch = (
                0 if args.batch_size == "auto"
                else int(float(args.batch_size))
            )
            code, text = client.monitor_add(
                args.file, args.module, args.interval,
                monitor_id=args.monitor_id, batch_size=batch,
            )
            print(f"Monitor Add Status Code: {code}")
            print(f"Monitor Add Response: {text}")
            return 0 if code == 200 else 1
        if not args.monitor_id:
            print(f"--monitor-id is required for monitor {sub}")
            return 1
        if sub == "follow":
            for rec in client.monitor_feed(
                args.monitor_id, from_seq=args.from_seq
            ):
                sys.stdout.write(
                    json.dumps(rec, separators=(",", ":")) + "\n"
                )
                sys.stdout.flush()
            return 0
        code, text = client.monitor_update(args.monitor_id, sub)
        print(code, text)
        return 0 if code == 200 else 1

    if args.action == "reset":
        code, text = client.reset()
        print(code, text)
        return 0 if code == 200 else 1

    if args.action is None:
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
