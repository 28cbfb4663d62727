"""The port's client (``swarm_tpu_torch/client/``) and benchmark sampler
(``swarm_tpu_torch/benchmark.py``) against the JAX package's, on the CPU.

- the modules are copies: their code is the reference's with the package
  name changed, docstrings and comments aside;
- each CLI action is run by both packages' ``main`` against each
  package's server, through the harness of ``tests/test_torch_server.py``
  (one patched clock and uuid sequence, a fresh server on roots of its
  own for each client): the return codes, the printed text with the
  bound port written as ``PORT``, the client's ``scan.submit`` /
  ``scan.stream_start`` event lines, and the server's state, blob and
  doc stores and metric deltas are equal. The client's ``time`` reads
  the same clock (the ECT and heartbeat ages); the stdin stream's 0.3 s
  a chunk is skipped, and ``recycle``'s 10 s waits for the spin-down to
  land instead;
- state across the packages: a ``--configure`` file written by either
  CLI is loaded equal by the other's ``Config``, and a scan that one
  package's client submits is read byte-equal by the other's ``cat``
  and ``stream``;
- the client-rendering cases of the reference's files, on the port's
  client and server: ``tests/test_fleet.py`` (``render_workers``),
  ``tests/test_end_to_end.py`` (the views, stdin ``stream`` and
  ``cat``, ``tail``, ``spinup`` / ``recycle`` / ``terminate`` over the
  port's process fleet on the CPU), ``tests/test_resilience.py``
  (``dead-letter``, ``metrics``), ``tests/test_gateway.py`` (the
  ``tenants`` view), ``tests/test_trace_waterfall.py`` (``render_trace``
  of a dispatched scan) and ``tests/test_monitor.py`` (``monitor_feed``
  resumed from its cursor).

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import contextlib
import dataclasses
import io
import json
import socket
import sys
import threading
import time
from pathlib import Path

import pytest

import swarm_tpu.client.cli as j_cli
import swarm_tpu.client.tables as j_tables
import swarm_tpu.config as j_config
import swarm_tpu.telemetry.events as j_events
import swarm_tpu_torch.client.cli as t_cli
import swarm_tpu_torch.client.tables as t_tables
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.telemetry.events as t_events

from test_torch_fleet import stripped
from test_torch_server import KEY, PKG, SIDES, one_torch_thread, run_side  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CLI = {"jax": j_cli, "torch": t_cli}
EVENTS = {"jax": j_events, "torch": t_events}
CONFIG = {"jax": j_config, "torch": t_config}
#: the client's own event lines
CLIENT_EVENTS = ("scan.submit", "scan.stream_start")


# ---------------------------------------------------------------------------
# the copies


@pytest.mark.parametrize("rel", ["client/cli.py", "client/tables.py", "client/__main__.py",
                                 "client/__init__.py", "benchmark.py"])
def test_module_is_a_copy_of_the_reference(rel):
    with open(REPO / "swarm_tpu" / rel) as f, open(REPO / "swarm_tpu_torch" / rel) as g:
        assert stripped(g.read()) == stripped(f.read())


def test_table_renders_as_the_reference():
    tables = []
    for mod in (j_tables, t_tables):
        t = mod.Table(["a", "longer b", 3])
        t.add_row(["x", None, 1.5])
        t.add_row(["wide cell", "", 0])
        tables.append(str(t))
    assert tables[0] == tables[1]
    assert tables[1].splitlines()[1] == "| a         | longer b | 3   |"


# ---------------------------------------------------------------------------
# the harness: each client against one server package


class CliClock:
    """The client module's ``time``: the script's clock, sleeps skipped
    (or handed to ``sleep``), everything else the real module."""

    def __init__(self, clock, sleep=None):
        self.clock = clock
        self.sleep = sleep or (lambda s: None)

    def time(self) -> float:
        return self.clock.time()

    def __getattr__(self, name):
        return getattr(time, name)


class Cli:
    """One package's CLI as a script calls it: ``cli(srv, *argv)`` →
    ``[rc, stdout]`` with the server's URL and key appended and its
    port written as ``PORT``; ``lines`` gathers the client's event lines."""

    def __init__(self, side: str, e):
        self.side = side
        self.mod = CLI[side]
        self.e = e
        self.lines: list = []

    def __call__(self, srv, *argv, stdin: str | None = None) -> list:
        args = list(argv)
        if srv is not None:
            args += ["--server-url", self.e.base(srv), "--api-key", KEY]
        out = io.StringIO()
        saved = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out):
                rc = self.mod.main(args)
        finally:
            sys.stdin = saved
        text = out.getvalue()
        if srv is not None:
            text = text.replace(f":{srv.port}", ":PORT")
        return [rc, text]


def run_clients(script, server: str, tmp_path, monkeypatch, sleep=None) -> dict:
    """``script(e, cli)`` against ``server``'s package with each
    package's client, a fresh server each → the port client's run,
    after what each saw, the client event lines, the server's stores
    and its metric deltas were found equal."""
    t0 = float(int(time.time()))
    out = {}
    for side in SIDES:
        def case(e, side=side):
            cli = Cli(side, e)
            unsubscribe = EVENTS[side].subscribe(
                lambda rec: rec["event"] in CLIENT_EVENTS and cli.lines.append(
                    json.dumps(rec, sort_keys=True)))
            with monkeypatch.context() as mp:
                mp.setattr(cli.mod, "time", CliClock(e.clock, sleep and sleep(e)))
                mp.setattr(EVENTS[side], "time", e.clock)
                try:
                    seen = script(e, cli)
                finally:
                    unsubscribe()
            return {"seen": seen, "events": cli.lines}

        out[side] = run_side(case, server, tmp_path / f"{server}-{side}", t0, monkeypatch)
    for key in ("seen", "state", "blobs", "docs", "moved"):
        assert out["torch"].get(key) == out["jax"].get(key), key
    return out["torch"]


def _file(e, name: str, text: str) -> str:
    path = e.root / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def _lease(e, srv, worker: str = "w1"):
    r = e.get(srv, "/get-job", params={"worker_id": worker})
    return r.json() if r.status_code == 200 else None


def _complete(e, srv, job: dict, output: bytes | None = None) -> None:
    """One leased chunk through the HTTP worker surface: its output (by
    default its own input) and ``complete``."""
    sid, idx = job["scan_id"], int(job["chunk_index"])
    if output is None:
        output = e.get(srv, f"/get-input-chunk/{sid}/{idx}").content
    e.clock.advance(0.5)
    e.post(srv, f"/put-output-chunk/{sid}/{idx}", data=output)
    e.post(srv, f"/update-job/{job['job_id']}", json={"status": "complete"})


def _drain(e, srv, worker: str = "w1") -> int:
    n = 0
    while (job := _lease(e, srv, worker)) is not None:
        _complete(e, srv, job)
        n += 1
    return n


@contextlib.contextmanager
def bare_registry(metrics):
    """Every family of ``metrics`` without children in the block (its
    unlabeled child fresh), and as it was after it: ``/metrics`` then
    renders only what the script moved, whatever this process's other
    tests left in the process-wide registry."""
    saved = {}
    for fam in metrics.REGISTRY._metrics.values():
        saved[fam] = fam._data
        fam._data = {} if fam.labelnames else {(): fam._new_child()}
    try:
        yield
    finally:
        for fam, data in saved.items():
            fam._data = data


def _roster(e):
    """A fleet of names only, of the server's package: ``spin_up`` adds
    the prefix's node names, ``spin_down`` takes them away."""
    base = e.p.fleet.FleetProvider

    class Roster(base):
        def __init__(self):
            self.nodes: list = []
            self.lock = threading.Lock()

        def spin_up(self, prefix, nodes):
            with self.lock:
                for name in e.p.fleet.generate_node_names(prefix, nodes):
                    if name not in self.nodes:
                        self.nodes.append(name)

        def spin_down(self, prefix):
            with self.lock:
                self.nodes = [n for n in self.nodes if not n.startswith(prefix)]

        def list_nodes(self, prefix):
            with self.lock:
                return sorted(n for n in self.nodes if n.startswith(prefix))

    return Roster()


def _wait(ready, timeout_s: float = 10.0):
    deadline = time.monotonic() + timeout_s
    while not (got := ready()):
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.01)
    return got


# ---------------------------------------------------------------------------
# each action on both clients, on each server


def c_scan(e, cli):
    srv = e.server(lease_seconds=30)
    targets = _file(e, "t.txt", "".join(f"10.0.0.{i}\n" for i in range(5)))
    seen = [cli(srv, "scan", "--module", "echo"),
            cli(srv, "scan", "--file", targets, "--module", "echo", "--batch-size", "2")]
    e.clock.advance(1.0)
    seen.append(cli(srv, "scan", "--file", targets, "--module", "echo"))  # auto: 5/1.8
    seen.append(e.norm(srv, e.get(srv, "/get-statuses")))
    return seen


def c_scan_autoscale(e, cli):
    fleet = _roster(e)
    srv = e.server(lease_seconds=30, fleet=fleet)
    targets = _file(e, "t.txt", "".join(f"h{i}.example\n" for i in range(9)))
    seen = [cli(srv, "scan", "--file", targets, "--module", "echo", "--autoscale"),
            cli(srv, "scan", "--file", targets, "--module", "echo", "--autoscale",
                "--prefix", "as", "--nodes", "2")]
    seen.append(_wait(lambda: fleet.list_nodes("as") or None))
    seen.append(e.norm(srv, e.get(srv, "/get-statuses")))
    return seen


def c_scan_qos(e, cli):
    srv = e.server(lease_seconds=30)
    bulk = _file(e, "bulk.txt", "".join(f"b{i}\n" for i in range(6)))
    probe = _file(e, "probe.txt", "p0\np1\n")
    seen = [cli(srv, "scan", "--file", bulk, "--module", "echo", "--batch-size", "1",
                "--qos", "bulk")]
    e.clock.advance(1.0)
    seen.append(cli(srv, "scan", "--file", probe, "--module", "probe", "--batch-size", "1",
                    "--qos", "interactive", "--tenant", "acme"))
    # the express lane hands the interactive probe out first
    seen.append([_lease(e, srv)["job_id"] for _ in range(3)])
    seen.append(e.norm(srv, e.get(srv, "/get-statuses")))
    return seen


def c_views(e, cli):
    srv = e.server(lease_seconds=30)
    seen = [cli(srv, "workers"), cli(srv, "jobs"), cli(srv, "scans")]
    targets = _file(e, "t.txt", "one\ntwo\nthree\n")
    seen.append(cli(srv, "scan", "--file", targets, "--module", "echo", "--batch-size", "1"))
    first = _lease(e, srv, "w1")
    e.clock.advance(2.0)
    second, third = _lease(e, srv, "w2"), _lease(e, srv, "w3")
    _complete(e, srv, first)
    e.clock.advance(3.0)
    e.get(srv, "/get-job", params={"worker_id": "idle"})
    e.clock.advance(1.5)
    seen += [cli(srv, "workers"), cli(srv, "jobs"), cli(srv, "scans")]
    _complete(e, srv, second)
    _complete(e, srv, third)
    e.clock.advance(200.0)
    seen += [cli(srv, "workers"), cli(srv, "jobs"), cli(srv, "scans")]
    return seen


def c_metrics(e, cli):
    with bare_registry(e.p.metrics):
        srv = e.server(lease_seconds=30)
        e.post(srv, "/queue", json={"module": "echo", "file_content": ["a\n", "b\n"],
                                    "batch_size": 1})
        _complete(e, srv, _lease(e, srv))
        return [cli(srv, "metrics")]


def c_dead_letter(e, cli):
    srv = e.server(lease_seconds=30, max_attempts=1, retry_failed=True)
    seen = [cli(srv, "dead-letter")]
    e.post(srv, "/queue", json={"module": "boom", "file_content": ["x\n", "y\n"],
                                "batch_size": 1, "scan_id": "dl_1"})
    job = _lease(e, srv, "w0")
    e.post(srv, f"/update-job/{job['job_id']}",
           json={"status": "cmd failed", "worker_id": "w0"})
    seen += [cli(srv, "dead-letter"), cli(srv, "dead-letter", "--requeue"),
             cli(srv, "dead-letter", "--requeue", "--job-id", "dl_1_9"),
             cli(srv, "dead-letter", "--requeue", "--job-id", job["job_id"]),
             cli(srv, "dead-letter"), e.norm(srv, e.get(srv, "/get-statuses"))]
    return seen


def c_tenants(e, cli):
    srv = e.server(lease_seconds=30, gateway_tenant_rate=0.001,
                   gateway_tenant_burst=2)
    targets = _file(e, "t.txt", "a\nb\n")
    seen = [cli(srv, "tenants")]
    for i, tenant in enumerate(("acme", "noisy", "noisy", "noisy")):
        e.clock.advance(1.0)
        seen.append(cli(srv, "scan", "--file", targets, "--module", f"m{i}",
                        "--batch-size", "1", "--tenant", tenant))
    seen.append(cli(srv, "tenants"))
    return seen


def c_stream(e, cli):
    srv = e.server(lease_seconds=30, gateway_stream_poll_s=0.01)
    lines = "".join(f"host{i}.example\n" for i in range(23))  # 2 full + 1 partial
    seen = [cli(srv, "stream"), cli(srv, "cat"),
            cli(srv, "stream", "--module", "echo", "--scan-id", "echo_777",
                "--batch-size", "0", stdin=lines)]
    seen.append(_drain(e, srv))
    seen += [cli(srv, "stream", "--scan-id", "echo_777", "--from-chunk", "1"),
             cli(srv, "stream", "--scan-id", "echo_777", "--from-chunk", "3"),
             cli(srv, "cat", "--scan-id", "echo_777"),
             cli(srv, "cat", "--scan-id", "nosuch_1")]
    return seen


def c_trace(e, cli):
    srv = e.server(lease_seconds=30, trace_enabled=True)
    targets = _file(e, "t.txt", "alpha\nbeta\n")
    seen = [cli(srv, "trace"),
            cli(srv, "scan", "--file", targets, "--module", "echo", "--batch-size", "1")]
    scan_id = e.get(srv, "/get-statuses").json()["scans"][0]["scan_id"]
    e.clock.advance(0.25)
    _drain(e, srv)
    seen += [cli(srv, "trace", "--scan-id", scan_id),
             cli(srv, "trace", "--scan-id", "nosuch_1")]
    return seen


def c_monitor(e, cli):
    from test_torch_server_cases import MONITOR, _fire_epoch

    srv = e.server(**MONITOR)
    targets = _file(e, "targets.txt", "t0\nt1\nt2\n")
    seen = [cli(srv, "monitor"),
            cli(srv, "monitor", "add", "--file", targets, "--module", "monmod"),
            cli(srv, "monitor", "add", "--file", targets, "--module", "monmod",
                "--interval", "60", "--monitor-id", "m1", "--batch-size", "1"),
            cli(srv, "monitor", "add", "--file", targets, "--module", "monmod",
                "--interval", "0.5", "--monitor-id", "bad")]
    seen += [cli(srv, "monitor", "ls"), cli(srv, "monitor", "pause"),
             cli(srv, "monitor", "pause", "--monitor-id", "m1"), cli(srv, "monitor", "ls"),
             cli(srv, "monitor", "resume", "--monitor-id", "m1"),
             cli(srv, "monitor", "frobnicate")]
    seen.append(_fire_epoch(e, srv))
    seen += [cli(srv, "monitor", "ls"), cli(srv, "scans"),
             cli(srv, "monitor", "rm", "--monitor-id", "m1"),
             cli(srv, "monitor", "follow", "--monitor-id", "m1"),
             cli(srv, "monitor", "follow", "--monitor-id", "m1", "--from-seq", "2"),
             cli(srv, "monitor", "rm", "--monitor-id", "m1")]
    return seen


def c_fleet(e, cli):
    fleet = _roster(e)
    srv = e.server(lease_seconds=30, fleet=fleet)
    seen = [cli(srv, "spinup", "--prefix", "cf"), cli(srv, "spinup", "--prefix", "cf",
                                                      "--nodes", "2")]
    seen.append(_wait(lambda: len(fleet.list_nodes("cf")) == 2 and fleet.list_nodes("cf")))
    # recycle's wait: until the spin-down has landed
    seen += [cli(srv, "recycle", "--prefix", "cf"),
             cli(srv, "recycle", "--prefix", "cf", "--nodes", "1")]
    seen.append(_wait(lambda: fleet.list_nodes("cf") == ["cf1"] and fleet.list_nodes("cf")))
    seen += [cli(srv, "terminate"), cli(srv, "terminate", "--prefix", "cf")]
    seen.append(_wait(lambda: fleet.list_nodes("cf") == [] and ["gone"]))
    return seen


def _recycle_waits(e):
    """``recycle``'s 10 s: until the server's fleet has no ``cf`` node."""
    return lambda s: _wait(lambda: not e.servers[-1].fleet.list_nodes("cf"))


def c_reset(e, cli):
    srv = e.server(lease_seconds=30)
    targets = _file(e, "t.txt", "a\nb\n")
    seen = [cli(srv, "scan", "--file", targets, "--module", "echo", "--batch-size", "1"),
            cli(srv, "reset"), cli(srv, "scans"), cli(srv, "jobs"), cli(srv)]
    return seen


def c_configure(e, cli):
    srv = e.server(lease_seconds=30)
    home = e.root / "home"
    home.mkdir()
    path = _file(e, "cfg/swarm.json", "{}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        seen = [cli(srv, "--configure"), cli(srv, "--configure", "--config", path)]
        saved = [json.loads(p.read_text()) for p in (home / ".swarm_tpu.json", Path(path))]
        seen.append([{k: (v.replace(f":{srv.port}", ":PORT") if isinstance(v, str) else v)
                      for k, v in doc.items()} for doc in saved])
        # the saved files alone reach the server
        seen += [cli(None, "scans"), cli(None, "scans", "--config", path)]
    return seen


def c_tail(e, cli):
    srv = e.server(lease_seconds=30)
    targets = _file(e, "tail.txt", "aa\nbb\ncc\n")
    seen = [cli(srv, "scan", "--file", targets, "--module", "echo", "--batch-size", "2")]
    _drain(e, srv)
    with pytest.MonkeyPatch.context() as mp:
        # three empty polls end the follow (36,000 in a terminal)
        mp.setattr(cli.mod.JobClient.tail, "__defaults__", (2,))
        seen.append(cli(srv, "jobs", "--tail"))
        seen.append(cli(srv, "scans", "--tail"))
    return seen


def c_unreachable(e, cli):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen = []
    for action in (["scans"], ["reset"], ["cat", "--scan-id", "x_1"]):
        rc, text = cli(None, *action, "--server-url", f"http://127.0.0.1:{port}",
                       "--api-key", KEY)
        seen.append([rc, text.replace(f":{port}", ":PORT")])
    return seen


SCRIPTS = {
    "scan": (c_scan, None), "scan_autoscale": (c_scan_autoscale, None),
    "scan_qos": (c_scan_qos, None), "views": (c_views, None),
    "metrics": (c_metrics, None), "dead_letter": (c_dead_letter, None),
    "tenants": (c_tenants, None), "stream": (c_stream, None), "trace": (c_trace, None),
    "monitor": (c_monitor, None), "fleet": (c_fleet, _recycle_waits),
    "reset": (c_reset, None), "configure": (c_configure, None), "tail": (c_tail, None),
    "unreachable": (c_unreachable, None),
}


@pytest.mark.parametrize("server", SIDES)
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_cli_action_equals_jax(name, server, tmp_path, monkeypatch):
    script, sleep = SCRIPTS[name]
    out = run_clients(script, server, tmp_path, monkeypatch, sleep)
    CHECKS[name](out["seen"]["seen"], out["seen"]["events"])


def _check_scan(seen, events):
    assert seen[0] == [1, "Both file and module are required for starting a scan\n"]
    assert seen[1][0] == 0 and "Start Scan Status Code: 200" in seen[1][1]
    statuses = seen[3]["body"]
    assert sorted(s["total_chunks"] for s in statuses["scans"]) == [3, 3]  # 5 // 1.8 = 2
    assert [json.loads(x)["event"] for x in events] == ["scan.submit"] * 2
    assert [json.loads(x)["batch_size"] for x in events] == [2, 2]


def _check_scan_autoscale(seen, events):
    assert seen[0] == [1, "Both prefix and nodes are required for autoscale\n"]
    assert seen[1][1].startswith("202 ") and seen[2] == ["as1", "as2"]
    [scan] = seen[3]["body"]["scans"]
    assert scan["total_chunks"] == 5  # 9 lines / (2 × 1.8) → batches of 2


def _check_scan_qos(seen, events):
    assert seen[2][0].startswith("probe_") and seen[2][1].startswith("probe_")
    jobs = seen[3]["body"]["jobs"]
    assert {j["qos"] for j in jobs.values() if j["module"] == "probe"} == {"interactive"}


def _check_views(seen, events):
    assert all(rc == 0 for rc, _ in seen)
    assert seen[0][1].count("\n") == 5  # a header, no row
    assert "| idle      | pending | 1.5s " in seen[4][1] and "| w1 " in seen[4][1]
    assert "in progress" in seen[5][1] and "| complete    | w1 " in seen[5][1]
    assert "| 33.33 |" in seen[6][1] and "| 3.5m " in seen[7][1]
    assert seen[8][1].count("| complete ") == 3 and "| 100.0 |" in seen[9][1]


def _check_metrics(seen, events):
    rc, text = seen[0]
    assert rc == 0 and text.startswith("dead-letter jobs: 0\nbreakers: all closed")
    assert "swarm_queue_jobs_queued_total" in text


def _check_dead_letter(seen, events):
    assert seen[0][1].startswith("Dead-letter jobs: 0")
    assert seen[1][1].startswith("Dead-letter jobs: 1") and "cmd failed x1" in seen[1][1]
    assert seen[2] == [1, "--job-id is required for dead-letter --requeue\n"]
    assert seen[3][0] == 1 and seen[4][0] == 0 and seen[5][1].startswith("Dead-letter jobs: 0")


def _check_tenants(seen, events):
    assert seen[0][0] == 0 and seen[0][1].startswith("Tenants: 1\n")  # the default
    assert "Start Scan Status Code: 429" in seen[4][1] and seen[4][0] == 1
    assert "acme" in seen[5][1] and "noisy" in seen[5][1]


def _check_stream(seen, events):
    assert seen[0] == [1, "scan-id is required for stream\n"]
    assert seen[2][1].count("Uploading chunk") == 3 and seen[3] == 3
    assert seen[4][1] == "".join(f"host{i}.example\n" for i in range(23))
    assert seen[5][1] == "".join(f"host{i}.example\n" for i in range(20, 23))
    # /raw joins the chunks' outputs as they are, then print's newline
    assert seen[6][1] == "".join(
        "".join(f"host{i}.example\n" for i in range(a, b)).rstrip("\n")
        for a, b in ((0, 10), (10, 20), (20, 23))) + "\n"
    assert [json.loads(x)["event"] for x in events] == ["scan.stream_start"]


def _check_trace(seen, events):
    assert seen[0] == [1, "scan-id is required for trace\n"]
    rc, text = seen[2]
    assert rc == 0 and "queue-wait" in text and "critical path" in text
    assert json.loads(events[0])["trace_id"] in text
    assert seen[3][0] == 1 and seen[3][1].startswith("No trace for scan nosuch_1")


def _check_monitor(seen, events):
    assert seen[0][1].startswith("Monitors: 0")
    assert seen[1][0] == 1 and seen[2][0] == 0
    assert seen[5] == [1, "--monitor-id is required for monitor pause\n"]
    assert "yes" in seen[7][1] and seen[9][0] == 1
    records = [json.loads(x) for x in seen[14][1].splitlines()]
    assert [r["seq"] for r in records] == [0, 1, 2]
    assert seen[15][1] == seen[14][1].splitlines(True)[2]


def _check_fleet(seen, events):
    assert seen[0] == [1, "Both prefix and nodes are required for spinning up\n"]
    assert seen[1] == [0, "Successfully issued spinup for prefix cf\n"]
    assert seen[3][0] == 1 and seen[4][0] == 0
    assert "Waiting 10 seconds" in seen[4][1] and seen[5] == ["cf1"]
    assert seen[6] == [1, "Prefix is required for spinning down\n"] and seen[7][0] == 0


def _check_reset(seen, events):
    assert seen[1][0] == 0 and seen[2][1].count("\n") == 5  # an empty table
    assert seen[4] == [0, ""]


def _check_configure(seen, events):
    assert seen[0] == seen[1] == [0, "Configuration saved\n"]
    assert all(d["server_url"] == "http://127.0.0.1:PORT" and d["api_key"] == KEY
               for d in seen[2])
    assert all(s[0] == 0 and s[1].startswith("Scan Information:") for s in seen[3:])


def _check_tail(seen, events):
    assert seen[1][1].endswith("+\naa\nbb\ncc\n")  # the two completed chunks, once
    assert seen[2][1].endswith("+\n")


def _check_unreachable(seen, events):
    assert all(s == [2, "Cannot reach server at http://127.0.0.1:PORT\n"] for s in seen)


CHECKS = {name: globals()[f"_check_{name}"] for name in SCRIPTS}


# ---------------------------------------------------------------------------
# state across the packages


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_configure_file_reads_across(writer, reader, tmp_path):
    """A ``--configure`` file that one package's CLI wrote loads equal
    in both packages' ``Config``."""
    path = tmp_path / "swarm.json"
    path.write_text("{}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = CLI[writer].main(["--configure", "--config", str(path), "--server-url",
                               "http://10.9.8.7:4242", "--api-key", "across"])
    assert rc == 0 and out.getvalue() == "Configuration saved\n"
    mine = CONFIG[writer].Config.load(path=str(path))
    theirs = CONFIG[reader].Config.load(path=str(path))
    assert dataclasses.asdict(theirs) == dataclasses.asdict(mine)
    assert theirs.resolve_url() == "http://10.9.8.7:4242" and theirs.api_key == "across"


@pytest.mark.parametrize("server", SIDES)
@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_scan_reads_across(writer, reader, server, tmp_path):
    """A scan that one package's ``scan`` submitted, its chunks done over
    HTTP, is read byte-equal by both packages' ``cat`` and ``stream``."""
    p = PKG[server]
    srv = p.app.SwarmServer(p.config.Config(
        host="127.0.0.1", port=0, api_key=KEY, blob_root=str(tmp_path / "blobs"),
        doc_root=str(tmp_path / "docs"), gateway_stream_poll_s=0.01))
    srv.start_background()
    url = ["--server-url", f"http://127.0.0.1:{srv.port}", "--api-key", KEY]
    try:
        targets = tmp_path / "t.txt"
        targets.write_text("".join(f"10.1.0.{i}\n" for i in range(7)))
        with contextlib.redirect_stdout(io.StringIO()):
            assert CLI[writer].main(["scan", "--file", str(targets), "--module", "echo",
                                     "--batch-size", "3"] + url) == 0
        [scan_id] = [s["scan_id"] for s in CLI[reader].JobClient(
            f"http://127.0.0.1:{srv.port}", KEY).get_statuses()["scans"]]
        auth = {"Authorization": f"Bearer {KEY}"}
        base = f"http://127.0.0.1:{srv.port}"
        import requests

        for i in range(3):
            job = requests.get(base + "/get-job", params={"worker_id": "w"}, headers=auth,
                               timeout=10).json()
            chunk = requests.get(base + f"/get-input-chunk/{scan_id}/{job['chunk_index']}",
                                 headers=auth, timeout=10).content
            requests.post(base + f"/put-output-chunk/{scan_id}/{job['chunk_index']}",
                          data=chunk.upper(), headers=auth, timeout=10)
            requests.post(base + f"/update-job/{job['job_id']}", json={"status": "complete"},
                          headers=auth, timeout=10)
        read = {}
        for side in (writer, reader):
            for action in ("cat", "stream"):
                with contextlib.redirect_stdout(io.StringIO()) as out:
                    assert CLI[side].main([action, "--scan-id", scan_id] + url) == 0
                read[side, action] = out.getvalue()
    finally:
        srv.shutdown()
    assert read[reader, "cat"] == read[writer, "cat"]
    assert read[reader, "stream"] == read[writer, "stream"]
    assert read[reader, "stream"] == "".join(f"10.1.0.{i}\n".upper() for i in range(7))


# ---------------------------------------------------------------------------
# the reference's client-rendering cases, on the port's client and server


def test_render_workers_drain_annotation_and_advisor_line():
    """``tests/test_fleet.py``: per-worker state with the drain reason
    inlined, heartbeat age, and the advisor's target-vs-actual line."""
    from swarm_tpu_torch.client.cli import _fmt_age, render_workers

    assert _fmt_age(None) == ""
    assert _fmt_age(100.0, now=103.2) == "3.2s"
    assert _fmt_age(1.0, now=301.0) == "5.0m"
    assert _fmt_age(1.0, now=7201.0) == "2.0h"
    statuses = {
        "workers": {
            "w0": {"status": "active", "last_contact": 100.0, "polls_with_no_jobs": 0},
            "w1": {"status": "preempted", "last_contact": 99.0, "polls_with_no_jobs": 3},
        },
        "draining": {"w1": "preempted"},
    }
    health = {"autoscale": {"prefix": "swarm-", "target_nodes": 8, "current_nodes": 3,
                            "action": "spin-up", "dry_run": True, "queue_depth": 12,
                            "forecast_jobs": 40.5}}
    out = render_workers(statuses, health)
    assert "preempted (preempted)" in out and "active" in out
    assert ("autoscale[swarm-]: target 8 vs actual 3 nodes"
            " (spin-up, dry-run); queue depth 12, forecast 40.5 jobs" in out)
    assert "autoscale[" not in render_workers(statuses, None)
    assert out.split("\n", 1)[1] == j_cli.render_workers(statuses, health).split("\n", 1)[1]


@pytest.fixture
def stack(tmp_path, monkeypatch):
    """``tests/test_end_to_end.py``'s stack on the port: its server, an
    ``echo`` module, and the port's worker on the CPU."""
    monkeypatch.setenv("SWARM_TEMPLATES_DIR", str(REPO / "tests" / "data" / "templates"))
    modules = tmp_path / "modules"
    modules.mkdir()
    (modules / "echo.json").write_text(json.dumps({"command": "cat {input} > {output}"}))
    cfg = t_config.Config(host="127.0.0.1", port=0, api_key="e2ekey",
                          blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
                          modules_dir=str(modules), poll_interval_idle_s=0.05,
                          poll_interval_busy_s=0.01, gateway_stream_poll_s=0.01)
    from swarm_tpu_torch.server.app import SwarmServer

    srv = SwarmServer(cfg)
    srv.start_background()
    cfg.server_url = f"http://127.0.0.1:{srv.port}"
    yield cfg, srv, tmp_path
    srv.shutdown()


def _port_worker(cfg, max_jobs: int, worker_id: str = "tpu-w0"):
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    names = {f.name for f in dataclasses.fields(WorkerConfig)}
    fields = {**cfg.__dict__, "max_jobs": max_jobs, "worker_id": worker_id}
    proc = JobProcessor(WorkerConfig(**{k: v for k, v in fields.items() if k in names}),
                        device="cpu")
    proc.process_jobs()
    return proc


def test_cli_actions_render(stack, capsys):
    cfg, srv, tmp_path = stack
    scan_file = tmp_path / "t.txt"
    scan_file.write_text("one\ntwo\n")
    base_args = ["--server-url", cfg.resolve_url(), "--api-key", cfg.api_key]
    assert t_cli.main(["scan", "--file", str(scan_file), "--module", "echo",
                       "--batch-size", "1"] + base_args) == 0
    _port_worker(cfg, max_jobs=2)
    for action in ("workers", "jobs", "scans"):
        assert t_cli.main([action] + base_args) == 0
    captured = capsys.readouterr().out
    assert "tpu-w0" in captured and "complete" in captured
    assert t_cli.main(["reset"] + base_args) == 0


def test_cli_stream_and_cat(stack, monkeypatch, capsys):
    """stdin → rolling 10-line chunks → ``/queue`` under a caller-fixed
    scan id, then ``cat``."""
    cfg, srv, tmp_path = stack
    base_args = ["--server-url", cfg.resolve_url(), "--api-key", cfg.api_key]
    lines = "".join(f"host{i}.example\n" for i in range(23))  # 2 full + 1 partial
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    monkeypatch.setattr(t_cli.time, "sleep", lambda s: None)
    assert t_cli.main(["stream", "--module", "echo", "--scan-id", "echo_777",
                       "--batch-size", "0"] + base_args) == 0
    out = capsys.readouterr().out
    assert out.count("Uploading chunk") == 3  # the trailing partial flushed too
    _port_worker(cfg, max_jobs=3)
    assert t_cli.main(["cat", "--scan-id", "echo_777"] + base_args) == 0
    catted = capsys.readouterr().out
    for i in (0, 9, 10, 19, 20, 22):
        assert f"host{i}.example" in catted


def test_cli_tail_follows_completed_chunks(stack):
    """``/get-latest-chunk`` pops the completed list, ``/get-chunk``
    fetches the output."""
    cfg, srv, tmp_path = stack
    scan_file = tmp_path / "tail.txt"
    scan_file.write_text("aa\nbb\ncc\n")
    client = t_cli.JobClient(cfg.resolve_url(), cfg.api_key)
    code, _ = client.start_scan(str(scan_file), "echo", 0, 0)
    assert code == 200
    _port_worker(cfg, max_jobs=1)
    chunk = client.get_latest_chunk_raw()
    assert chunk is not None and "aa" in chunk and "cc" in chunk
    assert client.get_latest_chunk_raw() is None  # the completed list drained


def test_cli_spinup_terminate_recycle(tmp_path, monkeypatch, capsys):
    """The CLI's fleet actions against the port's process provider, its
    nodes ``python -m swarm_tpu_torch.worker --device cpu``."""
    from swarm_tpu_torch.server.app import SwarmServer
    from swarm_tpu_torch.server.fleet import ProcessProvider

    modules = tmp_path / "modules"
    modules.mkdir()
    cfg = t_config.Config(host="127.0.0.1", port=0, api_key="cli-fleet",
                          blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
                          modules_dir=str(modules), fleet_provider="process")
    monkeypatch.setenv("SWARM_POLL_INTERVAL_IDLE_S", "0.2")
    monkeypatch.chdir(REPO)  # the spawned ``-m`` finds the package
    fleet = ProcessProvider(cfg, extra_args=["--device", "cpu"])
    srv = SwarmServer(cfg, fleet=fleet)
    srv.start_background()
    cfg.server_url = f"http://127.0.0.1:{srv.port}"
    base_args = ["--server-url", cfg.resolve_url(), "--api-key", cfg.api_key]
    real_sleep = time.sleep
    monkeypatch.setattr(t_cli.time, "sleep", lambda s: real_sleep(min(s, 0.05)))

    def until(ready):
        deadline = time.monotonic() + 15
        while not ready() and time.monotonic() < deadline:
            real_sleep(0.1)

    try:
        assert t_cli.main(["spinup", "--prefix", "cf", "--nodes", "2"] + base_args) == 0
        until(lambda: len(fleet.list_nodes("cf")) == 2)
        assert sorted(fleet.list_nodes("cf")) == ["cf1", "cf2"]
        # recycle = spin-down + spin-up
        assert t_cli.main(["recycle", "--prefix", "cf", "--nodes", "1"] + base_args) == 0
        until(lambda: fleet.list_nodes("cf") == ["cf1"])
        assert fleet.list_nodes("cf") == ["cf1"]
        assert t_cli.main(["terminate", "--prefix", "cf"] + base_args) == 0
        until(lambda: not fleet.list_nodes("cf"))
        assert fleet.list_nodes("cf") == []
    finally:
        fleet.shutdown()
        srv.shutdown()


def test_cli_dead_letter_list_and_requeue(tmp_path, capsys):
    """``tests/test_resilience.py``: the dead-letter view, its requeue,
    and ``metrics`` led by the resilience summary."""
    from swarm_tpu_torch.server.app import SwarmServer

    cfg = t_config.Config(host="127.0.0.1", port=0, api_key="dlkey",
                          blob_root=str(tmp_path / "b"), doc_root=str(tmp_path / "d"),
                          max_attempts=1, lease_seconds=0.02)
    srv = SwarmServer(cfg)
    srv.start_background()
    try:
        q = srv.queue
        q.queue_scan({"module": "echo", "file_content": ["t\n"], "batch_size": 1})
        job = q.next_job("w0")
        time.sleep(0.05)
        assert q.next_job("w1") is None  # expiry + attempts=1 → dead letter
        base = ["--server-url", f"http://127.0.0.1:{srv.port}", "--api-key", "dlkey"]
        assert t_cli.main(["dead-letter"] + base) == 0
        out = capsys.readouterr().out
        assert "Dead-letter jobs: 1" in out and job["job_id"] in out
        assert t_cli.main(["dead-letter", "--requeue", "--job-id", job["job_id"]] + base) == 0
        assert q.dead_letter_jobs() == []
        assert t_cli.main(["metrics"] + base) == 0
        out = capsys.readouterr().out
        assert "dead-letter jobs: 0" in out and "breakers:" in out
    finally:
        srv.shutdown()


def test_tenants_endpoint_and_cli(tmp_path, capsys):
    """``tests/test_gateway.py``: ``/tenants`` and the ``tenants`` view."""
    import requests

    from swarm_tpu_torch.server.app import SwarmServer

    srv = SwarmServer(t_config.Config(
        host="127.0.0.1", port=0, api_key="gk", blob_root=str(tmp_path / "blobs"),
        doc_root=str(tmp_path / "docs"), gateway_tenant_rate=0.2, gateway_tenant_burst=2))
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"

    def post(tenant, scan_id):
        return requests.post(base + "/queue", json={
            "module": "echo", "file_content": ["x\n"], "batch_size": 1, "scan_id": scan_id},
            headers={"Authorization": "Bearer gk", "X-Swarm-Tenant": tenant}, timeout=10)

    try:
        post("acme", "acme_5")
        for i in range(3):
            post("noisy", f"nz_{i}")
        data = requests.get(base + "/tenants", headers={"Authorization": "Bearer gk"},
                            timeout=10).json()["tenants"]
        assert data["acme"]["admitted"] == 1 and data["acme"]["queue_depth"] == 1
        assert data["noisy"]["shed"] >= 1
        rc = t_cli.main(["tenants", "--server-url", base, "--api-key", "gk"])
        out = capsys.readouterr().out
        assert rc == 0 and "acme" in out and "noisy" in out
    finally:
        srv.shutdown()


def test_dispatched_scan_waterfall_renders(stack):
    """``tests/test_trace_waterfall.py``: a scan of two chunks through
    the port's worker, its waterfall rendered by the port's
    ``render_trace``."""
    from swarm_tpu_torch.telemetry import tracing

    cfg, srv, tmp_path = stack
    tracing.set_enabled(True)
    try:
        scan_file = tmp_path / "targets.txt"
        scan_file.write_text("alpha\nbeta\n")
        client = t_cli.JobClient(cfg.resolve_url(), cfg.api_key)
        code, _ = client.start_scan(str(scan_file), "echo", 0, 1, scan_id="wfall_1")
        assert code == 200
        assert _port_worker(cfg, max_jobs=2, worker_id="wf-w").jobs_done == 2
        doc = client.get_trace("wfall_1")
    finally:
        tracing.set_enabled(None)
    assert doc is not None and doc["trace_id"] == client.last_trace_id
    assert tracing.waterfall_orphans(doc) == []
    rendered = t_cli.render_trace(doc)
    for needle in ("wfall_1", "queue-wait", "execute", "critical path"):
        assert needle in rendered, (needle, rendered)
    assert rendered == j_cli.render_trace(doc)


def test_monitor_feed_resumes_from_its_cursor(tmp_path):
    """``tests/test_monitor.py``: two feed records over the raw wire,
    then the port's ``monitor_feed`` from the cursor: the rest, no
    duplicate; after ``rm`` the generator ends on its own."""
    import requests

    from swarm_tpu_torch.datamodel import chunk_input_key
    from swarm_tpu_torch.server.app import SwarmServer

    srv = SwarmServer(t_config.Config(
        host="127.0.0.1", port=0, api_key="sk", blob_root=str(tmp_path / "blobs"),
        doc_root=str(tmp_path / "docs"), monitor_tick_s=3600.0, monitor_feed_poll_s=0.01,
        monitor_feed_idle_timeout_s=1.0))
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    auth = {"Authorization": "Bearer sk"}
    try:
        r = requests.post(base + "/monitor", headers=auth, timeout=10, json={
            "monitor_id": "m1", "module": "monmod", "targets": [f"t{i}\n" for i in range(4)],
            "interval_s": 3600.0, "batch_size": 1})
        assert r.status_code == 200
        assert srv.monitor.tick(now=time.time() + 1e6) == 1
        while (job := requests.get(base + "/get-job", params={"worker_id": "w"},
                                   headers=auth, timeout=10)).status_code == 200:
            job = job.json()
            sid, idx = job["scan_id"], int(job["chunk_index"])
            raw = srv.queue.blobs.get(chunk_input_key(sid, idx)).decode()
            out = "".join(f"v:{ln}\n" for ln in raw.split("\n"))
            requests.post(base + f"/put-output-chunk/{sid}/{idx}", data=out.encode(),
                          headers=auth, timeout=10)
            requests.post(base + f"/update-job/{job['job_id']}", json={"status": "complete"},
                          headers=auth, timeout=10)
        _wait(lambda: srv.monitor.drain() > 0, 20.0)
        resp = requests.get(base + "/monitor-feed/m1", headers=auth, stream=True, timeout=10)
        acked = []
        for line in resp.iter_lines():
            acked.append(json.loads(line))
            if len(acked) == 2:
                break
        resp.close()
        assert [r["seq"] for r in acked] == [0, 1]
        client = t_cli.JobClient(base, "sk")
        resumed = []
        for rec in client.monitor_feed("m1", from_seq=acked[-1]["seq"] + 1):
            resumed.append(rec)
            if len(resumed) == 2:
                break
        assert [r["seq"] for r in resumed] == [2, 3]
        assert [r["target"] for r in acked + resumed] == ["t0", "t1", "t2", "t3"]
        requests.post(base + "/monitor/m1", json={"op": "rm"}, headers=auth, timeout=10)
        assert [r["seq"] for r in client.monitor_feed("m1")] == [0, 1, 2, 3]
    finally:
        srv.shutdown()
