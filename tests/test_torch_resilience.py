"""The port's resilience layer (swarm_tpu_torch.resilience, the worker's
heartbeat, spool, transport and drain, the engine's degraded mode)
against the JAX package's.

Every scenario of ``tests/test_resilience.py`` that needs no server runs
once on each package — the same fault plans, fake clocks, stub clients
and rows — and the two outcomes must be equal, and equal to what the
reference test asserts: the fault-plan grammar, breaker transitions,
retry counts and jittered delays, heartbeat stops, spool replays, the
typed transport error, drain outcomes, and the engine's degraded and
recovered matches (template ids and extractions, exact). Intervals are
short: no sleep is longer than 0.5 s.
"""

import http.server
import json
import os
import random
import signal
import threading
import time
import types
from pathlib import Path

import pytest

import swarm_tpu.resilience.breaker as j_breaker
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.resilience.heartbeat as j_heartbeat
import swarm_tpu.resilience.spool as j_spool
import swarm_tpu.resilience.transport as j_transport
import swarm_tpu_torch.resilience.breaker as t_breaker
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.resilience.heartbeat as t_heartbeat
import swarm_tpu_torch.resilience.spool as t_spool
import swarm_tpu_torch.resilience.transport as t_transport
import torch
from swarm_tpu.config import Config
from swarm_tpu.worker import runtime as j_runtime
from swarm_tpu_torch.worker import runtime as t_runtime


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines of both packages that walk
    inline (``SWARM_WALK_THREADS=1``) unless a test sets their walk: six
    test processes share the host, and no result depends on either."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data" / "templates"


def _jax_worker(client, tmp, **cfg):
    return j_runtime.JobProcessor(Config(**cfg), client=client, work_dir=str(tmp / "wd"))


def _port_worker(client, tmp, **cfg):
    return t_runtime.JobProcessor(t_runtime.WorkerConfig(**cfg), client=client,
                                  device="cpu", work_dir=str(tmp / "wd"))


PKGS = {
    "jax": types.SimpleNamespace(
        faults=j_faults, breaker=j_breaker, transport=j_transport, heartbeat=j_heartbeat,
        spool=j_spool, runtime=j_runtime, worker=_jax_worker),
    "port": types.SimpleNamespace(
        faults=t_faults, breaker=t_breaker, transport=t_transport, heartbeat=t_heartbeat,
        spool=t_spool, runtime=t_runtime, worker=_port_worker),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS.values():
        pkg.faults.clear_plan()
    yield
    for pkg in PKGS.values():
        pkg.faults.clear_plan()


def on_both(scenario, *args) -> dict:
    """``scenario(pkg, *args)`` on each package → {"jax": ..., "port": ...};
    each package's fault plan is cleared after its run."""
    out = {}
    for name, pkg in PKGS.items():
        try:
            out[name] = scenario(pkg, *args)
        finally:
            pkg.faults.clear_plan()
    return out


def assert_equal_outcomes(out: dict, want=None):
    assert out["port"] == out["jax"]
    if want is not None:
        assert out["port"] == want


# ---------------------------------------------------------------------------
# Fault harness (tests/test_resilience.py:59-127)


def _fire(pkg, name, detail=None, exc=None) -> str:
    """One fault-point call → "ok" or the raised exception's class name."""
    try:
        pkg.faults.fault_point(name, detail=detail, exc=exc)
    except Exception as e:  # noqa: BLE001 - the outcome is the exception
        return type(e).__name__
    return "ok"


def plan_occurrences(pkg):
    plan = pkg.faults.install_plan("p.a:2,4-5")
    fired = [_fire(pkg, "p.a") for _ in range(6)]
    return fired, plan.snapshot()


def plan_detail_glob_typed(pkg):
    pkg.faults.install_plan("p.run/poison*:*")
    return [_fire(pkg, "p.run", "healthy_1_0"),
            _fire(pkg, "p.run", "poison_1_0", exc=pkg.transport.TransportError)]


def plan_sleep(pkg):
    pkg.faults.install_plan("p.slow:1:sleep=0.05")
    t0 = time.perf_counter()
    first = _fire(pkg, "p.slow")
    slept = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = _fire(pkg, "p.slow")
    return first, slept >= 0.04, second, time.perf_counter() - t0 < 0.04


def plan_seeded_probability(pkg):
    runs = []
    for _ in range(2):
        plan = pkg.faults.FaultPlan("seed=42;p.b:p0.5")
        fires = []
        for _i in range(32):
            try:
                plan.check("p.b", None, None)
                fires.append(0)
            except pkg.faults.FaultInjected:
                fires.append(1)
        runs.append(fires)
    assert runs[0] == runs[1] and 0 < sum(runs[0]) < 32
    return runs[0]


def plan_overlapping_clauses(pkg):
    plan = pkg.faults.install_plan("p.c:1;p.*:1")
    return [_fire(pkg, "p.c") for _ in range(3)], plan.snapshot()


def plan_unarmed_and_message(pkg):
    pkg.faults.clear_plan()
    unarmed = _fire(pkg, "p.anything")
    pkg.faults.install_plan("p.m:1:err=boom;p.n")
    try:
        pkg.faults.fault_point("p.m")
        message = None
    except pkg.faults.FaultInjected as e:
        message = str(e)
    return unarmed, message, _fire(pkg, "p.m"), [_fire(pkg, "p.n") for _ in range(2)]


def plan_message_with_colons_and_spaces(pkg):
    pkg.faults.install_plan(" p.m : 1 : err=host:port down ; seed=3 ")
    try:
        pkg.faults.fault_point("p.m")
        message = None
    except pkg.faults.FaultInjected as e:
        message = str(e)
    return message, pkg.faults.active_plan().seed


PLAN_SCENARIOS = {
    "occurrences_and_ranges": (plan_occurrences, (
        ["ok", "FaultInjected", "ok", "FaultInjected", "FaultInjected", "ok"],
        {"p.a": {"calls": 6, "fired": 3}})),
    "detail_glob_and_typed_exc": (plan_detail_glob_typed, ["ok", "TransportError"]),
    "sleep_action": (plan_sleep, ("ok", True, "ok", True)),
    "seeded_probability": (plan_seeded_probability, None),
    "overlapping_clauses_one_fire_per_call": (plan_overlapping_clauses, (
        ["FaultInjected", "FaultInjected", "ok"],
        {"p.c": {"calls": 3, "fired": 1}, "p.*": {"calls": 3, "fired": 1}})),
    "message_with_colons_and_spaces": (plan_message_with_colons_and_spaces,
                                       ("host:port down", 3)),
    "unarmed_noop_and_message": (plan_unarmed_and_message, (
        "ok", "boom", "ok", ["FaultInjected", "FaultInjected"])),
}


@pytest.mark.parametrize("case", sorted(PLAN_SCENARIOS))
def test_fault_plan_equals_jax(case):
    scenario, want = PLAN_SCENARIOS[case]
    assert_equal_outcomes(on_both(scenario), want)


def test_fault_plan_read_lazily_from_the_environment(monkeypatch):
    """``SWARM_FAULT_PLAN`` is read at the first fault point, once."""
    monkeypatch.setenv("SWARM_FAULT_PLAN", "p.env:1")

    def scenario(pkg):
        monkeypatch.setattr(pkg.faults, "_active", pkg.faults._UNSET)
        first, second = _fire(pkg, "p.env"), _fire(pkg, "p.env")
        return first, second, pkg.faults.active_plan().spec

    assert_equal_outcomes(on_both(scenario), ("FaultInjected", "ok", "p.env:1"))


# ---------------------------------------------------------------------------
# Circuit breaker (tests/test_resilience.py:129)


def breaker_cycle(pkg):
    pkg.breaker.reset_board()
    clock = [0.0]
    br = pkg.breaker.CircuitBreaker("t.x", threshold=2, cooldown_s=1.0,
                                    clock=lambda: clock[0])
    seen = [br.allow()]
    br.record_failure()
    seen.append(br.state)
    br.record_failure()
    seen += [br.state, br.allow()]
    clock[0] = 1.5  # cooldown elapsed → half-open, exactly one probe
    seen += [br.state, br.allow(), br.allow()]
    br.record_failure()  # the probe failed → open again
    seen.append(br.state)
    clock[0] = 3.0
    seen.append(br.allow())
    br.record_success()
    seen += [br.state, br.allow()]
    return seen


def breaker_board(pkg):
    pkg.breaker.reset_board()
    board = pkg.breaker.BreakerBoard("t.board", threshold=1, cooldown_s=60.0)
    twin = pkg.breaker.BreakerBoard("t.board", threshold=5, cooldown_s=60.0)
    board.get("a").record_failure()
    twin.get("a")  # same name, closed: must not hide the open one
    board.get("b")
    seen = [board.states(), board.any_open(), pkg.breaker.breaker_states("t.board")]
    board.reset_all()
    seen += [board.states(), board.any_open()]
    return seen


def test_breaker_cycle_equals_jax():
    assert_equal_outcomes(on_both(breaker_cycle), [
        True, "closed", "open", False, "half-open", True, False, "open", True,
        "closed", True])


def test_breaker_board_equals_jax():
    assert_equal_outcomes(on_both(breaker_board), [
        {"a": "open", "b": "closed"}, True,
        {"t.board.a": "open", "t.board.b": "closed"},
        {"a": "closed", "b": "closed"}, False])


# ---------------------------------------------------------------------------
# Retrying transport (tests/test_resilience.py:172-209)


class FlakyInner:
    def __init__(self, exc, fail_times=0):
        self.fail_times = fail_times
        self.exc = exc
        self.calls = 0

    def get_job(self, worker_id):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc("boom")
        return {"job_id": "j", "worker": worker_id}

    def update_job(self, job_id, changes, worker_id=None):
        return False  # a typed refusal: never retried


def retry_then_succeed(pkg):
    inner = FlakyInner(pkg.transport.TransportError, fail_times=2)
    delays = []
    rc = pkg.transport.RetryingServerClient(inner, retries=3, seed=3, sleep=delays.append)
    return rc.get_job("w")["job_id"], inner.calls, delays


def retry_exhausts(pkg):
    inner = FlakyInner(pkg.transport.TransportError, fail_times=99)
    rc = pkg.transport.RetryingServerClient(inner, retries=2, breaker_threshold=100,
                                            sleep=lambda s: None)
    try:
        rc.get_job("w")
        raised = None
    except pkg.transport.TransportError as e:
        raised = type(e).__name__
    return raised, inner.calls


def retry_breaker_per_operation(pkg):
    inner = FlakyInner(pkg.transport.TransportError, fail_times=99)
    rc = pkg.transport.RetryingServerClient(inner, retries=0, breaker_threshold=2,
                                            breaker_cooldown_s=60, sleep=lambda s: None)
    raised = []
    for _ in range(3):
        try:
            rc.get_job("w")
        except pkg.transport.TransportError as e:
            raised.append(type(e).__name__)
    # the other operations keep their own breaker; a typed False passes
    return raised, inner.calls, rc.update_job("j", {"status": "x"}), rc.breakers.states()


def retry_breaker_recovers_after_cooldown(pkg):
    inner = FlakyInner(pkg.transport.TransportError, fail_times=2)
    rc = pkg.transport.RetryingServerClient(inner, retries=0, breaker_threshold=2,
                                            breaker_cooldown_s=0.05, sleep=lambda s: None)
    seen = []
    for _ in range(3):
        try:
            rc.get_job("w")
        except pkg.transport.TransportError as e:
            seen.append(type(e).__name__)
    time.sleep(0.08)  # the cooldown elapses: one probe call goes through
    seen.append(rc.get_job("w")["job_id"])
    return seen, inner.calls, rc.breakers.states()


RETRY_SCENARIOS = {
    "retries_then_succeeds": (retry_then_succeed, None),
    "exhausts_and_raises": (retry_exhausts, ("TransportError", 3)),
    "breaker_recovers_after_cooldown": (retry_breaker_recovers_after_cooldown, (
        ["TransportError", "TransportError", "CircuitOpenError", "j"], 3,
        {"get_job": "closed"})),
    "breaker_fast_fails_per_operation": (retry_breaker_per_operation, (
        ["TransportError", "TransportError", "CircuitOpenError"], 2, False,
        {"get_job": "open", "update_job": "closed"})),
}


@pytest.mark.parametrize("case", sorted(RETRY_SCENARIOS))
def test_retrying_client_equals_jax(case):
    scenario, want = RETRY_SCENARIOS[case]
    out = on_both(scenario)
    assert_equal_outcomes(out, want)
    if case == "retries_then_succeeds":
        job, calls, delays = out["port"]
        # two jittered backoffs, 0.5x..1.5x of 0.2 s and 0.4 s
        assert (job, calls, len(delays)) == ("j", 3, 2)
        assert 0.1 <= delays[0] <= 0.3 and 0.2 <= delays[1] <= 0.6


def test_retrying_client_proxies_attributes_and_keywords_equal_jax():
    """Attributes the facade does not wrap (the drain and generation
    headers' values) come from the inner client; keywords reach it."""

    def scenario(pkg):
        class Inner:
            last_drain_reason, last_server_generation = "preempted", 4

            def __init__(self):
                self.seen = []

            def renew_lease(self, job_id, worker_id, saturation=None):
                self.seen.append((job_id, worker_id, saturation))
                return True

        inner = Inner()
        rc = pkg.transport.RetryingServerClient(inner, sleep=lambda s: None)
        ok = rc.renew_lease("s_1_0", "w0", saturation=0.5)
        return ok, inner.seen, rc.last_drain_reason, rc.last_server_generation

    assert_equal_outcomes(on_both(scenario), (True, [("s_1_0", "w0", 0.5)], "preempted", 4))


# ---------------------------------------------------------------------------
# Lease heartbeat with a stub client (tests/test_resilience.py:264-295)


class LeaseStub:
    """``renew_lease`` is True while the lease is ours, False once it is
    not, and raises while ``down``."""

    def __init__(self, exc, ours=True, down=False):
        self.exc, self.ours, self.down = exc, ours, down
        self.renews = 0

    def renew_lease(self, job_id, worker_id, **kw):
        self.renews += 1
        if self.down:
            raise self.exc("down")
        return self.ours


def _wait_for(cond, limit_s: float = 3.0) -> None:
    """Poll ``cond`` every 10 ms until it holds or ``limit_s`` passes."""
    deadline = time.monotonic() + limit_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


def heartbeats(mode: str) -> dict:
    """One heartbeat of each package, side by side at a 0.05 s interval,
    until each has made 3 renewal attempts (or stopped itself) → each
    package's (lease_ok, running, renewals > 1, attempts > 1, stopped,
    counts stable after stop)."""
    stubs, hbs = {}, {}
    for name, pkg in PKGS.items():
        stubs[name] = LeaseStub(pkg.transport.TransportError, ours=mode != "not_ours",
                                down=mode == "server_down")
        hbs[name] = pkg.heartbeat.LeaseHeartbeat(stubs[name], "s_1_0", "w0",
                                                 interval_s=0.05).start()
    for name, hb in hbs.items():
        _wait_for(lambda: stubs[name].renews >= 3 or not hbs[name].running)
    time.sleep(0.1)  # a ticker that stopped itself stays stopped
    running = {name: hb.running for name, hb in hbs.items()}
    for hb in hbs.values():
        hb.stop()
    after_stop = {name: stubs[name].renews for name in hbs}
    time.sleep(0.12)
    return {name: (hb.lease_ok, running[name], hb.renewals > 1, stubs[name].renews > 1,
                   not hb.running, stubs[name].renews == after_stop[name])
            for name, hb in hbs.items()}


@pytest.mark.parametrize("mode,want", [
    # keeps the chunk leased, stops with it
    ("ours", (True, True, True, True, True, True)),
    # the lease went to another worker: the ticker stops itself
    ("not_ours", (False, False, False, False, True, True)),
    # server unreachable: the ticker keeps trying
    ("server_down", (True, True, False, True, True, True)),
])
def test_lease_heartbeat_equals_jax(mode, want):
    assert_equal_outcomes(heartbeats(mode), want)


def test_heartbeat_carries_saturation_equal_jax():
    """Each renewal carries the saturation the provider reports; a
    provider that raises or reports None leaves it out."""
    values = {"ok": [0.25], "none": [None], "raises": []}

    def provider(kind):
        def fn():
            if kind == "raises":
                raise RuntimeError("no scheduler")
            return values[kind][0]
        return fn

    out = {}
    for name, pkg in PKGS.items():
        seen = {}
        for kind in values:
            calls = []

            class Stub:
                def renew_lease(self, job_id, worker_id, **kw):
                    calls.append(kw)
                    return True

            hb = pkg.heartbeat.LeaseHeartbeat(Stub(), "s_1_0", "w0", interval_s=0.05,
                                              saturation_fn=provider(kind)).start()
            _wait_for(lambda: calls)
            hb.stop()
            seen[kind] = calls[:1]
        out[name] = seen
    assert_equal_outcomes(out, {"ok": [{"saturation": 0.25}], "none": [{}], "raises": [{}]})


# ---------------------------------------------------------------------------
# Spool (tests/test_resilience.py:378-443)


class SpoolServer:
    def __init__(self, exc, fence_ok=True, fail=False):
        self.exc, self.fence_ok, self.fail = exc, fence_ok, fail
        self.puts, self.updates, self.renews = [], [], []

    def renew_lease(self, job_id, worker_id, **kw):
        if self.fail:
            raise self.exc("down")
        self.renews.append((job_id, worker_id))
        return self.fence_ok

    def put_output_chunk(self, scan_id, chunk_index, data):
        if self.fail:
            raise self.exc("down")
        self.puts.append((scan_id, chunk_index, data))
        return True

    def update_job(self, job_id, changes, worker_id=None):
        if self.fail:
            raise self.exc("down")
        self.updates.append((job_id, changes, worker_id))
        return self.fence_ok


def spool_idempotent(pkg, tmp):
    spool = pkg.spool.OutputSpool(tmp / "spool")
    spool.put("s_1_0", "s_1", 0, "w0", b"results\n", perf={"rows": 3})
    srv = SpoolServer(pkg.transport.TransportError)
    seen = [len(spool), spool.replay(srv), len(spool), spool.replay(srv)]
    return seen, srv.puts, srv.updates


def spool_down_then_fenced(pkg, tmp):
    spool = pkg.spool.OutputSpool(tmp / "spool")
    spool.put("s_1_0", "s_1", 0, "w0", b"a")
    seen = [spool.replay(SpoolServer(pkg.transport.TransportError, fail=True)), len(spool)]
    fenced = SpoolServer(pkg.transport.TransportError, fence_ok=False)
    seen += [spool.replay(fenced), len(spool)]
    # fencing is checked before the blob is touched
    return seen, fenced.renews, fenced.puts, fenced.updates


def spool_survives_restart(pkg, tmp):
    pkg.spool.OutputSpool(tmp / "spool").put("s_1_0", "s_1", 0, "w0", b"a")
    again = pkg.spool.OutputSpool(tmp / "spool")
    return len(again), again.replay(SpoolServer(pkg.transport.TransportError)), len(again)


def spool_chunk_order(pkg, tmp):
    spool = pkg.spool.OutputSpool(tmp / "spool")
    for idx in (10, 2, 0):
        spool.put(f"scanx_1_{idx}", "scanx_1", idx, "w0", b"x%d" % idx)
    spool.put("scana_1_1", "scana_1", 1, "w0", b"a1")
    srv = SpoolServer(pkg.transport.TransportError)
    return spool.replay(srv), srv.puts


def spool_orphan_and_deferred(pkg, tmp):
    spool = pkg.spool.OutputSpool(tmp / "spool")
    spool.put("s_1_0", "s_1", 0, "w0", b"a")
    spool.put("s_1_1", "s_1", 1, "w0", b"b")
    spool.put("s_1_2", "s_1", 2, "w0", b"c")
    (tmp / "spool" / "s_1_0.bin").unlink()  # a meta file without its data

    class DownAfterOne(SpoolServer):
        def update_job(self, job_id, changes, worker_id=None):
            out = super().update_job(job_id, changes, worker_id)
            self.fail = True  # the server goes away after one completion
            return out

    srv = DownAfterOne(pkg.transport.TransportError)
    return spool.replay(srv), len(spool), srv.puts, [e["job_id"] for e in spool.entries()]


def spool_half_put_is_invisible(pkg, tmp):
    spool = pkg.spool.OutputSpool(tmp / "spool")
    (tmp / "spool" / "s_1_0.bin").write_bytes(b"a")  # a put cut before its meta
    srv = SpoolServer(pkg.transport.TransportError)
    return len(spool), spool.entries(), spool.replay(srv), srv.puts


SPOOL_SCENARIOS = {
    "replay_is_idempotent": (spool_idempotent, (
        [1, 1, 0, 0], [("s_1", 0, b"results\n")],
        [("s_1_0", {"status": "complete", "perf": {"rows": 3}}, "w0")])),
    "keeps_entries_while_server_down_and_drops_fenced": (spool_down_then_fenced, (
        [0, 1, 1, 0], [("s_1_0", "w0")], [], [])),
    "survives_restart": (spool_survives_restart, (1, 1, 0)),
    "drops_orphan_meta_and_defers_on_an_outage": (spool_orphan_and_deferred, (
        1, 1, [("s_1", 1, b"b")], ["s_1_2"])),
    "half_written_put_is_invisible": (spool_half_put_is_invisible, (0, [], 0, [])),
    "replays_in_chunk_index_order": (spool_chunk_order, (4, [
        ("scana_1", 1, b"a1"), ("scanx_1", 0, b"x0"), ("scanx_1", 2, b"x2"),
        ("scanx_1", 10, b"x10")])),
}


@pytest.mark.parametrize("case", sorted(SPOOL_SCENARIOS))
def test_spool_equals_jax(case, tmp_path, capsys):
    scenario, want = SPOOL_SCENARIOS[case]
    out = {}
    for name, pkg in PKGS.items():
        out[name] = scenario(pkg, tmp_path / name)
        out[name + "_printed"] = capsys.readouterr().out
    assert out["port_printed"] == out["jax_printed"]
    if case == "replays_in_chunk_index_order":
        assert "spool replay [scana_1]: completed chunks [1]" in out["port_printed"]
        assert "spool replay [scanx_1]: completed chunks [0, 2, 10]" in out["port_printed"]
    assert_equal_outcomes({k: out[k] for k in PKGS}, want)


# ---------------------------------------------------------------------------
# The typed transport error and the wire of the new operations
# (tests/test_resilience.py:521)


class WireStub:
    """Local stand-in of the server's worker routes: an idle queue whose
    answers carry X-Swarm-Generation and (once armed) X-Swarm-Drain,
    renewals and deregistration recorded, 503 on uploads."""

    def __init__(self):
        self.bodies: list = []
        self.drain = None
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                headers = [("X-Swarm-Generation", "7")]
                if stub.drain:
                    headers.append(("X-Swarm-Drain", stub.drain))
                self._reply(204, headers)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                if self.path.startswith("/put-output-chunk/"):
                    return self._reply(503)
                stub.bodies.append((self.path, json.loads(body)))
                self._reply(200 if self.path != "/renew-lease/gone_1_0" else 409)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


def wire(pkg):
    stub = WireStub()
    client = pkg.runtime.ServerClient(stub.url, "k", timeout=5.0)
    try:
        seen = [client.get_job("w-idle"), client.last_server_generation,
                client.last_drain_reason]
        stub.drain = "preempted"
        seen += [client.get_job("w-idle"), client.last_drain_reason]
        seen += [client.renew_lease("s_1_0", "w0"), client.renew_lease("gone_1_0", "w0"),
                 client.renew_lease("s_1_0", "w0", saturation=0.25),
                 client.deregister("w0"), stub.bodies]
        try:
            client.put_output_chunk("s_1", 0, b"x")
        except pkg.transport.TransportError as e:
            seen.append(str(e))
    finally:
        stub.close()
    # drop the keep-alive pool: the test server's handler threads outlive
    # shutdown(), which a dead server's connections would not
    client.session.close()
    try:
        client.get_job("w-idle")
    except pkg.transport.TransportError as e:
        seen.append(type(e).__name__)
    pkg.faults.install_plan("transport.renew_lease/s_1_0:1")
    try:
        client.renew_lease("s_1_0", "w0")
    except pkg.transport.TransportError as e:
        seen.append(str(e))
    return seen


def test_transport_error_and_wire_equal_jax():
    assert_equal_outcomes(on_both(wire), [
        None, 7, None, None, "preempted", True, False, True, True,
        [("/renew-lease/s_1_0", {"worker_id": "w0"}),
         ("/renew-lease/gone_1_0", {"worker_id": "w0"}),
         ("/renew-lease/s_1_0", {"worker_id": "w0", "saturation": 0.25}),
         ("/deregister", {"worker_id": "w0"})],
        "put_chunk: server error 503", "TransportError",
        "injected fault at transport.renew_lease/s_1_0"])


# ---------------------------------------------------------------------------
# The engine's degraded mode (tests/test_resilience.py:552-614)


@pytest.fixture(scope="module")
def degrade_corpus():
    from swarm_tpu.fingerprints import load_corpus
    from test_match_parity import fuzz_rows
    from test_torch_walk import to_port

    templates, _ = load_corpus(DATA)
    return templates, [to_port(t) for t in templates], fuzz_rows, to_port


def _engine(name, templates, **kw):
    if name == "jax":
        from swarm_tpu.ops.engine import MatchEngine

        return MatchEngine(templates, mesh=None, **kw)
    from swarm_tpu_torch.ops.engine import MatchEngine

    return MatchEngine(templates, device="cpu", walk_threads=1, **kw)


def _view(matches) -> list:
    return [(m.template_ids, m.extractions) for m in matches]


def test_engine_degrades_to_oracle_bit_identically_equal_jax(degrade_corpus):
    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    j_rows = fuzz_rows(j_templates, random.Random(5), 24)
    out = {}
    for name, pkg in PKGS.items():
        templates = j_templates if name == "jax" else t_templates
        rows = j_rows if name == "jax" else [to_port(r) for r in j_rows]
        baseline = _view(_engine(name, templates, batch_rows=16).match(rows))
        pkg.faults.install_plan("device.dispatch:*")  # every device call fails
        eng = _engine(name, templates, batch_rows=16, device_breaker_threshold=1,
                      device_breaker_cooldown_s=60.0)
        degraded = _view(eng.match(rows))
        pkg.faults.clear_plan()
        assert degraded == baseline
        out[name] = (degraded, eng.stats.degraded_batches, eng.stats.device_faults,
                     eng._device_breakers.any_open())
    assert_equal_outcomes(out)
    assert out["port"][1] > 0 and out["port"][2] > 0 and out["port"][3]


def test_engine_device_breaker_recovers_after_cooldown_equal_jax(degrade_corpus):
    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    j_rows = fuzz_rows(j_templates, random.Random(6), 8)
    out = {}
    for name, pkg in PKGS.items():
        templates = j_templates if name == "jax" else t_templates
        rows = j_rows if name == "jax" else [to_port(r) for r in j_rows]
        eng = _engine(name, templates, batch_rows=8, device_breaker_threshold=1,
                      device_breaker_cooldown_s=0.05)
        pkg.faults.install_plan("device.dispatch:1")  # one transient fault
        first = _view(eng.match(rows))
        degraded_first = eng.stats.degraded_batches
        time.sleep(0.08)  # the cooldown elapses → the half-open probe
        second = _view(eng.match(rows))
        pkg.faults.clear_plan()
        out[name] = (first, second, degraded_first, eng.stats.degraded_batches,
                     eng.stats.device_faults, eng._device_breakers.any_open())
    assert_equal_outcomes(out)
    first, second, degraded_first, degraded, faults, any_open = out["port"]
    # the probe succeeded: the device path is back, the breaker closed
    assert first == second and degraded_first >= 1 and degraded == degraded_first
    assert faults == 1 and not any_open


def test_shape_class_equals_jax(degrade_corpus):
    """The breaker key of each encoded batch: rows × each stream's
    width, the same string in both packages."""
    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    j_rows = fuzz_rows(j_templates, random.Random(7), 40)
    j_eng = _engine("jax", j_templates, batch_rows=16)
    t_eng = _engine("port", t_templates, batch_rows=16)
    keys = []
    for n in (1, 16, 40):
        j_batch = j_eng.encode_packed(j_rows[:n])[1]
        t_batch = t_eng.encode_packed([to_port(r) for r in j_rows[:n]])[1]
        keys.append((t_eng._shape_class(t_batch), j_eng._shape_class(j_batch)))
    assert all(t == j for t, j in keys)
    assert len({t for t, _j in keys}) > 1


@pytest.fixture(scope="module")
def plan_engines(degrade_corpus):
    """Each package's engine with the pipeline off and on, the device
    breaker opening after 2 faults and cooling down at once."""
    j_templates, t_templates, _fuzz_rows, _to_port = degrade_corpus
    out = {}
    for name in PKGS:
        templates = j_templates if name == "jax" else t_templates
        off = _engine(name, templates, batch_rows=8, pipeline="off",
                      device_breaker_threshold=2, device_breaker_cooldown_s=0.0)
        on = _engine(name, templates, batch_rows=8, pipeline="on", db=off.db,
                     device_breaker_threshold=2, device_breaker_cooldown_s=0.0)
        out[name] = {"off": off, "on": on}
    return out


def _fresh(eng):
    eng.clear_content_memos()
    eng._device_breakers.reset_all()
    return eng.stats.device_faults, eng.stats.degraded_batches


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_device_dispatch_plan_degrades_two_batches_equal_jax(degrade_corpus, plan_engines,
                                                             pipeline):
    """``device.dispatch:1-2`` over 4 batches: the first two dispatches
    fail and degrade, the breaker opens at the second and (cooldown 0)
    lets the next batch probe the device, which closes it; the results
    equal the fault-free ones, in both packages."""
    j_templates, _t, fuzz_rows, to_port = degrade_corpus
    j_rows = fuzz_rows(j_templates, random.Random(8), 32)
    out = {}
    for name, pkg in PKGS.items():
        eng = plan_engines[name][pipeline]
        rows = j_rows if name == "jax" else [to_port(r) for r in j_rows]
        _fresh(eng)
        clean = _view(eng.match(rows))
        f0, d0 = _fresh(eng)
        pkg.faults.install_plan("device.dispatch:1-2")
        try:
            got = _view(eng.match(rows))
        finally:
            pkg.faults.clear_plan()
        assert got == clean
        out[name] = (got, eng.stats.device_faults - f0, eng._device_breakers.any_open())
    assert_equal_outcomes(out)
    assert out["port"][1:] == (2, False)


@pytest.mark.parametrize("prefetch", ["thread", "inline"])
def test_sched_submit_fault_propagates_out_of_run_equal_jax(degrade_corpus, plan_engines,
                                                            prefetch):
    """A fault at ``sched.submit`` is not a device fault: it ends
    ``run()`` with the injected error, in both packages."""
    j_templates, _t, fuzz_rows, to_port = degrade_corpus
    j_rows = fuzz_rows(j_templates, random.Random(9), 32)
    out = {}
    for name, pkg in PKGS.items():
        eng = plan_engines[name]["on"]
        rows = j_rows if name == "jax" else [to_port(r) for r in j_rows]
        f0, d0 = _fresh(eng)
        sched_mod = __import__(f"{'swarm_tpu' if name == 'jax' else 'swarm_tpu_torch'}.sched",
                               fromlist=["BatchScheduler"])
        sched = sched_mod.BatchScheduler(eng, sched_mod.SchedulerConfig(prefetch=prefetch))
        pkg.faults.install_plan("sched.submit:2")
        try:
            with pytest.raises(pkg.faults.FaultInjected, match="sched.submit/fresh"):
                list(sched.run([rows[i : i + 8] for i in range(0, len(rows), 8)]))
            snap = pkg.faults.active_plan().snapshot()
        finally:
            pkg.faults.clear_plan()
        out[name] = (snap["sched.submit"], eng.stats.device_faults - f0,
                     eng.stats.degraded_batches - d0)
    assert_equal_outcomes(out, ({"calls": 2, "fired": 1}, 0, 0))


def _card_typed(eng):
    """The port's CPU engine, told it sits on the card: its kernels'
    plain versions still run, but a fault is judged as on a CUDA
    device."""
    eng._on_card = True
    return eng


def _run_port(eng, rows, pipeline):
    if pipeline == "off":
        return _view(eng.match(rows))
    from swarm_tpu_torch.sched import BatchScheduler, SchedulerConfig

    sched = BatchScheduler(eng, SchedulerConfig(inflight=2))
    sched._overlap_helps = True  # through begin_packed, as on the card
    return [_view(res) for res in sched.run([rows[i : i + 8] for i in range(0, len(rows), 8)])]


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("where", ["launch", "collect"])
def test_real_kernel_error_on_the_card_propagates(degrade_corpus, monkeypatch, where, pipeline):
    """On a CUDA engine a real launch or collect error is not degraded:
    it propagates out of ``match`` and the scheduler's ``run``, and no
    batch goes to the host oracle. The JAX package degrades on any
    exception; the port keeps that only on the CPU, so no kernel
    failure on the card is hidden behind a finished job."""
    import swarm_tpu_torch.ops.match as t_match

    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    rows = [to_port(r) for r in fuzz_rows(j_templates, random.Random(10), 32)]
    eng = _card_typed(_engine("port", t_templates, batch_rows=8, pipeline=pipeline,
                              device_breaker_threshold=1))
    msg = "match_verdicts: CUDA error 700 at launch"

    def fault(*_a, **_k):
        raise RuntimeError(msg)

    if where == "launch":
        monkeypatch.setattr(t_match.kernels, "match_verdicts", fault)
    else:
        monkeypatch.setattr(eng.device, "collect", fault)
    with pytest.raises(RuntimeError, match=msg):
        _run_port(eng, rows, pipeline)
    assert (eng.stats.device_faults, eng.stats.degraded_batches) == (0, 0)
    assert not eng._device_breakers.any_open()


def test_real_kernel_error_in_a_half_open_probe_leaves_the_breaker_closed(degrade_corpus,
                                                                          monkeypatch):
    """A real error on the card during the breaker's half-open probe
    propagates, and the breaker is closed again: no probe is left out
    that would keep the shape class's later batches off the card."""
    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    rows = [to_port(r) for r in fuzz_rows(j_templates, random.Random(12), 8)]
    eng = _card_typed(_engine("port", t_templates, batch_rows=8, device_breaker_threshold=1,
                              device_breaker_cooldown_s=0.0))
    want = _view(_engine("port", t_templates, batch_rows=8).match(rows))
    t_faults.install_plan("device.dispatch:1")
    try:
        assert _view(eng.match(rows)) == want  # degraded: the breaker opens
    finally:
        t_faults.clear_plan()
    assert eng.stats.degraded_batches == 1
    eng.clear_content_memos()
    collect = eng.device.collect

    def fault(*_a, **_k):
        raise RuntimeError("illegal memory access")

    monkeypatch.setattr(eng.device, "collect", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.match(rows)  # the half-open probe's collect fails for real
    assert set(eng._device_breakers.states().values()) == {"closed"}
    monkeypatch.setattr(eng.device, "collect", collect)
    eng.clear_content_memos()
    assert _view(eng.match(rows)) == want
    assert (eng.stats.device_faults, eng.stats.degraded_batches) == (1, 1)


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_injected_fault_on_the_card_degrades(degrade_corpus, pipeline):
    """The ``device.dispatch`` fault point stands for a dispatch that
    never reached the card: on a CUDA engine it still degrades, and the
    results equal the fault-free ones. The breaker opens at the fault
    and stays open, so the batch degrades whether the pipeline retries
    its dispatch at the walk or not."""
    j_templates, t_templates, fuzz_rows, to_port = degrade_corpus
    rows = [to_port(r) for r in fuzz_rows(j_templates, random.Random(11), 32)]
    clean = _run_port(_engine("port", t_templates, batch_rows=8), rows, pipeline)
    eng = _card_typed(_engine("port", t_templates, batch_rows=8, pipeline=pipeline,
                              device_breaker_threshold=1, device_breaker_cooldown_s=60.0))
    t_faults.install_plan("device.dispatch:1")
    try:
        got = _run_port(eng, rows, pipeline)
    finally:
        t_faults.clear_plan()
    assert got == clean
    assert eng.stats.device_faults == 1 and eng.stats.degraded_batches >= 1
    assert eng._device_breakers.any_open()


# ---------------------------------------------------------------------------
# The worker's drain (tests/test_resilience.py:717-827)


class DrainClient:
    """Minimal transport for the drain path."""

    def __init__(self, exc, fail_replay=False):
        self.exc, self.fail_replay = exc, fail_replay
        self.deregistered, self.puts, self.updates = [], [], []
        self.last_drain_reason = None

    def get_job(self, worker_id):
        return None

    def renew_lease(self, job_id, worker_id, saturation=None):
        if self.fail_replay:
            raise self.exc("down")
        return True

    def put_output_chunk(self, scan_id, chunk_index, data):
        self.puts.append((scan_id, chunk_index))
        return True

    def update_job(self, job_id, changes, worker_id=None):
        self.updates.append(job_id)
        return True

    def deregister(self, worker_id):
        self.deregistered.append(worker_id)
        return True


def _drain_run(pkg, tmp, *, fail_replay=False, spooled=False, header=None, order=None,
               plan=None):
    client = DrainClient(pkg.transport.TransportError, fail_replay=fail_replay)
    if plan:
        pkg.faults.install_plan(plan)
    proc = pkg.worker(client, tmp, worker_id="wd", poll_interval_idle_s=0.01,
                      spool_dir=str(tmp / "spool"))
    if spooled:
        proc.spool.put("s_1_0", "s_1", 0, "wd", b"x")
    if header:
        client.last_drain_reason = header  # X-Swarm-Drain on the next poll
    if order:
        proc.request_drain(order)  # what the SIGTERM handler does
    proc.process_jobs()
    return proc.drain_outcome, client.deregistered, client.puts, len(proc.spool)


DRAIN_SCENARIOS = {
    "header_exits_poll_loop_and_deregisters": (
        dict(header="preempted"), ("idle", ["wd"], [], 0), "worker drained (preempted): idle"),
    "flushes_spool_before_exit": (
        dict(spooled=True, order="sigterm"), ("idle", ["wd"], [("s_1", 0)], 0),
        "worker drained (sigterm): idle"),
    "spooled_when_server_unreachable": (
        dict(spooled=True, order="sigterm", fail_replay=True), ("spooled", ["wd"], [], 1),
        "worker drained (sigterm): spooled"),
    "aborted_by_injected_fault": (
        dict(spooled=True, order="preempted", plan="worker.drain/wd:*"),
        ("aborted", [], [], 1), "worker drained (preempted): aborted"),
}


@pytest.mark.parametrize("case", sorted(DRAIN_SCENARIOS))
def test_worker_drain_equals_jax(case, tmp_path, capsys):
    kw, want, line = DRAIN_SCENARIOS[case]
    out = {}
    for name, pkg in PKGS.items():
        try:
            out[name] = _drain_run(pkg, tmp_path / name, **kw)
        finally:
            pkg.faults.clear_plan()
        assert line in capsys.readouterr().out
    assert_equal_outcomes(out, want)


def test_worker_request_drain_first_reason_wins_equal_jax(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        proc = pkg.worker(DrainClient(pkg.transport.TransportError), tmp_path / name,
                          worker_id="wd", poll_interval_idle_s=0.01)
        proc._job_in_flight = True  # the drain order lands mid-chunk
        proc.request_drain("sigterm")
        proc.request_drain("preempted")  # a later reason does not override
        proc._job_in_flight = False  # the chunk was finished first
        out[name] = (proc.drain_requested, proc.drain("sigterm"), proc.drain_outcome)
    assert_equal_outcomes(out, ("sigterm", "completed", "completed"))


# ---------------------------------------------------------------------------
# The worker's chunk under faults: spool on an outage and replay on the
# next poll, heartbeat renewals over a slow chunk, a poisoned execution,
# and the breaker reset on a server restart — the ``echo`` module (no
# device work), the same scripted server on both packages


class ScriptedServer:
    """One ``echo`` job; the first ``down_puts`` uploads and the first
    ``down_completes`` completion updates fail (a TransportError, as the
    HTTP client raises on a 5xx); later polls return no job, then a
    drain order. Every call is recorded in order."""

    def __init__(self, exc, down_puts=0, generations=None, drain_after=2, down_completes=0):
        self.exc = exc
        self.down_puts = down_puts
        self.down_completes = down_completes
        self.generations = list(generations or [])
        self.drain_after = drain_after
        self.job = {"job_id": "e_1_0", "scan_id": "e_1", "chunk_index": 0, "module": "echo"}
        self.calls: list = []
        self.statuses: list = []
        self.outputs: list = []
        self.renewals = 0
        self.polls = 0
        self.last_drain_reason = None
        self.last_server_generation = None

    def get_job(self, worker_id):
        self.polls += 1
        self.calls.append("get_job")
        if self.generations:
            self.last_server_generation = self.generations.pop(0)
        if self.polls > self.drain_after:
            self.last_drain_reason = "drain"
        job, self.job = self.job, None
        return job

    def get_input_chunk(self, scan_id, chunk_index):
        self.calls.append("get_input_chunk")
        return b"10.0.0.1\nexample.test:8443\n"

    def update_job(self, job_id, changes, worker_id=None):
        self.calls.append(f"update:{changes['status']}")
        if changes["status"] == "complete" and self.down_completes > 0:
            self.down_completes -= 1
            raise self.exc("server error 503")
        self.statuses.append(changes["status"])
        return True

    def put_output_chunk(self, scan_id, chunk_index, data):
        self.calls.append("put_output_chunk")
        if self.down_puts > 0:
            self.down_puts -= 1
            raise self.exc("server error 503")
        self.outputs.append(data)
        return True

    def renew_lease(self, job_id, worker_id, **kw):
        self.renewals += 1
        return True

    def deregister(self, worker_id):
        self.calls.append("deregister")
        return True


def worker_chunk(pkg, tmp, *, down_puts=0, plan=None, heartbeat=0.0, generations=None,
                 down_completes=0):
    srv = ScriptedServer(pkg.transport.TransportError, down_puts=down_puts,
                         generations=generations, down_completes=down_completes)
    client = pkg.transport.RetryingServerClient(srv, retries=2, sleep=lambda s: None)
    if plan:
        pkg.faults.install_plan(plan)
    proc = pkg.worker(client, tmp, worker_id="w0", modules_dir=str(REPO / "modules"),
                      poll_interval_idle_s=0.01, poll_interval_busy_s=0.0,
                      heartbeat_interval_s=heartbeat, spool_dir=str(tmp / "spool"))
    if generations:
        # the last poll before the restart saw generation 1, and the
        # dead server left the upload breaker open
        proc._seen_generation = 1
        for _ in range(5):
            client.breakers.get("put_output_chunk").record_failure()
    proc.process_jobs()
    hb = proc._last_heartbeat
    return {
        "calls": [c for c in srv.calls if c != "get_job"],
        "outputs": srv.outputs, "spooled_left": len(proc.spool),
        "drain": proc.drain_outcome, "renewals_3": srv.renewals >= 3,
        "hb_stopped": hb is not None and not hb.running,
        "breakers": sorted(set(client.breakers.states().values())),
    }


ECHO = b"10.0.0.1\nexample.test:8443\n"
PHASES = ["update:starting", "update:downloading", "get_input_chunk", "update:executing",
          "update:uploading"]
WORKER_SCENARIOS = {
    # the upload outage outlasts the retries: spooled, then replayed on
    # the next poll (the lease probe is a renewal), then the drain
    "outage_spools_then_replays": (dict(down_puts=3), {
        "calls": PHASES + ["put_output_chunk"] * 4 + ["update:complete", "deregister"],
        "outputs": [ECHO], "spooled_left": 0, "drain": "idle", "renewals_3": False,
        "hb_stopped": True, "breakers": ["closed"]}),
    # the upload lands but the completion cannot: spooled, then the
    # replay uploads again and completes
    "completion_outage_spools_then_replays": (dict(down_completes=3), {
        "calls": PHASES + ["put_output_chunk"] + ["update:complete"] * 3
        + ["put_output_chunk", "update:complete", "deregister"],
        "outputs": [ECHO, ECHO], "spooled_left": 0, "drain": "idle", "renewals_3": False,
        "hb_stopped": True, "breakers": ["closed"]}),
    # a chunk slowed past three heartbeat intervals keeps its lease
    "slow_chunk_renews_its_lease": (dict(plan="executor.run:1:sleep=0.35", heartbeat=0.06), {
        "calls": PHASES + ["put_output_chunk", "update:complete", "deregister"],
        "outputs": [ECHO], "spooled_left": 0, "drain": "idle", "renewals_3": True,
        "hb_stopped": True, "breakers": ["closed"]}),
    # a poisoned execution fails its job, the worker goes on
    "poisoned_execution_fails_the_job": (dict(plan="executor.run/e_1_*:*"), {
        "calls": PHASES[:4] + ["update:cmd failed", "deregister"], "outputs": [],
        "spooled_left": 0, "drain": "idle", "renewals_3": False, "hb_stopped": True,
        "breakers": ["closed"]}),
    # a new server generation closes the breakers the old one opened
    "server_restart_resets_breakers": (dict(generations=[2]), {
        "calls": PHASES + ["put_output_chunk", "update:complete", "deregister"],
        "outputs": [ECHO], "spooled_left": 0, "drain": "idle", "renewals_3": False,
        "hb_stopped": True, "breakers": ["closed"]}),
}


@pytest.mark.parametrize("case", sorted(WORKER_SCENARIOS))
def test_worker_chunk_under_faults_equals_jax(case, tmp_path):
    kw, want = WORKER_SCENARIOS[case]
    out = {name: None for name in PKGS}
    for name, pkg in PKGS.items():
        try:
            out[name] = worker_chunk(pkg, tmp_path / name, **kw)
        finally:
            pkg.faults.clear_plan()
    assert_equal_outcomes(out, want)


class RaiseThenCompleteServer(ScriptedServer):
    """Two ``echo`` jobs: the first one's input download raises an
    error that is not a TransportError (so ``process_chunk`` raises),
    the second completes."""

    def __init__(self, exc):
        super().__init__(exc, drain_after=99)
        self.jobs = [dict(self.job, job_id="e_1_0", chunk_index=0),
                     dict(self.job, job_id="e_1_1", chunk_index=1)]

    def get_job(self, worker_id):
        super().get_job(worker_id)
        return self.jobs.pop(0) if self.jobs else None

    def get_input_chunk(self, scan_id, chunk_index):
        if chunk_index == 0:
            self.calls.append("get_input_chunk:raised")
            raise RuntimeError("chunk store exploded")
        return super().get_input_chunk(scan_id, chunk_index)


def test_worker_max_jobs_counts_a_chunk_that_raises(tmp_path, capsys):
    """How ``--max-jobs`` counts a chunk whose processing raises: as the
    JAX worker counts it, not at all. Under ``max_jobs=1`` both workers
    poll on past the chunk that raised and return after the chunk that
    completed, with ``jobs_done == 1`` and the same polls and calls."""
    out = {}
    for name, pkg in PKGS.items():
        srv = RaiseThenCompleteServer(pkg.transport.TransportError)
        proc = pkg.worker(srv, tmp_path / name, worker_id="w0", max_jobs=1,
                          modules_dir=str(REPO / "modules"), poll_interval_idle_s=0.01,
                          poll_interval_busy_s=0.0, spool_dir=str(tmp_path / name / "spool"))
        proc.process_jobs()
        out[name] = (proc.jobs_done, srv.polls, srv.calls, srv.statuses, srv.outputs)
        assert "error processing job: chunk store exploded" in capsys.readouterr().out
    assert_equal_outcomes(out, (
        1, 2, ["get_job", "update:starting", "update:downloading", "get_input_chunk:raised",
               "get_job"] + PHASES + ["put_output_chunk", "update:complete"],
        ["starting", "downloading", "starting", "downloading", "executing", "uploading",
         "complete"], [ECHO]))


def test_worker_drain_ordered_mid_chunk_completes_the_chunk_equal_jax(tmp_path):
    """A drain order (SIGTERM's flag) that arrives while a chunk runs:
    the chunk finishes and uploads, then the worker drains with the
    outcome "completed" and deregisters."""
    out = {}
    for name, pkg in PKGS.items():
        srv = ScriptedServer(pkg.transport.TransportError, drain_after=99)
        proc = pkg.worker(srv, tmp_path / name, worker_id="w0",
                          modules_dir=str(REPO / "modules"), poll_interval_idle_s=0.01,
                          poll_interval_busy_s=0.0, spool_dir=str(tmp_path / name / "spool"))
        put = srv.put_output_chunk

        def put_then_order(scan_id, chunk_index, data, _put=put, _proc=proc):
            _proc.request_drain("sigterm")  # lands mid-chunk
            return _put(scan_id, chunk_index, data)

        srv.put_output_chunk = put_then_order
        proc.process_jobs()
        out[name] = ([c for c in srv.calls if c != "get_job"], proc.drain_outcome, srv.polls)
    assert_equal_outcomes(out, (PHASES + ["put_output_chunk", "update:complete", "deregister"],
                                "completed", 1))


WIRE_SCENARIOS = {
    # the transport.put_chunk fault point, through the default client
    "put_chunk_fault_point_spools_then_replays": (
        dict(fault_plan="transport.put_chunk:1-3"), dict(drain_on_poll=3)),
    # real 503 answers to the uploads
    "server_errors_spool_then_replay": ({}, dict(put_failures=3, drain_on_poll=3)),
    # a slow chunk's renewals over the wire
    "slow_chunk_renews_over_the_wire": (
        dict(fault_plan="executor.run:1:sleep=0.35", heartbeat_interval_s=0.06),
        dict(drain_on_poll=2)),
}


@pytest.mark.parametrize("case", sorted(WIRE_SCENARIOS))
def test_worker_over_the_wire_equals_jax(case, tmp_path):
    """Each package's worker with its default client (the retrying
    transport over ``ServerClient``) against the same local stand-in
    server (``chip_smoke.StubServer``) and an ``echo`` job."""
    from chip_smoke import API_KEY, StubServer

    cfg_kw, stub_kw = WIRE_SCENARIOS[case]
    out = {}
    for name, pkg in PKGS.items():
        stub = StubServer(ECHO, module="echo", **stub_kw)
        try:
            proc = pkg.worker(None, tmp_path / name, server_url=stub.url, api_key=API_KEY,
                              worker_id="w0", modules_dir=str(REPO / "modules"),
                              poll_interval_idle_s=0.01, poll_interval_busy_s=0.0,
                              transport_retries=2, transport_backoff_s=0.01,
                              transport_backoff_max_s=0.02,
                              spool_dir=str(tmp_path / name / "spool"), **cfg_kw)
            proc.process_jobs()
        finally:
            stub.close()
            pkg.faults.clear_plan()
        out[name] = {"statuses": stub.statuses, "uploads": stub.uploads,
                     "failed_puts": stub.failed_puts, "spool_left": len(proc.spool),
                     "drain": proc.drain_outcome, "deregistered": stub.deregistered,
                     "renewals_3": stub.renewals >= 3, "polls": stub.polls}
    want = {"statuses": ["starting", "downloading", "executing", "uploading", "complete"],
            "uploads": [ECHO], "failed_puts": stub_kw.get("put_failures", 0), "spool_left": 0,
            "drain": "idle", "deregistered": ["w0"], "renewals_3": "heartbeat_interval_s" in cfg_kw,
            "polls": stub_kw["drain_on_poll"]}
    assert_equal_outcomes(out, want)


def test_main_routes_sigterm_to_the_drain(monkeypatch, tmp_path):
    """``python -m swarm_tpu_torch.worker``: SIGTERM only asks for the
    drain, as the JAX worker's ``main`` arranges it; the poll loop then
    drains and returns."""
    seen = {}
    real = t_runtime.JobProcessor.process_jobs

    def process_jobs(proc):
        os.kill(os.getpid(), signal.SIGTERM)  # handled before the next bytecode
        seen["requested"] = proc.drain_requested
        proc.client = DrainClient(t_transport.TransportError)
        real(proc)
        seen["outcome"] = proc.drain_outcome
        seen["deregistered"] = proc.client.deregistered

    saved = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(t_runtime.JobProcessor, "process_jobs", process_jobs)
    monkeypatch.setenv("SWARM_SPOOL_DIR", str(tmp_path / "spool"))
    try:
        t_runtime.main(["--worker-id", "w-main", "--device", "cpu",
                        "--modules-dir", str(REPO / "modules")])
    finally:
        signal.signal(signal.SIGTERM, saved)
    assert seen == {"requested": "sigterm", "outcome": "idle", "deregistered": ["w-main"]}


def test_worker_config_reads_the_resilience_fields_from_env(monkeypatch, tmp_path):
    """The new fields come from ``SWARM_<FIELD>`` as the JAX config
    reads them, coerced to each field's type."""
    env = {"SWARM_LEASE_SECONDS": "90", "SWARM_TRANSPORT_RETRIES": "5",
           "SWARM_TRANSPORT_BACKOFF_S": "0.05", "SWARM_TRANSPORT_BACKOFF_MAX_S": "1.5",
           "SWARM_TRANSPORT_BREAKER_THRESHOLD": "4",
           "SWARM_TRANSPORT_BREAKER_COOLDOWN_S": "2.5", "SWARM_HEARTBEAT_INTERVAL_S": "7",
           "SWARM_SPOOL_DIR": "/tmp/spool-x",
           "SWARM_FAULT_PLAN": "executor.run:1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = t_runtime.WorkerConfig.from_env()
    (tmp_path / "none.json").write_text("{}")
    jax = Config.load(path=str(tmp_path / "none.json"), env=env)
    fields = ("lease_seconds", "transport_retries", "transport_backoff_s",
              "transport_backoff_max_s", "transport_breaker_threshold",
              "transport_breaker_cooldown_s", "heartbeat_interval_s", "spool_dir",
              "fault_plan")
    assert [getattr(port, f) for f in fields] == [getattr(jax, f) for f in fields]
    assert isinstance(port.transport_retries, int) and isinstance(port.lease_seconds, float)
    defaults = t_runtime.WorkerConfig()
    assert [getattr(defaults, f) for f in fields] == [getattr(Config(), f) for f in fields]
