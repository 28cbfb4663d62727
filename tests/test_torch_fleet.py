"""The port's fleet orchestration (``swarm_tpu_torch/server/fleet.py``)
against the JAX package's (``swarm_tpu/server/fleet.py``), on the CPU.

- the module is a copy: its code is the reference's with the package
  name changed, docstrings and comments aside, and its metric handles
  are the same ``swarm_fleet_*`` families;
- each case is a script of ``tests/test_fleet.py`` (16 of its 17: the
  ``render_workers`` case waits for the client) over one package's
  fleet module. It runs once on each package, and what the script saw
  (names, provider kinds, wire payloads recorded by the reference's
  fake ``requests`` layer, node lists, the simulated provider's
  ``events`` and callbacks, the advisor's recommendations) and the
  ``swarm_fleet_*`` samples that moved are equal. The forecaster,
  simulated-provider and advisor scripts run on one injected clock;
- ``ProcessProvider`` spawns each package's own worker: the port's is
  ``python -m swarm_tpu_torch.worker`` and runs on the card unless told
  otherwise, so the port's provider gets ``extra_args=["--device",
  "cpu"]``, which it passes on the worker's command line.

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import ast
import contextlib
import re
import threading
import time
from types import SimpleNamespace

from test_fleet import _FakeQueue, _FakeRequests, _NodesProvider

import swarm_tpu.config as j_config
import swarm_tpu.server.fleet as j_fleet
import swarm_tpu.server.queue as j_queue
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.fleet_export as j_fleet_export
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.server.fleet as t_fleet
import swarm_tpu_torch.server.queue as t_queue
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.fleet_export as t_fleet_export
import swarm_tpu_torch.telemetry.metrics as t_metrics

PKG = {
    "jax": SimpleNamespace(config=j_config, fleet=j_fleet, queue=j_queue, stores=j_stores,
                           metrics=j_metrics, worker="swarm_tpu.worker", extra=[]),
    "torch": SimpleNamespace(config=t_config, fleet=t_fleet, queue=t_queue, stores=t_stores,
                             metrics=t_metrics, worker="swarm_tpu_torch.worker",
                             extra=["--device", "cpu"]),
}
SIDES = ("jax", "torch")


# ---------------------------------------------------------------------------
# the copy


def stripped(source: str) -> str:
    """A module's code with its docstrings removed (comments go with
    the parse), the JAX package's name written as the port's."""
    tree = ast.parse(re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", source))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree)


def test_fleet_is_a_copy_of_the_reference():
    with open(j_fleet.__file__) as f, open(t_fleet.__file__) as g:
        assert stripped(g.read()) == stripped(f.read())


def test_fleet_families_are_the_reference_families():
    names = ("FLEET_NODES", "FLEET_TARGET", "FLEET_FORECAST", "FLEET_SCALE_EVENTS",
             "FLEET_PREEMPTIONS", "FLEET_COLDSTART")
    for n in names:
        a, b = getattr(j_fleet_export, n), getattr(t_fleet_export, n)
        assert (a.name, a.kind, a.help, a.labelnames, getattr(a, "buckets", None)) == (
            b.name, b.kind, b.help, b.labelnames, getattr(b, "buckets", None))
        assert sorted(a._data) == sorted(b._data), n
        assert getattr(j_fleet, n) is a and getattr(t_fleet, n) is b


# ---------------------------------------------------------------------------
# the harness


def _fleet_samples(metrics) -> dict:
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in metrics.parse_exposition(metrics.REGISTRY.render())
            if name.startswith("swarm_fleet_")}


def _moved(metrics, before: dict, after: dict) -> dict:
    """Each gauge's value where it is not 0, and every other sample that
    moved."""
    gauges = {n for n, fam in metrics.REGISTRY._metrics.items() if fam.kind == "gauge"}
    out = {}
    for key, value in after.items():
        if key[0] in gauges:
            if value != 0.0:
                out[key] = value
        elif value != before.get(key, 0.0):
            out[key] = value - before.get(key, 0.0)
    return out


@contextlib.contextmanager
def zeroed_families(metrics, prefixes):
    """The samples of the ``prefixes`` families at 0 in the block, and
    as they were after it: the registry is process-wide, and other tests
    of the process move these families too (a gauge keeps the last value
    anyone set; a float sum's delta depends on where it started)."""
    saved = [(child, list(child), fam._new_child())
             for name, fam in metrics.REGISTRY._metrics.items()
             if name.startswith(prefixes)
             for child in list(fam._data.values())]
    for child, _, fresh in saved:
        child[:] = fresh
    try:
        yield
    finally:
        for child, values, _ in saved:
            child[:] = values


def run_case(case) -> dict:
    """``case(p)`` on each package → what each saw; both must be equal,
    and so must the ``swarm_fleet_*`` samples each moved."""
    out = {}
    for side in SIDES:
        p = PKG[side]
        with zeroed_families(p.metrics, ("swarm_fleet_",)):
            before = _fleet_samples(p.metrics)
            seen = case(p)
            moved = _moved(p.metrics, before, _fleet_samples(p.metrics))
        out[side] = {"seen": seen, "moved": moved}
    assert out["torch"]["seen"] == out["jax"]["seen"]
    assert out["torch"]["moved"] == out["jax"]["moved"]
    return out["torch"]


# ---------------------------------------------------------------------------
# tests/test_fleet.py


def test_node_names_reference_format():
    out = run_case(lambda p: [p.fleet.generate_node_names("sw", 3),
                              p.fleet.generate_node_names("x", 0)])
    assert out["seen"] == [["sw1", "sw2", "sw3"], []]


def test_rate_limiter_caps_burst():
    def case(p):
        rl = p.fleet.RateLimiter(per_minute=5)
        t0 = time.monotonic()
        for _ in range(5):
            rl.acquire()
        fast = time.monotonic() - t0 < 0.5
        done = threading.Event()

        def sixth():
            rl.acquire()
            done.set()

        threading.Thread(target=sixth, daemon=True).start()
        return [rl.per_minute, fast, done.wait(0.3)]

    assert run_case(case)["seen"] == [5, True, False]


def test_build_provider_dispatch():
    def case(p):
        kinds = []
        for provider in ("", "process", "digitalocean", "sim", "simulated"):
            cfg = p.config.Config(fleet_provider=provider) if provider else p.config.Config()
            kinds.append(type(p.fleet.build_provider(cfg)).__name__)
        return kinds

    assert run_case(case)["seen"] == ["NullProvider", "ProcessProvider",
                                      "DigitalOceanProvider", "SimulatedProvider",
                                      "SimulatedProvider"]


def _do_provider(p, fake, **cfg_kw):
    """``tests/test_fleet.py``'s ``_do_provider`` on package ``p``."""
    cfg = p.config.Config(fleet_provider="digitalocean", fleet_api_token="tok",
                          server_url="http://c2.example:5001", api_key="fleetkey",
                          fleet_image="snapshot-123", **cfg_kw)
    provider = p.fleet.DigitalOceanProvider(cfg)
    provider._requests = fake
    return provider


def test_do_spin_up_wire_shape():
    def case(p):
        fake = _FakeRequests()
        provider = _do_provider(p, fake)
        provider.spin_up("sw", 3)
        return [provider._headers(), sorted(fake.posts, key=lambda x: x[1]["name"]),
                provider.limiter.per_minute]

    headers, posts, per_minute = run_case(case)["seen"]
    assert headers == {"Authorization": "Bearer tok"} and per_minute == 250
    assert [body["name"] for _, body in posts] == ["sw1", "sw2", "sw3"]
    assert {url for url, _ in posts} == {"https://api.digitalocean.com/v2/droplets"}
    ud = posts[0][1]["user_data"]
    assert "#cloud-config" in ud and "SERVER_URL=http://c2.example:5001" in ud
    assert "API_KEY=fleetkey" in ud and "WORKER_ID=sw1" in ud


def test_do_spin_up_skips_live_names():
    """Ensure-up: a name that is already a droplet is not created again."""
    def case(p):
        fake = _FakeRequests(droplets=[{"id": 11, "name": "sw1"}])
        _do_provider(p, fake).spin_up("sw", 3)
        return sorted(body["name"] for _, body in fake.posts)

    assert run_case(case)["seen"] == ["sw2", "sw3"]


def test_do_spin_down_prefix_scoped():
    def case(p):
        fake = _FakeRequests(droplets=[{"id": 11, "name": "sw1"}, {"id": 12, "name": "sw2"},
                                       {"id": 99, "name": "other1"}])
        provider = _do_provider(p, fake)
        listed = provider.list_nodes("sw")
        provider.spin_down("sw")
        return [listed, sorted(fake.deletes)]

    assert run_case(case)["seen"] == [["sw1", "sw2"], [
        "https://api.digitalocean.com/v2/droplets/11",
        "https://api.digitalocean.com/v2/droplets/12"]]


def test_process_provider_lifecycle():
    """Each package's provider spawns its own worker processes (the
    port's on the CPU, as asked) and kills them."""
    def case(p):
        cfg = p.config.Config(fleet_provider="process", server_url="http://127.0.0.1:1",
                              api_key="k")
        provider = p.fleet.ProcessProvider(cfg, extra_args=p.extra or None)
        try:
            provider.spin_up("pw", 2)
            provider.spin_up("pw", 2)  # ensure-up: the live names are kept
            up = sorted(provider.list_nodes("pw"))
            cmds = {n: proc.args for n, proc in provider._procs.items()}
            time.sleep(0.5)
            alive = sorted(provider.list_nodes("pw"))  # still polling, not dead
            provider.spin_down("pw")
            deadline = time.monotonic() + 10
            while provider.list_nodes("pw") and time.monotonic() < deadline:
                time.sleep(0.1)
            down = provider.list_nodes("pw")
        finally:
            provider.shutdown()
        for name, cmd in cmds.items():
            assert cmd[1:3] == ["-m", p.worker]
            assert cmd[3:] == ["--server-url", "http://127.0.0.1:1", "--api-key", "k",
                               "--worker-id", name] + p.extra
        return [up, alive, down, sorted(cmds)]

    assert run_case(case)["seen"] == [["pw1", "pw2"], ["pw1", "pw2"], [], ["pw1", "pw2"]]


def test_idle_teardown_via_queue():
    def case(p):
        class RecordingProvider(p.fleet.NullProvider):
            def __init__(self):
                self.torn_down = []

            def teardown_async(self, prefix):
                self.torn_down.append(prefix)

        fleet = RecordingProvider()
        cfg = p.config.Config(api_key="k", idle_polls_before_teardown=3)
        q = p.queue.JobQueueService(cfg, p.stores.MemoryStateStore(),
                                    p.stores.MemoryBlobStore(), p.stores.MemoryDocStore(),
                                    fleet=fleet)
        seen = [q.next_job("idle-w") for _ in range(4)]
        seen.append(q.statuses()["workers"]["idle-w"]["status"])
        seen.append(list(fleet.torn_down))
        q.next_job("idle-w")
        seen.append(q.statuses()["workers"]["idle-w"]["status"])
        seen.append(list(fleet.torn_down))
        q.queue_scan({"module": "echo", "file_content": ["x\n"], "batch_size": 1,
                      "scan_id": "echo_42"})
        seen.append(q.next_job("idle-w")["job_id"])
        seen.append(q.statuses()["workers"]["idle-w"]["status"])
        return seen

    assert run_case(case)["seen"] == [None] * 4 + ["pending", [], "inactive", ["idle-w"],
                                                   "echo_42_0", "active"]


def test_forecaster_ewma_rise_and_idle_decay_deterministic():
    def case(p):
        f = p.fleet.InflowForecaster(alpha=0.3, window_s=1.0)
        f.record(10, now=0.0)
        return [f.rate(now=0.5), f.rate(now=1.0), f.rate(now=2.0), f.rate(now=500.0),
                f.tenant_rates(now=500.0)]

    seen = run_case(case)["seen"]
    assert seen[0] == 0.0 and abs(seen[1] - 3.0) < 1e-9 and abs(seen[2] - 2.1) < 1e-9
    assert seen[3:] == [0.0, {}]


def test_forecaster_per_tenant_rates_and_sum():
    def case(p):
        f = p.fleet.InflowForecaster(alpha=1.0, window_s=1.0)
        f.record(4, tenant="a", now=0.0)
        f.record(2, tenant="b", now=0.0)
        return [f.rate("a", now=1.0), f.rate(now=1.0), f.tenant_rates(now=1.0)]

    assert run_case(case)["seen"] == [4.0, 6.0, {"a": 4.0, "b": 2.0}]


def test_sim_provider_coldstart_preempt_grace_kill_cycle():
    def case(p):
        t = [0.0]
        notices, killed, seen = [], [], []
        sim = p.fleet.SimulatedProvider(
            preempt_grace_s=5.0, coldstart_warm_s=0.25, aot_warm=True, clock=lambda: t[0],
            on_preempt_notice=notices.append, on_kill=killed.append)
        sim.spin_up("n", 2)
        seen += [sorted(sim.list_nodes("n")), sim.ready_nodes("n")]
        t[0] = 0.3
        seen += [sorted(sim.ready_nodes("n")), sim.preempt("n1"), list(notices),
                 sim.preempt("n1")]
        t[0] = 3.0
        sim.poll()
        seen += [sorted(sim.list_nodes("n")), list(killed)]
        t[0] = 5.4
        sim.poll()
        seen += [sim.list_nodes("n"), list(killed), list(sim.events)]
        return seen

    seen = run_case(case)["seen"]
    assert seen[:6] == [["n1", "n2"], [], ["n1", "n2"], True, ["n1"], False]
    assert seen[6:10] == [["n1", "n2"], [], ["n2"], ["n1"]]
    assert [(e, n) for _t, e, n in seen[10]] == [
        ("spin_up", "n1"), ("spin_up", "n2"), ("ready", "n1"), ("ready", "n2"),
        ("preempt_notice", "n1"), ("killed", "n1")]


def test_sim_spin_up_never_reprovisions_a_draining_name():
    def case(p):
        t = [0.0]
        sim = p.fleet.SimulatedProvider(preempt_grace_s=2.0, coldstart_warm_s=0.0,
                                        clock=lambda: t[0])
        sim.spin_up("n", 1)
        ready = sim.ready_nodes("n")
        sim.preempt("n1")
        sim.spin_up("n", 1)
        spin_ups = [n for _ts, e, n in sim.events if e == "spin_up"]
        t[0] = 2.5
        sim.poll()
        return [ready, spin_ups, sim.list_nodes("n"), list(sim.events)]

    assert run_case(case)["seen"][:3] == [["n1"], ["n1"], []]


def test_sim_coldstart_cold_vs_aot_warm():
    def case(p):
        t = [0.0]
        cold = p.fleet.SimulatedProvider(aot_warm=False, coldstart_cold_s=4.2,
                                         coldstart_warm_s=0.23, clock=lambda: t[0])
        warm = p.fleet.SimulatedProvider(aot_warm=True, coldstart_cold_s=4.2,
                                         coldstart_warm_s=0.23, clock=lambda: t[0])
        seen = [cold.coldstart_s, warm.coldstart_s]
        cold.spin_up("c", 1)
        warm.spin_up("w", 1)
        t[0] = 1.0
        seen += [cold.ready_nodes("c"), warm.ready_nodes("w")]
        t[0] = 4.3
        seen += [cold.ready_nodes("c")]
        # a Config's fleet_sim_* fields pick the same defaults
        sim = p.fleet.SimulatedProvider(p.config.Config(fleet_provider="sim"))
        seen += [sim.coldstart_s, sim.preempt_grace_s]
        return seen

    out = run_case(case)
    assert out["seen"][:5] == [4.2, 0.23, [], ["w1"], ["c1"]]
    # each node's cold start observed once, by the package's own histogram
    assert out["moved"][("swarm_fleet_coldstart_seconds_count", ())] == 2


def test_sim_node_factory_attaches_and_kill_reaches_handle():
    def case(p):
        t = [0.0]

        class _Handle:
            def __init__(self, name):
                self.name = name
                self.stopped = self.killed = False

            def stop(self):
                self.stopped = True

            def kill(self):
                self.killed = True

        handles = {}

        def factory(name):
            handles[name] = _Handle(name)
            return handles[name]

        sim = p.fleet.SimulatedProvider(preempt_grace_s=1.0, coldstart_warm_s=0.0,
                                        clock=lambda: t[0], node_factory=factory)
        sim.spin_up("n", 2)
        seen = [sorted(handles)]
        sim.preempt("n1")
        t[0] = 1.5
        sim.poll()
        seen.append((handles["n1"].killed, handles["n1"].stopped))
        sim.spin_down("n")
        seen.append((handles["n2"].killed, handles["n2"].stopped))
        return seen

    assert run_case(case)["seen"] == [["n1", "n2"], (True, False), (False, True)]


def test_advisor_scales_ahead_of_the_spike():
    def case(p):
        t = [0.0]
        fq, prov = _FakeQueue(), _NodesProvider()
        fc = p.fleet.InflowForecaster(alpha=0.5, window_s=1.0, clock=lambda: t[0])
        adv = p.fleet.AutoscaleAdvisor(fq, prov, jobs_per_node=4, min_nodes=0, max_nodes=8,
                                       apply_enabled=True, forecaster=fc,
                                       forecast_horizon_s=8.0, clock=lambda: t[0])
        seen = [adv.recommend("node")]
        fc.record(10, now=0.0)
        t[0] = 1.0
        seen += [adv.apply("node"), list(prov.nodes), adv.status("node")]
        return seen

    out = run_case(case)
    rec = out["seen"][1]
    assert out["seen"][0]["target_nodes"] == 0
    assert rec["action"] == "spin-up" and rec["applied"] and rec["target_nodes"] == 8
    assert rec["queue_depth"] == 0 and len(out["seen"][2]) == 8
    assert out["moved"][("swarm_fleet_scale_events_total", (("action", "spin_up"),))] == 1
    assert out["moved"][("swarm_fleet_target_nodes", ())] == 8


def test_advisor_scaledown_hysteresis_then_scale_to_zero():
    def case(p):
        t = [0.0]
        fq, prov = _FakeQueue(), _NodesProvider()
        prov.spin_up("node", 2)
        adv = p.fleet.AutoscaleAdvisor(fq, prov, jobs_per_node=1, min_nodes=1, max_nodes=4,
                                       apply_enabled=True, forecaster=None,
                                       scaledown_hysteresis=1, scale_to_zero_after_s=10.0,
                                       clock=lambda: t[0])
        seen = [adv.apply("node"), list(prov.nodes)]
        t[0] = 11.0
        seen += [adv.apply("node"), list(prov.nodes), adv.recommend("node")]
        return seen

    out = run_case(case)
    first, nodes1, second, nodes2, third = out["seen"]
    assert first["action"] == "spin-down" and not first["scale_to_zero"]
    assert nodes1 == ["node1"] and second["scale_to_zero"] and nodes2 == []
    assert third["action"] == "hold" and not third["scale_to_zero"]
    assert out["moved"][("swarm_fleet_scale_events_total",
                         (("action", "scale_to_zero"),))] == 1


def test_advisor_status_reads_without_advancing_the_control_law():
    def case(p):
        fq, prov = _FakeQueue(), _NodesProvider()
        prov.spin_up("node", 2)
        adv = p.fleet.AutoscaleAdvisor(fq, prov, jobs_per_node=1, min_nodes=0, max_nodes=4,
                                       apply_enabled=False, forecaster=None,
                                       scaledown_hysteresis=3)
        seen = [adv.recommend("node")]
        seen += [adv.status("node") for _ in range(5)]
        seen += [adv.recommend("node"), adv.recommend("node"), list(prov.nodes)]
        # from_config: the Config's fields, the forecaster built from them
        cfg = p.config.Config(gateway_autoscale_jobs_per_node=3, fleet_forecast_alpha=0.5)
        built = p.fleet.AutoscaleAdvisor.from_config(fq, prov, cfg)
        seen.append([built.jobs_per_node, built.min_nodes, built.max_nodes,
                     built.apply_enabled, built.forecaster.alpha, built.forecast_horizon_s,
                     built.scaledown_hysteresis, built.scale_to_zero_after_s])
        return seen

    seen = run_case(case)["seen"]
    assert [r["action"] for r in (seen[0], seen[6], seen[7])] == ["hold", "hold", "spin-down"]
    assert all(s["target_nodes"] == 0 and s["current_nodes"] == 2 for s in seen[1:6])
    assert seen[7]["dry_run"] and seen[8] == ["node1", "node2"]
    assert seen[9][0] == 3 and seen[9][4] == 0.5
