"""The port's telemetry (swarm_tpu_torch.telemetry, utils/trace.py and
the worker's spans, events and families) against the JAX package's.

- the reference's unit cases of ``tests/test_telemetry.py`` and
  ``tests/test_tracing.py`` (registry, exposition, escaping, collectors,
  thread safety, events, sinks, trace ids, ``PhaseTimer``) and span
  cases, each run on both packages;
- the device profile's check that a CUDA trace names every kernel its
  block launched;
- every family the port registers exists in the JAX registry with the
  same kind, help, label names and buckets;
- end to end on the CPU: the JAX server and client mint a trace, the
  port's worker runs an ``echo`` job, and one trace id shows at every
  layer, the assembled trace included;
- one small ``tpu`` job on ``tests/data/templates`` (64 rows, batches
  of 32) through the JAX worker and the port's, off and on the pipeline,
  traced and untraced: the same ``perf`` keys in the same order, the
  same span names and nesting, the same ``rows_processed``, the same
  registry deltas, and the same output traced and untraced; a profiled
  job's output and its trace, and a profiled job whose trace lost the
  card's kernels completing with the same output, its trace kept as
  lost;
- the resilience families' deltas under a fault plan.
"""

import base64
import collections
import json
import os
import threading
import time
import types
from pathlib import Path

import pytest

import swarm_tpu.resilience.transport as j_transport
import swarm_tpu.telemetry as j_telemetry
import swarm_tpu.telemetry.engine_export as j_engine_export
import swarm_tpu.telemetry.events as j_events
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu.telemetry.tracing as j_tracing
import swarm_tpu.utils.trace as j_trace
import swarm_tpu_torch.resilience.transport as t_transport
import swarm_tpu_torch.telemetry as t_telemetry
import swarm_tpu_torch.telemetry.engine_export as t_engine_export
import swarm_tpu_torch.telemetry.events as t_events
import swarm_tpu_torch.telemetry.metrics as t_metrics
import swarm_tpu_torch.telemetry.tracing as t_tracing
import swarm_tpu_torch.utils.trace as t_trace
import torch
from swarm_tpu.client.cli import JobClient
from swarm_tpu.config import Config
from swarm_tpu.server.app import SwarmServer
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

PKGS = {
    "jax": types.SimpleNamespace(metrics=j_metrics, events=j_events, tracing=j_tracing,
                                 trace=j_trace, telemetry=j_telemetry),
    "port": types.SimpleNamespace(metrics=t_metrics, events=t_events, tracing=t_tracing,
                                  trace=t_trace, telemetry=t_telemetry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class traced:
    """Tracing on (or off) in both packages for the block, then back to
    each package's environment gate."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        for p in PKGS.values():
            p.tracing.set_enabled(self.on)

    def __exit__(self, *exc):
        for p in PKGS.values():
            p.tracing.set_enabled(None)


# ---------------------------------------------------------------------------
# (i) the reference's unit cases, on both packages


def test_counter_inc_and_labels(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("t_requests_total", "reqs", ("route",))
    c.labels(route="/a").inc()
    c.labels(route="/a").inc(2)
    c.labels(route="/b").inc()
    assert c.labels(route="/a").value == 3
    assert c.labels(route="/b").value == 1
    with pytest.raises(ValueError):
        c.labels(route="/a").inc(-1)  # counters never decrease


def test_unlabeled_counter_and_gauge(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("t_jobs_total", "jobs")
    c.inc()
    c.inc(4)
    g = reg.gauge("t_depth", "depth")
    g.set(7)
    g.inc(-2)
    text = reg.render()
    assert "t_jobs_total 5" in text
    assert "t_depth 5" in text


def test_get_or_create_same_family_and_mismatch_raises(pkg):
    reg = pkg.metrics.MetricsRegistry()
    a = reg.counter("t_shared_total", "x", ("k",))
    assert reg.counter("t_shared_total", "x", ("k",)) is a
    with pytest.raises(ValueError):
        reg.gauge("t_shared_total", "x", ("k",))  # kind mismatch
    with pytest.raises(ValueError):
        reg.counter("t_shared_total", "x", ("other",))  # label mismatch


def test_kind_misuse_and_invalid_names_raise(pkg):
    reg = pkg.metrics.MetricsRegistry()
    with pytest.raises(TypeError):
        reg.counter("t_c_total")._unlabeled().set(1)
    with pytest.raises(TypeError):
        reg.gauge("t_g")._unlabeled().observe(1)
    with pytest.raises(TypeError):
        reg.histogram("t_h")._unlabeled().inc()
    for name, labels in (("9bad", ()), ("ok_total", ("bad-label",)),
                         ("ok2_total", ("__reserved",))):
        with pytest.raises(ValueError):
            reg.counter(name, "x", labels)


def test_histogram_buckets_and_labeled_children(pkg):
    reg = pkg.metrics.MetricsRegistry()
    h = reg.histogram("t_lat_seconds", "lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h._unlabeled().observe(v)
    text = reg.render()
    for line in ('t_lat_seconds_bucket{le="0.1"} 1', 't_lat_seconds_bucket{le="1"} 3',
                 't_lat_seconds_bucket{le="10"} 4', 't_lat_seconds_bucket{le="+Inf"} 5',
                 "t_lat_seconds_count 5", "t_lat_seconds_sum 56.05"):
        assert line in text
    hp = reg.histogram("t_ph_seconds", "ph", ("phase",), buckets=(1.0,))
    hp.labels(phase="download").observe(0.5)
    hp.labels(phase="execute").observe(2.0)
    snap = reg.snapshot()["t_ph_seconds"]
    by_phase = {s["labels"]["phase"]: s["value"] for s in snap["samples"]}
    assert by_phase["download"]["count"] == 1
    assert by_phase["execute"]["buckets"]["1"] == 0  # over the top bucket


def test_label_escaping_roundtrip(pkg):
    assert pkg.metrics.escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    reg = pkg.metrics.MetricsRegistry()
    hostile = 'quote:" backslash:\\ newline:\n end'
    reg.counter("t_esc_total", "esc", ("v",)).labels(v=hostile).inc()
    text = reg.render()
    assert len([ln for ln in text.splitlines() if ln.startswith("t_esc_total{")]) == 1
    [(_name, labels, value)] = [s for s in pkg.metrics.parse_exposition(text)
                                if s[0] == "t_esc_total"]
    assert labels["v"] == hostile and value == 1


def test_exposition_golden(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("g_requests_total", "Total requests", ("code",)).labels(code="200").inc(2)
    reg.gauge("g_depth", "Queue depth").set(3)
    reg.histogram("g_lat_seconds", "Latency", buckets=(0.5,))._unlabeled().observe(0.25)
    assert reg.render() == (
        "# HELP g_depth Queue depth\n"
        "# TYPE g_depth gauge\n"
        "g_depth 3\n"
        "# HELP g_lat_seconds Latency\n"
        "# TYPE g_lat_seconds histogram\n"
        'g_lat_seconds_bucket{le="0.5"} 1\n'
        'g_lat_seconds_bucket{le="+Inf"} 1\n'
        "g_lat_seconds_sum 0.25\n"
        "g_lat_seconds_count 1\n"
        "# HELP g_requests_total Total requests\n"
        "# TYPE g_requests_total counter\n"
        'g_requests_total{code="200"} 2\n'
    )
    assert pkg.metrics.CONTENT_TYPE == "text/plain; version=0.0.4; charset=utf-8"


def test_parse_exposition_rejects_malformed(pkg):
    parse = pkg.metrics.parse_exposition
    with pytest.raises(ValueError, match="line 1"):
        parse("not a metric line at all!\n")
    with pytest.raises(ValueError, match="line 2"):
        parse("ok_total 1\nbad{unclosed 2\n")
    with pytest.raises(ValueError):
        parse('x{l="v"} notanumber\n')
    with pytest.raises(ValueError):
        parse("# TYPE x notakind\n")


def test_exemplars_render_only_behind_the_flag(pkg, monkeypatch):
    reg = pkg.metrics.MetricsRegistry()
    h = reg.histogram("t_ex_seconds", "ex", buckets=(1.0,))
    h._unlabeled().observe(0.5, trace_id="abc")
    monkeypatch.delenv("SWARM_METRICS_EXEMPLARS", raising=False)
    pkg.metrics.parse_exposition(reg.render())
    assert " # {" not in reg.render()
    monkeypatch.setenv("SWARM_METRICS_EXEMPLARS", "1")
    assert 't_ex_seconds_bucket{le="+Inf"} 1 # {trace_id="abc"} 0.5' in reg.render()


def test_collectors_run_at_render_and_errors_isolated(pkg):
    reg = pkg.metrics.MetricsRegistry()
    g = reg.gauge("t_collected", "c")
    calls = []

    def ok():
        calls.append(1)
        g.set(len(calls))

    def broken():
        raise RuntimeError("scrape must survive this")

    reg.add_collector(broken)
    reg.add_collector(ok)
    assert "t_collected 1" in reg.render()
    assert "t_collected 2" in reg.render()
    reg.remove_collector(ok)
    reg.render()
    assert len(calls) == 2


def test_registry_thread_safety(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("t_mt_total", "mt", ("w",))
    h = reg.histogram("t_mt_seconds", "mt", buckets=(0.5, 1.0))

    def work(i):
        for _ in range(500):
            c.labels(w=str(i % 4)).inc()
            h._unlabeled().observe(0.25)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sum(s["value"] for s in reg.snapshot()["t_mt_total"]["samples"]) == 8 * 500
    assert reg.snapshot()["t_mt_seconds"]["samples"][0]["value"]["count"] == 8 * 500


def test_emit_event_subscribers_and_counter(pkg):
    ev = pkg.events
    seen = []
    before = pkg.metrics.REGISTRY.get("swarm_events_total").labels(event="test.ping").value
    unsub = ev.subscribe(seen.append)
    try:
        rec = ev.emit_event("test.ping", trace_id="t1", job_id="j1", phase="x", skipme=None)
    finally:
        unsub()
    assert seen == [rec]
    assert rec["event"] == "test.ping" and rec["trace_id"] == "t1" and rec["job_id"] == "j1"
    assert "skipme" not in rec and "ts" in rec  # None fields dropped
    ev.emit_event("test.ping")  # unsubscribed: no further delivery
    assert len(seen) == 1
    after = pkg.metrics.REGISTRY.get("swarm_events_total").labels(event="test.ping").value
    assert after - before == 2


def test_emit_event_file_sink(pkg, tmp_path, monkeypatch):
    sink = tmp_path / "events.jsonl"
    monkeypatch.setenv(pkg.events.ENV_SINK, str(sink))
    pkg.events.emit_event("test.sink", trace_id="abc123")
    pkg.events.emit_event("test.sink", trace_id="abc123")
    lines = sink.read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["event"] == "test.sink" and rec["trace_id"] == "abc123"


def test_trace_ids_and_the_header(pkg):
    ev = pkg.events
    a, b = ev.new_trace_id(), ev.new_trace_id()
    assert a != b and len(a) == 32 and int(a, 16) >= 0
    assert ev.TRACE_HEADER == "X-Swarm-Trace"
    assert ev.header_trace_id({"X-Swarm-Trace": "abc"}) == "abc"
    assert ev.header_trace_id({"x-swarm-trace": "abc"}) == "abc"
    assert ev.header_trace_id({"X-SWARM-TRACE": " abc "}) == "abc"
    assert ev.header_trace_id({"X-Swarm-Trace": ""}) is None
    assert ev.header_trace_id({"Other": "x"}) is None
    for bad in ("x" * 65, "a b", "a\nb", 'a"b', "トレース", "a;b"):
        assert ev.header_trace_id({"X-Swarm-Trace": bad}) is None, bad
    assert ev.header_trace_id({"X-Swarm-Trace": "A-Z_09"}) == "A-Z_09"


def test_broken_subscriber_isolated(pkg):
    def boom(_rec):
        raise RuntimeError("no")

    seen = []
    u1 = pkg.events.subscribe(boom)
    u2 = pkg.events.subscribe(seen.append)
    try:
        pkg.events.emit_event("test.iso")
    finally:
        u1()
        u2()
    assert len(seen) == 1


def test_phase_timer_accumulates_and_snapshots_copies(pkg):
    t = pkg.trace.PhaseTimer()
    with t.phase("download"):
        time.sleep(0.01)
    with t.phase("download"):
        pass
    with t.phase("execute"):
        pass
    t.count("rows", 100)
    t.count("rows", 28)
    perf = t.perf()
    assert perf["download_s"] >= 0.01 and "execute_s" in perf and perf["rows"] == 128
    assert list(perf) == ["download_s", "execute_s", "rows"]
    s1, c1 = t.snapshot()
    s1["download"] = 999.0  # mutating the copy must not leak back
    c1["rows"] = 999
    s2, c2 = t.snapshot()
    assert s2["download"] < 100 and c2["rows"] == 128


def test_phase_timer_concurrent_ticks(pkg):
    t = pkg.trace.PhaseTimer()
    stop = threading.Event()
    errors = []

    def ticker(name):
        try:
            while not stop.is_set():
                with t.phase(name):
                    pass
                t.count("rows", 1)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def scraper():
        try:
            while not stop.is_set():
                seconds, _counters = t.snapshot()
                assert all(v >= 0 for v in seconds.values())
                t.perf()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=ticker, args=("stream",)),
               threading.Thread(target=ticker, args=("probe",)),
               threading.Thread(target=scraper)]
    for th in threads:
        th.start()
    time.sleep(0.2)
    stop.set()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert not errors
    seconds, counters = t.snapshot()
    assert set(seconds) == {"stream", "probe"} and counters["rows"] > 0


def test_device_profile_disabled_is_free(pkg, monkeypatch):
    monkeypatch.delenv("SWARM_PROFILE_DIR", raising=False)
    with pkg.trace.maybe_device_profile("job_x") as active:
        assert active is False


def test_device_profile_writes_a_torch_trace(tmp_path):
    import torch

    with t_trace.maybe_device_profile("job_y", profile_dir=str(tmp_path), device="cpu") as on:
        assert on is True
        with torch.profiler.record_function("match.phase_a"):
            torch.ones((8, 8)).sum()
    [path] = list((tmp_path / "job_y").glob("trace_*.json"))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "match.phase_a" in names


def _kernel_trace(path, names) -> str:
    """A Chrome trace whose kernel events are ``names``, beside a host
    span and a copy."""
    events = [{"cat": "user_annotation", "name": "match.phase_a"},
              {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)"}]
    events += [{"cat": "kernel", "name": n} for n in names]
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_profiled_symbols_leave_off_templates_and_parameters(tmp_path):
    path = _kernel_trace(tmp_path / "t.json", [
        "(anonymous namespace)::match_regex_scan_kernel<3>(Variants, RegexArgs)",
        "(anonymous namespace)::cluster_parent_kernel<unsigned int>(uint4 const*, int const*, "
        "int, float*, int*)",
        "void match_verify_kernel(VerifyArgs)", "match_md5_kernel",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
        "at::detail::Array<char*, 1> >(int, at::native::FillFunctor<int>, "
        "at::detail::Array<char*, 1>)"])
    assert t_trace.profiled_symbols(path) == {
        "match_regex_scan_kernel", "cluster_parent_kernel", "match_verify_kernel",
        "match_md5_kernel", "vectorized_elementwise_kernel"}


@pytest.mark.parametrize("kernels_in_trace, launched, missing", [
    # every kernel of every wrapper that launched: the profile holds
    (["(anonymous namespace)::match_phase_a_probe_kernel(TableSet, unsigned int const*, int, "
      "unsigned int*)",
      "(anonymous namespace)::match_phase_a_rank_kernel(TableSet, unsigned int const*, int, int, "
      "int*, int*)",
      "void match_verdicts_pack_kernel(PackArgs)", "void match_verdicts_kernel(L, X)"],
     {"match_phase_a": 2, "match_verdicts": 2, "match_md5": 0}, []),
    # a trace with no device event at all, after launches
    ([], {"cluster_counts": 1, "cluster_parent": 1},
     ["cluster_counts_kernel", "cluster_parent_kernel"]),
    # one of a wrapper's two launches missing
    (["void match_verdicts_pack_kernel(PackArgs)"], {"match_verdicts": 2},
     ["match_verdicts_kernel"]),
    # nothing launched (a command job on the card): nothing to find
    ([], {"match_phase_a": 0}, []),
])
def test_check_profile_wants_every_launched_kernel(tmp_path, kernels_in_trace, launched, missing):
    from swarm_tpu_torch.ops import kernels

    path = _kernel_trace(tmp_path / "t.json", kernels_in_trace)
    if not missing:
        t_trace.check_profile(path, launched, kernels.SYMBOLS)
        return
    with pytest.raises(t_trace.ProfileError) as err:
        t_trace.check_profile(path, launched, kernels.SYMBOLS)
    assert str(missing) in str(err.value)


def test_kernel_symbols_name_each_wrapper_and_its_globals():
    """Every counted wrapper maps to the ``__global__`` functions its
    CUDA source launches."""
    import re

    from swarm_tpu_torch.ops import kernels

    assert set(kernels.SYMBOLS) == set(kernels.LAUNCHES)
    launched = set()
    for sources, _lib in kernels.LIBRARIES.values():
        for src in sources:
            launched |= set(re.findall(r"(\w+_kernel)\s*(?:<[^<>]*>)?\s*<<<", src.read_text()))
    assert {s for syms in kernels.SYMBOLS.values() for s in syms} == launched


def _span_tree(spans: list) -> collections.Counter:
    """(parent name, name) of each span, as a multiset."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return collections.Counter((by_id.get(s["parent_id"]), s["name"]) for s in spans)


def test_spans_nest_under_the_attempt_root(pkg):
    tr = pkg.tracing
    with traced(False):
        assert tr.attempt_context("t1") is None
        assert tr.span("x") is tr.span("y")  # the shared no-op
    with traced(True):
        assert tr.attempt_context(None) is None
        ctx = tr.attempt_context("t1", job_id="j", attempt=None)
        with tr.activate(ctx):
            with tr.span("download"):
                pass
            with tr.span("execute") as ex:
                with tr.span("sched", pipeline="on"):
                    pass
            ctx.add_synth("device", ex.start, 0.5, parent_id=ex.span_id, rows=3)
        assert tr.current_context() is None
        spans = ctx.finish()
    assert spans[0]["name"] == "attempt" and spans[0]["attrs"] == {"job_id": "j"}
    assert all(s["trace_id"] == "t1" for s in spans)
    assert _span_tree(spans) == collections.Counter({
        (None, "attempt"): 1, ("attempt", "download"): 1, ("attempt", "execute"): 1,
        ("execute", "sched"): 1, ("execute", "device"): 1})
    assert ctx.finish() == []


def test_span_list_is_bounded(pkg, monkeypatch):
    tr = pkg.tracing
    monkeypatch.setattr(tr.TraceContext, "MAX_SPANS", 2)
    dropped = pkg.metrics.REGISTRY.get("swarm_trace_spans_dropped_total").labels(
        reason="context_full")
    before = dropped.value
    ctx = tr.TraceContext("t2")
    for k in range(3):
        ctx.add_synth(f"s{k}", 0.0, 0.1)
    assert ctx.span_count() == 2 and dropped.value - before == 1
    assert len(ctx.finish()) == 3  # the root and the two kept


# ---------------------------------------------------------------------------
# (ii) the family contract


def _port_families() -> dict:
    from swarm_tpu_torch.ops import engine, match, workflows  # noqa: F401
    from swarm_tpu_torch.resilience import breaker, faults, heartbeat, spool  # noqa: F401
    from swarm_tpu_torch.sched import scheduler  # noqa: F401
    from swarm_tpu_torch.server import app, fleet, queue  # noqa: F401

    t_engine_export._gauges()
    return dict(t_metrics.REGISTRY._metrics)


def test_every_port_family_is_the_reference_family():
    import swarm_tpu.resilience.heartbeat  # noqa: F401
    import swarm_tpu.resilience.spool  # noqa: F401
    import swarm_tpu.sched.scheduler  # noqa: F401
    import swarm_tpu.server.app  # noqa: F401
    import swarm_tpu.server.queue  # noqa: F401

    j_engine_export._gauges()
    port = _port_families()
    ref = j_metrics.REGISTRY._metrics
    assert len(port) >= 60
    for name, fam in port.items():
        want = ref.get(name)
        assert want is not None, f"{name}: not a family of the JAX registry"
        assert (fam.kind, fam.help, fam.labelnames) == (want.kind, want.help,
                                                        want.labelnames), name
        assert getattr(fam, "buckets", None) == getattr(want, "buckets", None), name
    # the monitor's and the journal's families, all of them
    lanes = ("swarm_monitor_", "swarm_journal_")
    want_lanes = sorted(n for n in ref if n.startswith(lanes))
    assert sorted(n for n in port if n.startswith(lanes)) == want_lanes
    assert len(want_lanes) == 9
    # the families the JAX queue module and the trace families register,
    # all of them
    import swarm_tpu.server.queue as j_queue
    import swarm_tpu.telemetry.trace_export as j_trace_export

    want_server = {v.name for m in (j_queue, j_trace_export) for v in vars(m).values()
                   if isinstance(v, j_metrics._Metric)}
    assert want_server <= set(port)
    assert {"swarm_job_phase_seconds", "swarm_trace_assembled_total",
            "swarm_trace_flight_dumps_total", "swarm_queue_express_served_total"} <= want_server
    assert len([n for n in want_server if n.startswith("swarm_queue_")]) == 11
    # the fleet's six families and the server app's HTTP and scrape-time
    # families, all of them, with their pre-seeded label values
    import swarm_tpu.server.app as j_app
    import swarm_tpu.telemetry.fleet_export as j_fleet_export

    want_app = {v.name for m in (j_app, j_fleet_export) for v in vars(m).values()
                if isinstance(v, j_metrics._Metric)}
    assert {n for n in want_app if n.startswith("swarm_fleet_")} == {
        "swarm_fleet_nodes", "swarm_fleet_target_nodes", "swarm_fleet_forecast_rate",
        "swarm_fleet_scale_events_total", "swarm_fleet_preemptions_total",
        "swarm_fleet_coldstart_seconds"}
    assert {n for n in want_app if n.startswith("swarm_http_")} == {
        "swarm_http_requests_total", "swarm_http_request_seconds"}
    assert want_app <= set(port)
    for name in want_app:
        if name.startswith("swarm_fleet_"):
            assert sorted(port[name]._data) == sorted(ref[name]._data), name
    rendered = t_metrics.REGISTRY.render()
    assert j_metrics.parse_exposition(rendered) == t_metrics.parse_exposition(rendered)


# ---------------------------------------------------------------------------
# (iv), (v) end to end against the JAX server


def jsonl(n: int) -> bytes:
    """``n`` JSONL response rows over a few pages of the test corpus's
    shapes, each row's body salted so that its content is its own."""
    bodies = [b"<html><head><title>Welcome to nginx!</title></head></html>",
              b"<html><head><title>Grafana</title></head><body>grafana v9.1.0</body></html>",
              b"<html><body>site powered by AcmeCMS, demo-build 3.11</body></html>",
              b"<html>404 Not Found</html>", b"A" * 900]
    lines = []
    for i in range(n):
        body = b"<!-- %05d -->" % i + bodies[i % len(bodies)]
        lines.append(json.dumps({
            "host": f"198.51.100.{i % 254}", "port": (80, 443)[i % 2],
            "status": (200, 404, 301)[i % 3], "body_b64": base64.b64encode(body).decode(),
            "header_b64": base64.b64encode(
                b"HTTP/1.1 200 OK\r\nServer: nginx\r\nX-Widget-Version: 4.2").decode()}))
    return ("\n".join(lines) + "\n").encode()


class Stack:
    """The JAX server, its client, and one worker of each package with
    one engine each over ``tests/data/templates`` (batches of 32 rows)."""

    def __init__(self, tmp: Path):
        from swarm_tpu.fingerprints import load_corpus as j_load_corpus
        from swarm_tpu.ops.engine import MatchEngine as JaxEngine
        from swarm_tpu_torch.fingerprints.nuclei import load_corpus
        from swarm_tpu_torch.ops.engine import MatchEngine

        self.tmp = tmp
        modules = tmp / "modules"
        modules.mkdir()
        (modules / "echo.json").write_text(json.dumps({"command": "cat {input} > {output}"}))
        (modules / "fp.json").write_text(json.dumps({"backend": "tpu", "templates": str(DATA)}))
        self.cfg = Config(host="127.0.0.1", port=0, api_key="telkey",
                          blob_root=str(tmp / "blobs"), doc_root=str(tmp / "docs"),
                          modules_dir=str(modules), poll_interval_idle_s=0.05,
                          poll_interval_busy_s=0.0)
        self.server = SwarmServer(self.cfg)
        self.server.start_background()
        self.cfg.server_url = f"http://127.0.0.1:{self.server.port}"
        self.client = JobClient(self.cfg.resolve_url(), self.cfg.api_key)
        self.jax = j_runtime.JobProcessor(
            Config(**{**self.cfg.__dict__, "max_jobs": 1, "worker_id": "jax-w"}),
            work_dir=str(tmp / "jax-wd"))
        self.port = t_runtime.JobProcessor(
            t_runtime.WorkerConfig(server_url=self.cfg.server_url, api_key="telkey",
                                   worker_id="port-w", modules_dir=str(modules), max_jobs=1,
                                   poll_interval_idle_s=0.05, poll_interval_busy_s=0.0),
            device="cpu", work_dir=str(tmp / "port-wd"))
        self.jax_engine = JaxEngine(j_load_corpus(str(DATA))[0], mesh=None, batch_rows=32,
                                    walk_threads=1)
        self.port_engine = MatchEngine(load_corpus(DATA)[0], device="cpu", batch_rows=32,
                                       walk_threads=1)
        self.jax._engines[str(DATA)] = self.jax_engine
        self.port.engines[str(DATA)] = self.port_engine
        self._n = 0

    def scan(self, worker, module: str, blob: bytes, pipeline: str = "off") -> dict:
        """One scan of ``module`` over ``blob`` run by ``worker``; →
        its job record, assembled trace (or None), output, trace id and
        the two registries' samples before and after."""
        self._n += 1
        scan_id = f"tel_{self._n}"
        path = self.tmp / f"{scan_id}.txt"
        path.write_bytes(blob)
        for eng in (self.jax_engine, self.port_engine):
            eng.pipeline = pipeline
            eng.clear_content_memos()
        before = samples()
        code, _ = self.client.start_scan(str(path), module, 0, 0, scan_id=scan_id)
        assert code == 200
        worker.process_jobs()
        after = samples()
        [job] = [j for j in self.client.get_statuses()["jobs"].values()
                 if j["scan_id"] == scan_id]
        [summary] = [s for s in self.client.get_statuses()["scans"]
                     if s["scan_id"] == scan_id]
        return {"job": job, "scan": summary, "trace": self.client.get_trace(scan_id),
                "output": self.client.fetch_raw(scan_id), "trace_id": self.client.last_trace_id,
                "delta": {k: {n: after[k][n] - before[k].get(n, 0.0) for n in after[k]
                              if after[k][n] != before[k].get(n, 0.0)} for k in after}}

    def close(self):
        self.server.shutdown()


def samples() -> dict:
    """Each package's registry as {(name, labels): value}, parsed back
    from its exposition by its own parser."""
    out = {}
    for name, p in PKGS.items():
        out[name] = {(n, tuple(sorted(lab.items()))): v
                     for n, lab, v in p.metrics.parse_exposition(p.metrics.REGISTRY.render())}
    return out


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack(tmp_path_factory.mktemp("telemetry"))
    yield s
    s.close()


def test_trace_id_propagates_through_the_port_worker(stack):
    """After ``tests/test_tracing.py::test_trace_id_propagates_end_to_end``:
    the JAX client and server mint and keep the trace; the port's worker
    runs the ``echo`` job. One trace id at every layer, the server's
    assembled trace among them, and each phase observed on the port's
    registry."""
    events = {"jax": [], "port": []}
    unsub = [j_telemetry.subscribe(events["jax"].append),
             t_telemetry.subscribe(events["port"].append)]
    try:
        with traced():
            out = stack.scan(stack.port, "echo", b"alpha\nbeta\n")
    finally:
        for u in unsub:
            u()
    trace_id = out["trace_id"]
    assert out["job"]["status"] == "complete" and out["output"].splitlines() == ["alpha", "beta"]
    [submit] = [e for e in events["jax"] if e["event"] == "scan.submit"]
    assert submit["trace_id"] == trace_id
    assert out["job"]["trace_id"] == trace_id
    [done] = [e for e in events["port"] if e["event"] == "job.worker_done"]
    assert done["trace_id"] == trace_id and done["status"] == "complete"
    assert done["job_id"] == out["job"]["job_id"] and done["perf"]["download_s"] >= 0
    assert [e["phase"] for e in events["port"] if e["event"] == "job.phase"] == [
        "starting", "downloading", "executing", "uploading"]
    assert [e["event"] for e in events["port"] if e.get("trace_id") == trace_id][0] == "job.start"
    doc = out["trace"]
    assert doc["trace_id"] == trace_id and doc["status"] == "complete"
    assert j_tracing.waterfall_orphans(doc) == []
    assert _span_tree([s for s in doc["spans"]
                       if s["name"] in ("attempt", "download", "execute", "upload")]) == \
        collections.Counter({(None, "attempt"): 1, ("attempt", "download"): 1,
                             ("attempt", "execute"): 1, ("attempt", "upload"): 1})
    port = out["delta"]["port"]
    for phase in ("download", "execute", "upload"):
        assert port[("swarm_worker_phase_seconds_count", (("phase", phase),))] == 1
    assert port[("swarm_worker_jobs_total", (("outcome", "complete"),))] == 1
    text = t_telemetry.REGISTRY.render()
    assert j_metrics.parse_exposition(text) == t_metrics.parse_exposition(text)


#: registry samples whose delta over one job is deterministic
DETERMINISTIC = ("swarm_worker_jobs_total", "swarm_worker_phase_seconds_count",
                 "swarm_worker_rows_total", "swarm_memo_lookups_total",
                 "swarm_sched_rows_total", "swarm_sched_batches_total",
                 "swarm_workflow_gate_plane_batches_total",
                 "swarm_workflow_host_twin_fallbacks_total",
                 "swarm_workflow_step_memo_hits_total",
                 "swarm_workflow_step_memo_misses_total", "swarm_events_total",
                 "swarm_device_staged_batches_total",
                 "swarm_device_compacted_dispatches_total")


def _deterministic(out: dict) -> dict:
    """The deterministic deltas of one scan over both registries: the
    JAX server's families move on the JAX registry whichever worker
    ran the job, the worker's on its own package's."""
    total: dict = {}
    for delta in out["delta"].values():
        for k, v in delta.items():
            if k[0] in DETERMINISTIC:
                total[k] = total.get(k, 0.0) + v
    return total


@pytest.fixture(scope="module")
def tpu_jobs(stack):
    """The ``tpu`` job of 64 rows through each worker: untraced with the
    pipeline off, traced with the pipeline off and on; the port's also
    with a device profile."""
    import swarm_tpu.resilience.breaker as j_breaker
    import swarm_tpu_torch.resilience.breaker as t_breaker

    # a breaker an earlier module left open would add ``breakers_open``
    # to one package's perf fields only
    j_breaker.reset_board()
    t_breaker.reset_board()
    blob = jsonl(64)
    out = {}
    for traced_on, pipeline in ((False, "off"), (True, "off"), (True, "on")):
        with traced(traced_on):
            for name in ("jax", "port"):
                worker = stack.jax if name == "jax" else stack.port
                out[name, traced_on, pipeline] = stack.scan(worker, "fp", blob, pipeline)
    return out


@pytest.mark.parametrize("arm", [(False, "off"), (True, "off"), (True, "on")],
                         ids=["untraced", "traced", "traced_pipeline"])
def test_tpu_job_reports_as_the_jax_worker(tpu_jobs, arm):
    """The completed job's perf keys in the JAX worker's order (rows,
    device_s and host_confirm_s among them; phase_a_s and phase_b_s only
    traced), the scan's rows_processed and a rows_per_second, the
    output, and the registry deltas of the job, equal to the JAX
    worker's."""
    jax, port = tpu_jobs["jax", *arm], tpu_jobs["port", *arm]
    assert port["job"]["status"] == jax["job"]["status"] == "complete"
    assert list(port["job"]["perf"]) == list(jax["job"]["perf"])
    assert {"rows", "device_s", "host_confirm_s", "pipeline"} <= set(port["job"]["perf"])
    assert ("phase_a_s" in port["job"]["perf"]) == arm[0]
    assert port["job"]["perf"]["rows"] == jax["job"]["perf"]["rows"] == 64
    assert port["scan"]["rows_processed"] == jax["scan"]["rows_processed"] == 64
    assert port["scan"]["rows_per_second"] and port["scan"]["rows_per_second"] > 0
    assert port["output"] == jax["output"] == tpu_jobs["port", False, "off"]["output"]
    assert port["output"].count("\n") >= 64
    got, want = _deterministic(port), _deterministic(jax)
    assert got == want
    assert got[("swarm_worker_rows_total", ())] == 64
    if arm[1] == "on":
        assert sum(v for k, v in got.items() if k[0] == "swarm_sched_rows_total") == 64


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_tpu_job_spans_assemble_as_the_jax_workers(tpu_jobs, pipeline):
    """The JAX server assembles the port's traced job with the JAX
    worker's span names and nesting (``device`` with its phases and
    ``walk`` under ``execute``; ``sched`` with the pipeline on) and no
    orphans; the untraced job leaves no trace and no spans."""
    jax, port = tpu_jobs["jax", True, pipeline], tpu_jobs["port", True, pipeline]
    for out in (jax, port):
        assert out["trace"]["trace_id"] == out["trace_id"]
        assert j_tracing.waterfall_orphans(out["trace"]) == []
        assert "spans" not in out["job"]["perf"]
    tree = _span_tree(port["trace"]["spans"])
    assert tree == _span_tree(jax["trace"]["spans"])
    assert {("attempt", "execute"), ("execute", "device"), ("device", "device.phase_a"),
            ("device", "device.phase_b"), ("execute", "walk")} <= set(tree)
    assert (("execute", "sched") in tree) == (pipeline == "on")
    assert tpu_jobs["port", False, "off"]["trace"] is None


def test_profiled_job_is_byte_identical(stack, tmp_path, monkeypatch):
    """With ``SWARM_PROFILE_DIR`` set the worker writes a torch.profiler
    trace of each job's execute under ``<dir>/<job_id>/``, and the job's
    output is the unprofiled job's (the ``tpu`` job profiled on the card
    is ``chip_smoke.py``'s telemetry_worker phase)."""
    blob = b"alpha\nbeta\n"
    plain = stack.scan(stack.port, "echo", blob)
    monkeypatch.setenv("SWARM_PROFILE_DIR", str(tmp_path))
    out = stack.scan(stack.port, "echo", blob)
    assert out["job"]["status"] == "complete" and out["output"] == plain["output"]
    [trace] = list((tmp_path / out["job"]["job_id"]).glob("trace_*.json"))
    assert json.loads(trace.read_text())["traceEvents"]
    assert not (tmp_path / plain["job"]["job_id"]).exists()


def test_lost_profile_still_completes_the_job(stack, tmp_path, monkeypatch, capsys):
    """A profile that lost the card's kernels (its check substituted by
    one that fails, as ``torch.profiler`` now and then loses them on
    the card) does not fail the job, as it never does in the JAX worker:
    the ``tpu`` job uploads the unprofiled job's output and completes;
    its trace is kept as ``trace_<ns>.lost.json`` and no whole trace is
    left; the worker prints the loss and the job's perf fields carry
    it."""
    blob = jsonl(64)
    plain = stack.scan(stack.port, "fp", blob)

    def lost(path, launched, symbols):
        raise t_trace.ProfileError(f"the profile {path} holds no device event of "
                                   "['match_md5_kernel']")

    monkeypatch.setattr(t_trace, "check_profile", lost)
    monkeypatch.setenv("SWARM_PROFILE_DIR", str(tmp_path))
    out = stack.scan(stack.port, "fp", blob)
    job = out["job"]
    assert job["status"] == "complete" and out["output"] == plain["output"]
    [trace] = list((tmp_path / job["job_id"]).iterdir())
    assert trace.name.startswith("trace_") and trace.name.endswith(".lost.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert "match_md5_kernel" in job["perf"]["profile_lost"]
    assert job["perf"]["profile_lost"].endswith(f"kept as {trace}")
    assert "profile_lost" not in plain["job"]["perf"]
    assert f"profile lost: {job['perf']['profile_lost']}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the resilience families under a fault plan


RESILIENCE = ("swarm_resilience_faults_injected_total",
              "swarm_resilience_transport_retries_total",
              "swarm_resilience_transport_failures_total",
              "swarm_resilience_spooled_chunks_total", "swarm_resilience_spool_replayed_total",
              "swarm_resilience_breaker_transitions_total", "swarm_worker_jobs_total",
              "swarm_worker_drain_total", "swarm_worker_drain_seconds_count",
              "swarm_worker_poll_errors_total", "swarm_events_total")


def test_resilience_families_under_a_fault_plan_equal_jax(tmp_path):
    """An ``echo`` chunk whose execution a plan slows, whose uploads
    fail past the retries and open the upload breaker (spooled, then
    replayed), after a poll that fails past its retry: each package's
    registry moves by the same amounts."""
    from test_torch_resilience import PKGS as RES_PKGS
    from test_torch_resilience import ScriptedServer

    deltas = {}
    for name, pkg in RES_PKGS.items():
        srv = ScriptedServer(pkg.transport.TransportError, down_puts=3)
        get_job, polls = srv.get_job, []

        def first_poll_fails(worker_id, _get=get_job, _polls=polls, _exc=srv.exc):
            _polls.append(1)
            if len(_polls) <= 2:
                raise _exc("server error 503")
            return _get(worker_id)

        srv.get_job = first_poll_fails
        client = pkg.transport.RetryingServerClient(srv, retries=1, breaker_threshold=2,
                                                    breaker_cooldown_s=0.0,
                                                    sleep=lambda s: None)
        before = samples()[name]
        pkg.faults.install_plan("executor.run:1:sleep=0.01")
        try:
            proc = pkg.worker(client, tmp_path / name, worker_id="w0",
                              modules_dir=str(REPO / "modules"), poll_interval_idle_s=0.0,
                              poll_interval_busy_s=0.0, spool_dir=str(tmp_path / name / "sp"))
            proc.process_jobs()
        finally:
            pkg.faults.clear_plan()
        after = samples()[name]
        deltas[name] = {k: after[k] - before.get(k, 0.0) for k in after
                        if k[0] in RESILIENCE and after[k] != before.get(k, 0.0)}
        assert srv.outputs == [b"10.0.0.1\nexample.test:8443\n"]
    assert deltas["port"] == deltas["jax"]
    port = deltas["port"]
    assert port[("swarm_resilience_faults_injected_total", (("point", "executor.run"),))] == 1
    assert port[("swarm_resilience_spooled_chunks_total", ())] == 1
    assert port[("swarm_resilience_spool_replayed_total", (("outcome", "completed"),))] == 1
    assert any(fam == "swarm_resilience_breaker_transitions_total" and ("state", "open") in labels
               for fam, labels in port)
    assert port[("swarm_worker_poll_errors_total", ())] == 1
    assert j_transport.TransportError is not t_transport.TransportError
