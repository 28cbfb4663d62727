"""The port's gateway (``swarm_tpu_torch/gateway``) against the JAX
package's (``swarm_tpu/gateway``), on the CPU.

- the modules are copies: every function and class of the reference's
  ``qos``, ``admission``, ``qoscache`` and ``streaming`` is in the port
  with the same source (the package name aside), and the seven
  ``swarm_gateway_*`` families have the reference's names, kinds, help,
  labels and buckets;
- ``AdmissionController.decide`` sequences under an injected clock give
  the same ``Decision``s, ``snapshot()``, fleet saturation and
  ``swarm_gateway_*`` deltas as JAX's, over configurations: rate and
  burst, a per-tenant queue cap, ``queue_high``, shed pressure per QoS
  class, breakers, the saturation TTL, tenant expiry and the
  ``max_tenants`` cap;
- ``parse_qos`` / ``qos_class`` over a table of header values, and the
  class names against the scheduler's (``sched/buckets.py``);
- the ``g`` family's digests and segment splits are byte-equal; the
  port's and the JAX ``GatewayScanCache`` on one store read each other's
  entries, per target and whole-chunk, partial and complete, and the
  same operations on each package's own tier leave equal ``counters()``
  and equal store contents, across an epoch bump and on a dead store;
- ``stream_scan`` over one scripted queue (late chunks, a gap that
  persists, a failed chunk, the idle timeout under a fake clock, a
  restarted server's stored chunks, a resume cursor) yields the same
  bytes and the same stream-byte count.

Everything compared is integers, strings or bytes: tolerance 0.
"""

import inspect
import re
from types import SimpleNamespace

import numpy as np
import pytest

import swarm_tpu.cache.tier as j_tier
import swarm_tpu.gateway.admission as j_admission
import swarm_tpu.gateway.qos as j_qos
import swarm_tpu.gateway.qoscache as j_qoscache
import swarm_tpu.gateway.streaming as j_streaming
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.cache.tier as t_tier
import swarm_tpu_torch.gateway.admission as t_admission
import swarm_tpu_torch.gateway.qos as t_qos
import swarm_tpu_torch.gateway.qoscache as t_qoscache
import swarm_tpu_torch.gateway.streaming as t_streaming
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics

PKG = {
    "jax": SimpleNamespace(admission=j_admission, qos=j_qos, qoscache=j_qoscache,
                           streaming=j_streaming, tier=j_tier, metrics=j_metrics),
    "torch": SimpleNamespace(admission=t_admission, qos=t_qos, qoscache=t_qoscache,
                             streaming=t_streaming, tier=t_tier, metrics=t_metrics),
}

# ---------------------------------------------------------------------------
# the copies and the families

COPIES = [(j_qos, t_qos), (j_admission, t_admission), (j_qoscache, t_qoscache),
          (j_streaming, t_streaming)]


def _own_members(module):
    return {name: obj for name, obj in vars(module).items()
            if (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


@pytest.mark.parametrize("orig,port", COPIES, ids=[c[0].__name__ for c in COPIES])
def test_copies_match_their_originals(orig, port):
    mine = _own_members(port)
    theirs = _own_members(orig)
    assert theirs and set(theirs) == set(mine)
    for name, obj in theirs.items():
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert inspect.getsource(mine[name]) == want, f"{port.__name__}.{name} differs"
    for name, value in vars(orig).items():
        if name.isupper() and isinstance(value, (str, int, float, tuple)):
            assert getattr(port, name) == value, name


FAMILIES = ["swarm_gateway_admitted_total", "swarm_gateway_shed_total",
            "swarm_gateway_queued_by_tenant", "swarm_gateway_pressure",
            "swarm_gateway_stream_bytes_total", "swarm_gateway_latency_seconds",
            "swarm_gateway_cache_short_circuit_total"]


@pytest.mark.parametrize("name", FAMILIES)
def test_gateway_family_is_the_reference_family(name):
    port, ref = t_metrics.REGISTRY._metrics[name], j_metrics.REGISTRY._metrics[name]
    assert (port.kind, port.help, port.labelnames) == (ref.kind, ref.help, ref.labelnames)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)


def test_gateway_families_render_the_reference_series():
    """Each family's pre-seeded series are in the port's exposition, as
    in a fresh JAX process's."""
    rendered = {(n, tuple(sorted(lab.items()))) for n, lab, _v in t_metrics.parse_exposition(
        t_metrics.REGISTRY.render()) if n.startswith("swarm_gateway_")}
    for tenant_reason in ("rate", "queue_full", "pressure", "tenant_limit"):
        assert ("swarm_gateway_shed_total", (("reason", tenant_reason), ("tenant", "default"))) in (
            rendered)
    for q in ("bulk", "interactive"):
        assert ("swarm_gateway_latency_seconds_count", (("qos", q),)) in rendered
    for o in ("hit", "miss"):
        assert ("swarm_gateway_cache_short_circuit_total", (("outcome", o),)) in rendered
    assert ("swarm_gateway_admitted_total", (("tenant", "default"),)) in rendered
    assert ("swarm_gateway_pressure", ()) in rendered


# ---------------------------------------------------------------------------
# admission


def gateway_series(metrics) -> dict:
    out = {}
    for n, lab, v in metrics.parse_exposition(metrics.REGISTRY.render()):
        if n in ("swarm_gateway_admitted_total", "swarm_gateway_shed_total",
                 "swarm_gateway_pressure"):
            out[(n, tuple(sorted(lab.items())))] = v
    return out


def series_delta(before, after):
    return {k: (v if k[0] == "swarm_gateway_pressure" else v - before.get(k, 0.0))
            for k, v in after.items() if k[0] == "swarm_gateway_pressure"
            or v != before.get(k, 0.0)}


CONFIGS = {
    "unlimited": {},
    "rate_burst": {"gateway_tenant_rate": 2.0, "gateway_tenant_burst": 3},
    "queue_cap": {"gateway_tenant_queue_max": 4, "gateway_tenant_rate": 50.0},
    "queue_high": {"gateway_queue_high": 100},
    "shed_per_class": {"gateway_shed_pressure": 0.9, "gateway_shed_pressure_bulk": 0.5,
                       "gateway_shed_pressure_interactive": 0.95},
    "breakers": {"gateway_shed_pressure": 0.5, "gateway_retry_after_s": 2.5},
    "tenant_cap_and_ttl": {"gateway_max_tenants": 3, "gateway_tenant_ttl_s": 10.0,
                           "gateway_tenant_rate": 1.0, "gateway_tenant_burst": 2},
    "saturation_ttl": {"gateway_saturation_ttl_s": 5.0, "gateway_queue_high": 50},
}


def _events(seed: int, n: int = 120) -> list:
    """One seeded submission script: (tenant, snapshot fields, now,
    tenant depth, qos, saturation reports)."""
    rng = np.random.default_rng(seed)
    tenants = ["default", "acme", "globex", "initech", "umbrella", "hooli"]
    now, out = 100.0, []
    for _ in range(n):
        now += float(rng.choice([0.0, 0.05, 0.2, 0.7, 3.0, 12.0], p=[.2, .3, .2, .15, .1, .05]))
        reports = [(f"w{int(rng.integers(0, 3))}", float(rng.choice([0.0, 0.3, 0.6, 0.99, 1.7])))
                   for _ in range(int(rng.integers(0, 2)))]
        out.append((
            tenants[int(rng.integers(0, len(tenants)))],
            dict(queue_depth=int(rng.integers(0, 140)), active_jobs=int(rng.integers(0, 9)),
                 open_breakers=int(rng.choice([0, 0, 0, 1]))),
            now, int(rng.integers(0, 7)), [None, "bulk", "interactive"][int(rng.integers(0, 3))],
            reports))
    return out


def run_admission(side: str, config: dict, seed: int) -> tuple:
    pkg = PKG[side]
    ctl = pkg.admission.AdmissionController.from_config(SimpleNamespace(**config))
    before = gateway_series(pkg.metrics)
    decisions, saturations = [], []
    for tenant, snap, now, depth, qos, reports in _events(seed):
        for worker, value in reports:
            ctl.note_saturation(worker, value, now=now)
        sat = ctl.fleet_saturation(now=now)
        saturations.append(sat)
        decisions.append(ctl.decide(tenant, pkg.admission.PressureSnapshot(saturation=sat, **snap),
                                    now, tenant_depth=depth, qos=qos))
    ctl.drop_saturation("w0")
    saturations.append(ctl.fleet_saturation(now=now))
    return ([tuple(vars(d).values()) for d in decisions], ctl.snapshot(), saturations,
            series_delta(before, gateway_series(pkg.metrics)))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_admission_sequences_equal_jax(config, seed):
    j = run_admission("jax", CONFIGS[config], seed)
    t = run_admission("torch", CONFIGS[config], seed)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2]
    assert t[3] == j[3]
    reasons = {d[1] for d in t[0]}
    if config != "unlimited":
        assert reasons - {"ok"}, f"{config}: nothing shed"


def test_token_bucket_equals_jax():
    for rate, burst in ((0.0, 5), (1.5, 1), (4.0, 3)):
        jb, tb = j_admission.TokenBucket(rate, burst), t_admission.TokenBucket(rate, burst)
        for now in (0.0, 0.0, 0.1, 0.1, 0.5, 0.4, 2.0, 2.0, 2.0, 9.0):
            assert tb.take(now) == jb.take(now) and tb.tokens == jb.tokens


# ---------------------------------------------------------------------------
# qos

QOS_VALUES = [None, "", "  ", "bulk", "BULK", " Bulk ", "interactive", "Interactive",
              " INTERACTIVE\t", "express", "inter active", "0", "x"]


@pytest.mark.parametrize("value", QOS_VALUES, ids=[repr(v) for v in QOS_VALUES])
def test_parse_qos_and_class_equal_jax(value):
    def outcome(mod, v):
        try:
            return ("ok", mod.parse_qos(v))
        except ValueError as e:
            return ("error", str(e))

    assert outcome(t_qos, value) == outcome(j_qos, value)
    assert t_qos.qos_class(value) == j_qos.qos_class(value)


def test_qos_constants_match_the_scheduler():
    from swarm_tpu_torch.sched import buckets

    assert (t_qos.QOS_BULK, t_qos.QOS_INTERACTIVE) == (buckets.QOS_BULK, buckets.QOS_INTERACTIVE)
    assert t_qos.QOS_HEADER == j_qos.QOS_HEADER == "X-Swarm-QoS"
    assert t_qos.QOS_CLASSES == j_qos.QOS_CLASSES


# ---------------------------------------------------------------------------
# the gateway scan cache

CHUNKS = [
    ("fingerprint", ["198.51.100.1:80", "198.51.100.2:443"]),
    ("httpx", ["a.example"]),
    ("nuclei", ["h1", "h2", "h3", "hé", "h\udcff"]),
    ("", []),
]


@pytest.mark.parametrize("module,lines", CHUNKS, ids=[c[0] or "empty" for c in CHUNKS])
def test_digests_byte_equal(module, lines):
    assert t_qoscache.scan_chunk_digest(module, lines) == j_qoscache.scan_chunk_digest(
        module, lines)
    for target in lines:
        assert t_qoscache.scan_target_digest(module, target) == j_qoscache.scan_target_digest(
            module, target)


SPLITS = [(b"a\nb\n", 2), (b"a\nb", 2), (b"a\nb\nc\n", 2), (b"", 1), (b"x\n", 1), (b"", 0),
          (b"\n\n", 2), (b"a\n\nb\n", 3), (b"one line", 3)]


@pytest.mark.parametrize("output,n", SPLITS, ids=[f"{o!r}/{n}" for o, n in SPLITS])
def test_split_output_segments_equal_jax(output, n):
    got = t_qoscache.split_output_segments(output, n)
    assert got == j_qoscache.split_output_segments(output, n)
    if got is not None:
        assert b"".join(got) == output


def shared_tiers():
    """One memory store under a tier of each package."""
    state, blobs = t_stores.MemoryStateStore(), t_stores.MemoryBlobStore()
    return j_tier.SharedResultTier(state, blobs), t_tier.SharedResultTier(state, blobs), state


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_caches_read_each_others_entries(writer):
    """On one store, what one package's gateway writes (per target, and
    whole-chunk for multi-line outputs) the other's reads back byte for
    byte: complete, partial (a hole for the unknown chunk) and re-chunked."""
    reader = "torch" if writer == "jax" else "jax"
    j_t, t_t, _state = shared_tiers()
    tiers = {"jax": j_t, "torch": t_t}
    w = PKG[writer].qoscache.GatewayScanCache(tiers[writer], writer_id="gw-w")
    r = PKG[reader].qoscache.GatewayScanCache(tiers[reader], writer_id="gw-r")
    targets = [f"10.0.0.{i}:80" for i in range(6)]
    out = b"".join(b'{"host": "%s", "m": %d}\n' % (t.encode(), i) for i, t in enumerate(targets))
    assert w.writeback("fingerprint", targets[:4], b"".join(out.splitlines(True)[:4]))
    assert w.writeback("nuclei", ["x", "y"], b"multi\nline\nverdict\n")  # whole-chunk
    whole = r.lookup_chunks("fingerprint", [targets[:4]])
    assert whole == [b"".join(out.splitlines(True)[:4])]
    rechunked = r.lookup_chunks("fingerprint", [targets[:1], targets[1:4]])
    assert rechunked == [out.splitlines(True)[0], b"".join(out.splitlines(True)[1:4])]
    assert r.lookup_chunks("fingerprint", [targets[:2], targets[4:]]) is None
    assert r.lookup_chunks_partial("fingerprint", [targets[:2], targets[4:]]) == [
        b"".join(out.splitlines(True)[:2]), None]
    assert r.lookup_chunks("nuclei", [["x", "y"]]) == [b"multi\nline\nverdict\n"]
    assert r.counters() == {"hits": 6, "misses": 2, "stored": 0}
    assert w.counters() == {"hits": 0, "misses": 0, "stored": 5}


class DeadState:
    def __getattr__(self, name):
        def dead(*a, **kw):
            raise ConnectionError("store down")

        return dead


def cache_run(side: str, monkeypatch) -> tuple:
    pkg = PKG[side]
    monkeypatch.setattr(pkg.qoscache.GatewayScanCache, "_EPOCH_TTL_S", 0.0)
    tier = pkg.tier.SharedResultTier(t_stores.MemoryStateStore(), t_stores.MemoryBlobStore())
    cache = pkg.qoscache.GatewayScanCache(tier, writer_id="gw")
    out = [cache.writeback("m", ["a", "b"], b"A\nB\n"),
           cache.writeback("m", ["c"], b"C"),
           cache.writeback("m", ["d", "e"], b"only one line"),
           cache.lookup_chunks("m", [["a"], ["b", "c"]]),
           cache.lookup_chunks_partial("m", [["a", "z"], ["d", "e"]]),
           cache.lookup_chunks("m", []),
           tier.bump_epoch(),
           cache.lookup_chunks_partial("m", [["a"], ["c"]]),
           cache.writeback("m", ["a"], b"A2\n"),
           cache.lookup_chunks("m", [["a"]])]
    tier._state.hset(f"{tier._prefix}:g:gw.g1", t_qoscache.scan_target_digest("m", "q"), "!!")
    out.append(cache.lookup_chunks_partial("m", [["q"]]))  # a corrupt entry is a miss
    state = {k: dict(v) for k, v in tier._state._hashes.items()}
    dead = pkg.qoscache.GatewayScanCache(pkg.tier.SharedResultTier(DeadState(), None))
    out += [dead.lookup_chunks("m", [["a"]]), dead.writeback("m", ["a"], b"A\n"),
            dead.counters()]
    return out, cache.counters(), state


def test_cache_counters_and_entries_equal_jax(monkeypatch, capsys):
    j = cache_run("jax", monkeypatch)
    t = cache_run("torch", monkeypatch)
    assert t == j
    assert t[1]["hits"] and t[1]["misses"] and t[1]["stored"]
    printed = capsys.readouterr().out
    assert printed.count("gateway scan cache degraded to pass-through (ConnectionError") == 2


def test_build_gateway_cache_reads_the_config(monkeypatch):
    monkeypatch.setattr(t_tier, "_MEMORY_TIER", None)
    assert t_qoscache.build_gateway_cache(SimpleNamespace(cache_backend="off")) is None
    assert t_qoscache.build_gateway_cache(
        SimpleNamespace(cache_backend="memory", qos_gateway_cache=False)) is None
    cache = t_qoscache.build_gateway_cache(SimpleNamespace(cache_backend="memory", worker_id="s1",
                                                           cache_ttl_s=0.0, cache_max_entries=0))
    assert cache._tier is t_tier._memory_tier() and cache._writer == "gw:s1"
    with pytest.raises(ValueError, match="unknown cache_backend"):
        t_qoscache.build_gateway_cache(SimpleNamespace(cache_backend="etcd"))


# ---------------------------------------------------------------------------
# the result stream


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class ScriptedQueue:
    """A queue whose chunk records and outputs appear on a script:
    ``records[i] = (visible_at, status, ready_at)`` — the record shows
    ``status`` from ``visible_at`` and its output (``complete``) from
    ``ready_at`` (None: never); ``stored`` is a restarted server's chunk
    store (no live records)."""

    def __init__(self, clock, records: dict, stored: dict = None):
        self.clock, self.records, self.stored = clock, records, stored or {}

    def _status(self, i):
        rec = self.records.get(i)
        if rec is None or self.clock.t < rec[0]:
            return None
        visible, status, ready = rec
        return "complete" if ready is not None and self.clock.t >= ready else status

    def output_chunk(self, scan_id, i):
        if i in self.stored:
            return self.stored[i]
        return f"out-{scan_id}-{i}\n" if self._status(i) == "complete" else None

    def chunk_status(self, scan_id, i):
        return self._status(i)

    def scan_chunk_states(self, scan_id):
        return {i: s for i in self.records if (s := self._status(i)) is not None}

    def stored_output_chunks(self, scan_id):
        return sorted(self.stored)


STREAMS = {
    "late_chunks": ({0: (0, "executing", 0.0), 1: (0, "executing", 0.4),
                     2: (0, "queued", 1.3), 3: (0.2, "executing", 0.25)}, None, 0),
    "persistent_gap": ({0: (0, "executing", 0.0), 1: (0, "executing", 0.1),
                        3: (0, "executing", 0.0)}, None, 0),
    "failed_chunk": ({0: (0, "executing", 0.0), 1: (0, "dead letter", None),
                      2: (0, "cmd failed", None), 3: (0.3, "executing", 0.5)}, None, 0),
    "idle_timeout": ({0: (0, "executing", 0.0), 1: (0, "executing", None)}, None, 0),
    "restarted_server": ({}, {0: "a\n", 2: "c\n", 3: ""}, 0),
    "resume_cursor": ({0: (0, "executing", 0.0), 1: (0, "executing", 0.0),
                       2: (0, "executing", 0.6)}, None, 1),
}


def run_stream(side: str, case: str) -> tuple:
    pkg = PKG[side]
    records, stored, start = STREAMS[case]
    clock = FakeClock()
    queue = ScriptedQueue(clock, records, stored)
    counter = pkg.metrics.REGISTRY._metrics["swarm_gateway_stream_bytes_total"]
    before = counter.labels().value
    lines = list(pkg.streaming.stream_scan(queue, "s1", from_chunk=start, poll_s=0.05,
                                           idle_timeout_s=1.0, clock=clock, sleep=clock.sleep))
    return lines, counter.labels().value - before, round(clock.t, 9)


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_scan_equals_jax(case):
    j = run_stream("jax", case)
    t = run_stream("torch", case)
    assert t == j
    lines = t[0]
    assert lines and lines[-1].startswith(b'{"event":')
    if case == "idle_timeout":
        assert b'"timeout"' in lines[-1]
    if case in ("persistent_gap", "failed_chunk", "restarted_server"):
        assert any(b'"skipped"' in ln for ln in lines)
