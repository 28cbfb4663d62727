"""The port's AOT library cache (``swarm_tpu_torch/aot``) against the JAX
package's (``swarm_tpu/aot``), on the CPU.

- ``AotStore``: the same sequence of puts, gets, index reads, epoch bumps
  and a fenced writer on each package's store leaves the same state-store
  contents and the same blob bytes, and answers the same;
- ``AotClient``: the same sequence of publishes, fetches (pool and store
  hits, misses), a fenced publish, a corrupt payload, ``aot.fetch`` and
  ``aot.put`` fault plans, a dead store, a prewarm and an epoch bump gives
  equal ``counters()`` and equal ``swarm_aot_*`` deltas. The JAX client
  carries the port's payloads: its ``serialize_compiled`` /
  ``load_compiled`` are monkeypatched to the port's codec, and nothing of
  the JAX package is edited. The program groups differ by design (the
  port's salts its own kernel sources and toolchain), so the digests do;
- the kernel loader through a client (``ops/kernels.py``): a cold process
  compiles each library once and publishes it; a fresh process (no
  library loaded, an empty build directory) prewarms all four and loads
  them with no compile; a payload under another key, with a wrong
  sha256 or a bad header writes nothing and builds once; ``aot_publish``
  off publishes nothing. Each sequence's counts equal the JAX client's
  on the reference's own sequence (``AotJit._materialize``: fetch, else
  compile and publish; ``prewarm``);
- the worker's ``SWARM_AOT_*`` fields parse as the JAX ``Config`` parses
  them; ``JobProcessor.engine_for`` attaches and prewarms, and a store
  that cannot be built prints the reference's line and still serves.

``nvcc --version``, the card's capability, the compiler and the loader
are stubbed as in ``tests/test_torch_build.py``: nothing is built.
Everything compared is integers, strings or bytes: tolerance 0.
"""

import json

import pytest
import torch

import swarm_tpu.aot.jitcache as j_jitcache
import swarm_tpu.aot.store as j_store
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.aot.store as t_store
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.metrics as t_metrics
from swarm_tpu_torch.aot import libcache
from swarm_tpu_torch.ops import kernels

from test_torch_build import NVCC_VERSION, compiles, lib_env, loads  # noqa: F401

NAMES = tuple(kernels.LIBRARIES)
DATA = "tests/data/templates"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def env(lib_env, compiles, loads, monkeypatch):  # noqa: F811
    """The stubbed build environment with no AOT client attached, every
    library built once (a stand-in file under its key), no fault plan in
    either package, and the JAX client carrying the port's payloads."""
    monkeypatch.setattr(kernels, "_aot", None)
    for name in NAMES:
        kernels.build(name)
    compiles.clear()
    monkeypatch.setattr(j_jitcache, "serialize_compiled", libcache.serialize_library)
    monkeypatch.setattr(j_jitcache, "load_compiled", lambda blob: libcache.decode_payload(blob)[0])
    yield lib_env
    j_faults.clear_plan()
    t_faults.clear_plan()


# ---------------------------------------------------------------------------
# helpers


class Side:
    """One package's store and client modules, its fault plan, and a view
    of its ``swarm_aot_*`` series."""

    def __init__(self, name):
        jax_side = name == "jax"
        self.name = name
        self.mod = j_store if jax_side else t_store
        self.stores = j_stores if jax_side else t_stores
        self.faults = j_faults if jax_side else t_faults
        self.metrics = j_metrics if jax_side else t_metrics

    def store(self):
        return self.mod.AotStore(self.stores.MemoryStateStore(), self.stores.MemoryBlobStore())

    def client(self, store, worker="w", **kw):
        return self.mod.AotClient(store, worker_id=worker, breaker_cooldown_s=60.0, **kw)

    def digest(self, client, name):
        return client.key_digest(name, kernels.library_key(name), "", "")

    def aot_series(self) -> dict:
        out = {}
        for n, labels, v in self.metrics.parse_exposition(self.metrics.REGISTRY.render()):
            if n in ("swarm_aot_fetch_total", "swarm_aot_publish_total"):
                out[(n, labels.get("outcome"))] = v
            elif n == "swarm_aot_bringup_seconds_count":
                out[(n, labels.get("source"))] = v
            elif n == "swarm_aot_artifact_bytes":
                out[(n, None)] = v
        return out


SIDES = {"jax": Side("jax"), "torch": Side("torch")}


def deltas(before: dict, after: dict) -> dict:
    return {k: (after[k] if k[0] == "swarm_aot_artifact_bytes" else after[k] - before.get(k, 0))
            for k in after}


def store_contents(store) -> tuple:
    """The state hashes and the blob bytes of a memory-backed store."""
    state = {name: dict(h) for name, h in store._state._hashes.items()}
    return state, dict(store._blobs._blobs)


class DeadState:
    """A state store whose every operation raises (a dead backend)."""

    def __getattr__(self, name):
        def dead(*a, **kw):
            raise ConnectionError("store down")

        return dead


def publish(side, client, name):
    return client.publish(side.digest(client, name), {"k": name, "s": "", "a": ""}, name)


def fetch(side, client, name):
    got = client.fetch_loaded(side.digest(client, name))
    return None if got is None else "loaded"


# ---------------------------------------------------------------------------
# AotStore


def _store_sequence(side) -> tuple:
    st = side.store()
    out = []
    w1 = st.acquire_writer("w1")
    out.append(st.put_artifact("g0", "d1", '{"k":"md5"}', b"payload-1", "w1", w1))
    out.append(st.get_artifact("g0", "d1"))
    out.append(st.get_artifact("g0", "nope"))
    out.append(sorted(st.list_index("g0").items()))
    w1b = st.acquire_writer("w1")  # a restarted w1 supersedes the old token
    out.append(st.put_artifact("g0", "d2", '{"k":"match"}', b"payload-2", "w1", w1))
    out.append(st.put_artifact("g0", "d2", '{"k":"match"}', b"payload-2", "w1", w1b))
    out.append(st.bump_epoch())
    gen = st.epoch_generation()
    out.append(st.put_artifact(f"g{gen}", "d1", '{"k":"md5"}', b"payload-3", "w1", w1b))
    out.append(sorted(st.list_index(f"g{gen}").items()))
    st.fence_writer("w1")
    out.append(st.put_artifact(f"g{gen}", "d3", "{}", b"x", "w1", w1b))
    st._blobs.delete(f"aot/g{gen}/d1")  # an index entry whose blob vanished
    out.append(st.get_artifact(f"g{gen}", "d1"))
    return out, st


def test_store_state_equals_jax_byte_for_byte():
    j_out, j_st = _store_sequence(SIDES["jax"])
    t_out, t_st = _store_sequence(SIDES["torch"])
    assert t_out == j_out
    assert "fenced" in t_out and "stored" in t_out
    assert store_contents(t_st) == store_contents(j_st)
    assert t_st._prefix == j_st._prefix == "swarm:aot"
    with pytest.raises(ValueError, match="blob store"):
        t_store.AotStore(t_stores.MemoryStateStore(), None)


# ---------------------------------------------------------------------------
# AotClient


def sc_publish_then_hits(side):
    st = side.store()
    a = side.client(st, "a")
    out = [publish(side, a, "md5"), fetch(side, a, "md5")]  # a pool hit
    b = side.client(st, "b")
    out += [fetch(side, b, "md5"), fetch(side, b, "md5")]  # a store hit, then the pool
    return out, [a, b], st


def sc_miss_then_publish(side):
    st = side.store()
    a = side.client(st, "a")
    out = [fetch(side, a, "match")]
    a.note_compile_seconds(0.5)
    out += [publish(side, a, "match"), fetch(side, side.client(st, "c"), "match")]
    return out, [a], st


def sc_fenced_publish(side):
    st = side.store()
    a = side.client(st, "a")
    out = [publish(side, a, "md5")]
    st.fence_writer("a:aot")
    out += [publish(side, a, "cluster"), fetch(side, side.client(st, "b"), "cluster")]
    return out, [a], st


def sc_corrupt_payload(side):
    st = side.store()
    a = side.client(st, "a")
    out = [publish(side, a, "md5")]
    digest = side.digest(a, "md5")
    key = f"aot/g0/{digest}"
    st._blobs.put(key, st._blobs.get(key)[:-7])  # truncated
    b = side.client(st, "b")
    out += [fetch(side, b, "md5"), b.prewarm()]
    st._blobs.put(key, b"not a payload")
    out += [fetch(side, side.client(st, "c"), "md5")]
    return out, [a, b], st


def _planned(side, spec, fn):
    side.faults.install_plan(spec)
    try:
        return fn()
    finally:
        side.faults.clear_plan()


def sc_fetch_fault_plan(side):
    st = side.store()
    a = side.client(st, "a")
    for name in NAMES:
        publish(side, a, name)
    b = side.client(st, "b", breaker_threshold=3)
    out = _planned(side, "aot.fetch:1-3", lambda: [
        b.prewarm(), fetch(side, b, "md5"), fetch(side, b, "match"), fetch(side, b, "cluster"),
        publish(side, b, "verdicts"), b.counters()["breaker"]])
    return out, [a, b], st


def sc_put_fault_plan(side):
    st = side.store()
    a = side.client(st, "a")
    out = _planned(side, "aot.put:1", lambda: [publish(side, a, "md5"), publish(side, a, "md5")])
    return out, [a], st


def sc_dead_store(side):
    st = side.mod.AotStore(DeadState(), side.stores.MemoryBlobStore())
    a = side.client(st, "a", breaker_threshold=2)
    out = [fetch(side, a, "md5"), publish(side, a, "md5"), a.prewarm(), fetch(side, a, "md5"),
           a.counters()["breaker"]]
    return out, [a], st


def sc_prewarm(side):
    st = side.store()
    a = side.client(st, "a")
    for name in NAMES:
        publish(side, a, name)
    b = side.client(st, "b")
    out = [b.prewarm(), b.prewarm()] + [fetch(side, b, n) for n in NAMES]
    return out, [a, b], st


def sc_epoch_bump(side):
    st = side.store()
    a = side.client(st, "a")
    out = [publish(side, a, "md5"), st.bump_epoch()]
    b = side.client(st, "b")
    out += [fetch(side, b, "md5"), b.prewarm(), publish(side, b, "md5"),
            sorted(json.loads(v)["k"] for v in st.list_index("g1").values()),
            fetch(side, side.client(st, "c"), "md5")]
    return out, [a, b], st


def sc_publish_disabled(side):
    st = side.store()
    a = side.client(st, "a", publish=False)
    return [publish(side, a, "md5"), fetch(side, a, "md5")], [a], st


SCENARIOS = [sc_publish_then_hits, sc_miss_then_publish, sc_fenced_publish, sc_corrupt_payload,
             sc_fetch_fault_plan, sc_put_fault_plan, sc_dead_store, sc_prewarm, sc_epoch_bump,
             sc_publish_disabled]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_client_counters_and_families_equal_jax(env, scenario):
    got = {}
    for name, side in SIDES.items():
        before = side.aot_series()
        out, clients, _st = scenario(side)
        got[name] = (out, [c.counters() for c in clients], deltas(before, side.aot_series()))
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]


def test_digests_are_the_ports_own(env):
    """The program groups differ (the port salts its CUDA sources and its
    toolchain; JAX its traced programs and jax/XLA), so one library's
    digest differs between the packages, and the store is not shared."""
    j = SIDES["jax"].client(SIDES["jax"].store())
    t = SIDES["torch"].client(SIDES["torch"].store())
    assert j.group() != t.group() and len(t.group()) == 24
    for name in NAMES:
        assert SIDES["torch"].digest(t, name) != SIDES["jax"].digest(j, name)
    # the port's digest of a library: its name and key, empty statics and shapes
    d = kernels.aot_digest(t, "md5")
    assert d == t.key_digest("md5", kernels.library_key("md5"), "", "")
    assert len({kernels.aot_digest(t, n) for n in NAMES}) == len(NAMES)


@pytest.mark.parametrize("change", ["capability", "nvcc", "source"])
def test_group_moves_with_the_toolchain_and_sources(env, monkeypatch, change):
    st = SIDES["torch"].store()
    before = SIDES["torch"].client(st).group()
    if change == "capability":
        monkeypatch.setattr(kernels, "_device_capability", lambda: (10, 0))
    elif change == "nvcc":
        monkeypatch.setattr(kernels, "_nvcc_version", lambda: NVCC_VERSION.replace("12.8", "12.9"))
    else:
        files = t_store._kernel_files()
        assert "ops/kernels.py" in files and any(f.endswith("md5.cu") for f in files)
        monkeypatch.setattr(t_store, "_kernel_files", lambda: files[:-1])
    assert SIDES["torch"].client(st).group() != before


# ---------------------------------------------------------------------------
# the payload codec


def test_payload_round_trip_and_refusals(env):
    blob = libcache.serialize_library("md5")
    assert blob.startswith(libcache._MAGIC)
    name, data = libcache.decode_payload(blob)
    assert name == "md5" and data == kernels.library_path("md5").read_bytes()
    kernels.library_path("md5").unlink()
    assert libcache.load_payload(blob) == kernels.library_path("md5")
    assert kernels.library_path("md5").read_bytes() == data
    bad = {
        "header": b"XXXXXX\x00" + blob[len(libcache._MAGIC):],
        "truncated": blob[:len(libcache._MAGIC) + 10],
        "sha256": blob[:-1] + bytes([blob[-1] ^ 1]),
        "key": blob.replace(kernels.library_key("md5").encode(), b"0" * 64),
        "name": blob.replace(b"\x03\x00\x00\x00md5", b"\x03\x00\x00\x00md6"),
    }
    for why, b in bad.items():
        with pytest.raises(ValueError):
            libcache.decode_payload(b)


# ---------------------------------------------------------------------------
# the loader through a client


def jax_materialize(side, client, name):
    """The reference's ``AotJit._materialize`` for one first-seen shape:
    fetch, else compile (here nothing) and publish."""
    digest = side.digest(client, name)
    if client.fetch_loaded(digest) is None:
        client.note_compile_seconds(0.0)
        client.publish(digest, {"k": name, "s": "", "a": ""}, name)


def _fresh_process(monkeypatch):
    """As a new process on another host finds it: nothing loaded, no
    keyed file on disk."""
    monkeypatch.setattr(kernels, "_libs", {})
    for name in NAMES:
        kernels.library_path(name).unlink(missing_ok=True)


def test_loader_cold_then_joiner_equals_jax(env, compiles, loads, monkeypatch):  # noqa: F811
    """A cold process (empty build directory) builds each library once and
    publishes it; a joiner prewarms all four and loads them with no
    compile. The port's counts equal the JAX client's on the reference's
    sequence: cold, a miss, a compile and a publish a library; joining,
    a prewarm, then a pool hit a library."""
    t, j = SIDES["torch"], SIDES["jax"]
    _fresh_process(monkeypatch)
    t_st, j_st = t.store(), j.store()
    t_before, j_before = t.aot_series(), j.aot_series()
    cold, j_cold = t.client(t_st, "cold"), j.client(j_st, "cold")
    kernels.attach_aot(cold)
    for name in NAMES:
        kernels.load_library(name)
        kernels.load_library(name)  # loaded: nothing more
        jax_materialize(j, j_cold, name)
    assert [p for _s, p in compiles] == [kernels.library_path(n) for n in NAMES]
    assert cold.counters() == j_cold.counters()
    assert cold.counters()["published"] == 4 and cold.counters()["fetch_misses"] == 4
    _fresh_process(monkeypatch)
    compiles.clear()
    joiner, j_joiner = t.client(t_st, "joiner"), j.client(j_st, "joiner")
    kernels.attach_aot(joiner)
    assert kernels.aot_prewarm() == 4 == j_joiner.prewarm()
    assert all(kernels.library_path(n).exists() for n in NAMES)
    for name in NAMES:
        kernels.load_library(name)
        jax_materialize(j, j_joiner, name)
    assert compiles == []
    assert joiner.counters() == j_joiner.counters()
    assert joiner.counters()["prewarmed"] == 4 and joiner.counters()["fetch_hits"] == 4
    assert deltas(t_before, t.aot_series()) == deltas(j_before, j.aot_series())
    assert loads[-4:] == [str(kernels.library_path(n)) for n in NAMES]


def test_loader_fetches_on_first_use_without_prewarm(env, compiles, loads, monkeypatch):  # noqa: F811
    t = SIDES["torch"]
    st = t.store()
    kernels.attach_aot(t.client(st, "pub"))
    for name in NAMES:
        kernels.aot_publish(name)
    _fresh_process(monkeypatch)
    lazy = t.client(st, "lazy")
    kernels.attach_aot(lazy)
    for name in NAMES:
        assert kernels.build(name) == 0.0  # fetched, not compiled
    assert compiles == [] and lazy.counters()["fetch_hits"] == 4
    for name in NAMES:
        kernels.load_library(name)
    assert lazy.counters()["fetch_hits"] == 8 and lazy.counters()["fetch_misses"] == 0


def test_local_keyed_files_are_pool_hits(env, compiles, loads, monkeypatch):  # noqa: F811
    """A keyed file on this host's disk is a pool hit with no store
    traffic: a dead store is never asked."""
    t = SIDES["torch"]
    monkeypatch.setattr(kernels, "_libs", {})
    st = t.mod.AotStore(DeadState(), t.stores.MemoryBlobStore())
    client = t.client(st, "local")
    kernels.attach_aot(client)
    for name in NAMES:
        kernels.load_library(name)
    c = client.counters()
    assert compiles == [] and c["fetch_hits"] == 4 and c["pool"] == 4 and c["breaker"] == "closed"


def _tamper(blob: bytes, how: str) -> bytes:
    if how == "header":
        return b"SWLIB0\x00" + blob[len(libcache._MAGIC):]
    if how == "sha256":
        return blob[:-1] + bytes([blob[-1] ^ 0xFF])
    return blob.replace(kernels.library_key("md5").encode(), b"f" * 64)


@pytest.mark.parametrize("how", ["key", "sha256", "header"])
def test_refused_payload_writes_nothing_and_builds_once(env, compiles, loads, monkeypatch,  # noqa: F811
                                                        how):
    t = SIDES["torch"]
    st = t.store()
    kernels.attach_aot(t.client(st, "pub"))
    kernels.aot_publish("md5")
    pub_digest = kernels.aot_digest(kernels.aot_client(), "md5")
    key = f"aot/g0/{pub_digest}"
    st._blobs.put(key, _tamper(st._blobs.get(key), how))
    _fresh_process(monkeypatch)
    written = []
    real_load = libcache.load_payload

    def spy(blob):
        out = real_load(blob)
        written.append(out)
        return out

    monkeypatch.setattr(libcache, "load_payload", spy)
    client = t.client(st, "joiner")
    kernels.attach_aot(client)
    assert kernels.aot_prewarm() == 0 and written == []
    assert not kernels.library_path("md5").exists()
    kernels.load_library("md5")
    c = client.counters()
    assert written == [] and [p for _s, p in compiles] == [kernels.library_path("md5")]
    assert c["deserialize_errors"] == 2 and c["published"] == 1  # the rebuild replaces it
    assert libcache.decode_payload(st._blobs.get(key))[0] == "md5"


def test_refused_library_file_is_dropped_and_rebuilt(env, compiles, monkeypatch):  # noqa: F811
    from test_torch_build import _Lib

    t = SIDES["torch"]
    monkeypatch.setattr(kernels, "_libs", {})
    calls = []

    def cdll(p):
        calls.append(p)
        if len(calls) == 1:
            raise OSError("invalid ELF header")
        return _Lib(p)

    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    client = t.client(t.store(), "w")
    kernels.attach_aot(client)
    kernels.load_library("md5")
    c = client.counters()
    assert len(compiles) == 1 and len(calls) == 2
    assert c["deserialize_errors"] == 1 and c["published"] == 1


def test_publish_off_publishes_nothing(env, compiles, loads, monkeypatch):  # noqa: F811
    t = SIDES["torch"]
    _fresh_process(monkeypatch)
    st = t.store()
    client = t.client(st, "ro", publish=False)
    kernels.attach_aot(client)
    before = t.aot_series()
    kernels.load_library("md5")
    after = deltas(before, t.aot_series())
    assert len(compiles) == 1 and st.list_index("g0") == {}
    assert client.counters()["published"] == 0 and client.counters()["fetch_misses"] == 1
    assert all(after[("swarm_aot_publish_total", o)] == 0 for o in ("stored", "fenced", "error"))
    assert after[("swarm_aot_bringup_seconds_count", "compile")] == 1


# ---------------------------------------------------------------------------
# the worker's config and engine_for

AOT_ENV = [
    ("SWARM_AOT_BACKEND", "local", "aot_backend"),
    ("SWARM_AOT_BACKEND", "MEMORY", "aot_backend"),
    ("SWARM_AOT_URL", "redis://10.0.0.9:6379/2", "aot_url"),
    ("SWARM_AOT_DIR", "/srv/aot", "aot_dir"),
    ("SWARM_AOT_PUBLISH", "0", "aot_publish"),
    ("SWARM_AOT_PUBLISH", "yes", "aot_publish"),
    ("SWARM_AOT_PREWARM", "false", "aot_prewarm"),
    ("SWARM_AOT_PREWARM", "on", "aot_prewarm"),
    ("SWARM_AOT_BREAKER_THRESHOLD", "7", "aot_breaker_threshold"),
    ("SWARM_AOT_BREAKER_COOLDOWN_S", "2.5", "aot_breaker_cooldown_s"),
    ("SWARM_AOT_PUBLISH", "", "aot_publish"),
]


@pytest.mark.parametrize("var,value,field", AOT_ENV, ids=[f"{v}={x}" for v, x, _f in AOT_ENV])
def test_aot_env_parses_as_jax_config(tmp_path, monkeypatch, var, value, field):
    from swarm_tpu.config import Config
    from swarm_tpu_torch.worker.runtime import WorkerConfig

    monkeypatch.setenv("HOME", str(tmp_path))
    want = getattr(Config.load(env={var: value}), field)
    got = getattr(WorkerConfig.load(env={var: value}, read_files=False), field)
    assert got == want and type(got) is type(want)


def test_aot_defaults_equal_jax_config(tmp_path, monkeypatch):
    from swarm_tpu.config import Config
    from swarm_tpu_torch.worker.runtime import WorkerConfig

    monkeypatch.setenv("HOME", str(tmp_path))
    j, t = Config.load(env={}), WorkerConfig.load(env={}, read_files=False)
    fields = ("aot_backend", "aot_url", "aot_dir", "aot_publish", "aot_prewarm",
              "aot_breaker_threshold", "aot_breaker_cooldown_s")
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}


def test_build_aot_client_backends(env, tmp_path, monkeypatch):
    from swarm_tpu_torch.worker.runtime import WorkerConfig

    monkeypatch.setattr(t_store, "_MEMORY_STORE", None)
    assert t_store.build_aot_client(WorkerConfig()) is None
    mem = t_store.build_aot_client(WorkerConfig(aot_backend="memory", worker_id="m"))
    assert mem._store is t_store.build_aot_client(WorkerConfig(aot_backend="memory"))._store
    local = t_store.build_aot_client(WorkerConfig(aot_backend="local", aot_dir=str(tmp_path),
                                                  aot_publish=False, aot_breaker_threshold=5))
    assert local.publish_enabled is False and local._breaker.threshold == 5
    assert local._breaker.name == "aot.store.worker-0"
    with pytest.raises(ValueError, match="unknown aot_backend"):
        t_store.build_aot_client(WorkerConfig(aot_backend="etcd"))
    # the local backend across two clients, as two processes on one host
    kernels.attach_aot(local)
    other = t_store.AotClient(t_store.AotStore(t_stores.LocalStateStore(tmp_path / "state"),
                                               t_stores.LocalBlobStore(tmp_path / "blobs")))
    local.publish_enabled = True
    assert kernels.aot_publish("verdicts") == "stored"
    assert other.prewarm() == 1


def test_engine_for_attaches_and_prewarms(env, tmp_path, monkeypatch, capsys):
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "db"))
    aot_dir = str(tmp_path / "aot")
    pub = t_store.build_aot_client(WorkerConfig(aot_backend="local", aot_dir=aot_dir))
    kernels.attach_aot(pub)
    for name in NAMES:
        assert kernels.aot_publish(name) == "stored"
    kernels.attach_aot(None)
    for name in NAMES:
        kernels.library_path(name).unlink()
    cfg = WorkerConfig(aot_backend="local", aot_dir=aot_dir, worker_id="joiner")
    eng = JobProcessor(cfg, device="cpu").engine_for(DATA)
    out = capsys.readouterr().out
    assert "AOT prewarm: 4 executables loaded in " in out
    client = kernels.aot_client()
    assert eng._aot_client is client and client.counters()["prewarmed"] == 4
    assert all(kernels.library_path(n).exists() for n in NAMES)
    assert eng.aot_prewarm() == 4  # pooled already: nothing fetched twice
    assert client.counters()["prewarmed"] == 4
    eng.attach_aot(None)
    assert kernels.aot_client() is None and eng.aot_prewarm() == 0


def test_engine_for_compiles_locally_when_the_store_cannot_be_built(env, tmp_path, monkeypatch,
                                                                     capsys):
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "db"))
    eng = JobProcessor(WorkerConfig(aot_backend="etcd"), device="cpu").engine_for(DATA)
    assert ("AOT executable cache unavailable (unknown aot_backend 'etcd'); compiling locally"
            in capsys.readouterr().out)
    assert eng._aot_client is None and kernels.aot_client() is None
    res = eng.match([Response(host="h", port=80, status=200, body=b"<title>Welcome to nginx!",
                              header=b"Server: nginx")])
    assert len(res) == 1


def test_sharded_and_device_surfaces_reach_the_process_attachment(env):
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.parallel.mesh import make_mesh

    templates, _ = load_corpus(DATA)
    eng = MatchEngine(templates, device="cpu", mesh=make_mesh((2, 1, 1), ["cpu"] * 2),
                      walk_threads=1)
    assert eng.sharded is not None and eng.aot_prewarm() == 0
    t = SIDES["torch"]
    st = t.store()
    pub = t.client(st, "pub")
    kernels.attach_aot(pub)
    kernels.aot_publish("cluster")
    kernels.attach_aot(None)
    client = t.client(st, "rank")
    eng.attach_aot(client)
    assert kernels.aot_client() is client
    assert eng.aot_prewarm() == 1 and eng.device.aot_prewarm() == 1
    eng.sharded.attach_aot(None)
    assert kernels.aot_client() is None
