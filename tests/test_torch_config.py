"""The port's ``Config`` (``swarm_tpu_torch/config.py``) against the JAX
package's (``swarm_tpu/config.py``), on the CPU.

- the dataclasses have the same fields in the same order, with equal
  names, types and defaults;
- ``load`` from the same config file, environment and overrides gives
  equal ``asdict`` (the default files, a malformed default, an explicit
  path that must load, precedence, empty variables, every bool, int and
  float field coerced from a string); ``save`` writes the same bytes and
  ``resolve_url`` strips the same slashes;
- the port's readers of a config (the admission controller, the result
  tier, the gateway scan cache, the AOT client, the queue) find their
  fields on the port's ``Config``.
"""

import dataclasses
import json

import pytest

import swarm_tpu.config as j_config
import swarm_tpu_torch.config as t_config
from swarm_tpu_torch.worker.runtime import WorkerConfig

J, T = j_config.Config, t_config.Config


@pytest.fixture
def home(tmp_path, monkeypatch):
    """An empty home directory for the default files."""
    h = tmp_path / "home"
    h.mkdir()
    monkeypatch.setenv("HOME", str(h))
    return h


def test_fields_equal_jax():
    mine = [(f.name, f.type, f.default) for f in dataclasses.fields(T)]
    theirs = [(f.name, f.type, f.default) for f in dataclasses.fields(J)]
    assert mine == theirs and len(mine) == 101
    assert dataclasses.asdict(T()) == dataclasses.asdict(J())


def test_worker_config_fields_are_config_fields():
    """The worker's own config is a subset with the same defaults."""
    full = {f.name: (f.type, f.default) for f in dataclasses.fields(T)}
    for f in dataclasses.fields(WorkerConfig):
        assert full[f.name] == (f.type, f.default), f.name


def _both(path=None, env=None, **overrides) -> tuple:
    env = {} if env is None else env
    return (dataclasses.asdict(T.load(path=path, env=env, **overrides)),
            dataclasses.asdict(J.load(path=path, env=env, **overrides)))


FILE = {"server_url": "http://file:1/", "api_key": "from-file", "port": "6001",
        "state_backend": "redis", "journal_compact_segments": 64, "qos_express_burst": "2",
        "monitor_tick_s": 1, "trace_enabled": "yes", "gateway_autoscale_apply": "on",
        "fleet_sim_preempt_grace_s": "7.5", "unknown_key": 7}


@pytest.mark.parametrize("case", ["explicit", "default", "legacy", "both_defaults",
                                  "malformed_default", "none"])
def test_load_from_files_equals_jax(case, home, tmp_path):
    explicit = None
    if case == "explicit":
        explicit = tmp_path / "server.json"
        explicit.write_text(json.dumps(FILE))
        (home / ".swarm_tpu.json").write_text(json.dumps({"api_key": "default"}))
    elif case == "default":
        (home / ".swarm_tpu.json").write_text(json.dumps(FILE))
    elif case == "legacy":
        (home / ".axiom.json").write_text(json.dumps(FILE))
    elif case == "both_defaults":
        (home / ".swarm_tpu.json").write_text(json.dumps(FILE))
        (home / ".axiom.json").write_text(json.dumps({"api_key": "legacy"}))
    elif case == "malformed_default":
        (home / ".swarm_tpu.json").write_text("{not json")
        (home / ".axiom.json").write_text(json.dumps(FILE))
    mine, theirs = _both(str(explicit) if explicit else None)
    assert mine == theirs
    if case in ("explicit", "default", "legacy", "both_defaults"):
        assert (mine["port"], mine["qos_express_burst"], mine["monitor_tick_s"],
                mine["trace_enabled"], mine["gateway_autoscale_apply"]) == (6001, 2, 1.0, True,
                                                                            True)


@pytest.mark.parametrize("content", [None, "{not json"])
def test_explicit_config_must_load(content, tmp_path, home):
    path = tmp_path / "cfg.json"
    if content is not None:
        path.write_text(content)
    for cls in (J, T):
        with pytest.raises((OSError, ValueError)):
            cls.load(path=str(path), env={})


def test_precedence_file_env_overrides_equal_jax(tmp_path, home):
    path = tmp_path / "server.json"
    path.write_text(json.dumps(FILE))
    env = {"SWARM_API_KEY": "from-env", "API_KEY": "alias", "SWARM_PORT": "7001",
           "SWARM_LEASE_SECONDS": "12", "SWARM_MAX_ATTEMPTS": "5", "SERVER_URL": "http://alias",
           "SWARM_JOURNAL_ENABLED": "off", "SWARM_MONITOR_ENABLED": "0"}
    mine, theirs = _both(str(path), env, api_key="from-flag", port=None, max_attempts=7)
    assert mine == theirs
    assert (mine["api_key"], mine["port"], mine["lease_seconds"], mine["max_attempts"],
            mine["server_url"], mine["journal_enabled"]) == ("from-flag", 7001, 12.0, 7,
                                                             "http://alias", False)


@pytest.mark.parametrize("env", [{"SWARM_API_KEY": ""}, {"API_KEY": "", "SWARM_SPOOL_DIR": ""},
                                 {"SWARM_WORKER_ID": "", "WORKER_ID": "alias"}])
def test_empty_variable_counts_as_jax(env, tmp_path, home):
    path = tmp_path / "server.json"
    path.write_text(json.dumps(FILE))
    mine, theirs = _both(str(path), env)
    assert mine == theirs


@pytest.mark.parametrize("raw", ["1", "true", "Yes", " on ", "0", "false", "off", "", "2"])
def test_every_bool_field_coerces_as_jax(raw, home):
    names = [f.name for f in dataclasses.fields(T) if f.type == "bool"]
    assert len(names) == 12
    env = {"SWARM_" + n.upper(): raw for n in names}
    mine, theirs = _both(env=env)
    assert mine == theirs
    assert {mine[n] for n in names} == {raw.strip().lower() in ("1", "true", "yes", "on")}


def test_every_number_field_coerces_as_jax(home):
    fields = [f for f in dataclasses.fields(T) if f.type in ("int", "float")]
    env = {"SWARM_" + f.name.upper(): "3" for f in fields}
    mine, theirs = _both(env=env)
    assert mine == theirs
    for f in fields:
        value = mine[f.name]
        assert value == 3 and type(value).__name__ == f.type, f.name


def test_save_and_resolve_url_equal_jax(tmp_path):
    cfg = dict(server_url="http://h:9//", api_key="k", lease_seconds=7.0, pipeline="on")
    mine, theirs = T(**cfg), J(**cfg)
    a, b = mine.save(str(tmp_path / "t.json")), theirs.save(str(tmp_path / "j.json"))
    assert a.read_bytes() == b.read_bytes()
    assert mine.resolve_url() == theirs.resolve_url() == "http://h:9"
    assert dataclasses.asdict(T.load(path=str(a), env={})) == dataclasses.asdict(mine)


def test_readers_find_their_fields_on_the_config(monkeypatch):
    from swarm_tpu_torch.aot import store as aot_store
    from swarm_tpu_torch.cache import tier as cache_tier
    from swarm_tpu_torch.gateway.admission import AdmissionController
    from swarm_tpu_torch.gateway.qoscache import build_gateway_cache
    from swarm_tpu_torch.server.queue import JobQueueService
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryDocStore, MemoryStateStore

    cfg = T(gateway_tenant_rate=2.5, gateway_tenant_burst=3, gateway_shed_pressure_bulk=0.4,
            cache_backend="memory", cache_ttl_s=9.0, aot_backend="memory", aot_publish=False,
            worker_id="cfg-w", journal_enabled=False, qos_express_burst=1)
    ac = AdmissionController.from_config(cfg)
    assert (ac.tenant_rate, ac.tenant_burst, ac.shed_pressure_bulk) == (2.5, 3, 0.4)
    monkeypatch.setattr(cache_tier, "_MEMORY_TIER", None, raising=False)
    tier = cache_tier.build_tier(cfg)
    assert tier is not None
    gw = build_gateway_cache(cfg)
    assert gw is not None
    monkeypatch.setattr(aot_store, "_MEMORY_STORE", None, raising=False)
    client = aot_store.build_aot_client(cfg)
    assert client is not None and client.publish_enabled is False
    q = JobQueueService(cfg, MemoryStateStore(), MemoryBlobStore(), MemoryDocStore())
    assert q.generation == 0 and q.recovery_summary is None
