"""The port's mesh across processes (``parallel/multihost.py`` and the
sharded matcher's multi-process branch), on the CPU with gloo.

- the reference's ``tests/test_sharding.py`` multi-host cases: a no-op
  without the environment, a group joined from it (with
  ``torch.distributed.init_process_group`` mocked), a partial triplet
  failing loudly; the backend choice from the processes' devices;
- a real two-process match: two interpreters join one gloo group over
  localhost, each holding 4 CPU ranks, and run the sharded match on
  grids where the data axis, the model axis and the seq axis span the
  processes; each process's planes must equal the JAX ``DeviceDB.match``
  on the same batch. Then a corpus refresh on the multi-process grid,
  and a ``MatchEngine`` whose auto mesh spans both processes, against
  the JAX package on the same corpus and rows.

The ranks' code is this file's ``__main__`` block, run with
``sys.executable``: it imports torch and the port, never JAX.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
DATA = HERE / "data" / "templates"
#: the grids of the two-process match, by the axis that spans the
#: processes (each process drives 4 of the 8 ranks, in process order)
GRIDS = {"data": (2, 2, 2), "model": (1, 2, 4), "seq": (1, 1, 8)}
#: the template the refresh adds, and a row that holds its word
PROBE_ID, PROBE_WORD = "delta-probe", "deltaprobe-needle-xyz"
RANK_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# the reference's multi-host cases


def test_multihost_noop_without_env():
    from swarm_tpu_torch.parallel.multihost import maybe_initialize_distributed

    assert maybe_initialize_distributed(env={}) is False
    assert maybe_initialize_distributed(env={}, autodetect=True) is False


def _mock_group(monkeypatch, world: int, peers=None):
    """``init_process_group`` and ``all_gather_object`` replaced: the
    calls recorded, every peer given ``peers`` (else this process's
    own device ids)."""
    import torch.distributed as dist

    from swarm_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))

    def gather(out, obj):
        out[:] = [obj if peers is None else peers[i] for i in range(world)]

    monkeypatch.setattr(dist, "all_gather_object", gather)
    monkeypatch.setattr(multihost, "_BACKEND", None)
    monkeypatch.setattr(multihost, "_GROUP", None)
    monkeypatch.delenv("SWARM_DIST_BACKEND", raising=False)
    return calls


def test_multihost_initializes_from_env(monkeypatch, capsys):
    from swarm_tpu_torch.parallel import multihost

    calls = _mock_group(monkeypatch, 4)
    ok = multihost.maybe_initialize_distributed(env={
        "SWARM_COORDINATOR": "10.0.0.1:8476",
        "SWARM_NUM_PROCESSES": "4",
        "SWARM_PROCESS_ID": "2",
    }, devices=["cpu"])
    assert ok is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:8476",
                      "world_size": 4, "rank": 2}]
    assert multihost.collective_backend() == "gloo" == os.environ["SWARM_DIST_BACKEND"]
    assert "collectives on gloo (a process runs its ranks on the CPU)" in capsys.readouterr().out


def test_multihost_autodetect_reads_torchrun_env(monkeypatch):
    from swarm_tpu_torch.parallel import multihost

    calls = _mock_group(monkeypatch, 2)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "2", "RANK": "1"}
    assert multihost.maybe_initialize_distributed(env=env) is False  # not asked to
    assert multihost.maybe_initialize_distributed(env=env, autodetect=True, devices=["cpu"])
    assert calls == [{"backend": "gloo", "init_method": "tcp://127.0.0.1:29500",
                      "world_size": 2, "rank": 1}]


def test_multihost_partial_config_fails_loudly():
    from swarm_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="incomplete"):
        multihost.maybe_initialize_distributed(
            env={"SWARM_COORDINATOR": "10.0.0.1:8476", "SWARM_NUM_PROCESSES": "4"})


@pytest.mark.parametrize("peers,backend", [
    ([[("cuda", "GPU-a")], [("cuda", "GPU-a")]], "gloo"),
    ([[("cuda", "GPU-a")], [("cuda", "GPU-b")]], "nccl"),
    ([[("cuda", "GPU-a")], [("cpu",)]], "gloo"),
], ids=["shared_card", "own_cards", "a_cpu_process"])
def test_backend_is_chosen_from_the_devices(monkeypatch, capsys, peers, backend):
    """Two processes on one card take gloo through host memory, each on
    its own cards NCCL (its group made once, never replaced), any CPU
    process gloo."""
    import torch.distributed as dist

    from swarm_tpu_torch.parallel import multihost

    _mock_group(monkeypatch, 2, peers)
    groups = []
    monkeypatch.setattr(dist, "new_group", lambda **kw: groups.append(kw) or "nccl-group")
    assert multihost._choose_backend(["cpu"], 2, 0) == backend
    assert multihost.collective_backend() == backend
    assert groups == ([{"backend": "nccl"}] if backend == "nccl" else [])
    assert multihost.world_group() == ("nccl-group" if backend == "nccl" else None)
    out = capsys.readouterr().out
    assert f"collectives on {backend}" in out
    if peers[0] == peers[1]:
        assert "share a card" in out


def test_failed_nccl_group_raises(monkeypatch):
    """No gloo in NCCL's place after a failure."""
    import torch.distributed as dist

    from swarm_tpu_torch.parallel import multihost

    _mock_group(monkeypatch, 2, [[("cuda", "GPU-a")], [("cuda", "GPU-b")]])

    def fail(**kw):
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(dist, "new_group", fail)
    with pytest.raises(RuntimeError, match="NCCL error"):
        multihost._choose_backend(None, 2, 0)
    assert multihost._BACKEND is None


# ---------------------------------------------------------------------------
# two processes


def _world():
    """The world of ``tests/multihost_worker.py``'s ``build_world``: its
    JAX db and its 16 rows, plus a row with the refresh's word, as dicts,
    encoded as it encodes them, the streams padded for 8 seq ranks
    (which also suits 2 and 4)."""
    import random

    import swarm_tpu.parallel.sharded as j_sharded
    from multihost_worker import build_world
    from swarm_tpu.fingerprints import load_corpus
    from swarm_tpu.fingerprints import model as j_model
    from swarm_tpu.ops.encoding import encode_batch
    from test_match_parity import fuzz_rows

    db, _batch = build_world()
    templates, _ = load_corpus(DATA)
    rows = fuzz_rows(templates, random.Random(41), 16)
    rows[3].oob_protocols = ("http", "dns")
    rows[3].oob_requests = b"GET /si00aa11bb22cc33 HTTP/1.1\r\nHost: cb.test\r\n\r\n" * 3
    fields = ("host", "port", "status", "body", "header", "banner", "oob_protocols",
              "oob_requests")
    dicts = [{f: getattr(r, f) for f in fields} for r in rows]
    dicts.append({"host": "p", "port": 80, "status": 200,
                  "body": f"x {PROBE_WORD} y".encode(), "header": b""})
    batch = encode_batch([j_model.Response(**d) for d in dicts], max_body=512,
                         max_header=512, pad_rows_to=32)
    streams = dict(batch.streams)
    j_sharded.pad_streams_for_seq(streams, 8, j_sharded.max_entry_len(db))
    return db, templates, {"streams": streams, "lengths": dict(batch.lengths),
                           "status": batch.status, "rows": dicts}


def _probe_template(model):
    return model.Template(id=PROBE_ID, protocol="http", operations=[model.Operation(
        matchers=[model.Matcher(type="word", part="body", words=[PROBE_WORD])])])


def _planes_equal(got, want) -> bool:
    """The six planes and the workflow gate planes, exactly."""
    assert len(got) == len(want) == 7
    if (got[6] is None) != (want[6] is None):
        return False
    return all(np.array_equal(g, np.asarray(w))
               for g, w in zip((*got[:6], *(got[6] or ())), (*want[:6], *(want[6] or ()))))


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Both ranks' outputs, or a failure naming the rank that failed."""
    tmp = tmp_path_factory.mktemp("mh")
    _db, _templates, world = _world()
    world_path = tmp / "world.pkl"
    world_path.write_bytes(pickle.dumps(world))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    try:
        for rank in (0, 1):
            env = dict(os.environ, JAX_PLATFORMS="cpu", SWARM_COORDINATOR=f"127.0.0.1:{port}",
                       SWARM_NUM_PROCESSES="2", SWARM_PROCESS_ID=str(rank),
                       SWARM_MH_IN=str(world_path), SWARM_MH_OUT=str(tmp / "out"),
                       OMP_NUM_THREADS="1")
            # output to files, not pipes: a rank blocked in a collective
            # while its sibling fills a pipe would deadlock the pair
            log = open(tmp / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve())],
                                          env=env, stdout=log, stderr=subprocess.STDOUT,
                                          cwd=str(HERE.parent)))
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed ({p.returncode}):\n{out[-4000:]}"
    return [pickle.loads((tmp / f"out.rank{r}").read_bytes()) for r in (0, 1)], outs


@pytest.fixture(scope="module")
def jax_planes():
    """The JAX single-device planes of the batch, on the corpus and on
    the corpus with the probe template; the JAX engine's results."""
    from swarm_tpu.fingerprints import model as j_model
    from swarm_tpu.fingerprints.compile import compile_corpus
    from swarm_tpu.ops.engine import MatchEngine
    from swarm_tpu.ops.match import DeviceDB

    db, templates, world = _world()
    args = (world["streams"], world["lengths"], world["status"])
    new = compile_corpus(list(templates) + [_probe_template(j_model)])
    eng = MatchEngine(templates, mesh=None, batch_rows=16, walk_threads=1)
    res = eng.match([j_model.Response(**d) for d in world["rows"]])
    return {"base": DeviceDB(db).match(*args, full=True),
            "refresh": DeviceDB(new).match(*args, full=True),
            "engine": [(sorted(r.template_ids), r.extractions) for r in res]}


@pytest.mark.parametrize("axis", list(GRIDS))
def test_two_process_planes_equal_jax(two_process_run, jax_planes, axis):
    """Each process returns the whole batch's planes, equal to the JAX
    single-device DeviceDB's, on a grid whose ``axis`` spans the two
    processes; the cross-process bytes are those of its collectives."""
    outs, _logs = two_process_run
    for rank, out in enumerate(outs):
        run = out["grids"][axis]
        assert run["multiprocess"] and run["process"] == [0] * 4 + [1] * 4
        assert _planes_equal(run["planes"], jax_planes["base"]), (rank, axis)
        assert run["planes"][6] is not None  # the corpus's workflow gates
        cross = run["cross_process_bytes"]
        assert cross["survivor"] == 4
        assert (cross["combine"] > 0) == (axis != "data")
        assert cross["gather"] > 0
    assert np.unpackbits(outs[0]["grids"][axis]["planes"][0]).any()


def test_two_process_refresh_equals_jax(two_process_run, jax_planes):
    """The model-spanning grid refreshed onto the corpus plus one template
    gives the JAX planes of the new corpus; a no-op uploads nothing."""
    outs, _logs = two_process_run
    for out in outs:
        assert out["refresh"]["stats"]["uploaded_leaves"] > 0
        assert _planes_equal(out["refresh"]["planes"], jax_planes["refresh"])
        assert out["refresh"]["noop"]["uploaded_leaves"] == 0
        assert out["refresh"]["noop"]["executables_kept"] is True
    probe = np.unpackbits(jax_planes["refresh"][0], axis=1)
    assert probe[len(outs[0]["engine"]["results"]) - 1].any()
    assert not _planes_equal(jax_planes["refresh"], jax_planes["base"])


def test_two_process_engine_auto_mesh_equals_jax(two_process_run, jax_planes):
    """A MatchEngine with the default mesh in the group spans both
    processes' ranks, and each process's results are the JAX engine's."""
    outs, logs = two_process_run
    for out, log in zip(outs, logs):
        assert out["engine"]["mesh_process"] == [0, 1]
        assert out["engine"]["results"] == jax_planes["engine"]
        assert "collectives on gloo (a process runs its ranks on the CPU)" in log


# ---------------------------------------------------------------------------
# one rank (this file run as a script)


def _rank_main() -> None:
    import torch
    import torch.distributed as dist

    from swarm_tpu_torch.fingerprints import model as t_model
    from swarm_tpu_torch.fingerprints.compile import compile_corpus, compile_corpus_delta
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.engine import MatchEngine
    from swarm_tpu_torch.parallel import multihost
    from swarm_tpu_torch.parallel.mesh import make_mesh
    from swarm_tpu_torch.parallel.sharded import ShardedMatcher

    torch.set_num_threads(1)
    assert multihost.maybe_initialize_distributed(devices=["cpu"] * 4)
    assert multihost.maybe_initialize_distributed()  # a second call: a no-op
    rank = multihost.process_index()
    world = pickle.loads(Path(os.environ["SWARM_MH_IN"]).read_bytes())
    args = (world["streams"], world["lengths"], world["status"])
    templates, errors = load_corpus(DATA)
    assert templates and not errors
    db = compile_corpus(templates)
    out = {"grids": {}}
    matchers = {}
    for axis, shape in GRIDS.items():
        mesh = make_mesh(shape, ["cpu"] * 4)
        m = ShardedMatcher(db, mesh)
        assert not m.overlap
        planes = m.match(*args)
        out["grids"][axis] = {"planes": planes, "multiprocess": m.multiprocess,
                              "process": mesh.process.reshape(-1).tolist(),
                              "cross_process_bytes": dict(m.cross_process_bytes)}
        matchers[axis] = m
    db_new, _stats = compile_corpus_delta(list(templates) + [_probe_template(t_model)], db)
    m = matchers["model"]
    stats = m.refresh(db_new)
    planes = m.match(*args)
    noop, _ = compile_corpus_delta(list(templates) + [_probe_template(t_model)], db_new)
    out["refresh"] = {"stats": stats, "planes": planes, "noop": m.refresh(noop)}
    eng = MatchEngine(templates, device="cpu", batch_rows=16, walk_threads=1)
    assert eng.sharded is not None and eng.sharded.multiprocess
    res = eng.match([t_model.Response(**d) for d in world["rows"]])
    out["engine"] = {"mesh_process": sorted({int(p) for p in eng.mesh.process.flat}),
                     "results": [(sorted(r.template_ids), r.extractions) for r in res]}
    Path(f"{os.environ['SWARM_MH_OUT']}.rank{rank}").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    _rank_main()
