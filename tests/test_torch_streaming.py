"""The port's double-buffered probe→match stream
(``swarm_tpu_torch.worker.streaming``) against the JAX package's.

``stream_match`` runs with a stub probe that turns each wave of target
lines into response rows (the realistic mix, planted with the synthetic
corpus's fragments, dead rows and extra rows a target): the port's rows
and per-row results must be the JAX package's, in input order, at wave
sizes that do and do not divide the input. Exact.
"""

import os
import threading

import pytest
import torch

from chip_smoke import realistic_rows, synthetic_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.fingerprints import nuclei as j_nuclei
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.worker import executor as j_executor
from swarm_tpu.worker import streaming as j_streaming
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints import nuclei as t_nuclei
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.worker import executor as t_executor
from swarm_tpu_torch.worker import streaming as t_streaming


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


N_TARGETS = 90


@pytest.fixture(scope="module")
def corpus():
    docs, plants = synthetic_corpus(0, 120)
    rows = realistic_rows(N_TARGETS * 2, seed=5, plants=plants)
    return docs, rows


@pytest.fixture(scope="module")
def engines(corpus):
    docs, _rows = corpus
    return (MatchEngine([t_nuclei.parse_template(d) for d in docs], device="cpu"),
            JaxEngine([j_nuclei.parse_template(d) for d in docs], mesh=None, pipeline="off"))


def stub_probe(model, rows, threads):
    """An executor ``run`` that answers each target line ``t<i>`` with
    row i (odd i also with row i + N_TARGETS: two ports a target; every
    seventh target dead), and records the thread it ran on."""

    def run(self, lines):
        threads.add(threading.get_ident())
        out = []
        for line in lines:
            i = int(line.strip()[1:])
            if i % 7 == 3:
                out.append(model.Response(host=line, port=80, alive=False))
                continue
            out.append(model.Response(**rows[i]))
            if i % 2:
                out.append(model.Response(**rows[i + N_TARGETS]))
        return out

    return run


def outputs(rows, results):
    return [(r.host, r.port, r.alive, m.template_ids, m.extractions)
            for r, m in zip(rows, results)]


@pytest.mark.parametrize("wave", [7, 32, N_TARGETS, 1024])
def test_stream_match_equal(corpus, engines, monkeypatch, wave):
    _docs, rows = corpus
    t_threads, j_threads = set(), set()
    monkeypatch.setattr(t_executor.ProbeExecutor, "run", stub_probe(t_model, rows, t_threads))
    monkeypatch.setattr(j_executor.ProbeExecutor, "run", stub_probe(j_model, rows, j_threads))
    lines = [f"t{i}" for i in range(N_TARGETS)]
    t_eng, j_eng = engines
    t_eng.clear_content_memos()
    j_eng.clear_content_memos()
    t_rows, t_res, t_stats = t_streaming.stream_match(t_eng, lines, wave_targets=wave)
    j_rows, j_res, j_stats = j_streaming.stream_match(j_eng, lines, wave_targets=wave)
    got = outputs(t_rows, t_res)
    assert got == outputs(j_rows, j_res)
    assert [r.host for r in t_rows if r.alive][:3] == ["192.0.2.0", "192.0.2.1", "192.0.2.91"]
    assert len(t_rows) == N_TARGETS + N_TARGETS // 2 - sum(
        1 for i in range(N_TARGETS) if i % 7 == 3 and i % 2)
    assert any(m.template_ids for m in t_res)
    waves = -(-N_TARGETS // wave)
    assert (t_stats.waves, t_stats.rows) == (j_stats.waves, j_stats.rows) == (waves, len(t_rows))
    # the probe ran on the producer thread, never the caller's
    assert threading.get_ident() not in t_threads


def test_the_producer_never_touches_torch(corpus, engines, monkeypatch):
    """Every torch call stays on the consuming thread: each tensor the
    engine makes from its host batch is made on the caller's thread."""
    import torch

    _docs, rows = corpus
    caller = threading.get_ident()
    seen = []
    real = torch.from_numpy

    def guarded(*a, **kw):
        seen.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(torch, "from_numpy", guarded)
    monkeypatch.setattr(t_executor.ProbeExecutor, "run", stub_probe(t_model, rows, set()))
    t_eng = engines[0]
    t_eng.clear_content_memos()
    t_streaming.stream_match(t_eng, [f"t{i}" for i in range(40)], wave_targets=9)
    assert seen and set(seen) == {caller}


def test_pipeline_keeps_order_and_raises():
    pipe = t_streaming.StreamingPipeline(
        probe=lambda wave: [int(x) * 2 for x in wave],
        consume=lambda rows: sum(rows),
        wave_targets=3,
    )
    assert pipe.run([str(i) for i in range(10)]) == [6, 24, 42, 18]
    assert (pipe.stats.waves, pipe.stats.rows) == (4, 10)
    assert pipe.run([]) == [0]

    def bad(wave):
        if "4" in wave:
            raise ValueError("probe failed")
        return wave

    pipe = t_streaming.StreamingPipeline(probe=bad, consume=len, wave_targets=2)
    with pytest.raises(ValueError, match="probe failed"):
        pipe.run([str(i) for i in range(8)])
    pipe = t_streaming.StreamingPipeline(probe=list, consume=lambda r: 1 / 0, wave_targets=2)
    with pytest.raises(ZeroDivisionError):
        pipe.run(["a", "b", "c"])


def test_stats_overlap():
    s = t_streaming.StreamStats(probe_seconds=2.0, match_seconds=3.0, wall_seconds=4.0)
    assert s.overlap_seconds == pytest.approx(1.0)
    assert t_streaming.StreamStats(wall_seconds=9.0).overlap_seconds == 0.0
