"""The port's WorkflowRunner and the engine's gate planes against the JAX
package's.

On ``tests/data/templates`` (one named-matcher workflow) and on bench.py's
workflow-heavy synthetic corpus (named-matcher gates, tag and path
subtemplates), the port's ``WorkflowRunner`` over its CPU engine must
give the JAX runner's per-row results with the device gate planes
decoded and with the host loop (``device=False``,
``SWARM_WORKFLOW_DEVICE=0``), the JAX engine's ``RowMatches.wf`` planes
row for row, and the same ``evaluate_hits`` answers. Exact.
"""

import os
import numpy as np
import pytest

import bench
import torch
from swarm_tpu.cache.tier import row_digest as j_row_digest
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints.model import Response as JResponse
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.ops.workflows import WorkflowRunner as JaxRunner
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.ops import workflows as t_workflows
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.ops.workflows import WorkflowRunner, row_digest
from test_match_parity import DATA
from test_torch_walk import to_port


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


ACME = b"<html><body>site powered by AcmeCMS, demo-build 3.11</body></html>"


def demo_rows() -> list:
    """Rows that fire the demo workflow's trigger with and without the
    gated subtemplate, plain pages, a duplicate and a dead row."""
    hdr = b"HTTP/1.1 200 OK\r\nX-Widget-Version: 4.2"
    rows = [
        JResponse(host="10.0.0.1", port=80, status=200, body=ACME, header=hdr),
        JResponse(host="10.0.0.2", port=80, status=200, body=b"hello world",
                  header=b"HTTP/1.1 200 OK"),
        JResponse(host="10.0.0.3", port=8080, status=200,
                  body=b"<div>site powered by AcmeCMS, demo-build 9.9 dark</div>", header=hdr),
        JResponse(host="10.0.0.4", port=80, status=200,
                  body=b"site POWERED BY acmecms", header=hdr),
        JResponse(host="10.0.0.5", port=443, status=200, body=ACME, header=hdr),
        JResponse(host="10.0.0.6", port=80, alive=False),
    ]
    return rows


class Pair:
    """One corpus on both packages: engines, runners, rows."""

    def __init__(self, j_templates, rows, batch_rows=1024):
        self.j_templates = j_templates
        self.t_templates = [to_port(t) for t in j_templates]
        self.j_rows = rows
        self.batch_rows = batch_rows

    def t_rows(self):
        return [to_port(r) for r in self.j_rows]

    def engines(self):
        return (JaxEngine(self.j_templates, mesh=None, pipeline="off", batch_rows=self.batch_rows),
                MatchEngine(self.t_templates, device="cpu", batch_rows=self.batch_rows))


@pytest.fixture(scope="module")
def demo():
    templates, errors = j_load_corpus(DATA)
    assert not errors
    return Pair(templates, demo_rows())


@pytest.fixture(scope="module")
def stress():
    return Pair(bench.workflow_stress_templates(6), bench.workflow_stress_rows(48, 6),
                batch_rows=16)


def planes_of(results) -> list:
    return [None if rm.wf is None else [np.asarray(p).tobytes() for p in rm.wf]
            for rm in results]


@pytest.mark.parametrize("corpus", ["demo", "stress"])
def test_rowmatches_wf_planes_equal(request, corpus):
    pair = request.getfixturevalue(corpus)
    j_eng, t_eng = pair.engines()
    j_res, t_res = j_eng.match(pair.j_rows), t_eng.match(pair.t_rows())
    assert [r.template_ids for r in t_res] == [r.template_ids for r in j_res]
    assert planes_of(t_res) == planes_of(j_res)
    # the gates were lowered and carry bits on live rows
    assert t_eng.db.wf is not None and t_eng.db.wf.num_terms
    assert any(p is not None and any(b.strip(b"\0") for b in p) for p in planes_of(t_res))
    # the dead row has no planes
    assert all(p is None for p, r in zip(planes_of(t_res), pair.j_rows) if not r.alive)
    # memo-served rows (a second call) carry none, in both packages
    assert planes_of(t_eng.match(pair.t_rows())) == planes_of(j_eng.match(pair.j_rows))


@pytest.mark.parametrize("corpus", ["demo", "stress"])
@pytest.mark.parametrize("device", [True, False])
def test_run_equal(request, corpus, device):
    pair = request.getfixturevalue(corpus)
    j_eng, t_eng = pair.engines()
    j_run = JaxRunner(pair.j_templates, engine=j_eng, device=device)
    t_run = WorkflowRunner(pair.t_templates, engine=t_eng, device=device)
    assert t_run.device == j_run.device == device
    got = t_run.run(pair.t_rows())
    assert got == j_run.run(pair.j_rows)
    assert any(got)
    # every workflow is content-pure: the step memo serves the rescan
    # without the engine
    assert t_run._memo_complete == j_run._memo_complete is True
    calls = []
    t_eng.match = lambda rows: calls.append(rows) or []
    assert t_run.run(pair.t_rows()) == got
    assert calls == []


def test_device_decode_equals_host_twin(stress):
    _j, t_eng = stress.engines()
    dev = WorkflowRunner(stress.t_templates, engine=t_eng, device=True)
    twin = WorkflowRunner(stress.t_templates, engine=t_eng, device=False)
    assert dev.plan is not None and dev.device and not twin.device
    assert dev.run(stress.t_rows()) == twin.run(stress.t_rows())


@pytest.mark.parametrize("env,want", [("0", False), ("off", False), ("1", True), (None, True)])
def test_environment_switch(demo, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("SWARM_WORKFLOW_DEVICE", raising=False)
    else:
        monkeypatch.setenv("SWARM_WORKFLOW_DEVICE", env)
    j_eng, t_eng = demo.engines()
    t_run = WorkflowRunner(demo.t_templates, engine=t_eng)
    j_run = JaxRunner(demo.j_templates, engine=j_eng)
    assert t_run.device == j_run.device == want
    assert t_run.run(demo.t_rows()) == j_run.run(demo.j_rows)


def test_runner_builds_its_engine_on_the_given_device(demo):
    t_run = WorkflowRunner(demo.t_templates, device="cpu")
    assert str(t_run.engine.device.device) == "cpu"
    j_run = JaxRunner(demo.j_templates, mesh=None, pipeline="off")
    assert t_run.run(demo.t_rows()) == j_run.run(demo.j_rows)


@pytest.mark.parametrize("corpus", ["demo", "stress"])
def test_evaluate_hits_equal(request, corpus):
    """The worker's entry: gating over an already-matched hit set, named
    gates re-confirmed on the row."""
    pair = request.getfixturevalue(corpus)
    j_eng, t_eng = pair.engines()
    j_run = JaxRunner(pair.j_templates, engine=j_eng)
    t_run = WorkflowRunner(pair.t_templates, engine=t_eng)
    t_rows = pair.t_rows()
    fired = 0
    for jr, tr, rm in zip(pair.j_rows, t_rows, t_eng.match(t_rows)):
        hits = set(rm.template_ids)
        got = t_run.evaluate_hits(hits, lambda _t, _r=tr: [_r])
        assert got == j_run.evaluate_hits(hits, lambda _t, _r=jr: [_r])
        fired += bool(got)
    assert fired


def test_row_digest_is_the_references(stress):
    rows = demo_rows() + stress.j_rows[:8] + [JResponse(host="b", port=1, banner=b"SSH-2.0-x")]
    assert [row_digest(to_port(r)) for r in rows] == [j_row_digest(r) for r in rows]


def test_port_loads_the_same_corpus():
    t_templates, t_errors = t_load_corpus(DATA)
    j_templates, _ = j_load_corpus(DATA)
    assert not t_errors
    assert [to_port(t) for t in j_templates] == t_templates
    assert "demo-workflow" in {w.id for w in WorkflowRunner(t_templates, device="cpu").workflows}
    assert t_workflows._WF_MEMO_MAX == 4096
