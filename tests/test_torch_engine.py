"""The port's MatchEngine and fingerprint worker against the JAX package.

``MatchEngine.match`` on the CPU must give the JAX engine's template ids
and extractions (and the CPU oracle's) row for row, dead rows and
duplicated content included; a ``fingerprint`` job through the port's
``JobProcessor(device="cpu")`` must give the JAX worker's bytes, with
the scheduler (``pipeline: on``) as without it.
"""

import base64
import json
import os
import shutil

import pytest
import torch
import yaml

from chip_smoke import realistic_rows, synthetic_corpus, wide_matcher_docs, wide_matcher_rows
from swarm_tpu.config import Config
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.fingerprints import nuclei as j_nuclei
from swarm_tpu.ops import cpu_ref as j_cpu_ref
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.worker.modules import ModuleRegistry as JaxModuleRegistry
from swarm_tpu.worker.runtime import JobProcessor as JaxJobProcessor
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints import nuclei as t_nuclei
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.worker.modules import ModuleRegistry
from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig
from test_match_parity import DATA, fuzz_rows
from test_torch_worker import REPO, RecordingClient


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


#: a device-lowered template that reads the host: its extraction is
#: decided per row, not per content
ROWDEP_DOC = {
    "id": "rowdep-host-extract",
    "info": {"name": "host echo", "severity": "info"},
    "http": [{
        "method": "GET", "path": ["{{BaseURL}}"],
        "matchers": [{"type": "word", "words": ["Welcome to nginx"], "part": "body"}],
        "extractors": [{"type": "regex", "part": "host", "regex": ["[a-z]+"]}],
    }],
}


def corpus_docs() -> list[dict]:
    docs, _plants = synthetic_corpus(0, 150)
    return docs + [ROWDEP_DOC]


def rows_of(docs) -> list[dict]:
    """The realistic mix planted with the corpus, fuzz rows, duplicated
    content from other hosts, and dead rows."""
    _docs, plants = synthetic_corpus(0, 150)
    rows = realistic_rows(300, seed=21, plants=plants)
    templates = [j_nuclei.parse_template(d) for d in docs]
    import random

    for r in fuzz_rows(templates, random.Random(4), 40):
        rows.append({f: getattr(r, f) for f in ("host", "port", "status", "body", "header",
                                                 "banner")})
    rows += [dict(r, host=f"dup{i}") for i, r in enumerate(rows[:30])]
    rows[7] = dict(rows[7], alive=False)
    rows.append({"host": "dead", "port": 80, "alive": False})
    return rows


def test_engine_matches_jax_and_oracle():
    docs = corpus_docs()
    dicts = rows_of(docs)
    j_templates = [j_nuclei.parse_template(d) for d in docs]
    t_templates = [t_nuclei.parse_template(d) for d in docs]
    j_rows = [j_model.Response(**d) for d in dicts]
    want = JaxEngine(j_templates, mesh=None, pipeline="off").match(j_rows)
    # batch_rows 128: several batches, the last one partial
    eng = MatchEngine(t_templates, batch_rows=128, device="cpu")
    got = eng.match([t_model.Response(**d) for d in dicts])
    assert len(got) == len(want) == len(dicts)
    for i, (a, b) in enumerate(zip(want, got)):
        assert (b.template_ids, b.extractions) == (a.template_ids, a.extractions), i
    hits = [r for r in got if r.template_ids]
    assert len(hits) > 30 and any(r.extractions for r in hits)
    assert got[7].template_ids == [] and got[-1].template_ids == []
    # duplicated content from another host: per-row host extractions
    hosts = {r.extractions.get("rowdep-host-extract", [None])[0] for r in got}
    assert {"dup", "dead"} & hosts == {"dup"}
    assert eng.stats.unique_rows < eng.stats.rows
    # and the oracle, row for row, on every template
    for i in range(0, len(dicts), 5):
        ids, ext = [], {}
        for t in j_templates:
            res = j_cpu_ref.match_template(t, j_rows[i])
            if res.matched:
                ids.append(t.id)
                if res.extractions:
                    ext[t.id] = res.extractions
        assert (got[i].template_ids, got[i].extractions) == (ids, ext), i


def test_engine_matches_jax_on_matchers_of_more_than_32_values():
    """A status matcher of 40 codes (AND a word) and a size matcher of 40
    sizes: the port's engine on the CPU gives the JAX engine's template
    ids, the rows whose code or size lies past the first 32 included."""
    docs = wide_matcher_docs()
    dicts = wide_matcher_rows()
    want = JaxEngine([j_nuclei.parse_template(d) for d in docs], mesh=None,
                     pipeline="off").match([j_model.Response(**d) for d in dicts])
    got = MatchEngine([t_nuclei.parse_template(d) for d in docs], device="cpu").match(
        [t_model.Response(**d) for d in dicts])
    assert [r.template_ids for r in got] == [r.template_ids for r in want]
    assert [r.template_ids for r in got][:4] == [["many-status", "many-size"]] * 3 + [
        ["many-size"]]
    assert got[6].template_ids == ["many-size"] and got[7].template_ids == []


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatchEngine([t_nuclei.parse_template(ROWDEP_DOC)])


# ---------------------------------------------------------------------------
# The fingerprint worker


def jsonl(dicts) -> bytes:
    lines = []
    for d in dicts:
        obj = {"host": d.get("host", ""), "port": d.get("port", 0),
               "status": d.get("status", 0),
               "body_b64": base64.b64encode(d.get("body", b"")).decode(),
               "header_b64": base64.b64encode(d.get("header", b"")).decode()}
        if d.get("banner") is not None:
            obj["banner_b64"] = base64.b64encode(d["banner"]).decode()
        if not d.get("alive", True):
            obj["alive"] = False
        lines.append(json.dumps(obj))
    return ("\n".join(lines) + "\n\n").encode()


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    for doc in corpus_docs():
        (root / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
    return root


def jax_execute_tpu(templates_dir, blob: bytes) -> bytes:
    proc = JaxJobProcessor.__new__(JaxJobProcessor)
    proc.cfg = Config()
    templates, _ = j_nuclei.load_corpus(templates_dir)
    proc._engines = {str(templates_dir): JaxEngine(templates, mesh=None, pipeline="off")}
    return proc._execute_tpu(JaxModuleRegistry(REPO / "modules").load("fingerprint"), blob)


def test_fingerprint_job_identical(corpus_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("SWARM_TEMPLATES_DIR", str(corpus_dir))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    blob = jsonl(rows_of(corpus_docs()))
    job = {"job_id": "fp_1_0", "scan_id": "fp_1", "chunk_index": 0, "module": "fingerprint"}
    client = RecordingClient(job, blob)
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, device="cpu")
    proc.process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "uploading", "complete"]
    assert client.output == jax_execute_tpu(corpus_dir, blob)
    assert len(client.output.splitlines()) == len(rows_of(corpus_docs()))
    assert list(proc.engines) == [str(corpus_dir)]


@pytest.mark.parametrize("form", ["workflow_corpus", "targets", "nuclei", "pipeline"])
def test_unported_fingerprint_forms_fail(tmp_path, monkeypatch, form):
    """The forms of a ``fingerprint`` job the port once refused: a
    corpus with workflow templates, ``targets`` input, ``nuclei`` output
    and ``pipeline: on`` (the scheduler) now run, byte-identical to the
    JAX worker's same job."""
    from swarm_tpu.config import Config as JaxConfig
    from test_torch_worker import jax_processor

    corpus = tmp_path / "corpus"
    shutil.copytree(DATA / "http", corpus / "http")
    modules = tmp_path / "modules"
    modules.mkdir()
    spec = json.loads((REPO / "modules" / "fingerprint.json").read_text())
    blob = jsonl([{"host": "a", "port": 80, "status": 200,
                   "body": b"site powered by AcmeCMS, demo-build 3.11"}])
    if form == "workflow_corpus":
        shutil.copytree(DATA / "workflows", corpus / "workflows")
    elif form == "targets":
        # a refused loopback port; names resolve on localhost only
        spec.update(input_format="targets", probe={"resolvers": ["127.0.0.1"]})
        blob = b"127.0.0.1:1\n"
    elif form == "nuclei":
        spec["output_format"] = "nuclei"
    (modules / "fingerprint.json").write_text(json.dumps(spec))
    monkeypatch.setenv("SWARM_TEMPLATES_DIR", str(corpus))
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "dbcache"))
    job = {"job_id": "fp_1_0", "scan_id": "fp_1", "chunk_index": 0, "module": "fingerprint"}
    client = RecordingClient(job, blob)
    cfg = WorkerConfig(modules_dir=str(modules), max_jobs=1, poll_interval_busy_s=0,
                       pipeline="on" if form == "pipeline" else "off")
    JobProcessor(cfg, client=client, registry=ModuleRegistry(modules), device="cpu").process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "uploading", "complete"]
    if form == "pipeline":
        jax = JaxJobProcessor(JaxConfig(modules_dir=str(modules), pipeline="on"),
                              client=object(), registry=JaxModuleRegistry(str(modules)),
                              work_dir=str(tmp_path / "jax-worker"))
        assert client.updates[-1]["perf"]["pipeline"] == "on"
        assert client.updates[-1]["perf"]["sched"]["fresh_rows"] == 1
    else:
        jax = jax_processor(modules, tmp_path)
    assert client.output == jax._execute_tpu(jax.registry.load("fingerprint"), blob)
    assert client.output


def test_missing_corpus_fails_job(monkeypatch):
    # the module's templates are ${SWARM_TEMPLATES_DIR}: unset, no corpus
    monkeypatch.delenv("SWARM_TEMPLATES_DIR", raising=False)
    for registry in (ModuleRegistry, JaxModuleRegistry):
        with pytest.raises(ValueError, match="SWARM_TEMPLATES_DIR"):
            registry(REPO / "modules").load("fingerprint").templates_dir
    job = {"job_id": "fp_1_0", "scan_id": "fp_1", "chunk_index": 0, "module": "fingerprint"}
    client = RecordingClient(job, jsonl([{"host": "a", "port": 80, "status": 200}]))
    cfg = WorkerConfig(modules_dir=str(REPO / "modules"), max_jobs=1, poll_interval_busy_s=0)
    proc = JobProcessor(cfg, client=client, device="cpu")
    proc.process_jobs()
    assert [u["status"] for u in client.updates] == [
        "starting", "downloading", "executing", "cmd failed"]
    assert client.output is None
    assert not proc.engines
