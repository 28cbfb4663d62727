"""The port's service detection (``swarm_tpu_torch.ops.service``,
``fingerprints/nmap_probes.py``) against the JAX package's.

On the bundled probes DB the port's ``ServiceClassifier(device="cpu")``
must give the JAX classifier's ``ServiceInfo`` field for field over the
banners of ``tests/test_service_detect.py`` and
``tests/test_service_recall.py``, with and without the sent probes, and
``format_nmap_report`` byte for byte; on the 12,331-signature DB
(``swarm_tpu/data/service-probes-large.txt``, read as data) the same on
a spread subset of its recall set, each row also equal to the recall
file's label. Exact.
"""

import base64
import dataclasses
import inspect
import json
import os
import re
from pathlib import Path

import pytest
import torch

from swarm_tpu.fingerprints import nmap_probes as j_probes
from swarm_tpu.fingerprints.model import Response as JResponse
from swarm_tpu.ops import service as j_service
from swarm_tpu.worker import formats as j_formats
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.fingerprints import nmap_probes as t_probes
from swarm_tpu_torch.fingerprints.model import Response as TResponse
from swarm_tpu_torch.ops import service as t_service
from swarm_tpu_torch.worker import formats as t_formats
from test_service_detect import MINI_DB
from test_service_recall import ADVERSARIAL, _case


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
BUNDLED = REPO / "swarm_tpu_torch" / "data" / "service-probes.txt"
LARGE = REPO / "swarm_tpu" / "data" / "service-probes-large.txt"
RECALL = REPO / "swarm_tpu" / "data" / "service-probes-large.recall.json"


def ported_source(obj) -> str:
    return re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))


def own_members(module) -> dict:
    return {name: obj for name, obj in vars(module).items()
            if (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


@pytest.mark.parametrize("orig,port", [(j_probes, t_probes), (j_service, t_service),
                                       (j_formats, t_formats)],
                         ids=["nmap_probes", "service", "formats"])
def test_copies_match_their_originals(orig, port):
    mine = own_members(port)
    for name, obj in own_members(orig).items():
        assert name in mine, f"{port.__name__} lacks {name}"
        assert inspect.getsource(mine[name]) == ported_source(obj), name


def test_bundled_db_is_the_references():
    assert BUNDLED.read_bytes() == j_probes.BUNDLED_DB.read_bytes()
    assert t_probes.BUNDLED_DB == BUNDLED
    assert t_probes.SYSTEM_DB == j_probes.SYSTEM_DB


@pytest.mark.parametrize("path", [BUNDLED, LARGE], ids=["bundled", "large"])
def test_probes_parse_equal(path):
    t, t_skipped = t_probes.load_probes(path)
    j, j_skipped = j_probes.load_probes(path)
    assert t_skipped == j_skipped
    assert [dataclasses.asdict(p) for p in t] == [dataclasses.asdict(p) for p in j]


def info_dicts(infos) -> list:
    return [dataclasses.asdict(i) for i in infos]


def classify_both(t_clf, j_clf, cases, sent: bool):
    """Rows ``h<i>.example:<port>`` of ``(banner, port, probe)`` cases,
    plus a dead and an empty row → (port infos, JAX infos)."""
    t_rows = [TResponse(host=f"h{i % 7}.example", port=p, banner=b)
              for i, (b, p, _pr) in enumerate(cases)]
    j_rows = [JResponse(host=f"h{i % 7}.example", port=p, banner=b)
              for i, (b, p, _pr) in enumerate(cases)]
    t_rows += [TResponse(host="dead", port=1, alive=False), TResponse(host="e", port=2, banner=b"")]
    j_rows += [JResponse(host="dead", port=1, alive=False), JResponse(host="e", port=2, banner=b"")]
    probes = [pr for _b, _p, pr in cases] + ["NULL", "NULL"] if sent else None
    return t_clf.classify(t_rows, probes), j_clf.classify(j_rows, probes)


@pytest.fixture(scope="module")
def bundled():
    return (t_service.ServiceClassifier(db_path=str(BUNDLED), device="cpu"),
            j_service.ServiceClassifier(db_path=str(BUNDLED)))


ADV_CASES = [(b, p, pr) for b, p, _s, _w, pr in map(_case, ADVERSARIAL)]


@pytest.mark.parametrize("sent", [True, False], ids=["sent_probes", "no_probes"])
def test_bundled_classify_equal(bundled, sent, monkeypatch, tmp_path):
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path))
    t_clf, j_clf = bundled
    got, want = classify_both(t_clf, j_clf, ADV_CASES, sent)
    assert info_dicts(got) == info_dicts(want)
    assert [i.line() for i in got] == [i.line() for i in want]
    assert t_formats.format_nmap_report(got) == j_formats.format_nmap_report(want)
    assert sum(i.service is not None for i in got) >= 100
    # the classify memo serves a repeat with the same answers
    again, _ = classify_both(t_clf, j_clf, ADV_CASES, sent)
    assert info_dicts(again) == info_dicts(got)


def test_mini_db_classify_equal():
    """The hand DB of ``test_service_detect.py``: probe order, softmatch
    restriction, fallbacks."""
    t_clf = t_service.ServiceClassifier(probes=t_probes.parse_probes(MINI_DB)[0], device="cpu")
    j_clf = j_service.ServiceClassifier(probes=j_probes.parse_probes(MINI_DB)[0])
    cases = [
        (b"SSH-2.0-OpenSSH_8.9p1 Ubuntu\r\n", 22, "NULL"),
        (b"SSH-2.0-dropbear\r\n", 22, "NULL"),
        (b"220 (vsFTPd 3.0.3)\r\n", 21, "NULL"),
        (b"HTTP/1.1 200 OK\r\nServer: nginx/1.18.0\r\n\r\n", 80, "GetRequest"),
        (b"HTTP/1.0 404 NF\r\n\r\n", 8080, "GetRequest"),
        (b"HTTP/1.0 404 NF\r\n\r\n", 8080, "NULL"),
        (b"SSH-2.0-OpenSSH_9.6\r\n", 8000, "GetRequest"),
        (b"garbage", 1, "Unknown"),
    ]
    for sent in (True, False):
        got, want = classify_both(t_clf, j_clf, cases, sent)
        assert info_dicts(got) == info_dicts(want)
        assert t_formats.format_nmap_report(got) == j_formats.format_nmap_report(want)
    for port in (1, 22, 80, 443, 8050, 65535):
        assert t_clf.probe_for_port(port).name == j_clf.probe_for_port(port).name
    assert t_clf.default_payload_probe().name == j_clf.default_payload_probe().name


def test_probe_selection_equal(bundled):
    from swarm_tpu_torch.worker.executor import top_ports

    t_clf, j_clf = bundled
    for port in top_ports() + [1, 2121, 40000, 65535]:
        assert dataclasses.asdict(t_clf.probe_for_port(port)) == dataclasses.asdict(
            j_clf.probe_for_port(port))
    assert dataclasses.asdict(t_clf.default_payload_probe()) == dataclasses.asdict(
        j_clf.default_payload_probe())


# ---------------------------------------------------------------------------
# The production-scale DB: 487 probes, 12,331 signatures


@pytest.fixture(scope="module")
def large(tmp_path_factory):
    cache = tmp_path_factory.mktemp("svcdb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWARM_DB_CACHE_DIR", str(cache))
        t_clf = t_service.ServiceClassifier(db_path=str(LARGE), device="cpu")
        j_clf = j_service.ServiceClassifier(db_path=str(LARGE))
    return t_clf, j_clf, cache


#: recall rows a test takes: every eleventh entry (126 of 1,386)
RECALL_STEP = 11


def test_large_db_recall_subset_equal(large):
    t_clf, j_clf, _cache = large
    assert len(t_clf._matches) == len(j_clf._matches) == 12331
    assert len(t_clf.probes) == 487
    recall = json.loads(RECALL.read_text())[::RECALL_STEP]
    cases = [(base64.b64decode(r["banner"]), 2121, r["probe"]) for r in recall]
    got, want = classify_both(t_clf, j_clf, cases, sent=True)
    assert info_dicts(got) == info_dicts(want)
    assert t_formats.format_nmap_report(got) == j_formats.format_nmap_report(want)
    # the rule tests/test_service_detect.py holds the JAX classifier to
    for r, info in zip(recall, got):
        assert (info.service, info.product, info.version) == (
            r["service"], r["product"], r["version"]), info.line()
    # bench.py's service shapes and the adversarial banners, no probe named
    got, want = classify_both(t_clf, j_clf, ADV_CASES[::3], sent=False)
    assert info_dicts(got) == info_dicts(want)


def test_large_db_served_from_the_ports_cache(large, monkeypatch):
    _t, _j, cache = large
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(cache))
    entries = sorted(p.name for p in cache.glob("*.pkl"))
    ours = [e for e in entries if e.startswith("swarm_tpu_torch-svcdb-")]
    assert len(ours) == 1 and len(entries) == 2
    calls = []
    monkeypatch.setattr(t_compile, "compile_corpus", lambda t: calls.append(t))
    warm = t_service.ServiceClassifier(db_path=str(LARGE), device="cpu")
    assert calls == [] and warm.engine.db.num_templates == 12331
    assert sorted(p.name for p in cache.glob("*.pkl")) == entries
