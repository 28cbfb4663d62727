"""The port's match-engine host side against the JAX engine's.

The port's ``MatchEngine(device="cpu")`` must compute what
``swarm_tpu.ops.engine.MatchEngine(mesh=None, pipeline="off")`` computes
with its native libraries, the way it computes it: the same verdict
bits, template ids, extractions and host confirms per row
(``confirms_per_row``: matcher-level confirms of the sparse walk), batch
for batch, cold, served from the verdict memo, and again after
``clear_content_memos()``, with the walk serial (``walk_threads`` 0),
batched inline (1) and on a pool of 4. The regex front (``ops/fastre.py``)
and compiler (``ops/crexc.py``) are held to JAX's on tests/test_fastre.py's
patterns. Everything compared is integers, bytes or strings: tolerance 0.
"""

import dataclasses
import inspect
import os
import re

import pytest
import torch

from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.fingerprints import nuclei as j_nuclei
from swarm_tpu.native import crex as j_crex
from swarm_tpu.ops import crexc as j_crexc
from swarm_tpu.ops import engine as j_engine
from swarm_tpu.ops import fastre as j_fastre
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.native import crex as t_crex
from swarm_tpu_torch.ops import crexc as t_crexc
from swarm_tpu_torch.ops import engine as t_engine
from swarm_tpu_torch.ops import fastre as t_fastre
from bench import walk_stress_rows, walk_stress_templates
from test_fastre import HAND_CASES, corpus_patterns, sample_texts
from test_match_parity import DATA
from test_torch_engine import corpus_docs, rows_of
from test_torch_native import load_jax_crex


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


#: batch rows: the corpus's rows make three batches, the last partial
BATCH = 128


@pytest.fixture(scope="module", autouse=True)
def jax_crex_loaded():
    """Both packages' regex helpers on their crex VM (see
    :func:`test_torch_native.load_jax_crex`)."""
    load_jax_crex()

#: engine methods the port keeps as the reference wrote them
SAME_METHODS = (
    "_bind_db", "_cache_put", "_extract_op", "walk_threads", "configure_walk", "_walk_pool",
    "_resolve_regex_ex", "_accel_extract_regex", "_confirm_ext_pattern", "_confirm_operation",
    "_redo_template", "_confirm_matcher_serial", "_regex_matcher_raw",
    "_gather_confirm_candidates",
)

#: the crex binding's loader (one function under one lock, building
#: into the port's build directory) and the calls that raise on a
#: failed build instead of answering None
CREX_DIFFERS = ("ensure_crex", "_ensure_crex_locked", "finditer_spans",
                "finditer_spans_batch", "exists", "exists_batch", "search")


def ported_source(obj) -> str:
    return re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))


def own_members(module) -> dict:
    return {name: obj for name, obj in vars(module).items()
            if (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


COPIES = [(j_fastre, t_fastre, ()), (j_crexc, t_crexc, ()), (j_crex, t_crex, CREX_DIFFERS)]


@pytest.mark.parametrize("orig,port,differs", COPIES, ids=[c[0].__name__ for c in COPIES])
def test_copies_match_their_originals(orig, port, differs):
    mine = own_members(port)
    for name, obj in own_members(orig).items():
        if name in differs:
            continue
        assert name in mine, f"{port.__name__} lacks {name}"
        assert inspect.getsource(mine[name]) == ported_source(obj), name


@pytest.mark.parametrize("name", SAME_METHODS)
def test_engine_method_is_the_reference(name):
    def source_of(cls):
        obj = inspect.getattr_static(cls, name)
        return getattr(obj, "fget", getattr(obj, "__func__", obj))

    got = inspect.getsource(source_of(t_engine.MatchEngine))
    assert got == ported_source(source_of(j_engine.MatchEngine))


# ---------------------------------------------------------------------------
# The engines, batch for batch


def to_port(obj):
    """A JAX-package model object (Template, Operation, Matcher,
    Extractor, Response) as the port's, field for field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_model, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    return obj


def engine_corpus():
    """tests/test_torch_engine.py's corpus and rows: planted, fuzz,
    duplicated from other hosts, dead, a row-dependent template."""
    docs = corpus_docs()
    dicts = rows_of(docs)
    return ([j_nuclei.parse_template(d) for d in docs],
            [j_model.Response(**d) for d in dicts])


def stress_corpus():
    """The bundled corpus plus bench.py's walk-stress templates (long
    prefix-verified words, case-insensitive words, regex prefilters,
    binary needles, an extractor-only op) over its stress rows, with
    duplicated content from other hosts and dead rows: the uncertainty
    the sparse walk and its batched native passes resolve."""
    templates, errors = j_nuclei.load_corpus(DATA)
    assert templates, errors
    rows = walk_stress_rows(240, seed=42)
    rows += [dataclasses.replace(r, host=f"dup{i}") for i, r in enumerate(rows[:30])]
    for i in (5, 77, 251):
        rows[i] = dataclasses.replace(rows[i], alive=False)
    return list(templates) + walk_stress_templates(), rows


CORPORA = {"engine": engine_corpus, "stress": stress_corpus}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def engines(request):
    j_templates, j_rows = CORPORA[request.param]()
    jax = j_engine.MatchEngine(j_templates, mesh=None, pipeline="off", batch_rows=BATCH)
    port = t_engine.MatchEngine(to_port(j_templates), batch_rows=BATCH, device="cpu")
    t_rows = to_port(j_rows)
    assert len(t_rows) > 2 * BATCH
    return request.param, jax, port, j_rows, t_rows


def packed_view(eng, packed, n) -> tuple:
    rows = eng.rowmatches_from_packed(packed, n)
    return (
        packed.bits[:n].tobytes(), list(packed.template_ids), packed.extractions,
        packed.host_always_matches, packed.confirms_per_row,
        [(r.template_ids, r.extractions, r.confirmed_on_host) for r in rows],
    )


def run_pass(jax, port, j_rows, t_rows) -> list:
    """Both engines over the rows batch by batch; each batch's results
    must be equal. → the port's per-batch results."""
    out = []
    for s in range(0, len(t_rows), BATCH):
        want = packed_view(jax, jax.match_packed(j_rows[s : s + BATCH]), len(j_rows[s : s + BATCH]))
        got = packed_view(port, port.match_packed(t_rows[s : s + BATCH]), len(t_rows[s : s + BATCH]))
        for field, a, b in zip(("bits", "ids", "extractions", "host_always", "confirms",
                                "rows"), want, got):
            assert b == a, (s, field)
        out.append(got)
    return out


@pytest.mark.parametrize("walk_threads", [0, 1, 4])
def test_engine_walk_equals_jax(engines, walk_threads):
    corpus, jax, port, j_rows, t_rows = engines
    for eng in (jax, port):
        eng.configure_walk(walk_threads)
        eng.clear_content_memos()
    s0 = dict(port.stats.__dict__)
    cold = run_pass(jax, port, j_rows, t_rows)
    s1 = dict(port.stats.__dict__)
    warm = run_pass(jax, port, j_rows, t_rows)
    s2 = dict(port.stats.__dict__)
    # after clearing, the port's cold results again (the JAX engine's,
    # as held above)
    port.clear_content_memos()
    cleared = [packed_view(port, port.match_packed(t_rows[i : i + BATCH]),
                           len(t_rows[i : i + BATCH])) for i in range(0, len(t_rows), BATCH)]
    assert cleared == cold
    # the cold pass walked matchers (not whole templates) on the device's
    # miss uniques; the warm pass was served from the memo, device-free
    assert s1["unique_rows"] > s0["unique_rows"] and s1["host_confirm_pairs"] > s0[
        "host_confirm_pairs"]
    assert any(b[4] for b in cold)
    assert s2["unique_rows"] == s1["unique_rows"] and s2["device_seconds"] == s1["device_seconds"]
    assert s2["memo_slots"] - s1["memo_slots"] == sum(r.alive for r in t_rows)
    # served rows confirm only their row-dependent deferrals
    assert sum(sum(b[4].values()) for b in warm) < sum(sum(b[4].values()) for b in cold)
    if corpus == "stress":
        batched = s1["walk_batched_pairs"] - s0["walk_batched_pairs"]
        assert (batched > 0) == (walk_threads > 0)
    assert port.stats.walk_pool_threads == (walk_threads if walk_threads > 1 else 0)


def test_engine_match_equals_jax(engines):
    """``match`` (dead rows dropped before batching, batches of BATCH,
    each batch's encode made on a helper thread while the batch before
    it is matched): template ids and extractions equal the JAX engine's,
    row for row; the port's confirms equal the JAX engine's
    ``match_packed`` run over the same batches in turn, each batch
    encoded before the one before it is matched (its memo lookup sees
    the content walked up to two batches back, not the batch just
    before it)."""
    _corpus, jax, port, j_rows, t_rows = engines
    for eng in (jax, port):
        eng.configure_walk(None)
        eng.clear_content_memos()
    want = jax.match(j_rows)
    got = port.match(t_rows)
    assert [(r.template_ids, r.extractions) for r in got] == [
        (r.template_ids, r.extractions) for r in want]
    jax.clear_content_memos()
    live = [r for r in j_rows if r.alive]
    batches = [live[s : s + BATCH] for s in range(0, len(live), BATCH)]
    confirms = []
    pre = jax.encode_packed(batches[0], True)
    for i, rows in enumerate(batches):
        nxt = jax.encode_packed(batches[i + 1], True) if i + 1 < len(batches) else None
        confirms += [r.confirmed_on_host for r in jax.rowmatches_from_packed(
            jax.match_packed(rows, pre=pre), len(rows))]
        pre = nxt
    it = iter(confirms)
    assert [r.confirmed_on_host for r in got] == [
        next(it) if r.alive else 0 for r in t_rows]
    assert sum(confirms) > 0


def test_memo_queries_equal(engines):
    _corpus, jax, port, j_rows, t_rows = engines
    for eng in (jax, port):
        eng.clear_content_memos()
    half = len(t_rows) // 2
    jax.match_packed(j_rows[:BATCH])
    port.match_packed(t_rows[:BATCH])
    want = jax.memo_known_mask(j_rows[:half]).tolist()
    assert port.memo_known_mask(t_rows[:half]).tolist() == want
    assert [port.memo_contains(r) for r in t_rows[:half]] == [
        jax.memo_contains(r) for r in j_rows[:half]]
    assert 0 < sum(want) < half
    port.clear_content_memos()
    assert not port.memo_known_mask(t_rows[:half]).any()


# ---------------------------------------------------------------------------
# The regex front and compiler


def fastre_patterns() -> list:
    return [p for p, _t in HAND_CASES] + corpus_patterns(200)


@pytest.mark.parametrize("pattern", fastre_patterns())
def test_fastre_equal(pattern):
    """``analyze``, ``literals_absent``, ``search_bool`` and
    ``finditer_values`` (groups 0 and 1) of the port equal JAX's; the
    crex programs the analysis holds are the same programs."""
    ji, ti = j_fastre.analyze(pattern), t_fastre.analyze(pattern)
    assert (ti.ok, ti.literals, ti.cnf, ti.scan_pos, ti.scan_bytes, ti.needle) == (
        ji.ok, ji.literals, ji.cnf, ji.scan_pos, ji.scan_bytes, ji.needle)
    assert [p.tolist() for p in ti.prefix] == [p.tolist() for p in ji.prefix]
    for jp, tp in ((ji.cprog, ti.cprog), (ji.nfa, ti.nfa)):
        assert (jp is None) == (tp is None)
        if tp is not None:
            assert (tp.prog.tobytes(), tp.masks.tobytes()) == (jp.prog.tobytes(),
                                                               jp.masks.tobytes())
    texts = [t.encode("latin-1") for p, t in HAND_CASES if p == pattern] + sample_texts()
    for data in texts:
        text = data.decode("latin-1")
        if ti.ok:
            assert t_fastre.literals_absent(ti, data.lower()) == j_fastre.literals_absent(
                ji, data.lower())
        assert t_fastre.search_bool(pattern, data, text) == j_fastre.search_bool(
            pattern, data, text)
        for group in (0, 1):
            assert t_fastre.finditer_values(pattern, data, text, group) == (
                j_fastre.finditer_values(pattern, data, text, group))
