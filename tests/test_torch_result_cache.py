"""The port's fleet result tier against the JAX package's, on the CPU.

``swarm_tpu_torch/stores.py`` and ``swarm_tpu_torch/cache/tier.py`` are
copies of the reference's (``tests/test_torch_match.py`` holds their
sources equal). Here they are held to it in use, after
``tests/test_result_cache.py``:

- the wire format byte for byte: ``row_digest``, ``confirm_digest``,
  the verdict entry and the workflow entry;
- an engine pair of each package (writer A, then reader B with a cold
  L1 over the same tier) in each tier state: cold then warm across
  engines, JAX's dict-memo L1 (the port has the native memo only, so its
  pair is the same run), dead rows and duplicate content, the
  scheduler's prefetch, the confirm family on and off, the workflow
  family, a superseded writer, a fault plan, a dead and a dying store,
  an epoch bump. Each pair gives the JAX pair's RowMatches (template
  ids, extractions, host confirms), tier ``counters()``, writebacks by
  family and outcome, and the tier's stored entries;
- the tier's own contracts on the port: fencing before and during a
  write, ``bump_epoch`` reaching live clients, a corpus refresh moving
  the epoch once, TTL and max-entry eviction, the breaker under
  ``cache.get`` / ``cache.put`` plans, and a worker whose
  ``SWARM_CACHE_BACKEND=memory`` engines share the tier
  (``JobProcessor.engine_for``).

RowMatches against a tierless engine compare template ids and
extractions: a row the tier served was walked by another engine, so its
host confirms are counted there. Everything compared is integers, bytes
or strings: tolerance 0.

One engine per corpus and package is built for the module (a JAX
engine's first match traces its device function, ~7 s); each run takes
it with its content memos cleared, its scheduler dropped and the run's
client attached, which is the fresh engine of the JAX tests (a cold L1).
Engines walk inline (``walk_threads=1``) under one intra-op torch
thread.
"""

import numpy as np
import pytest
import torch

import bench as bench_mod
import swarm_tpu.cache.tier as j_tier
import swarm_tpu.resilience.faults as j_faults
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.memo_export as j_memo
import swarm_tpu_torch.cache.tier as t_tier
import swarm_tpu_torch.resilience.faults as t_faults
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.memo_export as t_memo
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.fingerprints.compile import compile_corpus as j_compile_corpus
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.ops.workflows import WorkflowRunner as JaxRunner
from swarm_tpu_torch.fingerprints.compile import compile_corpus as t_compile_corpus
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.ops.workflows import WorkflowRunner

from test_torch_walk import to_port
from test_workflows import _acme_rows

DATA = "tests/data/templates"
FAMILIES = ("verdict", "confirm", "workflow")
OUTCOMES = ("stored", "fenced", "error")
#: engine stats both packages keep
STATS = ("rows", "batches", "memo_slots", "host_confirm_pairs", "host_always_pairs",
         "overflow_rows")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rows(n, seed=7, unique=True):
    """``tests/test_result_cache.py``'s rows: the realistic mix, each
    body salted when ``unique`` (JAX Responses)."""
    rows = bench_mod.realistic_rows(n, seed=seed)
    if unique:
        rng = np.random.default_rng(seed + 1)
        for i, r in enumerate(rows):
            salt = bytes(rng.integers(97, 123, size=24, dtype=np.uint8))
            r.body = b"<!-- u%d %s -->" % (i, salt) + r.body
    return rows


class Side:
    """One package's half of a comparison: its tier and store modules,
    fault plan, memo families, and one engine per corpus."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.tier_mod = j_tier if jax_side else t_tier
        self.stores = j_stores if jax_side else t_stores
        self.faults = j_faults if jax_side else t_faults
        self.memo = j_memo if jax_side else t_memo
        self.Runner = JaxRunner if jax_side else WorkflowRunner
        if jax_side:
            templates, errors = j_load_corpus(DATA)
        else:
            templates, errors = t_load_corpus(DATA)
        assert templates and not errors
        stress = bench_mod.walk_stress_templates()
        self.corpora = {"corpus": list(templates),
                        "stress": list(templates) + (stress if jax_side else to_port(stress))}
        self._dbs: dict = {}
        self._engines: dict = {}

    # -- objects ------------------------------------------------------------
    def rows(self, rows):
        """Fresh row objects of this package over ``rows`` (JAX
        Responses): the content's bytes, ``alive`` kept."""
        if self.name == "jax":
            out = bench_mod._clone_rows(rows)
            for o, r in zip(out, rows):
                o.alive = r.alive
            return out
        return to_port(rows)

    def tier(self, state=None, **kw):
        return self.tier_mod.SharedResultTier(
            state if state is not None else self.stores.MemoryStateStore(),
            self.stores.MemoryBlobStore(), **kw)

    def client(self, tier, worker, **kw):
        return self.tier_mod.ResultCacheClient(tier, worker_id=worker, **kw)

    def db(self, corpus, templates=None):
        templates = templates if templates is not None else self.corpora[corpus]
        key = (corpus, id(templates))
        if key not in self._dbs:
            compile_corpus = j_compile_corpus if self.name == "jax" else t_compile_corpus
            self._dbs[key] = (templates, compile_corpus(templates))
        return self._dbs[key][1]

    def new_engine(self, templates, db=None, batch_rows=32, **kw):
        kw = dict(mesh=None, batch_rows=batch_rows, walk_threads=1, db=db, **kw)
        if self.name == "jax":
            return JaxEngine(templates, pipeline="off", **kw)
        return MatchEngine(templates, device="cpu", **kw)

    def engine(self, corpus, client=None, batch_rows=32, pipeline="off", dict_memo=False):
        """This package's engine of ``corpus`` with a cold L1: content
        memos cleared, no scheduler, ``client`` attached."""
        eng = self._engines.get(corpus)
        if eng is None:
            eng = self._engines[corpus] = self.new_engine(
                self.corpora[corpus], db=self.db(corpus))
        eng.clear_content_memos()
        eng._shared_seen.clear()
        eng._sched = None
        eng.batch_rows = batch_rows
        eng.pipeline = pipeline
        if self.name == "jax":
            # the dict-memo L1 of a JAX engine without its native library
            eng._native_memo_ok = False if dict_memo else None
            eng._vmemo = None
        eng.attach_result_cache(client)
        return eng

    # -- observations -------------------------------------------------------
    def writebacks(self) -> dict:
        return {(f, o): self.memo.MEMO_WRITEBACKS.labels(family=f, outcome=o).value
                for f in FAMILIES for o in OUTCOMES}

    def run(self, eng, rows, client=None, match=None) -> dict:
        """One call of ``match`` (``eng.match``) over this package's copy
        of ``rows`` → what it returned and what it moved."""
        before = {k: getattr(eng.stats, k) for k in STATS}
        unique = getattr(eng.stats, "unique_rows", 0)
        wb = self.writebacks()
        got = (match or eng.match)(self.rows(rows))
        out = {
            "results": view(got) if match is None else got,
            "stats": {k: getattr(eng.stats, k) - before[k] for k in STATS},
            "writebacks": {k: v - wb[k] for k, v in self.writebacks().items() if v - wb[k]},
        }
        if client is not None:
            out["counters"] = counters(client)
        if self.name == "torch":
            # the rows the port's engine sent to the device (the JAX
            # engine keeps no such count)
            out["device_rows"] = eng.stats.unique_rows - unique
        return out


def view(results) -> list:
    return [(r.template_ids, r.extractions, r.confirmed_on_host) for r in results]


def ids_ext(results) -> list:
    return [(ids, ext) for ids, ext, _conf in results]


def counters(client) -> dict:
    """``client.counters()`` with the epoch's generation only: its digest
    half covers each package's compiler sources, so it differs by
    design."""
    c = dict(client.counters())
    c["epoch"] = c["epoch"].rsplit(".g", 1)[1] if c["epoch"] else None
    return c


def jax_view(obs):
    """An observation without the port's device-row counts."""
    if isinstance(obs, dict):
        return {k: jax_view(v) for k, v in obs.items() if k != "device_rows"}
    return obs


def tier_entries(tier) -> dict:
    """family → {digest: value} of every entry the tier's memory state
    store holds (one epoch a family in these runs)."""
    out: dict = {}
    prefix = tier._prefix + ":"
    for name, h in tier._state._hashes.items():
        fam = name[len(prefix):].split(":", 1)[0]
        if name.startswith(prefix) and fam in ("v", "c", "w"):
            out.setdefault(fam, {}).update(h)
    return out


@pytest.fixture(scope="module")
def sides():
    return {"jax": Side("jax"), "torch": Side("torch")}


# ---------------------------------------------------------------------------
# the scenarios: each runs one engine pair of one package


def sc_cold_warm(side, dict_memo=False):
    rows = _rows(14)
    want = side.run(side.engine("corpus", dict_memo=dict_memo), rows)
    tier = side.tier()
    ca, cb = side.client(tier, "wa"), side.client(tier, "wb")
    a = side.run(side.engine("corpus", ca, dict_memo=dict_memo), rows, ca)
    b = side.run(side.engine("corpus", cb, dict_memo=dict_memo), rows, cb)
    return {"tierless": want, "a": a, "b": b, "entries": tier_entries(tier)}


def sc_dead_dup(side):
    rows = _rows(10)
    rows[7] = bench_mod._clone_rows([rows[1]])[0]  # duplicate content
    # a dead twin of row 0: content the tier holds after A, never served
    rows[3] = j_model.Response(alive=False, body=rows[0].body)
    want = side.run(side.engine("corpus"), rows)
    tier = side.tier()
    ca, cb = side.client(tier, "p1"), side.client(tier, "p2")
    a = side.run(side.engine("corpus", ca), rows, ca)
    b = side.run(side.engine("corpus", cb), rows, cb)
    return {"tierless": want, "a": a, "b": b, "entries": tier_entries(tier)}


def sc_prefetch(side):
    rows = _rows(28, seed=21)
    want = side.run(side.engine("corpus"), rows)
    tier = side.tier()
    ca, cb = side.client(tier, "s1"), side.client(tier, "s2")
    a = side.run(side.engine("corpus", ca), rows, ca)
    eng = side.engine("corpus", cb, batch_rows=16, pipeline="on")
    b = side.run(eng, rows, cb)
    snap = eng.scheduler().stats.snapshot()
    b["sched"] = {k: snap[k] for k in ("memo_rows", "fresh_rows", "dead_rows")}
    return {"tierless": want, "a": a, "b": b, "entries": tier_entries(tier)}


def sc_confirm(side):
    """Engine A resolves a confirm-heavy feed; engine B gets the same
    part bytes inside new row compositions (each header extended), so
    the verdict family misses and only the confirm family can hit: once
    with the confirm family off (and no writeback, so the tier stays as
    A left it), then on."""
    rows = bench_mod.walk_stress_rows(32, seed=11)
    rows_b = bench_mod._clone_rows(rows)
    for i, r in enumerate(rows_b):
        r.header = r.header + b"\r\nX-Recompose: %d" % i
    want = side.run(side.engine("stress", batch_rows=64), rows_b)
    tier = side.tier()
    ca = side.client(tier, "cfA")
    a = side.run(side.engine("stress", ca, batch_rows=64), rows, ca)
    entries = tier_entries(tier)
    off = side.client(tier, "cfB0", confirm=False, writeback=False)
    b_off = side.run(side.engine("stress", off, batch_rows=64), rows_b, off)
    on = side.client(tier, "cfB1")
    b_on = side.run(side.engine("stress", on, batch_rows=64), rows_b, on)
    return {"tierless": want, "a": a, "entries": entries, "b_off": b_off, "b_on": b_on}


def sc_workflow(side):
    """``tests/test_workflows.py``'s rescan: runner A gates the acme rows
    and writes the ``w`` family back; runner B, on a cold engine over
    the same tier, serves every row from it without calling the
    engine."""
    rows = _acme_rows()
    tier = side.tier()
    ca, cb = side.client(tier, "wa"), side.client(tier, "wb")
    eng = side.engine("corpus", ca, batch_rows=8)
    a = side.run(eng, rows, ca, match=side.Runner(side.corpora["corpus"], engine=eng).run)
    eng = side.engine("corpus", cb, batch_rows=8)
    calls: list = []
    real = eng.match
    eng.match = lambda rs, **kw: (calls.append(len(rs)), real(rs, **kw))[1]
    try:
        b = side.run(eng, rows, cb, match=side.Runner(side.corpora["corpus"], engine=eng).run)
    finally:
        del eng.match
    b["engine_calls"] = calls
    return {"a": a, "b": b, "entries": tier_entries(tier)}


def sc_fenced(side):
    """A client's identity superseded after it bound (the restarted
    successor): its writebacks are fenced, and a fresh reader finds
    nothing of it."""
    rows = _rows(8)
    tier = side.tier()
    client = side.client(tier, "w9")
    eng = side.engine("corpus", client)
    tier.acquire_writer(f"w9:{side.tier_mod.corpus_digest(side.corpora['corpus'])[:8]}")
    a = side.run(eng, rows, client)
    fresh = side.client(tier, "w10")
    b = side.run(side.engine("corpus", fresh), rows, fresh)
    return {"a": a, "b": b, "entries": tier_entries(tier)}


def sc_chaos(side):
    """``cache.get:1-2;cache.put:1`` trips the breaker: the scan runs
    L1-only, and after the plan clears the same tier serves again."""
    rows = _rows(12)
    want = side.run(side.engine("corpus"), rows)
    plan = side.faults.install_plan("seed=3;cache.get:1-2;cache.put:1")
    try:
        tier = side.tier()
        client = side.client(tier, "chaos", breaker_threshold=2)
        a = side.run(side.engine("corpus", client), rows, client)
        a["fired"] = {k: c["fired"] for k, c in plan.snapshot().items()}
    finally:
        side.faults.clear_plan()
    c2 = side.client(tier, "chaos2")
    b = side.run(side.engine("corpus", c2), rows, c2)
    return {"tierless": want, "a": a, "b": b, "entries": tier_entries(tier)}


def sc_dead_store(side):
    """A dead backend opens the breaker at once (threshold 1): the scan
    is L1-only and identical, and a second scan does not touch the
    store."""

    class Dead(side.stores.MemoryStateStore):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def hget(self, name, key):
            self.calls += 1
            raise ConnectionError("down")

        def hset_many(self, name, mapping):
            self.calls += 1
            raise ConnectionError("down")

        hmget = hset = hincr = hget

    store = Dead()
    want = side.run(side.engine("corpus"), _rows(10))
    client = side.client(side.tier(store), "dead", breaker_threshold=1,
                         breaker_cooldown_s=3600.0)
    eng = side.engine("corpus", client)
    a = side.run(eng, _rows(10), client)
    a["store_calls"] = store.calls
    b = side.run(eng, _rows(8, seed=99), client)
    b["store_calls"] = store.calls
    return {"tierless": want, "a": a, "b": b}


def sc_flaky(side):
    """The backend dies mid-scan (every store operation after the 6th
    raises): identical results, the breaker no longer closed."""

    class Flaky(side.stores.MemoryStateStore):
        def __init__(self, fail_after):
            super().__init__()
            self.calls = 0
            self.fail_after = fail_after

        def _maybe_fail(self):
            self.calls += 1
            if self.calls > self.fail_after:
                raise ConnectionError("backend died mid-scan")

        def hget(self, name, key):
            self._maybe_fail()
            return super().hget(name, key)

        def hmget(self, name, keys):
            self._maybe_fail()
            return super().hmget(name, keys)

        def hset(self, name, key, value):
            self._maybe_fail()
            return super().hset(name, key, value)

        def hset_many(self, name, mapping):
            self._maybe_fail()
            return super().hset_many(name, mapping)

        def hincr(self, name, key, by=1):
            self._maybe_fail()
            return super().hincr(name, key, by)

    rows = _rows(14)
    want = side.run(side.engine("corpus"), rows)
    store = Flaky(fail_after=6)
    client = side.client(side.tier(store), "flaky", breaker_threshold=1)
    a = side.run(side.engine("corpus", client), rows, client)
    a["store_calls"] = store.calls
    return {"tierless": want, "a": a}


def sc_epoch_bump(side):
    """Writer, warm reader, then ``bump_epoch``: a third engine reads
    the new generation's empty namespace."""
    rows = _rows(8)
    tier = side.tier()
    c1, c2, c3 = (side.client(tier, w) for w in ("e1", "e2", "e3"))
    a = side.run(side.engine("corpus", c1), rows, c1)
    b = side.run(side.engine("corpus", c2), rows, c2)
    tier.bump_epoch()
    c = side.run(side.engine("corpus", c3), rows, c3)
    return {"a": a, "b": b, "c": c}


SCENARIOS = {
    "cold_warm": sc_cold_warm,
    "dead_dup": sc_dead_dup,
    "prefetch": sc_prefetch,
    "confirm": sc_confirm,
    "workflow": sc_workflow,
    "fenced": sc_fenced,
    "chaos": sc_chaos,
    "dead_store": sc_dead_store,
    "flaky": sc_flaky,
    "epoch_bump": sc_epoch_bump,
}


@pytest.fixture(scope="module")
def observed(sides):
    """scenario → {package: observation}, each run once for the module."""
    cache: dict = {}

    def get(name):
        if name not in cache:
            cache[name] = {p: SCENARIOS[name](s) for p, s in sides.items()}
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# the wire format, byte for byte


def _wire_rows():
    rows = bench_mod.realistic_rows(48, seed=3) + bench_mod.walk_stress_rows(16, seed=4)
    rows += [
        j_model.Response(body=b"B", header=b"H", status=200, host="a", port=80),
        j_model.Response(body=b"B", header=b"H", status=200, host="z", port=443),
        j_model.Response(body=b"B", header=b"H", status=404),
        j_model.Response(body=b"B", header=b"H", status=200, banner=b"B"),
        j_model.Response(body=b"B", header=b"H", status=200, banner=b""),
        j_model.Response(body=b"B", oob_protocols=("a\x1fb",)),
        j_model.Response(body=b"B", oob_protocols=("a", "b")),
        j_model.Response(body=b"", oob_requests=b"GET /x", oob_ips=("10.0.0.1", "::1")),
        j_model.Response(body=b"\xff\x00", header=b"\xe9", oob_protocols=("dns\udcff",)),
    ]
    return rows


def test_row_digest_equal():
    rows = _wire_rows()
    want = [j_tier.row_digest(r) for r in rows]
    assert [t_tier.row_digest(r) for r in to_port(rows)] == want
    assert len(set(want[-9:])) == 8  # host and port are not content


def test_confirm_digest_equal():
    keys = [(tag, m, p) for tag in ("m", "pe") for m in (0, 3, 4, 1 << 20)
            for p in (b"", b"p", b"q", b"\x00" * 300, "é".encode())]
    want = [j_tier.confirm_digest(k) for k in keys]
    assert [t_tier.confirm_digest(k) for k in keys] == want
    assert len(set(want)) == len(keys)


ENTRIES = [
    (b"\x01\x02\xff", (("tid-a", ("v1", "v\xe92")), ("tid-b", ())), (3, 17)),
    (b"", (), ()),
    (bytes(range(256)), (("x", ("",)),), (0,)),
    (b"\x00", (("lone", ("\udcff",)),), ()),  # JSON can't carry it: not shared
]


@pytest.mark.parametrize("entry", range(len(ENTRIES)))
def test_verdict_entry_equal(entry):
    bits, ment, mdef = ENTRIES[entry]
    raw = j_tier.encode_entry(bits, ment, mdef)
    assert t_tier.encode_entry(bits, ment, mdef) == raw
    if raw is not None:
        assert t_tier.decode_entry(raw) == j_tier.decode_entry(raw) == (bits, ment, mdef)
    for bad in ("not json", '{"b":"!!!","e":[],"d":[]}', '{"b":"AA==","e":[[1]],"d":[]}'):
        assert t_tier.decode_entry(bad) is None and j_tier.decode_entry(bad) is None


def test_workflow_entry_equal():
    for per in ({"wf-b": ["t2", "t1"], "wf-a": []}, {}, {"w": ["\udcff"]}, {1: [2, 3]}):
        raw = j_tier.encode_workflow_entry(per)
        assert t_tier.encode_workflow_entry(per) == raw
        if raw is not None:
            assert t_tier.decode_workflow_entry(raw) == j_tier.decode_workflow_entry(raw)
    assert t_tier.decode_workflow_entry("[") is None


def test_corpus_digest_is_the_ports_own(sides):
    """Stable over a fresh list, and not the JAX package's: each salts
    with its own compiler sources, so their epochs never meet."""
    t_corpus = sides["torch"].corpora["corpus"]
    assert t_tier.corpus_digest(list(t_corpus)) == t_tier.corpus_digest(t_corpus)
    assert t_tier.corpus_digest(t_corpus) != j_tier.corpus_digest(sides["jax"].corpora["corpus"])
    assert t_tier.corpus_digest(t_corpus + t_corpus[:1]) != t_tier.corpus_digest(t_corpus)


# ---------------------------------------------------------------------------
# the engine pairs against the JAX package's


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_pair_equals_jax(observed, scenario):
    """The same RowMatches, tier counters, writebacks, engine stats and
    stored entries from the port's pair as from the JAX package's."""
    obs = observed(scenario)
    want, got = obs["jax"], jax_view(obs["torch"])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], (scenario, key)


def test_dict_memo_pair_equals_the_ports(observed, sides):
    """A JAX pair on the dict-memo L1 (its engine without the native
    library) gives what the port's pair gives on its native memo."""
    want = sc_cold_warm(sides["jax"], dict_memo=True)
    assert jax_view(observed("cold_warm")["torch"]) == want


def test_cold_warm_serves_the_reader_from_the_tier(observed):
    obs = observed("cold_warm")["torch"]
    a, b = obs["a"], obs["b"]
    assert ids_ext(a["results"]) == ids_ext(b["results"]) == ids_ext(obs["tierless"]["results"])
    assert a["counters"]["shared_misses"] > 0 and a["counters"]["shared_hits"] == 0
    assert b["counters"]["shared_hits"] > 0 and b["counters"]["shared_misses"] == 0
    assert b["stats"]["memo_slots"] == 14 and b["stats"]["host_confirm_pairs"] == 0
    assert a["device_rows"] == obs["tierless"]["device_rows"] == 14 and b["device_rows"] == 0
    assert a["writebacks"][("verdict", "stored")] == a["counters"]["shared_misses"]
    assert len(obs["entries"]["v"]) == a["counters"]["shared_misses"]


def test_dead_rows_and_duplicates(observed):
    obs = observed("dead_dup")["torch"]
    b = obs["b"]["results"]
    assert ids_ext(b) == ids_ext(obs["tierless"]["results"])
    assert b[3] == ([], {}, 0)  # the dead row stays verdict-free
    # nine live rows, eight distinct contents: one lookup a content
    assert obs["b"]["counters"]["shared_hits"] == 8


def test_prefetch_rides_the_memo_lane(observed):
    obs = observed("prefetch")["torch"]
    assert ids_ext(obs["b"]["results"]) == ids_ext(obs["tierless"]["results"])
    assert obs["b"]["sched"] == {"memo_rows": 28, "fresh_rows": 0, "dead_rows": 0}
    assert obs["b"]["counters"]["shared_hits"] > 0


@pytest.mark.parametrize("confirm", ["on", "off"])
def test_confirm_family(observed, confirm):
    obs = observed("confirm")["torch"]
    b = obs[f"b_{confirm}"]
    assert ids_ext(b["results"]) == ids_ext(obs["tierless"]["results"])
    assert obs["a"]["stats"]["host_confirm_pairs"] > 0
    assert obs["a"]["writebacks"][("confirm", "stored")] == len(obs["entries"]["c"]) > 0
    c = b["counters"]
    assert c["verdict_hits"] == 0 and c["verdict_misses"] > 0
    if confirm == "on":
        assert c["confirm_hits"] > 0
    else:
        assert c["confirm_hits"] == c["confirm_misses"] == 0 and not b["writebacks"]


def test_workflow_family(observed):
    obs = observed("workflow")["torch"]
    a, b = obs["a"], obs["b"]
    assert a["results"][0] == {"demo-workflow": ["demo-acme-vuln"]}
    assert b["results"] == a["results"] and b["engine_calls"] == []
    assert b["counters"]["shared_hits"] == len(obs["entries"]["w"]) == 3


def test_superseded_writer_is_fenced(observed):
    obs = observed("fenced")["torch"]
    assert obs["a"]["counters"]["shared_misses"] > 0
    assert obs["a"]["writebacks"][("verdict", "fenced")] > 0
    assert ("verdict", "stored") not in obs["a"]["writebacks"]
    assert obs["b"]["counters"]["shared_hits"] == 0


@pytest.mark.parametrize("scenario", ["chaos", "dead_store", "flaky"])
def test_failing_tier_degrades_to_l1_identical(observed, scenario):
    obs = observed(scenario)["torch"]
    want = ids_ext(obs["tierless"]["results"])
    assert ids_ext(obs["a"]["results"]) == want
    if scenario == "chaos":
        assert sum(obs["a"]["fired"].values()) > 0
        assert ids_ext(obs["b"]["results"]) == want  # healed
    elif scenario == "dead_store":
        # the breaker opened: the second scan did not touch the store
        assert obs["b"]["store_calls"] == obs["a"]["store_calls"]
        assert obs["b"]["counters"]["breaker"] == "open"
    else:
        assert obs["a"]["counters"]["breaker"] != "closed"


def test_epoch_bump_invalidates(observed):
    obs = observed("epoch_bump")["torch"]
    assert obs["b"]["counters"]["shared_hits"] > 0
    c = obs["c"]["counters"]
    assert c["shared_hits"] == 0 and c["shared_misses"] > 0 and c["epoch"] == "1"
    assert ids_ext(obs["c"]["results"]) == ids_ext(obs["a"]["results"])


# ---------------------------------------------------------------------------
# the tier's own contracts, on the port


def test_state_store_hmget_hincr():
    import threading

    s = t_stores.MemoryStateStore()
    s.hset("h", "a", "1")
    assert s.hmget("h", ["a", "missing"]) == ["1", None]
    assert s.hincr("c", "n") == 1
    assert s.hincr("c", "n", 5) == 6

    def spin():
        for _ in range(200):
            s.hincr("c", "race")

    ts = [threading.Thread(target=spin) for _ in range(2)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert s.hget("c", "race") == "400"


@pytest.mark.parametrize("store", ["memory", "local"])
def test_blob_spill_roundtrip(tmp_path, store):
    blobs = (t_stores.MemoryBlobStore() if store == "memory"
             else t_stores.LocalBlobStore(tmp_path / "blobs"))
    tier = t_tier.SharedResultTier(t_stores.MemoryStateStore(), blobs, spill_bytes=16)
    tok = tier.acquire_writer("w")
    big = "x" * 200
    assert tier.put_many("v", "e1", [("d1", big), ("d2", "small")], "w", tok) == ("stored", 2)
    assert tier.get_many("v", "e1", ["d1", "d2"]) == {"d1": big, "d2": "small"}
    blobs.delete("cache/v/e1/d1")  # a vanished blob behind a live pointer: a miss
    assert tier.get_many("v", "e1", ["d1", "d2"]) == {"d2": "small"}


def test_local_state_store_shares_the_fence_across_instances(tmp_path):
    """Two ``LocalStateStore`` objects on one directory (two processes of
    one host) see one fencing counter: the second acquire supersedes."""
    t1 = t_tier.SharedResultTier(t_stores.LocalStateStore(tmp_path))
    t2 = t_tier.SharedResultTier(t_stores.LocalStateStore(tmp_path))
    tok1 = t1.acquire_writer("w")
    tok2 = t2.acquire_writer("w")
    assert tok2 > tok1
    assert t1.put_many("v", "e", [("d", "v")], "w", tok1) == ("fenced", 0)
    assert t2.put_many("v", "e", [("d", "v")], "w", tok2) == ("stored", 1)
    assert t1.get_many("v", "e", ["d"]) == {"d": "v"}


def test_fencing_rejects_stale_writer():
    tier = t_tier.SharedResultTier(t_stores.MemoryStateStore(), t_stores.MemoryBlobStore())
    t1 = tier.acquire_writer("worker-1")
    t2 = tier.acquire_writer("worker-1")
    assert t2 > t1
    assert tier.put_many("v", "e", [("d", "v")], "worker-1", t1) == ("fenced", 0)
    assert tier.get_many("v", "e", ["d"]) == {}
    assert tier.put_many("v", "e", [("d", "v")], "worker-1", t2) == ("stored", 1)
    tier.fence_writer("worker-1")
    assert tier.put_many("v", "e", [("d2", "v")], "worker-1", t2) == ("fenced", 0)


def test_fencing_mid_write_supersession_reports_fenced():
    tier = t_tier.SharedResultTier(t_stores.MemoryStateStore(), t_stores.MemoryBlobStore())
    token = tier.acquire_writer("w")
    state = tier._state
    real = state.hset_many
    fired = []

    def hset_and_supersede(name, mapping):
        real(name, mapping)
        if name.startswith("swarm:cache:v:") and not fired:
            fired.append(True)
            tier.acquire_writer("w")  # the successor arrives mid-write

    state.hset_many = hset_and_supersede
    try:
        out = tier.put_many("v", "e", [("d1", "x"), ("d2", "y")], "w", token)
    finally:
        state.hset_many = real
    assert out == ("fenced", 0)
    assert tier.get_many("v", "e", ["d1", "d2"]) == {"d1": "x", "d2": "y"}
    assert tier.put_many("v", "e", [("d3", "z")], "w", token) == ("fenced", 0)
    assert tier.get_many("v", "e", ["d3"]) == {}


def test_same_identity_clients_share_one_process_token(sides):
    side = sides["torch"]
    tier = side.tier()
    rows_a, rows_b = _rows(5, seed=31), _rows(5, seed=32)
    ca = side.client(tier, "tw")
    side.run(side.engine("corpus", ca), rows_a)
    cb = side.client(tier, "tw")
    side.run(side.engine("corpus", cb), rows_b)
    reader = side.client(tier, "reader")
    eng = side.engine("corpus", reader)
    side.run(eng, rows_a)
    side.run(eng, rows_b)
    assert reader.counters()["verdict_hits"] == len(rows_a) + len(rows_b)


def test_writeback_clears_recent_miss_suppression(sides):
    side = sides["torch"]
    client = side.client(side.tier(), "rm")
    rows = _rows(5, seed=41)
    side.run(side.engine("corpus", client), rows)
    assert client.counters()["shared_misses"] >= len(rows)
    for r in to_port(rows):
        assert t_tier.row_digest(r) not in client._recent_miss


def test_epoch_bump_reaches_live_clients(sides):
    """An operator ``bump_epoch`` reaches a running client once its
    epoch read is older than the TTL (back-dated here)."""
    side = sides["torch"]
    tier = side.tier()
    client = side.client(tier, "ttl")
    eng = side.engine("corpus", client)
    side.run(eng, _rows(4, seed=51))
    assert client.counters()["epoch"].endswith(".g0")
    tier.bump_epoch()
    with client._lock:
        client._epoch_read_at = -1e9
    side.run(eng, _rows(4, seed=52))
    assert client.counters()["epoch"].endswith(".g1")


def test_refresh_moves_the_epoch_once(sides):
    """``refresh_corpus`` on a live engine binds the client once, to the
    new corpus's epoch: the next batch finds none of the old entries and
    equals a fresh engine's on the new corpus. Refreshing back moves it
    back, where the old corpus's entries serve again."""
    side = sides["torch"]
    corpus = side.corpora["corpus"]
    added = corpus + side.corpora["stress"][len(corpus):][:1]
    rows = _rows(6)
    tier = side.tier()
    client = side.client(tier, "rf")
    eng = side.new_engine(corpus, db=side.db("corpus"))
    eng.attach_result_cache(client)
    side.run(eng, rows)
    before = client.counters()["epoch"]
    binds = []
    real = client.bind_corpus
    client.bind_corpus = lambda d: binds.append(d) or real(d)
    eng.refresh_corpus(added)
    assert binds == [t_tier.corpus_digest(added)]
    after = client.counters()["epoch"]
    assert after and after != before
    got = side.run(eng, rows, client)
    assert got["counters"]["shared_hits"] == 0 and got["counters"]["verdict_misses"] > 0
    fresh = side.run(side.new_engine(added, db=side.db("added", added)), rows)
    assert ids_ext(got["results"]) == ids_ext(fresh["results"])
    eng.refresh_corpus(corpus)
    assert client.counters()["epoch"] == before
    hits = client.counters()["verdict_hits"]
    eng.clear_content_memos()
    side.run(eng, rows)
    assert client.counters()["verdict_hits"] == hits + len(rows)


def _eviction_counts():
    return {r: t_memo.MEMO_EVICTIONS.labels(reason=r).value for r in ("ttl", "size")}


def test_policy_off_by_default_writes_no_stamps():
    state = t_stores.MemoryStateStore()
    tier = t_tier.SharedResultTier(state, t_stores.MemoryBlobStore())
    tok = tier.acquire_writer("w")
    assert tier.put_many("v", "e.g0", [("d1", "x")], "w", tok) == ("stored", 1)
    assert state.hgetall("swarm:cache:ts:v:e.g0") == {}
    assert tier.get_many("v", "e.g0", ["d1"]) == {"d1": "x"}
    assert tier.entry_count("v", "e.g0") == 0


def test_ttl_expires_lazily_and_counts_eviction():
    import time

    state = t_stores.MemoryStateStore()
    tier = t_tier.SharedResultTier(state, t_stores.MemoryBlobStore(), ttl_s=30.0)
    tok = tier.acquire_writer("w")
    tier.put_many("v", "e.g0", [("d1", "x"), ("d2", "y")], "w", tok)
    assert tier.get_many("v", "e.g0", ["d1", "d2"]) == {"d1": "x", "d2": "y"}
    before = _eviction_counts()
    state.hset("swarm:cache:ts:v:e.g0", "d1", str(time.time() - 120.0))
    assert tier.get_many("v", "e.g0", ["d1", "d2"]) == {"d2": "y"}
    assert state.hget("swarm:cache:v:e.g0", "d1") is None
    assert state.hget("swarm:cache:ts:v:e.g0", "d1") is None
    assert _eviction_counts()["ttl"] == before["ttl"] + 1


def test_max_entries_bound_evicts_oldest_per_family():
    import time

    state = t_stores.MemoryStateStore()
    tier = t_tier.SharedResultTier(state, t_stores.MemoryBlobStore(), max_entries=3)
    tok = tier.acquire_writer("w")
    before = _eviction_counts()
    tier.put_many("v", "e.g0", [("a", "1"), ("b", "2"), ("c", "3")], "w", tok)
    old = str(time.time() - 60.0)
    state.hset("swarm:cache:ts:v:e.g0", "a", old)
    state.hset("swarm:cache:ts:v:e.g0", "b", old)
    tier.put_many("v", "e.g0", [("d", "4"), ("e", "5")], "w", tok)
    assert tier.get_many("v", "e.g0", list("abcde")) == {"c": "3", "d": "4", "e": "5"}
    assert tier.entry_count("v", "e.g0") == 3
    assert _eviction_counts()["size"] == before["size"] + 2
    tier.put_many("c", "e.g0", [("x", "1")], "w", tok)
    assert tier.get_many("c", "e.g0", ["x"]) == {"x": "1"}


@pytest.mark.parametrize("point", ["cache.get", "cache.put"])
def test_breaker_under_a_fault_plan(point):
    """Every ``point`` operation fails: the breaker opens at its
    threshold, a lookup is then a miss and a writeback a drop, and the
    store is not asked again while it is open."""
    tier = t_tier.SharedResultTier(t_stores.MemoryStateStore(), t_stores.MemoryBlobStore())
    client = t_tier.ResultCacheClient(tier, worker_id="br", breaker_threshold=2,
                                      breaker_cooldown_s=3600.0)
    rows = to_port(_rows(4, seed=61))
    client.bind_corpus("ab" * 32)
    calls = []
    real = tier.get_many if point == "cache.get" else tier.put_many
    spy = lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]  # noqa: E731
    setattr(tier, "get_many" if point == "cache.get" else "put_many", spy)
    before = t_memo.MEMO_WRITEBACKS.labels(family="verdict", outcome="error").value
    t_faults.install_plan(f"seed=1;{point}:*")
    try:
        for _ in range(4):
            if point == "cache.get":
                assert client.lookup_rows(rows) == {}
            else:
                assert client.writeback_rows([(r, b"\x01", None) for r in rows]) == 0
    finally:
        t_faults.clear_plan()
    assert client.counters()["breaker"] == "open"
    assert calls == []  # the fault fired before the store each time, then the breaker
    if point == "cache.put":
        after = t_memo.MEMO_WRITEBACKS.labels(family="verdict", outcome="error").value
        assert after - before == 4 * len(rows)


def test_policy_via_config_and_parity_under_ttl(sides):
    """``build_result_cache`` reads the worker's ``cache_*`` fields onto
    the process's memory tier, and a bounded tier (8 entries a family,
    24 rows) stays identical: an eviction is a miss, a walk, a
    writeback."""
    from swarm_tpu_torch.cache import build_result_cache
    from swarm_tpu_torch.cache.tier import _memory_tier
    from swarm_tpu_torch.worker.runtime import WorkerConfig

    side = sides["torch"]
    cfg = WorkerConfig(cache_backend="memory", cache_ttl_s=900.0, cache_max_entries=8)
    client = build_result_cache(cfg)
    tier = _memory_tier()
    assert client is not None and tier._ttl_s == 900.0 and tier._max_entries == 8
    try:
        rows = _rows(24, seed=33)
        want = side.run(side.engine("corpus"), rows)
        got = side.run(side.engine("corpus", client, batch_rows=8), rows)
        assert ids_ext(got["results"]) == ids_ext(want["results"])
    finally:
        tier.configure_policy(0.0, 0)
    assert build_result_cache(WorkerConfig()) is None
    with pytest.raises(ValueError, match="unknown cache_backend"):
        build_result_cache(WorkerConfig(cache_backend="etcd"))


# ---------------------------------------------------------------------------
# the worker


def test_worker_engines_share_the_memory_tier(tmp_path, monkeypatch):
    """Two port workers (one process: the memory tier is the process's)
    read ``SWARM_CACHE_BACKEND=memory`` and attach the tier to the
    engine ``engine_for`` builds. The second engine serves the content
    the first resolved from the tier: fewer device rows, the same
    RowMatches."""
    from swarm_tpu_torch.cache.tier import _memory_tier
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "db"))
    env = {"SWARM_CACHE_BACKEND": "memory", "SWARM_PIPELINE": "off"}
    rows = _rows(12, seed=71)
    engines, out = [], []
    for worker in ("w0", "w1"):
        cfg = WorkerConfig.load(env={**env, "SWARM_WORKER_ID": worker}, read_files=False)
        assert cfg.cache_backend == "memory" and cfg.worker_id == worker
        eng = JobProcessor(cfg, device="cpu").engine_for(DATA)
        assert eng._result_cache is not None
        assert eng._result_cache._tier is _memory_tier()
        eng.configure_walk(1)
        engines.append(eng)
        unique = eng.stats.unique_rows
        out.append((view(eng.match(to_port(rows))), eng.stats.unique_rows - unique,
                    eng._result_cache.counters()))
    (a, a_rows, a_c), (b, b_rows, b_c) = out
    assert ids_ext(a) == ids_ext(b)
    assert a_rows == 12 and b_rows == 0
    assert b_c["verdict_hits"] == 12 and b_c["verdict_misses"] == 0
    tierless = engines[0]
    tierless.attach_result_cache(None)
    tierless.clear_content_memos()
    assert ids_ext(view(tierless.match(to_port(rows)))) == ids_ext(a)
    assert JobProcessor(WorkerConfig(), device="cpu").engine_for(DATA) is not None


def test_worker_runs_l1_only_when_the_tier_cannot_be_built(tmp_path, monkeypatch, capsys):
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(tmp_path / "db"))
    eng = JobProcessor(WorkerConfig(cache_backend="etcd"), device="cpu").engine_for(DATA)
    assert eng._result_cache is None
    assert "result cache unavailable (unknown cache_backend 'etcd'); running L1-only" in (
        capsys.readouterr().out)
