"""The port's monitor lane (``swarm_tpu_torch/monitor``) against the JAX
package's (``swarm_tpu/monitor``), on the CPU.

- the modules are copies: every function and class of the reference's
  ``spec``, ``diff``, ``feed``, ``notify`` and ``service`` is in the port
  with the same source, the package name aside;
- the non-server cases of ``tests/test_monitor.py`` run on each package
  and see the same values; ``diff_epoch``, ``extract_verdicts`` and the
  specs' validation and wires over seeded inputs are equal;
- ``MonitorPlaneStore``'s ``m`` entries: the same operations on each
  package's own tier leave byte-equal stores, and on one shared store
  each package reads what the other wrote;
- the feed's blobs, marks, ``seq_base`` and ``stream_feed`` (a scripted
  writer, a resume cursor, the idle timeout under a fake clock, a
  removed monitor) give the same bytes;
- the port's ``MonitorService`` and the JAX one, each on a
  ``JobQueueService`` over memory stores (the service takes its queue
  as an argument): both on a JAX queue, and each on its own package's
  queue. Driven with ``run_thread=False`` and a fake clock through the
  same script of ticks, drains, a shed, a late chunk, a corpus delta, a
  refire and a restart, the spec wires after every step, the feed's
  bytes, the plane entries, the events and the ``swarm_monitor_*``
  deltas are equal;
- a CPU ``refresh_corpus`` of the port's engine notifies a listener
  once, with the port's ``corpus_digest`` (which by design differs
  from the JAX package's for the same templates).

Everything compared is bytes, strings or numbers: tolerance 0.
"""

import hashlib
import inspect
import json
import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swarm_tpu.cache.tier as j_tier
import swarm_tpu.gateway.qoscache as j_qoscache
import swarm_tpu.monitor as j_monitor
import swarm_tpu.monitor.diff as j_diff
import swarm_tpu.monitor.feed as j_feed
import swarm_tpu.monitor.notify as j_notify
import swarm_tpu.monitor.service as j_service
import swarm_tpu.monitor.spec as j_spec
import swarm_tpu.server.queue as j_queue
import swarm_tpu.stores as j_stores
import swarm_tpu.telemetry.events as j_events
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.cache.tier as t_tier
import swarm_tpu_torch.config as t_config
import swarm_tpu_torch.datamodel as t_dm
import swarm_tpu_torch.gateway.qoscache as t_qoscache
import swarm_tpu_torch.monitor as t_monitor
import swarm_tpu_torch.monitor.diff as t_diff
import swarm_tpu_torch.monitor.feed as t_feed
import swarm_tpu_torch.monitor.notify as t_notify
import swarm_tpu_torch.monitor.service as t_service
import swarm_tpu_torch.monitor.spec as t_spec
import swarm_tpu_torch.server.queue as t_queue
import swarm_tpu_torch.stores as t_stores
import swarm_tpu_torch.telemetry.events as t_events
import swarm_tpu_torch.telemetry.metrics as t_metrics
import swarm_tpu.datamodel as j_dm
from swarm_tpu.config import Config

PKG = {
    "jax": SimpleNamespace(diff=j_diff, feed=j_feed, notify=j_notify, service=j_service,
                           spec=j_spec, tier=j_tier, qoscache=j_qoscache, stores=j_stores,
                           events=j_events, metrics=j_metrics),
    "torch": SimpleNamespace(diff=t_diff, feed=t_feed, notify=t_notify, service=t_service,
                             spec=t_spec, tier=t_tier, qoscache=t_qoscache, stores=t_stores,
                             events=t_events, metrics=t_metrics),
}
SIDES = ("jax", "torch")
DATA = Path(__file__).resolve().parent / "data" / "templates"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines that walk inline
    (``SWARM_WALK_THREADS=1``): six test processes share the host, and
    no result depends on either."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


# ---------------------------------------------------------------------------
# the copies

COPIES = [(j_monitor, t_monitor), (j_spec, t_spec), (j_diff, t_diff), (j_feed, t_feed),
          (j_notify, t_notify), (j_service, t_service)]


def _own_members(module):
    return {name: obj for name, obj in vars(module).items()
            if (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


@pytest.mark.parametrize("orig,port", COPIES, ids=[c[0].__name__ for c in COPIES])
def test_copies_match_their_originals(orig, port):
    mine, theirs = _own_members(port), _own_members(orig)
    assert set(theirs) == set(mine)
    for name, obj in theirs.items():
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert inspect.getsource(mine[name]) == want, f"{port.__name__}.{name} differs"
    for name, value in vars(orig).items():
        if name.isupper() and isinstance(value, (str, int, float)):
            assert getattr(port, name) == value, name
    assert getattr(port, "__all__", None) == getattr(orig, "__all__", None)


# ---------------------------------------------------------------------------
# the non-server cases of tests/test_monitor.py, on each package


def split_contract(p):
    split = p.qoscache.split_output_segments
    out = [split(b"anything at all", 1), split(b"a\nb\n", 2), split(b"a\nb", 2),
           split(b"a\nb\nc\n", 2), split(b"", 2), split(b"x\n", 0)]
    assert out == [[b"anything at all"], [b"a\n", b"b\n"], [b"a\n", b"b"], None, None, None]
    return out


def diff_lifecycle(p):
    diff_epoch = p.diff.diff_epoch
    order = ["t1", "t2"]
    recs1, plane1 = diff_epoch("m", 1, {}, {"t1": "f1", "t2": ""}, order, 0)
    assert [(r["kind"], r["target"], r["seq"]) for r in recs1] == [("new", "t1", 0)]
    assert plane1 == {"t1": {"v": "f1", "fs": 1}}
    recs2, plane2 = diff_epoch("m", 2, plane1, {"t1": "f2", "t2": "x"}, order, 1)
    assert [(r["kind"], r["target"], r["seq"]) for r in recs2] == [
        ("changed", "t1", 1), ("new", "t2", 2)]
    assert recs2[0]["prev"] == "f1" and recs2[0]["first_seen"] == 1
    assert plane2["t2"] == {"v": "x", "fs": 2}
    recs3, plane3 = diff_epoch("m", 3, plane2, {"t1": "", "t2": "x"}, order, 3)
    assert [(r["kind"], r["target"]) for r in recs3] == [("resolved", "t1")]
    assert "t1" not in plane3
    recs4, plane4 = diff_epoch("m", 4, plane3, {"t1": "f3"}, order, 4)
    assert [(r["kind"], r["target"]) for r in recs4] == [("new", "t1")]
    assert recs4[0]["first_seen"] == 4
    assert plane4["t2"] == {"v": "x", "fs": 2}
    return [recs1, plane1, recs2, plane2, recs3, plane3, recs4, plane4]


def diff_departed(p):
    prev = {"zed": {"v": "a", "fs": 1}, "abc": {"v": "b", "fs": 1}, "kept": {"v": "c", "fs": 1}}
    recs, plane = p.diff.diff_epoch("m", 2, prev, {"kept": "c2"}, ["kept"], 7)
    assert [(r["kind"], r["target"], r["seq"]) for r in recs] == [
        ("changed", "kept", 7), ("resolved", "abc", 8), ("resolved", "zed", 9)]
    assert set(plane) == {"kept"}
    recs2, _ = p.diff.diff_epoch("m", 2, prev, {"kept": "c2"}, ["kept"], 7)
    enc = b"".join(p.diff.encode_record(r) for r in recs)
    assert enc == b"".join(p.diff.encode_record(r) for r in recs2)
    return [recs, plane, enc]


def plane_fold(p):
    plane: dict = {}
    records = []
    epochs = [{"a": "1", "b": ""}, {"a": "2", "b": "x"}, {"a": "", "b": "x"}, {"a": "3"}]
    for i, verdicts in enumerate(epochs, start=1):
        recs, plane = p.diff.diff_epoch("m", i, plane, verdicts, ["a", "b"], len(records))
        records.extend(recs)
    assert p.diff.plane_from_records(records) == plane
    return [records, plane]


def extract_both(p):
    chunks = [["a", "b"], ["c"], ["d"]]
    v = p.diff.extract_verdicts(chunks, {0: b"va\nvb\n", 1: b"multi\nline\nout\n"})
    assert v == {"a": "va", "b": "vb", "c": "multi\nline\nout"} and "d" not in v
    return v


def spec_basics(p):
    from swarm_tpu_torch.datamodel import SCAN_ID_RE, parse_scan_id

    MonitorSpec = p.spec.MonitorSpec
    spec = MonitorSpec("m-1", "echo", ["a\n"], 30.0)
    assert spec.validate() is None
    problems = [MonitorSpec("has.dots", "echo", ["a"], 30.0).validate(),
                MonitorSpec("m", "echo", [], 30.0).validate(),
                MonitorSpec("m", "echo", ["a"], 0.0).validate(),
                MonitorSpec("m", "", ["a"], 30.0).validate()]
    assert all(problems)
    sid = spec.scan_id_for(3, now=1234.0)
    assert SCAN_ID_RE.match(sid) and parse_scan_id(sid) == ("m-1.e3", 1234)
    spec.next_fire_at = 100.0
    dues = [spec.due(99.0), spec.due(100.0)]
    assert dues == [False, True]
    spec.paused = True
    assert not spec.due(1e9)
    spec.paused = False
    spec.epoch, spec.last_scan_id, spec.refire = 4, sid, True
    assert MonitorSpec.from_wire(spec.to_wire()) == spec
    return [problems, sid, dues, spec.to_wire()]


def notify_semantics(p):
    class Rec:
        def __init__(self):
            self.seen = []

        def on_corpus_delta(self, digest):
            self.seen.append(digest)

    class Boom:
        def on_corpus_delta(self, digest):
            raise RuntimeError("bad listener")

    good, bad = Rec(), Boom()
    p.notify.register(good)
    p.notify.register(good)  # idempotent: one delivery per delta
    p.notify.register(bad)
    try:
        n = p.notify.notify_corpus_delta("d1")
        assert good.seen == ["d1"]
    finally:
        p.notify.unregister(good)
        p.notify.unregister(bad)
    p.notify.notify_corpus_delta("d2")
    assert good.seen == ["d1"]
    # a listener that is gone is dropped, never notified
    gone = Rec()
    p.notify.register(gone)
    del gone
    return [n, good.seen, p.notify.notify_corpus_delta("d3")]


REFERENCE_CASES = [split_contract, diff_lifecycle, diff_departed, plane_fold, extract_both,
                   spec_basics, notify_semantics]


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=[c.__name__ for c in REFERENCE_CASES])
def test_reference_case_equals_jax(case, capsys):
    got = {side: case(PKG[side]) for side in SIDES}
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# seeded diffs, verdicts and specs


def _targets(rng, n: int) -> list:
    return [f"10.{int(rng.integers(3))}.0.{i}:{(80, 443)[i % 2]}" for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_diff_epoch_equals_jax(seed):
    """Random prior planes, verdicts (absent, empty, equal, changed),
    target orders with repeats and departures: the same records, the
    same bytes, the same next plane; folding the records of a run of
    epochs gives the last plane in both."""
    rng = np.random.default_rng(seed)
    pool = _targets(rng, 40)
    plane_t: dict = {}
    plane_j: dict = {}
    feed = []
    for epoch in range(1, 7):
        order = [pool[int(i)] for i in rng.integers(0, len(pool), int(rng.integers(1, 50)))]
        verdicts = {}
        for t in pool:
            r = rng.random()
            if r < 0.2:
                continue
            if r < 0.35:
                verdicts[t] = ""
            elif r < 0.7 and t in plane_t:
                verdicts[t] = plane_t[t]["v"]
            else:
                verdicts[t] = f"v{int(rng.integers(3))}:{t}"
        base = len(feed)
        got = t_diff.diff_epoch("mon", epoch, plane_t, verdicts, order, base)
        want = j_diff.diff_epoch("mon", epoch, plane_j, verdicts, order, base)
        assert got == want
        assert [t_diff.encode_record(r) for r in got[0]] == [
            j_diff.encode_record(r) for r in want[0]]
        (records, plane_t), plane_j = got, want[1]
        feed.extend(records)
    assert t_diff.plane_from_records(feed) == j_diff.plane_from_records(feed) == plane_t


def _outputs(rng, chunks: list) -> dict:
    outs = {}
    for i, chunk in enumerate(chunks):
        r = rng.random()
        if r < 0.15:
            continue  # a failed chunk: no output
        lines = [f"v{int(rng.integers(4))}:{t}" for t in chunk]
        if r < 0.3:
            raw = "\n".join(lines)  # no trailing newline
        elif r < 0.45:
            raw = "coarse\nverdict\n" * (len(chunk) + 1)  # not one line a target
        elif r < 0.5:
            raw = ""
        else:
            raw = "".join(x + "\n" for x in lines)
        data = raw.encode()
        if rng.random() < 0.2:
            data += b"\xff\xfe"  # bytes that are not utf-8
        outs[i] = data
    return outs


@pytest.mark.parametrize("seed", range(6))
def test_extract_verdicts_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    pool = _targets(rng, 30)
    targets = [pool[int(i)] for i in rng.integers(0, len(pool), 60)]
    for batch in (1, 3, 7, 60):
        chunks = [targets[i:i + batch] for i in range(0, len(targets), batch)]
        outs = _outputs(rng, chunks)
        assert t_diff.extract_verdicts(chunks, outs) == j_diff.extract_verdicts(chunks, outs)
    assert t_diff.target_digest("fingerprint", pool[0]) == j_diff.target_digest(
        "fingerprint", pool[0])
    assert t_diff._index_digest("m-1") == j_diff._index_digest("m-1")


WIRES = [
    {}, {"monitor_id": "m"}, {"monitor_id": "m", "module": "echo", "targets": ["a"],
                             "interval_s": 1, "extra": 3},
    {"monitor_id": "bad.id", "module": "echo", "targets": ["a"], "interval_s": 5.0},
    {"monitor_id": "m", "module": "echo", "targets": [1], "interval_s": 5.0},
    {"monitor_id": "m", "module": "a/b", "targets": ["a"], "interval_s": 5.0},
    {"monitor_id": "m", "module": "echo", "targets": ["a"], "interval_s": 0.01},
    {"monitor_id": "m", "module": "echo", "targets": ["a"], "interval_s": 5.0,
     "batch_size": -1},
    {"monitor_id": "m" * 65, "module": "echo", "targets": ["a"], "interval_s": 5.0},
    {"monitor_id": "m_2", "module": "echo", "targets": ["a\n", "b"], "interval_s": "7",
     "tenant": None, "qos": "", "batch_size": None, "paused": 1, "created_at": None,
     "epoch": "3", "next_fire_at": 0, "last_scan_id": "", "refire": 0},
    {"monitor_id": "m-3", "module": "fingerprint", "targets": ["x"], "interval_s": 60.0,
     "tenant": "acme", "qos": "interactive", "batch_size": 4, "paused": False,
     "created_at": 12.5, "epoch": 9, "next_fire_at": 99.0, "last_scan_id": "m-3.e9_12",
     "refire": True},
]


@pytest.mark.parametrize("wire", WIRES, ids=range(len(WIRES)))
def test_spec_wire_validate_and_due_equal_jax(wire):
    specs = [p.spec.MonitorSpec.from_wire(dict(wire)) for p in (PKG["torch"], PKG["jax"])]
    assert specs[0].to_wire() == specs[1].to_wire()
    assert json.dumps(specs[0].to_wire()) == json.dumps(specs[1].to_wire())
    assert specs[0].validate() == specs[1].validate()
    for now in (0.0, 98.9, 99.0, 1e12):
        assert specs[0].due(now) == specs[1].due(now)
    for epoch, now in ((1, 0.0), (12, 1700000000.9)):
        assert specs[0].scan_id_for(epoch, now) == specs[1].scan_id_for(epoch, now)


# ---------------------------------------------------------------------------
# MonitorPlaneStore: the tier's m family


def plane_run(p, tier, writer: str) -> list:
    """Stores and loads across monitors and epochs, a zero-change epoch,
    an emptied plane, an epoch bump, an evicted entry and a corrupt
    index, on one package's store."""
    store = p.diff.MonitorPlaneStore(tier, writer_id=writer)
    a = {"10.0.0.1:80": {"v": "x", "fs": 1}, "10.0.0.2:443": {"v": "y\nz", "fs": 1}}
    out = [store.load("m1", "fingerprint"),
           store.store("m1", "fingerprint", a, list(a), 1),
           store.load("m1", "fingerprint"),
           store.store("m1", "fingerprint", a, [], 2),  # zero-change epoch
           store.load("m1", "fingerprint")]
    b = dict(a)
    b.pop("10.0.0.1:80")
    b["10.0.0.3:80"] = {"v": "w", "fs": 3}
    out += [store.store("m1", "fingerprint", b, ["10.0.0.1:80", "10.0.0.3:80"], 3),
            store.load("m1", "fingerprint"),
            store.store("m2", "nuclei", {}, [], 1), store.load("m2", "nuclei")]
    ns = f"mon.g{tier.epoch_generation()}.m1"
    out.append(tier.get_many("m", ns, [p.diff._index_digest("m1")]))
    tier.bump_epoch()
    out += [store.load("m1", "fingerprint"),
            store.store("m1", "fingerprint", b, list(b), 4),
            store.load("m1", "fingerprint")]
    # an evicted entry: the plane is no longer whole
    gen = tier.epoch_generation()
    tier._state.hdel(f"{tier._prefix}:m:mon.g{gen}.m1",
                     p.diff.target_digest("fingerprint", "10.0.0.3:80"))
    out.append(store.load("m1", "fingerprint"))
    tier._state.hset(f"{tier._prefix}:m:mon.g{gen}.m2", p.diff._index_digest("m2"), "{bad")
    out.append(store.load("m2", "nuclei"))
    out.append(p.diff.MonitorPlaneStore(None).load("m1", "fingerprint"))
    return out


class DeadState:
    def __getattr__(self, name):
        def dead(*a, **kw):
            raise ConnectionError("store down")

        return dead


def test_plane_entries_byte_equal_to_jax(monkeypatch):
    got, states = {}, {}
    for side in SIDES:
        p = PKG[side]
        monkeypatch.setattr(p.diff.MonitorPlaneStore, "_EPOCH_TTL_S", 0.0)
        tier = p.tier.SharedResultTier(t_stores.MemoryStateStore(), t_stores.MemoryBlobStore())
        got[side] = plane_run(p, tier, "w")
        dead = p.diff.MonitorPlaneStore(p.tier.SharedResultTier(DeadState(), None))
        got[side] += [dead.load("m1", "x"), dead.store("m1", "x", {}, [], 1)]
        states[side] = {k: dict(v) for k, v in tier._state._hashes.items()}
    assert got["torch"] == got["jax"]
    assert states["torch"] == states["jax"]
    assert any(":m:mon.g" in k for k in states["torch"])


@pytest.mark.parametrize("writer", SIDES)
def test_plane_stores_read_each_others_entries(writer, monkeypatch):
    """On one store, the plane one package's store writes the other's
    loads back whole, and after the reader's own write the writer loads
    the reader's plane."""
    reader = "torch" if writer == "jax" else "jax"
    for side in SIDES:
        monkeypatch.setattr(PKG[side].diff.MonitorPlaneStore, "_EPOCH_TTL_S", 0.0)
    state, blobs = t_stores.MemoryStateStore(), t_stores.MemoryBlobStore()
    tiers = {side: PKG[side].tier.SharedResultTier(state, blobs) for side in SIDES}
    w = PKG[writer].diff.MonitorPlaneStore(tiers[writer], writer_id="a")
    r = PKG[reader].diff.MonitorPlaneStore(tiers[reader], writer_id="b")
    plane = {f"t{i}": {"v": f"v{i}", "fs": i % 3 + 1} for i in range(12)}
    assert w.store("mx", "fingerprint", plane, list(plane), 5)
    assert r.load("mx", "fingerprint") == (plane, 5)
    plane2 = {k: v for k, v in plane.items() if k != "t3"}
    plane2["t20"] = {"v": "new", "fs": 6}
    assert r.store("mx", "fingerprint", plane2, ["t3", "t20"], 6)
    assert w.load("mx", "fingerprint") == (plane2, 6)


# ---------------------------------------------------------------------------
# the feed


def _records(seed: int, epochs: int) -> list:
    rng = np.random.default_rng(seed)
    plane: dict = {}
    out = []
    pool = _targets(rng, 20)
    for epoch in range(1, epochs + 1):
        verdicts = {t: ("" if rng.random() < 0.3 else f"v{int(rng.integers(3))}")
                    for t in pool if rng.random() < 0.8}
        recs, plane = j_diff.diff_epoch("fm", epoch, plane, verdicts, pool,
                                        sum(len(r) for r in out))
        out.append(recs)
    return out


def feed_run(p, blobs) -> list:
    by_epoch = _records(7, 5)
    out = []
    for epoch, recs in enumerate(by_epoch, start=1):
        out.append(p.feed.seq_base(blobs, "fm", epoch))
        p.feed.write_records(blobs, "fm", recs)
        if epoch != 4:  # epoch 4 is interrupted: records, no mark
            p.feed.write_mark(blobs, "fm", epoch, len(recs), f"fm.e{epoch}_{epoch}")
        out.append(p.feed.epoch_marked(blobs, "fm", epoch))
    # a re-run of an earlier epoch keeps its base
    out += [p.feed.seq_base(blobs, "fm", 2), p.feed.marked_epochs(blobs, "fm"),
            p.feed.feed_records(blobs, "fm"), p.feed.feed_records(blobs, "fm", marked_only=True),
            p.feed.record_key("fm", 3, 12), p.feed.mark_key("fm", 3), p.feed.feed_prefix("fm")]
    blobs.put("_monitor/fm/mark/junk.json", b"{}")
    blobs.put(p.feed.feed_prefix("fm") + "zz.json", b"not json")
    out += [p.feed.marked_epochs(blobs, "fm"), len(p.feed.feed_records(blobs, "fm"))]
    return out


def test_feed_blobs_equal_jax():
    got, contents = {}, {}
    for side in SIDES:
        p = PKG[side]
        blobs = p.stores.MemoryBlobStore()
        got[side] = feed_run(p, blobs)
        contents[side] = {k: blobs.get(k) for k in blobs.list("")}
    assert got["torch"] == got["jax"]
    assert contents["torch"] == contents["jax"]


class ScriptedClock:
    """A fake clock whose ``sleep`` advances it and, at set times, lets
    the writer land the next epoch's records."""

    def __init__(self, p, blobs, pending: list):
        self.now, self.p, self.blobs, self.pending = 0.0, p, blobs, list(pending)
        self.sleeps = 0

    def clock(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.sleeps += 1
        self.now += s
        if self.pending and self.sleeps % 3 == 0:
            self.p.feed.write_records(self.blobs, "fm", self.pending.pop(0))


@pytest.mark.parametrize("from_seq,alive", [(0, None), (5, None), (0, "dies"), (10**6, None),
                                            (-3, None)])
def test_stream_feed_equals_jax(from_seq, alive):
    by_epoch = _records(11, 6)
    got = {}
    for side in SIDES:
        p = PKG[side]
        blobs = p.stores.MemoryBlobStore()
        for recs in by_epoch[:2]:
            p.feed.write_records(blobs, "fm", recs)
        clk = ScriptedClock(p, blobs, by_epoch[2:])
        live = None
        if alive == "dies":
            live = lambda: clk.now < 0.35  # noqa: E731
        got[side] = list(p.feed.stream_feed(blobs, "fm", from_seq=from_seq, poll_s=0.1,
                                            idle_timeout_s=1.0, clock=clk.clock,
                                            sleep=clk.sleep, alive=live))
    assert got["torch"] == got["jax"]
    assert json.loads(got["torch"][-1])["event"] in ("timeout", "end")


# ---------------------------------------------------------------------------
# MonitorService against a queue service: a JAX one for both packages,
# or each package's own


class FakeTime:
    """The queue module's ``time`` with ``time()`` read off the fake
    clock."""

    def __init__(self, clock):
        self._clock = clock

    def time(self) -> float:
        return self._clock()

    def __getattr__(self, name):
        return getattr(time, name)


def verdict_line(target: str, epoch: int) -> str:
    """The scripted worker's verdict: a third of the targets find
    nothing, some lose their finding every third epoch, a fifth change
    with the epoch, the rest are steady."""
    h = int(hashlib.sha256(target.encode()).hexdigest(), 16)
    if h % 3 == 0 or (h % 7 == 1 and epoch % 3 == 0):
        return ""
    if h % 5 == 0:
        return f"v{epoch // 2}:{target}"
    return f"steady:{target}"


#: the queue package a service runs over: ``jax`` (both services on a
#: JAX queue) or ``own`` (each on its own package's queue)
QUEUES = {"jax": {"jax": (j_queue, Config, j_stores, j_dm),
                  "torch": (j_queue, Config, j_stores, j_dm)},
          "own": {"jax": (j_queue, Config, j_stores, j_dm),
                  "torch": (t_queue, t_config.Config, t_stores, t_dm)}}


class Harness:
    """One package's MonitorService on its own ``JobQueueService``
    (memory stores) of the ``queues`` package, a fake clock, and a
    ``submit`` that fires the epoch through the queue and writes the
    scripted chunk outputs."""

    def __init__(self, side: str, monkeypatch, queues: str = "jax"):
        self.p = PKG[side]
        self.now = 1_700_000_000.0
        queue, config, stores, self.dm = QUEUES[queues][side]
        monkeypatch.setattr(queue, "time", FakeTime(lambda: self.now))
        self.queue = queue.JobQueueService(
            config(lease_seconds=5.0), stores.MemoryStateStore(), stores.MemoryBlobStore(),
            stores.MemoryDocStore())
        self.tier = self.p.tier.SharedResultTier(t_stores.MemoryStateStore(),
                                                 t_stores.MemoryBlobStore())
        self.calls: list = []
        self.shed: set = set()  # (monitor_id, epoch) submissions to shed once
        self.late: set = set()  # (monitor_id, epoch): the last chunk's output withheld
        self.withheld: list = []
        self.events: list = []
        self._unsub = self.p.events.subscribe(self._event)
        self.service = self.start()

    def _event(self, rec: dict) -> None:
        if rec["event"].startswith("monitor."):
            self.events.append({k: v for k, v in rec.items() if k != "ts"})

    def start(self):
        svc = self.p.service.MonitorService(self.queue, SimpleNamespace(monitor_tick_s=3600.0),
                                            submit=self.submit, tier=self.tier,
                                            clock=lambda: self.now)
        svc.start(run_thread=False)
        return svc

    def restart(self) -> None:
        self.service.stop()
        self.service = self.start()

    def close(self) -> None:
        self.service.stop()
        self._unsub()

    def submit(self, spec, scan_id: str, epoch: int):
        self.calls.append((spec.monitor_id, scan_id, epoch))
        if (spec.monitor_id, epoch) in self.shed:
            self.shed.discard((spec.monitor_id, epoch))
            return None
        result = self.queue.fire_monitor_epoch(spec.to_wire(), scan_id, epoch)
        chunk_input_key, chunk_output_key = self.dm.chunk_input_key, self.dm.chunk_output_key

        coarse = spec.module == "coarse"
        for i in range(result["chunks"]):
            lines = self.queue.blobs.get(chunk_input_key(scan_id, i)).decode().split("\n")
            if coarse:
                out = f"chunk {i} of {len(lines)} at e{epoch}\nsecond line\n"
            else:
                out = "".join(verdict_line(t, epoch) + "\n" for t in lines)
            key = chunk_output_key(scan_id, i)
            if (spec.monitor_id, epoch) in self.late and i == result["chunks"] - 1:
                self.withheld.append((key, out.encode()))
            else:
                self.queue.blobs.put(key, out.encode())
        return result

    def release(self) -> None:
        for key, data in self.withheld:
            self.queue.blobs.put(key, data)
        self.withheld.clear()

    def specs(self) -> list:
        return self.queue.list_monitors()

    def feed(self) -> dict:
        return {k: self.queue.blobs.get(k) for k in self.queue.blobs.list("_monitor/")}

    def monitor_samples(self) -> dict:
        m = self.p.metrics
        return {(n, tuple(sorted(lab.items()))): v
                for n, lab, v in m.parse_exposition(m.REGISTRY.render())
                if n.startswith("swarm_monitor_") and n != "swarm_monitor_standing_specs"}


def _targets_of(n: int, salt: str) -> list:
    return [f"{salt}-{i}.example:{(80, 443)[i % 2]}\n" for i in range(n)]


def drive(h: Harness) -> list:
    """The script both services run; each step's observation is the
    step's return value and every spec wire after it."""
    log = []

    def step(name, value):
        log.append((name, value, h.specs()))

    MonitorSpec = h.p.spec.MonitorSpec
    specs = [MonitorSpec("web", "fingerprint", _targets_of(23, "web"), 60.0, tenant="acme",
                         batch_size=5, created_at=h.now),
             MonitorSpec("db", "fingerprint", _targets_of(9, "db"), 120.0, tenant="zeta",
                         batch_size=0, created_at=h.now),
             MonitorSpec("api", "coarse", _targets_of(6, "api"), 60.0, tenant="acme",
                         batch_size=4, created_at=h.now),
             MonitorSpec("idle", "fingerprint", _targets_of(3, "idle"), 60.0, tenant="zeta",
                         paused=True, created_at=h.now)]
    for s in specs:
        h.queue.put_monitor(s.to_wire())
    h.shed.add(("db", 1))
    h.late.add(("web", 2))
    step("tick", h.service.tick())  # db shed: stays due
    step("drain", h.service.drain())
    step("tick", h.service.tick())  # db fires now
    step("drain", h.service.drain())
    for k in range(4):
        h.now += 61.0
        step("tick", h.service.tick())
        step("drain", h.service.drain())  # web e2 waits for its late chunk
        if k == 0:
            step("tick-pending", h.service.tick(now=h.now + 1e6))
            h.release()
            step("drain-late", h.service.drain())
    # two targets leave db's spec: their findings resolve
    wire = h.queue.get_monitor("db")
    wire["targets"] = wire["targets"][:-2]
    h.queue.put_monitor(wire)
    # a corpus delta: every unpaused spec that is not due is touched
    h.now += 5.0
    # (other live listeners of the process may be notified too: the
    # step reads only that this service is one of them)
    registered = any(r() is h.service for r in h.p.notify._LISTENERS)
    h.p.notify.notify_corpus_delta("corpus-digest-1")
    step("notify", registered)
    step("tick", h.service.tick())
    step("drain", h.service.drain())
    step("tick-cadence", h.service.tick())
    # a fire with no diff, then a restart: the new service resumes it
    h.now += 130.0
    step("tick", h.service.tick())
    h.restart()
    step("drain-restarted", h.service.drain())
    # a journaled-but-unfired epoch: refired once, same epoch, same scan id
    wire = h.queue.get_monitor("web")
    wire.update(refire=True, next_fire_at=0.0)
    h.queue.put_monitor(wire)
    step("tick-refire", h.service.tick())
    step("drain", h.service.drain())
    # a removed monitor's pending epoch is dropped
    h.now += 200.0
    step("tick", h.service.tick())
    h.queue.remove_monitor("api")
    step("drain-removed", h.service.drain())
    step("specs", [s.to_wire() for s in h.service.list_specs()])
    return log


@pytest.mark.parametrize("queues", QUEUES)
def test_service_equals_jax(queues, monkeypatch, capsys):
    got = {}
    for side in SIDES:
        h = Harness(side, monkeypatch, queues)
        try:
            before = h.monitor_samples()
            log = drive(h)
            after = h.monitor_samples()
        finally:
            h.close()
        got[side] = {
            "log": log, "calls": h.calls, "feed": h.feed(), "events": h.events,
            "moved": {k: v - before.get(k, 0.0) for k, v in after.items()
                      if not k[0].endswith("ratio") and v != before.get(k, 0.0)},
            "ratio": {k: v for k, v in after.items() if k[0].endswith("ratio")},
            "tier": {k: dict(v) for k, v in h.tier._state._hashes.items()},
        }
    t, j = got["torch"], got["jax"]
    assert [s[0] for s in t["log"]] == [s[0] for s in j["log"]]
    for a, b in zip(t["log"], j["log"]):
        assert a == b, a[0]
    for key in ("calls", "feed", "events", "moved", "ratio", "tier"):
        assert t[key] == j[key], key
    # the script reached every path it means to
    values = {name: (value, specs) for name, value, specs in t["log"]}
    # the late chunk held web's epoch 2 back while the others committed
    assert values["drain-late"][0] == 3 and values["drain-restarted"][0] == 3
    assert values["tick-refire"][0] == 1 and values["drain-removed"][0] == 2
    assert values["tick-cadence"][0] == 0
    # the service listens; the delta touched every unpaused spec
    assert values["notify"][0] is True
    assert [(s["monitor_id"], s["next_fire_at"]) for s in values["notify"][1]
            if not s["paused"]] == [("api", 0.0), ("db", 0.0), ("web", 0.0)]
    assert sum(e["event"] == "monitor.corpus_delta_touch" for e in t["events"]) == 3
    kinds = {json.loads(v)["kind"] for k, v in t["feed"].items() if "/feed/" in k}
    assert kinds == {"new", "changed", "resolved"}
    refired = [c for c in t["calls"] if c[0] == "web"]
    assert refired[-2][1:] == refired[-3][1:]  # the refire: same scan id, same epoch
    assert t["moved"][("swarm_monitor_epochs_fired_total", ())] > 0


@pytest.mark.parametrize("queues", QUEUES)
def test_restarted_service_resumes_the_same_epoch(queues, monkeypatch, capsys):
    """A fire with no mark, then a new service over the same queue: the
    reconcile picks the epoch up and its diff commits once, under the
    fired scan id, equal in both packages; a second drain commits
    nothing."""
    got = {}
    for side in SIDES:
        h = Harness(side, monkeypatch, queues)
        try:
            MonitorSpec = h.p.spec.MonitorSpec
            h.queue.put_monitor(MonitorSpec("r", "fingerprint", _targets_of(7, "r"), 60.0,
                                            batch_size=2).to_wire())
            fired = h.service.tick()
            before = h.feed()
            h.restart()
            out = [fired, before, h.service.drain(), h.service.drain(), h.feed(), h.specs()]
        finally:
            h.close()
        marks = [k for k in out[4] if "/mark/" in k]
        assert out[:1] == [1] and out[1] == {} and out[2:4] == [1, 0]
        assert marks == ["_monitor/r/mark/e00000001.json"]
        got[side] = out
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the refresh's fan-out


def test_cpu_refresh_notifies_the_port_digest_once():
    from swarm_tpu.fingerprints import load_corpus as j_load_corpus
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.engine import MatchEngine

    templates, _ = load_corpus(DATA)
    eng = MatchEngine(templates, device="cpu")

    class Listener:
        def __init__(self):
            self.seen = []

        def on_corpus_delta(self, digest):
            self.seen.append(digest)

    listener = Listener()
    t_notify.register(listener)
    try:
        eng.refresh_corpus(templates[1:])
    finally:
        t_notify.unregister(listener)
    digest = t_tier.corpus_digest(templates[1:])
    assert listener.seen == [digest]
    assert digest != t_tier.corpus_digest(templates)
    j_templates, _ = j_load_corpus(DATA)
    assert digest != j_tier.corpus_digest(j_templates[1:])  # a port epoch is its own
