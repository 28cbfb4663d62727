"""The port's native host passes against the JAX package's bindings.

``swarm_tpu_torch/native/scanio.py`` binds libfastpack (content dedup,
alive mask, the resident verdict memo, set-bit enumeration, the
extraction driver, the batched word confirm) and
``swarm_tpu_torch/native/crex.py`` binds the crex regex VM, each built
into ``swarm_tpu_torch/_build/``. On the same seeded inputs every
result must equal the JAX package's bindings (``swarm_tpu/native/``),
exactly: everything compared is integers, bytes or strings.
"""

import random
import re
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.native import crex as j_crex
from swarm_tpu.native import scanio as j_scanio
from swarm_tpu.ops import crexc as j_crexc
from swarm_tpu.ops.engine import _content_key
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.native import crex as t_crex
from swarm_tpu_torch.native import scanio as t_scanio
from swarm_tpu_torch.ops import crexc as t_crexc
from test_crex import HAND, fuzz_texts

BUILD = Path(t_scanio.__file__).resolve().parents[1] / "_build"
SIDES = {"jax": (j_scanio, j_model), "torch": (t_scanio, t_model)}


def load_jax_crex(tries: int = 20) -> None:
    """Make sure the JAX package's libcrex is loaded. Its loader marks
    the library failed for the rest of the process after one failed
    load (``_lib_failed``), and its regex helpers then answer None
    (undecided) where the port's crex answers. Several test workers
    starting cold run its ``make -C native`` into the same files at
    once, and a worker that loads a half-written library is marked so
    (``tests/test_crex.py`` loads it at collection). By the time a test
    runs that build has finished: clear the mark and load again."""
    for _ in range(tries):
        if j_crex.ensure_crex() is not None:
            return
        with j_crex._load_lock:
            j_crex._lib_failed = False
        time.sleep(0.5)
    raise AssertionError("the JAX package's libcrex does not load")


@pytest.fixture(scope="module", autouse=True)
def jax_crex_loaded():
    load_jax_crex()


def test_libraries_load_from_the_port_build():
    """All three libraries the port loads come from its own build
    directory, never from the JAX package's ``native/`` builds."""
    libs = {"libscanio.so": t_scanio.ensure_lib(), "libfastpack.so": t_scanio.ensure_fastpack(),
            "libcrex.so": t_crex.ensure_crex()}
    for name, lib in libs.items():
        assert Path(lib._name) == BUILD / name
    assert t_scanio.ensure_fastpack() is libs["libfastpack.so"]


def content_pool(model) -> list:
    """Rows whose content keys differ in one dimension each (status,
    banner vs body, oob fields, a mid-body byte the hash never reads)."""
    R = model.Response
    base = bytearray(b"x" * 500)
    base[50] = ord("q")
    return [
        R(body=b"page-A" * 100, header=b"Server: x\r\n", status=200),
        R(body=b"page-A" * 100, header=b"Server: x\r\n", status=404),
        R(body=b"page-B" * 100, header=b"Server: x\r\n", status=200),
        R(banner=b"SSH-2.0", body=b"", header=b"", status=0),
        R(banner=None, body=b"SSH-2.0", header=b"", status=0),
        R(body=b"", header=b"", status=0),
        R(body=b"oob", status=200, oob_protocols=("http",), oob_requests=b"GET /x",
          oob_ips=("1.2.3.4",)),
        R(body=b"oob", status=200, oob_protocols=("dns",), oob_requests=b"GET /x",
          oob_ips=("1.2.3.4",)),
        R(body=b"x" * 500, header=b"", status=200),
        R(body=bytes(base), header=b"", status=200),
    ]


def clone(model, r):
    """Content-equal copy through fresh byte objects."""
    return model.Response(
        host=r.host, port=r.port, status=r.status,
        body=bytes(memoryview(r.body)), header=bytes(memoryview(r.header)),
        banner=None if r.banner is None else bytes(memoryview(r.banner)),
        oob_protocols=tuple(r.oob_protocols), oob_requests=bytes(memoryview(r.oob_requests)),
        oob_ips=tuple(r.oob_ips), alive=r.alive,
    )


def seeded_rows(model, seed: int) -> list:
    rng = random.Random(seed)
    pool = content_pool(model)
    rows = [rng.choice(pool) for _ in range(rng.randrange(0, 60))]
    rows += [clone(model, r) for r in rows[:10]]
    for i in rng.sample(range(len(rows)), k=len(rows) // 5):
        rows[i] = clone(model, rows[i])
        rows[i].alive = False
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_rows_dedup_and_alive_equal(seed):
    got = {}
    for side, (scanio, model) in SIDES.items():
        rows = seeded_rows(model, seed)
        uniq, back = scanio.rows_dedup(rows)
        n_alive, mask = scanio.rows_alive(rows)
        got[side] = (uniq.tolist(), back.tolist(), n_alive, mask.tolist())
    assert got["torch"] == got["jax"]
    # and the Python key semantics
    rows = seeded_rows(j_model, seed)
    key_of: dict = {}
    back = [key_of.setdefault(_content_key(r), len(key_of)) for r in rows]
    assert got["torch"][1] == back
    assert got["torch"][3] == [int(r.alive) for r in rows]


@pytest.mark.parametrize("limit", [1, 7, 8, 9, 100, 203])
def test_plane_bits_equal(limit):
    rng = np.random.default_rng(limit)
    nb = (limit + 7) // 8 + 1
    plane = (rng.random((37, nb)) < 0.2) * rng.integers(0, 256, (37, nb))
    plane = plane.astype(np.uint8)
    want_r, want_t = np.nonzero(np.unpackbits(plane, axis=1)[:, :limit])
    for scanio in (j_scanio, t_scanio):
        rs, ts = scanio.plane_bits(plane, limit)
        assert (rs.tolist(), ts.tolist()) == (want_r.tolist(), want_t.tolist())


@pytest.mark.parametrize("seed", range(3))
def test_ext_resolve_equal(seed):
    rng = np.random.default_rng(seed)
    NT, NO, B = 90, 140, 33
    t_ops = [rng.choice(NO, size=rng.integers(0, 4), replace=False) for _ in range(NT)]
    indptr = np.zeros(NT + 1, dtype=np.int64)
    indptr[1:] = np.cumsum([len(o) for o in t_ops])
    flat = np.concatenate(t_ops).astype(np.int64)
    masked = rng.integers(0, 256, (B, (NT + 7) // 8), dtype=np.uint8)
    rowdep = (rng.random(NT) < 0.1).astype(np.uint8)
    skip = (rng.random(B) < 0.1).astype(np.uint8)
    pop_value = rng.integers(0, 256, (B, (NO + 7) // 8), dtype=np.uint8)
    pop_unc = rng.integers(0, 256, (B, (NO + 7) // 8), dtype=np.uint8)
    got = [
        [a.tolist() for a in scanio.ext_resolve(masked, NT, rowdep, skip, indptr, flat,
                                                pop_value, pop_unc)]
        for scanio in (j_scanio, t_scanio)
    ]
    assert got[1] == got[0]
    assert len(got[1][0]) > 20 and {1, 2} <= set(got[1][3])


NEEDLE_CASES = [
    ([b"needle-x"], False, False),
    ([b"needle-x", b"absent!"], False, True),
    ([b"needle-x", b"fix "], False, False),
    ([b"needle-x"], True, False),
    ([b""], False, True),
]


@pytest.mark.parametrize("needles,ci,cond_and", NEEDLE_CASES)
def test_confirm_needles_batch_equal(needles, ci, cond_and):
    rng = np.random.default_rng(7)
    parts = [bytes(rng.integers(32, 127, size=rng.integers(0, 200), dtype=np.uint8))
             for _ in range(64)]
    parts += [b"", b"NeEdLe-X", b"prefix needle-x suffix", b"needle-"]
    want = j_scanio.confirm_needles_batch(list(parts), needles, ci, cond_and)
    got = t_scanio.confirm_needles_batch(list(parts), needles, ci, cond_and)
    assert got.tolist() == want.tolist()
    for p, v in zip(parts, got.tolist()):
        hay = p.lower() if ci else p
        hits = [nd in hay for nd in needles]
        assert bool(v) == (all(hits) if cond_and else any(hits))


# ---------------------------------------------------------------------------
# VerdictMemo: each scenario runs on both packages' memos and returns a
# trace of everything it observed; the traces must be equal.


def memo_insert_dedupe_and_extras(scanio, model) -> list:
    m = scanio.VerdictMemo(8, 8)
    R = model.Response
    r1 = R(body=b"aaa", header=b"h", status=200)
    r2 = R(body=b"bbb", header=b"h", status=200)
    bits = np.zeros((3, 8), dtype=np.uint8)
    out = [m.lookup([r1, r2, clone(model, r1)], bits)]
    m.insert(r1, np.arange(8, dtype=np.uint8), ((("t-x", ("v1", "v2")),), (3,)))
    out.append((m.contains(clone(model, r1)), m.contains(r2)))
    bits = np.zeros((3, 8), dtype=np.uint8)
    state, miss, extr, deferred = m.lookup([r2, clone(model, r1), r1], bits)
    assert extr[(1, "t-x")] is not extr[(2, "t-x")]  # thawed per row
    out.append((state, miss, extr, deferred, bits))
    return out


def memo_dead_rows_served_as_zero(scanio, model) -> list:
    m = scanio.VerdictMemo(8, 4)
    live = model.Response(body=b"live", status=200)
    m.insert(live, np.full(4, 7, np.uint8), None)
    bits = np.full((2, 4), 0xEE, dtype=np.uint8)
    res = m.lookup([model.Response(host="d", alive=False), clone(model, live)], bits)
    return [res, bits]


def memo_lru_eviction_and_overwrite(scanio, model) -> list:
    m = scanio.VerdictMemo(4, 4)

    def mk(i):
        return model.Response(body=b"x%d" % i, status=i)

    for i in range(6):
        m.insert(mk(i), np.full(4, i, np.uint8), None)
    out = [len(m), [m.contains(mk(i)) for i in range(6)]]
    bits = np.zeros((1, 4), dtype=np.uint8)
    m.lookup([mk(2)], bits)  # refresh 2, the oldest resident
    m.insert(mk(9), np.full(4, 9, np.uint8), None)  # evicts 3, not 2
    out.append([m.contains(mk(i)) for i in (2, 3, 9)])
    m.insert(mk(5), np.full(4, 0x55, np.uint8), None)  # overwrite
    out.append(m.lookup([clone(model, mk(5))], bits) + (bits.copy(), len(m)))
    m.clear()
    out.append(len(m))
    return out


def memo_contains_batch(scanio, model) -> list:
    m = scanio.VerdictMemo(8, 4)
    live = model.Response(body=b"resident", status=200)
    m.insert(live, np.full(4, 3, np.uint8), None)
    dead_twin = clone(model, live)
    dead_twin.alive = False
    out = [m.contains_batch([clone(model, live), model.Response(body=b"novel"), dead_twin]),
           m.contains_batch([]).shape]
    m2 = scanio.VerdictMemo(2, 4)
    a, b = model.Response(body=b"a"), model.Response(body=b"b")
    m2.insert(a, np.zeros(4, np.uint8), None)
    m2.insert(b, np.zeros(4, np.uint8), None)
    m2.contains_batch([clone(model, a)])  # a probe refreshes nothing
    m2.insert(model.Response(body=b"c"), np.zeros(4, np.uint8), None)
    out.append((m2.contains(clone(model, a)), m2.contains(clone(model, b))))
    return out


def memo_insert_batch(scanio, model) -> list:
    m = scanio.VerdictMemo(16, 2)
    rows = content_pool(model)[:6]
    plane = np.arange(12, dtype=np.uint8).reshape(6, 2)
    skip = np.array([0, 1, 0, 0, 1, 0], dtype=np.uint8)
    extras = [None, None, ((("t", ("v",)),), ()), None, None, ((), (4,))]
    out = [m.insert_batch(rows, plane, skip, extras)]
    bits = np.zeros((6, 2), dtype=np.uint8)
    out.append(m.lookup([clone(model, r) for r in rows], bits) + (bits,))
    return out


def memo_refuses_malformed_extras(scanio, model) -> list:
    m = scanio.VerdictMemo(4, 4)
    r = model.Response(body=b"x", status=200)
    out = []
    for bad in ([("tid", [1])], ("only-one",), ((), [])):
        with pytest.raises(ValueError):
            m.insert(r, np.zeros(4, np.uint8), bad)
        with pytest.raises(ValueError):
            m.insert_batch([r], np.zeros((1, 4), np.uint8), np.zeros(1, np.uint8), [bad])
        out.append(len(m))
    m.insert(r, np.zeros(4, np.uint8), None)
    out.append(len(m))
    return out


class MutatingAlive:
    """An ``alive`` whose truthiness replaces the row's body mid-lookup:
    the lookup must refetch the row's parts after the check."""

    def __init__(self, row, new_body: bytes):
        self._row = row
        self._new_body = new_body

    def __bool__(self):
        self._row.body = self._new_body
        return True


def memo_refetch_after_mutating_bool(scanio, model) -> list:
    memo = scanio.VerdictMemo(64, 2)
    R = model.Response
    bits = np.array([0xAB, 0x01], dtype=np.uint8)
    memo.insert(R(host="a", port=80, status=200, body=b"KNOWN-BODY", header=b"H: 1\r\n"),
                bits, None)
    tricky = R(host="b", port=80, status=200, body=b"OLD-BODY", header=b"H: 1\r\n")
    tricky.alive = MutatingAlive(tricky, b"KNOWN-BODY")
    out = np.zeros((1, 2), dtype=np.uint8)
    state, miss, extr, deferred = memo.lookup([tricky], out)
    assert state[0] == -1 and not miss and (out[0] == bits).all()
    return [state, miss, extr, deferred, out]


MEMO_SCENARIOS = [memo_insert_dedupe_and_extras, memo_dead_rows_served_as_zero,
                  memo_lru_eviction_and_overwrite, memo_contains_batch, memo_insert_batch,
                  memo_refuses_malformed_extras, memo_refetch_after_mutating_bool]


def plain(x):
    """A trace with numpy arrays as lists, for ==."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("scenario", MEMO_SCENARIOS, ids=[f.__name__ for f in MEMO_SCENARIOS])
def test_verdict_memo_equal(scenario):
    want = plain(scenario(j_scanio, j_model))
    got = plain(scenario(t_scanio, t_model))
    assert got == want


def test_memo_trace_expectations():
    """The reference behaviour the traces above must show (pinned on the
    port's memo so that two equally wrong traces cannot pass)."""
    tr = plain(memo_insert_dedupe_and_extras(t_scanio, t_model))
    assert tr[0][0] == [0, 1, 0] and tr[0][1] == [0, 1] and tr[1] == (True, False)
    assert tr[2][:4] == ([0, -1, -1], [0], {(1, "t-x"): ["v1", "v2"], (2, "t-x"): ["v1", "v2"]},
                         [(1, 3), (2, 3)])
    tr = plain(memo_dead_rows_served_as_zero(t_scanio, t_model))
    assert tr[0][:2] == ([-2, -1], []) and tr[1] == [[0] * 4, [7] * 4]
    tr = plain(memo_lru_eviction_and_overwrite(t_scanio, t_model))
    assert tr[:3] == [4, [False, False, True, True, True, True], [True, False, True]]
    assert tr[3][4] == [[0x55] * 4] and tr[3][5] == 4 and tr[4] == 0
    tr = plain(memo_contains_batch(t_scanio, t_model))
    assert tr == [[1, 0, 0], (0,), (False, True)]
    tr = plain(memo_insert_batch(t_scanio, t_model))
    assert tr[0] == 4 and tr[1][0] == [-1, 0, -1, -1, 1, -1]
    assert tr[1][2] == {(2, "t"): ["v"]} and tr[1][3] == [(5, 4)]


# ---------------------------------------------------------------------------
# crex


def re_search(pattern: str, text: str) -> bool:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return re.search(pattern, text) is not None


@pytest.mark.parametrize("case", HAND, ids=[c[0][:30] for c in HAND])
def test_crex_equal(case):
    """The port's compiler gives the JAX compiler's program, and the
    port's VM the JAX VM's answers: ``finditer_spans``, ``search``,
    ``exists`` and ``exists_batch`` over the case's text and the fuzz
    texts of tests/test_crex.py."""
    pattern, text, group = case
    texts = [text.encode("latin-1")] + fuzz_texts()
    for compile_name in ("compile_crex", "compile_crex_nfa"):
        jp = getattr(j_crexc, compile_name)(pattern)
        tp = getattr(t_crexc, compile_name)(pattern)
        assert (jp is None) == (tp is None)
        if tp is None:
            continue
        assert (tp.prog.tobytes(), tp.masks.tobytes(), tp.n_saves, tp.group_exists) == (
            jp.prog.tobytes(), jp.masks.tobytes(), jp.n_saves, jp.group_exists)
        if compile_name == "compile_crex":
            for data in texts:
                assert t_crex.finditer_spans(tp, data, group) == j_crex.finditer_spans(
                    jp, data, group)
                assert t_crex.search(tp, data) == j_crex.search(jp, data)
            assert t_crex.finditer_spans_batch(tp, texts, group) == (
                j_crex.finditer_spans_batch(jp, texts, group))
        else:
            got = [t_crex.exists(tp, d) for d in texts]
            assert got == [j_crex.exists(jp, d) for d in texts]
            for d, v in zip(texts, got):
                assert v is None or v == re_search(pattern, d.decode("latin-1"))
            assert t_crex.exists_batch(tp, texts).tolist() == (
                j_crex.exists_batch(jp, texts).tolist())


def test_crex_covers_the_hand_cases():
    """Most hand cases compile, so the comparison above is not vacuous."""
    assert sum(t_crexc.compile_crex(p) is not None for p, _t, _g in HAND) >= 40
    assert sum(t_crexc.compile_crex_nfa(p) is not None for p, _t, _g in HAND) >= 30


def test_probe_front_end_bindings_equal():
    """The scan library's probe front-end as both packages bind it: the
    TLS-capable batch scan against loopback listeners (a greeting, a
    reply to the payload, a refused port), ``tls_available``, the
    ``open_mask``, and libfastpack's ``concat3_list``."""
    from chip_smoke import BannerFleet

    assert t_scanio.tls_available() == j_scanio.tls_available()
    with BannerFleet([(b"SSH-2.0-x\r\n", True), (b"HTTP/1.1 200 OK\r\n\r\nhi", False)]) as fleet:
        targets = fleet.targets + ["127.0.0.1:1"]
        ips = ["127.0.0.1"] * len(targets)
        ports = np.asarray([int(t.rsplit(":", 1)[1]) for t in targets], dtype=np.uint16)
        payloads = [None, b"GET / HTTP/1.0\r\n\r\n", b"x"]
        got = t_scanio.tcp_scan(ips, ports, payloads, read_timeout_ms=1000, banner_cap=64)
        want = j_scanio.tcp_scan(ips, ports, payloads, read_timeout_ms=1000, banner_cap=64)
    assert got.status.tolist() == want.status.tolist()
    assert got.open_mask.tolist() == want.open_mask.tolist() == [True, True, False]
    assert [got.banner(i) for i in range(3)] == [want.banner(i) for i in range(3)]
    assert got.banner(0) == b"SSH-2.0-x\r\n" and got.banner(1).endswith(b"hi")
    rng = random.Random(5)
    heads = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40))) for _ in range(9)]
    bodies = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 90))) for _ in range(9)]
    concat = np.asarray([rng.randrange(2) for _ in range(9)], dtype=np.uint8)
    for width in (1, 64, 200):
        a = np.zeros((9, width), dtype=np.uint8)
        b = np.zeros((9, width), dtype=np.uint8)
        t_scanio.concat3_list(heads, bodies, concat, width, a)
        j_scanio.concat3_list(heads, bodies, concat, width, b)
        assert np.array_equal(a, b)
    with pytest.raises(TypeError):
        t_scanio.concat3_list(heads, ["not bytes"] * 9, concat, 8, a)
