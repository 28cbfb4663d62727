"""md5 and the verdict lowering of the port (swarm_tpu_torch) against the
JAX package, and the CSR layout that kernel ``match_verdicts`` reads.

Every comparison is exact: the values are bools and uint32 words. On the
CPU the wrappers take their plain versions (``ops/md5.py`` ``md5_words``,
``ops/match.py`` ``eval_verdicts``); the kernels themselves
(``ops/csrc/md5.cu``, ``ops/csrc/verdicts.cu``) run only on a card, where
the tests marked ``cuda`` hold them against their plain versions. The
kernel's layout is checked here by :func:`walk_layout`, a numpy walk of
the CSR arrays row by row, and by :func:`walk_chunks`, a numpy walk of
the kernel's own design: the slot planes packed into row-sliced words,
then chunk by chunk of ``match.verdict_chunks``, every any / all a word
operation, at row counts that leave a word partly filled.

Corpora: ``tests/data/templates`` (the whole tree: its workflow lowers
gate planes, which read m_value) and a 300-template synthetic corpus from
``chip_smoke.synthetic_corpus`` (word, regex, dsl, md5 and tiny-slot
matchers) with six templates for the rules it does not reach (size,
negated slots, a residue, a negated matcher, a prefilter op). Inputs: the verdict call of one ``DeviceDB`` batch of fuzzed
and realistic rows (recorded with ``kernels.record_calls``), and seeded
random slot planes with uncertain bits set.
"""

import hashlib
import os
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarm_tpu.fingerprints.compile as j_compile
import swarm_tpu.fingerprints.nuclei as j_nuclei
from chip_smoke import (MD5_CASE_WIDTHS, WIDE_SIZES, WIDE_STATUS, md5_cases, md5_hashlib,
                        realistic_rows, sass_chain, synthetic_corpus, wide_matcher_docs,
                        wide_matcher_rows)
from swarm_tpu.ops import match as jm
from swarm_tpu.ops.md5 import md5_words as j_md5_words
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.fingerprints import nuclei as t_nuclei
from swarm_tpu_torch.fingerprints.model import Response
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops import match as tm
from swarm_tpu_torch.ops.encoding import STREAMS, encode_batch
from swarm_tpu_torch.ops.md5 import md5_words as t_md5_words
from test_match_parity import DATA, fuzz_rows


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


#: the lengths where md5's padding changes shape: the empty message, the
#: last length whose marker and bit length fit one block (55), the
#: lengths whose padding spills into one more block (56-63), whole
#: blocks (64, 128), the same edges a block later (119, 120, 183, 184),
#: and the full width W (the marker falls in the 64 bytes past the stream)
MD5_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 183, 184)


# ---------------------------------------------------------------------------
# md5


def md5_case(width: int, seed: int):
    """Rows at the edge lengths (and W - 9, W - 8, W) with random bytes
    past each length: both md5 versions must mask them."""
    rng = np.random.default_rng(seed)
    lens = np.array(
        [n for n in MD5_EDGE_LENGTHS if n <= width] + [width - 9, width - 8, width],
        dtype=np.int32)
    stream = rng.integers(0, 256, (len(lens), width)).astype(np.uint8)
    return stream, lens


@pytest.mark.parametrize("width", [64, 256, 4096])
def test_md5_edge_lengths_equal_jax_and_hashlib(width):
    stream, lens = md5_case(width, seed=width)
    got = kernels.match_md5(torch.from_numpy(stream), torch.from_numpy(lens)).numpy()
    assert got.dtype == np.int64 and got.shape == (len(lens), 4)
    want = np.asarray(jax.jit(j_md5_words)(stream, lens)).astype(np.int64)
    assert np.array_equal(got, want)
    for i, n in enumerate(lens):
        digest = np.frombuffer(hashlib.md5(stream[i, :n].tobytes()).digest(), "<u4")
        assert np.array_equal(got[i], digest.astype(np.int64)), n
    # the host block bound changes nothing
    bounded = t_md5_words(torch.from_numpy(stream), torch.from_numpy(lens),
                          max_len=int(lens.max()))
    assert np.array_equal(bounded.numpy(), got)


#: the named cases of ``chip_smoke.md5_cases``
MD5_CASES = ("random", "edge_lanes", "chunk_borders", "nonpositive", "past_width")


@pytest.mark.parametrize("case", MD5_CASES)
@pytest.mark.parametrize("width", [64, 320])
def test_md5_cases_equal_jax_and_hashlib(width, case):
    """The kernel's named cases through the wrapper on the CPU (the plain
    version): equal to the JAX ``md5_words``, lengths of 0 and below and
    past the width included, and to hashlib wherever the JAX code
    digests a message."""
    stream, lens = md5_cases(width)[case]
    got = kernels.match_md5(torch.from_numpy(stream), torch.from_numpy(lens)).numpy()
    want = np.asarray(jax.jit(j_md5_words)(stream, lens)).astype(np.int64)
    assert np.array_equal(got, want)
    ok, host = md5_hashlib(stream, lens)
    assert np.array_equal(got[ok], host[ok])
    assert ok.sum() == len(lens) if case in ("random", "edge_lanes", "chunk_borders") else ok.any()


def test_md5_wrapper_checks_its_inputs():
    stream = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.match_md5(stream.to(torch.int32), lens)
    with pytest.raises(TypeError):
        kernels.match_md5(stream, lens.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.match_md5(torch.zeros((2, 60), dtype=torch.uint8), lens)
    with pytest.raises(ValueError):
        kernels.match_md5(stream, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.match_md5(stream.to("meta"), lens.to("meta"))
    with pytest.raises(ValueError):
        kernels.match_md5(stream, lens.to("meta"))


# ---------------------------------------------------------------------------
# The verdict lowering: corpora and inputs


def _rule_template(i: int, matchers: list, condition: str = "or") -> dict:
    return {"id": f"verdict-rule-{i}", "info": {"name": f"rule {i}", "severity": "info"},
            "requests": [{"method": "GET", "path": ["{{BaseURL}}/"],
                          "matchers-condition": condition, "matchers": matchers}]}


#: templates for the rules the synthetic corpus does not reach: size
#: matchers, negated-slot conjuncts, a residue, a negated word matcher,
#: a prefilter op
RULE_DOCS = [
    _rule_template(0, [{"type": "size", "size": [5, 120], "part": "body"}]),
    _rule_template(1, [{"type": "dsl", "condition": "and",
                        "dsl": ['!contains(body, "forbidden-word")', "status_code == 200"]}]),
    _rule_template(2, [{"type": "dsl", "dsl": ['contains(body, "acme") && sha256(body) == "00"']}]),
    _rule_template(3, [{"type": "dsl", "dsl": [
        '!contains(body, "alpha-x") && !contains(body, "beta-y") && len(body) > 3']}]),
    _rule_template(4, [{"type": "word", "words": ["nope-word"], "negative": True},
                       {"type": "size", "size": [0], "part": "header"}], "and"),
    # a kval matcher has no device lowering: the op becomes a prefilter
    _rule_template(5, [{"type": "word", "words": ["kv-word"]},
                       {"type": "kval", "kval": ["x_powered_by"]}], "and"),
]
RULE_ROWS = [
    {"host": "r", "port": 80, "status": 200, "body": b"acme " * 24},
    {"host": "s", "port": 80, "status": 200, "body": b"forbidden-word acme beta-y"},
    {"host": "t", "port": 80, "status": 404, "body": b"alpha"},
    {"host": "u", "port": 80, "status": 200, "body": b"nope-word", "header": b"Server: x"},
    {"host": "v", "port": 80, "status": 200, "body": b"kv-word"},
]


class Corpus:
    def __init__(self, j_templates, t_templates, dicts):
        self.j_db = j_compile.compile_corpus(j_templates)
        self.t_db = t_compile.compile_corpus(t_templates)
        self.dicts = dicts


def _fuzz_dicts(templates, seed: int, n: int) -> list:
    fields = ("host", "port", "status", "body", "header", "banner", "oob_protocols",
              "oob_requests")
    return [{f: getattr(r, f) for f in fields}
            for r in fuzz_rows(templates, random.Random(seed), n)]


@pytest.fixture(scope="module")
def corpora():
    docs, plants = synthetic_corpus(0, 300)
    docs = docs + RULE_DOCS
    j_syn = [j_nuclei.parse_template(d) for d in docs]
    syn_rows = (realistic_rows(40, seed=4, plants=plants) + _fuzz_dicts(j_syn, 4, 24)
                + RULE_ROWS)
    j_tree, t_tree = j_nuclei.load_corpus(DATA)[0], t_nuclei.load_corpus(DATA)[0]
    return {
        "synthetic": Corpus(j_syn, [t_nuclei.parse_template(d) for d in docs], syn_rows),
        "tree": Corpus(j_tree, t_tree, _fuzz_dicts(j_tree, 5, 48)),
    }


@pytest.fixture(scope="module")
def verdict_inputs(corpora):
    """Per corpus: the recorded ``match_verdicts`` call of one DeviceDB
    batch on the CPU → (layout, value, unc, lengths, status, digest, rx)."""
    out = {}
    for name, c in corpora.items():
        batch = encode_batch([Response(**d) for d in c.dicts], max_body=4096,
                             max_header=1024, build_all=False, width_multiple=512)
        dev = tm.DeviceDB(c.t_db, device="cpu")
        with kernels.record_calls() as calls:
            dev.match(batch.streams, batch.lengths, batch.status)
        (args,) = [a for n, a in calls if n == "match_verdicts"]
        out[name] = args
    return out


def planes_case(args, planes: str, digest: bool, rx: bool) -> tuple:
    """The recorded call with the dispatch's slot planes or seeded random
    ones (uncertain bits on a fifth of the slots), and with or without
    its digest and its regex overlay."""
    layout, value, unc, ln, st, dg, overlay = args
    if planes == "random":
        rng = np.random.default_rng(value.shape[1])
        value = torch.from_numpy(rng.random(value.shape) < 0.3)
        unc = torch.from_numpy(rng.random(value.shape) < 0.2)
    return layout, value, unc, ln, st, dg if digest else None, overlay if rx else None


# ---------------------------------------------------------------------------
# The CSR layout, walked as the kernel walks it


def _clamped(i: int, n: int) -> int:
    i = i + n if i < 0 else i
    return min(max(i, 0), n - 1)


def _reduce(off, idx, owner: int, n: int, v: np.ndarray, u: np.ndarray):
    """(all v, any v, any u, any v & ~u, any ~v & ~u) of one owner's
    members over [B, n] planes, or None when it has no members."""
    lo, hi = int(off[owner]), int(off[owner + 1])
    if hi <= lo:
        return None
    j = [_clamped(int(x), n) for x in idx[lo:hi]]
    gv, gu = v[:, j], u[:, j]
    return gv.all(1), gv.any(1), gu.any(1), (gv & ~gu).any(1), (~gv & ~gu).any(1)


def walk_layout(lay: dict, value, unc, lengths: dict, status, digest=None, rx=None) -> tuple:
    """The verdict lowering over ``match.verdict_layout_np``'s CSR
    arrays, owner by owner in the three phases of csrc/verdicts.cu,
    vectorized over rows → (t_value, t_unc, op_value, op_unc, m_value,
    m_unc)."""
    bit = {k: 1 << i for i, k in enumerate(tm.M_FLAG_BITS)}
    obit = {k: 1 << i for i, k in enumerate(tm.OP_FLAG_BITS)}
    B, NS = value.shape
    nm, nop = len(lay["m_flags"]), len(lay["op_flags"])
    nt = len(lay["t_op_off"]) - 1
    srcs = np.stack([status if n == "status" else lengths[n] for n in tm.CHECK_SOURCES], 1)
    mv, mu = np.zeros((B, nm), bool), np.zeros((B, nm), bool)
    for m in range(nm):
        fl = int(lay["m_flags"][m])
        slot_red, u = np.ones(B, bool), np.zeros(B, bool)
        r = _reduce(lay["m_slot_off"], lay["m_slot_idx"], m, NS, value, unc)
        if r is not None:
            all_v, any_v, any_u, any_vnu, _ = r
            is_and = bool(fl & bit["m_cond_and"])
            slot_red = all_v if is_and else any_v
            u = any_u & ~(~all_v if is_and else any_vnu)
        neg_present = neg_df = np.zeros(B, bool)
        r = _reduce(lay["m_neg_off"], lay["m_neg_idx"], m, NS, value, unc)
        if r is not None:
            neg_present, neg_df = r[1], r[3]
            u = u | r[2]
        scalar_ok = np.ones(B, bool)
        if fl & bit["is_scalar"]:
            for c in range(lay["scalar_src"].shape[1]):
                v = srcs[:, lay["scalar_src"][m, c]].astype(np.float32)
                cmp, mask = lay["scalar_cmp"][m, c], int(lay["scalar_mask"][m, c])
                checks = (v == cmp, v != cmp, v < cmp, v > cmp, v <= cmp, v >= cmp,
                          np.ones(B, bool))
                conj = np.zeros(B, bool)
                for i, chk in enumerate(checks):
                    if mask >> i & 1:
                        conj |= chk
                scalar_ok &= conj
        status_ok = size_ok = np.zeros(B, bool)
        if fl & bit["is_status"]:
            status_ok = (status[:, None] == lay["m_status"][m][None]).any(1)
        if fl & bit["is_size"]:
            sel = srcs[:, lay["m_size_src"][m]]
            size_ok = (sel[:, None] == lay["m_size"][m][None]).any(1)
        md5_ok = np.ones(B, bool)
        if fl & bit["m_md5_check"]:
            if digest is not None:
                want = lay["m_md5"][m].astype(np.uint32).astype(np.int64)
                md5_ok = (digest == want[None]).all(1)
            else:
                u = np.ones(B, bool)
        val = np.zeros(B, bool)
        if fl & bit["is_words"]:
            val = slot_red
        if fl & bit["is_scalar"]:
            val = scalar_ok & slot_red & ~neg_present & md5_ok
        if fl & bit["is_status"]:
            val = status_ok
        if fl & bit["is_size"]:
            val = size_ok
        if fl & bit["is_scalar"]:
            u = u & ~(~scalar_ok | ~md5_ok | neg_df)
        if fl & (bit["m_residue"] | bit["is_rx_prefilter"]):
            u = u | val
        if rx is not None and lay["m_rx"][m] >= 0:
            val, u = rx[0][:, lay["m_rx"][m]], rx[1][:, lay["m_rx"][m]]
        if fl & bit["m_negative"]:
            val = ~val
        mv[:, m], mu[:, m] = val, u
    ov, ou = np.zeros((B, nop), bool), np.zeros((B, nop), bool)
    for o in range(nop):
        r = _reduce(lay["op_m_off"], lay["op_m_idx"], o, nm, mv, mu)
        fl = int(lay["op_flags"][o])
        if r is not None:
            all_v, any_v, any_u, any_vnu, any_nvnu = r
            is_and = bool(fl & obit["op_cond_and"])
            ov[:, o] = all_v if is_and else any_v
            ou[:, o] = any_u & ~(any_nvnu if is_and else any_vnu)
        if fl & obit["op_prefilter"]:
            ou[:, o] = ov[:, o]
    tv, tu = np.zeros((B, nt), bool), np.zeros((B, nt), bool)
    for t in range(nt):
        r = _reduce(lay["t_op_off"], lay["t_op_idx"], t, nop, ov, ou)
        if r is not None:
            tv[:, t], tu[:, t] = r[1], r[2] & ~r[3]
    return tv, tu, ov, ou, mv, mu


def _np(x):
    return None if x is None else x.numpy()


_j_eval = {}


def jax_verdicts(c: Corpus, value, unc, lengths, status, digest, rx) -> tuple:
    """The JAX ``eval_verdicts(full=True)`` on the same inputs, jitted
    once per (corpus, digest given, overlay given)."""
    key = (id(c.j_db), digest is None, rx is None)
    if key not in _j_eval:
        db = c.j_db

        def run(v, u, ln, st, dg, r, arrays):
            return jm.eval_verdicts(db, v, u, ln, st, full=True, md5_digest=dg, rx=r,
                                    arrays=arrays)

        _j_eval[key] = jax.jit(run)
    arrays = jax.tree_util.tree_map(jnp.asarray, j_compile.verdict_arrays_np(c.j_db))
    out = _j_eval[key](
        jnp.asarray(value.numpy()), jnp.asarray(unc.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in lengths.items() if k in STREAMS},
        jnp.asarray(status.numpy()),
        None if digest is None else jnp.asarray(digest.numpy().astype(np.uint32)),
        None if rx is None else tuple(jnp.asarray(p.numpy()) for p in rx), arrays)
    return tuple(np.asarray(p) for p in out)


CASES = [(p, d, r) for p in ("dispatch", "random") for d in (True, False) for r in (True, False)]


@pytest.mark.parametrize("planes,digest,rx", CASES,
                         ids=[f"{p}-{'digest' if d else 'nodigest'}-{'rx' if r else 'norx'}"
                              for p, d, r in CASES])
@pytest.mark.parametrize("corpus", ["synthetic", "tree"])
def test_walked_layout_equals_port_and_jax(corpora, verdict_inputs, corpus, planes, digest, rx):
    c = corpora[corpus]
    layout, value, unc, ln, st, dg, overlay = planes_case(verdict_inputs[corpus], planes,
                                                          digest, rx)
    assert (dg is None) != digest and (overlay is None) != rx
    lay = tm.verdict_layout_np(c.t_db)
    walked = walk_layout(lay, value.numpy(), unc.numpy(), {k: v.numpy() for k, v in ln.items()},
                         st.numpy(), _np(dg), None if overlay is None else tuple(map(_np, overlay)))
    port = kernels.match_verdicts(layout, value, unc, ln, st, dg, overlay)
    assert len(port) == 6
    # m_value leaves the lowering only for the workflow gates
    assert layout.has_gates == (corpus == "tree") and (port[4] is None) != layout.has_gates
    for i, (a, b) in enumerate(zip(walked, port)):
        if b is None:
            continue
        assert b.dtype == torch.bool
        assert np.array_equal(a, b.numpy()), f"plane {i}"
    # the JAX package: its five planes, and the gates that read m_value
    full = tm.full_planes(layout.arrays, tuple(torch.from_numpy(p) for p in walked))
    want = jax_verdicts(c, value, unc, ln, st, dg, overlay)
    assert len(full) == len(want) == (9 if corpus == "tree" else 5)
    for i, (a, b) in enumerate(zip(full, want)):
        assert np.array_equal(a.numpy(), b), f"plane {i}"
    assert walked[0].any()
    assert walked[5].any() or planes == "dispatch"  # uncertain matchers


# ---------------------------------------------------------------------------
# The kernel's design: rows in the bits of a word, template chunks


def pack_words(plane: np.ndarray) -> np.ndarray:
    """bool [B, n] → the kernel's row-sliced words uint32 [W, n], W =
    ceil(B / 32): bit r of word w is row 32 w + r, rows past B zero."""
    B, n = plane.shape
    W = (B + 31) // 32
    padded = np.zeros((W * 32, n), dtype=np.uint64)
    padded[:B] = plane
    shifted = padded.reshape(W, 32, n) << np.arange(32, dtype=np.uint64)[None, :, None]
    return np.bitwise_or.reduce(shifted, axis=1).astype(np.uint32)


def _words(rows: np.ndarray) -> np.ndarray:
    """A per-row bool mask [B] → its words [W] (the kernel's loop over
    a word's rows)."""
    return pack_words(rows[:, None])[:, 0]


def _reduce_words(off, idx, owner: int, n: int, base: int, v, u):
    """(all v, any v, any u, any v & ~u, any ~v & ~u) words [W] of one
    owner's members, clamped into [0, n), read at j - base from [., W]
    word arrays; None without members."""
    lo, hi = int(off[owner]), int(off[owner + 1])
    if hi <= lo:
        return None
    j = np.array([_clamped(int(x), n) - base for x in idx[lo:hi]])
    gv, gu = v[j], u[j]
    orr = np.bitwise_or.reduce
    return (np.bitwise_and.reduce(gv, 0), orr(gv, 0), orr(gu, 0), orr(gv & ~gu, 0),
            orr(~gv & ~gu, 0))


#: the values of a status or size matcher a pass of the kernel's warp
VALUE_PASS = 32


def any_value(values: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Each row's ``got`` equal to one of a matcher's ``values``, as the
    kernel's any_value takes them: :data:`VALUE_PASS` values a pass (lane
    s loads value p + s), each row's hits OR-ed over the passes."""
    ok = np.zeros(got.shape[0], dtype=bool)
    for p in range(0, len(values), VALUE_PASS):
        ok |= (got[:, None] == values[None, p:p + VALUE_PASS]).any(1)
    return ok


def walk_chunks(lay: dict, value, unc, lengths: dict, status, digest=None, rx=None) -> tuple:
    """The verdict lowering as csrc/verdicts.cu computes it: the slot
    planes (and the overlay) packed into row-sliced words, then chunk by
    chunk of ``lay["chunks"]`` (``match.verdict_chunks``) matchers, ops
    and templates over the chunk's word arrays, every any / all a word
    operation, the per-row checks built into masks; each plane entry
    written from the chunk that owns it → (t_value, t_unc, op_value,
    op_unc, m_value, m_unc) bool planes. Fails if an entry is written
    twice or never."""
    bit = {k: 1 << i for i, k in enumerate(tm.M_FLAG_BITS)}
    obit = {k: 1 << i for i, k in enumerate(tm.OP_FLAG_BITS)}
    B, NS = value.shape
    nm, nop = len(lay["m_flags"]), len(lay["op_flags"])
    nt = len(lay["t_op_off"]) - 1
    vw, uw = pack_words(value), pack_words(unc)
    rvw, ruw = (None, None) if rx is None else (pack_words(rx[0]), pack_words(rx[1]))
    srcs = np.stack([status if n == "status" else lengths[n] for n in tm.CHECK_SOURCES], 1)
    W = vw.shape[0]
    ones = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    zeros = np.zeros(W, dtype=np.uint32)
    out = {k: np.zeros((W, n), dtype=np.uint32) for k, n in (
        ("tv", nt), ("tu", nt), ("ov", nop), ("ou", nop), ("mv", nm), ("mu", nm))}
    written = {k: np.zeros(n, dtype=np.int64) for k, n in (("t", nt), ("op", nop), ("m", nm))}
    for ch in lay["chunks"]:
        t_lo, t_hi, op_lo, op_hi, op_own_lo, op_own_hi, m_lo, m_hi, m_own_lo, m_own_hi = map(
            int, ch)
        mv = np.zeros((m_hi - m_lo, W), dtype=np.uint32)
        mu = np.zeros_like(mv)
        for m in range(m_lo, m_hi):
            fl = int(lay["m_flags"][m])
            slot_red, u = ones, zeros
            r = _reduce_words(lay["m_slot_off"], lay["m_slot_idx"], m, NS, 0, vw.T, uw.T)
            if r is not None:
                all_v, any_v, any_u, any_vnu, _ = r
                is_and = bool(fl & bit["m_cond_and"])
                slot_red = all_v if is_and else any_v
                u = any_u & ~(~all_v if is_and else any_vnu)
            neg_present = neg_df = zeros
            r = _reduce_words(lay["m_neg_off"], lay["m_neg_idx"], m, NS, 0, vw.T, uw.T)
            if r is not None:
                neg_present, neg_df = r[1], r[3]
                u = u | r[2]
            scalar_ok = ones
            if fl & bit["is_scalar"]:
                for c in range(lay["scalar_src"].shape[1]):
                    v = srcs[:, lay["scalar_src"][m, c]].astype(np.float32)
                    cmp, mask = lay["scalar_cmp"][m, c], int(lay["scalar_mask"][m, c])
                    checks = (v == cmp, v != cmp, v < cmp, v > cmp, v <= cmp, v >= cmp,
                              np.ones(B, bool))
                    conj = np.zeros(B, bool)
                    for i, chk in enumerate(checks):
                        if mask >> i & 1:
                            conj |= chk
                    scalar_ok = scalar_ok & _words(conj)
            status_ok = size_ok = zeros
            if fl & bit["is_status"]:
                status_ok = _words(any_value(lay["m_status"][m], status))
            if fl & bit["is_size"]:
                size_ok = _words(any_value(lay["m_size"][m], srcs[:, lay["m_size_src"][m]]))
            md5_ok = ones
            if fl & bit["m_md5_check"]:
                if digest is not None:
                    want = lay["m_md5"][m].astype(np.uint32).astype(np.int64)
                    md5_ok = _words((digest == want[None]).all(1))
                else:
                    u = ones
            val = zeros
            if fl & bit["is_words"]:
                val = slot_red
            if fl & bit["is_scalar"]:
                val = scalar_ok & slot_red & ~neg_present & md5_ok
            if fl & bit["is_status"]:
                val = status_ok
            if fl & bit["is_size"]:
                val = size_ok
            if fl & bit["is_scalar"]:
                u = u & scalar_ok & md5_ok & ~neg_df
            if fl & (bit["m_residue"] | bit["is_rx_prefilter"]):
                u = u | val
            if rvw is not None and lay["m_rx"][m] >= 0:
                val, u = rvw[:, lay["m_rx"][m]], ruw[:, lay["m_rx"][m]]
            if fl & bit["m_negative"]:
                val = ~val
            mv[m - m_lo], mu[m - m_lo] = val, u
        ov = np.zeros((op_hi - op_lo, W), dtype=np.uint32)
        ou = np.zeros_like(ov)
        for o in range(op_lo, op_hi):
            r = _reduce_words(lay["op_m_off"], lay["op_m_idx"], o, nm, m_lo, mv, mu)
            fl = int(lay["op_flags"][o])
            if r is not None:
                all_v, any_v, any_u, any_vnu, any_nvnu = r
                is_and = bool(fl & obit["op_cond_and"])
                ov[o - op_lo] = all_v if is_and else any_v
                ou[o - op_lo] = any_u & ~(any_nvnu if is_and else any_vnu)
            if fl & obit["op_prefilter"]:
                ou[o - op_lo] = ov[o - op_lo]
        for t in range(t_lo, t_hi):
            r = _reduce_words(lay["t_op_off"], lay["t_op_idx"], t, nop, op_lo, ov, ou)
            if r is not None:
                out["tv"][:, t], out["tu"][:, t] = r[1], r[2] & ~r[3]
        out["ov"][:, op_own_lo:op_own_hi] = ov[op_own_lo - op_lo:op_own_hi - op_lo].T
        out["ou"][:, op_own_lo:op_own_hi] = ou[op_own_lo - op_lo:op_own_hi - op_lo].T
        out["mv"][:, m_own_lo:m_own_hi] = mv[m_own_lo - m_lo:m_own_hi - m_lo].T
        out["mu"][:, m_own_lo:m_own_hi] = mu[m_own_lo - m_lo:m_own_hi - m_lo].T
        written["t"][t_lo:t_hi] += 1
        written["op"][op_own_lo:op_own_hi] += 1
        written["m"][m_own_lo:m_own_hi] += 1
    assert all((n == 1).all() for n in written.values()), "an entry written twice or never"

    def unpack(words):  # [W, n] → bool [B, n]
        rows = (words[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
        return rows.reshape(W * 32, -1)[:B].astype(bool)

    return tuple(unpack(out[k]) for k in ("tv", "tu", "ov", "ou", "mv", "mu"))


def rows_case(args, rows: int, digest: bool, rx: bool) -> tuple:
    """The recorded call's rows drawn with repeats to ``rows`` rows
    (seeded), a twentieth of their slot bits flipped and a tenth set
    uncertain, with or without the digest and the overlay."""
    layout, value, unc, ln, st, dg, overlay = args
    rng = np.random.default_rng(rows)
    pick = torch.from_numpy(rng.integers(0, value.shape[0], rows))
    flip = torch.from_numpy(rng.random((rows, value.shape[1])) < 0.05)
    more = torch.from_numpy(rng.random((rows, value.shape[1])) < 0.1)
    return (layout, (value[pick] ^ flip).contiguous(), (unc[pick] | more).contiguous(),
            {k: v[pick].contiguous() for k, v in ln.items()}, st[pick].contiguous(),
            dg[pick].contiguous() if digest else None,
            tuple(p[pick].contiguous() for p in overlay) if rx else None)


ROW_COUNTS = (1, 31, 32, 33, 256)
WORD_CASES = [(d, r) for d in (True, False) for r in (True, False) if d or r]


@pytest.mark.parametrize("digest,rx", WORD_CASES,
                         ids=[f"{'digest' if d else 'nodigest'}-{'rx' if r else 'norx'}"
                              for d, r in WORD_CASES])
@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("corpus", ["synthetic", "tree"])
def test_word_chunk_walk_equals_port_and_jax(corpora, verdict_inputs, corpus, rows, digest, rx):
    c = corpora[corpus]
    layout, value, unc, ln, st, dg, overlay = rows_case(verdict_inputs[corpus], rows, digest, rx)
    lay = tm.verdict_layout_np(c.t_db)
    walked = walk_chunks(lay, value.numpy(), unc.numpy(), {k: v.numpy() for k, v in ln.items()},
                         st.numpy(), _np(dg), None if overlay is None else tuple(map(_np, overlay)))
    port = kernels.match_verdicts(layout, value, unc, ln, st, dg, overlay)
    for i, (a, b) in enumerate(zip(walked, port)):
        if b is not None:
            assert np.array_equal(a, b.numpy()), f"plane {i}"
    full = tm.full_planes(layout.arrays, tuple(torch.from_numpy(p) for p in walked))
    want = jax_verdicts(c, value, unc, ln, st, dg, overlay)
    for i, (a, b) in enumerate(zip(full, want)):
        assert np.array_equal(a.numpy(), b), f"plane {i}"
    assert walked[5].any() or rows == 1  # uncertain matchers


@pytest.fixture(scope="module")
def wide():
    """The corpus of more than 32 status and size values a matcher
    (``chip_smoke.wide_matcher_docs``) in both packages, and the recorded
    verdict call of its rows' DeviceDB batch on the CPU."""
    docs = wide_matcher_docs()
    c = Corpus([j_nuclei.parse_template(d) for d in docs],
               [t_nuclei.parse_template(d) for d in docs], wide_matcher_rows())
    batch = encode_batch([Response(**d) for d in c.dicts], max_body=4096, max_header=1024,
                         build_all=False, width_multiple=512)
    dev = tm.DeviceDB(c.t_db, device="cpu")
    with kernels.record_calls() as calls:
        dev.match(batch.streams, batch.lengths, batch.status)
    (args,) = [a for n, a in calls if n == "match_verdicts"]
    return c, args


def test_wide_status_and_size_matchers_equal_port_and_jax(wide):
    """A status and a size matcher of 40 values: the layout is 40 wide,
    and the word-chunk walk (values 32 a pass), the port's plain verdicts
    and the JAX ``eval_verdicts`` agree; the rows whose value lies past
    the first 32 fire."""
    c, (layout, value, unc, ln, st, dg, overlay) = wide
    lay = tm.verdict_layout_np(c.t_db)
    assert lay["m_status"].shape[1] == lay["m_size"].shape[1] == len(WIDE_STATUS) > VALUE_PASS
    assert kernels.verdict_struct(layout).n_status == len(WIDE_STATUS)
    walked = walk_chunks(lay, value.numpy(), unc.numpy(), {k: v.numpy() for k, v in ln.items()},
                         st.numpy(), _np(dg), None if overlay is None else tuple(map(_np, overlay)))
    port = kernels.match_verdicts(layout, value, unc, ln, st, dg, overlay)
    for i, (a, b) in enumerate(zip(walked, port)):
        if b is not None:
            assert np.array_equal(a, b.numpy()), f"plane {i}"
    full = tm.full_planes(layout.arrays, tuple(torch.from_numpy(p) for p in walked))
    want = jax_verdicts(c, value, unc, ln, st, dg, overlay)
    for i, (a, b) in enumerate(zip(full, want)):
        assert np.array_equal(a.numpy(), b), f"plane {i}"
    ids = c.t_db.template_ids
    fired = [[ids[t] for t in np.flatnonzero(row)] for row in walked[0][:, :len(ids)]]
    assert fired == [["many-status", "many-size"]] * 3 + [["many-size"]] * 2 + [
        ["many-size"], ["many-size"], [], []]
    assert WIDE_SIZES[35] == 116 and st.numpy()[2] == WIDE_STATUS[-1]


def test_chunks_partition_and_cover_the_corpus(corpora):
    """The chunk table: the templates in order, the owned op and matcher
    ranges a partition, every member a chunk reads inside what it
    computes; on the synthetic corpus, whose templates reach their ops
    and matchers in order, enough chunks to give the card ~4 blocks an
    SM at 256 rows, none wider than its block."""
    for name, c in corpora.items():
        lay = tm.verdict_layout_np(c.t_db)
        ch = lay["chunks"].astype(np.int64)
        assert ch.shape[1] == len(tm.CHUNK_FIELDS) == 10
        nm, nop, nt = len(lay["m_flags"]), len(lay["op_flags"]), len(lay["t_op_off"]) - 1
        for lo, hi, n in ((0, 1, nt), (4, 5, nop), (8, 9, nm)):
            assert ch[0, lo] == 0 and ch[-1, hi] == n and (ch[1:, lo] == ch[:-1, hi]).all()
        assert (ch[:, 2] <= ch[:, 4]).all() and (ch[:, 5] <= ch[:, 3]).all()
        assert (ch[:, 6] <= ch[:, 8]).all() and (ch[:, 9] <= ch[:, 7]).all()
        for k in range(len(ch)):
            _hull_inside(lay["t_op_off"], lay["t_op_idx"], ch[k, 0], ch[k, 1], nop, ch[k, 2], ch[k, 3])
            _hull_inside(lay["op_m_off"], lay["op_m_idx"], ch[k, 2], ch[k, 3], nm, ch[k, 6], ch[k, 7])
        assert tm.chunk_smem(ch) <= kernels.MAX_SHARED_BYTES
    docs, _ = synthetic_corpus(0)
    lay = tm.verdict_layout_np(t_compile.compile_corpus([t_nuclei.parse_template(d) for d in docs]))
    ch = lay["chunks"]
    assert len(ch) * 8 >= 4 * 132  # 256 rows: 8 words
    assert (ch[:, 7] - ch[:, 6]).max() <= tm.CHUNK_OWNERS >= (ch[:, 1] - ch[:, 0]).max()
    assert ((ch[:, 7] - ch[:, 6]) == (ch[:, 9] - ch[:, 8])).all()  # reached in order: no overlap


def _hull_inside(off, idx, lo, hi, n, in_lo, in_hi) -> None:
    members = idx[off[lo]:off[hi]]
    if members.size:
        j = tm._clamped(torch.from_numpy(members), n).numpy()
        assert in_lo <= j.min() and j.max() < in_hi


def test_chunks_of_an_unordered_layout():
    """Templates that reach ops and matchers out of order, an op and a
    matcher no template reaches, a template without ops: the chunks
    widen their hulls and still own each entry once."""
    lay = {"t_op_off": np.array([0, 2, 2, 3, 4]), "t_op_idx": np.array([3, 0, 1, -1]),
           "op_m_off": np.array([0, 1, 3, 3, 5, 6]), "op_m_idx": np.array([6, 0, 1, 2, 5, 3]),
           "m_flags": np.zeros(7, np.int32), "op_flags": np.zeros(5, np.int32)}
    ch = tm.verdict_chunks(lay, owners=1).astype(np.int64)
    assert ch[:, 0].tolist() == [0, 1, 2, 3] and ch[-1, 1] == 4
    for lo, hi, n in ((4, 5, 5), (8, 9, 7)):
        assert ch[0, lo] == 0 and ch[-1, hi] == n and (ch[1:, lo] == ch[:-1, hi]).all()
    for k in range(len(ch)):
        _hull_inside(lay["t_op_off"], lay["t_op_idx"], ch[k, 0], ch[k, 1], 5, ch[k, 2], ch[k, 3])
        _hull_inside(lay["op_m_off"], lay["op_m_idx"], ch[k, 2], ch[k, 3], 7, ch[k, 6], ch[k, 7])
        assert ch[k, 2] <= ch[k, 4] <= ch[k, 5] <= ch[k, 3]
        assert ch[k, 6] <= ch[k, 8] <= ch[k, 9] <= ch[k, 7]


def test_inputs_reach_every_rule(corpora, verdict_inputs):
    """The corpora give the walk every kind of matcher and rule to check."""
    lay = tm.verdict_layout_np(corpora["synthetic"].t_db)
    assert np.bitwise_or.reduce(lay["m_flags"]) == (1 << len(tm.M_FLAG_BITS)) - 1
    assert np.bitwise_or.reduce(lay["op_flags"]) == (1 << len(tm.OP_FLAG_BITS)) - 1
    assert (lay["m_rx"] >= 0).any() and (np.diff(lay["m_neg_off"]) > 0).any()
    assert (lay["scalar_mask"] > 1).any()  # checks other than ==
    assert not corpora["synthetic"].t_db.host_always
    tree = tm.verdict_layout_np(corpora["tree"].t_db)
    assert corpora["tree"].t_db.wf is not None and corpora["tree"].t_db.wf.num_terms
    assert (tree["m_flags"] & (1 << tm.M_FLAG_BITS.index("is_status"))).any()
    for args in verdict_inputs.values():
        assert args[5] is not None and args[6] is not None  # digest and overlay


def test_layout_csr_keeps_bucket_rows():
    buckets = ((np.array([2, 0]), np.array([[5], [7]])), (np.array([3]), np.array([[1, 4]])))
    off, idx = tm._csr(buckets, 5)
    assert off.tolist() == [0, 1, 1, 2, 4, 4]
    assert idx.tolist() == [7, 5, 1, 4]
    with pytest.raises(ValueError):  # an owner in two buckets
        tm._csr(buckets + ((np.array([2]), np.array([[0, 0]])),), 5)
    with pytest.raises(ValueError):  # an owner out of range
        tm._csr(buckets, 3)


def test_layout_struct_and_flags_match_the_kernel_source():
    """The ctypes struct and the flag bits follow csrc/verdicts.cu field
    for field and bit for bit: a drift would pass the CPU tests (the
    plain version reads neither) and misread the layout on the card."""
    src = (Path(kernels.__file__).parent / "csrc" / "verdicts.cu").read_text()
    body = re.search(r"struct VerdictLayout \{(.*?)\};", src, re.S).group(1)
    pointers = re.findall(r"const \w+\* (\w+);", body)
    counts = re.search(r"^\s*int32_t ([\w, ]+);", body, re.M).group(1).split(", ")
    assert [name for name, _ in kernels.VerdictLayoutC._fields_] == pointers + counts
    assert pointers == [key for key, _ in kernels.VERDICT_LAYOUT_KEYS]
    names = {"And": "m_cond_and", "Negative": "m_negative", "Residue": "m_residue",
             "Md5": "m_md5_check", "Words": "is_words", "RxPrefilter": "is_rx_prefilter",
             "Scalar": "is_scalar", "Status": "is_status", "Size": "is_size"}
    m_bits = {names[n]: int(v) for n, v in re.findall(r"kM(\w+) = (\d+)", src)}
    assert m_bits == {key: 1 << i for i, key in enumerate(tm.M_FLAG_BITS)}
    op_bits = dict(re.findall(r"kOp(\w+) = (\d+)", src))
    assert op_bits == {"And": "1", "Prefilter": "2"}
    assert tm.OP_FLAG_BITS == ("op_cond_and", "op_prefilter")
    # the check sources: the kernel takes as many as the layout indexes,
    # the status last; the scalar variables resolve as compile numbers them
    assert int(re.search(r"constexpr int kSources = (\d+);", src).group(1)) == len(tm.CHECK_SOURCES)
    assert int(re.search(r"constexpr int kChunkFields = (\d+);", src).group(1)) == len(
        tm.CHUNK_FIELDS)
    assert "kStatusSource = kSources - 1;" in src and tm.CHECK_SOURCES[-1] == "status"
    assert tm.CHECK_SOURCES[:-1] == STREAMS
    var = {t_compile.SV_STATUS: "status", t_compile.SV_LEN_BODY: "body",
           t_compile.SV_LEN_HEADER: "header", t_compile.SV_LEN_ALL: "all",
           t_compile.SV_CONTENT_LENGTH: "body"}
    assert tm.SCALAR_VAR_SOURCES == tuple(var[i] for i in range(t_compile.SCALAR_VARS))


def test_verdicts_wrapper_checks_its_inputs(verdict_inputs):
    layout, value, unc, ln, st, dg, rx = verdict_inputs["synthetic"]
    with pytest.raises(TypeError):
        kernels.match_verdicts(layout, value.to(torch.uint8), unc, ln, st, dg, rx)
    with pytest.raises(TypeError):
        kernels.match_verdicts(layout, value, unc, ln, st.to(torch.int64), dg, rx)
    with pytest.raises(TypeError):
        kernels.match_verdicts(layout, value, unc, ln, st, dg.to(torch.int32), rx)
    with pytest.raises(ValueError):
        kernels.match_verdicts(layout, value[:, :-1], unc, ln, st, dg, rx)
    with pytest.raises(ValueError):
        kernels.match_verdicts(layout, value, unc, ln, st, dg, (rx[0][:, :-1], rx[1]))
    with pytest.raises(ValueError):  # planes on another device than the layout
        kernels.match_verdicts(layout, value.to("meta"), unc.to("meta"), ln, st, dg, rx)
    with pytest.raises(ValueError):
        kernels.match_verdicts(layout, value, unc.to("meta"), ln, st, dg, rx)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 256, 4096])
def test_md5_kernel_equals_plain_on_card(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from swarm_tpu_torch.ops.md5 import md5_words

    stream, lens = md5_case(width, seed=width)
    s, n = torch.from_numpy(stream).cuda(), torch.from_numpy(lens).cuda()
    assert torch.equal(kernels.match_md5(s, n), md5_words(s, n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MD5_CASES)
@pytest.mark.parametrize("width", MD5_CASE_WIDTHS)
def test_md5_kernel_cases_equal_plain_and_hashlib_on_card(width, case):
    """The kernel on its named cases (``chip_smoke.md5_cases``: 1,024
    random lengths, the edge lengths at several lanes of a block, every
    chunk border of its shared-memory ring ±1, lengths of 0 and below
    beside W, lengths past W; random bytes past every length), at widths
    of one block, one chunk, not a multiple of the chunk, and 4,096:
    exact against its plain version and against hashlib."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from swarm_tpu_torch.ops.md5 import md5_words

    stream, lens = md5_cases(width)[case]
    s, n = torch.from_numpy(stream).cuda(), torch.from_numpy(lens).cuda()
    got = kernels.match_md5(s, n)
    assert torch.equal(got, md5_words(s, n))
    ok, host = md5_hashlib(stream, lens)
    assert np.array_equal(got.cpu().numpy()[ok], host[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("planes,digest,rx", CASES)
@pytest.mark.parametrize("corpus", ["synthetic", "tree"])
def test_verdicts_kernel_equals_plain_on_card(corpora, corpus, planes, digest, rx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    c = corpora[corpus]
    batch = encode_batch([Response(**d) for d in c.dicts], max_body=4096, max_header=1024,
                         build_all=False, width_multiple=512)
    dev = tm.DeviceDB(c.t_db, device="cuda")
    with kernels.record_calls() as calls:
        dev.match(batch.streams, batch.lengths, batch.status)
    (args,) = [a for n, a in calls if n == "match_verdicts"]
    args = planes_case(args, planes, digest, rx)
    if planes == "random":
        args = (args[0], args[1].cuda(), args[2].cuda(), *args[3:])
    got = kernels.match_verdicts(*args)
    for a, b in zip(got, tm.verdicts_plain(*args)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_verdicts_kernel_on_wide_matchers_equals_plain_on_card(wide):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    c, _args = wide
    batch = encode_batch([Response(**d) for d in c.dicts], max_body=4096, max_header=1024,
                         build_all=False, width_multiple=512)
    dev = tm.DeviceDB(c.t_db, device="cuda")
    with kernels.record_calls() as calls:
        dev.match(batch.streams, batch.lengths, batch.status)
    (args,) = [a for n, a in calls if n == "match_verdicts"]
    assert args[0].csr["m_status"].shape[1] > VALUE_PASS
    for a, b in zip(kernels.match_verdicts(*args), tm.verdicts_plain(*args)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_ptxas_report_names_the_new_kernels():
    """The build's ptxas check finds both kernels by name, digits included."""
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        for name in ("_ZN37_GLOBAL__N__5a1c2e07_6_md5_cu_0f3b4c1916match_md5_kernelEPKhPKiiiPl",
                     "_ZN42_GLOBAL__N__9d2e4f11_11_verdicts_cu_a1b2c3d421match_verdicts_kernel"
                     "ENS_13VerdictLayoutENS_12VerdictBatchE"))
    report = kernels.ptxas_report(log)
    assert [k["kernel"] for k in report] == ["match_md5_kernel", "match_verdicts_kernel"]
    assert all(k["registers"] == 40 and k["spill_stores"] == 0 for k in report)


def test_ptxas_report_reads_past_a_file_hash_that_reads_as_a_length():
    """nvcc's hash in the unnamed namespace can hold digits that read as
    a length prefix reaching the kernel's name too ("50" + 50 characters
    ending in ``_kernel`` here, as in one build on the card): the name
    is the innermost such identifier."""
    name = ("_ZN40_GLOBAL__N__f50d7673_8_match_cu_523b098423match_regex_scan_kernel"
            "ILi3EEviiPKhPKi")
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n")
    assert [k["kernel"] for k in kernels.ptxas_report(log)] == ["match_regex_scan_kernel<3>"]


#: two md5 rounds as sm_90a emits them, in one basic block between a
#: branch and a label: the words' shared-memory load, then per round F
#: (LOP3), an add and the rotate with its add (LEA.HI), a + x + k summed
#: off the chain (IADD3 with the constant); the next block's loop test
#: and a store of another function stay out
ROUNDS_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116match_md5_kernelEPKhPKiiiPl
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA `(.L_x_1) ;
.L_x_0:
        /*0020*/                   LDS.128 R4, [R20] ;
        /*0030*/                   IADD3 R9, R3, -0x28955b88, R4 ;
        /*0040*/                   LOP3.LUT R10, R21, R2, R22, 0xb8, !PT ;
        /*0050*/                   IMAD.IADD R10, R9, 0x1, R10 ;
        /*0060*/                   LEA.HI R2, R10, R2, R10, 0x7 ;
        /*0070*/                   IADD3 R11, R22, -0x173848aa, R5 ;
        /*0080*/                   LOP3.LUT R12, R2, R21, R2, 0xb8, !PT ;
        /*0090*/                   IMAD.IADD R12, R11, 0x1, R12 ;
        /*00a0*/                   LEA.HI R3, R12, R2, R12, 0xc ;
        /*00b0*/               @P1 BRA `(.L_x_0) ;
.L_x_1:
        /*00c0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_113other_kernelEv
        /*0000*/                   STG.E desc[UR4][R2.64], R0 ;
        /*0010*/                   EXIT ;
"""


def test_sass_chain_counts_the_dependent_operations_a_round():
    """chip_smoke's SASS check: the largest basic block's longest
    register chain (LDS, IADD3, IMAD.IADD, LEA.HI, LOP3, IMAD.IADD,
    LEA.HI: the first round's F waits on nothing), over its rounds."""
    got = sass_chain(ROUNDS_SASS, "match_md5_kernel", 2)
    assert got["block_instructions"] == 10
    assert got["chain"] == 7 and got["chain_ops_per_round"] == 3.5
    # the chain's middle: the second round's F, add and rotate
    assert got["round_ops"][-3:] == ["LOP3.LUT", "IMAD.IADD", "LEA.HI"]
    with pytest.raises(AssertionError):
        sass_chain(ROUNDS_SASS, "missing_kernel", 2)
