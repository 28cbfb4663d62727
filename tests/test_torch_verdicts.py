"""md5 and the verdict lowering of the port (swarm_tpu_torch) against the
JAX package, and the CSR layout that kernel ``match_verdicts`` reads.

Every comparison is exact: the values are bools and uint32 words. On the
CPU the wrappers take their plain versions (``ops/md5.py`` ``md5_words``,
``ops/match.py`` ``eval_verdicts``); the kernels themselves
(``ops/csrc/md5.cu``, ``ops/csrc/verdicts.cu``) run only on a card, where
the tests marked ``cuda`` hold them against their plain versions. The
kernel's layout is checked here by :func:`walk_layout`, a numpy walk of
the CSR arrays in the kernel's own order of work.

Corpora: ``tests/data/templates`` (the whole tree: its workflow lowers
gate planes, which read m_value) and a 300-template synthetic corpus from
``chip_smoke.synthetic_corpus`` (word, regex, dsl, md5 and tiny-slot
matchers) with six templates for the rules it does not reach (size,
negated slots, a residue, a negated matcher, a prefilter op). Inputs: the verdict call of one ``DeviceDB`` batch of fuzzed
and realistic rows (recorded with ``kernels.record_calls``), and seeded
random slot planes with uncertain bits set.
"""

import hashlib
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
from chip_smoke import realistic_rows, synthetic_corpus
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
