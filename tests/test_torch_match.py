"""The port's template-match path (swarm_tpu_torch) against the JAX package.

Every comparison is exact: the values are bools, integers or bytes. The
same rows, made from a seed, go through both packages on the CPU (the
port's kernels through their plain versions; the JAX package's match
path has no Pallas kernel). Corpora: ``tests/data/templates`` (the whole
tree, whose workflow lowers gate planes) and a 150-template synthetic
corpus from ``chip_smoke.synthetic_corpus`` (word, regex, dsl, md5 and
tiny-slot matchers). The kernels themselves run only on a card: the
tests marked ``cuda`` hold them against their plain versions there.
"""

import hashlib
import inspect
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swarm_tpu.fingerprints.compile as j_compile
import swarm_tpu.fingerprints.dslc as j_dslc
import swarm_tpu.fingerprints.extractors as j_extractors
import swarm_tpu.fingerprints.model as j_model
import swarm_tpu.fingerprints.nuclei as j_nuclei
import swarm_tpu.fingerprints.regexlin as j_regexlin
import swarm_tpu.fingerprints.workflows as j_workflows
import swarm_tpu.ops.cpu_ref as j_cpu_ref
import swarm_tpu.ops.encoding as j_encoding
import swarm_tpu.ops.hashing as j_hashing
from chip_smoke import realistic_rows, synthetic_corpus
from swarm_tpu.ops import match as jm
from swarm_tpu.ops.md5 import md5_words as j_md5_words
from swarm_tpu.ops.regexdev import regex_verify as j_regex_verify
from swarm_tpu_torch.fingerprints import compile as t_compile
from swarm_tpu_torch.fingerprints import dslc as t_dslc
from swarm_tpu_torch.fingerprints import extractors as t_extractors
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints import nuclei as t_nuclei
from swarm_tpu_torch.fingerprints import regexlin as t_regexlin
from swarm_tpu_torch.fingerprints import workflows as t_workflows
from swarm_tpu_torch.ops import cpu_ref as t_cpu_ref
from swarm_tpu_torch.ops import encoding as t_encoding
from swarm_tpu_torch.ops import hashing as t_hashing
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops import match as tm
from swarm_tpu_torch.ops import regexdev as t_regexdev
from swarm_tpu_torch.ops.md5 import md5_words as t_md5_words
from test_match_parity import DATA, fuzz_rows

# ---------------------------------------------------------------------------
# Corpora and rows, made once for both packages


class Corpus:
    def __init__(self, j_templates, t_templates):
        self.j_templates = j_templates
        self.t_templates = t_templates
        self.j_db = j_compile.compile_corpus(j_templates)
        self.t_db = t_compile.compile_corpus(t_templates)


def load_tree(root):
    return Corpus(j_nuclei.load_corpus(root)[0], t_nuclei.load_corpus(root)[0])


def synthetic(n: int = 150) -> Corpus:
    docs, _plants = synthetic_corpus(0, n)
    return Corpus([j_nuclei.parse_template(d) for d in docs],
                  [t_nuclei.parse_template(d) for d in docs])


@pytest.fixture(scope="module")
def corpora():
    return {"tree": load_tree(DATA), "synthetic": synthetic()}


@pytest.fixture(scope="module")
def phase_batches(corpora):
    """Per corpus: the engine's encode of row_dicts plus a dense row,
    through both packages (phase_inputs)."""
    return {
        name: phase_inputs(c, row_dicts(c.j_templates, seed=5) + [dense_row(c.j_templates)])
        for name, c in corpora.items()
    }


def row_dicts(templates, seed: int = 0, n: int = 48) -> list[dict]:
    """fuzz_rows over the corpus, the realistic mix with planted corpus
    fragments, banner, OOB, empty and over-wide rows."""
    fuzz = fuzz_rows(templates, random.Random(seed), n // 2)
    fields = ("host", "port", "status", "body", "header", "banner", "oob_protocols",
              "oob_requests")
    out = [{f: getattr(r, f) for f in fields} for r in fuzz]
    _docs, plants = synthetic_corpus(0, 150)
    out += realistic_rows(n - len(out), seed=seed + 1, plants=plants)
    out += [
        {"host": "b", "port": 22, "banner": b"SSH-2.0-OpenSSH_8.9 AcmeCMS"},
        {"host": "o", "port": 80, "status": 200, "body": b"x", "oob_protocols": ("dns", "http"),
         "oob_requests": b"GET /callback HTTP/1.1"},
        {"host": "e", "port": 80},
        {"host": "w", "port": 80, "status": 200, "body": b"powered by AcmeCMS " * 300,
         "header": b"Server: nginx\r\n" + b"X-Pad: y\r\n" * 200},
    ]
    return out


def both(dicts: list[dict]):
    return [j_model.Response(**d) for d in dicts], [t_model.Response(**d) for d in dicts]


def encode_both(dicts, **kw):
    j_rows, t_rows = both(dicts)
    return j_encoding.encode_batch(j_rows, **kw), t_encoding.encode_batch(t_rows, **kw)


ENGINE_ENCODE = dict(max_body=4096, max_header=1024, build_all=False, width_multiple=512)


def jax_tree(arrays_np):
    return jax.tree_util.tree_map(jnp.asarray, arrays_np)


def torch_streams(batch):
    s = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.streams.items()}
    ln = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.lengths.items()}
    return tm.ensure_all_stream(s, ln), ln


# the JAX functions run jitted: eager, each of their many small ops
# compiles on its own, several times slower on the CPU
_j_all_stream = jax.jit(jm.ensure_all_stream)
_j_compact = jax.jit(jm.compact_candidates, static_argnums=(1, 2))


def jax_streams(batch):
    s = {k: jnp.asarray(v) for k, v in batch.streams.items()}
    ln = {k: jnp.asarray(v) for k, v in batch.lengths.items()}
    return _j_all_stream(s, ln), ln


# ---------------------------------------------------------------------------
# 1. The copies


COPIES = [
    (j_model, t_model, ()),
    (j_regexlin, t_regexlin, ()),
    (j_dslc, t_dslc, ()),
    (j_extractors, t_extractors, ()),
    (j_workflows, t_workflows, ()),
    (j_cpu_ref, t_cpu_ref, ()),
    # the two file loaders import yaml inside themselves
    (j_nuclei, t_nuclei, ("load_template_file", "load_corpus")),
    # compile_corpus's docstring names the port's layout upload; the
    # corpus-delta functions are left out
    (j_compile, t_compile, ("compile_corpus", "compile_corpus_delta", "stack_tables_delta",
                            "_adopt_equal_leaves", "build_device_layout_delta")),
    # numpy half only; the torch window hashes replace the jnp ones
    (j_hashing, t_hashing, ("window_hashes_jnp", "bloom_probe_jnp")),
    # numpy path only: no native encoder, no recycled buffer pool
    (j_encoding, t_encoding, ("encode_batch", "ResponseBatch", "_RotatingPool",
                              "_native_encoder_available")),
]


def _own_members(module):
    return {
        name: obj for name, obj in vars(module).items()
        if (inspect.isfunction(obj) or inspect.isclass(obj))
        and obj.__module__ == module.__name__
    }


@pytest.mark.parametrize("orig,port,differs", COPIES, ids=[c[0].__name__ for c in COPIES])
def test_copies_match_their_originals(orig, port, differs):
    """Every function and class of the original is in the copy with the
    same source (the package name aside), but for the listed ones."""
    mine = _own_members(port)
    for name, obj in _own_members(orig).items():
        if name in differs:
            continue
        assert name in mine, f"{port.__name__} lacks {name}"
        want = re.sub(r"\bswarm_tpu\b(?!_torch)", "swarm_tpu_torch", inspect.getsource(obj))
        assert inspect.getsource(mine[name]) == want, f"{port.__name__}.{name} differs"


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_device_layout_equal(corpora, corpus):
    c = corpora[corpus]
    j_meta, j_arrays = j_compile.build_device_layout(c.j_db)
    t_meta, t_arrays = t_compile.build_device_layout(c.t_db)
    assert repr(j_meta) == repr(t_meta)
    j_leaves, j_def = jax.tree_util.tree_flatten(j_arrays)
    t_leaves, t_def = jax.tree_util.tree_flatten(t_arrays)
    assert str(j_def) == str(t_def)
    for a, b in zip(j_leaves, t_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert c.j_db.template_ids == c.t_db.template_ids
    assert c.j_db.stats == c.t_db.stats


@pytest.mark.parametrize("build_all", [True, False])
def test_encode_batch_equal(corpora, build_all):
    dicts = row_dicts(corpora["tree"].j_templates, seed=3)
    jb, tb = encode_both(dicts, max_body=1024, max_header=512, pad_rows_to=256,
                         build_all=build_all, width_multiple=128)
    assert sorted(jb.streams) == sorted(tb.streams)
    for k in jb.streams:
        assert jb.streams[k].dtype == tb.streams[k].dtype
        assert np.array_equal(jb.streams[k], tb.streams[k]), k
    assert sorted(jb.lengths) == sorted(tb.lengths)
    for k in jb.lengths:
        assert np.array_equal(jb.lengths[k], tb.lengths[k]), k
    assert np.array_equal(jb.status, tb.status)
    assert np.array_equal(jb.truncated, tb.truncated)
    assert tb.truncated.any()


def test_all_stream_synthesis_equal(corpora):
    jb, tb = encode_both(row_dicts(corpora["tree"].j_templates, seed=4), **ENGINE_ENCODE)
    js, _ = jax_streams(jb)
    ts, _ = torch_streams(tb)
    assert np.array_equal(np.asarray(js["all"]), ts["all"].numpy())


# ---------------------------------------------------------------------------
# 2. Phase A


@pytest.mark.parametrize("q", [1, 4, 8])
def test_window_hashes_equal(q):
    rng = np.random.default_rng(q)
    stream = rng.integers(0, 256, size=(5, 77), dtype=np.uint8)
    h1, h2 = t_hashing.window_hashes(torch.from_numpy(stream), q)
    j1, j2 = j_hashing.window_hashes_jnp(jnp.asarray(stream), q)
    assert np.array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    assert np.array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))


def dense_row(templates) -> dict:
    """A body of corpus words: more fired windows than a small budget."""
    words = [w for t in templates for _, m in t.all_matchers() for w in m.words]
    return {"host": "d", "port": 80, "status": 200,
            "body": " ".join(words * 4).encode("utf-8", "surrogateescape")[:4000]}


def phase_inputs(c: Corpus, dicts):
    jb, tb = encode_both(dicts, **ENGINE_ENCODE)
    j_meta, j_np = j_compile.build_device_layout(c.j_db)
    t_meta, t_np = t_compile.build_device_layout(c.t_db)
    js, jl = jax_streams(jb)
    ts, tl = torch_streams(tb)
    tab = tm.to_device(t_np["tab"], torch.device("cpu"))
    return dict(jb=jb, j_meta=j_meta, j_np=j_np, js=js, jl=jl, t_meta=t_meta, t_np=t_np,
                ts=ts, tl=tl, tab=tab, views=tm.table_views(t_meta, ts, tl),
                cs=tm.col_starts_of(t_meta, ts))


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_phase_a_equal_at_every_ladder_width(corpora, phase_batches, corpus):
    c, p = corpora[corpus], phase_batches[corpus]
    meta = p["j_meta"]
    assert np.array_equal(jm._col_starts_of(meta, p["js"]), p["cs"])
    cnt = jax.jit(lambda tab, s, ln: jm.prefilter_counts(meta, tab, jm._StreamCtx(s, ln))[0])(
        jax_tree(p["j_np"]["tab"]), p["js"], p["jl"])
    budget = 32  # small: the dense row overflows it
    K = max(1, min(budget, int(p["cs"][-1])))
    col, n_surv = kernels.match_phase_a(p["views"], p["t_meta"].table_q, p["cs"],
                                        p["tab"]["bloom"], budget, K)
    cnt = np.asarray(cnt)
    assert np.array_equal(n_surv.numpy(), cnt[:, -1])
    assert (n_surv > K).any()
    kc = 8
    while True:
        kc = t_compile.survivor_bucket(kc, budget)
        want = np.asarray(_j_compact(jnp.asarray(cnt), kc, K))
        assert np.array_equal(col[:, :kc].numpy(), want), kc
        if kc >= budget:
            break
        kc *= 2


# ---------------------------------------------------------------------------
# 3. Phase B's gather-verify


def phase_b_inputs(c: Corpus, p: dict):
    """Phase A at the engine's budget → (col, kc)."""
    budget = tm.global_candidate_budget(128, len(p["t_meta"].table_stream))
    K = max(1, min(budget, int(p["cs"][-1])))
    col, n_surv = kernels.match_phase_a(p["views"], p["t_meta"].table_q, p["cs"],
                                        p["tab"]["bloom"], budget, K)
    return col, t_compile.survivor_bucket(int(n_surv.clamp(max=K).max()), budget)


def verify(c: Corpus, p: dict, col, kc):
    return kernels.match_verify(
        p["views"], p["t_meta"].table_q, p["cs"], col, kc, p["tab"], p["t_meta"].max_group,
        torch.from_numpy(c.t_db.slot_bytes), torch.from_numpy(c.t_db.slot_len),
        max(c.t_db.num_slots, 1))


def slot_bits(c: Corpus, p: dict) -> torch.Tensor:
    """The batch's value slot plane: verify, then the tiny slots."""
    value, _unc = verify(c, p, *phase_b_inputs(c, p))
    return tm.tiny_slot_bits(p["t_meta"], c.t_db.tiny_bytes, c.t_db.tiny_slot, p["ts"],
                             p["tl"], value)


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_verify_equal(corpora, phase_batches, corpus):
    c, p = corpora[corpus], phase_batches[corpus]
    col, kc = phase_b_inputs(c, p)
    value, unc = verify(c, p, col, kc)
    meta, cs, ns = p["j_meta"], p["cs"], c.j_db.num_slots

    @jax.jit
    def j_verify(tab, slot_bytes, slot_len, s, ln, col):
        return jm.verify_candidates(meta, tab, slot_bytes, slot_len, jm._StreamCtx(s, ln),
                                    col, cs, ns)

    jv, ju = j_verify(jax_tree(p["j_np"]["tab"]), jnp.asarray(c.j_db.slot_bytes),
                      jnp.asarray(c.j_db.slot_len), p["js"], p["jl"],
                      jnp.asarray(col[:, :kc].numpy()))
    assert np.array_equal(value.numpy(), np.asarray(jv))
    assert np.array_equal(unc.numpy(), np.asarray(ju))
    assert value.any()


# ---------------------------------------------------------------------------
# 4. The device regex and md5


@pytest.mark.parametrize("k_pairs", [None, 3])
def test_regex_verify_equal(corpora, k_pairs):
    c = corpora["synthetic"]
    _docs, plants = synthetic_corpus(0, 150)
    dicts = realistic_rows(120, seed=9, plants=plants)
    p = phase_inputs(c, dicts)
    B = len(dicts)
    value = slot_bits(c, p).numpy()  # the gate's slots
    k = k_pairs or c.t_db.rx_k_pairs(B)
    rx_t = tm.to_device(t_compile.rx_arrays_np(c.t_db), torch.device("cpu"))
    word_tab = torch.from_numpy(tm._word_table())
    tv, tu = t_regexdev.regex_verify(c.t_db, p["ts"], p["tl"], torch.from_numpy(value), k,
                                     rx_t, word_tab)
    db = c.j_db
    jv, ju = jax.jit(lambda s, ln, v, a: j_regex_verify(db, s, ln, v, k_pairs=k, arrays=a))(
        p["js"], p["jl"], jnp.asarray(value), jax_tree(j_compile.rx_arrays_np(db)))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert tv.any()
    assert tu.any() == (k_pairs is not None)


def test_md5_words_equal():
    rng = np.random.default_rng(2)
    W = 256
    lens = np.array([0, 1, 55, 56, 63, 64, 119, 120, W, 200], dtype=np.int32)
    stream = np.zeros((len(lens), W), dtype=np.uint8)
    for i, n in enumerate(lens):
        stream[i, :n] = rng.integers(0, 256, n)
    got = t_md5_words(torch.from_numpy(stream), torch.from_numpy(lens)).numpy()
    want = jax.jit(j_md5_words)(stream, lens)
    assert np.array_equal(got, np.asarray(want).astype(np.int64))
    for i, n in enumerate(lens):
        want = np.frombuffer(hashlib.md5(stream[i, :n].tobytes()).digest(), "<u4")
        assert np.array_equal(got[i], want.astype(np.int64))


# ---------------------------------------------------------------------------
# 5. DeviceDB: every plane, byte for byte


@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_devicedb_match_equal(corpora, corpus):
    c = corpora[corpus]
    dicts = row_dicts(c.j_templates, seed=7) + [dense_row(c.j_templates)]
    jb, tb = encode_both(dicts, **ENGINE_ENCODE)
    # candidate_k 8: a budget the dense row overflows
    want = jm.DeviceDB(c.j_db, candidate_k=8).match(jb.streams, jb.lengths, jb.status,
                                                     full=True)
    got = tm.DeviceDB(c.t_db, candidate_k=8, device="cpu").match(tb.streams, tb.lengths,
                                                                 tb.status)
    assert len(got) == len(want) == 7
    for a, b in zip(want[:6], got[:6]):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)
    assert (want[6] is None) == (got[6] is None) == (corpus != "tree")
    for a, b in zip(want[6] or (), got[6] or ()):
        assert np.array_equal(np.asarray(a), b)
    assert got[5].any()  # the dense row overflows the candidate budget


def test_record_calls_replays_dispatch(corpora):
    c = corpora["synthetic"]
    _jb, tb = encode_both(row_dicts(c.j_templates, seed=7), **ENGINE_ENCODE)
    dev = tm.DeviceDB(c.t_db, device="cpu")
    kernels.reset_launches()
    with kernels.record_calls() as calls:
        dev.match(tb.streams, tb.lengths, tb.status)
    assert [name for name, _ in calls] == ["match_phase_a", "match_verify", "match_md5",
                                           "match_regex_scan", "match_verdicts"]
    assert not any(kernels.LAUNCHES.values())
    # replaying the recorded phase A gives the col the verify was handed
    col, _n_surv = kernels.match_phase_a(*calls[0][1])
    assert torch.equal(col, calls[1][1][3])
    dev.match(tb.streams, tb.lengths, tb.status)
    assert len(calls) == 5  # nothing is recorded outside the block


def test_devicedb_defaults_to_cuda(corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.DeviceDB(corpora["tree"].t_db)


def test_wrappers_check_their_inputs():
    v = kernels.StreamView(torch.zeros((2, 8), dtype=torch.uint8),
                           torch.zeros(2, dtype=torch.int32), False)
    bloom = torch.zeros((1, t_hashing.BLOOM_WORDS), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels._tables([v], [9], [0, 8], torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels._tables([v], [4, 4], [0, 8], torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels._views([v] * (kernels.MATCH_MAX_TABLES + 1), torch.device("cpu"),
                       kernels.MATCH_MAX_TABLES)
    bad = kernels.StreamView(v.data, torch.zeros(2, dtype=torch.int64), False)
    with pytest.raises(TypeError):
        kernels._views([bad], torch.device("cpu"), 4)
    col, n_surv = kernels.match_phase_a([v], [4], [0, 8], bloom, 8, 8)
    assert col.shape == (2, 8) and (col == -1).all() and (n_surv == 0).all()


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["tree", "synthetic"])
def test_match_kernels_equal_plain_on_card(corpora, corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    c = corpora[corpus]
    dicts = row_dicts(c.j_templates, seed=8) + [dense_row(c.j_templates)]
    _jb, tb = encode_both(dicts, **ENGINE_ENCODE)
    dev = tm.DeviceDB(c.t_db, device="cuda")
    meta, arrays = dev._ensure_layout()
    s, ln, _st = dev.upload(tb.streams, tb.lengths, tb.status)
    views, cs = tm.table_views(meta, s, ln), tm.col_starts_of(meta, s)
    planes = []
    for budget in (dev._budget(), 16):
        K = max(1, min(budget, int(cs[-1])))
        args = (views, meta.table_q, cs, arrays["tab"]["bloom"], budget, K)
        col, n_surv = kernels.match_phase_a(*args)
        col_p, n_surv_p = tm.phase_a_plain(*args)
        assert torch.equal(col, col_p) and torch.equal(n_surv, n_surv_p)
        kc = t_compile.survivor_bucket(int(n_surv.clamp(max=K).max()), budget)
        vargs = (views, meta.table_q, cs, col, kc, arrays["tab"], meta.max_group,
                 arrays["slot_bytes"], arrays["slot_len"], max(c.t_db.num_slots, 1))
        planes.append(kernels.match_verify(*vargs))
        for a, b in zip(planes[-1], tm.verify_plain(*vargs)):
            assert torch.equal(a, b)
    value = planes[0][0]
    nseq = int(c.t_db.rx_seq_matcher.shape[0])
    if nseq:
        _fired, idx = t_regexdev.compact_pairs(c.t_db, value, c.t_db.rx_k_pairs(len(dicts)),
                                               arrays["rx"])
        safe = idx.clamp(min=0)
        rargs = (t_regexdev.stream_variants(c.t_db, s, ln), safe // nseq, safe % nseq,
                 idx >= 0, arrays["rx"], arrays["word_tab"], int(c.t_db.rx_max_skip_run))
        assert torch.equal(kernels.match_regex_scan(*rargs), t_regexdev.regex_scan_plain(*rargs))
