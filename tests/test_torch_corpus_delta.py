"""The port's corpus-delta refresh against the JAX package's, on the CPU.

Each case of ``tests/test_corpus_delta.py`` on both packages, on the
small corpus ``tests/data/templates``:

- a one-template add, remove or edit delta-compiles to a layout equal
  byte for byte to the JAX package's from-scratch ``build_device_layout``
  of the same templates (and to the port's own);
- a single add rebuilds only the touched stacked row (a spy on the
  port's ``stack_tables_np``), a no-op delta reuses every leaf;
- a live refresh serves the next batch with the JAX engine's results
  after the same refresh, and a fresh port engine's, exactly; memos are
  invalidated;
- a no-op refresh uploads nothing and keeps the kernels' corpus structs
  (the ``VerifyCorpus`` and ``VerdictLayout`` objects); a sharded refresh
  on a (2,2,2) grid of ``cpu`` ranks equals the single-device one; a
  refresh, then an injected ``device.dispatch`` fault, gives the new
  corpus's verdicts from the CPU oracle.

``test_refresh_bumps_shared_cache_epoch_exactly_once`` is
``tests/test_torch_result_cache.py``'s ``test_refresh_moves_the_epoch_once``,
beside the tier's other cases. Also here: the ``swarm_aot_*``
families against the JAX module's, and ``load_library``'s hit, miss and
deserialize_error outcomes with the compiler and the loader stubbed.
"""

import random

import jax
import numpy as np
import pytest
import torch

import swarm_tpu.fingerprints.compile as j_fpc
import swarm_tpu.telemetry.aot_export as j_aot
import swarm_tpu.telemetry.metrics as j_metrics
import swarm_tpu_torch.fingerprints.compile as t_fpc
import swarm_tpu_torch.telemetry.aot_export as t_aot
import swarm_tpu_torch.telemetry.metrics as t_metrics
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.parallel.mesh import make_mesh
from swarm_tpu_torch.resilience import faults as t_faults

from test_match_parity import fuzz_rows
from test_torch_build import NVCC_VERSION, compiles, lib_env, loads  # noqa: F401

DATA = "tests/data/templates"
FIELDS = ("host", "port", "status", "body", "header", "banner")
CASES = ["add_at_end", "remove_last", "remove_mid", "edit_word"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines that walk inline
    (``walk_threads=1``): several test processes share the host (the
    results do not depend on either)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def corpora():
    j_templates, errors = j_load_corpus(DATA)
    t_templates, t_errors = t_load_corpus(DATA)
    assert j_templates and not errors and not t_errors
    assert [t.id for t in j_templates] == [t.id for t in t_templates]
    return j_templates, t_templates


def _word_template(pkg, tid="delta-probe", needle="deltaprobe-needle-xyz"):
    return pkg.Template(id=tid, protocol="http", operations=[pkg.Operation(
        matchers=[pkg.Matcher(type="word", part="body", words=[needle])])])


def _case(pkg, templates, case):
    """(base, new) template lists of a delta case, as test_corpus_delta.py
    builds them."""
    base = list(templates)
    if case == "add_at_end":
        return base, base + [_word_template(pkg)]
    if case == "remove_last":
        return base, base[:-1]
    if case == "remove_mid":
        return base, base[:2] + base[3:]
    base = base + [_word_template(pkg)]  # edit_word: same id, another needle
    return base, base[:-1] + [_word_template(pkg, needle="deltaprobe-other-needle")]


def _assert_layouts_equal(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert str(ta) == str(tb), "layout structure drift"
    for (pa, xa), (_pb, xb) in zip(fa, fb):
        xa, xb = np.asarray(xa), np.asarray(xb)
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, jax.tree_util.keystr(pa)
        assert xa.tobytes() == xb.tobytes(), jax.tree_util.keystr(pa)


_DB_ARRAYS = (
    "slot_bytes", "slot_len", "tiny_bytes", "tiny_slot", "m_kind",
    "m_negative", "m_cond_and", "m_scalar", "m_residue", "m_status",
    "m_size", "op_cond_and", "op_prefilter", "t_prefilter", "m_src",
    "op_src", "rx_m_ids", "rx_bytemap",
)


# ---------------------------------------------------------------------------
# the delta compile


@pytest.mark.parametrize("case", CASES)
def test_delta_equals_jax_scratch(corpora, case):
    """The port's delta layout equals the JAX from-scratch layout of the
    same templates byte for byte, and the port's own from-scratch one;
    its stats equal the JAX delta's."""
    j_templates, t_templates = corpora
    j_base, j_new = _case(j_model, j_templates, case)
    t_base, t_new = _case(t_model, t_templates, case)
    t_old = t_fpc.compile_corpus(t_base)
    t_fpc.build_device_layout(t_old)
    t_delta, t_stats = t_fpc.compile_corpus_delta(t_new, t_old)
    j_old = j_fpc.compile_corpus(j_base)
    j_fpc.build_device_layout(j_old)
    _j_delta, j_stats = j_fpc.compile_corpus_delta(j_new, j_old)
    j_meta, j_arrays = j_fpc.build_device_layout(j_fpc.compile_corpus(j_new))
    t_scratch = t_fpc.compile_corpus(t_new)
    t_meta, t_arrays = t_fpc.build_device_layout(t_scratch)
    d_meta, d_arrays = t_delta._device_layout
    assert repr(d_meta) == repr(j_meta) == repr(t_meta)
    _assert_layouts_equal(d_arrays, j_arrays)
    _assert_layouts_equal(d_arrays, t_arrays)
    for name in _DB_ARRAYS:
        np.testing.assert_array_equal(getattr(t_delta, name), getattr(t_scratch, name),
                                      err_msg=name)
    assert t_delta.template_ids == t_scratch.template_ids
    assert t_stats == j_stats


def test_single_add_rebuilds_only_touched_rows(corpora, monkeypatch):
    """A one-template add whose words land in one table rebuilds exactly
    that stacked row, reuses every other (WordTables adopted by
    identity), and never calls the port's full-stack function."""
    _j, t_templates = corpora
    db_old = t_fpc.compile_corpus(t_templates)
    t_fpc.build_device_layout(db_old)
    calls = []
    real = t_fpc.stack_tables_np
    monkeypatch.setattr(t_fpc, "stack_tables_np", lambda *a: calls.append(1) or real(*a))
    db_new, stats = t_fpc.compile_corpus_delta(
        list(t_templates) + [_word_template(t_model)], db_old)
    assert not calls, "delta path fell back to a full stack build"
    T = stats["tables_total"]
    assert stats["tables_rebuilt"] == 1 and stats["tables_reused"] == T - 1
    assert stats["rows_rebuilt"] == 1 and stats["rows_reused"] == T - 1
    assert sum(1 for t in db_new.tables if any(t is o for o in db_old.tables)) == T - 1


def test_noop_delta_reuses_everything(corpora):
    _j, t_templates = corpora
    db_old = t_fpc.compile_corpus(t_templates)
    _m, a_old = t_fpc.build_device_layout(db_old)
    db_new, stats = t_fpc.compile_corpus_delta(list(t_templates), db_old)
    assert stats["tables_rebuilt"] == 0 and stats["rows_rebuilt"] == 0
    assert stats["leaves_reused"] == stats["leaves_total"] == len(
        jax.tree_util.tree_leaves(a_old))
    _m2, a_new = db_new._device_layout
    for (_p, new), (_q, old) in zip(t_fpc.layout_leaves(a_new), t_fpc.layout_leaves(a_old)):
        assert new is old


# ---------------------------------------------------------------------------
# the live engine


def _rows(j_templates, with_needle=True):
    rows = fuzz_rows(j_templates, random.Random(3), 12)
    dicts = [{f: getattr(r, f) for f in FIELDS} for r in rows]
    if with_needle:
        dicts.append({"host": "h", "port": 80, "status": 200,
                      "body": b"hello deltaprobe-needle-xyz world",
                      "header": b"X-Probe: 1\r\n"})
    return dicts


def _results(rms):
    return [(sorted(rm.template_ids), rm.extractions) for rm in rms]


def _port_rows(dicts):
    return [t_model.Response(**d) for d in dicts]


@pytest.mark.parametrize("case", CASES)
def test_live_refresh_serves_next_batch(corpora, case, monkeypatch):
    """A refresh of a live engine (an add reuses the unchanged stacked
    rows: spy, no full stack build), and its next batch gives the JAX engine's
    results after the same refresh, and a fresh port engine's, exactly."""
    j_templates, t_templates = corpora
    j_base, j_new = _case(j_model, j_templates, case)
    t_base, t_new = _case(t_model, t_templates, case)
    dicts = _rows(j_templates)
    eng = MatchEngine(t_base, batch_rows=16, device="cpu", walk_threads=1)
    j_eng = JaxEngine(j_base, mesh=None, batch_rows=16, walk_threads=1)
    assert _results(eng.match(_port_rows(dicts))) == _results(
        j_eng.match([j_model.Response(**d) for d in dicts]))
    calls = []
    real = t_fpc.stack_tables_np
    monkeypatch.setattr(t_fpc, "stack_tables_np", lambda *a: calls.append(1) or real(*a))
    stats = eng.refresh_corpus(t_new)
    monkeypatch.setattr(t_fpc, "stack_tables_np", real)
    if case == "add_at_end":  # a removal renumbers the slots of every later row
        assert not calls, "refresh paid a full layout rebuild"
    j_stats = j_eng.refresh_corpus(j_new)
    for key in ("tables_total", "tables_reused", "rows_reused", "rows_rebuilt",
                "leaves_reused", "leaves_total", "uploaded_leaves", "reused_leaves"):
        assert stats[key] == j_stats[key], key
    assert stats["uploaded_leaves"] + stats["reused_leaves"] == stats["leaves_total"]
    assert stats["reused_leaves"] > 0
    assert eng.templates == t_new
    got = _results(eng.match(_port_rows(dicts)))
    assert got == _results(j_eng.match([j_model.Response(**d) for d in dicts]))
    assert got == _results(MatchEngine(t_new, batch_rows=16, device="cpu", walk_threads=1).match(
        _port_rows(dicts)))
    assert ("delta-probe" in got[-1][0]) == (case == "add_at_end")


def test_refresh_invalidates_content_memos(corpora):
    """Memoized verdicts of the old corpus do not serve the new one: the
    same content picks up the added template after the refresh."""
    j_templates, t_templates = corpora
    rows = _port_rows(_rows(j_templates))
    eng = MatchEngine(list(t_templates), batch_rows=16, device="cpu", walk_threads=1)
    r1 = eng.match(rows)
    assert _results(eng.match(rows)) == _results(r1)  # memo-warm
    assert eng._vmemo is not None and eng.memo_contains(rows[-1])
    eng.refresh_corpus(list(t_templates) + [_word_template(t_model)])
    assert eng._vmemo is None and not eng._ext_cache and not eng._confirm_cache
    r2 = eng.match(rows)
    assert "delta-probe" in r2[-1].template_ids
    assert "delta-probe" not in r1[-1].template_ids


def test_noop_refresh_keeps_the_kernel_structs(corpora):
    """Refreshing onto the same corpus uploads no leaf, keeps the
    executables (the layout signature is unchanged), and keeps the very
    VerifyCorpus and VerdictLayout objects, whose structs hold the
    tensors' pointers."""
    j_templates, t_templates = corpora
    rows = _port_rows(_rows(j_templates, with_needle=False))
    eng = MatchEngine(list(t_templates), batch_rows=16, device="cpu", walk_threads=1)
    r1 = _results(eng.match(rows))
    _meta, arrays = eng.device._ensure_layout()
    verify, layout, tab = arrays["verify"], arrays["verdict"], dict(arrays["tab"])
    vstruct = layout.struct
    stats = eng.refresh_corpus(list(t_templates))
    assert stats["executables_kept"] is True
    assert stats["uploaded_leaves"] == 0 and stats["uploaded_bytes"] == 0
    assert stats["reused_leaves"] == stats["leaves_total"]
    _meta, arrays = eng.device._ensure_layout()
    assert arrays["verify"] is verify and arrays["verdict"] is layout
    assert layout.struct is vstruct and all(arrays["tab"][k] is tab[k] for k in tab)
    eng.clear_content_memos()
    assert _results(eng.match(rows)) == r1


def test_same_shape_edit_rewrites_tensors_in_place(corpora):
    """An edit that keeps every leaf's shape (one needle byte changed)
    copies the changed bytes into the old tensors: the structs are kept,
    executables_kept is True, and the results are the fresh engine's."""
    j_templates, t_templates = corpora
    base = list(t_templates) + [_word_template(t_model, needle="deltaprobe-needle-xyz")]
    new = base[:-1] + [_word_template(t_model, needle="deltaprobe-needle-xyq")]
    dicts = _rows(j_templates) + [{"host": "q", "port": 80, "status": 200,
                                   "body": b"a deltaprobe-needle-xyq b", "header": b""}]
    eng = MatchEngine(base, batch_rows=16, device="cpu", walk_threads=1)
    eng.match(_port_rows(dicts))
    _meta, arrays = eng.device._ensure_layout()
    verify, layout = arrays["verify"], arrays["verdict"]
    stats = eng.refresh_corpus(new)
    assert stats["uploaded_leaves"] > 0 and stats["executables_kept"] is True
    _meta, arrays = eng.device._ensure_layout()
    assert arrays["verify"] is verify and arrays["verdict"] is layout
    got = _results(eng.match(_port_rows(dicts)))
    assert got == _results(MatchEngine(new, batch_rows=16, device="cpu", walk_threads=1).match(
        _port_rows(dicts)))
    assert "delta-probe" in got[-1][0] and "delta-probe" not in got[-2][0]


def test_sharded_refresh_equals_single_device(corpora):
    """A (2,2,2) grid of cpu ranks refreshed onto the new corpus gives the
    single-device refreshed engine's results; its own stats count the
    host trees' leaves, and its halo is the new corpus's."""
    j_templates, t_templates = corpora
    new = list(t_templates) + [_word_template(t_model)]
    rows = _port_rows(_rows(j_templates))
    single = MatchEngine(list(t_templates), batch_rows=16, device="cpu", walk_threads=1)
    mesh_eng = MatchEngine(list(t_templates), batch_rows=16, device="cpu", walk_threads=1,
                           mesh=make_mesh((2, 2, 2), ["cpu"] * 8))
    assert _results(mesh_eng.match(rows)) == _results(single.match(rows))
    single.refresh_corpus(new)
    stats = mesh_eng.refresh_corpus(new)
    sh = stats["sharded"]
    assert sh["uploaded_leaves"] > 0 and sh["reused_leaves"] > 0
    assert mesh_eng.sharded.db is mesh_eng.db and mesh_eng.sharded.halo > 0
    want = _results(single.match(rows))
    assert _results(mesh_eng.match(rows)) == want
    assert "delta-probe" in want[-1][0]
    # a no-op refresh of the mesh uploads nothing and keeps its structs
    sh = mesh_eng.refresh_corpus(list(new))["sharded"]
    assert sh["uploaded_leaves"] == 0 and sh["executables_kept"] is True


def test_refresh_then_injected_fault_serves_the_new_corpus(corpora):
    """After a refresh, a batch whose dispatch fails (an injected
    ``device.dispatch`` fault) is redone on the CPU oracle over the new
    templates: the new corpus's verdicts."""
    j_templates, t_templates = corpora
    new = list(t_templates) + [_word_template(t_model)]
    rows = _port_rows(_rows(j_templates))
    want = _results(MatchEngine(new, batch_rows=64, device="cpu", walk_threads=1).match(rows))
    eng = MatchEngine(list(t_templates), batch_rows=64, device="cpu", walk_threads=1)
    eng.match(rows)
    eng.refresh_corpus(new)
    t_faults.install_plan("device.dispatch:1")
    try:
        got = _results(eng.match(rows))
    finally:
        t_faults.clear_plan()
    assert eng.stats.device_faults == 1 and eng.stats.degraded_batches == 1
    assert got == want and "delta-probe" in got[-1][0]


# ---------------------------------------------------------------------------
# swarm_aot_* and the kernel libraries


def test_aot_families_equal_jax():
    port = t_metrics.REGISTRY._metrics
    ref = j_metrics.REGISTRY._metrics
    names = [n for n in port if n.startswith("swarm_aot_")]
    assert sorted(names) == sorted(n for n in ref if n.startswith("swarm_aot_")) == sorted([
        "swarm_aot_fetch_total", "swarm_aot_publish_total", "swarm_aot_bringup_seconds",
        "swarm_aot_artifact_bytes"])
    for name in names:
        a, b = port[name], ref[name]
        assert type(a).__name__ == type(b).__name__, name
        assert a.help == b.help and tuple(a.labelnames) == tuple(b.labelnames), name
    # the same pre-seeded label values: the same rendered series
    def series(metrics):
        return sorted({(n, tuple(sorted(lab.items()))) for n, lab, _v in metrics.parse_exposition(
            metrics.REGISTRY.render()) if n.startswith("swarm_aot_")})

    assert series(t_metrics) == series(j_metrics)
    assert j_aot.AOT_FETCHES.name == t_aot.AOT_FETCHES.name


def _counts():
    return {o: t_aot.AOT_FETCHES.labels(outcome=o).value
            for o in ("hit", "miss", "deserialize_error")} | {
        "stored": t_aot.AOT_PUBLISHES.labels(outcome="stored").value}


def test_load_library_miss_then_hit(lib_env, compiles, loads, monkeypatch):  # noqa: F811
    before = _counts()
    kernels.load_library("md5")  # no keyed file: built
    monkeypatch.setattr(kernels, "_libs", {})  # a new process finds it
    kernels.load_library("md5")
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "hit": 1, "miss": 1, "deserialize_error": 0, "stored": 1}
    assert len(compiles) == 1
    assert t_aot.AOT_ARTIFACT_BYTES.labels().value == kernels.library_path("md5").stat().st_size


def test_load_library_rebuilds_a_refused_file_once(lib_env, compiles, monkeypatch):  # noqa: F811
    """A keyed file that ctypes.CDLL refuses is deleted and built once
    from the sources; the rebuilt file loads."""
    from test_torch_build import _Lib

    path = kernels.library_path("md5")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"truncated")
    loads = []

    def cdll(p):
        loads.append(p)
        if len(loads) == 1:
            raise OSError("invalid ELF header")
        return _Lib(p)

    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    before = _counts()
    lib = kernels.load_library("md5")
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "hit": 0, "miss": 0, "deserialize_error": 1, "stored": 1}
    assert loads == [str(path)] * 2 and len(compiles) == 1 and lib.path == str(path)
    assert path.read_bytes().startswith(b"\x7fELF built from")


def test_load_library_raises_when_the_rebuild_is_refused(lib_env, compiles,  # noqa: F811
                                                         monkeypatch):
    path = kernels.library_path("md5")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"truncated")

    def cdll(p):
        raise OSError("invalid ELF header")

    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    with pytest.raises(OSError, match="invalid ELF"):
        kernels.load_library("md5")
    assert len(compiles) == 1 and "md5" not in kernels._libs
