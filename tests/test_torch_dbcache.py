"""The port's corpus-compile cache (``swarm_tpu_torch.fingerprints.dbcache``)
against the JAX package's.

Cold, warm and corrupted entries behave as the reference's do, and the
two packages pointed at one ``SWARM_DB_CACHE_DIR`` never load (or
evict) each other's entries: a JAX ``CompiledDB`` pickle would import
the JAX package into the port.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from swarm_tpu.fingerprints import dbcache as j_dbcache
from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import compile as j_compile_mod
from swarm_tpu.fingerprints.compile import compile_corpus as j_compile
from swarm_tpu_torch.fingerprints import dbcache as t_dbcache
from swarm_tpu_torch.fingerprints.compile import CompiledDB
from swarm_tpu_torch.fingerprints import compile as t_compile
from test_match_parity import DATA
from test_torch_worker import REPO


@pytest.fixture
def corpus(tmp_path):
    root = tmp_path / "corpus"
    shutil.copytree(DATA / "http", root / "http")
    return root


@pytest.fixture
def cache(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", str(d))
    return d


def counting(monkeypatch, module, name="compile_corpus"):
    """Count the compiles ``module``'s ``load_or_compile`` runs."""
    calls = []
    real = getattr(module, name)

    def spy(templates):
        calls.append(len(templates))
        return real(templates)

    monkeypatch.setattr(module, name, spy)
    return calls


def same_db(a, b) -> bool:
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
    return a.template_ids == b.template_ids


def test_cold_then_warm(corpus, cache, monkeypatch):
    calls = counting(monkeypatch, t_compile)
    templates, db = t_dbcache.load_or_compile(corpus)
    assert calls == [len(templates)]
    [entry] = cache.glob("*.pkl")
    assert entry.name.startswith("swarm_tpu_torch-" + t_dbcache.path_tag(corpus) + "-")
    templates2, db2 = t_dbcache.load_or_compile(corpus)
    assert calls == [len(templates)]  # served from the cache
    assert isinstance(db2, CompiledDB) and same_db(db, db2)
    assert [t.id for t in templates2] == [t.id for t in templates]
    assert same_db(db2, t_compile.compile_corpus(templates))


def test_corrupted_entry_recompiles(corpus, cache, monkeypatch):
    calls = counting(monkeypatch, t_compile)
    t_dbcache.load_or_compile(corpus)
    [entry] = cache.glob("*.pkl")
    entry.write_bytes(b"not a pickle")
    _templates, db = t_dbcache.load_or_compile(corpus)
    assert len(calls) == 2 and isinstance(db, CompiledDB)
    [again] = cache.glob("*.pkl")
    assert again.name == entry.name and again.read_bytes() != b"not a pickle"


def test_changed_corpus_evicts_the_stale_entry(corpus, cache, monkeypatch):
    calls = counting(monkeypatch, t_compile)
    t_dbcache.load_or_compile(corpus)
    [old] = cache.glob("*.pkl")
    (corpus / "http" / "demo-panel.yaml").unlink()
    templates, _db = t_dbcache.load_or_compile(corpus)
    [new] = cache.glob("*.pkl")
    assert len(calls) == 2 and new.name != old.name
    assert "demo-panel" not in {t.id for t in templates}


def test_disabled_cache_always_compiles(corpus, monkeypatch):
    monkeypatch.setenv("SWARM_DB_CACHE_DIR", "")
    calls = counting(monkeypatch, t_compile)
    t_dbcache.load_or_compile(corpus)
    t_dbcache.load_or_compile(corpus)
    assert len(calls) == 2


def test_default_directory_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.delenv("SWARM_DB_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert t_dbcache._cache_dir() == tmp_path / ".cache" / "swarm_tpu_torch" / "db"
    assert j_dbcache.DEFAULT_CACHE_DIR != t_dbcache.DEFAULT_CACHE_DIR


def test_the_salt_is_the_ports_own_compiler():
    here = REPO / "swarm_tpu_torch" / "fingerprints"
    assert t_dbcache._CODE_FILES == j_dbcache._CODE_FILES
    assert all((here / f).resolve().is_file() for f in t_dbcache._CODE_FILES)
    material = b"corpus"
    assert t_dbcache._entry_key(material) != j_dbcache._entry_key(material)


def test_shared_directory_never_crosses(corpus, cache, monkeypatch):
    """Both packages cache one corpus in one directory: each builds its
    own entry once, serves only its own, and neither publish evicts the
    other's."""
    t_calls = counting(monkeypatch, t_compile)
    j_calls = counting(monkeypatch, j_compile_mod)
    j_dbcache.load_or_compile(corpus)
    _t, t_db = t_dbcache.load_or_compile(corpus)
    _j, j_db = j_dbcache.load_or_compile(corpus)
    _t2, t_db2 = t_dbcache.load_or_compile(corpus)
    assert len(t_calls) == 1 and len(j_calls) == 1
    assert type(t_db2).__module__ == "swarm_tpu_torch.fingerprints.compile"
    assert type(j_db).__module__ == "swarm_tpu.fingerprints.compile"
    entries = sorted(p.name for p in cache.glob("*.pkl"))
    assert len(entries) == 2
    assert sum(e.startswith("swarm_tpu_torch-") for e in entries) == 1


def test_a_jax_entry_under_the_ports_name_is_refused(corpus, cache, monkeypatch):
    """Even a JAX ``CompiledDB`` pickle planted under the port's exact
    file name is refused (and replaced), never unpickled into the
    port."""
    calls = counting(monkeypatch, t_compile)
    t_dbcache.load_or_compile(corpus)
    [entry] = cache.glob("*.pkl")
    templates, _ = j_load_corpus(corpus)
    entry.write_bytes(pickle.dumps((templates, j_compile(templates))))
    _t, db = t_dbcache.load_or_compile(corpus)
    assert len(calls) == 2
    assert type(db).__module__ == "swarm_tpu_torch.fingerprints.compile"
    with open(entry, "rb") as fh:
        assert pickle.load(fh)[1].__class__.__module__ == "swarm_tpu_torch.fingerprints.compile"


def test_warm_load_imports_no_jax_package(corpus, cache):
    """A fresh interpreter serving the port's warm entry from the shared
    directory imports neither JAX nor the JAX package."""
    j_dbcache.load_or_compile(corpus)
    t_dbcache.load_or_compile(corpus)
    code = (
        "import sys; from swarm_tpu_torch.fingerprints import dbcache;"
        f" t, db = dbcache.load_or_compile({str(corpus)!r});"
        " bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'swarm_tpu')];"
        " print(len(t), type(db).__module__, bad)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "SWARM_DB_CACHE_DIR": str(cache)})
    assert out.returncode == 0, out.stderr
    n, mod, bad = out.stdout.split(" ", 2)
    assert int(n) == len(j_load_corpus(corpus)[0])
    assert mod == "swarm_tpu_torch.fingerprints.compile" and bad.strip() == "[]"
