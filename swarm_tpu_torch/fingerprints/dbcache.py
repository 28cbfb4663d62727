"""Corpus-compile cache of the port: parsed templates + CompiledDB on disk.

The port of ``swarm_tpu/fingerprints/dbcache.py``. Compiling a full
corpus (3,989 YAML templates, or the 12,331 signatures of the
production service-probes DB) costs seconds of pure Python per process;
a warm worker loads one pickle instead.

The cache key covers the corpus contents (every template file's path,
size, mtime) AND the port's own compiler source bytes, so editing
either the templates or the lowering code invalidates cleanly. Entries
are pickles written atomically under ``~/.cache/swarm_tpu_torch/db``
(override: ``SWARM_DB_CACHE_DIR``; empty disables).

The JAX package keeps the same kind of entries, pickles of ITS
``CompiledDB``, and may be pointed at the same directory. Loading one
of them here would import that package, so the two never share an
entry: every file name of the port starts with :data:`PACKAGE`, its key
is salted with the package name and the port's compiler sources, a
publish evicts only the port's own stale siblings, and the unpickler
refuses any class of the JAX package (a refused entry counts as corrupt:
it is dropped and recompiled).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from pathlib import Path
from typing import Optional

PACKAGE = "swarm_tpu_torch"
DEFAULT_CACHE_DIR = f"~/.cache/{PACKAGE}/db"
_FORMAT_VERSION = 1

# compiler source files whose bytes salt the key: a lowering change must
# never serve stale compiled DBs. compile.py bakes tables from
# ops/hashing.py (gram hashes, blooms) and ops/encoding.py (stream
# layout) into the CompiledDB, so those salt the key too.
_CODE_FILES = (
    "compile.py",
    "nuclei.py",
    "model.py",
    "regexlin.py",
    "dslc.py",
    "../ops/hashing.py",
    "../ops/encoding.py",
    # the service classifier's template construction (_inline_flags,
    # Matcher wiring) feeds the svcdb entries — a lowering change there
    # must invalidate them too
    "../ops/service.py",
)

#: top-level modules whose classes an entry may never name
_FOREIGN_ROOTS = ("swarm_tpu", "jax", "jaxlib")


def _code_salt() -> bytes:
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    for name in _CODE_FILES:
        try:
            h.update(name.encode())
            h.update((here / name).read_bytes())
        except OSError:
            h.update(b"?")
    return h.digest()


def _corpus_material(templates_dir: str | Path) -> bytes:
    """The corpus tree's identity bytes (path, size, mtime per file)."""
    root = Path(templates_dir)
    entries = sorted(
        p for p in root.rglob("*")
        if p.is_file() and p.suffix in (".yaml", ".yml", ".txt")
    )
    lines = []
    for p in entries:
        st = p.stat()
        lines.append(
            f"{p.relative_to(root)}|{st.st_size}|{st.st_mtime_ns}\n"
        )
    return "".join(lines).encode()


def _entry_key(key_material: bytes) -> str:
    h = hashlib.sha256()
    h.update(b"v%d|" % _FORMAT_VERSION)
    h.update(PACKAGE.encode() + b"|")
    h.update(_code_salt())
    h.update(key_material)
    return h.hexdigest()


def corpus_key(templates_dir: str | Path) -> str:
    """Stable key over the corpus tree + compiler version."""
    return _entry_key(_corpus_material(templates_dir))


def _cache_dir() -> Optional[Path]:
    raw = os.environ.get("SWARM_DB_CACHE_DIR", DEFAULT_CACHE_DIR)
    if not raw:
        return None
    path = Path(raw).expanduser()
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    return path


class _PortUnpickler(pickle.Unpickler):
    """An unpickler that refuses the JAX package's classes (and JAX's)."""

    def find_class(self, module: str, name: str):
        if module.split(".", 1)[0] in _FOREIGN_ROOTS:
            raise pickle.UnpicklingError(f"foreign class {module}.{name}")
        return super().find_class(module, name)


def load_or_compile_keyed(tag: str, key_material: bytes, build):
    """Generic cached compile: ``tag`` groups entries (stale siblings
    under the SAME tag are evicted on publish — derive it from the
    artifact's identity, e.g. its path hash, so distinct DBs coexist),
    ``key_material`` + the compiler-source salt key them, ``build()``
    produces the picklable value. Used by load_or_compile and by the
    service classifier to bound the 12k-signature DB compile (~19 s
    cold) to one pickle load warm."""
    cache = _cache_dir()
    if cache is None:
        return build()
    group = f"{PACKAGE}-{tag}"
    key = _entry_key(key_material)
    entry = cache / f"{group}-{key}.pkl"
    if entry.is_file():
        try:
            with open(entry, "rb") as fh:
                return _PortUnpickler(fh).load()
        except Exception:
            try:
                entry.unlink()
            except OSError:
                pass
    value = build()
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(dir=cache, suffix=".tmp")
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(value, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, entry)
        tmp = None
        for stale in cache.glob(f"{group}-*.pkl"):
            if stale.name != entry.name:
                stale.unlink(missing_ok=True)
    except Exception:
        pass
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return value


def path_tag(path: str | Path) -> str:
    """Entry-group tag from an artifact's resolved path: groups the
    cache entries per location so publishing a new key evicts the
    stale siblings (the mtime-sensitive key would otherwise mint an
    immortal multi-MB pickle per checkout/touch), while distinct
    locations coexist."""
    return hashlib.sha256(
        str(Path(path).resolve()).encode()
    ).hexdigest()[:16]


def load_or_compile(templates_dir: str | Path):
    """→ (templates, CompiledDB), served from the disk cache when the
    corpus+compiler key matches; compiled (and cached) otherwise."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus

    def build():
        templates, _errors = load_corpus(templates_dir)
        return templates, compile_corpus(templates)

    return load_or_compile_keyed(
        path_tag(templates_dir), _corpus_material(templates_dir), build
    )
