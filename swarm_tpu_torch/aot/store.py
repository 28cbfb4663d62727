"""Artifact store and breaker-wrapped client of the AOT library cache,
the port of ``swarm_tpu/aot/store.py``.

The port's compiled artifacts are its CUDA kernel libraries
(``ops/kernels.py``): each is built once by ``nvcc`` into a file named
by its key. This module ships those files through the same state/blob
role pair as the result tier (``cache/tier.py``), under the reference's
``swarm:aot`` namespace and its epoch and fencing-token discipline
(:class:`AotStore` subclasses the tier): payloads (``aot/libcache.py``:
a header, the library's name and key, the sha256 of its bytes, the
bytes) live in the BLOB store; the state store holds a small JSON index
entry per artifact, so a joining worker can enumerate what is published
for its program group without reading a blob. A joining worker then
FETCHES its libraries instead of running ``nvcc``.

Key schema: every artifact digest is sha256 over

- the **program group**: the kernel sources' salt
  (:func:`kernel_code_salt`: ``ops/csrc/*.cu`` and ``ops/kernels.py``,
  which holds the nvcc flags) and the toolchain
  (:func:`toolchain_fingerprint`: torch and its CUDA, the card's
  capability, ``nvcc --version``), so a library built from other
  sources or by another toolchain never loads;
- the **kernel id**, here the library's name, and the **salt**, here
  its :func:`~swarm_tpu_torch.ops.kernels.library_key`;
- the static args and the aval signature of the reference's digest,
  both ``""``: the libraries are shape-free, every shape class of the
  match runs the same library, so one artifact a library serves every
  batch shape and every corpus.

``bump_epoch`` moves every reader and writer to a fresh namespace, the
operator's lever against a poisoned artifact, as on the result tier.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import time
from typing import Optional

from swarm_tpu_torch.cache.tier import SharedResultTier, _process_token
from swarm_tpu_torch.telemetry.aot_export import (
    AOT_ARTIFACT_BYTES,
    AOT_BRINGUP_SECONDS,
    AOT_FETCHES,
    AOT_PUBLISHES,
)

#: wire format version: salts every digest; the payload carries its own
#: header (``aot/libcache.py``)
_FORMAT = b"swarm-aot-v1"


def _kernel_files() -> list:
    """The kernel sources whose bytes salt the program group, relative
    to the ``swarm_tpu_torch`` package directory: every CUDA source
    under ``ops/csrc`` and ``ops/kernels.py`` (the nvcc flags, the
    bindings)."""
    import pathlib

    pkg = pathlib.Path(__file__).resolve().parent.parent
    sources = sorted(p.relative_to(pkg).as_posix() for p in (pkg / "ops" / "csrc").glob("*.cu"))
    return [*sources, "ops/kernels.py"]


def kernel_code_salt() -> str:
    """sha256 hex over the kernel source files, names and bytes: the
    "same sources" half of the program group."""
    import pathlib

    h = hashlib.sha256(_FORMAT)
    pkg = pathlib.Path(__file__).resolve().parent.parent
    for name in _kernel_files():
        h.update(name.encode())
        try:
            h.update((pkg / name).read_bytes())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def toolchain_fingerprint() -> str:
    """The toolchain a library is only valid under: the torch version
    and the CUDA it was built for, the card's compute capability and
    ``nvcc --version``. A library is a compiled binary for one
    architecture; the fingerprint rides the digest, so a mismatch is a
    clean miss."""
    import torch

    from swarm_tpu_torch.ops import kernels

    return "|".join(
        (
            torch.__version__,
            str(torch.version.cuda),
            "sm_{}{}".format(*kernels._device_capability()),
            kernels._nvcc_version(),
        )
    )


class AotStore(SharedResultTier):
    """Artifact store over the state/blob role pair — the result
    tier's epoch + fencing plumbing (inherited) with an artifact data
    plane: payloads in the blob store, JSON index entries in the state
    hash ``{prefix}:x:{epoch}``, blob keys ``aot/{epoch}/{digest}``."""

    _INDEX_FAMILY = "x"

    def __init__(self, state, blobs, prefix: str = "swarm:aot"):
        if blobs is None:
            raise ValueError("AotStore needs a blob store for payloads")
        super().__init__(state, blobs, prefix=prefix)

    def _index_name(self, epoch: str) -> str:
        return self._hash_name(self._INDEX_FAMILY, epoch)

    def _artifact_key(self, epoch: str, digest: str) -> str:
        return f"aot/{epoch}/{digest}"

    def list_index(self, epoch: str) -> dict:
        """digest → raw JSON index entry for every published artifact
        in one epoch namespace (the prewarm enumeration — one hgetall,
        no blob traffic)."""
        return self._state.hgetall(self._index_name(epoch))

    def get_artifact(
        self, epoch: str, digest: str
    ) -> Optional[tuple[str, bytes]]:
        """→ (index entry, payload bytes) or None. A live index entry
        whose blob vanished is a miss (same rule as the tier's spilled
        values)."""
        meta = self._state.hget(self._index_name(epoch), digest)
        if meta is None:
            return None
        try:
            payload = self._blobs.get(self._artifact_key(epoch, digest))
        except Exception:
            return None
        return meta, payload

    # pairs: writer_token / _blobs.put; pairs: writer_token / _state.hset (fence re-check)
    def put_artifact(
        self, epoch: str, digest: str, meta: str, payload: bytes,
        writer_id: str, token: int,
    ) -> str:
        """Publish one artifact under the writer's fencing token —
        checked BEFORE the write (stale-writer reject) and AGAIN after
        it (a writer superseded mid-write learns it was fenced). The
        payload blob lands before the index entry, so a reader can
        never see an index entry whose blob is still in flight; the
        mid-write bytes are not unwound: within an epoch an artifact is
        a pure function of its digest, so a superseded same-epoch
        writer's bytes are identical to the live successor's."""
        if self.writer_token(writer_id) != token:
            return "fenced"
        self._blobs.put(self._artifact_key(epoch, digest), payload)
        self._state.hset(self._index_name(epoch), digest, meta)
        if self.writer_token(writer_id) != token:
            return "fenced"
        return "stored"


class AotClient:
    """A worker's view of the artifact store: epoch-bound, breaker-
    wrapped, telemetry-counted — the contract of the result tier's
    client: a dead or slow backend trips the breaker and every lookup
    degrades to "compile locally", it never blocks. The fault points
    ``aot.fetch`` (details ``epoch`` / ``index`` / ``artifact``) and
    ``aot.put`` inject that failure.

    Fetched libraries live in a process-wide **pool** (digest → the
    keyed library file, written and checked): :meth:`prewarm` fills it
    from the store index at bring-up, and the kernel loader
    (``ops/kernels.py`` ``load_library``) consults it before touching
    the store; a keyed file already on this host's disk joins the pool
    as it is found (:meth:`pool_local`).

    Thread contract: the libraries load in parallel (one lock a library
    in the loader), and prewarm runs at bring-up — the pool and counters
    sit under ``_lock``.
    """

    #: pool bound: dict order is insertion order, the oldest entries
    #: drop past the cap (an evicted library re-fetches if it comes back)
    _POOL_MAX = 128

    def __init__(
        self,
        store: AotStore,
        worker_id: str = "worker",
        publish: bool = True,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
    ):
        from swarm_tpu_torch.resilience.breaker import CircuitBreaker

        self._store = store
        self._worker_id = worker_id
        self.publish_enabled = bool(publish)
        self._breaker = CircuitBreaker(
            f"aot.store.{worker_id}",
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
        )
        self._lock = threading.Lock()  # guards: _pool (reads), _counters, _group, _epoch, _epoch_read_at, _warned
        self._pool: dict = {}
        self._counters = {
            "fetch_hits": 0,
            "fetch_misses": 0,
            "deserialize_errors": 0,
            "published": 0,
            "publish_fenced": 0,
            "prewarmed": 0,
        }
        self._group: Optional[str] = None
        self._epoch: Optional[str] = None
        self._epoch_read_at = 0.0
        self._warned = False

    # -- identity ------------------------------------------------------
    #: how long a read epoch is trusted before the generation counter
    #: is re-read — the propagation ceiling for an operator
    #: ``bump_epoch`` on a live fleet
    _EPOCH_TTL_S = 60.0

    def group(self) -> str:
        """The program group digest (code salt + toolchain) — computed
        once; everything published/fetched by this process lives under
        it."""
        with self._lock:
            if self._group is None:
                h = hashlib.sha256(_FORMAT)
                h.update(kernel_code_salt().encode())
                h.update(toolchain_fingerprint().encode())
                self._group = h.hexdigest()[:24]
            return self._group

    def key_digest(self, kernel_id: str, salt: str, static_repr: str,
                   aval_sig: str) -> str:
        """The full artifact digest for one (kernel, statics, shapes)
        triple under this process's program group; the loader passes a
        library's name, its key and two empty strings."""
        h = hashlib.sha256(_FORMAT)
        for part in (self.group(), kernel_id, salt, static_repr, aval_sig):
            h.update(part.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def _epoch_name(self) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            if (
                self._epoch is not None
                and now - self._epoch_read_at < self._EPOCH_TTL_S
            ):
                return self._epoch
        gen = self._guarded(
            "aot.fetch", "epoch", self._store.epoch_generation
        )
        with self._lock:
            if gen is None:
                return self._epoch  # stale-by-≤TTL or None: degrade
            self._epoch = f"g{gen}"
            self._epoch_read_at = now
            return self._epoch

    # -- breaker plumbing ---------------------------------------------
    # may-block: wraps one artifact-store op behind the breaker
    def _guarded(self, point: str, detail: str, fn):
        from swarm_tpu_torch.resilience.faults import fault_point

        br = self._breaker
        if not br.allow():
            return None
        try:
            fault_point(point, detail=detail)
            out = fn()
        except Exception as e:
            br.record_failure()
            with self._lock:
                warn = not self._warned
                self._warned = True
            if warn:
                print(
                    f"AOT executable cache degraded to compile-only "
                    f"({type(e).__name__}: {e}) "
                    f"[breaker {br.name}: {br.state}]"
                )
            return None
        br.record_success()
        with self._lock:
            self._warned = False
        return out

    # requires-lock: _lock (every caller inserts under the lock)
    def _pool_put(self, digest: str, loaded) -> None:
        self._pool.pop(digest, None)
        while len(self._pool) >= self._POOL_MAX:
            self._pool.pop(next(iter(self._pool)))
        self._pool[digest] = loaded

    def pool_local(self, digest: str, path) -> None:
        """Pool a keyed library file found on this host's disk (built or
        fetched by an earlier process): the loader's next
        :meth:`fetch_loaded` is then a pool hit with no store traffic."""
        with self._lock:
            if digest not in self._pool:
                self._pool_put(digest, path)

    def drop(self, digest: str) -> None:
        """A pooled library that ``ctypes`` refused: count it as a
        ``deserialize_error`` and forget it (the loader rebuilds it)."""
        with self._lock:
            self._pool.pop(digest, None)
            self._counters["deserialize_errors"] += 1
        AOT_FETCHES.labels(outcome="deserialize_error").inc(1)

    # -- fetch path ----------------------------------------------------
    def fetch_loaded(self, digest: str):
        """→ the keyed library file for ``digest``, or None (miss /
        degraded / a refused payload — the caller compiles). Pool hits
        never touch the store; store hits are checked and written here
        and pooled for any later load."""
        with self._lock:
            loaded = self._pool.get(digest)
            if loaded is not None:
                self._counters["fetch_hits"] += 1
        if loaded is not None:
            AOT_FETCHES.labels(outcome="hit").inc(1)
            return loaded
        epoch = self._epoch_name()
        if epoch is None:
            return None
        got = self._guarded(
            "aot.fetch", "artifact",
            lambda: self._store.get_artifact(epoch, digest),
        )
        if got is None:
            with self._lock:
                self._counters["fetch_misses"] += 1
            AOT_FETCHES.labels(outcome="miss").inc(1)
            return None
        _meta, payload = got
        t0 = time.perf_counter()
        loaded = self._load_payload(payload)
        if loaded is None:
            with self._lock:
                self._counters["deserialize_errors"] += 1
            AOT_FETCHES.labels(outcome="deserialize_error").inc(1)
            return None
        AOT_BRINGUP_SECONDS.labels(source="fetch").observe(
            time.perf_counter() - t0
        )
        AOT_ARTIFACT_BYTES.set(len(payload))
        with self._lock:
            self._counters["fetch_hits"] += 1
            self._pool_put(digest, loaded)
        AOT_FETCHES.labels(outcome="hit").inc(1)
        return loaded

    def _load_payload(self, payload: bytes):
        """Check one payload and write its library under its keyed path
        → that path; None on ANY failure (bad header, another key, a
        wrong sha256, a truncated blob) — a bad artifact must cost a
        compile, never an exception on the load path. Nothing is written
        unless every check passes."""
        from swarm_tpu_torch.aot.libcache import load_payload

        try:
            return load_payload(payload)
        except Exception:
            return None

    def _load_verify(self, payload: bytes) -> None:
        """Raise if ``payload`` does not check out in this process (the
        publish gate; nothing is written)."""
        from swarm_tpu_torch.aot.libcache import decode_payload

        decode_payload(payload)

    def note_compile_seconds(self, seconds: float) -> None:
        """Record a local compile on the AOT-managed path (the miss
        arm of the bring-up histogram)."""
        AOT_BRINGUP_SECONDS.labels(source="compile").observe(seconds)

    # -- publish path --------------------------------------------------
    def publish(self, digest: str, meta: dict, compiled) -> str:
        """Serialize + publish one locally built library (``compiled``:
        its name; its keyed file must exist). Returns the outcome
        (``stored`` / ``fenced`` / ``error`` / ``disabled``); failures
        are counted and swallowed — publishing is strictly
        best-effort."""
        import json

        from swarm_tpu_torch.aot.libcache import serialize_library
        from swarm_tpu_torch.ops.kernels import library_path

        if not self.publish_enabled:
            return "disabled"
        epoch = self._epoch_name()
        if epoch is None:
            AOT_PUBLISHES.labels(outcome="error").inc(1)
            return "error"
        try:
            payload = serialize_library(compiled)
            # round-trip verification: a payload that does not check
            # out HERE would poison the store with deserialize_error
            # misses for every joining worker
            self._load_verify(payload)
        except Exception:
            AOT_PUBLISHES.labels(outcome="error").inc(1)
            return "error"
        meta = dict(meta)
        meta["g"] = self.group()
        meta["n"] = len(payload)
        writer = f"{self._worker_id}:aot"
        body = json.dumps(meta, separators=(",", ":"))

        def put():
            token = _process_token(self._store, writer)
            return self._store.put_artifact(
                epoch, digest, body, payload, writer, token
            )

        out = self._guarded("aot.put", "artifact", put)
        if out is None:
            AOT_PUBLISHES.labels(outcome="error").inc(1)
            return "error"
        with self._lock:
            if out == "stored":
                self._counters["published"] += 1
            else:
                self._counters["publish_fenced"] += 1
            # the built file IS the loaded form — pool it so a later
            # load in this process finds it without the store
            self._pool_put(digest, library_path(compiled))
        AOT_PUBLISHES.labels(outcome=out).inc(1)
        AOT_ARTIFACT_BYTES.set(len(payload))
        return out

    # -- bring-up ------------------------------------------------------
    def prewarm(self) -> int:
        """Fetch every library published for this process's program
        group, check it and write it under its keyed path (worker
        bring-up: fetch INSTEAD of compiling). Artifacts that fail their
        checks are counted and skipped; a dead store prewarms nothing.
        Returns the number of libraries now pooled."""
        import json

        epoch = self._epoch_name()
        if epoch is None:
            return 0
        index = self._guarded(
            "aot.fetch", "index", lambda: self._store.list_index(epoch)
        )
        if not index:
            return 0
        group = self.group()
        n = 0
        for digest, raw in index.items():
            try:
                meta = json.loads(raw)
            except ValueError:
                continue
            if meta.get("g") != group:
                continue
            with self._lock:
                if digest in self._pool:
                    n += 1
                    continue
            got = self._guarded(
                "aot.fetch", "artifact",
                lambda d=digest: self._store.get_artifact(epoch, d),
            )
            if got is None:
                continue
            t0 = time.perf_counter()
            loaded = self._load_payload(got[1])
            if loaded is None:
                with self._lock:
                    self._counters["deserialize_errors"] += 1
                AOT_FETCHES.labels(outcome="deserialize_error").inc(1)
                continue
            AOT_BRINGUP_SECONDS.labels(source="fetch").observe(
                time.perf_counter() - t0
            )
            with self._lock:
                self._pool_put(digest, loaded)
                self._counters["prewarmed"] += 1
            n += 1
        return n

    def counters(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["pool"] = len(self._pool)
            out["breaker"] = self._breaker.state
            return out


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

_FACTORY_LOCK = threading.Lock()
_MEMORY_STORE: Optional[AotStore] = None  # guarded-by: _FACTORY_LOCK (reads)
#: one store object per backend location in this process — the fencing
#: registry is keyed per store OBJECT (cache.tier._process_token), so
#: same-identity clients must share the instance
_SHARED_STORES: dict = {}  # guarded-by: _FACTORY_LOCK (reads)


def _memory_store() -> AotStore:
    global _MEMORY_STORE
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryStateStore

    with _FACTORY_LOCK:
        if _MEMORY_STORE is None:
            _MEMORY_STORE = AotStore(MemoryStateStore(), MemoryBlobStore())
        return _MEMORY_STORE


def _local_store(root: str) -> AotStore:
    from swarm_tpu_torch.stores import LocalBlobStore, LocalStateStore

    with _FACTORY_LOCK:
        store = _SHARED_STORES.get(("local", root))
        if store is None:
            store = _SHARED_STORES[("local", root)] = AotStore(
                LocalStateStore(f"{root}/state"),
                LocalBlobStore(f"{root}/blobs"),
            )
        return store


def _redis_store(url: str, blob_dir: str, s3_bucket: str) -> AotStore:
    from swarm_tpu_torch.stores import (
        LocalBlobStore,
        RedisStateStore,
        S3BlobStore,
    )

    with _FACTORY_LOCK:
        key = ("redis", url, blob_dir, s3_bucket)
        store = _SHARED_STORES.get(key)
        if store is None:
            if s3_bucket:
                blobs = S3BlobStore(s3_bucket)
            else:
                blobs = LocalBlobStore(
                    blob_dir or os.path.join(tempfile.gettempdir(), "swarm_aot_blobs"))
            store = _SHARED_STORES[key] = AotStore(
                RedisStateStore(url), blobs
            )
        return store


def build_aot_client(cfg) -> Optional[AotClient]:
    """Construct the AOT client from a config (the worker's
    ``WorkerConfig``, ``SWARM_AOT_*``); None when the cache is off.

    Backends: ``memory`` (per-process, tests), ``local`` (file-backed
    under ``aot_dir`` — cross-process on one host with zero side-cars),
    ``redis`` (fleet-wide: state via ``aot_url``/``redis_url``, payload
    blobs via the S3 role when ``s3_bucket`` is set, else a shared
    directory)."""
    backend = (getattr(cfg, "aot_backend", "off") or "off").lower()
    if backend in ("off", "", "0", "none", "false"):
        return None
    if backend == "memory":
        store = _memory_store()
    elif backend == "local":
        root = getattr(cfg, "aot_dir", "") or os.path.join(tempfile.gettempdir(), "swarm_aot")
        store = _local_store(root)
    elif backend == "redis":
        store = _redis_store(
            getattr(cfg, "aot_url", "") or cfg.redis_url,
            getattr(cfg, "aot_dir", ""),
            getattr(cfg, "s3_bucket", ""),
        )
    else:
        raise ValueError(f"unknown aot_backend {backend!r}")
    return AotClient(
        store,
        worker_id=getattr(cfg, "worker_id", "worker"),
        publish=getattr(cfg, "aot_publish", True),
        breaker_threshold=getattr(cfg, "aot_breaker_threshold", 3),
        breaker_cooldown_s=getattr(cfg, "aot_breaker_cooldown_s", 30.0),
    )
