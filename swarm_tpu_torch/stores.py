"""State, blob and document stores behind narrow interfaces, the port
of ``swarm_tpu/stores.py``.

Three roles, with the reference's key layouts so the data is
wire-compatible: Redis for queue and state, S3 for chunk blobs, MongoDB
for durable summaries. Each sits behind a small interface with embedded
defaults (thread-safe, no external dependency) and adapters for the
real services, whose client libraries (``redis``, ``boto3``,
``pymongo``) are imported inside the adapter that uses them, so the
module imports without them.

The port's worker uses the state and blob roles through the shared
result tier (``swarm_tpu_torch/cache``): the embedded stores make a
one-host fleet's tier work with no side-car, Redis makes it fleet-wide.
The port's queue (``swarm_tpu_torch/server/queue.py``) takes all three
roles; :func:`build_stores` makes them from a ``Config`` for the server
layer.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from pathlib import Path
from typing import Any, Iterable, Optional


# ---------------------------------------------------------------------------
# State store (Redis-role): hashes + lists, the five ops the server uses.
# ---------------------------------------------------------------------------


class StateStore:
    """Subset of Redis semantics used by the control plane.

    Key names carried over verbatim from the reference so a real Redis
    populated by this server is indistinguishable on the wire: ``jobs`` /
    ``workers`` hashes, ``job_queue`` / ``completed`` lists
    (``server/server.py:207,214,326,475``).
    """

    def hset(self, name: str, key: str, value: str) -> None:
        raise NotImplementedError

    def hget(self, name: str, key: str) -> Optional[str]:
        raise NotImplementedError

    def hmget(self, name: str, keys: list[str]) -> list[Optional[str]]:
        """Batched hget — ONE wire round trip on backends that support
        it (the result-cache tier's lookup path, docs/CACHING.md). The
        default loops hget, so adapters only override for speed."""
        return [self.hget(name, k) for k in keys]

    def hset_many(self, name: str, mapping: dict[str, str]) -> None:
        """Batched hset — ONE wire round trip on backends that support
        it (the result-cache tier's writeback path: a walked plane's
        worth of entries must not cost one RTT per row). The default
        loops hset, so adapters only override for speed."""
        for key, value in mapping.items():
            self.hset(name, key, value)

    def hincr(self, name: str, key: str, by: int = 1) -> int:
        """Atomically add ``by`` to an integer hash field (missing = 0)
        and return the new value — the fencing-token counter and epoch
        generation of the result-cache tier (docs/CACHING.md). Must be
        atomic WITHIN the backend (Redis HINCRBY; the embedded store's
        read-modify-write runs under its lock)."""
        raise NotImplementedError

    def hkeys(self, name: str) -> list[str]:
        raise NotImplementedError

    def hgetall(self, name: str) -> dict[str, str]:
        raise NotImplementedError

    def hdel(self, name: str, key: str) -> None:
        raise NotImplementedError

    def rpush(self, name: str, value: str) -> None:
        raise NotImplementedError

    def lpush(self, name: str, value: str) -> None:
        raise NotImplementedError

    def lclear(self, name: str) -> None:
        """Drop one list wholesale (Redis ``DEL``). Journal recovery
        (docs/DURABILITY.md) REBUILDS every dispatch list from the
        replayed job records; on a backend whose state survived the
        restart (real Redis) the stale lists must be cleared first or
        the rebuild would double-push every queued job."""
        raise NotImplementedError

    def lpop(self, name: str) -> Optional[str]:
        raise NotImplementedError

    def lrange(self, name: str, start: int, stop: int) -> list[str]:
        raise NotImplementedError

    def llen(self, name: str) -> int:
        raise NotImplementedError

    def flushall(self) -> None:
        raise NotImplementedError


class MemoryStateStore(StateStore):
    """Embedded thread-safe state store (hashes + lists)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()  # guards: _hashes (reads), _lists (reads)
        self._hashes: dict[str, dict[str, str]] = {}
        self._lists: dict[str, deque[str]] = {}

    def hset(self, name, key, value):
        # chaos lever (docs/RESILIENCE.md): a failing state-store write
        # surfaces as a 500 from whatever route attempted it
        from swarm_tpu_torch.resilience.faults import fault_point

        fault_point("store.hset", detail=name)
        with self._lock:
            self._hashes.setdefault(name, {})[key] = value

    def hget(self, name, key):
        with self._lock:
            return self._hashes.get(name, {}).get(key)

    def hmget(self, name, keys):
        with self._lock:
            h = self._hashes.get(name, {})
            return [h.get(k) for k in keys]

    def hset_many(self, name, mapping):
        with self._lock:
            self._hashes.setdefault(name, {}).update(mapping)

    def hincr(self, name, key, by=1):
        with self._lock:
            h = self._hashes.setdefault(name, {})
            value = int(h.get(key, "0")) + int(by)
            h[key] = str(value)
            return value

    def hkeys(self, name):
        with self._lock:
            return list(self._hashes.get(name, {}).keys())

    def hgetall(self, name):
        with self._lock:
            return dict(self._hashes.get(name, {}))

    def hdel(self, name, key):
        with self._lock:
            self._hashes.get(name, {}).pop(key, None)

    def rpush(self, name, value):
        with self._lock:
            self._lists.setdefault(name, deque()).append(value)

    def lpush(self, name, value):
        with self._lock:
            self._lists.setdefault(name, deque()).appendleft(value)

    def lpop(self, name):
        with self._lock:
            q = self._lists.get(name)
            return q.popleft() if q else None

    def lclear(self, name):
        with self._lock:
            self._lists.pop(name, None)

    def lrange(self, name, start, stop):
        with self._lock:
            items = list(self._lists.get(name, ()))
        if stop == -1:
            return items[start:]
        return items[start : stop + 1]

    def llen(self, name):
        with self._lock:
            return len(self._lists.get(name, ()))

    def flushall(self):
        with self._lock:
            self._hashes.clear()
            self._lists.clear()


class RedisStateStore(StateStore):
    """Adapter over a real Redis (requires the ``redis`` package)."""

    def __init__(self, url: str) -> None:
        import redis  # gated: not part of the baked image

        self._r = redis.Redis.from_url(url)

    @staticmethod
    def _d(value: Optional[bytes]) -> Optional[str]:
        return value.decode() if value is not None else None

    def hset(self, name, key, value):
        self._r.hset(name, key, value)

    def hget(self, name, key):
        return self._d(self._r.hget(name, key))

    def hmget(self, name, keys):
        return [self._d(v) for v in self._r.hmget(name, keys)]

    def hset_many(self, name, mapping):
        self._r.hset(name, mapping=mapping)

    def hincr(self, name, key, by=1):
        return int(self._r.hincrby(name, key, by))

    def hkeys(self, name):
        return [k.decode() for k in self._r.hkeys(name)]

    def hgetall(self, name):
        return {k.decode(): v.decode() for k, v in self._r.hgetall(name).items()}

    def hdel(self, name, key):
        self._r.hdel(name, key)

    def rpush(self, name, value):
        self._r.rpush(name, value)

    def lpush(self, name, value):
        self._r.lpush(name, value)

    def lpop(self, name):
        return self._d(self._r.lpop(name))

    def lclear(self, name):
        self._r.delete(name)

    def lrange(self, name, start, stop):
        return [v.decode() for v in self._r.lrange(name, start, stop)]

    def llen(self, name):
        return self._r.llen(name)

    def flushall(self):
        self._r.flushall()


class LocalStateStore(StateStore):
    """File-backed state store: one JSON document per key name under a
    directory, every read-modify-write serialized by an ``fcntl``
    file lock, so MULTIPLE PROCESSES on one host share state with zero
    side-cars. Built for the AOT executable cache's no-sidecar fleet
    mode and the bench's fresh-process cold-start A/B (docs/AOT.md) —
    the hot control plane should still prefer Memory (in-process) or
    Redis (multi-host): every op here costs a file open + lock.

    ``hincr`` is atomic across processes (read-modify-write under the
    exclusive lock), which is what the fencing-token counter and epoch
    generation need.
    """

    def __init__(self, root: str | Path) -> None:
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._lockfile = self._root / ".lock"
        self._thread_lock = threading.Lock()

    def _path(self, name: str) -> Path:
        # flat namespace, filesystem-safe: hex-escape anything outside
        # [A-Za-z0-9._-] so "swarm:aot:x:…" can't traverse or collide
        safe = "".join(
            c if c.isalnum() or c in "._-" else f"%{ord(c):02x}"
            for c in name
        )
        return self._root / (safe + ".json")

    class _Locked:
        def __init__(self, store: "LocalStateStore"):
            self._store = store
            self._fh = None

        def __enter__(self):
            import fcntl

            self._store._thread_lock.acquire()
            try:
                self._fh = open(self._store._lockfile, "a+")
                fcntl.flock(self._fh, fcntl.LOCK_EX)
            except BaseException:
                # a failed open/flock (fd exhaustion, removed root)
                # must release the thread lock — __exit__ never runs
                # when __enter__ raises, and a stuck lock would hang
                # every later store op in the process instead of
                # letting the caller's breaker degrade
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                self._store._thread_lock.release()
                raise
            return self

        def __exit__(self, *exc):
            import fcntl

            fcntl.flock(self._fh, fcntl.LOCK_UN)
            self._fh.close()
            self._store._thread_lock.release()
            return False

    def _load(self, name: str) -> dict:
        try:
            return json.loads(self._path(name).read_text())
        except (OSError, ValueError):
            return {"h": {}, "l": []}

    def _save(self, name: str, doc: dict) -> None:
        p = self._path(name)
        tmp = p.with_name(p.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(doc, separators=(",", ":")))
        os.replace(tmp, p)  # crash-atomic, same as LocalBlobStore.put

    def hset(self, name, key, value):
        from swarm_tpu_torch.resilience.faults import fault_point

        fault_point("store.hset", detail=name)
        with self._Locked(self):
            doc = self._load(name)
            doc["h"][key] = value
            self._save(name, doc)

    def hget(self, name, key):
        with self._Locked(self):
            return self._load(name)["h"].get(key)

    def hmget(self, name, keys):
        with self._Locked(self):
            h = self._load(name)["h"]
            return [h.get(k) for k in keys]

    def hset_many(self, name, mapping):
        with self._Locked(self):
            doc = self._load(name)
            doc["h"].update(mapping)
            self._save(name, doc)

    def hincr(self, name, key, by=1):
        with self._Locked(self):
            doc = self._load(name)
            value = int(doc["h"].get(key, "0")) + int(by)
            doc["h"][key] = str(value)
            self._save(name, doc)
            return value

    def hkeys(self, name):
        with self._Locked(self):
            return list(self._load(name)["h"].keys())

    def hgetall(self, name):
        with self._Locked(self):
            return dict(self._load(name)["h"])

    def hdel(self, name, key):
        with self._Locked(self):
            doc = self._load(name)
            if key in doc["h"]:
                del doc["h"][key]
                self._save(name, doc)

    def rpush(self, name, value):
        with self._Locked(self):
            doc = self._load(name)
            doc["l"].append(value)
            self._save(name, doc)

    def lpush(self, name, value):
        with self._Locked(self):
            doc = self._load(name)
            doc["l"].insert(0, value)
            self._save(name, doc)

    def lpop(self, name):
        with self._Locked(self):
            doc = self._load(name)
            if not doc["l"]:
                return None
            value = doc["l"].pop(0)
            self._save(name, doc)
            return value

    def lclear(self, name):
        with self._Locked(self):
            doc = self._load(name)
            if doc["l"]:
                doc["l"] = []
                self._save(name, doc)

    def lrange(self, name, start, stop):
        with self._Locked(self):
            items = list(self._load(name)["l"])
        if stop == -1:
            return items[start:]
        return items[start : stop + 1]

    def llen(self, name):
        with self._Locked(self):
            return len(self._load(name)["l"])

    def flushall(self):
        with self._Locked(self):
            for p in self._root.glob("*.json"):
                if ".tmp-" not in p.name:
                    p.unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# Blob store (S3-role): chunk input/output files.
# ---------------------------------------------------------------------------


class BlobStore:
    """Key layout matches the reference S3 bucket:
    ``{scan_id}/input/chunk_{i}.txt`` and ``{scan_id}/output/chunk_{i}.txt``
    (``server/server.py:446``, ``worker/worker.py:71,96``).
    """

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove one blob (missing keys are a no-op — journal
        compaction and reset may race a crash-recovery's leftovers)."""
        raise NotImplementedError

    def delete_all(self) -> None:
        raise NotImplementedError


class LocalBlobStore(BlobStore):
    """Directory-backed blob store (the embedded default)."""

    def __init__(self, root: str | Path) -> None:
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> Path:
        p = (self._root / key).resolve()
        if not p.is_relative_to(self._root.resolve()):
            raise ValueError(f"blob key escapes store root: {key!r}")
        return p

    def put(self, key, data):
        from swarm_tpu_torch.resilience.faults import fault_point

        fault_point("store.blob_put", detail=key)
        p = self._path(key)
        with self._lock:
            p.parent.mkdir(parents=True, exist_ok=True)
            # crash-atomic (docs/DURABILITY.md): a kill -9 mid-write
            # must never leave a truncated chunk or journal segment —
            # recovery reconciles "output blob present ⇒ job complete",
            # so a half blob would become a half result. Same-directory
            # temp + rename is atomic on POSIX.
            tmp = p.with_name(p.name + f".tmp-{os.getpid()}")
            tmp.write_bytes(data)
            os.replace(tmp, p)

    def get(self, key):
        return self._path(key).read_bytes()

    def exists(self, key):
        return self._path(key).is_file()

    def delete(self, key):
        try:
            self._path(key).unlink()
        except FileNotFoundError:
            pass

    def list(self, prefix):
        root = self._root.resolve()
        # Walk only the deepest existing directory implied by the prefix,
        # then string-filter the remainder — not the whole store.
        if not prefix or prefix.endswith("/"):
            base_dir = (root / prefix).resolve()
        else:
            base_dir = (root / prefix).resolve().parent
        if not base_dir.is_relative_to(root):
            base_dir = root
        if not base_dir.is_dir():
            return []
        out = []
        for p in base_dir.rglob("*"):
            if p.is_file() and ".tmp-" not in p.name:
                # in-flight atomic-put temp files are not blobs: a
                # racing list must never hand a half-written key to
                # raw_scan or journal replay
                rel = p.relative_to(root).as_posix()
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete_all(self):
        import shutil

        with self._lock:
            shutil.rmtree(self._root, ignore_errors=True)
            self._root.mkdir(parents=True, exist_ok=True)


class MemoryBlobStore(BlobStore):
    """In-memory blob store for tests."""

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}  # guarded-by: _lock (reads)
        self._lock = threading.Lock()

    def put(self, key, data):
        with self._lock:
            self._blobs[key] = bytes(data)

    def get(self, key):
        with self._lock:
            if key not in self._blobs:
                raise KeyError(key)
            return self._blobs[key]

    def exists(self, key):
        with self._lock:
            return key in self._blobs

    def list(self, prefix):
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def delete(self, key):
        with self._lock:
            self._blobs.pop(key, None)  # blocking-ok: _blobs is the embedded store's own dict — this IS the O(1) store primitive

    def delete_all(self):
        with self._lock:
            self._blobs.clear()  # blocking-ok: embedded store primitive — in-memory dict clear under its own lock


class S3BlobStore(BlobStore):
    """Adapter over real S3 (requires ``boto3``)."""

    def __init__(self, bucket: str, **client_kwargs: Any) -> None:
        import boto3  # gated

        self._bucket = bucket
        self._s3 = boto3.client("s3", **client_kwargs)

    def put(self, key, data):
        self._s3.put_object(Bucket=self._bucket, Key=key, Body=data)

    def get(self, key):
        return self._s3.get_object(Bucket=self._bucket, Key=key)["Body"].read()

    def exists(self, key):
        try:
            self._s3.head_object(Bucket=self._bucket, Key=key)
            return True
        except Exception:
            return False

    def list(self, prefix):
        paginator = self._s3.get_paginator("list_objects_v2")
        keys: list[str] = []
        for page in paginator.paginate(Bucket=self._bucket, Prefix=prefix):
            keys.extend(o["Key"] for o in page.get("Contents", []))
        return sorted(keys)

    def delete(self, key):
        self._s3.delete_object(Bucket=self._bucket, Key=key)

    def delete_all(self):
        raise NotImplementedError("refusing to wipe a real bucket")


# ---------------------------------------------------------------------------
# Document store (Mongo-role): scan summaries + parsed chunks.
# ---------------------------------------------------------------------------


class DocCollection:
    def insert_one(self, doc: dict) -> None:
        raise NotImplementedError

    def find_one(self, query: dict) -> Optional[dict]:
        raise NotImplementedError

    def find(self, query: Optional[dict] = None) -> list[dict]:
        raise NotImplementedError


class DocStore:
    """Collection names carried from the reference ``asm`` database:
    ``scans`` summaries (``server/server.py:277-294``), per-scan parsed
    collections (``server/server.py:393``), ``jobs`` (``server/server.py:367``).
    """

    def collection(self, name: str) -> DocCollection:
        raise NotImplementedError

    def drop_all(self) -> None:
        raise NotImplementedError


class _MemoryCollection(DocCollection):
    def __init__(self) -> None:
        self._docs: list[dict] = []  # guarded-by: _lock (reads)
        self._lock = threading.Lock()

    @staticmethod
    def _matches(doc: dict, query: Optional[dict]) -> bool:
        return not query or all(doc.get(k) == v for k, v in query.items())

    def insert_one(self, doc):
        with self._lock:
            self._docs.append(dict(doc))  # blocking-ok: _docs is the embedded collection's own list — this IS the store primitive

    def find_one(self, query):
        with self._lock:
            for doc in self._docs:
                if self._matches(doc, query):
                    return dict(doc)
        return None

    def find(self, query=None):
        with self._lock:
            return [dict(d) for d in self._docs if self._matches(d, query)]


class MemoryDocStore(DocStore):
    def __init__(self) -> None:
        self._collections: dict[str, _MemoryCollection] = {}  # guarded-by: _lock (reads)
        self._lock = threading.Lock()

    def collection(self, name):
        with self._lock:
            return self._collections.setdefault(name, _MemoryCollection())

    def drop_all(self):
        with self._lock:
            self._collections.clear()


class _JsonlCollection(DocCollection):
    """Append-only JSONL file per collection — durable embedded docs."""

    def __init__(self, path: Path) -> None:
        self._path = path
        self._lock = threading.Lock()

    def insert_one(self, doc):
        with self._lock:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            with self._path.open("a") as f:
                f.write(json.dumps(doc) + "\n")

    def _iter(self) -> Iterable[dict]:
        if not self._path.is_file():
            return
        with self._path.open() as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    def find_one(self, query):
        with self._lock:
            for doc in self._iter():
                if _MemoryCollection._matches(doc, query):
                    return doc
        return None

    def find(self, query=None):
        with self._lock:
            return [d for d in self._iter() if _MemoryCollection._matches(d, query)]


class LocalDocStore(DocStore):
    def __init__(self, root: str | Path) -> None:
        self._root = Path(root)
        self._lock = threading.Lock()
        self._collections: dict[str, _JsonlCollection] = {}  # guarded-by: _lock (reads)

    def collection(self, name):
        safe = name.replace("/", "_")
        # Cache per name so all callers share one file lock.
        with self._lock:
            coll = self._collections.get(safe)
            if coll is None:
                coll = self._collections[safe] = _JsonlCollection(
                    self._root / f"{safe}.jsonl"
                )
            return coll

    def drop_all(self):
        import shutil

        with self._lock:
            self._collections.clear()
            shutil.rmtree(self._root, ignore_errors=True)


class _MongoCollection(DocCollection):
    """Conforms pymongo's Cursor/ObjectId behavior to the DocCollection
    contract: find() returns a list of plain dicts, insert_one does not
    mutate the caller's document."""

    def __init__(self, coll) -> None:
        self._coll = coll

    @staticmethod
    def _strip(doc: Optional[dict]) -> Optional[dict]:
        if doc is not None:
            doc = dict(doc)
            doc.pop("_id", None)
        return doc

    def insert_one(self, doc):
        self._coll.insert_one(dict(doc))

    def find_one(self, query):
        return self._strip(self._coll.find_one(query))

    def find(self, query=None):
        return [self._strip(d) for d in self._coll.find(query or {})]


class MongoDocStore(DocStore):
    """Adapter over real MongoDB (requires ``pymongo``)."""

    def __init__(self, url: str, db: str) -> None:
        import pymongo  # gated

        self._db = pymongo.MongoClient(url)[db]

    def collection(self, name):
        return _MongoCollection(self._db[name])

    def drop_all(self):
        raise NotImplementedError("refusing to drop a real database")


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------


def build_stores(cfg) -> tuple[StateStore, BlobStore, DocStore]:
    """Construct the three stores from a :class:`swarm_tpu_torch.config.Config`."""
    if cfg.state_backend == "redis":
        state: StateStore = RedisStateStore(cfg.redis_url)
    else:
        state = MemoryStateStore()

    if cfg.blob_backend == "s3":
        blobs: BlobStore = S3BlobStore(cfg.s3_bucket)
    elif cfg.blob_backend == "memory":
        blobs = MemoryBlobStore()
    else:
        blobs = LocalBlobStore(cfg.blob_root)

    if cfg.doc_backend == "mongo":
        docs: DocStore = MongoDocStore(cfg.mongo_url, cfg.mongo_db)
    elif cfg.doc_backend == "memory":
        docs = MemoryDocStore()
    else:
        docs = LocalDocStore(cfg.doc_root)
    return state, blobs, docs
