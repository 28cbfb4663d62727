"""Fleet-wide content-addressed result cache, the port of
``swarm_tpu/cache/tier.py``.

Scans repeat content: thousands of hosts serve byte-identical pages,
banners and certificates, yet an engine's caches (the native verdict
memo, the batched walk's confirm cache, the workflow runner's step memo)
die with its worker. This module lifts them into a shared tier, so a
row that any worker has fully resolved skips the card fleet-wide:

- **Keys are content hashes**: sha256 over the normalized row bytes
  (the fields ``engine._content_key`` reads — banner, body, header,
  status, the OOB planes — length-prefixed), scoped by a **corpus
  epoch**: the corpus digest with an operator-bumpable generation
  counter. A refreshed corpus has another digest, so every stale entry
  becomes unreachable with no deletion pass; ``bump_epoch`` does the
  same for a poisoned tier over an unchanged corpus.
- **Three value families** share the tier: the verdict memo's entries
  (packed verdict row, extractions, row-dependent deferrals; ``v``),
  the batched walk's part-keyed confirm verdicts (``c``) and the
  workflow runner's gating results (``w``).
- **Fencing tokens**: each writer takes a monotonic token for its
  identity; a restarted or re-leased worker of the same identity
  supersedes the old one, whose writes the tier then rejects, checked
  before the write and again after it.
- **Storage** is the state and blob roles of ``swarm_tpu_torch/stores``:
  entries in a hash (one ``hmget`` a batched lookup), oversized values
  spilled to the blob store behind a pointer.

The digests and the entry formats are the reference's byte for byte.
The epoch is not: :func:`corpus_digest` salts with the port's
``fingerprints/dbcache._code_salt`` (a hash of the port's compiler
sources), so a port epoch never equals a JAX epoch and entries of the
two packages never mix on one backend. That is intended: matcher and
template indices are baked into the entries, and only the same lowering
code may share them.

The engine's memos stay in front as the L1; the engine consults L1 →
shared tier → card (``ops/engine.py``), and the scheduler makes the
shared lookup in its prefetch stage (``sched/scheduler.py``). All tier
traffic goes through :class:`ResultCacheClient`, which runs every store
operation behind a circuit breaker: a dead Redis degrades the scan to
L1-only and never blocks it (fault points ``cache.get`` /
``cache.put``).
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import time
import weakref
from typing import Optional, Sequence

from swarm_tpu_torch.telemetry.memo_export import (
    MEMO_EPOCH,
    MEMO_EVICTIONS,
    MEMO_HIT_RATIO,
    MEMO_LOOKUP_SECONDS,
    MEMO_WRITEBACKS,
    SHARED_HITS,
    SHARED_MISSES,
)

#: serialization format version — salts every digest so a wire-format
#: change can never deserialize stale entries
_FORMAT = b"swarm-cache-v1"


# ---------------------------------------------------------------------------
# Content addressing
# ---------------------------------------------------------------------------


def _lp(out: bytearray, b: bytes) -> None:
    out += len(b).to_bytes(8, "little")
    out += b


def _lp_seq(out: bytearray, seq) -> None:
    """Length-prefix a string sequence element-wise (count, then each
    element) — joining with a separator would make element boundaries
    ambiguous, exactly what the prefix discipline exists to prevent."""
    _lp(out, str(len(seq)).encode())
    for item in seq:
        _lp(out, item.encode("utf-8", "surrogateescape"))


def row_digest(row) -> str:
    """Content address of one response row: sha256 over the normalized
    row bytes — exactly the fields the device and the content-side host
    walk read (``engine._content_key``), length-prefixed. host/port/
    duration are deliberately NOT hashed: row-dependent templates are
    stored as deferrals and re-decided per member row on replay, so
    content-identical rows from different hosts share one entry."""
    out = bytearray(_FORMAT)
    _lp(out, b"\x01" + row.banner if row.banner is not None else b"\x00")
    _lp(out, row.body)
    _lp(out, row.header)
    _lp(out, str(int(row.status)).encode())
    _lp_seq(out, row.oob_protocols)
    _lp(out, row.oob_requests)
    _lp_seq(out, row.oob_ips)
    return hashlib.sha256(bytes(out)).hexdigest()


def confirm_digest(key: tuple) -> str:
    """Content address of one confirm-cache entry ``(tag, m_id,
    part_bytes)`` (the engine's ``_confirm_cache`` key shape for the
    shareable ``"m"``/``"pe"`` namespaces). ``m_id`` is a compiled-db
    matcher index — stable only per corpus, which is why every lookup
    is epoch-scoped and the epoch digest covers the compiler source."""
    tag, m_id, part = key
    out = bytearray(_FORMAT)
    _lp(out, tag.encode())
    _lp(out, str(int(m_id)).encode())
    _lp(out, part)
    return hashlib.sha256(bytes(out)).hexdigest()


def corpus_digest(templates: Sequence) -> str:
    """Content digest of a template corpus — the epoch's identity half.

    Hashes every template's dataclass repr (deterministic across
    processes: field order is declaration order, values are
    bytes/str/int reprs) PLUS the compiler-source salt from
    ``fingerprints/dbcache`` — matcher/op/template INDICES are baked
    into both value families, and a lowering change can renumber them
    even when the YAML is unchanged."""
    from swarm_tpu_torch.fingerprints.dbcache import _code_salt

    h = hashlib.sha256(_FORMAT)
    h.update(_code_salt())
    for t in templates:
        h.update(repr(t).encode("utf-8", "surrogateescape"))
        h.update(b"\x00")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Entry wire format (family "v"): the native memo's (bits, ment, mdef)
# ---------------------------------------------------------------------------


def encode_entry(bits_bytes: bytes, ment: tuple, mdef: tuple) -> Optional[str]:
    """One verdict entry → compact JSON string (None when the extras
    hold something JSON can't carry — e.g. a lone-surrogate host
    remnant; the entry is simply not shared, never mangled)."""
    try:
        return json.dumps(
            {
                "b": base64.b64encode(bits_bytes).decode("ascii"),
                "e": [[tid, list(vals)] for tid, vals in ment],
                "d": list(mdef),
            },
            separators=(",", ":"),
        )
    except (TypeError, ValueError):
        return None


def decode_entry(raw: str) -> Optional[tuple]:
    """JSON string → ``(bits_bytes, ment, mdef)`` in exactly the
    deep-frozen shape the verdict memos store; None on anything
    malformed (a corrupt entry is a MISS, never an exception on the
    match path)."""
    try:
        doc = json.loads(raw)
        bits = base64.b64decode(doc["b"], validate=True)
        ment = tuple(
            (str(tid), tuple(str(v) for v in vals)) for tid, vals in doc["e"]
        )
        mdef = tuple(int(t) for t in doc["d"])
        return bits, ment, mdef
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Entry wire format (family "w"): per-content workflow gating results
# ---------------------------------------------------------------------------


def encode_workflow_entry(per: dict) -> Optional[str]:
    """One workflow gating result ``{workflow_id: [template ids]}`` →
    compact JSON string (None when an id holds something JSON can't
    carry — the entry is simply not shared, never mangled)."""
    try:
        return json.dumps(
            {str(k): sorted(str(t) for t in v) for k, v in per.items()},
            separators=(",", ":"),
            sort_keys=True,
        )
    except (TypeError, ValueError):
        return None


def decode_workflow_entry(raw: str) -> Optional[dict]:
    """JSON string → ``{workflow_id: [template ids]}``; None on
    anything malformed (a corrupt entry is a MISS, never an exception
    on the gating path)."""
    try:
        doc = json.loads(raw)
        return {str(k): [str(t) for t in v] for k, v in doc.items()}
    except Exception:
        return None


# ---------------------------------------------------------------------------
# The shared tier proper
# ---------------------------------------------------------------------------


class SharedResultTier:
    """Backend-agnostic shared tier over a :class:`~swarm_tpu_torch.stores.
    StateStore` (hash-addressed entries, fencing registry, epoch
    generation) plus an optional :class:`~swarm_tpu_torch.stores.BlobStore`
    spill for oversized values.

    Wire layout (Redis-compatible, namespaced under ``prefix``):

    - ``{prefix}:meta`` hash — ``epoch_gen`` (int), ``fence_next``
      (monotonic token counter)
    - ``{prefix}:writers`` hash — writer identity → current token
    - ``{prefix}:{family}:{epoch}`` hash — content digest → JSON entry,
      or the ``@blob`` pointer sentinel
    - blob key ``cache/{family}/{epoch}/{digest}`` — spilled values

    All methods are thread-safe to the extent the underlying stores
    are (both embedded defaults and both real adapters are)."""

    _BLOB_SENTINEL = "@blob"

    def __init__(self, state, blobs=None, prefix: str = "swarm:cache",
                 spill_bytes: int = 8192, ttl_s: float = 0.0,
                 max_entries: int = 0):
        self._state = state
        self._blobs = blobs
        self._prefix = prefix
        self._spill = int(spill_bytes)
        self.configure_policy(ttl_s, max_entries)

    # -- TTL/size policy (docs/CACHING.md) -----------------------------
    def configure_policy(self, ttl_s: float = 0.0, max_entries: int = 0) -> None:
        """Optional retention policy, per value-family namespace.
        Both default OFF (0) — today's behavior (backend eviction +
        epoch bumps) unless the operator configures it. ``ttl_s``
        expires entries lazily at lookup; ``max_entries`` bounds EACH
        ``{family}:{epoch}`` hash at write time, oldest-first. Only
        entries written while a policy is active carry a write stamp
        and participate; concurrent evictions are idempotent hdels."""
        self._ttl_s = float(ttl_s)
        self._max_entries = int(max_entries)

    def _policy_active(self) -> bool:
        return self._ttl_s > 0 or self._max_entries > 0

    def _ts_name(self, family: str, epoch: str) -> str:
        """Side hash of write timestamps (digest → unix seconds): the
        entry wire format stays untouched, so flipping the policy on
        or off can never strand or corrupt existing values."""
        return f"{self._prefix}:ts:{family}:{epoch}"

    def _evict(self, family: str, epoch: str, digests, reason: str) -> int:
        name = self._hash_name(family, epoch)
        ts_name = self._ts_name(family, epoch)
        n = 0
        for digest in digests:
            # a spilled value's blob becomes unreachable garbage, the
            # same reclamation story as a stale epoch's namespace
            self._state.hdel(name, digest)
            self._state.hdel(ts_name, digest)
            n += 1
        if n:
            MEMO_EVICTIONS.labels(reason=reason).inc(n)
        return n

    def entry_count(self, family: str, epoch: str) -> int:
        """Policy-tracked entries in one family namespace (test/ops
        surface; entries written with the policy off aren't counted)."""
        return len(self._state.hkeys(self._ts_name(family, epoch)))

    # -- epoch ---------------------------------------------------------
    def epoch_generation(self) -> int:
        raw = self._state.hget(f"{self._prefix}:meta", "epoch_gen")
        return int(raw) if raw else 0

    def bump_epoch(self) -> int:
        """Invalidate EVERY live entry by moving all readers/writers to
        a fresh key namespace (the operator lever for "poisoned tier,
        unchanged corpus"; stale-epoch entries are unreachable garbage,
        reclaimed by backend TTL/eviction policy, not by a scan)."""
        return self._state.hincr(f"{self._prefix}:meta", "epoch_gen", 1)

    # -- fencing -------------------------------------------------------
    def acquire_writer(self, writer_id: str) -> int:
        """Mint a fencing token for ``writer_id`` and make it the
        identity's CURRENT token — any prior holder of the same
        identity (the restarted/re-leased predecessor) is superseded
        from this moment and its writes are rejected."""
        token = self._state.hincr(f"{self._prefix}:meta", "fence_next", 1)
        self._state.hset(f"{self._prefix}:writers", writer_id, str(token))
        return token

    def writer_token(self, writer_id: str) -> Optional[int]:
        raw = self._state.hget(f"{self._prefix}:writers", writer_id)
        return int(raw) if raw else None

    def fence_writer(self, writer_id: str) -> None:
        """Revoke an identity outright (no successor yet): its token is
        dropped, so every in-flight write from it is rejected."""
        self._state.hdel(f"{self._prefix}:writers", writer_id)

    # -- data plane ----------------------------------------------------
    def _hash_name(self, family: str, epoch: str) -> str:
        return f"{self._prefix}:{family}:{epoch}"

    def _blob_key(self, family: str, epoch: str, digest: str) -> str:
        return f"cache/{family}/{epoch}/{digest}"

    def get_many(self, family: str, epoch: str, digests: list) -> dict:
        """digest → raw value for every present entry, ONE state-store
        round trip (``hmget``) plus a blob fetch per spilled value. A
        missing/vanished blob behind a live pointer is a miss."""
        if not digests:
            return {}
        name = self._hash_name(family, epoch)
        expired: set = set()
        if self._ttl_s > 0:
            # lazy TTL expiry: stamps ride a side hash, one extra
            # hmget per batched lookup only while the policy is on; an
            # expired entry is dropped and served as a miss
            now = time.time()
            ts_name = self._ts_name(family, epoch)
            stamps = self._state.hmget(ts_name, digests)
            stale: dict = {}
            for digest, raw_ts in zip(digests, stamps):
                if raw_ts is None:
                    continue  # pre-policy entry: no stamp, no expiry
                try:
                    if now - float(raw_ts) > self._ttl_s:
                        stale[digest] = raw_ts
                except ValueError:
                    stale[digest] = raw_ts
            if stale:
                # re-read just before deleting: a concurrent writer may
                # have refreshed the entry between the two reads, and
                # deleting THAT would destroy a fresh value. The
                # residual window after this check is benign (an
                # entry loss = one recompute, never a wrong verdict).
                recheck = self._state.hmget(ts_name, list(stale))
                expired = {
                    d for d, ts in zip(stale, recheck) if ts == stale[d]
                }
                if expired:
                    self._evict(family, epoch, expired, "ttl")
        out: dict = {}
        for digest, raw in zip(digests, self._state.hmget(name, digests)):
            if raw is None or digest in expired:
                continue
            if raw == self._BLOB_SENTINEL:
                if self._blobs is None:
                    continue
                try:
                    raw = self._blobs.get(
                        self._blob_key(family, epoch, digest)
                    ).decode("utf-8")
                except Exception:
                    continue
            out[digest] = raw
        return out

    # pairs: writer_token / _state.hset_many; pairs: writer_token / _blobs.put (fence re-check, docs/CACHING.md)
    def put_many(
        self, family: str, epoch: str, items: list, writer_id: str,
        token: int,
    ) -> tuple[str, int]:
        """Store ``[(digest, value), ...]`` under the writer's fencing
        token. Returns ``(outcome, stored_count)`` with outcome
        ``"stored"`` or ``"fenced"``. The token is checked BEFORE the
        write (the stale-writer reject) and AGAIN after it, so a
        writer superseded mid-write learns it was fenced instead of
        claiming success. The mid-write entries themselves are
        deliberately NOT unwound: within an epoch every entry is a
        pure function of its content digest (the epoch namespace pins
        corpus AND lowering code), so a superseded same-epoch writer's
        bytes are value-identical to what the live successor would
        store — deleting them could only ever destroy the successor's
        valid concurrent write for the same digest, never remove
        poison. Cross-epoch stale writers cannot reach this namespace
        at all (the actual poison vector the discipline closes)."""
        if self.writer_token(writer_id) != token:
            return "fenced", 0
        name = self._hash_name(family, epoch)
        mapping: dict = {}
        for digest, value in items:
            if self._blobs is not None and len(value) > self._spill:
                self._blobs.put(
                    self._blob_key(family, epoch, digest),
                    value.encode("utf-8"),
                )
                value = self._BLOB_SENTINEL
            mapping[digest] = value
        # ONE state-store round trip for the whole batch (hset_many) —
        # a walked plane's writeback must not cost one RTT per row
        self._state.hset_many(name, mapping)
        if self._policy_active():
            now = str(time.time())
            self._state.hset_many(
                self._ts_name(family, epoch), {d: now for d in mapping}
            )
            if self._max_entries > 0:
                stamps = self._state.hgetall(self._ts_name(family, epoch))
                excess = len(stamps) - self._max_entries
                if excess > 0:
                    oldest = sorted(
                        stamps, key=lambda d: (float(stamps[d]), d)
                    )[:excess]
                    self._evict(family, epoch, oldest, "size")
        if self.writer_token(writer_id) != token:
            return "fenced", 0
        return "stored", len(mapping)


# ---------------------------------------------------------------------------
# Breaker-wrapped per-engine client
# ---------------------------------------------------------------------------

# process-wide shared hit/miss totals behind the hit-ratio gauge (every
# client in the process reports into one ratio)
_G_LOCK = threading.Lock()
# [shared hits, shared misses] across every client in the process
_G_TOTALS = [0, 0]  # guarded-by: _G_LOCK

# ONE fencing token per writer identity PER PROCESS: two clients in the
# same process that derive the same identity (same worker id + same
# corpus digest — e.g. two modules over identical templates) are the
# SAME live writer and must share a token; re-acquiring would
# supersede the first client and silently fence its writebacks. A
# restart is a new process with an empty registry, so it re-acquires
# and supersedes the dead predecessor — exactly the discipline's
# intent. Keyed per tier object (WeakKey: the registry never extends a
# tier's lifetime).
_TOKEN_LOCK = threading.Lock()
_PROC_TOKENS = weakref.WeakKeyDictionary()  # guarded-by: _TOKEN_LOCK (reads)


def _process_token(tier: SharedResultTier, writer: str) -> int:
    """The process's token for (tier, writer) — acquired once, shared
    by every same-identity client. Store I/O runs under the lock;
    binding is rare (once per engine per process)."""
    with _TOKEN_LOCK:
        per_tier = _PROC_TOKENS.get(tier)
        if per_tier is None:
            per_tier = _PROC_TOKENS[tier] = {}
        token = per_tier.get(writer)
        if token is None:
            token = per_tier[writer] = tier.acquire_writer(writer)  # blocking-ok: one-time token mint per (tier, writer) — serialized registration IS the discipline (docs/CACHING.md)
        return token


class ResultCacheClient:
    """The engine's view of the shared tier: epoch-bound, breaker-
    wrapped, telemetry-counted. Every tier access runs behind a
    circuit breaker (``cache.tier.<worker>``): a dead/slow backend
    trips it and the engine silently degrades to L1-only — lookups
    return misses, writebacks drop — until the cooldown's half-open
    probe heals it. Chaos levers ``cache.get`` / ``cache.put``
    (docs/RESILIENCE.md) inject exactly that failure mode.

    Thread contract: the scheduler calls ``lookup_rows`` from its
    prefetch thread while the walk worker calls ``writeback_rows`` /
    ``writeback_confirms`` — all mutable client state sits under
    ``_lock``."""

    #: recent-miss suppression cap: a digest this client just missed is
    #: not re-queried (the engine will compute and write it back
    #: itself); bounded FIFO, oldest half dropped at the cap
    _RECENT_MAX = 8192
    #: how long a bound epoch is trusted before the generation counter
    #: is re-read — the propagation ceiling for an operator
    #: ``bump_epoch`` on a LIVE fleet (no restart needed; the re-read
    #: is one breaker-guarded hget per client per interval)
    _EPOCH_TTL_S = 60.0

    def __init__(
        self,
        tier: SharedResultTier,
        worker_id: str = "worker",
        confirm: bool = True,
        writeback: bool = True,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
    ):
        from swarm_tpu_torch.resilience.breaker import CircuitBreaker

        self._tier = tier
        self._worker_id = worker_id
        self.confirm = bool(confirm)
        self.writeback = bool(writeback)
        self._breaker = CircuitBreaker(
            f"cache.tier.{worker_id}",
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
        )
        self._lock = threading.Lock()  # guards: _recent_miss (reads), _hits, _misses, _fam, _epoch, _writer, _token, _digest, _warned, _fence_warned
        # serializes the bind SEQUENCE (epoch read + token acquisition,
        # store I/O included): two threads racing a lazy re-bind must
        # not each mint a token for the same identity — the loser's
        # token would disagree with the registry and every later
        # writeback would be silently fenced
        # lock-order: _bind_lock -> _lock
        self._bind_lock = threading.Lock()
        self._recent_miss: dict = {}
        self._hits = 0
        self._misses = 0
        # per-family [hits, misses]: the bench's gated hit ratio reads
        # verdict-family outcomes only (confirm digests would dilute it)
        self._fam: dict = {"v": [0, 0], "c": [0, 0], "w": [0, 0]}
        self._digest: Optional[str] = None
        self._epoch: Optional[str] = None
        self._epoch_read_at = 0.0
        self._writer: Optional[str] = None
        self._token: Optional[int] = None
        self._warned = False
        self._fence_warned = False

    # -- binding -------------------------------------------------------
    def bind_corpus(self, digest: str) -> None:
        """Bind this client to a corpus content digest (the engine
        calls this at attach time). Tier registration — reading the
        epoch generation and acquiring the fencing token — happens
        through the breaker and retries lazily on the next op if the
        backend is down at bind time."""
        with self._lock:
            self._digest = digest
            self._epoch = None
            self._writer = f"{self._worker_id}:{digest[:8]}"
            self._token = None
        self._ensure_bound()

    def refresh_epoch(self) -> None:
        """Re-read the tier's epoch generation (after an operator
        ``bump_epoch``; new entries land in — and lookups read — the
        fresh namespace)."""
        with self._lock:
            self._epoch = None
        self._ensure_bound()

    def _ensure_bound(self) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            if (
                self._epoch is not None
                and now - self._epoch_read_at < self._EPOCH_TTL_S
            ):
                return self._epoch
        with self._bind_lock:
            # re-check under the bind lock: the thread that lost the
            # race adopts the winner's bind instead of re-acquiring
            with self._lock:
                if (
                    self._epoch is not None
                    and now - self._epoch_read_at < self._EPOCH_TTL_S
                ):
                    return self._epoch
                stale_epoch = self._epoch
                digest = self._digest
                writer = self._writer
                token = self._token
            if digest is None:
                return None

            def bind():
                gen = self._tier.epoch_generation()
                tok = token
                if tok is None:
                    tok = _process_token(self._tier, writer)
                return f"{digest[:24]}.g{gen}", tok

            out = self._guarded("cache.get", "bind", bind)  # blocking-ok: the bind sequence (epoch read + token mint) is serialized by design — one guarded RTT per epoch TTL
            if out is None:
                # re-read failed (breaker open / backend down): keep
                # serving on the stale-by-≤TTL epoch if we have one —
                # a flaky meta read must not un-bind a working client
                return stale_epoch
            epoch, tok = out
            with self._lock:
                self._epoch = epoch
                self._epoch_read_at = time.monotonic()
                self._token = tok
        MEMO_EPOCH.labels().set(float(epoch.rsplit(".g", 1)[-1]))
        return epoch

    # -- breaker plumbing ---------------------------------------------
    # may-block: wraps one tier store op behind the breaker
    def _guarded(self, point: str, detail: str, fn):
        """Run one tier op behind the breaker; None = degraded (the
        caller treats it as a miss / dropped write)."""
        from swarm_tpu_torch.resilience.faults import fault_point

        br = self._breaker
        if not br.allow():
            return None
        try:
            from swarm_tpu_torch.telemetry import tracing

            fault_point(point, detail=detail)
            # child span under the worker's ambient attempt context
            # (no-op object when tracing is off / no context bound)
            with tracing.span(point, detail=detail):
                out = fn()
        except Exception as e:
            br.record_failure()
            with self._lock:
                warn = not self._warned
                self._warned = True
            if warn:
                print(
                    f"result cache degraded to L1-only "
                    f"({type(e).__name__}: {e}) "
                    f"[breaker {br.name}: {br.state}]"
                )
            return None
        br.record_success()
        with self._lock:
            self._warned = False
        return out

    # -- verdict family ------------------------------------------------
    def lookup_rows(self, rows: Sequence) -> dict:
        """Batched shared lookup: row position → decoded verdict entry
        ``(bits_bytes, ment, mdef)`` for every row whose content the
        tier holds. Dead rows never consult the tier (they resolve to
        zero verdicts by contract); duplicate contents are queried
        once and fan out to every member position; digests this client
        recently missed are suppressed entirely (the engine is about
        to compute them anyway)."""
        if not rows:
            return {}
        epoch = self._ensure_bound()
        if epoch is None:
            return {}
        members: dict = {}
        for i, row in enumerate(rows):
            if not getattr(row, "alive", True):
                continue
            members.setdefault(row_digest(row), []).append(i)
        with self._lock:
            digests = [d for d in members if d not in self._recent_miss]
        if not digests:
            return {}
        t0 = time.perf_counter()
        got = self._guarded(
            "cache.get", "verdict",
            lambda: self._tier.get_many("v", epoch, digests),
        )
        if got is None:
            # breaker-open / failed op: no real lookup happened — an
            # observation here would fill the low buckets with zeros
            # exactly while the tier is down
            return {}
        MEMO_LOOKUP_SECONDS.labels().observe(time.perf_counter() - t0)
        out: dict = {}
        hits = misses = 0
        missed: list = []
        for digest in digests:
            raw = got.get(digest)
            entry = decode_entry(raw) if raw is not None else None
            if entry is None:
                misses += 1
                missed.append(digest)
                continue
            hits += 1
            for i in members[digest]:
                out[i] = entry
        self._count(hits, misses, missed, "v")
        return out

    def writeback_rows(self, entries: list) -> int:
        """Batch-write freshly walked results: ``[(row, bits_bytes,
        (ment, mdef) | None), ...]`` → the verdict family. Returns the
        stored count (0 when fenced/degraded/disabled)."""
        if not self.writeback or not entries:
            return 0
        items: list = []
        for row, bits_bytes, extras in entries:
            if not getattr(row, "alive", True):
                continue
            ment, mdef = extras if extras is not None else ((), ())
            value = encode_entry(bits_bytes, ment, mdef)
            if value is not None:
                items.append((row_digest(row), value))
        return self._put("v", "verdict", items)

    # -- confirm family ------------------------------------------------
    def lookup_confirms(self, keys: list) -> dict:
        """Batched confirm-family lookup: engine ``_confirm_cache`` key
        → bool for every present entry (keys are the shareable
        ``("m"|"pe", m_id, part)`` namespaces)."""
        if not keys or not self.confirm:
            return {}
        epoch = self._ensure_bound()
        if epoch is None:
            return {}
        by_digest = {confirm_digest(k): k for k in keys}
        with self._lock:
            digests = [
                d for d in by_digest if d not in self._recent_miss
            ]
        if not digests:
            return {}
        t0 = time.perf_counter()
        got = self._guarded(
            "cache.get", "confirm",
            lambda: self._tier.get_many("c", epoch, digests),
        )
        if got is None:
            return {}  # degraded: no real lookup to time
        MEMO_LOOKUP_SECONDS.labels().observe(time.perf_counter() - t0)
        out: dict = {}
        hits = misses = 0
        missed: list = []
        for digest in digests:
            raw = got.get(digest)
            if raw == "1" or raw == "0":
                hits += 1
                out[by_digest[digest]] = raw == "1"
            else:
                misses += 1
                missed.append(digest)
        self._count(hits, misses, missed, "c")
        return out

    def writeback_confirms(self, items: list) -> int:
        """Batch-write confirm verdicts: ``[(key, bool), ...]`` from
        the batched walk's merge phase; non-shareable key namespaces
        (``"op"``-tagged per-object keys) are skipped here by the
        caller."""
        if not self.writeback or not self.confirm or not items:
            return 0
        return self._put(
            "c", "confirm",
            [(confirm_digest(k), "1" if v else "0") for k, v in items],
        )

    # -- workflow step family ------------------------------------------
    def lookup_workflows(self, rows: Sequence) -> dict:
        """Batched workflow-family lookup: row position → decoded
        gating result ``{workflow_id: [template ids]}`` for every row
        whose content the tier holds. Same content addressing as the
        verdict family (``row_digest``) under the separate ``"w"``
        namespace — entries cover content-pure workflows only, so a
        fleet-known trigger's gating costs this lookup, not a device
        dispatch. Recent-miss suppression is tracked under a
        ``"w:"``-prefixed key so a workflow miss never suppresses the
        verdict family's lookup of the same content (or vice versa)."""
        if not rows:
            return {}
        epoch = self._ensure_bound()
        if epoch is None:
            return {}
        members: dict = {}
        for i, row in enumerate(rows):
            if not getattr(row, "alive", True):
                continue
            members.setdefault(row_digest(row), []).append(i)
        with self._lock:
            digests = [
                d for d in members if ("w:" + d) not in self._recent_miss
            ]
        if not digests:
            return {}
        t0 = time.perf_counter()
        got = self._guarded(
            "cache.get", "workflow",
            lambda: self._tier.get_many("w", epoch, digests),
        )
        if got is None:
            return {}  # degraded: no real lookup to time
        MEMO_LOOKUP_SECONDS.labels().observe(time.perf_counter() - t0)
        out: dict = {}
        hits = misses = 0
        missed: list = []
        for digest in digests:
            raw = got.get(digest)
            entry = decode_workflow_entry(raw) if raw is not None else None
            if entry is None:
                misses += 1
                missed.append("w:" + digest)
                continue
            hits += 1
            for i in members[digest]:
                out[i] = entry
        self._count(hits, misses, missed, "w")
        return out

    def writeback_workflows(self, entries: list) -> int:
        """Batch-write freshly gated results: ``[(row, per_dict), ...]``
        → the workflow family (``per_dict`` restricted to content-pure
        workflows by the caller). Returns the stored count (0 when
        fenced/degraded/disabled)."""
        if not self.writeback or not entries:
            return 0
        items: list = []
        for row, per in entries:
            if not getattr(row, "alive", True):
                continue
            value = encode_workflow_entry(per)
            if value is not None:
                items.append((row_digest(row), value))
        return self._put("w", "workflow", items)

    # -- shared plumbing -----------------------------------------------
    def _put(self, family: str, label: str, items: list) -> int:
        if not items:
            return 0
        epoch = self._ensure_bound()
        if epoch is None:
            MEMO_WRITEBACKS.labels(family=label, outcome="error").inc(
                len(items)
            )
            return 0
        with self._lock:
            writer, token = self._writer, self._token
        out = self._guarded(
            "cache.put", label,
            lambda: self._tier.put_many(family, epoch, items, writer, token),
        )
        if out is None:
            MEMO_WRITEBACKS.labels(family=label, outcome="error").inc(
                len(items)
            )
            return 0
        outcome, stored = out
        MEMO_WRITEBACKS.labels(
            family=label, outcome=outcome
        ).inc(len(items) if outcome == "fenced" else stored)
        if outcome == "fenced":
            # being superseded is a normal fleet event, but a client
            # that keeps writing fenced is usually a DUPLICATE worker
            # id (two live processes sharing one identity) — say so
            # once instead of silently dropping every writeback
            with self._lock:
                warn = not self._fence_warned
                self._fence_warned = True
            if warn:
                print(
                    f"result cache writebacks fenced (writer "
                    f"{writer!r} superseded — restarted elsewhere or "
                    f"duplicate worker id); this engine is now a "
                    f"read-only tier consumer"
                )
        elif stored:
            # this content is provably in the tier now — stop
            # suppressing its digest, or recurring content evicted
            # from the L1 would be re-walked while the tier holds it
            with self._lock:
                for digest, _value in items:
                    self._recent_miss.pop(digest, None)
        return stored

    def _count(
        self, hits: int, misses: int, missed: list, family: str
    ) -> None:
        with self._lock:
            self._hits += hits
            self._misses += misses
            self._fam[family][0] += hits
            self._fam[family][1] += misses
            if len(self._recent_miss) + len(missed) > self._RECENT_MAX:
                for k in list(self._recent_miss)[: self._RECENT_MAX // 2]:
                    self._recent_miss.pop(k, None)
            for d in missed:
                self._recent_miss[d] = None
        if hits:
            SHARED_HITS.inc(hits)
        if misses:
            SHARED_MISSES.inc(misses)
        with _G_LOCK:
            _G_TOTALS[0] += hits
            _G_TOTALS[1] += misses
            total = _G_TOTALS[0] + _G_TOTALS[1]
            ratio = _G_TOTALS[0] / total if total else 0.0
        MEMO_HIT_RATIO.labels().set(ratio)

    def counters(self) -> dict:
        """This client's lifetime lookup outcomes (bench/test surface).
        ``shared_*`` are both families pooled; the ``verdict_*`` /
        ``confirm_*`` splits exist so row-granular gates (the dedup
        bench's hit ratio) aren't diluted by confirm-part digests."""
        with self._lock:
            return {
                "shared_hits": self._hits,
                "shared_misses": self._misses,
                "verdict_hits": self._fam["v"][0],
                "verdict_misses": self._fam["v"][1],
                "confirm_hits": self._fam["c"][0],
                "confirm_misses": self._fam["c"][1],
                "epoch": self._epoch,
                "breaker": self._breaker.state,
            }


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

_MEMORY_LOCK = threading.Lock()
_MEMORY_TIER: Optional[SharedResultTier] = None  # guarded-by: _MEMORY_LOCK (reads)
# one tier object per (url, spill dir) in this process: the fencing
# registry (_PROC_TOKENS) is keyed per tier OBJECT, so two clients
# over the same backend must see the same instance or same-identity
# clients would mint competing tokens and fence each other
_REDIS_TIERS: dict = {}  # guarded-by: _MEMORY_LOCK (reads)


def _memory_tier() -> SharedResultTier:
    """Process-wide embedded tier (the no-side-car default): every
    engine in the process shares one instance, so multi-module workers
    still get cross-engine reuse."""
    global _MEMORY_TIER
    from swarm_tpu_torch.stores import MemoryBlobStore, MemoryStateStore

    with _MEMORY_LOCK:
        if _MEMORY_TIER is None:
            _MEMORY_TIER = SharedResultTier(
                MemoryStateStore(), MemoryBlobStore()
            )
        return _MEMORY_TIER


def _redis_tier(url: str, spill_dir: str) -> SharedResultTier:
    from swarm_tpu_torch.stores import LocalBlobStore, RedisStateStore

    with _MEMORY_LOCK:
        tier = _REDIS_TIERS.get((url, spill_dir))
        if tier is None:
            blobs = LocalBlobStore(spill_dir) if spill_dir else None
            tier = _REDIS_TIERS[(url, spill_dir)] = SharedResultTier(
                RedisStateStore(url), blobs
            )
        return tier


def build_tier(cfg) -> Optional[SharedResultTier]:
    """The shared tier for a Config's ``SWARM_CACHE_*`` knobs — the
    ONE backend-dispatch + retention-policy site, shared by the
    engine-side :func:`build_result_cache` and the gateway-side scan
    cache (``gateway/qoscache.py``) so the two can never drift. None
    when the tier is off."""
    backend = (getattr(cfg, "cache_backend", "off") or "off").lower()
    if backend in ("off", "", "0", "none", "false"):
        return None
    if backend == "memory":
        tier = _memory_tier()
    elif backend == "redis":
        tier = _redis_tier(
            cfg.cache_url or cfg.redis_url, cfg.cache_spill_dir
        )
    else:
        raise ValueError(f"unknown cache_backend {backend!r}")
    # TTL/size policy (docs/CACHING.md): the tier objects are process
    # singletons per backend, so the most recent configuration wins —
    # defaults (0/0) keep today's behavior untouched
    tier.configure_policy(
        getattr(cfg, "cache_ttl_s", 0.0),
        getattr(cfg, "cache_max_entries", 0),
    )
    return tier


def build_result_cache(cfg) -> Optional[ResultCacheClient]:
    """Construct the tier client from a :class:`swarm_tpu_torch.config.
    Config` (``SWARM_CACHE_*`` knobs); None when the tier is off."""
    tier = build_tier(cfg)
    if tier is None:
        return None
    return ResultCacheClient(
        tier,
        worker_id=cfg.worker_id,
        confirm=cfg.cache_confirm,
        writeback=cfg.cache_writeback,
        breaker_threshold=cfg.cache_breaker_threshold,
        breaker_cooldown_s=cfg.cache_breaker_cooldown_s,
    )
