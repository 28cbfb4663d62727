"""Gateway-tier scan-result cache: the interactive short-circuit
(docs/GATEWAY.md §QoS).

The port's copy of ``swarm_tpu/gateway/qoscache.py``, on the port's
tier (``cache/tier.py``): its functions and classes are the
reference's, line for line (``tests/test_torch_gateway.py``). The ``g``
family's keys carry no code salt, so the port's entries are the JAX
gateway's byte for byte and each reads the other's on one store.

The fleet result tier (docs/CACHING.md) already means a worker never
re-walks content any worker has resolved — but an interactive lookup
still pays admission, dispatch, a worker poll and a device round trip
to learn what the fleet already knows. This module closes that last
gap at the FRONT door: completed small chunks are written back keyed
by ``(module, chunk target lines)``, and an interactive submission
whose every chunk is fleet-known is answered AT THE GATEWAY — outputs
persisted, job records created COMPLETE, zero worker dispatch
(``JobQueueService.complete_scan_from_cache``).

Rides the same :class:`~swarm_tpu_torch.cache.tier.SharedResultTier` as the
verdict/confirm families (family ``"g"``, own epoch namespace
``gw.g<generation>``), so:

- the fencing-token discipline applies to gateway writers exactly as
  to workers (a superseded server instance cannot poison the tier);
- the operator ``bump_epoch`` lever invalidates gateway entries along
  with every other family — the documented move after a corpus change
  (the gateway holds no corpus, so content-digest scoping cannot apply
  here; the generation counter is the whole invalidation story);
- a dead backend degrades to pass-through (every lookup a miss, every
  writeback dropped) — the cache is an accelerator, never a
  dependency.

Bulk submissions never consult this cache; with ``cache_backend=off``
(the default) it is never built at all, preserving the pre-QoS wire
behavior byte-for-byte.
"""

from __future__ import annotations

import base64
import hashlib
import threading
from typing import Optional, Sequence

from swarm_tpu_torch.cache.tier import (
    SharedResultTier,
    _FORMAT,
    _lp,
    _lp_seq,
    _process_token,
)

#: tier value family for gateway scan entries ("v" = verdict planes,
#: "c" = confirm verdicts — docs/CACHING.md)
FAMILY = "g"


def scan_chunk_digest(module: str, chunk_lines: Sequence[str]) -> str:
    """Content address of one submission chunk: sha256 over the module
    name and the chunk's target lines, length-prefixed (the same
    discipline as ``cache.tier.row_digest`` — concatenation stays
    unambiguous). Since the per-target key landed this is the
    MIGRATION-PATH key: still consulted on lookup so entries written by
    a pre-migration server keep hitting for one epoch, no longer
    written. Remove with the next ``bump_epoch``-worthy change."""
    out = bytearray(_FORMAT)
    _lp(out, b"gwscan")
    _lp(out, module.encode("utf-8", "surrogateescape"))
    _lp_seq(out, chunk_lines)
    return hashlib.sha256(bytes(out)).hexdigest()


def scan_target_digest(module: str, target: str) -> str:
    """Content address of ONE target line's output segment — the
    primary gateway-family key. Keying by (module, target) instead of
    (module, chunk) means any re-chunking of the same assets dedups: a
    monitor epoch at batch 5 hits entries written by a one-shot scan at
    batch 16, because both decompose to the same target keys."""
    out = bytearray(_FORMAT)
    _lp(out, b"gwtarget")
    _lp(out, module.encode("utf-8", "surrogateescape"))
    _lp(out, target.encode("utf-8", "surrogateescape"))
    return hashlib.sha256(bytes(out)).hexdigest()


def split_output_segments(output: bytes, n: int) -> Optional[list[bytes]]:
    """Split a chunk output into per-target segments, one per input
    line, such that ``b"".join(segments) == output`` exactly. None when
    the output does not carry one line per target (multi-line verdict
    modules) — those chunks stay chunk-granular. The invariant is what
    makes per-target reassembly byte-identical to the output a worker
    would have uploaded for the same chunk."""
    if n <= 0:
        return None
    if n == 1:
        return [output]
    parts = output.split(b"\n")
    if parts and parts[-1] == b"":
        core = parts[:-1]
        if len(core) != n:
            return None
        return [p + b"\n" for p in core]
    if len(parts) != n:
        return None
    return [p + b"\n" for p in parts[:-1]] + [parts[-1]]


class GatewayScanCache:
    """The server's view of the gateway family: epoch-bound, fenced,
    fail-open. One instance per server process; thread contract —
    request threads call ``lookup_chunks``/``writeback`` concurrently,
    all mutable state sits under ``_lock``."""

    #: how long a read epoch generation is trusted before re-reading —
    #: the propagation ceiling for an operator ``bump_epoch`` against a
    #: live gateway (same constant as the worker-side cache client)
    _EPOCH_TTL_S = 60.0

    def __init__(self, tier: SharedResultTier, writer_id: str = "gateway"):
        self._tier = tier
        self._writer = f"gw:{writer_id}"
        self._lock = threading.Lock()  # guards: _epoch, _epoch_read_at, _token, _hits, _misses, _stored, _warned
        self._epoch: Optional[str] = None
        self._epoch_read_at = 0.0
        self._token: Optional[int] = None
        self._hits = 0
        self._misses = 0
        self._stored = 0
        self._warned = False

    # ------------------------------------------------------------------
    def _degraded(self, e: Exception) -> None:
        with self._lock:
            warn = not self._warned
            self._warned = True
        if warn:
            print(
                f"gateway scan cache degraded to pass-through "
                f"({type(e).__name__}: {e})"
            )

    def _ensure_bound(self) -> Optional[tuple[str, int]]:
        """(epoch, fencing token), read through the store — None while
        the backend is unreachable (the caller treats the cache as a
        miss / dropped write)."""
        import time

        now = time.monotonic()
        with self._lock:
            if (
                self._epoch is not None
                and self._token is not None
                and now - self._epoch_read_at < self._EPOCH_TTL_S
            ):
                return self._epoch, self._token
        try:
            gen = self._tier.epoch_generation()
            token = _process_token(self._tier, self._writer)
        except Exception as e:
            self._degraded(e)
            return None
        epoch = f"gw.g{gen}"
        with self._lock:
            self._epoch = epoch
            self._epoch_read_at = now
            self._token = token
            self._warned = False
        return epoch, token

    # ------------------------------------------------------------------
    @staticmethod
    def _b64(raw) -> Optional[bytes]:
        try:
            return base64.b64decode(raw, validate=True)
        except (ValueError, TypeError):
            # a corrupt entry is a MISS, never an exception on the
            # submit path
            return None

    def lookup_chunks_partial(
        self, module: str, chunks: Sequence[Sequence[str]]
    ) -> Optional[list]:
        """Per-chunk outputs with None holes for unknown chunks — or
        None outright when the backend is unreachable. One batched tier
        read covers every target digest of every chunk PLUS the legacy
        chunk digests (the migration-path read). A chunk resolves
        per-target first (so re-chunked assets dedup), falling back to
        its whole-chunk entry."""
        if not chunks:
            return None
        bound = self._ensure_bound()
        if bound is None:
            return None
        epoch, _token = bound
        want: list[str] = []
        per_chunk: list[tuple[list[str], str]] = []
        for c in chunks:
            tdigests = [scan_target_digest(module, t) for t in c]
            cdigest = scan_chunk_digest(module, c)
            per_chunk.append((tdigests, cdigest))
            want.extend(tdigests)
            want.append(cdigest)
        try:
            got = self._tier.get_many(FAMILY, epoch, want)
        except Exception as e:
            self._degraded(e)
            return None
        outputs: list = []
        for tdigests, cdigest in per_chunk:
            segments = [self._b64(got[d]) for d in tdigests if d in got]
            if len(segments) == len(tdigests) and all(
                s is not None for s in segments
            ):
                outputs.append(b"".join(segments))
                with self._lock:
                    self._hits += 1
                continue
            whole = self._b64(got[cdigest]) if cdigest in got else None
            outputs.append(whole)
            with self._lock:
                if whole is not None:
                    self._hits += 1
                else:
                    self._misses += 1
        return outputs

    def lookup_chunks(
        self, module: str, chunks: Sequence[Sequence[str]]
    ) -> Optional[list[bytes]]:
        """Outputs for EVERY chunk of a submission, or None when any
        chunk is unknown (all-or-nothing: a partial hit falls through
        to normal admission so lease/retry semantics stay untouched —
        the interactive short-circuit contract). The monitor epoch path
        uses :meth:`lookup_chunks_partial` instead, where partial
        completion is the point."""
        outputs = self.lookup_chunks_partial(module, chunks)
        if outputs is None or any(o is None for o in outputs):
            return None
        return outputs

    def writeback(
        self, module: str, chunk_lines: Sequence[str], output: bytes
    ) -> bool:
        """Store one completed chunk's output under its content keys —
        fenced, best-effort (a dropped write costs one future device
        round trip, never correctness). Splittable outputs (one line
        per target — the normal module contract) store PER-TARGET
        segments; unsplittable ones keep the whole-chunk key, so
        multi-line-verdict modules stay exactly as cacheable as before
        the migration."""
        bound = self._ensure_bound()
        if bound is None:
            return False
        epoch, token = bound
        segments = split_output_segments(output, len(chunk_lines))
        if segments is not None:
            pairs = [
                (
                    scan_target_digest(module, target),
                    base64.b64encode(seg).decode("ascii"),
                )
                for target, seg in zip(chunk_lines, segments)
            ]
        else:
            pairs = [
                (
                    scan_chunk_digest(module, chunk_lines),
                    base64.b64encode(output).decode("ascii"),
                )
            ]
        try:
            outcome, stored = self._tier.put_many(
                FAMILY, epoch, pairs, self._writer, token,
            )
        except Exception as e:
            self._degraded(e)
            return False
        if outcome == "stored" and stored:
            with self._lock:
                self._stored += stored
            return True
        return False

    def counters(self) -> dict:
        """Lifetime outcomes (test/bench surface)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "stored": self._stored,
            }


def build_gateway_cache(cfg) -> Optional[GatewayScanCache]:
    """Construct the gateway cache from a Config: None when the shared
    tier is off (``cache_backend=off``, the default) or the gateway
    short-circuit is disabled (``qos_gateway_cache=false``) — either
    way the submit path is byte-identical to pre-QoS behavior. Backend
    dispatch AND the TTL/size retention policy ride
    :func:`cache.tier.build_tier`, so a server-only process honors
    ``cache_ttl_s``/``cache_max_entries`` exactly like a worker."""
    if not getattr(cfg, "qos_gateway_cache", True):
        return None
    from swarm_tpu_torch.cache.tier import build_tier

    tier = build_tier(cfg)
    if tier is None:
        return None
    return GatewayScanCache(tier, writer_id=getattr(cfg, "worker_id", "gw"))
