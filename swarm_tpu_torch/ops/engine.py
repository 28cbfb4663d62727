"""MatchEngine: the exact template-fingerprint engine of the port.

The port of ``swarm_tpu/ops/engine.py`` as it runs with its native
libraries: template corpus → CompiledDB (once), responses → padded
batches → :class:`~swarm_tpu_torch.ops.match.DeviceDB` on the card, or
:class:`~swarm_tpu_torch.parallel.sharded.ShardedMatcher` over a mesh
of devices → sparse host confirmation with the exact CPU oracle. The
result is bit-identical to running the oracle on every (row, template)
pair, and to the JAX engine's: template ids, extractions and host
confirms per row.

``mesh="auto"`` (the default) shards every batch over a (data, model,
seq) mesh of all local CUDA devices when the engine runs on the card
and there is more than one, as the JAX engine does over its chips;
``mesh=None`` keeps one device, and a
:class:`~swarm_tpu_torch.parallel.mesh.Mesh` may be passed in. On a
mesh the unique rows are placed so that every data rank holds its
share of the real rows, each batch's rows are padded to a multiple of
the data ranks, and on a seq grid the streams to whole halo-wide
slices (``pad_streams_for_seq``).

Two ways to feed it, with the same results:

- direct (``pipeline="off"``, the default): :meth:`MatchEngine.match`
  runs batches of ``batch_rows`` in turn, the next batch's encode on
  one helper thread while the current one is matched;
- pipelined (``pipeline="on"``, or ``SWARM_PIPELINE=on``): multi-row
  calls go through the continuous-batching scheduler
  (``swarm_tpu_torch/sched``), which drives the split submission
  surface — :meth:`MatchEngine.encode_packed`,
  :meth:`MatchEngine.begin_packed` (launch without waiting) and
  :meth:`MatchEngine.finish_packed` (wait for that batch, walk it) —
  with up to four batches in flight.

Per batch of up to ``batch_rows`` rows:

- one native lookup pass (``native/scanio.py`` ``VerdictMemo``, a
  content-keyed LRU in libfastpack) serves every row whose content the
  engine has resolved before straight into the batch's verdict plane,
  writes zero verdicts for dead rows, and deduplicates the misses by
  content; only the miss uniques are encoded (two native passes) and
  matched on the device;
- the host walk touches only the uncertain *matchers* that fired: an
  op still undecided after its certain matchers has a neutral certain
  part, so its exact value is the combination of its uncertain
  matchers alone. The batch's pending (row, matcher) pairs are first
  decided by grouped native passes that release the GIL — the word
  confirm of libfastpack and the crex regex VM (``native/crex.py``) —
  sharded over the walk pool, content-deduplicated and memoized across
  batches;
- extractions run per distinct (pattern, group) as one batched crex
  dispatch over every pending content, behind exact literal and
  DFA-existence gates (``ops/fastre.py``);
- rows that overflowed the candidate budget or were truncated are
  redone in full; templates that read beyond the response content
  (host, port, duration, ip) are decided per member row, not per
  content; the host-always tail runs on every live row;
- the walked content goes into the verdict memo, which lives as long as
  the engine. :meth:`MatchEngine.clear_content_memos` drops it (and the
  extraction and confirm caches): a measurement of the device path
  clears them before each call, or known content never reaches it.

A device fault degrades instead of failing: a fault that a dispatch or
a collect raises trips a breaker of the batch's shape class, and the
batch is redone on the exact CPU oracle — the whole-row redo that
overflowed rows take — so its verdicts and extractions are
bit-identical (``EngineStats.device_faults``, ``degraded_batches``).
After ``device_breaker_threshold`` faults in a row the breaker opens
and the shape class stays on the host for ``device_breaker_cooldown_s``;
then one probe batch goes to the card again. On the card only an
injected fault (``FaultInjected``, from the ``device.dispatch`` fault
point) degrades: a real launch or collect error — a CUDA error, or a
sticky fault that poisons the context — propagates and fails the job,
so no kernel failure moves work to the host unseen. On the CPU any
exception degrades, as in the JAX package. The kernels' libraries load
when the engine is built, outside the breaker: a kernel that does not
build or load raises there and never degrades a batch.

A live engine takes a changed corpus without a rebuild
(:meth:`MatchEngine.refresh_corpus`).

With a fleet result tier attached (:meth:`MatchEngine.attach_result_cache`,
a ``swarm_tpu_torch.cache.ResultCacheClient``; the worker attaches one
when ``SWARM_CACHE_BACKEND`` is set) the verdict memo is the L1 in front
of it, and a row resolves in the reference's order: L1, then the shared
tier, then the card. The encode's lookup asks the tier for the contents
the L1 missed and inserts its hits into the L1 before the misses are
encoded; the scheduler does the same in its prefetch stage
(:meth:`MatchEngine.prefetch_shared_memo`); the batched walk's confirm
verdicts are read from and written to the tier's confirm family; and
every fully resolved walked row is written back after its L1 insert. A
tier entry is a walked result for the same content under the same corpus
epoch, so the outputs are byte-identical with the tier off, cold, warm,
failing or moved to a new epoch; only the rows that reach the card
change.
"""

from __future__ import annotations

import binascii
import dataclasses
import os
import re
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from swarm_tpu_torch.fingerprints.compile import CompiledDB, compile_corpus
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.native.scanio import ext_resolve, plane_bits, rows_dedup
from swarm_tpu_torch.ops import cpu_ref, fastre
from swarm_tpu_torch.ops.encoding import _RotatingPool, encode_batch, round_up
from swarm_tpu_torch.ops.match import DeviceDB, Device
from swarm_tpu_torch.parallel import multihost
from swarm_tpu_torch.parallel.mesh import make_mesh
from swarm_tpu_torch.parallel.sharded import ShardedMatcher, pad_streams_for_seq
from swarm_tpu_torch.resilience.breaker import BreakerBoard
from swarm_tpu_torch.resilience.faults import FaultInjected
from swarm_tpu_torch.telemetry.engine_export import register_engine
from swarm_tpu_torch.telemetry.memo_export import L1_HITS, L1_MISSES
from swarm_tpu_torch.telemetry.shard_export import RANK_FILL


@dataclasses.dataclass
class RowMatches:
    """Exact match set for one response row."""

    template_ids: list
    extractions: dict  # template_id -> list[str]
    # uncertain pairs the host re-checked. Under content dedup a
    # confirm happens once per DISTINCT content and is attributed to
    # the group's representative row — duplicate members report 0
    # (the work genuinely wasn't repeated for them).
    confirmed_on_host: int = 0
    # workflow gate planes for this row: packed (cond_v, cond_u,
    # emit_v, emit_u) uint8 rows from the device gate-apply stage, or
    # None when the row was memo-served, redone, or the corpus lowered
    # no workflow terms — the runner then resolves every condition on
    # the host (exact either way).
    wf: Optional[tuple] = None


@dataclasses.dataclass
class PackedMatches:
    """Exact verdicts for one batch in wire form.

    ``bits[b, t >> 3] & (0x80 >> (t & 7))`` is template ``t``'s verdict
    for row ``b`` (np.packbits MSB-first convention); ``template_ids``
    maps the column index to ids. ``extractions`` is sparse:
    ``(row, template_id) -> list[str]``. ``host_always_matches`` lists
    (row, template_id) hits from the host-only tail, if any.
    """

    bits: np.ndarray  # uint8 [B, ceil(NT/8)]
    template_ids: list
    extractions: dict
    host_always_matches: list
    # row -> host confirmations spent on it. Confirms happen once per
    # DISTINCT content (dedup) and land on the representative row.
    confirms_per_row: dict
    # workflow gate planes: {"cond_v", "cond_u", "emit_v", "emit_u"}
    # packed uint8 [B, ...] + "valid" bool [B] (False for memo-served /
    # redone rows — their planes are stale or absent); None when the
    # corpus lowered no workflow terms
    wf: Optional[dict] = None
    # Buffer lifetime: ``MatchEngine.match_packed`` draws ``bits`` from a
    # per-shape rotating pool (``ops/encoding._RotatingPool``): the plane
    # is overwritten 8 same-shape batches later, so a caller that keeps
    # results longer copies them.


@dataclasses.dataclass
class EngineStats:
    rows: int = 0
    batches: int = 0
    # miss uniques the device matched (memo-served and duplicate rows
    # never reach it)
    unique_rows: int = 0
    # the verdict memo's lookup, row-granular: rows served, rows missed
    memo_hits: int = 0
    memo_misses: int = 0
    # the memo lookup and the encode of the miss uniques
    encode_seconds: float = 0.0
    device_seconds: float = 0.0
    # the launches' part of device_seconds, split at each dispatch's
    # survivor read: phase A up to and including the 4-byte read,
    # phase B after it (the rest of device_seconds is the collects' wait)
    phase_a_seconds: float = 0.0
    phase_b_seconds: float = 0.0
    host_confirm_seconds: float = 0.0
    host_confirm_pairs: int = 0
    host_always_pairs: int = 0
    overflow_rows: int = 0
    # memo-served ROW count, summed per batch (rows whose verdict came
    # from the cross-batch memo without device or walk work)
    memo_slots: int = 0
    # device-degraded mode: device-path failures observed, and batches
    # that ran on the exact CPU-oracle fallback (results stay
    # bit-identical — only throughput degrades)
    device_faults: int = 0
    degraded_batches: int = 0
    # host-walk sub-phases (all included in host_confirm_seconds):
    # uncertainty resolution, the extraction pass, memo inserts, and
    # the member fan-out/fixup assembly
    unc_seconds: float = 0.0
    ext_seconds: float = 0.0
    insert_seconds: float = 0.0
    fixup_seconds: float = 0.0
    # ext-phase sub-splits (all included in ext_seconds): the native
    # hit-enumeration C pass, undecided-op host confirms, and the
    # extraction proper (batched crex + oracle fallbacks)
    ext_enum_seconds: float = 0.0
    ext_resolve_seconds: float = 0.0
    ext_extract_seconds: float = 0.0
    # batched-confirm walk: (row, matcher)/(row, op) pairs whose verdict
    # was precomputed by the row-parallel native passes, the dispatch
    # rounds that ran, the plan+dispatch wall (included in
    # host_confirm_seconds via unc/ext), and the worker pool width (0 =
    # batching inline or disabled)
    walk_batched_pairs: int = 0
    walk_batch_rounds: int = 0
    walk_precompute_seconds: float = 0.0
    walk_pool_threads: int = 0


def _bit(packed: np.ndarray, b: int, i: int) -> bool:
    return bool((packed[b, i >> 3] >> (7 - (i & 7))) & 1)


_ROWDEP_VAR_RE = re.compile(r"\b(host|hostname|port|duration|ip)\b")


def _is_row_dependent(t: Template) -> bool:
    """Whether any matcher/extractor reads beyond response content
    (host/hostname/port/duration/ip dsl vars or the "host" part)."""
    for op in t.operations:
        for m in op.matchers:
            if (m.part or "") == "host":
                return True
            if any(_ROWDEP_VAR_RE.search(e) for e in m.dsl):
                return True
        for ex in op.extractors:
            if (ex.part or "") == "host":
                return True
    return False


def _content_key(r: Response) -> tuple:
    """The cross-batch verdict-memo key: everything the device and the
    content-side host walk read. host/port/duration are deliberately
    NOT in it (see MatchEngine._rowdep_t)."""
    return (
        r.banner, r.body, r.header, r.status,
        r.oob_protocols, r.oob_requests, r.oob_ips,
    )


def _dedup_rows(rows: list):
    """(uniq_indices, back, keys) — rows keyed by full response CONTENT,
    in one native pass (``rows_dedup``, exact compare).

    ``back[i]`` is the unique-slot index of row i; ``keys[s]`` is slot
    s's content key (built per unique slot only)."""
    uniq_arr, back = rows_dedup(rows)
    uniq = uniq_arr.tolist()
    keys = [_content_key(rows[i]) for i in uniq]
    return uniq, back, keys


def _place_rows_per_rank(nrows: list, padded: int, ranks: int):
    """Spread ``nrows`` real rows over ``ranks`` contiguous per-rank
    blocks of ``padded // ranks`` slots: rank r gets ``floor(n/R)`` or
    ``ceil(n/R)`` real rows at the head of its block, padding fills the
    tails. Sharding a [B] batch over 'data' is contiguous blocks, so
    without this a partial bucket lands every real row on rank 0 and
    the rest of the mesh matches pure padding.

    Returns ``(placed_rows, row_index)``: a ``padded``-length row list
    (pad slots are empty Responses — zero-length, matched by nothing)
    and the position of each real row in it (``row_index[i]`` is where
    real row i landed; relative order is preserved within and across
    blocks, so verdict planes gather back with one fancy index)."""
    n = len(nrows)
    per = padded // ranks
    base, extra = divmod(n, ranks)
    placed: list = [None] * padded
    row_index = np.empty(n, dtype=np.int64)
    i = 0
    for r in range(ranks):
        take = base + (1 if r < extra else 0)
        for j in range(take):
            pos = r * per + j
            placed[pos] = nrows[i]
            row_index[i] = pos
            i += 1
    pad = Response()
    placed = [row if row is not None else pad for row in placed]
    return placed, row_index


class MatchEngine:
    def __init__(
        self,
        templates: Sequence[Template],
        max_body: int = 4096,
        max_header: int = 1024,
        batch_rows: int = 1024,
        db: Optional[CompiledDB] = None,
        walk_threads: Optional[int] = None,  # None → SWARM_WALK_THREADS
        pipeline: Optional[str] = None,  # "on" | "off" | None → SWARM_PIPELINE
        device: Device = None,
        device_breaker_threshold: int = 2,
        device_breaker_cooldown_s: float = 60.0,
        mesh="auto",  # "auto" | None | parallel.mesh.Mesh
    ):
        self.templates = list(templates)
        self.db = db if db is not None else compile_corpus(self.templates)
        self.device = DeviceDB(self.db, device=device)
        #: the AOT library client attached through :meth:`attach_aot`
        self._aot_client = None
        # here, not under the breaker: a kernel that fails to build or
        # load must fail loudly, never degrade
        self.device.load_kernels()
        #: the sharded matcher over ``mesh`` (None on one device)
        self.sharded: Optional[ShardedMatcher] = None
        self.mesh = None
        self._resolve_backend(mesh)
        # device-degraded mode: a failure on the device path (on the
        # card, only an injected device.dispatch fault) trips a
        # per-shape-class breaker and the batch falls back to the exact
        # CPU oracle; the cooldown retries the device path, so a
        # transient fault heals itself
        self._on_card = self.device.device.type == "cuda" or (
            self.sharded is not None
            and any(d.type == "cuda" for d in self.sharded.devices))
        self._device_breakers = BreakerBoard(
            "engine.device",
            threshold=device_breaker_threshold,
            cooldown_s=device_breaker_cooldown_s,
        )
        self.max_body = max_body
        self.max_header = max_header
        self.batch_rows = batch_rows
        self.stats = EngineStats()
        # continuous-batching scheduler flag (swarm_tpu_torch/sched):
        # "on" routes multi-row :meth:`match` calls through the
        # prefetch/bucket/backpressure pipeline; None defers to
        # SWARM_PIPELINE (default off)
        if pipeline is None:
            pipeline = os.environ.get("SWARM_PIPELINE", "off")
        self.pipeline = (
            "on" if str(pipeline).lower() in ("on", "1", "true") else "off"
        )
        self._sched = None  # lazy BatchScheduler
        # guards the stats fields BOTH the submit thread (begin_packed)
        # and the scheduler's walk worker (finish_packed → _walk_plane),
        # or the encode thread and the matching thread, update —
        # unsynchronized float += across threads loses updates
        self._stats_lock = threading.Lock()  # guards: stats.device_seconds, phase_*_seconds, encode_seconds, memo_hits, memo_misses, device_faults
        # row-parallel batched confirm walk: explicit arg >
        # SWARM_WALK_THREADS > SWARM_EXT_THREADS (compat) > spare cores.
        # 0 = serial reference walk; 1 = batched native passes, inline;
        # >=2 adds the worker pool.
        self._walk_threads_arg = walk_threads
        self._bind_db()
        # content-keyed extraction memo (cross-batch): scan responses
        # repeat heavily (default pages are byte-identical fleet-wide)
        # and tech templates with version extractors fire on most rows,
        # so re-running the same regex/kval over the same bytes per row
        # dominated the host walk. Keyed per EXTRACTOR on exactly the
        # content it reads; bounded FIFO (keys hold the part bytes).
        self._ext_cache: dict = {}
        # cross-batch confirm memo for part-keyed matcher types
        # (word/regex/binary/size) — same bounding as _ext_cache
        self._confirm_cache: dict = {}
        # C resident verdict cache (native/scanio.VerdictMemo): content
        # key -> (packed verdict row, extraction entries, deferred
        # row-dependent template ids); its lookup pass serves known
        # rows straight into the batch's bits plane with no per-row
        # Python work. Entries are only stored for fully-resolved
        # (non-truncated, non-overflow) content. Created on first encode.
        self._vmemo = None
        # fleet-wide shared result tier: when a ResultCacheClient is
        # attached, the memo above becomes the L1 in front of it —
        # lookups go L1 → shared tier → device, fresh walk results
        # batch-write back after the L1 insert, and the batched walk's
        # confirm cache promotes into the tier's confirm family. None
        # (the default) keeps every path unchanged.
        self._result_cache = None
        # row ids the scheduler's prefetch stage already consulted the
        # shared tier for (hits landed in the L1, misses are
        # suppressed client-side): the encode-time consult skips them
        # so a fresh row's content is sha256'd once per batch, not
        # twice. id() keys are safe here because a stale entry can
        # only SKIP a consult (the row is computed locally) — it can
        # never serve wrong data. Bounded FIFO via _cache_put.
        self._shared_seen: dict = {}
        # recycled verdict planes for reuse_buffers encodes, keyed PER
        # SHAPE (see _encode_native)
        self._bits_pool = _RotatingPool(depth=8)
        # export this engine's stats to the registry: weakref-tracked,
        # read only at scrape time — no cost on the match path
        register_engine(self)

    def _bind_db(self) -> None:
        """Derive every db-indexed lookup table the walk and the
        sparse-confirmation paths read (provenance maps, extractor
        plans, CSR op->matcher tables). Called from __init__ and again
        by :meth:`refresh_corpus` after a corpus-delta swap — the
        tables are pure functions of ``self.db``."""
        db = self.db
        # device matcher/op id → source objects for sparse confirmation.
        # m == -1 is a synthesized extraction prefilter (extractor-only
        # op, compile.lower_extraction_prefilter): no source matcher —
        # its op is always prefiltered, so confirmation goes through
        # _confirm_operation, never the per-matcher path
        self._m_obj = [
            db.templates[t].operations[o].matchers[m] if m >= 0 else None
            for t, o, m in db.m_src
        ] if db.templates else []
        # per-pattern extraction-prefilter provenance (m == -1 rows):
        # matcher id -> (extractor_local, pattern_idx), (-1, -1) for
        # real matchers and the fire-always degrade
        ext_src = getattr(db, "m_ext_src", None)
        self._m_ext_src_py = (
            [(int(a), int(b)) for a, b in ext_src]
            if ext_src is not None
            else [(-1, -1)] * len(self._m_obj)
        )
        # matcher id -> owning op id (per-pattern confirm needs the op
        # object; built once from the op->matchers table)
        self._m_op_id = [0] * len(self._m_obj)
        for op_id_, ids_ in enumerate(db.op_matchers):
            for m_ in ids_:
                self._m_op_id[int(m_)] = op_id_
        # ops lowered as per-pattern extraction prefilters: op id ->
        # tuple of (extractor_local, pattern_idx) aligned with the op's
        # matcher ids — the walk turns the device pm-uncertainty bits
        # into the extraction pass's live-pattern hints
        self._op_ext_pats = {}
        for op_id_, ids_ in enumerate(db.op_matchers):
            pats = [self._m_ext_src_py[int(m_)] for m_ in ids_]
            if pats and all(p[0] >= 0 for p in pats):
                self._op_ext_pats[op_id_] = tuple(pats)
        # templates whose EVERY op is a per-pattern extraction
        # prefilter: their verdict IS "any extraction non-empty", so
        # the walk defers their uncertain bits to the batched
        # extraction pass (one native dispatch per distinct pattern)
        # instead of paying a per-(row, pattern) confirm round trip
        self._pseudo_t = frozenset(
            t_idx for t_idx, t_op_ids in enumerate(db.t_ops)
            if len(t_op_ids)
            and all(int(op) in self._op_ext_pats for op in t_op_ids)
        )
        self._op_obj = [
            db.templates[t].operations[o] for t, o in db.op_src
        ] if db.templates else []
        # all-regex extractor ops: precomputed (id(ex), ex, part) plan
        # — _extract_pending's unified inline loop rides it for both
        # cache hits AND misses (per-hit analyze() lookups and the
        # segs/fills bookkeeping cost more than the actual literal
        # gates at walk rates). Pattern infos resolve lazily on an
        # op's FIRST fired hit (_op_plan_infos): analyzing every
        # pattern of every extractor op up front would tax engine
        # construction for ops a scan never fires.
        self._op_ext_plan = {}
        self._op_ext_infos: dict = {}  # op_id -> per-ex infos tuples
        for op_id_, op_ in enumerate(self._op_obj):
            if op_.extractors and all(
                ex.type == "regex" for ex in op_.extractors
            ):
                self._op_ext_plan[op_id_] = tuple(
                    (id(ex), ex, ex.part) for ex in op_.extractors
                )
        # templates with extractors need a host pass on *hits* even when
        # the verdict itself was device-certain, so extraction output
        # stays bit-identical to the oracle
        self._has_extractors = [
            any(op.extractors for op in t.operations) for t in db.templates
        ]
        self._ext_t_idx = [
            i for i, has in enumerate(self._has_extractors) if has
        ]
        self._ext_cols = np.asarray(self._ext_t_idx, dtype=np.int64)
        self._ext_masks = (
            0x80 >> (self._ext_cols & 7)
        ).astype(np.uint8) if len(self._ext_cols) else np.zeros(0, np.uint8)
        # packed byte mask of extractor-template bits: the ext pass
        # ANDs it against the verdict plane (contiguous, one pass)
        # instead of a [B, n_ext] fancy-gather per batch
        self._ext_byte_mask = np.zeros(
            (db.num_templates + 7) // 8, dtype=np.uint8
        )
        for t_idx in self._ext_t_idx:
            self._ext_byte_mask[t_idx >> 3] |= 0x80 >> (t_idx & 7)
        # vectorized per-op matcher-id tables: resolving a giant op
        # (fingerprinthub: 2,897 matchers) must not walk bits in Python
        self._op_m_arr = [
            np.asarray(ids, dtype=np.int64) for ids in db.op_matchers
        ]
        # pre-shifted byte/bit index twins (the uncertain-op gather
        # runs per (row, op) — recomputing ids>>3 / 7-(ids&7) there
        # allocated three temporaries per pair)
        self._op_m_bytes = [ids >> 3 for ids in self._op_m_arr]
        self._op_m_shift = [
            (7 - (ids & 7)).astype(np.uint8) for ids in self._op_m_arr
        ]
        # CSR twin of op_matchers for the batched walk's vectorized
        # candidate expansion (one fancy index over the whole batch's
        # candidate ops instead of a per-op gather)
        self._op_m_indptr = np.zeros(
            len(self._op_m_arr) + 1, dtype=np.int64
        )
        for i, ids in enumerate(self._op_m_arr):
            self._op_m_indptr[i + 1] = self._op_m_indptr[i] + len(ids)
        self._op_m_flat = (
            np.concatenate(self._op_m_arr)
            if self._op_m_arr
            else np.zeros(0, dtype=np.int64)
        ).astype(np.int64, copy=False)
        self._op_m_counts = np.diff(self._op_m_indptr)
        # python-native twins of the per-template op tables: the walk's
        # inner loops hash (row, op) keys and index bit planes with
        # these, and numpy int scalars make every such op ~3x slower
        self._t_ops_py = [
            tuple(int(o) for o in ops) for ops in db.t_ops
        ]
        self._op_prefilter_py = [bool(x) for x in db.op_prefilter]
        self._op_cond_and_py = [bool(x) for x in db.op_cond_and]
        # ROW-dependent templates: verdicts/extractions that read
        # beyond the response content (host/port/duration dsl vars,
        # part "host") — e.g. the takeover family's
        # !contains(host, "tumblr.com") gates. Content-identical rows
        # from different hosts can disagree on exactly these templates,
        # so the content-dedup fast path resolves them per member row
        # (everything else resolves once per distinct content).
        # Conservative detection: false positives only cost speed.
        self._rowdep_t = frozenset(
            i for i, t in enumerate(db.templates) if _is_row_dependent(t)
        )
        # extractor templates that are ALSO row-dependent (their
        # values may read host): the per-batch certain-set scan walks
        # only these columns, not all extractor templates
        self._rowdep_ext_t = [
            t_idx for t_idx in self._ext_t_idx if t_idx in self._rowdep_t
        ]
        # CSR twin of t_ops + rowdep byte mask for the C extraction
        # driver (native/fastpack.cpp sw_ext_resolve)
        self._t_ops_indptr = np.zeros(db.num_templates + 1, dtype=np.int64)
        for i, ops in enumerate(self._t_ops_py):
            self._t_ops_indptr[i + 1] = self._t_ops_indptr[i] + len(ops)
        self._t_ops_flat = np.asarray(
            [o for ops in self._t_ops_py for o in ops], dtype=np.int64
        )
        self._rowdep_mask = np.zeros(db.num_templates, dtype=np.uint8)
        for i in self._rowdep_t:
            self._rowdep_mask[i] = 1

    _EXT_CACHE_MAX = 16384

    @classmethod
    def _cache_put(cls, cache: dict, key, val) -> None:
        """Bounded FIFO insert shared by the cross-batch content memos:
        past the cap, drop the oldest half (dict preserves order).
        Thread-tolerant under the GIL for the walk pool's fallback
        tasks: each dict op is atomic, the key snapshot tolerates
        concurrent inserts, and eviction uses pop (two racing evictors
        must not KeyError on a key the other already dropped). Values
        for one key are always identical (pure content functions), so
        a double insert is benign."""
        if len(cache) >= cls._EXT_CACHE_MAX:
            for k in list(cache)[: cls._EXT_CACHE_MAX // 2]:
                cache.pop(k, None)
        cache[key] = val

    def _extract_op(self, op, row: Response) -> list:
        """cpu_ref._extract with per-extractor content memoization."""
        out: list = []
        cache = self._ext_cache
        for ex in op.extractors:
            if ex.type in ("regex", "json", "xpath"):
                key = (id(ex), row.part(ex.part))
            elif ex.type == "kval":
                key = (id(ex), row.part("header"), row.oob_ips)
            else:
                out.extend(cpu_ref.extract_one(ex, row))
                continue
            vals = cache.get(key)
            if vals is None:
                if ex.type == "regex":
                    vals = self._accel_extract_regex(ex, key[1])
                else:
                    vals = cpu_ref.extract_one(ex, row)
                self._cache_put(cache, key, vals)
            out.extend(vals)
        return out

    @property
    def walk_threads(self) -> int:
        """Effective walk worker count: constructor arg >
        ``SWARM_WALK_THREADS`` > ``SWARM_EXT_THREADS`` (compat) >
        spare cores capped at 4. 0 disables the batched walk entirely
        (the serial reference path); 1 runs the batched native passes
        inline; >=2 row-shards them across the worker pool."""
        n = self._walk_threads_arg
        if n is None:
            import os as _os

            env = _os.environ.get("SWARM_WALK_THREADS") or _os.environ.get(
                "SWARM_EXT_THREADS"
            )
            n = int(env) if env else min(
                4, max(1, (_os.cpu_count() or 1) - 1)
            )
        return max(0, int(n))

    def configure_walk(self, threads: Optional[int]) -> None:
        """Re-point the walk pool at runtime (bench A/B, tests): shuts
        any existing pool down, then re-decides lazily on next use.
        ``None`` restores env-derived sizing."""
        pool = getattr(self, "_walk_pool_obj", None)
        if pool:
            pool.shutdown(wait=True)
        self._walk_pool_obj = None
        self._walk_threads_arg = threads
        self.stats.walk_pool_threads = 0

    def _walk_pool(self):
        """Shared row-sharded worker pool for the walk's GIL-released
        native batches — confirm passes AND extraction finditer
        batches (what used to be the extraction-only ``_ext_pool``).
        Sized by :attr:`walk_threads`; None when threading is off
        (batched passes then run inline on the walk thread)."""
        pool = getattr(self, "_walk_pool_obj", None)
        if pool is not None:
            return pool or None
        workers = self.walk_threads
        if workers <= 1:
            self._walk_pool_obj = ()  # sentinel: decided, disabled
            return None
        from concurrent.futures import ThreadPoolExecutor

        self._walk_pool_obj = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="swarm-walk"
        )
        self.stats.walk_pool_threads = workers
        return self._walk_pool_obj

    def _resolve_regex_ex(
        self, ex, ex_local, key, hint, infos,
        cache, fills, tasks, ncrex, _fastre,
    ) -> tuple:
        """Resolve one regex extractor against one content part:
        ``("v", vals)`` when decided inline (and memoized), ``("k",
        key)`` when a batched finditer task was registered in
        ``fills``/``tasks``. Gate order is cheapest-proof-first and
        every gate is a necessary-condition proof (skipping a pattern
        is exact): device pm-bit hint → required-literal CNF
        (the device bit only proves ONE group's gram presence; the
        other mandatory groups, e.g. the '@' an email must contain,
        are a few bytes.find) → lazy-DFA existence (a proven-absent
        pattern runs no finditer at all; a missing match costs the
        backtracker/re its worst case — 2-19 ms for leading-repeat
        shapes vs ~6 µs here)."""
        part = key[1]
        if hint is not None:
            live = hint.get(ex_local, [])
            if live:
                lowered = part.lower()
                live = [
                    p
                    for p in live
                    if not _fastre.literals_absent(infos[p], lowered)
                ]
        else:
            lowered = part.lower()
            live = []
            for p_idx, info in enumerate(infos):
                if info.ok and (info.literals or info.cnf) and (
                    _fastre.literals_absent(info, lowered)
                ):
                    continue
                live.append(p_idx)
        if live:
            kept = []
            for p_idx in live:
                nfa = infos[p_idx].nfa
                if nfa is not None and ncrex.exists(nfa, part) is False:
                    continue
                kept.append(p_idx)
            live = kept
        if not live:
            self._cache_put(cache, key, [])
            return ("v", [])
        if not isinstance(ex.group, int) or not all(
            infos[p].ok and ncrex.usable(infos[p].cprog) for p in live
        ):
            vals = self._accel_extract_regex(ex, part)
            self._cache_put(cache, key, vals)
            return ("v", vals)
        fills[key] = {"ex": ex, "part": part, "live": live, "by_pat": {}}
        for p_idx in live:
            t = tasks.setdefault(
                (ex.regex[p_idx], ex.group),
                {"cp": infos[p_idx].cprog, "items": [], "parts": []},
            )
            t["items"].append((key, p_idx))
            t["parts"].append(part)
        return ("k", key)

    def _extract_pending(
        self, pending: list, nrows: list, hints: Optional[dict] = None
    ) -> dict:
        """(b, t_idx) -> ordered extraction values for the native
        walk's resolved hit list.

        ``hints``: optional {(b, op_id): {ex_local: [p_idx, ...]}}
        of LIVE patterns for per-pattern extraction-prefilter ops
        (from the device pm-uncertainty bits): non-live patterns are
        exact no-matches and are skipped with no host work at all —
        every structure here is sized by the live count, never the
        op's full pattern population (credentials-disclosure: 689).

        Semantics are exactly ``_extract_op`` applied in hit order —
        same content-keyed memo, same extractor/pattern ordering, same
        oracle fallbacks — but every crex-able regex extraction runs as
        ONE batched native dispatch per distinct (pattern, group) over
        all pending contents (native/crex.cpp sw_crex_finditer_batch):
        at fresh-content walk rates the per-call dispatch overhead was
        the dominant extraction cost."""
        out: dict = {}
        if not pending:
            return out
        from swarm_tpu_torch.native import crex as ncrex
        from swarm_tpu_torch.ops import fastre as _fastre

        cache = self._ext_cache
        segs: dict = {}   # (b, t_idx) -> [("v", vals) | ("k", key)]
        fills: dict = {}  # key -> {"ex", "part", "by_pat"}
        tasks: dict = {}  # (pattern, group) -> {"cp", "items", "parts"}
        # Unified inline loop. All-regex ops (the population, incl.
        # every per-pattern-prefilter pseudo op) resolve each extractor
        # in place with precomputed PatternInfos — cache hit, literal/
        # CNF gate, DFA existence, [] short-circuit — and only rows
        # that create a batch task (or share a key with one) touch the
        # segs/fills bookkeeping. Mixed/non-regex ops keep the general
        # per-extractor walk. A (b, t) whose hits span both modes keeps
        # extraction order by replaying its inline values into the seg
        # list at transition time.
        plan_map = self._op_ext_plan
        cache_put = self._cache_put
        fast_acc: dict = {}  # (b, t_idx) -> [vals, ...] in hit order

        def to_seg(bt) -> list:
            seg = segs.get(bt)
            if seg is None:
                prior = fast_acc.pop(bt, None)
                seg = segs[bt] = (
                    [("v", v) for v in prior] if prior else []
                )
            return seg

        for b, t_idx, op_id in pending:
            bt = (b, t_idx)
            row = nrows[b]
            plan = plan_map.get(op_id)
            hint = hints.get((b, op_id)) if hints else None
            if plan is None:
                # mixed/non-regex extractors: general per-ex walk
                seg = to_seg(bt)
                for ex_local, ex in enumerate(
                    self._op_obj[op_id].extractors
                ):
                    if ex.type in ("regex", "json", "xpath"):
                        key = (id(ex), row.part(ex.part))
                    elif ex.type == "kval":
                        key = (id(ex), row.part("header"), row.oob_ips)
                    else:
                        seg.append(("v", cpu_ref.extract_one(ex, row)))
                        continue
                    vals = cache.get(key)
                    if vals is not None:
                        seg.append(("v", vals))
                        continue
                    if key in fills:
                        seg.append(("k", key))
                        continue
                    if ex.type != "regex":
                        vals = cpu_ref.extract_one(ex, row)
                        cache_put(cache, key, vals)
                        seg.append(("v", vals))
                        continue
                    # regex inside a mixed op: same inline resolution,
                    # infos from the shared analyze cache
                    infos = tuple(
                        _fastre.analyze(p) for p in ex.regex
                    )
                    entry = self._resolve_regex_ex(
                        ex, ex_local, key, hint, infos,
                        cache, fills, tasks, ncrex, _fastre,
                    )
                    seg.append(entry)
                continue
            # all-regex plan: inline resolution, no seg unless a task
            entries = None   # created only when a "k" entry appears
            chunks = None
            infos_op = self._op_ext_infos.get(op_id)
            if infos_op is None:
                infos_op = self._op_ext_infos[op_id] = tuple(
                    tuple(_fastre.analyze(p) for p in e.regex)
                    for _i, e, _pn in plan
                )
            for ex_local, (id_ex, ex, part_name) in enumerate(plan):
                infos = infos_op[ex_local]
                part = row.part(part_name)
                key = (id_ex, part)
                vals = cache.get(key)
                if vals is None and key not in fills:
                    entry = self._resolve_regex_ex(
                        ex, ex_local, key, hint, infos,
                        cache, fills, tasks, ncrex, _fastre,
                    )
                    if entry[0] == "v":
                        vals = entry[1]
                    # else: falls through to the "k" handling below
                elif vals is None:
                    entry = ("k", key)
                if vals is not None:
                    if entries is not None:
                        entries.append(("v", vals))
                    elif vals:
                        if chunks is None:
                            chunks = []
                        chunks.append(vals)
                    continue
                # task-backed key: this (b, t) needs seg ordering
                if entries is None:
                    entries = [("v", c) for c in chunks] if chunks else []
                    chunks = None
                entries.append(entry)
            if entries is not None:
                to_seg(bt).extend(entries)
            elif chunks:
                acc = fast_acc.get(bt)
                if acc is None and bt in segs:
                    segs[bt].extend(("v", c) for c in chunks)
                else:
                    if acc is None:
                        fast_acc[bt] = acc = []
                    acc.extend(chunks)

        done: dict = {}
        if fills:
            failed: set = set()
            task_list = list(tasks.items())
            # the batch C calls release the GIL: on hosts with spare
            # cores the per-pattern scans run concurrently (disjoint
            # outputs, no shared mutable state inside the call)
            pool = self._walk_pool()
            if pool is not None and len(task_list) > 1:
                results = list(pool.map(
                    lambda kv: ncrex.finditer_spans_batch(
                        kv[1]["cp"], kv[1]["parts"], kv[0][1]
                    ),
                    task_list,
                ))
            else:
                results = [
                    ncrex.finditer_spans_batch(t["cp"], t["parts"], group)
                    for (_pat, group), t in task_list
                ]
            for (_key, t), res in zip(task_list, results):
                for (key, p_idx), spans in zip(t["items"], res):
                    if spans is None:
                        failed.add(key)  # per-item native budget hit
                        continue
                    f = fills[key]
                    text = f.get("text")
                    if text is None:
                        text = f["text"] = f["part"].decode("latin-1")
                    f["by_pat"][p_idx] = [
                        None if s < 0 else text[s:e] for s, e in spans
                    ]
            for key, f in fills.items():
                if key in failed:
                    # any pattern short of native resources: the whole
                    # extractor re-runs on the exact per-call path
                    vals = self._accel_extract_regex(f["ex"], f["part"])
                else:
                    by_pat = f["by_pat"]
                    vals = [v for p in f["live"] for v in by_pat[p]]
                self._cache_put(cache, key, vals)
                done[key] = vals

        for bt, seg in segs.items():
            vals = []
            for kind, v in seg:
                vals.extend(v if kind == "v" else done[v])
            out[bt] = vals
        for bt, chunks in fast_acc.items():
            # fresh list: cached value lists must never be aliased into
            # per-batch results (downstream consumers own `vals`)
            vals = []
            for c in chunks:
                vals.extend(c)
            out[bt] = vals
        return out

    @staticmethod
    def _accel_extract_regex(ex, part: bytes) -> list:
        """Candidate-anchored regex extraction — byte-identical to
        cpu_ref.extract_one for type=regex (fuzz-pinned by
        tests/test_fastre.py); patterns the accelerator can't take
        fall back to the oracle's finditer loop per pattern.

        Per-pattern literal gate: a pattern whose necessary literals
        are all absent CANNOT match — skipping it is exact and turns a
        fired multi-hundred-pattern extractor (credentials-disclosure:
        689 regexes) into a few bytes.find calls plus the one or two
        patterns whose literal actually occurred."""
        from swarm_tpu_torch.native import crex as _ncrex

        out: list = []
        text = None
        lowered = None
        for pattern in ex.regex:
            info = fastre.analyze(pattern)
            if info.ok and (info.literals or info.cnf):
                if lowered is None:
                    lowered = part.lower()
                if fastre.literals_absent(info, lowered):
                    continue
            # linear-time existence pre-gate (same proof as the
            # batched path): no match => no values, skip the finditer
            if info.nfa is not None and _ncrex.exists(
                info.nfa, part
            ) is False:
                continue
            if text is None:
                text = part.decode("latin-1")
            vals = fastre.finditer_values(pattern, part, text, ex.group)
            if vals is not None:
                out.extend(vals)
                continue
            # fallback mirrors cpu_ref.extract_one exactly
            try:
                for m in cpu_ref._compile_cached(pattern).finditer(text):
                    try:
                        out.append(m.group(ex.group))
                    except IndexError:
                        out.append(m.group(0))
            except re.error:
                continue
        return out

    def _confirm_ext_pattern(self, m_id: int, row: Response) -> bool:
        """Exact verdict of ONE synthesized extraction-prefilter
        matcher: does this extraction pattern match the row's part
        (any match ⇒ the extractor extracts ⇒ the op matches — group
        participation doesn't matter for the bool). Content-keyed
        cache shared with the matcher confirms."""
        op = self._op_obj[self._m_op_id[m_id]]
        ex_local, p_idx = self._m_ext_src_py[m_id]
        if ex_local < 0:  # fire-always degrade: whole-op confirm
            return self._confirm_operation(op, row)
        ex = op.extractors[ex_local]
        pattern = ex.regex[p_idx]
        part = row.part(ex.part)
        key = ("pe", m_id, part)
        cache = self._confirm_cache
        v = cache.get(key)
        if v is None:
            info = fastre.analyze(pattern)
            if not info.ok:
                v = False  # invalid under re: extract_one yields nothing
            else:
                text = part.decode("latin-1")
                sv = fastre.search_bool(pattern, part, text)
                if sv is None:
                    sv = info.rex.search(text) is not None
                v = bool(sv)
            self._cache_put(cache, key, v)
        return v

    def _confirm_operation(self, op, row: Response) -> bool:
        """Exactly ``cpu_ref.match_operation(op, row)[0]`` with the
        part-keyed confirm cache and regex prefilter applied per
        matcher — the superset-lowered ops route here, where the slow
        literal-less regexes (waf-detect's cloudfront backtracker)
        otherwise re-scan every confirm."""
        if not op.matchers:
            # extractor-only operation: matches iff any extractor
            # extracts (nuclei semantics; cpu_ref.match_operation's
            # empty-verdicts branch is the oracle twin). _extract_op's
            # content-keyed memo makes the later extraction pass a
            # cache hit on the same values.
            return bool(op.extractors) and bool(self._extract_op(op, row))
        verdicts = []
        cache = self._confirm_cache
        for matcher in op.matchers:
            if matcher.type in ("word", "regex", "binary", "size"):
                # 'op'-namespaced: the walk's confirm_matcher keys this
                # same dict by small-int matcher index — unnamespaced,
                # correctness would rest on id() never colliding with it
                part = row.part(matcher.part)
                key = ("op", id(matcher), part)
                v = cache.get(key)
                if v is None:
                    raw = (
                        self._regex_matcher_raw(matcher, part)
                        if matcher.type == "regex"
                        else None
                    )
                    if raw is not None:
                        v = (not raw) if matcher.negative else raw
                    else:
                        mv = cpu_ref.match_matcher(matcher, row)
                        v = bool(mv) if mv is not None else False
                    self._cache_put(cache, key, v)
            else:
                mv = cpu_ref.match_matcher(matcher, row)
                v = bool(mv) if mv is not None else False
            verdicts.append(v)
        if not verdicts:
            return False
        if op.matchers_condition == "and":
            return all(verdicts)
        return any(verdicts)

    def _redo_template(self, template, row: Response):
        """``(matched, extractions)`` — exactly the fields the redo
        pass reads from ``cpu_ref.match_template``, evaluated through
        the prefiltered+cached op/extract paths (identical semantics:
        _confirm_operation ≡ match_operation[0], _extract_op ≡ the
        oracle's extractor loop with content memoization)."""
        if not row.alive:
            return False, []
        matched = False
        extractions: list = []
        for op in template.operations:
            if self._confirm_operation(op, row):
                matched = True
                extractions.extend(self._extract_op(op, row))
        return matched, extractions

    def _confirm_matcher_serial(self, m_id: int, row: Response) -> bool:
        """Exact verdict of ONE device matcher for one row — the
        serial reference confirm (content-keyed cache + per-pattern
        proofs). The batched walk's precomputed planes must agree with
        this bit for bit (tests/test_walk_parallel.py); pairs the
        native passes can't answer re-run here."""
        matcher = self._m_obj[m_id]
        if matcher is None:
            # synthesized extraction prefilter: per-pattern verdict
            return self._confirm_ext_pattern(m_id, row)
        if matcher.type not in ("word", "regex", "binary", "size"):
            # dsl/status/kval read beyond matcher.part — not cacheable
            mv = cpu_ref.match_matcher(matcher, row)
            return bool(mv) if mv is not None else False
        part = row.part(matcher.part)
        key = ("m", m_id, part)
        cache = self._confirm_cache
        v = cache.get(key)
        if v is None:
            # exact per-pattern evaluation with literal/candidate
            # proofs: most confirms are q-gram collisions whose slow
            # regex (waf-detect's ~2 ms backtrackers) certainly can't
            # match — those are decided at bytes.find speed; unproven
            # patterns get a real re.search. Negation mirrors
            # cpu_ref.match_matcher.
            raw = (
                self._regex_matcher_raw(matcher, part)
                if matcher.type == "regex"
                else None
            )
            if raw is not None:
                v = (not raw) if matcher.negative else raw
            else:
                mv = cpu_ref.match_matcher(matcher, row)
                v = bool(mv) if mv is not None else False
            self._cache_put(cache, key, v)
        return v

    def _regex_matcher_raw(self, matcher, part: bytes):
        """The EXACT raw (pre-negation) verdict of a regex matcher over
        ``part`` — each pattern decided by the cheapest sound means:
        required-literal absence (bytes.find), candidate-anchored
        search (ops/fastre.py), or a real ``re.search`` when neither
        proof applies — with short-circuit under the matcher condition.
        Returns None when any pattern fails to compile (the oracle's
        unsupported semantics; caller must fall back)."""
        if not matcher.regex:
            return None
        infos = [fastre.analyze(p) for p in matcher.regex]
        if not all(i.ok for i in infos):
            return None
        lowered = None
        text = None
        want_all = matcher.condition == "and"
        for p, info in zip(matcher.regex, infos):
            if info.literals or info.cnf:
                if lowered is None:
                    lowered = part.lower()
                if fastre.literals_absent(info, lowered):
                    if want_all:
                        return False
                    continue
            if text is None:
                text = part.decode("latin-1")
            v = fastre.search_bool(p, part, text)
            if v is None:
                v = info.rex.search(text) is not None
            if v and not want_all:
                return True
            if not v and want_all:
                return False
        return want_all

    # ------------------------------------------------------------------
    def _resolve_backend(self, mesh) -> None:
        """``"auto"``: in a process group of several processes, the mesh
        over every process's devices; else a mesh over every local CUDA
        device when the engine runs on the card and there is more than
        one, else one device; a Mesh: that mesh. The sharded matcher's kernels load
        here, outside the breaker, as the DeviceDB's do."""
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', None or a Mesh, got {mesh!r}")
            mesh = None
            if multihost.process_count() > 1:
                # a process group (parallel/multihost.py): the mesh over
                # every process's devices, this process's the engine's
                mesh = make_mesh(devices=None if self.device.device.type == "cuda"
                                 else [self.device.device])
            elif self.device.device.type == "cuda" and torch.cuda.device_count() > 1:
                mesh = make_mesh()
        if mesh is not None:
            self.sharded = ShardedMatcher(self.db, mesh)
            self.sharded.load_kernels()
            self.mesh = mesh

    def prewarm(self) -> None:
        """Upload the device layout before the first batch (the sharded
        matcher uploads its own when it is built), so that a worker's
        first job pays for none of it."""
        if self.sharded is None:
            self.device._ensure_layout()

    def data_ranks(self) -> int:
        """The 'data' axis size of the active backend (1 on one
        device): the scheduler's bucket planner fills its buckets per
        rank."""
        return self.sharded.ranks["data"] if self.sharded is not None else 1

    def scheduler(self):
        """This engine's continuous-batching scheduler (lazily built;
        exists regardless of the ``pipeline`` flag so callers can drive
        it explicitly for A/B runs)."""
        if self._sched is None:
            from swarm_tpu_torch.sched import BatchScheduler

            self._sched = BatchScheduler(self)
        return self._sched

    def match(self, responses: Sequence[Response]) -> list[RowMatches]:
        """Per-row exact match sets: template ids ascending by template
        index, then the host-always tail; extractions by template id.

        With ``pipeline="on"`` multi-row calls route through the
        continuous-batching scheduler (memo-known rows short-circuit out
        of device batches, fresh rows are re-binned into padding
        buckets, encode/dispatch/walk overlap). Otherwise batch by batch
        through :meth:`match_packed`, the next batch's encode on a
        helper thread; dead rows (no response observed) match nothing
        and are dropped before batching, so they never reach the
        device. Results are bit-identical either way."""
        if self.pipeline == "on" and len(responses) > 1:
            return self.scheduler().match_rows(responses)
        alive = [r for r in responses if r.alive]
        if len(alive) < len(responses):
            live_out = iter(self.match(alive))
            return [
                next(live_out)
                if r.alive
                else RowMatches(template_ids=[], extractions={})
                for r in responses
            ]
        out: list[RowMatches] = []
        chunks = [
            responses[s : s + self.batch_rows]
            for s in range(0, len(responses), self.batch_rows)
        ]
        for rows, pre in self._iter_encoded(chunks):
            packed = self.match_packed(rows, pre=pre)
            out.extend(self.rowmatches_from_packed(packed, len(rows)))
        return out

    def rowmatches_from_packed(self, packed: PackedMatches, n: int) -> list:
        """Per-row RowMatches assembly from one PackedMatches: template
        ids ascending by template index, then the host-always tail.

        The verdict-plane scan runs as ONE native pass over the whole
        batch (``plane_bits``) — a per-row np.unpackbits costs more
        than the typical row's entire hit set. Sparse side-tables are
        grouped by row ONCE (per-row scans of the whole extraction dict
        would be quadratic in batches where extractor templates fire
        on most rows)."""
        NT = self.db.num_templates
        conf = packed.confirms_per_row
        extr_by_row: dict = {}
        for (rb, tid), ext in packed.extractions.items():
            extr_by_row.setdefault(rb, {})[tid] = ext
        always_by_row: dict = {}
        for rb, tid in packed.host_always_matches:
            always_by_row.setdefault(rb, []).append(tid)
        tid_names = self.db.template_ids
        tids_by_row: dict = {}
        if n:
            rs, ts = plane_bits(np.ascontiguousarray(packed.bits[:n]), NT)
            for r, t in zip(rs.tolist(), ts.tolist()):
                tids_by_row.setdefault(r, []).append(tid_names[t])
        wf = packed.wf
        out = []
        for b in range(n):
            tids = tids_by_row.get(b, [])
            tids.extend(always_by_row.get(b, ()))
            row_wf = None
            if wf is not None and bool(wf["valid"][b]):
                row_wf = (
                    wf["cond_v"][b],
                    wf["cond_u"][b],
                    wf["emit_v"][b],
                    wf["emit_u"][b],
                )
            out.append(
                RowMatches(
                    template_ids=tids,
                    extractions=extr_by_row.get(b, {}),
                    confirmed_on_host=conf.get(b, 0),
                    wf=row_wf,
                )
            )
        return out

    # ------------------------------------------------------------------
    def _iter_encoded(self, chunks):
        """Yield (rows, pre_encoded) with the NEXT chunk's host encode
        overlapping the current chunk's device dispatch + confirmation
        (the device wait and the native walk passes release the GIL, so
        one helper thread recovers the encode). The helper thread only
        encodes — numpy and libfastpack, no torch call."""
        if len(chunks) <= 1:
            for c in chunks:
                yield c, None
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.encode_packed, chunks[0], True)
            for i, c in enumerate(chunks):
                pre = fut.result()
                if i + 1 < len(chunks):
                    fut = pool.submit(self.encode_packed, chunks[i + 1], True)
                yield c, pre

    def encode_packed(self, rows: Sequence[Response], reuse_buffers: bool = False):
        """Public pre-encode for pipelined feeding (:meth:`_encode_native`'s
        tuple): callers may encode batch i+1 on another thread while the
        device matches batch i and pass the result to
        :meth:`match_packed` or :meth:`begin_packed` via ``pre``.

        ``reuse_buffers=True`` draws the stream matrices and the verdict
        plane from the recycled pools (faster, no zero-fill) — but a
        pooled batch's arrays are OVERWRITTEN 8 same-shape encodes later
        (encoding._RotatingPool), so only enable it when each encoded
        batch is matched before that (the scheduler's budget holds at
        most 7 alive). The default allocates fresh arrays and is safe
        to hold indefinitely."""
        t0 = time.perf_counter()
        with record_function("engine.encode"):
            enc = self._encode_native(list(rows), reuse_buffers)
        with self._stats_lock:
            self.stats.encode_seconds += time.perf_counter() - t0
        return enc

    def encode(self, rows: Sequence[Response]):
        """Distinct-content rows → the device batch, padded to a 256-row
        bucket (no memo, no dedup: what :meth:`_encode_unique` gives the
        device)."""
        return self._encode_unique(list(rows), reuse_buffers=False)[0]

    def _encode_native(self, rows: list, reuse_buffers: bool):
        """Encode rows for the device, CONTENT-DEDUPLICATED two ways:
        within the batch (fleet scans see the same default pages on
        most hosts) and ACROSS batches via the verdict memo — content
        the engine has fully resolved before never rides the device
        again. ONE native pass serves every known row's
        packed verdict straight into the batch plane (and collects
        their extras), in-batch-dedups the misses, and only the miss
        uniques are encoded for the device.

        Returns ``("native", batch, matcher, bits, state, miss_uniq,
        served, n_rows)``: ``bits`` holds the served rows' verdicts (and
        zero for dead rows), ``state``/``miss_uniq`` are the lookup's
        (see ``VerdictMemo.lookup``), ``served`` the served rows'
        extractions and row-dependent deferrals, and ``batch`` (None
        when every row was served) the encoded miss uniques. With
        ``reuse_buffers=True`` the STORAGE of ``bits`` is drawn from the
        per-shape rotating pool and is overwritten 8 same-shape encodes
        later; the ``PackedMatches.bits`` a match assembles from it
        aliases this plane, so a caller that keeps results across more
        batches than that must ``.copy()`` them."""
        nbits = max((self.db.num_templates + 7) >> 3, 1)
        self._ensure_vmemo(nbits)
        if reuse_buffers:
            # A fresh ~1 MB np.empty per batch lands on mmap'd pages
            # whose first-touch faults cost more than the lookup pass
            # itself — draw from the per-shape rotating pool instead
            # (keyed per shape: the partial final chunk rotates its own
            # ring).
            bits = self._bits_pool.get(len(rows), nbits, "vbits")
        else:
            bits = np.empty((len(rows), nbits), dtype=np.uint8)
        state, miss_uniq, extr_known, deferred_known = (
            self._vmemo.lookup(rows, bits)
        )
        # memo accounting, row-granular
        hits, misses = int((state == -1).sum()), int((state >= 0).sum())
        with self._stats_lock:
            self.stats.memo_hits += hits
            self.stats.memo_misses += misses
        if hits:
            L1_HITS.inc(hits)
        if misses:
            L1_MISSES.inc(misses)
        # shared tier behind the L1: serve the miss slots' contents
        # from the fleet cache, then re-run the lookup so served rows
        # resolve exactly like locally-known content (one extra native
        # pass, paid only when the tier actually held something). Rows
        # the scheduler prefetch already consulted are skipped — their
        # hits are in the L1 and their misses suppressed, so re-asking
        # would only re-hash the content.
        if miss_uniq and self._result_cache is not None:
            seen = self._shared_seen
            cand = [
                rows[i]
                for i in miss_uniq
                if not seen or id(rows[i]) not in seen
            ]
            if cand and self._serve_shared(cand):
                state, miss_uniq, extr_known, deferred_known = (
                    self._vmemo.lookup(rows, bits)
                )
        served = (extr_known, deferred_known)
        if not miss_uniq:
            return (
                "native", None, None, bits, state, miss_uniq, served,
                len(rows),
            )
        nrows = [rows[i] for i in miss_uniq]
        batch, matcher = self._encode_unique(nrows, reuse_buffers)
        return (
            "native", batch, matcher, bits, state, miss_uniq, served,
            len(rows),
        )

    def _encode_unique(self, nrows: list, reuse_buffers: bool):
        """Encode the distinct-content rows for the active backend,
        padded to a 256-row bucket (a bounded set of batch shapes).

        A mesh also needs the row count divisible by the 'data' axis
        and every stream width divisible by 'seq' with each per-rank
        slice at least one halo wide (the sharded matcher raises
        otherwise); padding is zeros, which the length masks already
        ignore, and padded rows are sliced off the verdicts."""
        n_pad = round_up(max(len(nrows), 1), 256)
        if self.sharded is None:
            batch = encode_batch(
                nrows,
                max_body=self.max_body,
                max_header=self.max_header,
                pad_rows_to=n_pad,
                reuse_buffers=reuse_buffers,
                # the "all" stream synthesizes on device (half the encode
                # bytes and H2D traffic stay on the host); coarse width
                # buckets bound the set of batch shapes
                build_all=False,
                width_multiple=512,
            )
            return batch, self.device
        data_ranks = self.sharded.ranks["data"]
        seq_ranks = self.sharded.ranks["seq"]
        P = round_up(n_pad, data_ranks)
        row_index = None
        encode_rows = nrows
        if data_ranks > 1 and nrows:
            # the real rows interleave into per-data-rank blocks, so a
            # partially filled bucket spreads its live rows over every
            # rank instead of handing rank 0 all the work
            encode_rows, row_index = _place_rows_per_rank(nrows, P, data_ranks)
        batch = encode_batch(
            encode_rows,
            max_body=self.max_body,
            max_header=self.max_header,
            pad_rows_to=P,
            reuse_buffers=reuse_buffers,
            width_multiple=512,
        )
        if row_index is not None:
            batch.row_index = row_index
            per = P // data_ranks
            counts = np.bincount(row_index // per, minlength=data_ranks)
            RANK_FILL.set(float(counts.min()) / per)
        if seq_ranks > 1:
            pad_streams_for_seq(batch.streams, seq_ranks, self.sharded.halo)
        return batch, self.sharded

    def _gather_confirm_candidates(
        self, pt_value, pt_unc, pop_value, pop_unc, pm_unc, skip
    ):
        """Every (row, matcher) / prefiltered (row, op) pair the walk's
        serial loops COULD resolve, gathered from the device planes in
        one pass. Overapproximates the extraction pass's undecided ops
        via ``(pt_value | pt_unc) & ext_mask`` (the post-resolution
        extractor plane is a subset: value bits only appear there if
        they were set before the walk or uncertain) — extra pairs cost
        speculative native scans, never accounting, because
        ``host_confirm_pairs`` counts resolve_op calls, which this
        never changes. Returns ``(by_matcher {m_id: [b, ...]},
        op_pairs [(b, op_id), ...])``."""
        from swarm_tpu_torch.native.scanio import ext_resolve, plane_bits

        NT = self.db.num_templates
        rowdep = self._rowdep_t
        pseudo_t = self._pseudo_t
        seen_ops: set = set()
        op_cands: list = []  # (b, op_id) in need of a verdict
        # uncertain-template pairs: genuinely sparse, Python loop is fine
        ub, ut = plane_bits(np.ascontiguousarray(pt_unc), NT)
        for b, t_idx in zip(ub.tolist(), ut.tolist()):
            if b in skip or t_idx in rowdep or t_idx in pseudo_t:
                continue
            for op_id in self._t_ops_py[t_idx]:
                if not _bit(pop_unc, b, op_id):
                    continue
                key = (b, op_id)
                if key not in seen_ops:
                    seen_ops.add(key)
                    op_cands.append(key)
        # extractor-plane hits can be DENSE (tech templates fire on
        # most fleet rows): reuse the extraction pass's C driver over
        # the overapproximated plane and keep only its undecided
        # (state 2) ops — Python never touches the certain hits
        if len(self._ext_cols):
            emask = self._ext_byte_mask
            masked = (
                pt_value[:, : len(emask)] | pt_unc[:, : len(emask)]
            ) & emask[None, :]
            skip_rows = np.zeros(len(pt_value), dtype=np.uint8)
            for rb in skip:
                skip_rows[rb] = 1
            bs, ts, opsv, sts = ext_resolve(
                masked, NT, self._rowdep_mask, skip_rows,
                self._t_ops_indptr, self._t_ops_flat,
                np.ascontiguousarray(pop_value),
                np.ascontiguousarray(pop_unc),
            )
            und = sts == 2
            for b, t_idx, op_id in zip(
                bs[und].tolist(), ts[und].tolist(), opsv[und].tolist()
            ):
                if t_idx in pseudo_t:
                    continue  # decided by the extraction pass, never
                    # resolve_op'd — no confirms behind them
                key = (b, op_id)
                if key not in seen_ops:
                    seen_ops.add(key)
                    op_cands.append(key)
        by_matcher: dict = {}
        op_pairs: list = []
        mm_bs: list = []
        mm_ops: list = []
        for b, op_id in op_cands:
            if self._op_prefilter_py[op_id]:
                op_pairs.append((b, op_id))
            else:
                mm_bs.append(b)
                mm_ops.append(op_id)
        if mm_ops:
            # vectorized op → uncertain-matcher expansion: ONE fancy
            # index over the unpacked pm plane for the whole batch's
            # candidate ops (a per-op numpy gather costs ~8 us each —
            # thousands of pairs on the reference corpus)
            NM = len(self._m_obj)
            ops_arr = np.asarray(mm_ops, dtype=np.int64)
            bs_arr = np.asarray(mm_bs, dtype=np.int64)
            # unpack ONLY the candidate rows' pm bits: the full [B, NM]
            # plane is multi-MB at production batch sizes while the
            # candidate set is typically a handful of rows
            rows_u, row_local = np.unique(bs_arr, return_inverse=True)
            pm_bits = np.unpackbits(
                np.ascontiguousarray(pm_unc[rows_u]), axis=1, count=NM
            )
            counts = self._op_m_counts[ops_arr]
            total = int(counts.sum())
            if total:
                b_all = np.repeat(bs_arr, counts)
                # flat matcher ids of each candidate op, concatenated:
                # global position − local slice start + CSR offset
                idx = (
                    np.arange(total, dtype=np.int64)
                    - np.repeat(np.cumsum(counts) - counts, counts)
                    + np.repeat(self._op_m_indptr[ops_arr], counts)
                )
                m_all = self._op_m_flat[idx]
                sel = pm_bits[
                    np.repeat(row_local, counts), m_all
                ].astype(bool)
                for b, m in zip(
                    b_all[sel].tolist(), m_all[sel].tolist()
                ):
                    by_matcher.setdefault(m, []).append(b)
        return by_matcher, op_pairs

    #: distinct parts per pooled native shard — small enough that a
    #: 4-worker pool sees work from one big matcher group, large
    #: enough that per-task dispatch stays negligible
    _WALK_SHARD = 256
    #: below this many pending pairs the batch machinery costs more
    #: than the serial loops it would feed — skip it (results are
    #: identical either way; only where verdicts come from changes)
    _WALK_MIN_PAIRS = 16

    def _precompute_confirms(
        self, nrows, pt_value, pt_unc, pop_value, pop_unc, pm_unc, skip
    ):
        """Row-parallel batched confirm (docs/HOST_WALK.md).

        Plan phase (this thread): gather the batch's pending pairs,
        group them BY MATCHER, short-circuit pairs the cross-batch
        ``_confirm_cache`` already holds, and content-dedup the rest
        per matcher (distinct part bytes, not rows, are the unit of
        work — repeated internet content confirms once). Dispatch
        phase: each (matcher, part-shard) group resolves in one
        GIL-released native pass — ``sw_confirm_needles_batch`` for
        word/binary, crex DFA/NFA ``exists_batch`` per regex pattern —
        sharded across the walk pool; pairs the native passes can't
        answer exactly (unsupported patterns, dsl/status/kval, stale
        .so) re-run on the serial reference path inside pooled
        fallback tasks, so every verdict is bit-identical to
        ``_confirm_matcher_serial``. Merge phase (this thread): fold
        each task's private verdicts and cache inserts back into the
        shared ``_confirm_cache`` (per-thread shards merged at batch
        end — worker tasks never mutate the shared dict mid-flight).

        Returns ``({(b, m_id): bool}, {(b, op_id): bool})``.
        """
        t0 = time.perf_counter()
        by_matcher, op_pairs = self._gather_confirm_candidates(
            pt_value, pt_unc, pop_value, pop_unc, pm_unc, skip
        )
        pre_m: dict = {}
        pre_op: dict = {}
        n_pending = sum(map(len, by_matcher.values())) + len(op_pairs)
        if n_pending < self._WALK_MIN_PAIRS:
            # near-empty batch: the serial loops resolve a handful of
            # pairs faster than the group/dispatch/merge machinery
            # costs — the stats time below still records the plan
            self.stats.walk_precompute_seconds += (
                time.perf_counter() - t0
            )
            return pre_m, pre_op
        from swarm_tpu_torch.native import crex as ncrex
        from swarm_tpu_torch.native.scanio import confirm_needles_batch

        cache = self._confirm_cache
        # confirm-family promotion: the shared tier's second value
        # family serves/absorbs the part-keyed confirm verdicts around
        # the batched native passes — local cache first, one batched
        # tier lookup per matcher group, and every merged insert
        # batch-writes back at the end
        shared = self._result_cache
        if shared is not None and not shared.confirm:
            shared = None
        shared_inserts: list = []
        parts_of: dict = {}  # (b, part_name) -> bytes

        def row_part(b: int, name) -> bytes:
            key = (b, name)
            p = parts_of.get(key)
            if p is None:
                p = parts_of[key] = nrows[b].part(name)
            return p

        tasks: list = []      # zero-arg callables -> (verdicts, inserts)
        fallback: list = []   # (b, m_id) pairs for the serial reference

        def needle_task(m_id, matcher, part_rows, needles, ci, cond_and):
            neg = bool(matcher.negative)

            def run():
                parts = [p for p, _bs in part_rows]
                raw = confirm_needles_batch(parts, needles, ci, cond_and)
                verdicts: dict = {}
                inserts: list = []
                native = 0
                for (p, bs_), rv in zip(part_rows, raw.tolist()):
                    v = (not rv) if neg else bool(rv)
                    inserts.append((("m", m_id, p), v))
                    for b in bs_:
                        verdicts[(b, m_id)] = v
                        native += 1
                return verdicts, inserts, native

            return run

        def regex_task(m_id, matcher, part_rows, infos):
            neg = bool(matcher.negative)
            want_all = matcher.condition == "and"

            def run():
                verdicts: dict = {}
                inserts: list = []
                # pattern waterfall over still-undecided distinct
                # parts: exact per-pattern existence short-circuits
                # under the matcher condition exactly like
                # _regex_matcher_raw's loop (evaluation order is the
                # pattern order either way, so the combine is
                # identical); any non-exact item falls back whole.
                pending = list(part_rows)
                decided: list = []  # (part, bs, raw)
                bad: list = []
                for info in infos:
                    if not pending:
                        break
                    res = ncrex.exists_batch(
                        info.nfa, [p for p, _bs in pending]
                    )
                    if res is None:
                        bad.extend(pending)
                        pending = []
                        break
                    nxt: list = []
                    for (p, bs_), rv in zip(pending, res.tolist()):
                        if rv < 0:
                            bad.append((p, bs_))
                        elif want_all and not rv:
                            decided.append((p, bs_, False))
                        elif not want_all and rv:
                            decided.append((p, bs_, True))
                        else:
                            nxt.append((p, bs_))
                    pending = nxt
                # patterns exhausted without a short-circuit: the
                # combine's identity value (all -> True, any -> False)
                decided.extend((p, bs_, want_all) for p, bs_ in pending)
                native = 0
                for p, bs_, raw in decided:
                    v = (not raw) if neg else raw
                    inserts.append((("m", m_id, p), v))
                    for b in bs_:
                        verdicts[(b, m_id)] = v
                        native += 1
                for p, bs_ in bad:
                    for b in bs_:
                        verdicts[(b, m_id)] = (
                            self._confirm_matcher_serial(m_id, nrows[b])
                        )
                return verdicts, inserts, native

            return run

        def ext_pattern_task(m_id, pattern, part_rows, info):
            def run():
                verdicts: dict = {}
                inserts: list = []
                native = 0
                res = (
                    ncrex.exists_batch(info.nfa, [p for p, _b in part_rows])
                    if info.ok
                    else None
                )
                for idx, (p, bs_) in enumerate(part_rows):
                    is_native = False
                    if not info.ok:
                        v = False  # invalid under re: extracts nothing
                    elif res is not None and res[idx] >= 0:
                        v = bool(res[idx])
                        is_native = True
                    else:
                        text = p.decode("latin-1")
                        sv = fastre.search_bool(pattern, p, text)
                        if sv is None:
                            sv = info.rex.search(text) is not None
                        v = bool(sv)
                    inserts.append((("pe", m_id, p), v))
                    for b in bs_:
                        verdicts[(b, m_id)] = v
                        if is_native:
                            native += 1
                return verdicts, inserts, native

            return run

        def shard(part_rows: list) -> list:
            n = self._WALK_SHARD
            return [
                part_rows[i : i + n] for i in range(0, len(part_rows), n)
            ] or [[]]

        def dedup_misses(m_id, bs, part_name, cache_tag) -> list:
            """Cache-serve what the cross-batch memo holds, then the
            shared tier (one batched lookup per matcher group); group
            the remaining misses by DISTINCT part bytes →
            [(part, [b, ...]), ...]. A tier-served verdict also lands
            in the local cache so the next batch never re-asks."""
            by_part: dict = {}
            for b in bs:
                p = row_part(b, part_name)
                v = cache.get((cache_tag, m_id, p))
                if v is not None:
                    pre_m[(b, m_id)] = v
                else:
                    by_part.setdefault(p, []).append(b)
            if by_part and shared is not None:
                got = shared.lookup_confirms(
                    [(cache_tag, m_id, p) for p in by_part]
                )
                for key, v in got.items():
                    for b in by_part.pop(key[2]):
                        pre_m[(b, m_id)] = v
                    self._cache_put(cache, key, v)
            return list(by_part.items())

        for m_id, bs in by_matcher.items():
            matcher = self._m_obj[m_id]
            if matcher is None:
                op = self._op_obj[self._m_op_id[m_id]]
                ex_local, p_idx = self._m_ext_src_py[m_id]
                if ex_local < 0:  # fire-always degrade: whole-op path
                    fallback.extend((b, m_id) for b in bs)
                    continue
                ex = op.extractors[ex_local]
                pattern = ex.regex[p_idx]
                part_rows = dedup_misses(m_id, bs, ex.part, "pe")
                info = fastre.analyze(pattern)
                # one task per matcher, not per shard: the pattern's
                # lazy-DFA context serializes on its mutex, so sharding
                # ONE pattern across threads only buys lock ping-pong —
                # distinct matchers still run concurrently
                if part_rows:
                    tasks.append(
                        ext_pattern_task(m_id, pattern, part_rows, info)
                    )
                continue
            mtype = matcher.type
            if mtype in ("word", "binary"):
                if mtype == "word":
                    ci = bool(matcher.case_insensitive)
                    needles = [
                        w.encode("utf-8", "surrogateescape")
                        for w in matcher.words
                    ]
                    if ci:
                        needles = [nd.lower() for nd in needles]
                else:
                    ci = False
                    try:
                        needles = [
                            binascii.unhexlify(re.sub(r"\s", "", hx))
                            for hx in matcher.binary
                        ]
                    except (binascii.Error, ValueError):
                        # oracle's unsupported path (verdict False):
                        # keep it on the serial reference
                        fallback.extend((b, m_id) for b in bs)
                        continue
                if not needles:
                    # empty needle list is False before the combine
                    # (cpu_ref), then negation applies
                    v = bool(matcher.negative)
                    for b in bs:
                        pre_m[(b, m_id)] = v
                    continue
                part_rows = dedup_misses(m_id, bs, matcher.part, "m")
                cond_and = matcher.condition == "and"
                for sh in shard(part_rows):
                    if sh:
                        tasks.append(
                            needle_task(m_id, matcher, sh, needles, ci,
                                        cond_and)
                        )
            elif mtype == "regex":
                infos = [fastre.analyze(p) for p in matcher.regex]
                if not matcher.regex or not all(i.ok for i in infos):
                    # raw would be None (no patterns / a pattern the
                    # oracle can't compile): serial reference keeps
                    # the oracle-fallback semantics exact
                    fallback.extend((b, m_id) for b in bs)
                    continue
                part_rows = dedup_misses(m_id, bs, matcher.part, "m")
                # per-matcher task (no shards): see the DFA-mutex note
                # on the ext-prefilter branch above
                if part_rows:
                    tasks.append(regex_task(m_id, matcher, part_rows, infos))
            elif mtype == "size":
                sizes = matcher.size
                neg = bool(matcher.negative)
                want_all = matcher.condition == "and"
                for b in bs:
                    p = row_part(b, matcher.part)
                    key = ("m", m_id, p)
                    v = cache.get(key)
                    if v is None:
                        if not sizes:
                            raw = False
                        elif want_all:
                            raw = all(len(p) == s for s in sizes)
                        else:
                            raw = any(len(p) == s for s in sizes)
                        v = (not raw) if neg else raw
                        self._cache_put(cache, key, v)
                        # NOT promoted to the tier: the size branch
                        # decides inline (a length compare) and never
                        # consults the confirm family, so sharing
                        # these would be write-only tier traffic
                    pre_m[(b, m_id)] = v
            else:
                # dsl/status/kval read beyond the part — serial pairs
                fallback.extend((b, m_id) for b in bs)

        if fallback:
            def fallback_task(pairs):
                def run():
                    return (
                        {
                            (b, m): self._confirm_matcher_serial(
                                m, nrows[b]
                            )
                            for b, m in pairs
                        },
                        (),
                        0,
                    )

                return run

            tasks.append(fallback_task(fallback))
        if op_pairs:
            def op_task(pairs):
                def run():
                    return (
                        {
                            ("op", b, o): self._confirm_operation(
                                self._op_obj[o], nrows[b]
                            )
                            for b, o in pairs
                        },
                        (),
                        0,
                    )

                return run

            tasks.append(op_task(op_pairs))

        pool = self._walk_pool() if tasks else None
        if pool is not None and len(tasks) > 1:
            results = list(pool.map(lambda f: f(), tasks))
        else:
            results = [f() for f in tasks]
        native_pairs = 0
        for verdicts, inserts, native in results:
            native_pairs += native
            for key, v in verdicts.items():
                if len(key) == 3:  # ("op", b, op_id) from op_task
                    pre_op[(key[1], key[2])] = v
                else:
                    pre_m[key] = v
            for ck, v in inserts:
                self._cache_put(cache, ck, v)
                shared_inserts.append((ck, v))
        # batch-promote this round's freshly decided confirms into the
        # tier's confirm family — every insert key here is one of the
        # shareable ("m"|"pe", m_id, part) namespaces by construction
        # (the per-object "op"-tagged keys never reach the insert lists)
        if shared_inserts and shared is not None:
            shared.writeback_confirms(shared_inserts)
        # ONLY pairs the grouped native passes actually decided — not
        # cache-served, plan-inline (size/empty-needle), or serial-
        # fallback pairs — so the gauge attributes real native load
        self.stats.walk_batched_pairs += native_pairs
        if tasks:
            self.stats.walk_batch_rounds += 1
        self.stats.walk_precompute_seconds += time.perf_counter() - t0
        return pre_m, pre_op

    def _launch(self, batch, matcher):
        """``DeviceDB.dispatch`` of an encoded batch → its in-flight
        ``Dispatch``; the launch's host seconds go to device_seconds,
        split into phase A (up to and including the survivor read) and
        phase B from the dispatch's own ``compact`` dict."""
        t0 = time.perf_counter()
        pending = matcher.dispatch(batch.streams, batch.lengths, batch.status)
        lc = pending.compact
        with self._stats_lock:
            dt = time.perf_counter() - t0
            pa = min(lc.get("phase_a_s", 0.0) + lc.get("scalar_read_s", 0.0), dt)
            self.stats.device_seconds += dt
            self.stats.phase_a_seconds += pa
            self.stats.phase_b_seconds += dt - pa
        return pending

    # ------------------------------------------------------------------
    # Device-degraded mode

    @staticmethod
    def _shape_class(batch) -> str:
        """Breaker key: one breaker per batch shape class (rows × each
        stream's width), so a width bucket that keeps failing degrades
        alone while other shapes stay on the card."""
        streams = getattr(batch, "streams", None) or {}
        parts = [
            f"{name}{arr.shape[-1]}" for name, arr in sorted(streams.items())
        ]
        rows = next(iter(streams.values())).shape[0] if streams else 0
        return f"r{rows}." + ".".join(parts)

    def _note_device_fault(self, breaker, exc: BaseException) -> None:
        """A dispatch or collect failed with ``exc``: count it and trip
        the breaker, so the caller degrades the batch. On the card only
        an injected fault degrades: a real kernel error is re-raised
        and fails the job loudly instead of finishing it on the host,
        and the breaker is closed again so that no half-open probe is
        left out that would keep later batches off the card."""
        if self._on_card and not isinstance(exc, FaultInjected):
            breaker.reset()
            raise exc
        # with the scheduler's walk offload this runs on the submit
        # thread (begin_packed) and on the walk worker (_walk_plane)
        with self._stats_lock:
            self.stats.device_faults += 1
        breaker.record_failure()
        print(
            f"device path failed ({type(exc).__name__}: {exc}); "
            f"falling back to CPU oracle "
            f"[breaker {breaker.name}: {breaker.state}]"
        )

    def _oracle_planes(self, B: int):
        """The device output of a degraded batch: zero value and
        uncertainty planes and an all-true overflow vector, which the
        walk reads as "redo every row on the host oracle" — exactness is
        the redo path's contract."""
        db = self.db
        ntb = max((db.num_templates + 7) >> 3, 1)
        nob = max((len(db.op_matchers) + 7) >> 3, 1)
        nmb = max((len(db.m_src) + 7) >> 3, 1)
        return (
            np.zeros((B, ntb), dtype=np.uint8),
            np.zeros((B, ntb), dtype=np.uint8),
            np.zeros((B, nob), dtype=np.uint8),
            np.zeros((B, nob), dtype=np.uint8),
            np.zeros((B, nmb), dtype=np.uint8),
            np.ones((B,), dtype=bool),
            # no workflow gate planes: the runner resolves every
            # condition on the host (exact by construction)
            None,
        )

    def _walk_plane(self, nrows, batch, matcher, pending=None):
        """Device dispatch + sparse host resolution over DISTINCT new
        response contents (the unique content plane).

        ``pending`` is an already-launched dispatch from
        :meth:`begin_packed`: the walk then only pays the wait for that
        batch's read, and its kernels ran while the caller walked a
        previous batch. Without it the batch is dispatched here, if its
        breaker allows; a batch whose dispatch or collect fails with a
        fault that degrades (:meth:`_note_device_fault`), or whose
        breaker is open, walks the oracle planes. Any other failure
        propagates.

        Returns ``(pt_value, uextractions, deferred, redo_pos,
        confirms, wf_planes)``: the final content-side verdict bits
        ``[B, nb]`` (row-dependent undecided bits cleared and listed in
        ``deferred`` as ``(pos, t_idx)`` for per-member resolution),
        content-side extractions ``{(pos, tid): vals}``, the positions
        that needed a whole-row oracle redo (truncation/overflow —
        never memoized), per-position host-confirm counts, and the
        workflow gate planes of the B rows (None without gates)."""
        B = len(nrows)
        planes = None
        breaker = self._device_breakers.get(self._shape_class(batch))
        if pending is None and breaker.allow():
            try:
                pending = self._launch(batch, matcher)
            except Exception as e:
                self._note_device_fault(breaker, e)
        if pending is not None:
            t0 = time.perf_counter()
            try:
                planes = matcher.collect(pending)
                breaker.record_success()
            except Exception as e:
                self._note_device_fault(breaker, e)
            with self._stats_lock:
                self.stats.device_seconds += time.perf_counter() - t0
        if planes is None:
            # degraded mode: the all-overflow plane routes every row
            # through the whole-row oracle redo — the path truncated and
            # overflowed rows always take, so verdicts and extractions
            # are bit-identical to the device path
            planes = self._oracle_planes(B)
            self.stats.degraded_batches += 1
        # the walked rows' planes: the leading B rows, or where the
        # mesh placement put them (batch.row_index); a degraded batch's
        # oracle planes are B rows already
        ridx = batch.row_index

        def rows_view(a):
            a = np.asarray(a)
            if ridx is not None and a.shape[0] != B:
                return a[ridx]
            return a[:B]

        *device_planes, wf_planes = planes
        pt_value, pt_unc, pop_value, pop_unc, pm_unc, overflow = map(rows_view, device_planes)
        if wf_planes is not None:
            # packed cond/emit value+uncertainty bits, sliced to the
            # walked rows; the caller invalidates redo rows (their
            # planes were computed from unsound word bits)
            wf_planes = tuple(np.ascontiguousarray(rows_view(p)) for p in wf_planes)
        with record_function("engine.resolve"):
            return self._walk_unique(
                nrows, pt_value, pt_unc, pop_value, pop_unc, pm_unc, overflow,
                rows_view(batch.truncated)) + (wf_planes,)

    def _walk_unique(self, nrows, pt_value, pt_unc, pop_value, pop_unc, pm_unc, overflow,
                     truncated):
        """The host half of :meth:`_walk_plane`, over the device's planes
        of the unique rows (bucket padding already sliced off)."""
        NT = self.db.num_templates
        db = self.db
        B = len(nrows)
        # np.array(order="C"): ALWAYS a writable copy (the row-redo
        # pass writes rowbits back) AND row-major for the native passes
        pt_value = np.array(pt_value, order="C")
        # rows needing whole-row reconfirmation (candidate overflow or
        # stream truncation made word bits unsound for the row)
        row_redo = overflow | truncated
        self.stats.overflow_rows += int(row_redo.sum())

        t1 = time.perf_counter()
        confirms: dict = {}
        op_cache: dict = {}  # (b, op_id) -> exact bool
        # precomputed verdict planes from the row-parallel batched
        # confirm (docs/HOST_WALK.md): filled after the redo pass below,
        # consulted first by confirm_matcher/resolve_op. The resolution
        # structure (loops, short-circuits, counting) is untouched —
        # only where a pair's verdict COMES FROM changes, so verdicts
        # and host_confirm_pairs stay bit-identical to the serial walk.
        pre_m: dict = {}   # (b, m_id) -> exact bool
        pre_op: dict = {}  # (b, op_id) -> exact bool (prefiltered ops)

        def confirm_matcher(b: int, m_id: int, row: Response) -> bool:
            v = pre_m.get((b, m_id))
            if v is not None:
                return v
            return self._confirm_matcher_serial(m_id, row)

        op_prefilter = self._op_prefilter_py
        op_cond_and = self._op_cond_and_py

        def resolve_op(b: int, op_id: int, row: Response) -> bool:
            key = (b, op_id)
            v = op_cache.get(key)
            if v is not None:
                return v
            if not _bit(pop_unc, b, op_id):
                v = _bit(pop_value, b, op_id)
            elif op_prefilter[op_id]:
                # superset-lowered op: per-matcher bits are weakened, so
                # fired rows re-run the whole op (prefiltered + cached
                # per matcher — semantics identical to the oracle's
                # match_operation); the batched walk may have resolved
                # it already
                v = pre_op.get(key)
                if v is None:
                    v = self._confirm_operation(self._op_obj[op_id], row)
                confirms[b] = confirms.get(b, 0) + 1
                self.stats.host_confirm_pairs += 1
            else:
                # undecided ⇒ certain matchers are neutral; combine the
                # uncertain ones' exact values under the op condition
                ids = self._op_m_arr[op_id]
                bits = (
                    pm_unc[b, self._op_m_bytes[op_id]]
                    >> self._op_m_shift[op_id]
                ) & 1
                vals = [
                    confirm_matcher(b, int(m_id), row)
                    for m_id in ids[bits.astype(bool)]
                ]
                confirms[b] = confirms.get(b, 0) + len(vals)
                self.stats.host_confirm_pairs += len(vals)
                v = all(vals) if op_cond_and[op_id] else any(vals)
            op_cache[key] = v
            return v

        rowdep = self._rowdep_t
        # (unique slot, t_idx) pairs whose verdict must be decided per
        # MEMBER row (row-dependent template went device-undecided)
        deferred: list = []

        # --- full-row redo (rare): the oracle end to end, extractions
        # included (the extraction pass below skips these rows).
        # Content-independent templates run once on the representative;
        # row-dependent ones run per member in the fixup pass below ---
        redo_rows = np.flatnonzero(row_redo)
        uredo_extractions: dict = {}  # (new-subset pos, tid) -> values
        for b in redo_rows.tolist():
            row = nrows[b]
            rowbits = np.zeros((pt_value.shape[1],), dtype=np.uint8)
            for t_idx, template in enumerate(db.templates):
                if t_idx in rowdep:
                    deferred.append((b, t_idx))
                    continue
                res_matched, res_ext = self._redo_template(template, row)
                confirms[b] = confirms.get(b, 0) + 1
                self.stats.host_confirm_pairs += 1
                if res_matched:
                    rowbits[t_idx >> 3] |= 0x80 >> (t_idx & 7)
                    if res_ext:
                        uredo_extractions[(b, template.id)] = res_ext
            pt_value[b] = rowbits

        # --- sparse uncertainty resolution (unique plane) ---
        t_unc = time.perf_counter()
        # row-parallel batched confirm (docs/HOST_WALK.md): resolve the
        # whole batch's pending (row, matcher) pairs with grouped
        # GIL-released native passes BEFORE the serial-structured loops
        # below consume them. walk_threads=0 keeps the reference walk.
        if not row_redo.all() and self.walk_threads > 0:
            pre_m, pre_op = self._precompute_confirms(
                nrows, pt_value, pt_unc, pop_value, pop_unc, pm_unc,
                set(redo_rows.tolist()),
            )
        # (b, t_idx) pairs whose verdict is decided by the extraction
        # pass below (pseudo-ext templates on the native path)
        pseudo_pending: list = []
        if not row_redo.all():
            skip = set(redo_rows.tolist())
            ub, ut = plane_bits(np.ascontiguousarray(pt_unc), NT)
            pairs = zip(ub.tolist(), ut.tolist())
            pseudo_t = self._pseudo_t
            for b, t_idx in pairs:
                if b in skip:
                    continue
                byte_i = t_idx >> 3
                mask = 0x80 >> (t_idx & 7)
                if t_idx in pseudo_t and t_idx not in rowdep:
                    # verdict == extraction non-emptiness: decided by
                    # the batched extraction pass (bit set there on
                    # extraction); per-pair confirm calls cost ~10x
                    # the batched native scan at walk rates
                    pseudo_pending.append((b, t_idx))
                    pt_value[b, byte_i] &= 0xFF ^ mask
                    continue
                row = nrows[b]
                if t_idx in rowdep:
                    # undecided row-dependent template: content-
                    # identical rows can disagree here — decide per
                    # member below; clear the broadcast bit
                    deferred.append((b, t_idx))
                    pt_value[b, byte_i] &= 0xFF ^ mask
                    continue
                # undecided ⇒ no certain-true op; OR over the
                # uncertain ops' exact values decides the template
                hit = False
                for op_id in self._t_ops_py[t_idx]:
                    if _bit(pop_unc, b, op_id) and resolve_op(
                        b, op_id, row
                    ):
                        hit = True
                        break
                if hit:
                    pt_value[b, byte_i] |= mask
                else:
                    pt_value[b, byte_i] &= 0xFF ^ mask

        # --- extraction pass (unique plane): only extractor templates,
        # only hit rows (one vectorized gather over all extractor
        # columns at once — a Python loop over ~600 extractor templates
        # costs more than the actual extractions). Row-dependent
        # templates are handled in the member fixup pass ---
        t_ext = time.perf_counter()
        self.stats.unc_seconds += t_ext - t_unc
        uextractions: dict = dict(uredo_extractions)
        redo_set = set(redo_rows.tolist())
        if len(self._ext_cols):
            emask = self._ext_byte_mask
            masked = pt_value[:, : len(emask)] & emask[None, :]
            tids = db.template_ids
            # one C pass enumerates the extractor-plane hits AND
            # resolves op certainty against the packed planes —
            # Python touches only ops that are certainly-true
            # (extract) or undecided (resolve_op), in the same
            # (b-major, t, op) order the Python loop used
            skip_rows = np.zeros(len(nrows), dtype=np.uint8)
            for rb in redo_set:
                skip_rows[rb] = 1
            bs, ts, opsv, sts = ext_resolve(
                masked, NT, self._rowdep_mask, skip_rows,
                self._t_ops_indptr, self._t_ops_flat,
                np.ascontiguousarray(pop_value),
                np.ascontiguousarray(pop_unc),
            )
            t_sub = time.perf_counter()
            self.stats.ext_enum_seconds += t_sub - t_ext
            # certainty resolution stays in (b-major, t, op) order;
            # the regex extractions themselves then run BATCHED —
            # one native dispatch per distinct pattern over every
            # pending content (per-call overhead dominated the
            # fresh-content walk at per-hit rates)
            pending: list = []
            for b, t_idx, op_id, st in zip(
                bs.tolist(), ts.tolist(), opsv.tolist(), sts.tolist()
            ):
                if st == 2 and not resolve_op(b, op_id, nrows[b]):
                    continue
                pending.append((b, t_idx, op_id))
            # deferred pseudo-ext verdicts ride the same batch:
            # each uncertain op with >= 1 live pattern joins the
            # pending list; its (b, t) verdict bit is set below
            # iff the batched extraction produced values
            pseudo_set = set()
            for b, t_idx in pseudo_pending:
                pseudo_set.add((b, t_idx))
                for op_id in self._t_ops_py[t_idx]:
                    if _bit(pop_unc, b, op_id):
                        pending.append((b, t_idx, op_id))
            if pseudo_pending:
                self.stats.host_confirm_pairs += len(pseudo_pending)
                for b, _t in pseudo_pending:
                    confirms[b] = confirms.get(b, 0) + 1
            # live-pattern hints for per-pattern extraction
            # prefilters: the device pm-uncertainty bits already
            # say WHICH patterns' literals occurred — the
            # extraction pass then skips every other pattern with
            # no host scanning at all (certain-false bits are an
            # exact no-match proof)
            # hints are {ex_local: [p_idx, ...]} with only LIVE
            # patterns (flatnonzero is ascending and matcher order
            # is (ex_local, p_idx)-ascending, so lists stay in
            # pattern order) — consumers never touch the op's full
            # pattern population. The pm-plane gather batches per
            # op across all its pending rows: one 2D fancy-index
            # instead of a per-(row, op) 689-element gather.
            hints: dict = {}
            by_op: dict = {}
            for b, _t_idx, op_id in pending:
                if op_id in self._op_ext_pats:
                    by_op.setdefault(op_id, set()).add(b)
            for op_id, bset in by_op.items():
                rows_ = sorted(bset)
                bits2 = (
                    pm_unc[np.ix_(rows_, self._op_m_bytes[op_id])]
                    >> self._op_m_shift[op_id][None, :]
                ) & 1
                pats = self._op_ext_pats[op_id]
                for b in rows_:
                    hints[(b, op_id)] = {}
                # one nonzero over the whole (rows × matchers)
                # plane instead of a per-row flatnonzero
                ris, ks = np.nonzero(bits2)
                for ri, k in zip(ris.tolist(), ks.tolist()):
                    el, pi = pats[k]
                    hints[(rows_[ri], op_id)].setdefault(
                        el, []
                    ).append(pi)
            t_sub2 = time.perf_counter()
            self.stats.ext_resolve_seconds += t_sub2 - t_sub
            for (b, t_idx), vals in self._extract_pending(
                pending, nrows, hints
            ).items():
                if vals:
                    uextractions[(b, tids[t_idx])] = vals
                    if (b, t_idx) in pseudo_set:
                        # fused verdict: extraction fired
                        pt_value[b, t_idx >> 3] |= 0x80 >> (t_idx & 7)
            self.stats.ext_extract_seconds += (
                time.perf_counter() - t_sub2
            )

        self.stats.ext_seconds += time.perf_counter() - t_ext
        self.stats.host_confirm_seconds += time.perf_counter() - t1
        return (
            pt_value,
            uextractions,
            deferred,
            set(redo_rows.tolist()),
            confirms,
        )

    # ------------------------------------------------------------------
    def begin_packed(self, all_rows: Sequence[Response], pre=None):
        """Start a batch WITHOUT waiting for the device: encode (or
        adopt ``pre``, an :meth:`encode_packed` result for the same
        rows), upload the miss uniques and launch their kernels, and
        queue the read of the output. Returns an opaque in-flight handle
        for :meth:`finish_packed`.

        This is the continuous-batching scheduler's submission surface:
        with bounded in-flight handles the card crunches batch i+1 while
        the host walks batch i. A launch that fails with a fault that
        degrades (:meth:`_note_device_fault`), or an open breaker, leaves the
        handle without a dispatch: :meth:`finish_packed` then retries
        the card if the breaker allows, else degrades. Any other launch
        failure propagates."""
        if pre is None:
            pre = self.encode_packed(all_rows, reuse_buffers=True)
        batch, matcher = pre[1], pre[2]
        pending = None
        if batch is not None:
            breaker = self._device_breakers.get(self._shape_class(batch))
            if breaker.allow():
                try:
                    pending = self._launch(batch, matcher)
                except Exception as e:
                    self._note_device_fault(breaker, e)
        return (all_rows, pre, pending)

    def finish_packed(self, handle) -> PackedMatches:
        """Complete a :meth:`begin_packed` batch: wait for its own read,
        run the sparse host walk, assemble exact verdicts —
        bit-identical to :meth:`match_packed` on the same rows, a
        degraded batch's included."""
        rows, pre, pending = handle
        return self._match_packed_native(rows, pre, pending=pending)

    def match_packed(self, all_rows: Sequence[Response], pre=None) -> PackedMatches:
        """Exact verdict bitsets for up to ``batch_rows`` responses.

        The wire format: one device dispatch for the miss uniques,
        vectorized verdict assembly, host work proportional to the
        number of *uncertain fired matchers* — not to rows × templates.
        Dead rows are served as zero verdicts by the native lookup.
        ``pre`` is an optional :meth:`encode_packed` result for the SAME
        rows (pipelined feeding)."""
        if pre is None:
            pre = self.encode_packed(all_rows, reuse_buffers=True)
        return self._match_packed_native(all_rows, pre)

    def _match_packed_native(self, rows, enc, pending=None) -> PackedMatches:
        """Assembly for the C-memo encode path (:meth:`_encode_native`).

        Known rows arrived with their packed verdicts already fanned
        into ``bits`` by the native lookup; only miss uniques walk
        (``pending``: their dispatch, already launched)."""
        _tag, batch, matcher, bits, state, miss_uniq, served, n_src = enc
        if n_src != len(rows):
            raise ValueError(
                f"pre-encoded batch is for {n_src} rows, "
                f"match_packed got {len(rows)}"
            )
        self.stats.rows += len(rows)
        self.stats.batches += 1
        nrows = [rows[i] for i in miss_uniq]
        walked = None
        if batch is not None:
            self.stats.unique_rows += len(nrows)
            walked = self._walk_plane(nrows, batch, matcher, pending=pending)
        with record_function("engine.resolve"):
            return self._assemble_native(rows, nrows, bits, state, miss_uniq, served, walked)

    def _assemble_native(self, rows, nrows, bits, state, miss_uniq, served, walked):
        """The batch's exact verdicts from the memo-served rows and the
        walked miss uniques (``walked`` is :meth:`_walk_plane`'s result,
        None when every row was served): member fan-out, memo inserts,
        the per-row fixups and the host-always tail."""
        db = self.db
        extractions: dict = {}
        conf_full: dict = {}
        deferred_rows: list = []  # (row_i, t_idx) — decide per row
        wf_rows: Optional[dict] = None
        if walked is not None:
            B = len(nrows)
            pt_value, uext, deferred, redo_pos, confirms, wf_slots = walked
            t1 = time.perf_counter()
            self.stats.memo_slots += int((state == -1).sum())
            # broadcast walked bits to their member rows
            miss_rows = np.flatnonzero(state >= 0)
            bits[miss_rows] = pt_value[state[miss_rows]]
            if wf_slots is not None:
                # workflow gate planes for walked rows; memo-served
                # rows stay valid=False (host-resolved by the runner)
                cv, cu, ev, eu = wf_slots
                R = len(rows)
                sl = state[miss_rows]
                wf_rows = {
                    "cond_v": np.zeros((R, cv.shape[1]), dtype=np.uint8),
                    "cond_u": np.zeros((R, cu.shape[1]), dtype=np.uint8),
                    "emit_v": np.zeros((R, ev.shape[1]), dtype=np.uint8),
                    "emit_u": np.zeros((R, eu.shape[1]), dtype=np.uint8),
                }
                wf_rows["cond_v"][miss_rows] = cv[sl]
                wf_rows["cond_u"][miss_rows] = cu[sl]
                wf_rows["emit_v"][miss_rows] = ev[sl]
                wf_rows["emit_u"][miss_rows] = eu[sl]
                slot_ok = np.ones((B,), dtype=bool)
                for pos in redo_pos:
                    slot_ok[pos] = False
                valid = np.zeros((R,), dtype=bool)
                valid[miss_rows] = slot_ok[sl]
                wf_rows["valid"] = valid
            ext_by_pos: dict = {}
            for (b, tid), vals in uext.items():
                ext_by_pos.setdefault(int(b), []).append((tid, vals))
            def_by_pos: dict = {}
            for b, t_idx in deferred:
                def_by_pos.setdefault(int(b), []).append(t_idx)
            # memo inserts for fully-resolved content (deep-frozen
            # extras — callers receive thawed list copies, so a
            # caller's in-place edit can never rewrite the cache;
            # truncated/overflow positions are never stored). One
            # native call inserts the whole walked plane.
            t_ins = time.perf_counter()
            skip = np.zeros(B, dtype=np.uint8)
            for pos in redo_pos:
                skip[pos] = 1
            extras_list: list = [None] * B
            for pos in ext_by_pos.keys() | def_by_pos.keys():
                ment = tuple(
                    (tid, tuple(vals))
                    for tid, vals in ext_by_pos.get(pos, ())
                )
                mdef = tuple(def_by_pos.get(pos, ()))
                if ment or mdef:
                    extras_list[pos] = (ment, mdef)
            self._vmemo.insert_batch(nrows, pt_value[:B], skip, extras_list)
            # shared-tier writeback: the same fully-resolved planes the
            # L1 just absorbed batch-write to the fleet tier —
            # truncated/overflow positions stay local-only exactly like
            # the L1 (never memoized anywhere). Runs after the walk,
            # off the dispatch path; a fenced or degraded put drops
            # silently (the tier is an accelerator, never a dependency).
            if (
                self._result_cache is not None
                and self._result_cache.writeback
            ):
                self._result_cache.writeback_rows(
                    [
                        (nrows[b], pt_value[b].tobytes(), extras_list[b])
                        for b in range(B)
                        if not skip[b]
                    ]
                )
            ins_dt = time.perf_counter() - t_ins
            self.stats.insert_seconds += ins_dt
            # member fan-out over miss rows. Fresh-content batches
            # (every row a unique miss) skip the argsort grouping —
            # slot s's only member is miss_uniq[s].
            if len(miss_uniq) == len(rows):
                def members_of(pos: int) -> tuple:
                    return (miss_uniq[pos],)
            else:
                order = np.argsort(state, kind="stable")
                sorted_state = state[order]

                def members_of(pos: int) -> list:
                    lo = np.searchsorted(sorted_state, pos)
                    hi = np.searchsorted(sorted_state, pos + 1)
                    return order[lo:hi].tolist()

            for (pos, tid), vals in uext.items():
                for i in members_of(int(pos)):
                    extractions[(i, tid)] = vals
            for pos, tids in def_by_pos.items():
                for i in members_of(pos):
                    for t_idx in tids:
                        deferred_rows.append((i, t_idx))
            conf_full = {
                miss_uniq[pos]: n for pos, n in confirms.items()
            }
        else:
            ins_dt = 0.0
            t1 = time.perf_counter()
            self.stats.memo_slots += int((state == -1).sum())
        # extras served by the memo arrive ALREADY applied by the C
        # lookup: a (row, tid) -> thawed-list dict plus the
        # row-dependent deferral pairs. At steady state (no walked
        # extractions yet) the C-built dict is adopted wholesale.
        extr_known, deferred_known = served
        if extractions:
            extractions.update(extr_known)
        else:
            extractions = extr_known
        deferred_rows.extend(deferred_known)
        # certain-set row-dependent templates with extractors: at this
        # point the bits plane is content-certain (deferred bits are
        # cleared), so a set bit broadcasts exactly — but extraction
        # values may read the row's host → oracle per hit row. Runs
        # BEFORE the deferred fixups so fixup-set bits don't re-run.
        for t_idx in self._rowdep_ext_t:
            byte_i, mask = t_idx >> 3, 0x80 >> (t_idx & 7)
            template = db.templates[t_idx]
            for i in np.flatnonzero(bits[:, byte_i] & mask):
                res = cpu_ref.match_template(template, rows[int(i)])
                if res.matched and res.extractions:
                    extractions[(int(i), template.id)] = res.extractions
        # row-dependent deferrals (takeover family's host gates,
        # duration checks): decided per actual row via the oracle
        for i, t_idx in deferred_rows:
            template = db.templates[t_idx]
            mask = 0x80 >> (t_idx & 7)
            byte_i = t_idx >> 3
            res = cpu_ref.match_template(template, rows[i])
            conf_full[i] = conf_full.get(i, 0) + 1
            self.stats.host_confirm_pairs += 1
            if res.matched:
                bits[i, byte_i] |= mask
                if res.extractions:
                    extractions[(i, template.id)] = res.extractions
            else:
                bits[i, byte_i] &= 0xFF ^ mask
        host_always_matches = self._host_always_tail(
            rows, extractions, dead_state=state
        )
        now = time.perf_counter()
        # the insert window sits inside t1..now but is attributed to
        # insert_seconds — exclude it so the sub-phases sum to the
        # host_confirm total instead of double-counting
        self.stats.fixup_seconds += now - t1 - ins_dt
        self.stats.host_confirm_seconds += now - t1
        return PackedMatches(
            bits=bits,
            template_ids=db.template_ids,
            extractions=extractions,
            host_always_matches=host_always_matches,
            confirms_per_row=conf_full,
            wf=wf_rows,
        )

    def _host_always_tail(
        self, rows, extractions: dict, dead_state=None
    ) -> list:
        """Host-always tail: templates the compiler couldn't lower run
        exactly, per actual row (they may read host). Mutates
        ``extractions`` in place; returns the (row, template_id) hit
        list. ``dead_state`` is the memo lookup's state vector — rows
        marked dead (-2) match nothing by contract and are skipped.
        """
        host_always_matches: list = []
        db = self.db
        if db.host_always:
            for i, row in enumerate(rows):
                if dead_state is not None and dead_state[i] == -2:
                    continue
                for template in db.host_always:
                    res = cpu_ref.match_template(template, row)
                    self.stats.host_always_pairs += 1
                    if res.matched:
                        host_always_matches.append((i, template.id))
                        if res.extractions:
                            extractions[(i, template.id)] = res.extractions
        return host_always_matches

    # ------------------------------------------------------------------
    def _ensure_vmemo(self, nbits: int):
        """The C resident verdict cache, created on first need."""
        if self._vmemo is None:
            from swarm_tpu_torch.native.scanio import VerdictMemo

            self._vmemo = VerdictMemo(self._EXT_CACHE_MAX, nbits)
        return self._vmemo

    # ------------------------------------------------------------------
    # Shared result tier: L1 → shared → device
    # ------------------------------------------------------------------
    # once: client.bind_corpus (attach binds the tier epoch exactly once)
    def attach_result_cache(self, client) -> None:
        """Attach a fleet-wide content-addressed result tier
        (:class:`swarm_tpu_torch.cache.ResultCacheClient`). The client
        is bound to this engine's corpus digest, so entries can only be
        exchanged between engines compiled from identical templates
        (and identical lowering code — the epoch covers both). ``None``
        detaches."""
        if client is not None:
            from swarm_tpu_torch.cache.tier import corpus_digest

            client.bind_corpus(corpus_digest(self.templates))
        self._result_cache = client

    def attach_aot(self, client) -> None:
        """Attach an AOT library client
        (:class:`swarm_tpu_torch.aot.AotClient`) to whichever device
        backend serves this engine — the single-device :class:`DeviceDB`,
        and the sharded matcher when there is one. Both reach the one
        attachment of the process's kernel loader
        (``kernels.attach_aot``): the libraries are the process's, not an
        engine's. The engine loaded its match libraries when it was
        built, so an attach here reaches the libraries loaded later (the
        cluster kernels'); the worker attaches before it builds the
        engine (``worker/runtime.py``). ``None`` detaches."""
        self._aot_client = client
        self.device.attach_aot(client)
        if self.sharded is not None:
            self.sharded.attach_aot(client)

    def aot_prewarm(self) -> int:
        """Bring-up fetch: every library published for this process's
        program group, checked and written under its keyed path, so a
        later load fetches nothing and compiles nothing. → the libraries
        pooled (0 without a client)."""
        if self._aot_client is None:
            return 0
        backend = self.sharded if self.sharded is not None else self.device
        return backend.aot_prewarm()

    def _serve_shared(self, cand: list) -> int:
        """Serve shared-tier verdict entries for L1-missed rows: each
        hit is inserted into the verdict memo, so the caller's
        re-lookup serves it exactly like locally-computed known content
        — verdicts can't differ between a shared hit and a local walk
        because the entry IS a walked result for the same content under
        the same corpus epoch. Entries whose plane width doesn't match
        this corpus are dropped (foreign layout — treat as a miss, never
        as data). → the number of contents served."""
        client = self._result_cache
        if client is None or not cand:
            return 0
        entries = client.lookup_rows(cand)
        if not entries:
            return 0
        nbits = max((self.db.num_templates + 7) >> 3, 1)
        vmemo = self._ensure_vmemo(nbits)
        n = 0
        for pos, (mb, ment, mdef) in entries.items():
            if len(mb) != nbits:
                continue
            extras = (ment, mdef) if (ment or mdef) else None
            vmemo.insert(
                cand[pos], np.frombuffer(mb, dtype=np.uint8).copy(), extras
            )
            n += 1
        return n

    def prefetch_shared_memo(self, rows: Sequence) -> int:
        """Pipeline the shared-tier lookup into the scheduler's
        prefetch stage: rows the L1 doesn't know are batch-looked-up in
        the shared tier and the hits inserted into the L1 BEFORE
        plan-time classification, so a fleet-known row rides the memo
        lane (no bucket, no device batch slot) and a shared miss costs
        nothing on the dispatch path — the remote round trip overlapped
        the in-flight device batches. Returns the number of contents
        served. No-op without an attached tier."""
        if self._result_cache is None or not rows:
            return 0
        rows = list(rows)
        known = self.memo_known_mask(rows)
        cand = [
            r
            for i, r in enumerate(rows)
            if not known[i] and getattr(r, "alive", True)
        ]
        if not cand:
            return 0
        # remember what this stage consulted (hits AND misses): the
        # encode-time consult skips these rows instead of re-hashing
        for r in cand:
            self._cache_put(self._shared_seen, id(r), None)
        return self._serve_shared(cand)

    def memo_contains(self, row: Response) -> bool:
        """Whether the cross-batch verdict memo holds this row's
        content."""
        return self._vmemo is not None and self._vmemo.contains(row)

    def memo_known_mask(self, rows: list) -> np.ndarray:
        """uint8 residency mask over ``rows`` (no LRU side effects) in
        ONE native pass; a dead row is never known (it resolves to zero
        verdicts, never a memo entry)."""
        if self._vmemo is None:
            return np.zeros(len(rows), dtype=np.uint8)
        return self._vmemo.contains_batch(rows)

    def clear_content_memos(self) -> None:
        """Drop every cross-batch content memo: the verdict memo and the
        extraction and confirm caches. Whoever times the device path
        calls this before each call; production never needs it."""
        self._ext_cache.clear()
        self._confirm_cache.clear()
        if self._vmemo is not None:
            self._vmemo.clear()

    # once: _result_cache.bind_corpus (ONE shared-cache epoch move per refresh)
    def refresh_corpus(self, templates_new, db_new: Optional[CompiledDB] = None) -> dict:
        """Corpus refresh against a live engine (the reference's
        ``refresh_corpus``): delta-compile ``templates_new`` against the
        current CompiledDB (``compile_corpus_delta``: unchanged word
        tables adopted by identity, only the touched stacked-table rows
        rebuilt), re-derive the db-indexed lookup tables
        (:meth:`_bind_db`), upload only the changed layout leaves to the
        device (``DeviceDB.update_layout``) and to every rank of the mesh
        (``ShardedMatcher.refresh``, whose new halo the mesh encode then
        pads to), and drop every content-keyed memo: matcher and op
        indices renumber and plane widths can change, so a stale entry
        would be wrong, not slow. ``self.templates`` becomes the new
        list, so a degraded batch's CPU-oracle redo serves the new
        corpus.

        Caller contract: quiesce first — no batch may be in flight
        (dispatched and not collected, or inside the scheduler's
        in-flight window) across this call.

        ``db_new``: a CompiledDB already compiled for ``templates_new``
        (e.g. from ``fingerprints/dbcache``); it is delta-layouted
        against the current db either way. → the delta stats combined
        (the sharded matcher's under ``"sharded"``).

        An attached result tier moves to the new corpus epoch with ONE
        ``bind_corpus`` call: entries of the old corpus become
        unreachable, and the next batch reads and writes the new
        corpus's namespace. The new digest then goes to every
        in-process monitor service (``monitor.notify``), which makes
        its standing specs due for one out-of-cadence epoch."""
        from swarm_tpu_torch.fingerprints.compile import (
            build_device_layout_delta,
            compile_corpus_delta,
        )

        stats: dict = {}
        if db_new is None:
            db_new, stats = compile_corpus_delta(list(templates_new), self.db)
        else:
            build_device_layout_delta(db_new, self.db, stats)
        self.templates = list(templates_new)
        self.db = db_new
        self._bind_db()
        stats.update(self.device.update_layout(db_new))
        if self.sharded is not None:
            stats["sharded"] = self.sharded.refresh(db_new)
        # stale-corpus state: every content-keyed memo maps content to
        # verdicts and indices of the OLD corpus — invalid, not just cold
        self._vmemo = None  # recreated lazily at the new plane width
        self._ext_cache.clear()
        self._confirm_cache.clear()
        self._shared_seen.clear()
        # shared result tier: ONE namespace move — the epoch's digest
        # half covers the corpus content + lowering code
        from swarm_tpu_torch.cache.tier import corpus_digest

        digest = corpus_digest(self.templates)
        if self._result_cache is not None:
            self._result_cache.bind_corpus(digest)
        # corpus-delta fan-out: any in-process monitor service turns
        # this into a journaled due-now touch so standing specs fire
        # one immediate out-of-cadence diff epoch against the new
        # corpus (docs/MONITORING.md §Out-of-cadence re-evaluation)
        from swarm_tpu_torch.monitor import notify as monitor_notify

        monitor_notify.notify_corpus_delta(digest)
        return stats
