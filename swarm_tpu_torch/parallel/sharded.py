"""The sharded match: data × model × seq over a :class:`~swarm_tpu_torch.parallel.mesh.Mesh`.

The port of ``swarm_tpu/parallel/sharded.py``'s serving path. One
process drives every rank of the grid (or, across processes, every rank
of its own), each rank's kernels launched on its device's current
stream:

- **data**: the batch's rows in contiguous blocks, one a data rank; no
  traffic between data ranks until their planes are gathered;
- **model**: every rank probes the same windows against its 1/R slice
  of each word table's sorted h1 range (:func:`shard_stacked_np`:
  disjoint group ranges, per-rank blooms), so the ranks' slot bits
  combine by OR;
- **seq**: the rows' bytes; each rank owns the candidate windows that
  start in its slice, and reads ``max_entry_len`` bytes of both
  neighbours' slices (the halo copies of ``_exchange_halos``), so a word
  that spans a boundary is found by exactly the rank that owns its gram
  position.

Per batch (:meth:`ShardedMatcher.dispatch`):

1. stage each (data, seq) block on the devices of its ranks, and build
   each rank's halo-extended views from its neighbours' edge slices;
2. **phase A** on every rank (kernel ``match_phase_a`` with the halos
   and each table's global offset), then the host reads each rank's
   clamped survivor maximum — R × 4 bytes — and takes their maximum to
   size phase B on the survivor ladder, as ``DeviceDB`` does for one
   device;
3. **phase B** on every rank: the gather-verify (kernel
   ``match_verify``) and the tiny slots over the extended views, which
   stop at the rank's slot planes;
4. the **combine** (the reference's ``psum`` over model and seq, then
   its replicated verdict tail): on each data rank's first device, the
   OR of its ranks' value, uncertain and overflow planes, then the md5
   and the device regex on whole rows (a seq-sharded stream is gathered
   by concatenating the slices), the verdict kernel, the workflow gates
   and the fused planes; the data ranks' buffers are copied into one
   pinned host buffer, each behind an event.

The combine is **deferred** (:class:`_PendingShard`): ``dispatch``
returns it un-launched, and the next ``dispatch`` launches it right
after its own phase A is queued, so batch N's combine runs on the card
behind batch N+1's phase A while the host waits on N+1's survivor read;
otherwise :meth:`ShardedMatcher.collect` launches it.
``overlap=False`` (``SWARM_SHARD_OVERLAP=0``) launches it inline.
:meth:`dispatch`, :meth:`collect` and :meth:`match` have the contract
of ``DeviceDB``'s, so the engine and the scheduler drive a mesh as they
drive one device.

:meth:`ShardedMatcher.refresh` takes a refreshed corpus, uploading only
the leaves whose bytes changed.

**Across processes** (a mesh of ``parallel/multihost.py``'s process
group, ``multiprocess``): every process passes the same host batch, as
the reference's global arrays are built from each process's full copy,
and each stages, probes and verifies only the ranks it drives
(``Mesh.process``). The survivor maximum is one 4-byte
``all_reduce(MAX)`` (the reference's pmax); the combine of a data rank
whose model or seq ranks span processes is one all-reduce of its planes
over that data rank's group; a seq halo whose neighbour another process
drives is read from the host batch; each data rank's fused buffer is
broadcast from the process that ran its tail, so every process returns
the whole result. The overlap is off, and every process issues its
collectives in the same order. Each byte handed to a cross-process
collective is counted in ``swarm_shard_psum_bytes_total``
(``cross_process_bytes`` by kind).

Not ported: the fused single-kernel twin (the port's ``DeviceDB`` has
only the split path), buffer donation and the AOT executable cache.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from swarm_tpu_torch.fingerprints import compile as fpc
from swarm_tpu_torch.ops import hashing, kernels
from swarm_tpu_torch.ops.encoding import round_up
from swarm_tpu_torch.ops.match import (
    UploadCounts,
    VerdictLayout,
    _bytes_equal,
    _word_table,
    col_starts_of,
    ensure_all_stream,
    full_planes,
    fuse_planes,
    fused_plane_widths,
    global_candidate_budget,
    layout_signature,
    split_fused,
    table_views,
    tiny_slot_bits,
    to_device,
    upload_delta,
)
from swarm_tpu_torch.parallel import multihost
from swarm_tpu_torch.resilience.faults import fault_point
from swarm_tpu_torch.telemetry import shard_export


def shard_tables_np(db: fpc.CompiledDB, ranks: int) -> list[dict]:
    """Split every table's sorted h1-group range into ``ranks`` contiguous
    slices with identical padded shapes, one pytree leaf-list per table:
    arrays get a leading [ranks] axis to shard over 'model'.

    Padding uses a sentinel h1 of 0xFFFFFFFF with zero entry counts, so
    a padded group can never be "found" twice (searchsorted may land on
    it, but count 0 yields no entries).
    """
    stacked: list[dict] = []
    for table in db.tables:
        G = table.num_groups
        g_per = max(1, -(-G // ranks))
        gmax = g_per
        emax = 1
        slices = []
        for r in range(ranks):
            lo = min(r * g_per, G)
            hi = min(lo + g_per, G)
            if hi > lo:
                e_lo = int(table.entry_start[lo])
                e_hi = int(
                    table.entry_start[hi - 1] + table.entry_count[hi - 1]
                )
            else:
                e_lo = e_hi = 0
            slices.append((lo, hi, e_lo, e_hi))
            emax = max(emax, e_hi - e_lo)
        arrs = {
            "group_h1": np.full((ranks, gmax), 0xFFFFFFFF, dtype=np.uint32),
            "entry_start": np.zeros((ranks, gmax), dtype=np.int32),
            "entry_count": np.zeros((ranks, gmax), dtype=np.int32),
            "entry_h2": np.zeros((ranks, emax), dtype=np.uint32),
            "entry_slot": np.zeros((ranks, emax), dtype=np.int32),
            "entry_off": np.zeros((ranks, emax), dtype=np.int32),
            "entry_len": np.full((ranks, emax), 1 << 30, dtype=np.int32),
            "entry_suf_delta": np.zeros((ranks, emax), dtype=np.int32),
            "entry_suf_h1": np.zeros((ranks, emax), dtype=np.uint32),
            "entry_suf_h2": np.zeros((ranks, emax), dtype=np.uint32),
            "bloom": np.zeros((ranks, hashing.BLOOM_WORDS), dtype=np.uint32),
        }
        for r, (lo, hi, e_lo, e_hi) in enumerate(slices):
            n_g, n_e = hi - lo, e_hi - e_lo
            if n_g == 0:
                continue
            arrs["group_h1"][r, :n_g] = table.group_h1[lo:hi]
            arrs["entry_start"][r, :n_g] = table.entry_start[lo:hi] - e_lo
            arrs["entry_count"][r, :n_g] = table.entry_count[lo:hi]
            for name, src in (
                ("entry_h2", table.entry_h2),
                ("entry_slot", table.entry_slot),
                ("entry_off", table.entry_off),
                ("entry_len", table.entry_len),
                ("entry_suf_delta", table.entry_suf_delta),
                ("entry_suf_h1", table.entry_suf_h1),
                ("entry_suf_h2", table.entry_suf_h2),
            ):
                arrs[name][r, :n_e] = src[e_lo:e_hi]
            arrs["bloom"][r] = hashing.build_bloom_np(
                np.repeat(table.group_h1[lo:hi], table.entry_count[lo:hi]),
                table.entry_h2[e_lo:e_hi],
            )
        stacked.append(arrs)
    return stacked


def shard_stacked_np(db: fpc.CompiledDB, ranks: int) -> dict:
    """Model-sharded twin of ``compile.stack_tables_np``: one stacked
    table-major pytree per rank, with a leading [ranks] axis to shard
    over 'model'. Built on :func:`shard_tables_np` (same slicing, same
    per-rank blooms, same sentinels) and padded to rank-global
    Gmax/Emax so every rank's executable sees one shape."""
    per_table = shard_tables_np(db, ranks)
    T = len(per_table)
    if T == 0:
        base = fpc.stack_tables_np([])
        return {
            k: np.repeat(v[None], ranks, axis=0) for k, v in base.items()
        }
    gmax = max(t["group_h1"].shape[1] for t in per_table)
    emax = max(t["entry_h2"].shape[1] for t in per_table)
    out = {
        "group_h1": np.full((ranks, T, gmax), 0xFFFFFFFF, dtype=np.uint32),
        "entry_start": np.zeros((ranks, T, gmax), dtype=np.int32),
        "entry_count": np.zeros((ranks, T, gmax), dtype=np.int32),
        "entry_h2": np.zeros((ranks, T, emax), dtype=np.uint32),
        "entry_slot": np.zeros((ranks, T, emax), dtype=np.int32),
        "entry_off": np.zeros((ranks, T, emax), dtype=np.int32),
        "entry_len": np.full((ranks, T, emax), 1 << 30, dtype=np.int32),
        "entry_suf_delta": np.zeros((ranks, T, emax), dtype=np.int32),
        "entry_suf_h1": np.zeros((ranks, T, emax), dtype=np.uint32),
        "entry_suf_h2": np.zeros((ranks, T, emax), dtype=np.uint32),
        "bloom": np.zeros(
            (ranks, T, hashing.BLOOM_WORDS), dtype=np.uint32
        ),
        "n_groups": np.zeros((ranks, T), dtype=np.int32),
    }
    for t_idx, arrs in enumerate(per_table):
        g = arrs["group_h1"].shape[1]
        e = arrs["entry_h2"].shape[1]
        for name in (
            "group_h1", "entry_start", "entry_count",
        ):
            out[name][:, t_idx, :g] = arrs[name]
        for name in (
            "entry_h2", "entry_slot", "entry_off", "entry_len",
            "entry_suf_delta", "entry_suf_h1", "entry_suf_h2",
        ):
            out[name][:, t_idx, :e] = arrs[name]
        out["bloom"][:, t_idx] = arrs["bloom"]
        # real (unpadded) group counts per rank — the binary-search
        # bound. Derived from the slices shard_tables_np actually
        # built (every real group has >= 1 entry, padding has 0), so
        # any future change to its slicing rule stays in lockstep.
        out["n_groups"][:, t_idx] = (arrs["entry_count"] > 0).sum(axis=1)
    return out


def max_entry_len(db: fpc.CompiledDB) -> int:
    out = int(hashing.GRAM_LONG)
    for table in db.tables:
        if table.entry_len.size:
            out = max(out, int(table.entry_len.max()))
    return out


def pad_streams_for_seq(streams: dict, seq_ranks: int, halo: int) -> None:
    """Widen streams IN PLACE so each seq rank's slice is at least one
    halo wide and 128-aligned — the invariant :class:`ShardedMatcher`
    enforces (narrow streams like the width-1 OOB placeholders must
    widen before seq sharding). The engine's mesh encode pads through
    here."""
    seq = max(seq_ranks, 1)
    for name, arr in streams.items():
        per_rank = max(round_up(arr.shape[1], seq) // seq, halo)
        target = round_up(per_rank, 128) * seq
        if target > arr.shape[1]:
            streams[name] = np.pad(arr, ((0, 0), (0, target - arr.shape[1])))




class _PendingShard:
    """One batch's DEFERRED combine, double-buffered behind the next
    batch's phase A.

    ``dispatch`` returns this handle with the combine un-launched;
    whoever needs it next launches it exactly once:

    - the NEXT ``dispatch``, right after its own phase A is queued
      (``launched_by == "dispatch"``, the overlapped case);
    - otherwise ``collect`` (``"collect"``);
    - ``overlap=False``: ``dispatch`` itself, before it returns
      (``"inline"``).

    A launch failure is kept and raised at :meth:`force`, so the error
    surfaces on the batch that owns it, not on the batch whose dispatch
    happened to launch it. ``compact`` is the batch's survivor_max /
    verify_k / budget and stage seconds, as a ``DeviceDB`` dispatch
    carries them.
    """

    __slots__ = ("_matcher", "_thunk", "_lock", "_out", "_exc", "_done",
                 "launched_by", "compact")

    def __init__(self, matcher: "ShardedMatcher", thunk, compact: dict):
        self._matcher = matcher
        self._thunk = thunk
        self._lock = threading.Lock()
        self._out = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self.launched_by: Optional[str] = None
        self.compact = compact

    def launch(self, by: str) -> None:
        """Launch the combine once (from the submit thread, the walk
        worker or collect alike)."""
        with self._lock:
            if self._done:
                return
            try:
                self._out = self._thunk()
            except Exception as e:  # raised at force()
                self._exc = e
            finally:
                self._done = True
                self._thunk = None
                self.launched_by = by
                self._matcher._clear_pending(self)

    def force(self):
        """Launch if nothing did yet → the combine's (host buffer,
        events), or raise its launch failure."""
        self.launch("collect")
        if self._exc is not None:
            raise self._exc
        return self._out


class ShardedMatcher:
    """A CompiledDB uploaded to every rank of a mesh, and the
    split-phase, survivor-compacted match over the grid (module doc).

    Each model rank's slice of the stacked tables and blooms is uploaded
    once to each of its devices; the replicated slot, verdict and regex
    arrays once to each device of the mesh. On a mesh across processes
    (``multiprocess``) this process uploads to and runs only the ranks
    it drives (``Mesh.process``). ``last_compact`` is the ``compact``
    dict of the batch collected last; ``cross_process_bytes`` the bytes
    this process has handed to cross-process collectives, by kind."""

    def __init__(self, db: "fpc.CompiledDB", mesh, candidate_k: int = 128,
                 overlap: Optional[bool] = None):
        self.mesh = mesh
        self.candidate_k = candidate_k
        if overlap is None:
            overlap = os.environ.get("SWARM_SHARD_OVERLAP", "").strip().lower() not in (
                "0", "off", "false", "no")
        self.ranks = {name: int(mesh.shape[name]) for name in mesh.axis_names}
        #: this process, and whether the mesh spans others
        self.process = multihost.process_index()
        procs = getattr(mesh, "process", np.zeros(mesh.devices.shape, dtype=np.int64))
        self.multiprocess = bool((procs != self.process).any())
        # the deferred combine's launch order is host-controlled; on a
        # mesh across processes every process must issue its
        # collectives in the same order, so the overlap stays
        # single-process only
        self.overlap = bool(overlap) and not self.multiprocess
        #: the grid entries (d, m, s) this process drives → their device
        self._mine = {idx: dev for idx, dev in np.ndenumerate(mesh.devices)
                      if int(procs[idx]) == self.process}
        #: the process driving each data rank's combine and tail: its
        #: (d, 0, 0) entry's
        self._owner = [int(procs[d, 0, 0]) for d in range(self.ranks["data"])]
        self.cross_process_bytes = {"survivor": 0, "combine": 0, "gather": 0}
        self._groups: dict = {}
        if self.multiprocess:
            # one group a data rank whose model and seq ranks span
            # processes, made by every process in data-rank order
            for d in range(self.ranks["data"]):
                members = sorted({int(p) for p in procs[d].flat})
                if len(members) > 1:
                    group = multihost.new_group(members)
                    if self.process in members:
                        self._groups[d] = group
        self.last_compact: dict = {}
        self._lock = threading.Lock()
        #: the one un-launched deferred combine (depth 1: each dispatch
        #: launches its predecessor's before parking its own)
        self._pending: Optional[_PendingShard] = None  # guarded-by: _lock
        #: the distinct devices of this process's ranks, in first-appearance order
        self.devices = list(dict.fromkeys(self._mine.values()))
        self._rep: dict = {}
        self._tab: dict = {}
        self._rep_np = self._tab_np = self._va = None
        self._signature = None
        self._load_corpus(db)
        for ax, size in self.ranks.items():
            shard_export.MESH_AXIS.labels(axis=ax).set(size)

    def _load_corpus(self, db: "fpc.CompiledDB") -> dict:
        """Put ``db``'s layout on this process's ranks, keeping what is
        there: the replicated arrays on each device, each model rank's
        slice of the stacked tables on each of its devices. A leaf whose
        bytes are the old one's keeps its tensor, a changed leaf of the
        old shape is copied into it (``match.upload_delta``), and each
        ``VerifyCorpus`` and ``VerdictLayout`` is kept while every
        tensor it points at stays where it was. → the refresh stats
        (``refresh``'s)."""
        meta, arrays_np = fpc.build_device_layout(db)
        tab_np = shard_stacked_np(db, self.ranks["model"])
        rep_np = {"slot_bytes": arrays_np["slot_bytes"], "slot_len": arrays_np["slot_len"],
                  "rx": arrays_np["rx"]}
        va = arrays_np["verdict"]
        halo = max_entry_len(db) if self.ranks["seq"] > 1 else 0
        signature = (tuple(sorted(self.ranks.items())), halo,
                     layout_signature(db, meta, arrays_np, self.candidate_k),
                     tuple((k, v.shape, str(v.dtype)) for k, v in tab_np.items()))
        counts = UploadCounts()
        kept = True
        old_rep_np, old_tab_np = self._rep_np, self._tab_np
        rep_all: dict = {}
        for dev in self.devices:
            old = self._rep.get(dev)
            rep = upload_delta(rep_np, old_rep_np, old and {k: old[k] for k in rep_np}, dev,
                               counts, leaves=False, same=_bytes_equal)
            if old is None:
                rep["verdict"] = VerdictLayout(db, dev, va)
                rep["word_tab"] = to_device(_word_table(), dev)
            else:
                rep["verdict"] = old["verdict"].refreshed(db, va, counts)
                rep["word_tab"] = old["word_tab"]
                kept = kept and rep["verdict"] is old["verdict"]
            rep_all[dev] = rep
        tab_all: dict = {}
        if len(meta.table_stream):
            for (_d, m, _s), dev in self._mine.items():
                if (dev, m) in tab_all:
                    continue
                old = self._tab.get((dev, m))
                new_t = {k: v[m] for k, v in tab_np.items()}
                old_t = {k: v[m] for k, v in old_tab_np.items()} if old is not None else None
                tab = upload_delta(new_t, old_t, old and {k: old[k] for k in new_t}, dev,
                                   counts, leaves=False, same=_bytes_equal)
                rep = rep_all[dev]
                verify = old["verify"] if old is not None else None
                if verify is None or verify.max_group != meta.max_group or any(
                        tab[k] is not verify[k] for k in tab) or (
                        rep["slot_bytes"] is not verify.slot_bytes
                        or rep["slot_len"] is not verify.slot_len):
                    verify = kernels.VerifyCorpus(tab, meta.max_group, rep["slot_bytes"],
                                                  rep["slot_len"])
                    kept = kept and old is None  # a first load keeps nothing to lose
                tab["verify"] = verify
                tab_all[dev, m] = tab
        # the leaves of the host trees, counted once (the reference's
        # count): changed ones went to every device that holds them
        new_leaves = dict(fpc.layout_leaves({"tab": tab_np, "rep": {**rep_np, "verdict": va}}))
        old_leaves = dict(fpc.layout_leaves({"tab": old_tab_np, "rep": {
            **(old_rep_np or {}), "verdict": self._va}})) if old_rep_np is not None else {}
        same = sum(1 for path, leaf in new_leaves.items() if path in old_leaves and (
            old_leaves[path] is leaf or _bytes_equal(old_leaves[path], leaf)))
        stats = {"uploaded_leaves": len(new_leaves) - same, "reused_leaves": same,
                 "executables_kept": kept and signature == self._signature,
                 "uploaded_bytes": counts.uploaded_bytes, "reused_bytes": counts.reused_bytes}
        self.db, self.meta, self.halo = db, meta, halo
        self.budget = global_candidate_budget(self.candidate_k, len(meta.table_stream))
        self._rep, self._tab = rep_all, tab_all
        self._rep_np, self._tab_np, self._va = rep_np, tab_np, va
        self._signature = signature
        return stats

    def refresh(self, db_new: "fpc.CompiledDB") -> dict:
        """Corpus refresh on the mesh (the reference's ``refresh``):
        recompute the per-rank stacked and the replicated host trees and
        upload only the leaves whose bytes changed (:meth:`_load_corpus`);
        the new ``halo`` (``max_entry_len``) is what the engine's mesh
        encode pads the streams to from then on. A combine still parked
        captured the old corpus: it is launched first, and on the card
        the grid's devices are synchronized before any tensor is
        rewritten. → ``{"uploaded_leaves", "reused_leaves",
        "executables_kept", "uploaded_bytes", "reused_bytes"}``: leaves
        of the host trees (a changed leaf is uploaded to each device
        that holds it), bytes over every device, ``executables_kept``
        True when the signature (mesh, halo, layout, the per-rank stack's
        shapes) is unchanged and every rank's corpus structs were kept.
        On a mesh across processes each process refreshes its own ranks
        and issues no collective. Caller quiesces dispatches first."""
        stale = self._take_pending()
        if stale is not None:
            stale.launch("refresh")
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self._load_corpus(db_new)

    def load_kernels(self) -> None:
        """Build (at first use) and load the match kernels' libraries
        when the grid has a CUDA device; nothing on the CPU."""
        if any(dev.type == "cuda" for dev in self.devices):
            for name in ("match", "md5", "verdicts"):
                kernels.load_library(name)

    # -- AOT library cache ---------------------------------------------
    def attach_aot(self, client) -> None:
        """Attach an :class:`~swarm_tpu_torch.aot.AotClient` to the
        process's kernel loader (``kernels.attach_aot``), as the
        single-device path does. Unlike the reference, a mesh across
        processes fetches too: an XLA executable is bound to the
        topology it was compiled for, but a kernel library is bound only
        to its sources, toolchain and card, which its key holds, so each
        rank process fetches and loads its own libraries. ``None``
        detaches."""
        kernels.attach_aot(client)

    def aot_prewarm(self) -> int:
        """Every published library of this process's program group into
        its keyed file (bring-up fetch; see ``DeviceDB.aot_prewarm``)."""
        return kernels.aot_prewarm()

    # ------------------------------------------------------------------
    # the deferred combine's double buffer (depth 1)

    def _take_pending(self) -> Optional[_PendingShard]:
        with self._lock:
            handle, self._pending = self._pending, None
        return handle

    def _clear_pending(self, handle: _PendingShard) -> None:
        with self._lock:
            if self._pending is handle:
                self._pending = None

    # ------------------------------------------------------------------
    def _check_seq_widths(self, streams: dict) -> None:
        seq_ranks = self.ranks["seq"]
        if seq_ranks <= 1:
            return
        for name, arr in streams.items():
            per_rank = arr.shape[1] // seq_ranks
            if arr.shape[1] % seq_ranks:
                raise ValueError(
                    f"stream {name!r} width {arr.shape[1]} not divisible "
                    f"by seq ranks {seq_ranks}"
                )
            if per_rank < self.halo:
                # the halo slices would come up short and misalign
                # every window coordinate
                raise ValueError(
                    f"stream {name!r}: per-rank width {per_rank} < halo "
                    f"{self.halo} (longest table entry); widen the "
                    f"stream or lower the seq factor"
                )

    def _stage(self, streams: dict, lengths: dict, status) -> tuple:
        """Upload each (data, seq) block to the devices of this process's
        ranks → (local, lens, stat): ``local[d, s, dev]`` the block's
        slice of every stream, ``lens[d, dev]`` and ``stat[d]`` (on the
        data rank's first device, where this process drives it) its
        rows' lengths and statuses. On a grid
        without seq ranks the "all" stream is synthesized on the device
        when the batch carries its placeholder, as ``DeviceDB`` does."""
        grid = self.mesh.devices
        D, S = self.ranks["data"], self.ranks["seq"]
        per = int(status.shape[0]) // D
        local: dict = {}
        lens: dict = {}
        stat: dict = {}
        for (d, _m, s), dev in self._mine.items():
            rows = slice(d * per, (d + 1) * per)
            if (d, dev) not in lens:
                lens[d, dev] = {k: torch.from_numpy(np.ascontiguousarray(
                    v[rows], dtype=np.int32)).to(dev) for k, v in lengths.items()}
            if (d, s, dev) not in local:
                blk = {}
                for name, arr in streams.items():
                    w = arr.shape[1] // S
                    blk[name] = torch.from_numpy(np.ascontiguousarray(
                        arr[rows, s * w:(s + 1) * w])).to(dev)
                local[d, s, dev] = ensure_all_stream(blk, lens[d, dev]) if S == 1 else blk
        for d in range(D):
            if (d, 0, 0) in self._mine:
                stat[d] = torch.from_numpy(np.ascontiguousarray(
                    status[d * per:(d + 1) * per], dtype=np.int32)).to(grid[d, 0, 0])
        return local, lens, stat

    def _exchange_halos(self, local: dict, streams: dict) -> dict:
        """Each (data, seq, device) block's halo-extended views: ``halo``
        bytes of the previous seq rank's slice before it and of the
        next one's after it (zeros at the row's two ends), copied from
        the neighbours' own devices. A neighbour that another process
        drives gives its edge from the host batch, which every process
        holds whole: the same bytes, with no cross-process traffic and
        no ordering between processes. Without seq ranks, the blocks."""
        S, h = self.ranks["seq"], self.halo
        if S <= 1:
            return dict(local)
        grid = self.mesh.devices
        per = int(next(iter(streams.values())).shape[0]) // self.ranks["data"]
        ext: dict = {}
        for (d, s, dev), blk in local.items():
            views = {}
            for name, mine in blk.items():
                parts = []
                for nb, cut in ((s - 1, slice(-h, None)), (s + 1, slice(0, h))):
                    if 0 <= nb < S:
                        # the neighbour's block: its copy on this device
                        # if it has one, else the one on its own device,
                        # else (another process's) the host batch's
                        src = local.get((d, nb, dev)) or local.get((d, nb, grid[d, 0, nb]))
                        if src is not None:
                            parts.append(src[name][:, cut].to(dev))
                        else:
                            w = mine.shape[1]
                            blk_np = streams[name][d * per:(d + 1) * per, nb * w:(nb + 1) * w]
                            parts.append(torch.from_numpy(np.ascontiguousarray(
                                blk_np[:, cut])).to(dev))
                    else:
                        parts.append(torch.zeros((mine.shape[0], h), dtype=mine.dtype,
                                                 device=dev))
                views[name] = torch.cat([parts[0], mine, parts[1]], dim=1)
            ext[d, s, dev] = views
        return ext

    def _dispatch_metrics(self, streams: dict) -> None:
        """Per-dispatch traffic: the planes entering the combine and the
        seq halo copies, all made in phase A (the views carry into
        phase B, so the reference's second round is charged as saved)."""
        m = shard_export
        m.SHARD_DISPATCHES.inc(1)
        B = int(next(iter(streams.values())).shape[0])
        ns = max(self.db.num_slots, 1)
        if self.ranks["model"] > 1 or self.ranks["seq"] > 1:
            m.PSUM_BYTES.inc(B * (2 * ns + 1) * 4)
        if self.ranks["seq"] > 1:
            round_bytes = 2 * self.halo * B * len(streams)
            m.HALO_BYTES.labels(phase="a").inc(round_bytes)
            m.HALO_SAVED.inc(round_bytes)

    # ------------------------------------------------------------------
    def dispatch(self, streams: dict, lengths: dict, status) -> _PendingShard:
        """Stage the host batch (numpy), run phase A and phase B on
        every rank, and return the batch's un-launched combine
        (:class:`_PendingShard`). The one host sync is the read of the
        ranks' survivor maxima between the phases."""
        # the fault point of DeviceDB.dispatch: "the device path failed"
        # is one failure class whichever matcher serves it
        fault_point("device.dispatch")
        self._check_seq_widths(streams)
        D = self.ranks["data"]
        B = int(status.shape[0])
        if B % D:
            raise ValueError(f"{B} rows do not split over {D} data ranks")
        db, meta, h = self.db, self.meta, self.halo
        T = len(meta.table_stream)
        plane_width = max(db.num_slots, 1)
        budget = self.budget
        t0 = time.perf_counter()
        with record_function("match.upload"):
            local, lens, stat = self._stage(streams, lengths, status)
            ext = self._exchange_halos(local, streams)
        t1 = time.perf_counter()
        lc = {"budget": budget, "upload_s": t1 - t0}
        # each (data, seq, device) block's tables, its offsets a stream
        blocks = {}
        for (d, s, dev), views in ext.items():
            loc = local[d, s, dev]
            offs = {name: s * v.shape[1] for name, v in loc.items()}
            tabs = None
            if T:
                tabs = kernels.MatchTables(
                    table_views(meta, views, lens[d, dev]), meta.table_q,
                    col_starts_of(meta, loc), h, h, [offs[n] for n in meta.table_stream])
            blocks[d, s, dev] = (tabs, offs)
        ranks = {}
        with record_function("match.phase_a"):
            for (d, m, s), dev in self._mine.items():
                tabs, _offs = blocks[d, s, dev]
                if tabs is None:
                    continue
                K = max(1, min(budget, int(tabs.col_starts[-1])))
                col, n_surv = kernels.match_phase_a(
                    tabs, tabs.qs, tabs.col_starts, self._tab[dev, m]["bloom"], budget, K,
                    h, h, tabs.offsets)
                ranks[d, m, s] = (col, n_surv > K, torch.clamp(n_surv, max=K).max())
        t2 = time.perf_counter()
        # with this batch's phase A queued, launch the previous batch's
        # combine: it runs behind the probe while the host waits below
        prev = self._take_pending()
        if prev is not None:
            prev.launch("dispatch")
            shard_export.OVERLAPPED.inc(1)
        # the one host sync between the phases: each rank's survivor
        # maximum (R × 4 bytes), maxed on the host to size phase B
        with record_function("match.scalar_read"):
            n_live = max((int(r[2]) for r in ranks.values()), default=0)
            if self.multiprocess and T:
                # the reference's pmax across processes: 4 bytes
                n_live = int(self._all_reduce_max(torch.tensor([n_live], dtype=torch.int32),
                                                  None, "survivor")[0])
        t3 = time.perf_counter()
        kc = fpc.survivor_bucket(n_live, budget)
        planes = {}
        with record_function("match.verify"):
            for (d, m, s), dev in self._mine.items():
                tabs, offs = blocks[d, s, dev]
                if tabs is not None:
                    col, overflow, _n = ranks[d, m, s]
                    rep = self._rep[dev]
                    value, unc = kernels.match_verify(
                        tabs, tabs.qs, tabs.col_starts, col, kc, self._tab[dev, m]["verify"],
                        meta.max_group, rep["slot_bytes"], rep["slot_len"], plane_width,
                        h, h, tabs.offsets)
                else:
                    rows = stat[d].shape[0]
                    value = torch.zeros((rows, plane_width), dtype=torch.bool, device=dev)
                    unc = torch.zeros_like(value)
                    overflow = torch.zeros((rows,), dtype=torch.bool, device=dev)
                value = tiny_slot_bits(meta, db.tiny_bytes, db.tiny_slot, ext[d, s, dev],
                                       lens[d, dev], value, h, offs)
                planes[d, m, s] = (value, unc, overflow)
        if T:
            lc.update(survivor_max=n_live, verify_k=kc)
            shard_export.SURVIVOR_MAX.set(n_live)
        lc.update(phase_a_s=t2 - t1, scalar_read_s=t3 - t2,
                  phase_b_s=time.perf_counter() - t3)
        self._dispatch_metrics(streams)
        body_len = lengths.get("body")
        if self.multiprocess:
            def combine():
                return self._combine_multiprocess(planes, local, lens, stat, body_len, streams)
        else:
            def combine():
                return self._combine(planes, local, lens, stat, body_len)
        handle = _PendingShard(self, combine, lc)
        if self.overlap:
            with self._lock:
                self._pending = handle
        else:
            handle.launch("inline")
        return handle

    def _combine(self, planes: dict, local: dict, lens: dict, stat: dict, body_len) -> tuple:
        """The deferred combine of one batch (the reference's psum over
        model and seq and its replicated verdict tail) on each data
        rank's first device → (host buffer of the fused planes, the
        events its copies wait on; none on the CPU)."""
        from swarm_tpu_torch.ops.regexdev import regex_verify

        db, meta = self.db, self.meta
        grid = self.mesh.devices
        D, S = self.ranks["data"], self.ranks["seq"]
        outs = []
        with record_function("match.combine"):
            for d in range(D):
                dev0 = grid[d, 0, 0]
                value = unc = overflow = None
                for (dd, m, s), (v, u, o) in planes.items():
                    if dd != d:
                        continue
                    v, u, o = v.to(dev0), u.to(dev0), o.to(dev0)
                    if value is None:
                        value, unc, overflow = v, u, o
                    else:
                        value, unc, overflow = value | v, unc | u, overflow | o
                ln, st = lens[d, dev0], stat[d]
                # md5 and the regex read whole rows: the slices of a
                # seq-sharded row, gathered by concatenation
                full = local[d, 0, dev0]
                if S > 1:
                    full = {name: torch.cat([local[d, s, grid[d, 0, s]][name].to(dev0)
                                             for s in range(S)], dim=1) for name in full}
                digest = None
                if meta.has_md5 and "body" in full:
                    rows = slice(d * st.shape[0], (d + 1) * st.shape[0])
                    max_len = int(np.max(body_len[rows])) if st.shape[0] else 0
                    digest = kernels.match_md5(full["body"], ln["body"], max_len=max_len)
                rep = self._rep[dev0]
                rx = None
                if meta.n_rx:
                    rx = regex_verify(db, full, ln, value, k_pairs=db.rx_k_pairs(st.shape[0]),
                                      arrays=rep["rx"], word_tab=rep["word_tab"])
                layout = rep["verdict"]
                verdicts = kernels.match_verdicts(layout, value, unc, ln, st, digest, rx)
                outs.append(fuse_planes(full_planes(layout.arrays, verdicts), overflow))
            if not outs[0].is_cuda:
                return torch.cat(outs), []
            # the data ranks' buffers into one pinned host buffer, each
            # copy behind an event on its device's current stream
            rows = outs[0].shape[0]
            host = torch.empty((rows * D, outs[0].shape[1]), dtype=torch.uint8, pin_memory=True)
            events = []
            for d, out in enumerate(outs):
                host[d * rows:(d + 1) * rows].copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(out.device))
                events.append(done)
        return host, events

    # ------------------------------------------------------------------
    # across processes

    def _collective(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collectives' backend takes it: host memory
        for gloo (a card two processes share is staged through it), a
        card of this process for NCCL."""
        if multihost.collective_backend() == "nccl":
            return (t if t.is_cuda else t.to(self.devices[0])).contiguous()
        return t.cpu().contiguous()

    def _all_reduce_max(self, t: torch.Tensor, group, kind: str) -> torch.Tensor:
        """Element-wise maximum of ``t`` over ``group``'s processes (the
        whole group for None), its bytes counted under ``kind``."""
        import torch.distributed as dist

        out = self._collective(t)
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=multihost.world_group() if group is None else group)
        self._count_cross(kind, out.numel() * out.element_size())
        return out.to(t.device)

    def _count_cross(self, kind: str, n: int) -> None:
        # each byte handed to a cross-process collective: the
        # reference's psum/pmax and its host-local gather, combined
        self.cross_process_bytes[kind] += n
        shard_export.PSUM_BYTES.inc(n)

    def _combine_multiprocess(self, planes: dict, local: dict, lens: dict, stat: dict,
                              body_len, streams: dict) -> tuple:
        """The combine on a mesh across processes, launched inline by
        every process in the same order. For each data rank: the OR of
        this process's planes of its ranks, then, where its model and
        seq ranks span processes, one all-reduce (MAX on uint8: the OR
        of 0/1 bytes; NCCL has no bitwise OR) of the value, uncertain
        and overflow planes over the data rank's group; then the process
        that drives its (d, 0, 0) rank runs the verdict tail on whole
        rows (from the host batch where a seq slice is another
        process's). Last, each data rank's fused buffer is broadcast
        from that process, so every process returns the whole result
        (the reference's ``global_array_to_host_local_array(..., P())``).
        → (host buffer, no events)."""
        import torch.distributed as dist

        from swarm_tpu_torch.ops.regexdev import regex_verify

        db, meta = self.db, self.meta
        grid = self.mesh.devices
        D, S = self.ranks["data"], self.ranks["seq"]
        rows = int(next(iter(streams.values())).shape[0]) // D
        width = sum(fused_plane_widths(db))
        nccl = multihost.collective_backend() == "nccl"
        outs = []
        with record_function("match.combine"):
            for d in range(D):
                dev0 = grid[d, 0, 0]
                mine = [(idx, p) for idx, p in planes.items() if idx[0] == d]
                value = unc = overflow = None
                if mine:
                    at = dev0 if (d, 0, 0) in self._mine else mine[0][1][0].device
                    for _idx, (v, u, o) in mine:
                        v, u, o = v.to(at), u.to(at), o.to(at)
                        if value is None:
                            value, unc, overflow = v, u, o
                        else:
                            value, unc, overflow = value | v, unc | u, overflow | o
                if d in self._groups:
                    ns = value.shape[1]
                    flat = torch.cat([value.reshape(-1), unc.reshape(-1), overflow]).to(torch.uint8)
                    flat = self._all_reduce_max(flat, self._groups[d], "combine").bool()
                    value = flat[:rows * ns].reshape(rows, ns)
                    unc = flat[rows * ns:2 * rows * ns].reshape(rows, ns)
                    overflow = flat[2 * rows * ns:]
                if self._owner[d] != self.process:
                    outs.append(None)
                    continue
                ln, st = lens[d, dev0], stat[d]
                full = local[d, 0, dev0]
                if S > 1:
                    full = {name: torch.from_numpy(np.ascontiguousarray(
                        arr[d * rows:(d + 1) * rows])).to(dev0) for name, arr in streams.items()}
                digest = None
                if meta.has_md5 and "body" in full:
                    max_len = int(np.max(body_len[d * rows:(d + 1) * rows])) if rows else 0
                    digest = kernels.match_md5(full["body"], ln["body"], max_len=max_len)
                rep = self._rep[dev0]
                rx = None
                if meta.n_rx:
                    rx = regex_verify(db, full, ln, value, k_pairs=db.rx_k_pairs(rows),
                                      arrays=rep["rx"], word_tab=rep["word_tab"])
                layout = rep["verdict"]
                verdicts = kernels.match_verdicts(layout, value, unc, ln, st, digest, rx)
                outs.append(fuse_planes(full_planes(layout.arrays, verdicts), overflow))
            # every data rank's buffer to every process, in data-rank order
            here = next(iter(self.devices)) if nccl else torch.device("cpu")
            host = []
            for d, out in enumerate(outs):
                buf = (self._collective(out) if out is not None
                       else torch.empty((rows, width), dtype=torch.uint8, device=here))
                dist.broadcast(buf, src=self._owner[d], group=multihost.world_group())
                self._count_cross("gather", buf.numel())
                host.append(buf.cpu())
        return torch.cat(host), []

    def collect(self, pending: _PendingShard):
        """Launch the batch's combine if no later dispatch did, wait for
        its reads, and split the buffer → :func:`split_fused`. Safe on
        any thread: the waits are on the batch's own events."""
        t0 = time.perf_counter()
        with record_function("match.collect"):
            host, events = pending.force()
            for done in events:
                done.synchronize()
            buf = host.numpy()
        dt = time.perf_counter() - t0
        pending.compact["collect_s"] = dt
        self.last_compact = pending.compact
        # launch-if-needed + the waits + the read: how long collect
        # stalled on the combine (≈0 when a later dispatch overlapped it)
        shard_export.REDUCTION_WAIT.inc(dt)
        return split_fused(self.db, buf)

    def match(self, streams: dict, lengths: dict, status):
        """→ (t_value, t_unc, op_value, op_unc, m_unc, overflow, wf), as
        ``DeviceDB.match`` gives them."""
        return self.collect(self.dispatch(streams, lengths, status))
