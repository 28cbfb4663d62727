"""Device match: response streams → word-slot bits → verdict planes.

The port of ``swarm_tpu/ops/match.py``'s split-phase, survivor-compacted
path. Per batch, on the card unless the CPU is asked for:

1. **Phase A** (kernel ``match_phase_a``, ``csrc/match.cu``): every word
   table's bloom probe over every window of its (stream, case, q) view,
   and the first K fired (table, window) columns of each row in
   ascending table-major order, plus each row's survivor count. The
   host then reads ONE scalar, the batch's ``max(min(n_surv, K))``, and
   picks phase B's width on the survivor ladder
   (``compile.survivor_bucket``).
2. **Phase B**: the gather-verify of those candidates (kernel
   ``match_verify``), tiny slots by dense shifted compare, the md5 of
   the body where the corpus checks digests (kernel ``match_md5``,
   ``csrc/md5.cu``), the device regex (``ops/regexdev.py``, kernel
   ``match_regex_scan``), and the verdict lowering with its three-valued
   uncertainty (kernel ``match_verdicts``, ``csrc/verdicts.cu``, over the
   CSR layout of :class:`VerdictLayout`; the workflow gates stay torch
   ops), packed into ONE fused byte buffer.
3. **Collect**: one host read of that buffer, sliced back into the
   planes by :func:`split_fused`.

The guarantee is the JAX package's: a (row, template) pair whose
uncertain bit is clear has the exact oracle verdict; uncertain pairs
carry a superset signal and need host confirmation only when fired.

Conventions. The uint32 corpus arrays are carried as int32 tensors
holding the same bits (the kernels read them as uint32); the plain
versions widen them to int64 masked to 32 bits, as PyTorch for the CPU
has no uint32 arithmetic. JAX clamps an out-of-range gather index
without a word where PyTorch raises, so every gather whose index comes
from the corpus goes through :func:`_clamped`.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from swarm_tpu_torch.fingerprints import compile as fpc
from swarm_tpu_torch.ops import hashing, kernels
from swarm_tpu_torch.ops.encoding import STREAMS
from swarm_tpu_torch.ops.kernels import StreamView
from swarm_tpu_torch.utils.device import resolve_device

MASK32 = 0xFFFFFFFF


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integer tensor) → int64 holding the uint32."""
    return t.to(torch.int64) & MASK32


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A gather index as JAX applies it: negative indices count from
    the end, then every index is clamped into [0, n - 1]."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def to_device(tree, device: torch.device):
    """numpy layout tree → torch tensors on ``device``: uint32 arrays
    as int32 bit patterns, every other dtype as it is."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_device(v, device) for v in tree)
    arr = np.ascontiguousarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


# ---------------------------------------------------------------------------
# Fused full-mode output (producer and consumer live here)


def fused_plane_widths(db: "fpc.CompiledDB") -> list:
    """Byte widths of the output planes in fused order: t_value, t_unc,
    op_value, op_unc, m_unc (packed bits), then — only when the corpus
    lowered workflow gate tables — wf_cond_v, wf_cond_u, wf_emit_v,
    wf_emit_u, and finally the 1-byte overflow column. The template
    planes are padded to max(NT, 1) (eval_verdicts' allocation); the
    op/matcher planes are not."""
    nbt = (max(db.num_templates, 1) + 7) >> 3
    nbo = (db.op_src.shape[0] + 7) >> 3
    nbm = (db.m_src.shape[0] + 7) >> 3
    widths = [nbt, nbt, nbo, nbo, nbm]
    wf = getattr(db, "wf", None)
    if wf is not None and wf.num_terms:
        nbc = (wf.num_conds + 7) >> 3
        nbe = (wf.num_emits + 7) >> 3
        widths += [nbc, nbc, nbe, nbe]
    widths.append(1)
    return widths


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, N] → uint8 [B, ceil(N / 8)], MSB first (np.packbits)."""
    B, N = bits.shape
    nb = (N + 7) >> 3
    padded = torch.nn.functional.pad(bits.to(torch.uint8), (0, nb * 8 - N))
    # 128, 64, ..., 1 made on the device: a host tensor would be a copy
    # and a sync in the middle of phase B
    weights = (128 >> torch.arange(8, device=bits.device)).to(torch.uint8)
    return (padded.reshape(B, nb, 8) * weights).sum(-1, dtype=torch.uint8)


def fuse_planes(planes, overflow: torch.Tensor) -> torch.Tensor:
    """Pack the bit planes and append the overflow byte column — ONE
    device tensor, one host read (:func:`split_fused` slices it)."""
    parts = [packbits(p) for p in planes]
    parts.append(overflow[:, None].to(torch.uint8))
    return torch.cat(parts, dim=1)


def split_fused(db: "fpc.CompiledDB", buf: np.ndarray):
    """One fused host buffer → (t_value, t_unc, op_value, op_unc, m_unc,
    overflow bool [B], wf planes or None), the packed planes as views."""
    buf = np.ascontiguousarray(buf)
    outs = []
    off = 0
    for w in fused_plane_widths(db):
        outs.append(buf[:, off : off + w])
        off += w
    if off != buf.shape[1]:
        raise ValueError(
            f"fused buffer is {buf.shape[1]} bytes wide, plane widths "
            f"sum to {off}"
        )
    if len(outs) == 10:
        pt, pu, opv, opu, mu, cv, cu, ev, eu, ovf = outs
        wf = (cv, cu, ev, eu)
    else:
        pt, pu, opv, opu, mu, ovf = outs
        wf = None
    return pt, pu, opv, opu, mu, ovf[:, 0] != 0, wf


def global_candidate_budget(candidate_k: int, n_tables: int) -> int:
    """Per-row candidate budget of phase A's compaction: ``candidate_k``
    ×1 for ≤2 tables up to ×4 for ≥8 (the JAX package's rule)."""
    return candidate_k * max(1, min(n_tables, 8) // 2)


# ---------------------------------------------------------------------------
# Streams


def lower_stream(arr: torch.Tensor) -> torch.Tensor:
    return torch.where((arr >= 65) & (arr <= 90), arr + 32, arr)


def ensure_all_stream(streams: dict, lengths: dict) -> dict:
    """Synthesize the "all" stream (header + CRLF + body) on the device
    when the encode shipped a width-1 placeholder (``build_all=False``);
    ``lengths["all_hdr"]`` is each row's header-prefix length (0 =
    body-only). A host-built "all" passes through."""
    allv = streams.get("all")
    if allv is None or allv.shape[1] > 1 or "all_hdr" not in lengths:
        return streams
    body, header = streams["body"], streams["header"]
    B, Wb = body.shape
    Wh = header.shape[1]
    Wa = ((Wb + Wh + 2 + 127) // 128) * 128
    dev = body.device
    hl = lengths["all_hdr"].to(torch.int64)[:, None]
    bl = lengths["body"].to(torch.int64)[:, None]
    j = torch.arange(Wa, dtype=torch.int64, device=dev)[None, :]
    off = torch.where(hl > 0, hl + 2, 0)
    hvals = torch.gather(header, 1, j.clamp(max=Wh - 1).expand(B, Wa))
    bpos = j - off
    is_body = (bpos >= 0) & (bpos < bl)
    bvals = torch.gather(body, 1, bpos.clamp(0, Wb - 1).expand(B, Wa))
    is_crlf = (hl > 0) & (j >= hl) & (j < hl + 2)
    crlf = torch.where(j == hl, 13, 10).to(torch.uint8)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    synth = torch.where(
        j < hl, hvals, torch.where(is_crlf, crlf, torch.where(is_body, bvals, zero))
    )
    out = dict(streams)
    out["all"] = synth.contiguous()
    return out


def col_starts_of(meta: "fpc.DeviceLayoutMeta", streams: dict) -> np.ndarray:
    """Per-table start offsets on the concatenated (table, window)
    candidate axis, from the post-``ensure_all_stream`` widths."""
    T = len(meta.table_stream)
    cs = np.zeros(T + 1, dtype=np.int32)
    for t in range(T):
        cs[t + 1] = cs[t] + streams[meta.table_stream[t]].shape[1]
    return cs


def table_views(meta: "fpc.DeviceLayoutMeta", streams: dict, lengths: dict) -> list:
    """One :class:`StreamView` per word table, in table order."""
    return [
        StreamView(streams[s], lengths[s], bool(low))
        for s, low in zip(meta.table_stream, meta.table_lowered)
    ]


class _ViewCache:
    """Lowered streams and hash planes shared by a plain version's tables."""

    def __init__(self):
        self._lowered: dict = {}
        self._hashes: dict = {}

    def stream(self, v: StreamView) -> torch.Tensor:
        if not v.lowered:
            return v.data
        key = v.data.data_ptr()
        if key not in self._lowered:
            self._lowered[key] = lower_stream(v.data)
        return self._lowered[key]

    def hashes(self, v: StreamView, q: int):
        key = (v.data.data_ptr(), v.lowered, q)
        if key not in self._hashes:
            self._hashes[key] = hashing.window_hashes(self.stream(v), q)
        return self._hashes[key]


# ---------------------------------------------------------------------------
# Phase A and phase B: plain versions of the kernels


def prefilter_flags(views: list, qs, bloom: torch.Tensor) -> torch.Tensor:
    """The fired (table, window) flags, bool [B, C] on the table-major
    candidate axis (the JAX ``prefilter_counts`` before its cumsum)."""
    cache = _ViewCache()
    flags = []
    for t, (v, q) in enumerate(zip(views, qs)):
        h1, h2 = cache.hashes(v, int(q))
        W = h1.shape[1]
        i1 = h1 & (hashing.BLOOM_BITS - 1)
        i2 = h2 & (hashing.BLOOM_BITS - 1)
        words = u32(bloom[t])
        b1 = (words[i1 >> 5] >> (i1 & 31)) & 1
        b2 = (words[i2 >> 5] >> (i2 & 31)) & 1
        # windows starting past len - q cannot begin a real gram
        pos = torch.arange(W, dtype=torch.int64, device=h1.device)[None, :]
        bound = (v.lengths.to(torch.int64) - int(q))[:, None]
        flags.append(((b1 & b2) == 1) & (pos <= bound))
    return torch.cat(flags, dim=1)


def phase_a_plain(
    views: list, qs, col_starts, bloom: torch.Tensor, budget: int, kclamp: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel ``match_phase_a`` (same contract)."""
    flags = prefilter_flags(views, qs, bloom)
    B, C = flags.shape
    cnt = torch.cumsum(flags.to(torch.int64), dim=1)
    n_surv = cnt[:, -1] if C else torch.zeros(B, dtype=torch.int64, device=flags.device)
    # the j-th fired column lands in col[:, j] for j < kclamp; every
    # other column goes to a spill slot that is cut off
    target = torch.where(flags & (cnt <= kclamp), cnt - 1, budget)
    col = torch.full((B, budget + 1), -1, dtype=torch.int32, device=flags.device)
    cols = torch.arange(C, dtype=torch.int32, device=flags.device).expand(B, C)
    col.scatter_(1, target, cols)
    return col[:, :budget].contiguous(), n_surv.to(torch.int32)


def verify_plain(
    views: list, qs, col_starts, col: torch.Tensor, kc: int, tab: dict,
    max_group: int, slot_bytes: torch.Tensor, slot_len: torch.Tensor,
    plane_width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel ``match_verify`` — the JAX
    ``verify_candidates``, gather for gather."""
    dev = col.device
    col = col[:, :kc]
    B, K = col.shape
    T = len(views)
    if K == 0:
        empty = torch.zeros((B, plane_width), dtype=torch.bool, device=dev)
        return empty, empty.clone()
    cache = _ViewCache()
    valid = col >= 0
    colc = col.clamp(min=0).to(torch.int64)
    cs = torch.as_tensor(np.asarray(col_starts, dtype=np.int64), device=dev)
    tid = torch.searchsorted(cs, colc, right=True) - 1
    tid = tid.clamp(0, T - 1)
    cpos = colc - cs[tid]

    # per-candidate table attributes via small [T] tables
    combos = []
    t_combo = []
    for v, q in zip(views, qs):
        key = (v.data.data_ptr(), v.lowered, int(q))
        if key not in combos:
            combos.append(key)
        t_combo.append(combos.index(key))
    combo_view = {}
    for t, c in enumerate(t_combo):
        combo_view.setdefault(c, (views[t], int(qs[t])))
    cand_combo = torch.as_tensor(t_combo, device=dev)[tid]
    t_we = torch.as_tensor([v.data.shape[1] for v in views], device=dev)
    cand_we = t_we[tid]
    cand_slen = torch.gather(
        torch.stack([v.lengths.to(torch.int64) for v in views], dim=1), 1, tid
    )

    def hash_at(positions):
        out1 = torch.zeros((B, K), dtype=torch.int64, device=dev)
        out2 = torch.zeros((B, K), dtype=torch.int64, device=dev)
        for ci, (v, q) in combo_view.items():
            h1, h2 = cache.hashes(v, q)
            p = positions.clamp(0, h1.shape[1] - 1)
            sel = cand_combo == ci
            out1 = torch.where(sel, torch.gather(h1, 1, p), out1)
            out2 = torch.where(sel, torch.gather(h2, 1, p), out2)
        return out1, out2

    h1c, h2c = hash_at(cpos)

    # binary search of the stacked sorted h1 groups
    group_h1 = u32(tab["group_h1"])
    gmax = group_h1.shape[1]
    ng = tab["n_groups"].to(torch.int64)[tid]
    lo = torch.zeros_like(colc)
    hi = ng
    for _ in range(max(gmax, 1).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = group_h1[tid, mid.clamp(max=gmax - 1)]
        right = active & (v < h1c)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    gidx = lo.clamp(max=gmax - 1)
    found = valid & (lo < ng) & (group_h1[tid, gidx] == h1c)
    e_start = tab["entry_start"].to(torch.int64)[tid, gidx]
    e_count = tab["entry_count"].to(torch.int64)[tid, gidx]

    emax = tab["entry_h2"].shape[1]
    V = fpc.VERIFY_WIDTH
    offs = torch.arange(V, dtype=torch.int64, device=dev)
    b_idx = torch.arange(B, dtype=torch.int64, device=dev)[:, None].expand(B, K)
    # the candidates' streams, stacked at one width, for the byte verify
    wmax = max(int(v.data.shape[1]) for v in views)
    stacked = torch.stack([
        torch.nn.functional.pad(cache.stream(v), (0, wmax - v.data.shape[1]))
        for v in views
    ], dim=1)  # [B, T, wmax]
    rows = stacked[b_idx, tid]  # [B, K, wmax]
    slot_bytes_l = slot_bytes.to(torch.int64)
    vacc = torch.zeros(B * plane_width, dtype=torch.int32, device=dev)
    uacc = torch.zeros(B * plane_width, dtype=torch.int32, device=dev)
    for g in range(max_group):
        e = (e_start + g).clamp(max=emax - 1)
        in_group = found & (g < e_count)
        h2_ok = u32(tab["entry_h2"])[tid, e] == h2c
        spos = cpos + tab["entry_suf_delta"].to(torch.int64)[tid, e]
        s1, s2 = hash_at(spos)
        suf_ok = (
            (s1 == u32(tab["entry_suf_h1"])[tid, e])
            & (s2 == u32(tab["entry_suf_h2"])[tid, e])
            & (spos >= 0)
            & (spos < cand_we)
        )
        off_e = tab["entry_off"].to(torch.int64)[tid, e]
        len_e = tab["entry_len"].to(torch.int64)[tid, e]
        start = cpos - off_e
        fits = (start >= 0) & (start + len_e <= cand_slen) & (start + len_e <= cand_we)
        hit = in_group & h2_ok & suf_ok & fits
        slot = tab["entry_slot"].to(torch.int64)[tid, e]
        idx = (start[:, :, None] + offs).clamp(0, wmax - 1)
        gathered = torch.gather(rows, 2, idx).to(torch.int64)
        expected = slot_bytes_l[slot]  # [B, K, V]
        pos_ok = offs < len_e.clamp(max=V)[:, :, None]
        eq = ((gathered == expected) | ~pos_ok).all(-1)
        fired = hit & eq
        long = slot_len.to(torch.int64)[slot] > V
        # .at[b, slot].max(fired): repeated slots OR together
        flat = (b_idx * plane_width + slot).reshape(-1)
        vacc.index_add_(0, flat, fired.reshape(-1).to(torch.int32))
        uacc.index_add_(0, flat, (fired & long).reshape(-1).to(torch.int32))
    return (vacc > 0).view(B, plane_width), (uacc > 0).view(B, plane_width)


def tiny_slot_bits(
    meta: "fpc.DeviceLayoutMeta", tiny_bytes: np.ndarray, tiny_slot: np.ndarray,
    streams: dict, lengths: dict, value_bits: torch.Tensor,
) -> torch.Tensor:
    """Tiny slots (1–3 bytes): dense shifted compare — exact. The
    pattern bytes and slot ids are host ints (static per corpus)."""
    value_bits = value_bits.clone()
    shift_cache: dict = {}
    for i, (length, name, lowered) in enumerate(meta.tiny):
        key = (name, lowered)
        if key not in shift_cache:
            sv = streams[name]
            sv = lower_stream(sv) if lowered else sv
            W = sv.shape[1]
            padded = torch.nn.functional.pad(sv, (0, hashing.TINY_MAX))
            shift_cache[key] = [padded[:, j : j + W] for j in range(hashing.TINY_MAX)]
        shifts = shift_cache[key]
        W = shifts[0].shape[1]
        eq = shifts[0] == int(tiny_bytes[i, 0])
        for j in range(1, length):
            eq = eq & (shifts[j] == int(tiny_bytes[i, j]))
        pos = torch.arange(W, dtype=torch.int64, device=eq.device)[None, :]
        eq = eq & (pos <= (lengths[name].to(torch.int64) - length)[:, None])
        # the window lies inside the view's real bytes
        eq = eq & (pos + length <= W)
        slot = int(tiny_slot[i])
        value_bits[:, slot] |= eq.any(dim=1)
    return value_bits


# ---------------------------------------------------------------------------
# Verdict lowering: plain version (torch ops) and the layout of kernel match_verdicts


def _scatter_or(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> None:
    """dst[:, rows] |= src for possibly repeated ``rows`` (JAX .at[].max)."""
    acc = torch.zeros(dst.shape, dtype=torch.int32, device=dst.device)
    acc.index_add_(1, rows.to(torch.int64), src.to(torch.int32))
    dst |= acc > 0


def full_planes(arrays: dict, planes: tuple) -> tuple:
    """(t_value, t_unc, op_value, op_unc, m_value, m_unc) → the planes
    the JAX ``eval_verdicts(full=True)`` returns: m_value dropped (it
    may be None without gates), the four workflow gate planes appended
    when the corpus has gate tables (``arrays``: :func:`verdict_arrays`)."""
    t_value, t_unc, op_value, op_unc, m_value, m_unc = planes
    wf = arrays.get("wf")
    if wf is not None:
        gates = _apply_workflow_gates(wf, t_value, t_unc, op_value, op_unc, m_value, m_unc)
        return (t_value, t_unc, op_value, op_unc, m_unc, *gates)
    return t_value, t_unc, op_value, op_unc, m_unc


def eval_verdicts(
    db: "fpc.CompiledDB",
    value_bits: torch.Tensor,
    uncertain_bits: torch.Tensor,
    lengths: dict,
    status: torch.Tensor,
    md5_digest: Optional[torch.Tensor] = None,
    rx=None,
    arrays: Optional[dict] = None,
) -> tuple:
    """Slot bits + scalars → (t_value, t_unc, op_value, op_unc, m_value,
    m_unc) bool planes: the JAX ``eval_verdicts`` op for op, as torch
    ops (the plain version of kernel ``match_verdicts``), up to its
    ``full`` tail (:func:`full_planes`).

    Uncertainty is refined with three-valued logic at every reduction
    (a verdict decided by its certain inputs clears its uncertain bit).
    The scalar, status, size and md5 checks are computed for the
    matchers of that kind only: the JAX code computes them for every
    matcher and reads them only under that kind's mask, so the planes
    are the same."""
    dev = value_bits.device
    if arrays is None:
        arrays = verdict_arrays(db, dev)
    B = status.shape[0]
    NM = int(db.m_kind.shape[0])
    NS = value_bits.shape[1]

    svars = torch.stack(
        [(status if name == "status" else lengths[name]).to(torch.float32)
         for name in SCALAR_VAR_SOURCES],
        dim=1,
    )  # [B, SCALAR_VARS]

    # --- slot reductions (vacuously true when a matcher has no slots) ---
    slot_red = torch.ones((B, NM), dtype=torch.bool, device=dev)
    m_unc = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    cond_and = arrays["m_cond_and"]
    for rows, idx in arrays["m_slot_buckets"]:
        idx = _clamped(idx, NS)
        gv = value_bits[:, idx]  # [B, nb, w]
        gu = uncertain_bits[:, idx]
        is_and = cond_and[rows][None, :]
        red = torch.where(is_and, gv.all(-1), gv.any(-1))
        # Kleene: a certain-hit slot decides OR; any miss decides AND
        decided = torch.where(is_and, (~gv).any(-1), (gv & ~gu).any(-1))
        slot_red[:, rows] = red
        m_unc[:, rows] = gu.any(-1) & ~decided

    # --- negated-contains buckets: NONE of the slots may be present ---
    neg_present = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    neg_decided_false = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    for rows, idx in arrays["m_negslot_buckets"]:
        idx = _clamped(idx, NS)
        gv = value_bits[:, idx]
        gu = uncertain_bits[:, idx]
        neg_present[:, rows] = gv.any(-1)
        neg_decided_false[:, rows] = (gv & ~gu).any(-1)
        m_unc[:, rows] |= gu.any(-1)

    kinds = arrays["kind_ids"]

    # --- scalar programs ---
    scalar_ok = torch.ones((B, NM), dtype=torch.bool, device=dev)
    ids = kinds["scalar"]
    if ids.numel():
        var_id = _clamped(arrays["scalar_var"][ids], svars.shape[1])  # [n, C]
        cmp_val = arrays["scalar_cmp"][ids]
        v = svars[:, var_id]  # [B, n, C]
        checks = (
            v == cmp_val, v != cmp_val, v < cmp_val, v > cmp_val,
            v <= cmp_val, v >= cmp_val, torch.ones_like(v, dtype=torch.bool),
        )
        onehot = arrays["scalar_onehot"][:, ids]  # [NCHECKS, n, C]
        conj = torch.zeros_like(v, dtype=torch.bool)
        for i, c in enumerate(checks):
            conj |= onehot[i][None] & c
        scalar_ok[:, ids] = conj.all(-1)

    # --- status / size matchers ---
    status_ok = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    ids = kinds["status"]
    if ids.numel():
        status_ok[:, ids] = (
            status[:, None, None] == arrays["m_status"][ids][None]
        ).any(-1)
    size_ok = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    ids = kinds["size"]
    if ids.numel():
        len_streams = torch.stack([lengths[name] for name in STREAMS], dim=1)
        sel = len_streams[:, _clamped(arrays["m_size_stream"][ids], len(STREAMS))]
        size_ok[:, ids] = (sel[:, :, None] == arrays["m_size"][ids][None]).any(-1)

    is_words = arrays["is_words"]
    is_scalar = arrays["is_scalar"]

    # device md5 digest equality; fail CLOSED without a digest
    md5_ok = torch.ones((B, NM), dtype=torch.bool, device=dev)
    ids = kinds["md5"]
    if md5_digest is not None:
        if ids.numel():
            md5_ok[:, ids] = (
                md5_digest[:, None, :] == u32(arrays["m_md5"][ids])[None]
            ).all(-1)
    elif ids.numel():
        m_unc |= arrays["m_md5_check"][None, :]

    m_value = torch.zeros((B, NM), dtype=torch.bool, device=dev)
    m_value = torch.where(is_words[None, :], slot_red, m_value)
    m_value = torch.where(
        is_scalar[None, :], scalar_ok & slot_red & ~neg_present & md5_ok, m_value
    )
    m_value = torch.where(arrays["is_status"][None, :], status_ok, m_value)
    m_value = torch.where(arrays["is_size"][None, :], size_ok, m_value)

    # Kleene over the scalar∧slots∧¬neg∧md5 conjunction
    m_unc = m_unc & ~(is_scalar[None, :] & (~scalar_ok | ~md5_ok | neg_decided_false))
    # md5-style residues: a scalar pass still needs host confirmation
    m_unc = m_unc | (arrays["m_residue"][None, :] & m_value)
    # fired regex prefilters are uncertain ...
    m_unc = m_unc | (arrays["is_rx_prefilter"][None, :] & m_value)
    # ... except matchers the device regex re-checked exactly
    if rx is not None and len(db.rx_m_ids):
        rx_value, rx_unc = rx
        ids = arrays["rx_m_ids"].to(torch.int64)
        m_value[:, ids] = rx_value
        m_unc[:, ids] = rx_unc
    # negation after uncertainty capture
    m_value = m_value ^ arrays["m_negative"][None, :]

    # --- operations ---
    NOP = int(db.op_cond_and.shape[0])
    op_value = torch.zeros((B, NOP), dtype=torch.bool, device=dev)
    op_unc = torch.zeros((B, NOP), dtype=torch.bool, device=dev)
    op_cond = arrays["op_cond_and"]
    for rows, idx in arrays["op_m_buckets"]:
        idx = _clamped(idx, NM)
        gv = m_value[:, idx]
        gu = m_unc[:, idx]
        is_and = op_cond[rows][None, :]
        red = torch.where(is_and, gv.all(-1), gv.any(-1))
        decided = torch.where(is_and, (~gv & ~gu).any(-1), (gv & ~gu).any(-1))
        op_value[:, rows] = red
        op_unc[:, rows] = gu.any(-1) & ~decided
    # superset-lowered (prefilter) ops: uncertain exactly when fired
    op_unc = torch.where(arrays["op_prefilter"][None, :], op_value, op_unc)

    # --- templates: OR over their operations ---
    NT = max(db.num_templates, 1)
    t_value = torch.zeros((B, NT), dtype=torch.bool, device=dev)
    t_unc = torch.zeros((B, NT), dtype=torch.bool, device=dev)
    for rows, idx in arrays["t_op_buckets"]:
        idx = _clamped(idx, NOP)
        gv = op_value[:, idx]
        gu = op_unc[:, idx]
        t_value[:, rows] = gv.any(-1)
        t_unc[:, rows] = gu.any(-1) & ~(gv & ~gu).any(-1)
    return t_value, t_unc, op_value, op_unc, m_value, m_unc


def _apply_workflow_gates(wf: dict, t_value, t_unc, op_value, op_unc, m_value, m_unc):
    """Workflow gate-apply over the batch: each DNF condition gathered
    from the verdict planes, ANDed per term under Kleene logic, terms
    ORed into the emit plane. Host condition kinds read as (False,
    uncertain). → (cond_v, cond_u, emit_v, emit_u)."""
    B = t_value.shape[0]
    dev = t_value.device
    ck = wf["cond_kind"]
    ci = wf["cond_idx"].to(torch.int64)
    host = wf["cond_host"]
    is_t = ck == fpc.WFC_HIT_DEV
    is_op = ck == fpc.WFC_OP
    is_m = ck == fpc.WFC_MATCHER
    # one certain-False column pads each plane, for the host kinds
    pad = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    tv, tu = torch.cat([t_value, pad], 1), torch.cat([t_unc, pad], 1)
    opv, opu = torch.cat([op_value, pad], 1), torch.cat([op_unc, pad], 1)
    mv, mu = torch.cat([m_value, pad], 1), torch.cat([m_unc, pad], 1)
    ti = _clamped(torch.where(is_t, ci, tv.shape[1] - 1), tv.shape[1])
    oi = _clamped(torch.where(is_op, ci, opv.shape[1] - 1), opv.shape[1])
    mi = _clamped(torch.where(is_m, ci, mv.shape[1] - 1), mv.shape[1])
    cond_v = tv[:, ti] | opv[:, oi] | mv[:, mi]
    cond_u = tu[:, ti] | opu[:, oi] | mu[:, mi] | host[None, :]

    tc = wf["term_cond"].to(torch.int64)  # [NTERM, CMAX], -1 = vacuously TRUE
    valid = tc >= 0
    tcc = _clamped(tc.clamp(min=0), cond_v.shape[1])
    g_v = torch.where(valid[None], cond_v[:, tcc], True)
    g_u = torch.where(valid[None], cond_u[:, tcc], False)
    term_dead = (~g_v & ~g_u).any(-1)
    term_true = (g_v & ~g_u).all(-1)

    te = wf["term_emit"]
    NE = wf["emit_pad"].shape[0]
    emit_v = torch.zeros((B, NE), dtype=torch.bool, device=dev)
    emit_p = torch.zeros((B, NE), dtype=torch.bool, device=dev)
    _scatter_or(emit_v, te, term_true)
    _scatter_or(emit_p, te, ~term_dead)
    return cond_v, cond_u, emit_v, emit_p & ~emit_v


def verdict_arrays(db: "fpc.CompiledDB", device: torch.device) -> dict:
    """The verdict half of the layout on ``device``, plus the matcher
    ids of each check kind eval_verdicts computes per kind."""
    arrays = to_device(fpc.verdict_arrays_np(db), device)
    kind = db.m_kind
    arrays["kind_ids"] = to_device({
        "scalar": np.flatnonzero(kind == fpc.MK_SCALAR_DSL),
        "status": np.flatnonzero(kind == fpc.MK_STATUS),
        "size": np.flatnonzero(kind == fpc.MK_SIZE),
        "md5": np.flatnonzero(db.m_md5_check),
    }, device)
    return arrays


#: the values a scalar or size check reads, by source index: each
#: stream's length in ``encoding.STREAMS`` order, then the status (the
#: order of kernel ``match_verdicts``'s ``sources``; its kStatusSource
#: is the last)
CHECK_SOURCES = STREAMS + ("status",)
#: the scalar programs' variables (``compile.SV_*``, by id) by source
SCALAR_VAR_SOURCES = ("status", "body", "header", "all", "body")
assert len(SCALAR_VAR_SOURCES) == fpc.SCALAR_VARS

#: the matcher flag bits of the verdict layout, bit i = 1 << i, by the
#: ``verdict_arrays_np`` entry each copies (csrc/verdicts.cu kM*)
M_FLAG_BITS = ("m_cond_and", "m_negative", "m_residue", "m_md5_check", "is_words",
               "is_rx_prefilter", "is_scalar", "is_status", "is_size")
#: the operation flag bits (csrc/verdicts.cu kOp*)
OP_FLAG_BITS = ("op_cond_and", "op_prefilter")


def _csr(buckets, owners: int) -> tuple:
    """IndexBucket (rows, idx) pairs → CSR (off int32 [owners + 1],
    members int32): owner o's members are members[off[o]:off[o + 1]],
    its bucket row as it is (padding included); empty for an owner in
    no bucket. An owner in two buckets, or out of range, is refused:
    the bucket lists give each owner one row."""
    rows = [np.asarray(r, dtype=np.int64) for r, _ in buckets]
    flat = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= owners):
        raise ValueError(f"bucket owner out of [0, {owners})")
    if np.bincount(flat, minlength=owners).max(initial=0) > 1:
        raise ValueError("an owner has rows in two buckets")
    count = np.zeros(owners, dtype=np.int64)
    for r, (_rows, idx) in zip(rows, buckets):
        count[r] = idx.shape[1]
    off = np.zeros(owners + 1, dtype=np.int64)
    np.cumsum(count, out=off[1:])
    members = np.zeros(int(off[-1]), dtype=np.int32)
    for r, (_rows, idx) in zip(rows, buckets):
        members[off[r][:, None] + np.arange(idx.shape[1])] = idx
    return off.astype(np.int32), members


def verdict_layout_np(db: "fpc.CompiledDB") -> dict:
    """The corpus half of kernel ``match_verdicts``, from the same
    ``verdict_arrays_np`` its plain version reads: each bucket list as
    CSR (``m_slot``, ``m_neg``, ``op_m``, ``t_op`` ``_off`` / ``_idx``),
    the matcher and op flags as bits, the scalar programs' one-hot check
    selection as a 7-bit mask per (matcher, conjunct), each conjunct's
    variable and each size matcher's stream resolved (clamped as the
    plain version clamps them) to an index of :data:`CHECK_SOURCES`
    (``scalar_src``, ``m_size_src``), and ``m_rx``, each matcher's
    column of the device-regex overlay or -1."""
    va = fpc.verdict_arrays_np(db)
    nm = int(db.m_kind.shape[0])
    nop = int(db.op_cond_and.shape[0])
    nt = max(db.num_templates, 1)
    out = {}
    for key, buckets, owners in (
        ("m_slot", va["m_slot_buckets"], nm), ("m_neg", va["m_negslot_buckets"], nm),
        ("op_m", va["op_m_buckets"], nop), ("t_op", va["t_op_buckets"], nt),
    ):
        out[f"{key}_off"], out[f"{key}_idx"] = _csr(buckets, owners)
    out["m_flags"] = np.zeros(nm, dtype=np.int32)
    for bit, key in enumerate(M_FLAG_BITS):
        out["m_flags"] |= va[key].astype(np.int32) << bit
    out["op_flags"] = np.zeros(nop, dtype=np.int32)
    for bit, key in enumerate(OP_FLAG_BITS):
        out["op_flags"] |= va[key].astype(np.int32) << bit
    rx_ids = np.asarray(va["rx_m_ids"], dtype=np.int64)
    if rx_ids.size and (rx_ids.min() < 0 or rx_ids.max() >= nm):
        raise ValueError(f"rx matcher id out of [0, {nm})")
    out["m_rx"] = np.full(nm, -1, dtype=np.int32)
    for col, m in enumerate(rx_ids):  # a repeated id keeps its last column
        out["m_rx"][m] = col
    onehot = va["scalar_onehot"]  # [NCHECKS, NM, C]
    var_src = np.array([CHECK_SOURCES.index(n) for n in SCALAR_VAR_SOURCES], dtype=np.int32)
    var_id = _clamped(torch.from_numpy(va["scalar_var"]), len(SCALAR_VAR_SOURCES))
    out["scalar_src"] = var_src[var_id.numpy()]
    out["scalar_cmp"] = va["scalar_cmp"]
    out["scalar_mask"] = np.zeros(onehot.shape[1:], dtype=np.int32)
    for bit in range(onehot.shape[0]):
        out["scalar_mask"] |= onehot[bit].astype(np.int32) << bit
    if va["m_size"].shape != va["m_status"].shape:
        raise ValueError("m_size and m_status must have one shape")
    size_stream = _clamped(torch.from_numpy(va["m_size_stream"]), len(STREAMS))
    out["m_size_src"] = size_stream.numpy().astype(np.int32)
    for key in ("m_status", "m_size", "m_md5"):
        out[key] = va[key]
    return out


class VerdictLayout:
    """The verdict lowering's corpus half on one device, built once per
    corpus: ``csr``, the layout kernel ``match_verdicts`` reads
    (:func:`verdict_layout_np`, int32 tensors, float32 ``scalar_cmp``,
    ``m_md5`` as int32 bits), and ``arrays``, the bucketed arrays of its
    plain version and of the workflow gates (:func:`verdict_arrays`)."""

    def __init__(self, db: "fpc.CompiledDB", device: torch.device):
        self.db = db
        self.csr = to_device(verdict_layout_np(db), device)
        # the tensors' own device ("cuda:0" for "cuda"), as the planes carry it
        self.device = self.csr["m_flags"].device
        self.arrays = verdict_arrays(db, self.device)
        self.nm = int(db.m_kind.shape[0])
        self.nop = int(db.op_cond_and.shape[0])
        self.nt = max(db.num_templates, 1)
        self.n_rx = len(db.rx_m_ids)
        # m_value leaves the lowering only for the workflow gates
        self.has_gates = self.arrays.get("wf") is not None
        # the kernel's struct of the csr tensors' pointers, made once
        self.struct = kernels.verdict_struct(self)


def verdicts_plain(
    layout: VerdictLayout, value_bits: torch.Tensor, uncertain_bits: torch.Tensor,
    lengths: dict, status: torch.Tensor, md5_digest: Optional[torch.Tensor] = None, rx=None,
) -> tuple:
    """Plain version of kernel ``match_verdicts`` (same contract):
    :func:`eval_verdicts` over the layout's bucketed arrays, m_value
    None when the corpus has no workflow gates."""
    planes = eval_verdicts(layout.db, value_bits, uncertain_bits, lengths, status,
                           md5_digest=md5_digest, rx=rx, arrays=layout.arrays)
    return planes if layout.has_gates else (*planes[:4], None, planes[5])


# ---------------------------------------------------------------------------
# DeviceDB


Device = Optional[Union[str, torch.device]]


class DeviceDB:
    """A CompiledDB uploaded once to the device, and the split-phase,
    survivor-compacted match over it.

    :meth:`dispatch` uploads a batch, runs phase A, reads back ONE
    scalar (the batch's largest survivor count within the budget),
    picks phase B's width on the survivor ladder, and launches phase B;
    :meth:`collect` makes the one read of the fused output. Those are
    the only two host syncs of a batch. ``last_compact`` records the
    batch's survivor_max / verify_k / budget and the host seconds at
    each stage boundary."""

    def __init__(self, db: "fpc.CompiledDB", candidate_k: int = 128, device: Device = None):
        self.db = db
        self.candidate_k = candidate_k
        self.device = resolve_device(device)
        self.last_compact: dict = {}
        self._meta = None
        self._arrays = None

    def _ensure_layout(self):
        if self._arrays is None:
            meta, arrays_np = fpc.build_device_layout(self.db)
            arrays = to_device({k: v for k, v in arrays_np.items() if k != "verdict"},
                               self.device)
            arrays["verdict"] = VerdictLayout(self.db, self.device)
            arrays["word_tab"] = to_device(_word_table(), self.device)
            self._meta, self._arrays = meta, arrays
        return self._meta, self._arrays

    def _budget(self) -> int:
        meta, _ = self._ensure_layout()
        return global_candidate_budget(self.candidate_k, len(meta.table_stream))

    def upload(self, streams: dict, lengths: dict, status) -> tuple:
        """Host batch → device tensors, "all" synthesized."""
        dev = self.device
        s = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in streams.items()}
        ln = {
            k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(dev)
            for k, v in lengths.items()
        }
        st = torch.from_numpy(np.ascontiguousarray(status, dtype=np.int32)).to(dev)
        return ensure_all_stream(s, ln), ln, st

    def dispatch(self, streams: dict, lengths: dict, status) -> torch.Tensor:
        """Stage the host batch (numpy), run both phases, and return the
        fused output tensor, still on the device. Each step runs in a
        ``record_function`` span (``match.<step>``) that a profiler
        trace reads."""
        from swarm_tpu_torch.ops.regexdev import regex_verify

        db = self.db
        meta, arrays = self._ensure_layout()
        T = len(meta.table_stream)
        plane_width = max(db.num_slots, 1)
        budget = self._budget()
        t0 = time.perf_counter()
        with record_function("match.upload"):
            s, ln, st = self.upload(streams, lengths, status)
        B = st.shape[0]
        t1 = time.perf_counter()
        lc = {"budget": budget, "upload_s": t1 - t0}
        if T:
            views = table_views(meta, s, ln)
            cs = col_starts_of(meta, s)
            K = max(1, min(budget, int(cs[-1])))
            with record_function("match.phase_a"):
                col, n_surv = kernels.match_phase_a(
                    views, meta.table_q, cs, arrays["tab"]["bloom"], budget, K
                )
                overflow = n_surv > K
                nmax = torch.clamp(n_surv, max=K).max()
            t2 = time.perf_counter()
            # the one host sync between the phases: a 4-byte read that
            # sizes phase B to the live work instead of the budget
            with record_function("match.scalar_read"):
                n_live = int(nmax)
            t3 = time.perf_counter()
            kc = fpc.survivor_bucket(n_live, budget)
            with record_function("match.verify"):
                value, unc = kernels.match_verify(
                    views, meta.table_q, cs, col, kc, arrays["tab"], meta.max_group,
                    arrays["slot_bytes"], arrays["slot_len"], plane_width,
                )
            lc.update(survivor_max=n_live, verify_k=kc, phase_a_s=t2 - t1,
                      scalar_read_s=t3 - t2)
        else:
            value = torch.zeros((B, plane_width), dtype=torch.bool, device=self.device)
            unc = torch.zeros_like(value)
            overflow = torch.zeros((B,), dtype=torch.bool, device=self.device)
            t3 = t1
        with record_function("match.tiny_slots"):
            value = tiny_slot_bits(meta, db.tiny_bytes, db.tiny_slot, s, ln, value)
        digest = None
        if meta.has_md5 and "body" in s:
            with record_function("match.md5"):
                # host lengths: the plain version's block bound, no sync
                max_len = int(np.max(lengths["body"])) if len(lengths["body"]) else 0
                digest = kernels.match_md5(s["body"], ln["body"], max_len=max_len)
        rx = None
        if meta.n_rx:
            with record_function("match.regex"):
                rx = regex_verify(db, s, ln, value, k_pairs=db.rx_k_pairs(B),
                                  arrays=arrays["rx"], word_tab=arrays["word_tab"])
        with record_function("match.verdicts"):
            layout = arrays["verdict"]
            planes = kernels.match_verdicts(layout, value, unc, ln, st, digest, rx)
            out = fuse_planes(full_planes(layout.arrays, planes), overflow)
        lc["phase_b_s"] = time.perf_counter() - t3
        self.last_compact = lc
        return out

    def collect(self, out: torch.Tensor):
        """The one host read of the fused output → :func:`split_fused`."""
        t0 = time.perf_counter()
        with record_function("match.collect"):
            buf = out.cpu().numpy()
        self.last_compact["collect_s"] = time.perf_counter() - t0
        return split_fused(self.db, buf)

    def match(self, streams: dict, lengths: dict, status):
        """→ (t_value, t_unc, op_value, op_unc, m_unc, overflow, wf):
        host numpy views of one fused read (packed MSB-first planes,
        overflow bool [B], wf the four gate planes or None)."""
        return self.collect(self.dispatch(streams, lengths, status))


def _word_table() -> np.ndarray:
    from swarm_tpu_torch.fingerprints.regexlin import _WORD_BYTES

    return np.asarray(_WORD_BYTES, dtype=bool)
