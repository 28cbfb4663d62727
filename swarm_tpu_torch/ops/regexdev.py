"""Device regex verify: exact shift-and over fired rows.

The port of ``swarm_tpu/ops/regexdev.py``. Regex matchers whose
patterns compiled to linear programs (fingerprints/regexlin.py) are
re-checked on the card when their literal prefilter fires: the fired
(row, sequence) pairs are compacted under a fixed budget K, and each
pair runs the bit-parallel shift-and recurrence — up to 96 NFA
positions in uint32 lanes — over its stream's bytes. The result
replaces the prefilter's uncertain-on-fire semantics with an exact
verdict; only pairs beyond the budget stay uncertain (host confirms
them).

The fired gate, the compaction and the scatter back to matchers are
torch ops with no host sync; the scan is kernel ``match_regex_scan``
(``csrc/match.cu``), and :func:`regex_scan_plain` is its plain version.
"""

from __future__ import annotations

import torch

from swarm_tpu_torch.fingerprints import compile as fpc
from swarm_tpu_torch.fingerprints.regexlin import END_DOLLAR, END_NONE, END_Z
from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.ops.encoding import STREAMS
from swarm_tpu_torch.ops.kernels import StreamView

MASK32 = 0xFFFFFFFF


def compact_pairs(
    db: "fpc.CompiledDB", value_bits: torch.Tensor, k_pairs: int, arrays: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fired gate and the pair compaction → (fired_seq bool [B,
    NSEQ], idx int64 [K]): a sequence fires on a row when one of its
    literal slots did (literal-less sequences always fire), and ``idx``
    holds the flat row-major indices of the first K fired pairs, -1
    past them — ``jnp.nonzero(size=K, fill_value=-1)``'s pick, made
    without a host sync."""
    B, NS = value_bits.shape
    dev = value_bits.device
    NSEQ = int(db.rx_seq_matcher.shape[0])
    fired_seq = arrays["seq_always"][None, :].expand(B, NSEQ).clone()
    for rows, idx in arrays["slot_buckets"]:
        idx = idx.to(torch.int64).clamp(0, NS - 1)
        fired_seq[:, rows] |= value_bits[:, idx].any(-1)
    flat = fired_seq.reshape(-1)
    K = int(k_pairs)
    rank = torch.cumsum(flat.to(torch.int64), dim=0)
    # the j-th fired pair goes to idx[j] for j < K; the rest to a spill slot
    target = torch.where(flat & (rank <= K), rank - 1, K)
    idx = torch.full((K + 1,), -1, dtype=torch.int64, device=dev)
    idx.scatter_(0, target, torch.arange(flat.shape[0], dtype=torch.int64, device=dev))
    return fired_seq, idx[:K]


def stream_variants(db: "fpc.CompiledDB", streams: dict, lengths: dict) -> list:
    """The (stream, case) views the sequences scan, in ``rx_variants`` order."""
    return [
        StreamView(streams[STREAMS[s]], lengths[STREAMS[s]], bool(ci))
        for s, ci in fpc.rx_variants(db)
    ]


def regex_verify(
    db: "fpc.CompiledDB",
    streams: dict,
    lengths: dict,
    value_bits: torch.Tensor,
    k_pairs: int,
    arrays: dict,
    word_tab: torch.Tensor,
):
    """→ (rx_value [B, NRXM] bool, rx_unc [B, NRXM] bool).

    ``value_bits`` are the slot bits (the literal prefilters gate which
    pairs run); ``arrays`` the rx half of the device layout
    (``compile.rx_arrays_np`` on the device); ``word_tab`` bool [256]
    marks the ``\\w`` bytes."""
    NRXM = len(db.rx_m_ids)
    B = value_bits.shape[0]
    dev = value_bits.device
    if NRXM == 0:
        z = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        return z, z
    NSEQ = int(db.rx_seq_matcher.shape[0])
    fired_seq, idx = compact_pairs(db, value_bits, k_pairs, arrays)
    valid = idx >= 0
    safe = idx.clamp(min=0)
    pair_b = safe // NSEQ
    pair_s = safe % NSEQ
    matched = kernels.match_regex_scan(
        stream_variants(db, streams, lengths), pair_b, pair_s, valid, arrays,
        word_tab, int(db.rx_max_skip_run),
    )

    # --- scatter back to matcher granularity (repeats OR together) ---
    seq_matcher = arrays["seq_matcher"].to(torch.int64)
    hit = torch.zeros(B * NRXM, dtype=torch.int32, device=dev)
    hit.index_add_(0, pair_b * NRXM + seq_matcher[pair_s], matched.to(torch.int32))
    rx_value = (hit > 0).view(B, NRXM)
    # pairs that did not fit the budget leave their matcher uncertain
    included = torch.zeros(B * NSEQ, dtype=torch.int32, device=dev)
    included.index_add_(0, safe, valid.to(torch.int32))
    missing = fired_seq & ~(included > 0).view(B, NSEQ)
    unc = torch.zeros((B, NRXM), dtype=torch.int32, device=dev)
    unc.index_add_(1, seq_matcher, missing.to(torch.int32))
    return rx_value, unc > 0


def _lane_shift(d: torch.Tensor) -> torch.Tensor:
    """Left shift by 1 across the uint32 lanes [K, L] (lane 0 lowest)."""
    carry = torch.nn.functional.pad(d[:, :-1] >> 31, (1, 0))
    return ((d << 1) & MASK32) | carry


def regex_scan_plain(
    variants: list, pair_b: torch.Tensor, pair_s: torch.Tensor,
    valid: torch.Tensor, rx: dict, word_tab: torch.Tensor, r_closure: int,
) -> torch.Tensor:
    """Plain version of kernel ``match_regex_scan``: the JAX scan step
    for step, over all K pairs at once, up to the longest pair."""
    dev = pair_b.device
    K = pair_b.shape[0]
    if K == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    w_max = max(int(v.data.shape[1]) for v in variants)
    bufs = []
    for v in variants:
        arr = v.data
        if v.lowered:
            arr = torch.where((arr >= 65) & (arr <= 90), arr + 32, arr)
        bufs.append(torch.nn.functional.pad(arr, (0, w_max - arr.shape[1])))
    stacked = torch.stack(bufs, dim=1)  # [B, V, w_max]
    len_stack = torch.stack([v.lengths for v in variants], dim=1).to(torch.int64)

    pair_var = rx["var_of_seq"].to(torch.int64)[pair_s]
    pair_bytes = stacked[pair_b, pair_var].to(torch.int64)  # [K, w_max]
    pair_len = len_stack[pair_b, pair_var]  # [K]

    bytemap = rx["bytemap"].to(torch.int64) & MASK32  # [NSEQ, 256, L]
    L = bytemap.shape[2]
    map_flat = bytemap.reshape(-1, L)

    def lanes(key):
        return (rx[key].to(torch.int64) & MASK32)[pair_s]

    seed, skip, accept, sloop = lanes("seed"), lanes("skip"), lanes("accept"), lanes("self")
    anchored = rx["anchored"][pair_s]
    end_mode = rx["end_mode"][pair_s]
    start_wb = rx["start_wb"][pair_s]
    end_wb = rx["end_wb"][pair_s]

    last = torch.gather(pair_bytes, 1, (pair_len - 1).clamp(min=0)[:, None])[:, 0]
    trail_nl = (last == 0x0A) & (pair_len > 0)

    d = torch.zeros((K, L), dtype=torch.int64, device=dev)
    false = torch.zeros((K,), dtype=torch.bool, device=dev)
    matched, prev_word, pending, pend_word = false, false, false, false
    steps = int(pair_len.max()) if K else 0
    for pos in range(steps):
        c = pair_bytes[:, pos]
        live = pos < pair_len
        w_c = word_tab[c] & live
        # a trailing-\b accept of the previous byte resolves now
        matched = matched | (pending & live & (pend_word ^ w_c))
        pending = pending & ~live
        bc = torch.where(live[:, None], map_flat[pair_s * 256 + c], 0)
        s_ok = (~anchored | (pos == 0)) & (~start_wb | (w_c ^ prev_word))
        s = torch.where(s_ok[:, None], seed, 0)
        d = ((_lane_shift(d) | s) & bc) | (d & sloop & bc)
        for _ in range(r_closure):
            d = d | (_lane_shift(d) & skip)
        acc = ((d & accept) != 0).any(dim=1)
        end_ok = (
            (end_mode == END_NONE)
            | ((end_mode == END_Z) & (pos == pair_len - 1))
            | ((end_mode == END_DOLLAR)
               & ((pos == pair_len - 1) | (trail_nl & (pos == pair_len - 2))))
        )
        matched = matched | (acc & end_ok & ~end_wb)
        pending = pending | (acc & end_wb)
        pend_word = torch.where(acc & end_wb, w_c, pend_word)
        prev_word = w_c
    # the end of the stream is a boundary exactly after a word byte
    return (matched | (pending & pend_word)) & valid
