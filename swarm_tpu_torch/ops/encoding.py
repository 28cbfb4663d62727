"""Response rows → fixed-shape uint8 batches.

The port's copy of ``swarm_tpu/ops/encoding.py``. Rows are measured and
packed by two native passes (``native/scanio.py``'s ``rows_meta`` and
``rows_pack``, libfastpack), and the output is byte-equal to the JAX
package's ``encode_batch`` on the same rows.

The strategy: pad each part stream (body / header / all) to a
per-batch width, bucket widths to bound padding waste, and flag rows
whose parts were truncated — those rows are re-checked on the host so
truncation can never cost a match (parity invariant).

Part canonicalization: matcher ``part`` names map onto the physical
streams — body/header/all plus the out-of-band interaction streams
(``interactsh_protocol`` → oobp, ``interactsh_request`` → oobr, filled
from Response.oob_*). Unknown parts map to None and their matchers
evaluate constant-False on both engines, which keeps device and oracle
agreeing exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from swarm_tpu_torch.fingerprints.model import Response

# Physical streams materialized per batch. Order is load-bearing:
# compiled DBs store indices into this tuple (tiny_stream /
# rx_seq_stream / size_stream) — append only, never reorder.
STREAMS = ("body", "header", "all", "oobp", "oobr")

# matcher part name -> physical stream. Must agree with
# model.Response.part(): every alias here returns exactly that stream's
# bytes from the oracle. Parts absent here return b"" from the oracle,
# so their matchers lower to compile-time constants. 'host' is
# oracle-only (real bytes, no stream): matchers on it are not
# device-loweable and force host-always.
PART_TO_STREAM = {
    "body": "body",
    "data": "body",
    "body_1": "body",
    "body_2": "body",
    "header": "header",
    "all_headers": "header",
    "all": "all",
    "raw": "all",
    "response": "all",
    "interactsh_protocol": "oobp",
    "interactsh_request": "oobr",
}

HOST_ONLY_PARTS = frozenset({"host"})


def stream_for_part(part: str) -> Optional[str]:
    return PART_TO_STREAM.get(part)


def lower_bytes_np(a: np.ndarray) -> np.ndarray:
    """ASCII-lowercase a uint8 array (matches bytes.lower() for ASCII)."""
    is_upper = (a >= 65) & (a <= 90)
    return np.where(is_upper, a + 32, a)


@dataclasses.dataclass
class ResponseBatch:
    """Fixed-shape encoding of B response rows.

    streams: dict stream -> uint8 [B, W_stream]
    lengths: dict stream -> int32 [B] — post-truncation byte length (the
             length of what's actually in the stream array)
    status:  int32 [B]
    truncated: bool [B] — any stream lost bytes to the width cap; these
             rows are host-re-evaluated wholesale, which is what keeps
             size/len semantics exact for them.
    """

    streams: dict
    lengths: dict
    status: np.ndarray
    truncated: np.ndarray
    rows: list  # original Response objects (host fallback + reporting)
    #: the position of the i-th real row in the batch, when a mesh's
    #: placement spread the real rows over its data ranks' blocks; None
    #: when they lead the batch (the single-device layout)
    row_index: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return int(self.status.shape[0])


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class _RotatingPool:
    """Recycled encode buffers for the engine's pipelined feed.

    Zero-allocating a fresh (B, W) matrix per batch was ~40% of the
    encode cost (page faults on first touch); the native pack writes
    every byte of every row (payload + zero tail), so dirty buffers are
    safe to hand back. The rotation depth outlives the pipeline
    window with margin: the scheduler's accounting holds at most
    queue_depth (2) + in-flight device batches (3) + the offloaded
    walk (1) + the encode in progress (1) = 7 encoded batches alive at
    once (sched/scheduler.py), so the earliest reuse at i+depth (8)
    can never alias an in-flight transfer. That accounting is PER
    ENGINE: the pool is module-global, and the margin only covers one
    engine's pipeline at a time — the worker satisfies this by running
    one scheduler pass to completion per chunk (an engine's batches
    drain before another engine dispatches); concurrent same-shape
    pipelining from two engines is outside the reuse contract.

    ONLY the engine's hot path opts in (``encode_batch(...,
    reuse_buffers=True)``): a recycled batch's arrays are OVERWRITTEN
    ``depth`` same-shape encodes later, so callers that retain batches
    must use the default allocating path.
    """

    #: retained-bytes ceiling: production batch shapes vary (last
    #: partial chunk, alive-subset recursion, active-scan waves), so
    #: unbounded per-key caching would grow worker RSS forever. LRU
    #: keys are dropped past the cap — dropping only releases the
    #: POOL's references; in-flight batches keep their arrays alive
    #: through their own refs.
    MAX_BYTES = 256 * 1024 * 1024

    def __init__(self, depth: int = 8):
        self._depth = depth
        # key -> [bufs, next_idx]; dict order = LRU
        self._slots: dict = {}  # guarded-by: _lock (reads)
        self._bytes = 0  # guarded-by: _lock (reads)
        import threading

        self._lock = threading.Lock()

    def get(self, n: int, w: int, role: str) -> np.ndarray:
        # keyed per stream ROLE: one encode draws several same-width
        # buffers (wb == wh == wa is common at small widths), and a
        # shared rotation would hand batch i+1 a buffer batch i is
        # still feeding to the device
        key = (n, w, role)
        with self._lock:
            slot = self._slots.pop(key, None)
            if slot is None:
                slot = [
                    [np.empty((n, w), dtype=np.uint8) for _ in range(self._depth)],
                    0,
                ]
                self._bytes += n * w * self._depth
            self._slots[key] = slot  # re-insert: most-recently-used last
            while self._bytes > self.MAX_BYTES and len(self._slots) > 1:
                old_key, old_slot = next(iter(self._slots.items()))
                if old_key == key:
                    break  # never evict the slot we are handing out
                del self._slots[old_key]
                self._bytes -= (
                    old_key[0] * old_key[1] * len(old_slot[0])
                )
            bufs, i = slot
            slot[1] = (i + 1) % self._depth
            return bufs[i]


_POOL = _RotatingPool()


def _width_for(lens: np.ndarray, cap: int, multiple: int = 128) -> int:
    longest = int(lens.max()) if lens.size else 0
    return max(multiple, min(cap, round_up(max(longest, 1), multiple)))


def encode_batch(
    rows: Sequence[Response],
    max_body: int = 4096,
    max_header: int = 1024,
    pad_rows_to: Optional[int] = None,
    reuse_buffers: bool = False,
    build_all: bool = True,
    width_multiple: int = 128,
) -> ResponseBatch:
    """Encode responses into the padded streams.

    ``pad_rows_to`` pads the batch dimension (with empty rows) so the
    match path sees a small set of batch shapes.

    TWO C passes straight over the Response objects — one metadata pass
    (lengths/status/concat/OOB flags), one packing pass that writes
    every byte of every row (payload + zero tail), so the matrices may
    come from the recycled buffer pool instead of a fresh zero-fill
    (``reuse_buffers``; see _RotatingPool for the aliasing contract —
    engine hot path only).

    Part semantics MUST stay in lockstep with model.Response.part():
    "body" is the banner when one is set; "all" is header + CRLF + body
    except for banner rows (aliases the banner) and headerless rows
    (body alone).

    ``build_all=False`` skips materializing the "all" stream — a
    width-1 placeholder goes in its place and the device synthesizes
    the concatenation from the body/header streams plus
    ``lengths["all_hdr"]`` (ops/match.py ``ensure_all_stream``).
    """
    rows = list(rows)
    n_real = len(rows)
    if pad_rows_to is not None and pad_rows_to > n_real:
        rows = rows + [Response()] * (pad_rows_to - n_real)
    n = len(rows)

    from swarm_tpu_torch.native import scanio as _nat

    blens = np.empty(n, dtype=np.int64)
    hlens = np.empty(n, dtype=np.int64)
    status = np.empty(n, dtype=np.int32)
    concat = np.empty(n, dtype=np.uint8)
    bptr = np.empty(n, dtype=np.uintp)
    hptr = np.empty(n, dtype=np.uintp)
    has_oob = _nat.rows_meta(rows, blens, hlens, status, concat, bptr, hptr)
    alens = np.where(concat.astype(bool), hlens + 2 + blens, blens)
    wb = _width_for(blens, max_body, width_multiple)
    wh = _width_for(hlens, max_header, width_multiple)
    wa = (
        _width_for(alens, max_body + max_header, width_multiple)
        if build_all
        else 1
    )
    if reuse_buffers:
        body_arr = _POOL.get(n, wb, "body")
        header_arr = _POOL.get(n, wh, "header")
        all_arr = _POOL.get(n, wa, "all") if build_all else None
    else:
        body_arr = np.empty((n, wb), dtype=np.uint8)
        header_arr = np.empty((n, wh), dtype=np.uint8)
        all_arr = np.empty((n, wa), dtype=np.uint8) if build_all else None
    if all_arr is None:
        all_arr = np.zeros((n, 1), dtype=np.uint8)
    _nat.rows_pack(
        n, bptr, blens, hptr, hlens, concat, wb, body_arr,
        wh, header_arr, wa if build_all else 0, all_arr,
    )

    # OOB streams: bulk scans never carry interactions, so the common
    # case is two width-1 zero placeholders
    if not has_oob:
        wp = wr = 1
        plens = rlens = np.zeros((n,), dtype=np.int64)
        oobp_arr = np.zeros((n, 1), dtype=np.uint8)
        oobr_arr = np.zeros((n, 1), dtype=np.uint8)
    else:
        oobps = [
            " ".join(r.oob_protocols).encode() if r.oob_protocols else b""
            for r in rows
        ]
        oobrs = [r.oob_requests for r in rows]
        plens = np.fromiter((len(p) for p in oobps), dtype=np.int64, count=n)
        rlens = np.fromiter((len(q) for q in oobrs), dtype=np.int64, count=n)
        wp = _width_for(plens, 128)
        wr = _width_for(rlens, max_body)
        oobp_arr = np.zeros((n, wp), dtype=np.uint8)
        oobr_arr = np.zeros((n, wr), dtype=np.uint8)
        _nat.pack_list(oobps, wp, oobp_arr, lens=plens)
        _nat.pack_list(oobrs, wr, oobr_arr, lens=rlens)

    streams = {
        "body": body_arr,
        "header": header_arr,
        "all": all_arr,
        "oobp": oobp_arr,
        "oobr": oobr_arr,
    }
    minb = np.minimum(blens, wb)
    minh = np.minimum(hlens, wh)
    cat = concat.astype(bool)
    if build_all:
        all_len = np.minimum(alens, wa)
    else:
        # synthesized layout: clipped header (+CRLF) + clipped body —
        # the device rebuilds exactly these bytes
        all_len = np.where(cat, minh + 2 + minb, minb)
    lengths = {
        "body": minb.astype(np.int32),
        "header": minh.astype(np.int32),
        "all": all_len.astype(np.int32),
        # header-prefix length of the synthesized "all" (0 = body-only:
        # banner rows and headerless rows) — ops/match.ensure_all_stream
        "all_hdr": np.where(cat, minh, 0).astype(np.int32),
        "oobp": np.minimum(plens, wp).astype(np.int32),
        "oobr": np.minimum(rlens, wr).astype(np.int32),
    }
    trunc_any = (
        (blens > wb) | (hlens > wh)
        | ((alens > wa) if build_all else False)
        | (plens > wp) | (rlens > wr)
    )
    return ResponseBatch(
        streams=streams,
        lengths=lengths,
        status=status,
        truncated=trunc_any,
        rows=rows[:n_real],
    )
