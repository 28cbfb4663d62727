"""Response rows → fixed-shape uint8 batches.

The port's copy of ``swarm_tpu/ops/encoding.py``, numpy path only: the
port has no native encoder yet, and its output is byte-equal to the
JAX package's ``encode_batch`` on the same rows.

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

    @property
    def batch_size(self) -> int:
        return int(self.status.shape[0])


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _width_for(lens: np.ndarray, cap: int, multiple: int = 128) -> int:
    longest = int(lens.max()) if lens.size else 0
    return max(multiple, min(cap, round_up(max(longest, 1), multiple)))


def _pack(blobs: list, width: int) -> np.ndarray:
    out = np.zeros((len(blobs), width), dtype=np.uint8)
    for i, blob in enumerate(blobs):
        if blob:
            c = blob[:width]
            out[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
    return out


def encode_batch(
    rows: Sequence[Response],
    max_body: int = 4096,
    max_header: int = 1024,
    pad_rows_to: Optional[int] = None,
    build_all: bool = True,
    width_multiple: int = 128,
) -> ResponseBatch:
    """Encode responses into the padded streams.

    ``pad_rows_to`` pads the batch dimension (with empty rows) so the
    match path sees a small set of batch shapes.

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

    bodies = [r.body if r.banner is None else r.banner for r in rows]
    headers = [r.header for r in rows]
    blens = np.fromiter((len(b) for b in bodies), dtype=np.int64, count=n)
    hlens = np.fromiter((len(h) for h in headers), dtype=np.int64, count=n)
    status = np.fromiter((r.status for r in rows), dtype=np.int32, count=n)
    concat = (
        np.fromiter((r.banner is None for r in rows), dtype=np.bool_, count=n)
        & (hlens > 0)
    ).astype(np.uint8)
    alens = np.where(concat.astype(bool), hlens + 2 + blens, blens)
    wb = _width_for(blens, max_body, width_multiple)
    wh = _width_for(hlens, max_header, width_multiple)
    wa = (
        _width_for(alens, max_body + max_header, width_multiple)
        if build_all
        else 1
    )
    body_arr = _pack(bodies, wb)
    header_arr = _pack(headers, wh)
    if build_all:
        all_arr = _pack(
            [headers[i] + b"\r\n" + bodies[i] if concat[i] else bodies[i]
             for i in range(n)],
            wa,
        )
    else:
        all_arr = np.zeros((n, 1), dtype=np.uint8)

    # OOB streams: bulk scans never carry interactions, so the common
    # case is two width-1 zero placeholders
    if not any(r.oob_protocols or r.oob_requests for r in rows):
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
        oobp_arr = _pack(oobps, wp)
        oobr_arr = _pack(oobrs, wr)

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
