"""Fingerprint clustering: density peaks over bit-packed Hamming distances.

The port of ``swarm_tpu/ops/cluster.py`` (BASELINE.json config #5 —
"Internet-wide TLS JA3/JARM hash + fingerprint clustering"). For N
fingerprints of 512 bits it needs the pairwise Hamming structure, whose
N×N matrix (17 GB of f32 at N = 64k) must never be stored. Two reductions
and a host label pass give density-peaks clustering (Rodriguez & Laio):

* ``rho[i]``: the number of rows within ``radius`` of row i, i included
  (:func:`neighbor_counts`);
* ``delta[i]``/``parent[i]``: distance and index of the nearest strictly
  denser row, ties in rho broken toward the lower index
  (:func:`nearest_denser`);
* rows whose nearest denser row lies beyond ``radius`` seed clusters; all
  others join their parent's (:func:`density_cluster`).

On the card the two reductions are the hand-written kernels of
``csrc/cluster.cu`` (launched through ``ops/kernels.py``). The parent
search runs on the rows sorted densest first
(:func:`nearest_denser_in_order`, shared by the kernel's path and the
CPU's), where "denser" is "earlier" and only a triangle of pairs is
walked; :func:`parent_in_order_plain` is that kernel's plain tile
computation. The plain PyTorch versions of the whole functions,
:func:`neighbor_counts_plain` and :func:`nearest_denser_plain`, compute
them in row tiles of ``256 × N``; on the card they are the reference the
kernels are held to. Every value is an integer or an integer-valued f32,
so all of them agree exactly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from swarm_tpu_torch.ops import kernels
from swarm_tpu_torch.utils.device import resolve_device

# One fingerprint row = FP_BITS bits = FP_WORDS 32-bit words.
FP_BITS = 512
FP_WORDS = FP_BITS // 32

NO_PARENT_DELTA = 3.0e38
_PLAIN_TILE = 256  # rows a tile of the plain versions: 256 × N, never N × N

Device = Optional[Union[str, torch.device]]


# ---------------------------------------------------------------------------
# Host-side packing (numpy; the port's own copy)


def pack_strings(strings: list[bytes | str], n_bits: int = FP_BITS) -> np.ndarray:
    """Fingerprint strings → uint32 [N, n_bits/32] bit rows.

    Each byte contributes its 8 bits, truncated/zero-padded to
    ``n_bits``; two strings differing in one character differ in 1–8
    bits, so Hamming radius in bit units bounds character edits.
    """
    n = len(strings)
    words = n_bits // 32
    out = np.zeros((n, words), dtype=np.uint32)
    for i, s in enumerate(strings):
        raw = s.encode() if isinstance(s, str) else bytes(s)
        raw = raw[: n_bits // 8]
        arr = np.frombuffer(raw, dtype=np.uint8)
        bits = np.unpackbits(arr, bitorder="little")
        pad = np.zeros(n_bits, dtype=np.uint8)
        pad[: bits.shape[0]] = bits
        out[i] = np.packbits(pad, bitorder="little").view(np.uint32)
    return out


def pairwise_hamming(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """Small-N explicit distance matrix (diagnostics / tests only)."""
    a = np.unpackbits(packed_a.view(np.uint8), axis=1, bitorder="little")
    b = np.unpackbits(packed_b.view(np.uint8), axis=1, bitorder="little")
    return (
        a.sum(1)[:, None] + b.sum(1)[None, :] - 2 * (a.astype(np.int32) @ b.T)
    ).astype(np.int32)


def carry_packed(packed: np.ndarray, device: Device = None) -> torch.Tensor:
    """The JAX package's uint32 [N, 16] rows → the port's int32 [N, 16]
    tensor on ``device`` (the same bits, reinterpreted; a copy)."""
    arr = np.ascontiguousarray(packed)
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed must be uint32, got {arr.dtype}")
    if arr.ndim != 2 or arr.shape[1] != FP_WORDS:
        raise ValueError(f"packed must be [N, {FP_WORDS}], got {arr.shape}")
    return torch.tensor(arr.view(np.int32), device=resolve_device(device))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, and the kernels' reference on the card)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] → 0/1 float32 [N, W*32], bit s of word w at w*32+s.
    An arithmetic shift of word bit 31 still leaves the right bit after
    ``& 1`` (uint32 shifts are not available on the CPU)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(packed.shape[0], packed.shape[1] * 32).to(torch.float32)


def _distance_tiles(packed: torch.Tensor, triangle: bool = False):
    """Yield (start, stop, dist) over row tiles: dist = pop_i + pop_j −
    2·(a_i·a_j) as float32 [tile, N] (``triangle``: [tile, stop], the
    columns up to the tile's last row), exact for 0/1 rows of 512 bits."""
    bits = unpack_bits(packed)
    pop = bits.sum(dim=1)
    n = bits.shape[0]
    # full-precision f32 products: TF32 would round the dot products; the
    # caller's setting is restored when the walk ends
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, n, _PLAIN_TILE):
            e = min(s + _PLAIN_TILE, n)
            cols = e if triangle else n
            dist = pop[s:e, None] + pop[None, :cols] - 2.0 * (bits[s:e] @ bits[:cols].T)
            yield s, e, dist
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def neighbor_counts_plain(packed: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain version of the ``cluster_counts`` kernel → int32 [N]."""
    rho = torch.empty(packed.shape[0], dtype=torch.int32, device=packed.device)
    r = torch.tensor(radius, dtype=torch.float32, device=packed.device)
    for s, e, dist in _distance_tiles(packed):
        rho[s:e] = (dist <= r).sum(dim=1).to(torch.int32)
    return rho


def nearest_denser_plain(
    packed: torch.Tensor, rho: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``cluster_parent`` kernel → (delta f32 [N],
    parent int32 [N]); masks as the JAX package's XLA twin does."""
    n = packed.shape[0]
    dev = packed.device
    delta = torch.empty(n, dtype=torch.float32, device=dev)
    parent = torch.empty(n, dtype=torch.int32, device=dev)
    col = torch.arange(n, device=dev)
    big = torch.tensor(NO_PARENT_DELTA, dtype=torch.float32, device=dev)
    for s, e, dist in _distance_tiles(packed):
        row = col[s:e, None]
        rho_a = rho[s:e, None]
        denser = (rho[None, :] > rho_a) | (
            (rho[None, :] == rho_a) & (col[None, :] < row)
        )
        ok = denser & (col[None, :] != row)
        masked = torch.where(ok, dist, big)
        dmin = masked.min(dim=1).values
        # the lowest index at the minimum, as the kernel's ascending walk
        first = torch.where(masked == dmin[:, None], col[None, :], n).min(dim=1).values
        delta[s:e] = dmin
        parent[s:e] = torch.where(dmin < big, first, -1).to(torch.int32)
    return delta, parent


# ---------------------------------------------------------------------------
# The parent search in density order (the kernel's path and the CPU's)

#: the 32-bit parent key (d << 21) | j holds the original index j for up
#: to this many rows (d <= 512 takes the other 11 bits); above it the key
#: is (d << 32) | j in 64 bits, in the kernel as here
KEY32_MAX_ROWS = 1 << 21


def parent_key_shift(n: int) -> int:
    """Bits below the distance in the parent key for ``n`` rows."""
    return 21 if n <= KEY32_MAX_ROWS else 32


def parent_in_order_plain(
    rows: torch.Tensor, order: torch.Tensor, key_shift: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``cluster_parent`` kernel: ``rows`` in density
    order, ``order`` their original indices → (delta f32, parent int32)
    in that order. Row p's candidates are the rows before it; each
    pair's key is (d << shift) | j with j the original index, and the
    least key wins: the smallest distance, then the lowest index."""
    n = rows.shape[0]
    shift = parent_key_shift(n) if key_shift is None else key_shift
    none = (1 << (shift + 11)) - 1  # all ones: the 32-bit kernel's ~0u
    delta = torch.empty(n, dtype=torch.float32, device=rows.device)
    parent = torch.empty(n, dtype=torch.int32, device=rows.device)
    j = order.to(torch.int64)
    pos = torch.arange(n, device=rows.device)
    for s, e, dist in _distance_tiles(rows, triangle=True):
        key = (dist.to(torch.int64) << shift) | j[None, :e]
        best = torch.where(pos[None, :e] < pos[s:e, None], key, none).min(dim=1).values
        found = best != none
        delta[s:e] = torch.where(found, (best >> shift).to(torch.float32), NO_PARENT_DELTA)
        parent[s:e] = torch.where(found, best & ((1 << shift) - 1), -1).to(torch.int32)
    return delta, parent


def nearest_denser_in_order(
    packed: torch.Tensor, rho: torch.Tensor, in_order=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(delta f32 [N], parent int32 [N]): distance and index of each
    row's nearest strictly denser row (ties in rho go to the lower
    index); 3.0e38 and -1 where there is none. Sorts the rows densest
    first (rho descending, index ascending: then "j is denser than i" is
    "j comes first"), gathers them, searches them with ``in_order(rows,
    order)`` (default: the ``cluster_parent`` kernel's wrapper
    :func:`kernels.parent_in_order`) and scatters the results back to
    the original rows."""
    n = packed.shape[0]
    if rho.dtype != torch.int32 or rho.shape != (n,) or not rho.is_contiguous():
        raise ValueError("rho must be a contiguous int32 [N]")
    if rho.device != packed.device:
        raise ValueError("rho and packed must be on the same device")
    in_order = kernels.parent_in_order if in_order is None else in_order
    with record_function("density_order"):
        order = torch.argsort(-rho, stable=True)
        rows = packed.index_select(0, order)
    delta_o, parent_o = in_order(rows, order.to(torch.int32))
    with record_function("unpermute"):
        delta = torch.empty_like(delta_o)
        parent = torch.empty_like(parent_o)
        delta[order] = delta_o
        parent[order] = parent_o
    return delta, parent


# ---------------------------------------------------------------------------
# Public API (numpy in, numpy out, as the JAX package's)


def neighbor_counts(
    packed: np.ndarray, radius: float, device: Device = None
) -> np.ndarray:
    """rho[i] = #{j : hamming(i, j) ≤ radius} (includes i itself)."""
    x = carry_packed(packed, device)
    return kernels.cluster_counts(x, radius).cpu().numpy()


def nearest_denser(
    packed: np.ndarray, rho: np.ndarray, device: Device = None
) -> tuple[np.ndarray, np.ndarray]:
    """(delta, parent): distance/index of nearest strictly-denser row.

    ``rho`` is the neighbor count of :func:`neighbor_counts`. The unique
    global density maximum gets parent −1 and delta 3.0e38.
    """
    x = carry_packed(packed, device)
    rho_t = torch.tensor(np.asarray(rho, dtype=np.int32), device=x.device)
    delta, parent = nearest_denser_in_order(x, rho_t)
    return delta.cpu().numpy(), parent.cpu().numpy()


def density_cluster(
    packed: np.ndarray, radius: float, device: Device = None
) -> tuple[np.ndarray, np.ndarray]:
    """Full density-peaks clustering → (labels [N] int32, rho [N] int32).

    Rows whose nearest-denser neighbor is farther than ``radius`` seed
    clusters; every other row joins its parent's cluster. Two kernel
    launches (O(N²) compute, O(N) memory) + one O(N) host pass.
    """
    with record_function("carry_packed"):
        x = carry_packed(packed, device)
    n = x.shape[0]
    rho_t = kernels.cluster_counts(x, radius)
    delta_t, parent_t = nearest_denser_in_order(x, rho_t)
    with record_function("read_back"):
        rho = rho_t.cpu().numpy()
        delta = delta_t.cpu().numpy()
        parent = parent_t.cpu().numpy()
    with record_function("label_pass"):
        # Peaks seed clusters numbered in densest-first stable order;
        # everyone else resolves to its chain's first peak by pointer
        # jumping — parents are strictly (denser | equal-rho-lower-index),
        # so chains are acyclic and terminate at a peak in <= log2(n) hops.
        peaks = (parent < 0) | (delta > radius)
        order = np.argsort(-rho, kind="stable")  # densest first
        peak_ids = order[peaks[order]]
        label_of = np.full(n, -1, dtype=np.int32)
        label_of[peak_ids] = np.arange(len(peak_ids), dtype=np.int32)
        anchor = np.where(peaks, np.arange(n), parent)
        while True:
            nxt = anchor[anchor]
            if np.array_equal(nxt, anchor):
                break
            anchor = nxt
        labels = label_of[anchor]
    if (labels < 0).any():
        raise RuntimeError("density_cluster: a parent chain did not end at a peak")
    return labels, rho
