"""Rolling q-gram hashes shared by the compiler (numpy) and the match path (torch).

The port's copy of the numpy half of ``swarm_tpu/ops/hashing.py`` (the
compiler's side, byte-for-byte the same), plus :func:`window_hashes`,
the torch twin of the JAX package's ``window_hashes_jnp`` that the plain
versions of the match kernels use.

Both sides MUST compute identical values, so the polynomial and bases
live here: H(b, i) = Σ_{j<q} b[i+j]·r^j (mod 2^32), two independent
bases per gram size (h1 indexes the table, h2 kills collisions before
the exact byte verify). PyTorch for the CPU has no uint32 arithmetic,
so the torch side carries each hash as int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

# Odd multipliers (invertible mod 2^32), chosen independently per role.
BASE1 = np.uint32(0x01000193)  # FNV-ish
BASE2 = np.uint32(0x85EBCA77)
GRAM_LONG = 8  # words >= 8 bytes hash an 8-gram
GRAM_SHORT = 4  # words 4..7 bytes hash a 4-gram
TINY_MAX = GRAM_SHORT - 1  # words 1..3 bytes take the dense-compare path

BLOOM_BITS = 1 << 18  # 32 KiB bitmap per table: ~0.3% window FP at 7.5k words
BLOOM_WORDS = BLOOM_BITS // 32

MASK32 = 0xFFFFFFFF


def _powers(base: np.uint32, q: int) -> np.ndarray:
    out = np.ones(q, dtype=np.uint64)
    for j in range(1, q):
        out[j] = (out[j - 1] * np.uint64(base)) & np.uint64(0xFFFFFFFF)
    return out


def gram_hash_np(data: bytes | np.ndarray, q: int) -> tuple[int, int]:
    """Hash the first q bytes of ``data`` (compile-time side)."""
    arr = np.frombuffer(bytes(data[:q]), dtype=np.uint8).astype(np.uint64)
    assert arr.shape[0] == q, "gram shorter than q"
    p1, p2 = _powers(BASE1, q), _powers(BASE2, q)
    h1 = int((arr * p1).sum() & np.uint64(0xFFFFFFFF))
    h2 = int((arr * p2).sum() & np.uint64(0xFFFFFFFF))
    return h1, h2


def bloom_indices_np(h1: np.ndarray, h2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mask = BLOOM_BITS - 1
    return (h1 & mask).astype(np.int64), (h2 & mask).astype(np.int64)


def build_bloom_np(h1s: np.ndarray, h2s: np.ndarray) -> np.ndarray:
    """Pack table-side bloom bitmap: uint32 [BLOOM_WORDS]."""
    bitmap = np.zeros(BLOOM_WORDS, dtype=np.uint32)
    i1, i2 = bloom_indices_np(np.asarray(h1s, np.uint32), np.asarray(h2s, np.uint32))
    for idx in np.concatenate([i1, i2]):
        bitmap[idx >> 5] |= np.uint32(1) << np.uint32(idx & 31)
    return bitmap


def window_hashes(stream: torch.Tensor, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, W] → (h1, h2), each int64 [B, W] holding a uint32.

    Position i holds the hash of bytes[i:i+q]; windows running past W
    hash the zero padding (the JAX package's ``window_hashes_jnp``).
    """
    b = stream.to(torch.int64)
    B, W = b.shape
    padded = torch.nn.functional.pad(b, (0, q))
    p1 = _powers(BASE1, q)
    p2 = _powers(BASE2, q)
    h1 = torch.zeros((B, W), dtype=torch.int64, device=stream.device)
    h2 = torch.zeros((B, W), dtype=torch.int64, device=stream.device)
    for j in range(q):  # q shifted multiply-adds; < 2^43 before the mask
        window = padded[:, j : j + W]
        h1 += window * int(p1[j])
        h2 += window * int(p2[j])
    return h1 & MASK32, h2 & MASK32
