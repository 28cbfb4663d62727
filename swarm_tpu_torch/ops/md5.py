"""MD5 on the card: batched digests over padded byte streams.

The port of ``swarm_tpu/ops/md5.py``. The corpus uses ``md5(body) ==
"<hex>"`` dsl matchers; their digest check runs on the card so a fired
row needs no host confirmation. MD5's block chain is sequential, but
across the batch it vectorizes: a loop over 64-byte blocks, 64 rounds
of 32-bit ops per block, every lane a row.

PyTorch for the CPU has no uint32 arithmetic, so each 32-bit word is
carried as int64 masked with ``0xFFFFFFFF``. These plain torch ops are
the plain version of kernel ``match_md5`` (``csrc/md5.cu``, one thread
a row), which ``DeviceDB`` launches on the card through
``kernels.match_md5``; the CPU tests and ``chip_smoke.py`` hold the two
together.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MASK32 = 0xFFFFFFFF

# RFC 1321 tables
_K = [int(abs(math.sin(i + 1)) * (1 << 32)) & MASK32 for i in range(64)]
_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4
_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    return ((x << s) | (x >> (32 - s))) & MASK32


def md5_words(
    stream: torch.Tensor, lengths: torch.Tensor, max_len: Optional[int] = None
) -> torch.Tensor:
    """uint8 [B, W] (zero past each row's length, W a multiple of 64) +
    int32 [B] → digest as int64 [B, 4] holding uint32 little-endian
    words (word 0's LE bytes are the first 8 hex chars of the usual
    digest string), as the JAX ``md5_words`` returns them.

    ``max_len`` (a host int, at least every row's length) bounds the
    blocks walked: blocks past every row's padded message change no
    row, so the result is the same with or without it.
    """
    B, W = stream.shape
    dev = stream.device
    # room for the 0x80 marker + 8 length bytes past a full-width row
    ext = torch.nn.functional.pad(stream.to(torch.int64), (0, 64))
    Wp = W + 64
    idx = torch.arange(Wp, dtype=torch.int64, device=dev)[None, :]
    L = lengths.to(torch.int64)[:, None]
    msg = torch.where(idx < L, ext, 0)
    msg = torch.where(idx == L, 0x80, msg)
    # message bit length, little-endian, in the final 8 bytes of the
    # last block (bit counts fit 32 bits: the upper four bytes stay zero)
    pad_end = ((L + 9 + 63) // 64) * 64
    bitlen = (L * 8) & MASK32
    off = idx - (pad_end - 8)
    len_byte = (bitlen >> (8 * off.clamp(0, 3))) & 0xFF
    msg = torch.where((off >= 0) & (off < 4), len_byte, msg)

    nb = Wp // 64
    blocks = msg.reshape(B, nb, 16, 4)
    words = (
        blocks[..., 0]
        | (blocks[..., 1] << 8)
        | (blocks[..., 2] << 16)
        | (blocks[..., 3] << 24)
    )  # [B, nb, 16]
    n_blocks = pad_end[:, 0] // 64  # [B]
    if max_len is not None:
        nb = min(nb, (int(max_len) + 9 + 63) // 64)

    # filled on the device: copying a host tensor would sync phase B
    state = torch.stack([torch.full((B,), v, dtype=torch.int64, device=dev) for v in _INIT], 1)
    for block_i in range(nb):
        m = words[:, block_i]
        a, b, c, d = state[:, 0], state[:, 1], state[:, 2], state[:, 3]
        for i in range(64):
            if i < 16:
                f = (b & c) | (~b & d)
                g = i
            elif i < 32:
                f = (d & b) | (~d & c)
                g = (5 * i + 1) & 15
            elif i < 48:
                f = b ^ c ^ d
                g = (3 * i + 5) & 15
            else:
                f = c ^ (b | (~d & MASK32))
                g = (7 * i) & 15
            rot = _rotl((a + (f & MASK32) + _K[i] + m[:, g]) & MASK32, _S[i])
            a, b, c, d = d, (b + rot) & MASK32, b, c
        new = (state + torch.stack([a, b, c, d], dim=1)) & MASK32
        # rows whose padded message ended earlier skip this block
        live = (block_i < n_blocks)[:, None]
        state = torch.where(live, new, state)
    return state

