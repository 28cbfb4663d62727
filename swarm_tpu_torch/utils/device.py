"""Device selection for the port: CUDA unless the CPU is asked for.

The JAX package picks its backend through ``swarm_tpu/utils/backendprobe``;
the port has one rule instead. Every entry point takes ``device``; with
none given it runs on the card, and without a card it raises rather than
carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU. Raises on a CUDA request
    when no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the CPU is "
            "asked for (device='cpu' / --device cpu)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
