"""swarm_tpu_torch: the PyTorch + CUDA port of swarm_tpu, for NVIDIA Hopper.

The JAX package ``swarm_tpu`` stays the reference. This package imports
``torch`` and never ``jax`` nor anything of ``swarm_tpu``: what it needs
of the framework-free layers it keeps as its own copies. Its device work
runs on ``cuda`` unless the caller asks for the CPU
(:func:`swarm_tpu_torch.utils.device.resolve_device`).

Ported so far: the worker's ``jarm`` backend (TLS probing and the two
density-peaks kernels, ``ops/csrc/cluster.cu``); its ``tpu`` backend
(the template match through ``MatchEngine`` and the five match kernels
of ``ops/csrc/``, with ``jsonl`` or ``targets`` input, JSONL or nuclei
output and workflows); its ``probe`` backend; and its ``service``
backend (``ServiceClassifier`` over an nmap-service-probes DB on the
same match kernels). ROADMAP.md lists what is still to come.
"""
