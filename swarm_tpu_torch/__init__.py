"""swarm_tpu_torch: the PyTorch + CUDA port of swarm_tpu, for NVIDIA Hopper.

The JAX package ``swarm_tpu`` stays the reference. This package imports
``torch`` and never ``jax`` nor anything of ``swarm_tpu``: what it needs
of the framework-free layers it keeps as its own copies. Its device work
runs on ``cuda`` unless the caller asks for the CPU
(:func:`swarm_tpu_torch.utils.device.resolve_device`).

It does all that the JAX package does. The worker runs every backend
of ``swarm_tpu``: ``jarm`` (TLS probing and the two density-peaks
kernels, ``ops/csrc/cluster.cu``), ``tpu`` (the template match through
``MatchEngine`` and the five match kernels of ``ops/csrc/``), ``probe``,
``service``, ``active`` (with the OOB listener and headless execution),
``file``, ``ssl`` and the command fallback, with the scheduler,
resilience, telemetry, the mesh, the fleet result tier and the AOT
library store. The control plane is the reference's: the gateway, the
monitor lane, the queue and its journal, the REST server and its fleet
(``python -m swarm_tpu_torch.server``), the client
(``python -m swarm_tpu_torch.client``) and the benchmark sampler
(``python -m swarm_tpu_torch.benchmark``). ROADMAP.md lists what the
JAX package has that the port leaves out by design.
"""
