"""CLI client for the swarm control plane: the port's copy of
``swarm_tpu/client`` (:mod:`~swarm_tpu_torch.client.cli`).
"""
