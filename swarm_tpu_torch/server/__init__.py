"""Control plane: the port's copy of ``swarm_tpu/server``, so far its
durable queue journal (:mod:`~swarm_tpu_torch.server.journal`)."""
