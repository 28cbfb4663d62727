"""Control plane: the port's copy of ``swarm_tpu/server``, so far its
queue side — the job queue service (:mod:`~swarm_tpu_torch.server.queue`)
and its durable journal (:mod:`~swarm_tpu_torch.server.journal`)."""
