"""Control plane: the port's copy of ``swarm_tpu/server`` — the REST C2
server (:mod:`~swarm_tpu_torch.server.app`, ``python -m
swarm_tpu_torch.server``), the job queue service
(:mod:`~swarm_tpu_torch.server.queue`) with its durable journal
(:mod:`~swarm_tpu_torch.server.journal`), and fleet orchestration
(:mod:`~swarm_tpu_torch.server.fleet`)."""
