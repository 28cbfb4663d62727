"""Multi-tenant admission-controlled gateway, the port of
``swarm_tpu/gateway`` (docs/GATEWAY.md).

The serving tier's front door: every ``/queue`` submission carries a
tenant id (``X-Swarm-Tenant`` header; absent = the ``default`` tenant),
and admission is decided by
:class:`~swarm_tpu_torch.gateway.admission.AdmissionController` —
per-tenant token buckets, bounded per-tenant queues, and a composite
backpressure signal (queue depth, worker-reported in-flight
saturation, breaker states) that sheds with ``429 + Retry-After``.
Results stream back as NDJSON push
(:mod:`swarm_tpu_torch.gateway.streaming`); interactive submissions
whose every chunk the fleet knows are answered from the gateway's scan
cache (:mod:`swarm_tpu_torch.gateway.qoscache`). All of it is host
code; the server that calls it is the next slice of the port.
"""

from swarm_tpu_torch.gateway.admission import (  # noqa: F401
    AdmissionController,
    Decision,
    PressureSnapshot,
    TokenBucket,
)
from swarm_tpu_torch.gateway.streaming import stream_scan  # noqa: F401
