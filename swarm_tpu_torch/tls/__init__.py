"""TLS fingerprinting stack of the port: wire codec, JARM/JA3S.

See swarm_tpu_torch/tls/jarm.py for the fingerprint construction and
swarm_tpu_torch/ops/cluster.py for the device-side clustering.
"""

from swarm_tpu_torch.tls.jarm import (  # noqa: F401
    TlsFingerprint,
    fingerprint_from_banners,
    ja3s,
    jarm_hash,
    probe_set,
)
from swarm_tpu_torch.tls.wire import (  # noqa: F401
    HelloSpec,
    ServerHello,
    build_client_hello,
    parse_server_flight,
)
