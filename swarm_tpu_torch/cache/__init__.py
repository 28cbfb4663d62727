"""Fleet-wide content-addressed result cache (the port of
``swarm_tpu/cache``): :mod:`~swarm_tpu_torch.cache.tier`."""

from swarm_tpu_torch.cache.tier import (  # noqa: F401
    ResultCacheClient,
    SharedResultTier,
    build_result_cache,
    confirm_digest,
    corpus_digest,
    decode_entry,
    encode_entry,
    row_digest,
)
