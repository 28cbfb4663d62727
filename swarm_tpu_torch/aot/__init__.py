"""AOT library cache: the port's compiled CUDA kernel libraries as
distributable data, the port of ``swarm_tpu/aot``.

A cold worker runs ``nvcc`` on each kernel library before its first
batch. This package ships the built libraries (``ops/kernels.py``: one
shared library a CUDA source, named by its key) through the result
tier's stores under its epoch + fencing-token discipline, so a joining
worker FETCHES and loads them instead of compiling — falling back to a
local build on any miss or refused payload (breaker-wrapped; the cache
is an accelerator, never a dependency). Either way the kernels are the
same sources.
"""

from swarm_tpu_torch.aot.store import (  # noqa: F401
    AotClient,
    AotStore,
    build_aot_client,
    kernel_code_salt,
    toolchain_fingerprint,
)
