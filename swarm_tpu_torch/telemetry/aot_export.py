"""Always-registered ``swarm_aot_*`` metric families, the port of
``swarm_tpu/telemetry/aot_export.py``.

The port's only compiled artifacts are its CUDA kernel libraries, each
built once into a file named by its key (``ops/kernels.py``
``library_key``, ``library_path``) and loaded from that file by every
later process. :func:`~swarm_tpu_torch.ops.kernels.load_library` feeds
these families:

- ``swarm_aot_fetch_total{outcome}``: ``hit`` — a keyed library file
  was there and loaded without nvcc; ``miss`` — it was not, and nvcc
  built it; ``deserialize_error`` — the keyed file was there but
  ``ctypes.CDLL`` refused it: it is deleted and built once from the
  sources, and a load that fails again raises;
- ``swarm_aot_publish_total{outcome}``: ``stored`` — a build renamed
  into the build directory; ``fenced`` and ``error`` stay at 0, since
  the port has no shared store;
- ``swarm_aot_bringup_seconds{source}``: each load of a keyed file
  (``fetch``) and each build (``compile``);
- ``swarm_aot_artifact_bytes``: the size of the library loaded last.

Names, kinds, help strings, labels and the pre-seeded label values are
the reference's: its server and scrapers read them.
"""

from __future__ import annotations

from swarm_tpu_torch.telemetry.metrics import REGISTRY

AOT_FETCHES = REGISTRY.counter(
    "swarm_aot_fetch_total",
    "AOT executable-cache fetches by outcome (hit = loaded instead "
    "of compiled; deserialize_error = artifact present but unloadable, "
    "fell back to compile)",
    ("outcome",),
)
for _o in ("hit", "miss", "deserialize_error"):
    AOT_FETCHES.labels(outcome=_o)
del _o

AOT_PUBLISHES = REGISTRY.counter(
    "swarm_aot_publish_total",
    "AOT executable-cache publishes by outcome",
    ("outcome",),
)
for _o in ("stored", "fenced", "error"):
    AOT_PUBLISHES.labels(outcome=_o)
del _o

AOT_BRINGUP_SECONDS = REGISTRY.histogram(
    "swarm_aot_bringup_seconds",
    "Seconds to make one executable servable (fetch+deserialize on a "
    "hit, trace+compile on a miss), by source",
    ("source",),
)
AOT_BRINGUP_SECONDS.labels(source="fetch")
AOT_BRINGUP_SECONDS.labels(source="compile")

AOT_ARTIFACT_BYTES = REGISTRY.gauge(
    "swarm_aot_artifact_bytes",
    "Size in bytes of the most recently published or fetched AOT "
    "artifact",
)
AOT_ARTIFACT_BYTES.set(0)
