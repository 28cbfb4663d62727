"""Module registry: ``modules/<name>.json`` files, read as the JAX
package's ``swarm_tpu/worker/modules.py`` reads them.

A module file names its ``backend`` and the backend's settings, e.g. the
jarm module::

    {"backend": "jarm", "input_format": "targets", "cluster_radius": 32.0,
     "probe": {"type": "tls", "ports": [443], "concurrency": 256, ...}}

The port runs the ``jarm`` backend; the worker fails a job of any other
backend with "backend not ported".
"""

from __future__ import annotations

import json
from pathlib import Path


class ModuleSpec:
    def __init__(self, name: str, raw: dict):
        self.name = name
        self.raw = raw
        self.backend = raw.get("backend", "command")
        self.probe: dict = raw.get("probe", {})


class ModuleRegistry:
    def __init__(self, modules_dir: str | Path):
        self.modules_dir = Path(modules_dir)

    def load(self, name: str) -> ModuleSpec:
        safe = Path(name).name  # no path traversal via module names
        path = self.modules_dir / f"{safe}.json"
        with path.open() as f:
            return ModuleSpec(safe, json.load(f))
