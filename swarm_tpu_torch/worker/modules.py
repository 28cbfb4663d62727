"""Module registry: ``modules/<name>.json`` files, read as the JAX
package's ``swarm_tpu/worker/modules.py`` reads them.

A module file names its ``backend`` and the backend's settings, e.g.::

    {"backend": "jarm", "input_format": "targets", "cluster_radius": 32.0,
     "probe": {"type": "tls", "ports": [443], "concurrency": 256, ...}}
    {"backend": "tpu", "templates": "${SWARM_TEMPLATES_DIR}",
     "input_format": "jsonl"}

The port runs every backend of the JAX worker:

- ``jarm``: TLS fingerprints and their clusters (``cluster_radius``);
- ``tpu``: the template match, ``input_format`` ``jsonl`` or
  ``targets`` (probed with ``probe``, ``wave_targets`` a wave),
  ``output_format`` ``matches_jsonl`` (the default) or ``nuclei``, a
  corpus with or without workflow templates;
- ``probe``: ``probe`` then ``output_format`` ``httprobe`` or
  ``httpx_json`` (``probe.type`` ``dns`` for the dnsx list);
- ``service``: ``probe``, ``probes_db`` (an nmap-service-probes file;
  default the system DB, else the bundled one) and ``output_format``
  ``nmap`` (else one line per open port);
- ``active``: each template's own requests per ``targets`` line
  (nuclei's execution mode), ``probe`` (with ``wave_rows``,
  ``ssl_ports``, ``session_concurrency``, ...) and ``vars`` (operator
  template variables);
- ``file``: input lines are local file or directory paths, confined to
  ``scan_root`` when it is set;
- ``ssl``: TLS handshakes to ``targets`` lines, ``probe``'s
  ``concurrency`` and ``connect_timeout_ms``;
- a module without ``backend`` runs its ``command``, with ``{input}``
  and ``{output}`` replaced by the chunk's files, through the shell.

``jsonl`` rows: each input line is a JSON response row ``{host, port,
status, body?, header?, banner?}`` (``*_b64`` variants base64).
``targets`` lines: ``host``, ``host:port``, ``ip[:port]`` or
``scheme://host[:port][/path]``.
"""

from __future__ import annotations

import base64
import json
import os
from pathlib import Path
from typing import Optional

from swarm_tpu_torch.fingerprints.model import Response


class ModuleSpec:
    def __init__(self, name: str, raw: dict):
        self.name = name
        self.raw = raw
        self.backend = raw.get("backend", "command")
        self.command_template: Optional[str] = raw.get("command")
        self._templates_raw: Optional[str] = raw.get("templates")
        self._templates_resolved: Optional[str] = None
        self.input_format: str = raw.get("input_format", "jsonl")
        self.output_format: str = raw.get("output_format", "matches_jsonl")
        self.probe: dict = raw.get("probe", {})

    @property
    def templates_dir(self) -> Optional[str]:
        """Resolved template-corpus path (``$VAR`` references expanded),
        verified to exist: a corpus that cannot be found fails the job
        loudly rather than matching nothing. The runtime reads this
        several times per job, so the first success is kept."""
        if self._templates_raw is None:
            return None
        if self._templates_resolved is not None:
            return self._templates_resolved
        d = os.path.expandvars(self._templates_raw)
        if "$" in d:
            raise ValueError(
                f"module {self.name}: templates path "
                f"{self._templates_raw!r} references an unset "
                "environment variable (set SWARM_TEMPLATES_DIR or bake "
                "the corpus into the image — docker/worker.Dockerfile "
                "TEMPLATES_SRC)"
            )
        if not os.path.isdir(d):
            raise ValueError(
                f"module {self.name}: templates directory {d!r} does "
                "not exist (corpus not bundled/mounted?)"
            )
        self._templates_resolved = d
        return d

    def command(self, input_path: str, output_path: str) -> str:
        """Substitute {input}/{output} (reference worker.py:27-33)."""
        if not self.command_template:
            raise ValueError(f"module {self.name} has no command")
        return self.command_template.replace("{input}", input_path).replace(
            "{output}", output_path
        )


class ModuleRegistry:
    def __init__(self, modules_dir: str | Path):
        self.modules_dir = Path(modules_dir)

    def load(self, name: str) -> ModuleSpec:
        safe = Path(name).name  # no path traversal via module names
        path = self.modules_dir / f"{safe}.json"
        with path.open() as f:
            return ModuleSpec(safe, json.load(f))

    def names(self) -> list[str]:
        if not self.modules_dir.is_dir():
            return []
        return sorted(p.stem for p in self.modules_dir.glob("*.json"))


# ---------------------------------------------------------------------------
# Response rows of the jsonl input format (the JAX worker's own code)


def _bytes_field(obj: dict, name: str) -> bytes:
    if f"{name}_b64" in obj:
        return base64.b64decode(obj[f"{name}_b64"])
    value = obj.get(name)
    if value is None:
        return b""
    if isinstance(value, bytes):
        return value
    return str(value).encode("utf-8", "surrogateescape")


def parse_response_line(line: str) -> Optional[Response]:
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except ValueError:
        # bare target line — pass through as an empty response so the
        # row count is stable; real probing is the front-end's job
        host, _, port = line.partition(":")
        return Response(host=host, port=int(port) if port.isdigit() else 0)
    banner = _bytes_field(obj, "banner") if ("banner" in obj or "banner_b64" in obj) else None
    return Response(
        host=str(obj.get("host", "")),
        port=int(obj.get("port", 0) or 0),
        status=int(obj.get("status", 0) or 0),
        body=_bytes_field(obj, "body"),
        header=_bytes_field(obj, "header"),
        banner=banner,
        alive=bool(obj.get("alive", True)),
    )


def format_match_line(row: Response, matches) -> str:
    out = {
        "host": row.host,
        "port": row.port,
        "matches": matches.template_ids,
        "extractions": matches.extractions,
    }
    if not row.alive:
        out["unreachable"] = True
    return json.dumps(out, sort_keys=True)
