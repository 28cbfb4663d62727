"""How the port's worker reads its configuration: the JAX package's
``Config.load`` (``swarm_tpu/config.py``) for the fields the worker has.

In increasing precedence: the dataclass's defaults, then a config file,
then the environment, then explicit overrides (the CLI's flags).

- An explicit path must load: a missing file or bad JSON raises, so a
  typo never starts a worker that polls the default URL with the
  placeholder key. Without one, the first of ``~/.swarm_tpu.json`` and
  ``~/.axiom.json`` that exists is read, and a malformed one is
  ignored.
- ``SWARM_<FIELD>``, then the reference worker's aliases
  (``SERVER_URL``, ``API_KEY``, ``WORKER_ID``); a variable that is set
  but empty counts.
- Values are coerced to each field's type, bools from ``1`` / ``true``
  / ``yes`` / ``on``; keys of the file that the dataclass lacks are
  ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping, Optional

DEFAULT_CONFIG_FILE = "~/.swarm_tpu.json"
#: also read, for the reference CLI's config
LEGACY_CONFIG_FILE = "~/.axiom.json"

ENV_PREFIX = "SWARM_"
#: the reference worker's environment names, besides ``SWARM_<FIELD>``
ENV_ALIASES = {
    "server_url": ("SERVER_URL",),
    "api_key": ("API_KEY",),
    "worker_id": ("WORKER_ID",),
}


def read_config_file(path: Optional[str] = None) -> dict:
    """The values of the config file: ``path``'s (which must load), else
    the first default file that exists ({} when it is malformed or
    there is none)."""
    if path:
        return json.loads(Path(path).expanduser().read_text())
    for candidate in (DEFAULT_CONFIG_FILE, LEGACY_CONFIG_FILE):
        p = Path(candidate).expanduser()
        if p.is_file():
            try:
                return json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                return {}
    return {}


def load(cls, path: Optional[str] = None, env: Optional[Mapping[str, str]] = None,
         read_files: bool = True, **overrides: Any):
    """An instance of the dataclass ``cls`` from its defaults, the
    config file (when ``read_files``), the environment (``os.environ``
    unless ``env``) and the overrides that are not None."""
    env = os.environ if env is None else env
    values: dict = dict(read_config_file(path)) if read_files else {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for name in fields:
        for key in (ENV_PREFIX + name.upper(),) + ENV_ALIASES.get(name, ()):
            if key in env:
                values[name] = env[key]
                break
    values.update({k: v for k, v in overrides.items() if v is not None})
    coerced: dict = {}
    for name, value in values.items():
        field = fields.get(name)
        if field is None:
            continue
        if field.type in ("int", int) and not isinstance(value, int):
            value = int(value)
        elif field.type in ("float", float) and not isinstance(value, float):
            value = float(value)
        elif field.type in ("bool", bool) and not isinstance(value, bool):
            value = str(value).strip().lower() in ("1", "true", "yes", "on")
        coerced[name] = value
    return cls(**coerced)
