"""The port imports torch and nothing of JAX or of the JAX package.

Every module of ``swarm_tpu_torch`` is imported in a fresh interpreter,
which then must hold no ``jax`` and no ``swarm_tpu`` module.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def port_modules() -> list[str]:
    import swarm_tpu_torch

    names = ["swarm_tpu_torch"]
    for info in pkgutil.walk_packages(swarm_tpu_torch.__path__, "swarm_tpu_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return sorted(names)


def test_module_list_covers_the_slice():
    names = set(port_modules())
    assert {
        "swarm_tpu_torch.ops.cluster", "swarm_tpu_torch.ops.kernels",
        "swarm_tpu_torch.tls.jarm", "swarm_tpu_torch.native.scanio",
        "swarm_tpu_torch.worker.runtime", "swarm_tpu_torch.utils.device",
    } <= names


@pytest.mark.parametrize("module", port_modules())
def test_imports_no_jax(module):
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swarm_tpu' or m.startswith('swarm_tpu.'))\n"
        "print(json.dumps({'bad': bad, 'torch': 'torch' in sys.modules}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
