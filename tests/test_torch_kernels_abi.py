"""The ctypes bindings of the CUDA launchers against their C signatures.

``kernels._bind`` declares each ``extern "C"`` launcher's argument types
by hand; a parameter added to a launcher in ``ops/csrc/*.cu`` without
its binding shifts every later argument. Each launcher's parameter
count in the source must equal its binding's. Runs on the CPU: nothing
is built or loaded.
"""

from __future__ import annotations

import re

import pytest

from swarm_tpu_torch.ops import kernels

LAUNCHERS = (
    ("cluster", "cluster_counts"), ("cluster", "cluster_parent"),
    ("md5", "match_md5"), ("verdicts", "match_verdicts"),
    ("match", "match_phase_a"), ("match", "match_verify"),
    ("match", "match_regex_scan"),
)


class _Fn:
    argtypes = None
    restype = None


class _Lib:
    """Stands in for a loaded library: one bindable object a name."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.__dict__["fns"].setdefault(name, _Fn())


def _c_params(library: str, fn: str) -> list:
    (source,), _ = kernels.LIBRARIES[library]
    text = source.read_text()
    found = re.search(rf"^int {fn}\((.*?)\)\s*\{{", text, re.S | re.M)
    assert found, f"no launcher {fn} in {source.name}"
    return [p.strip() for p in found.group(1).split(",")]


@pytest.mark.parametrize("library,fn", LAUNCHERS)
def test_binding_matches_launcher_signature(library, fn):
    lib = _Lib()
    kernels._bind(library, lib)
    bound = lib.fns[fn]
    params = _c_params(library, fn)
    assert len(bound.argtypes) == len(params), (fn, params)
    assert bound.restype is not None


def test_every_launcher_is_checked():
    names = set()
    for library, _ in kernels.LIBRARIES.items():
        lib = _Lib()
        kernels._bind(library, lib)
        names |= {(library, fn) for fn in lib.fns}
    assert names == set(LAUNCHERS)
