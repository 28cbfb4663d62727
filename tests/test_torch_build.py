"""The kernel libraries' build key (``swarm_tpu_torch/ops/kernels.py``).

Each CUDA library is built into a file whose name carries a digest of
what it is built from: its sources (names and bytes), ``NVCC_FLAGS``,
``nvcc --version`` and the card's compute capability. A keyed file that
exists is loaded without running ``nvcc``; any change of the four builds
a new file; a file under any other name is never loaded. Runs on the
CPU: ``nvcc --version`` and the capability are stubbed, the compiler
and the loader are stand-ins, and nothing is built.
"""

from __future__ import annotations

import os
import re
import shutil

import pytest

from swarm_tpu_torch.ops import kernels

NVCC_VERSION = "nvcc: NVIDIA (R) Cuda compiler driver\nCuda compilation tools, release 12.8, V12.8.93\n"


@pytest.fixture
def lib_env(tmp_path, monkeypatch):
    """Every library's sources copied under ``tmp_path/src``, the build
    directory ``tmp_path/_build``, ``nvcc --version`` and the capability
    stubbed, no library loaded yet."""
    src = tmp_path / "src"
    src.mkdir()
    libraries = {}
    for name, (sources, stem) in kernels.LIBRARIES.items():
        copies = []
        for path in sources:
            shutil.copy2(path, src / path.name)
            copies.append(src / path.name)
        libraries[name] = (tuple(copies), stem)
    monkeypatch.setattr(kernels, "LIBRARIES", libraries)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_nvcc_version", lambda: NVCC_VERSION)
    monkeypatch.setattr(kernels, "_device_capability", lambda: (9, 0))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build_logs", {})
    return tmp_path


@pytest.fixture
def compiles(monkeypatch):
    """``compile_library`` replaced by a stand-in that writes the library
    file and records (sources, path) of each call."""
    calls = []

    def fake_compile(sources, lib_path):
        calls.append((tuple(sources), lib_path))
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        lib_path.write_bytes(b"\x7fELF built from " + b" ".join(s.name.encode() for s in sources))
        return f"ptxas info    : Used 32 registers\n{lib_path.name}"

    monkeypatch.setattr(kernels, "compile_library", fake_compile)
    return calls


class _Fn:
    argtypes = None
    restype = None


class _Lib:
    """Stands in for a loaded library: remembers its path, one bindable
    object a launcher name."""

    def __init__(self, path):
        self.path = path
        self.fns = {}

    def __getattr__(self, name):
        return self.__dict__["fns"].setdefault(name, _Fn())


@pytest.fixture
def loads(monkeypatch):
    """``ctypes.CDLL`` as the kernels module calls it, replaced by a
    stand-in that records each path it is asked to load."""
    paths = []

    def fake_cdll(path):
        paths.append(path)
        return _Lib(path)

    monkeypatch.setattr(kernels.ctypes, "CDLL", fake_cdll)
    return paths


def test_library_path_carries_the_key(lib_env):
    for name, (_sources, stem) in kernels.LIBRARIES.items():
        key = kernels.library_key(name)
        assert re.fullmatch(r"[0-9a-f]{64}", key)
        assert kernels.library_path(name) == lib_env / "_build" / f"{stem}-{key[:16]}.so"


def test_libraries_have_distinct_keys(lib_env):
    keys = {kernels.library_key(name) for name in kernels.LIBRARIES}
    assert len(keys) == len(kernels.LIBRARIES)


def _flip_source_byte(monkeypatch):
    (src,), _stem = kernels.LIBRARIES["md5"]
    data = bytearray(src.read_bytes())
    data[len(data) // 2] ^= 0x01
    src.write_bytes(bytes(data))


def _add_flag(monkeypatch):
    monkeypatch.setattr(kernels, "NVCC_FLAGS", (*kernels.NVCC_FLAGS, "-lineinfo"))


def _other_nvcc(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc_version",
                        lambda: NVCC_VERSION.replace("12.8, V12.8.93", "12.9, V12.9.41"))


def _other_card(monkeypatch):
    monkeypatch.setattr(kernels, "_device_capability", lambda: (10, 0))


@pytest.mark.parametrize("change", [_flip_source_byte, _add_flag, _other_nvcc, _other_card],
                         ids=["source_byte", "flag", "nvcc_version", "capability"])
def test_key_changes_with_what_the_library_is_built_from(lib_env, monkeypatch, change):
    before = {name: kernels.library_key(name) for name in kernels.LIBRARIES}
    change(monkeypatch)
    after = {name: kernels.library_key(name) for name in kernels.LIBRARIES}
    assert after["md5"] != before["md5"]
    if change is _flip_source_byte:  # the other libraries' sources are unchanged
        assert all(after[n] == before[n] for n in kernels.LIBRARIES if n != "md5")
    else:
        assert all(after[n] != before[n] for n in kernels.LIBRARIES)


def test_key_is_stable_and_ignores_mtimes(lib_env, monkeypatch):
    first = {name: kernels.library_key(name) for name in kernels.LIBRARIES}
    assert first == {name: kernels.library_key(name) for name in kernels.LIBRARIES}
    # the same bytes under the same names in another directory, newer
    copy = lib_env / "copy"
    copy.mkdir()
    libraries = {}
    for name, (sources, stem) in kernels.LIBRARIES.items():
        moved = []
        for path in sources:
            shutil.copy(path, copy / path.name)
            stat = path.stat()
            os.utime(copy / path.name, (stat.st_atime + 3600, stat.st_mtime + 3600))
            moved.append(copy / path.name)
        libraries[name] = (tuple(moved), stem)
    monkeypatch.setattr(kernels, "LIBRARIES", libraries)
    assert {name: kernels.library_key(name) for name in kernels.LIBRARIES} == first


def test_build_compiles_once_then_finds_the_keyed_file(lib_env, compiles):
    path = kernels.library_path("md5")
    assert not path.exists()
    assert kernels.build("md5") > 0.0
    assert compiles == [(kernels.LIBRARIES["md5"][0], path)]
    assert path.exists() and "md5" in kernels.build_logs
    assert kernels.build("md5") == 0.0
    assert len(compiles) == 1


def test_changed_flag_builds_a_new_path(lib_env, compiles, monkeypatch):
    kernels.build("md5")
    old = kernels.library_path("md5")
    _add_flag(monkeypatch)
    new = kernels.library_path("md5")
    assert new != old and not new.exists()
    assert kernels.build("md5") > 0.0
    assert [p for _s, p in compiles] == [old, new]
    assert old.exists() and new.exists()


def test_touching_a_source_rebuilds_nothing(lib_env, compiles):
    """The mtime test is gone: a source newer than its library, with the
    same bytes, keeps the key, and the keyed file is used."""
    kernels.build("md5")
    (src,), _stem = kernels.LIBRARIES["md5"]
    lib = kernels.library_path("md5")
    os.utime(src, (lib.stat().st_atime + 3600, lib.stat().st_mtime + 3600))
    assert kernels.build("md5") == 0.0
    assert len(compiles) == 1


def test_load_library_loads_only_the_keyed_file(lib_env, compiles, loads):
    """A library left under the old unkeyed name, or under another key,
    is never loaded: the keyed file is built and loaded instead."""
    build_dir = lib_env / "_build"
    build_dir.mkdir()
    stale = build_dir / "libswarm_md5.so"
    stale.write_bytes(b"\x7fELF an old build")
    other_key = build_dir / "libswarm_md5-0123456789abcdef.so"
    other_key.write_bytes(b"\x7fELF another key")
    lib = kernels.load_library("md5")
    keyed = kernels.library_path("md5")
    assert loads == [str(keyed)] and lib.path == str(keyed)
    assert [p for _s, p in compiles] == [keyed]
    assert lib.fns["match_md5"].argtypes is not None  # bound
    # the same process loads it once
    assert kernels.load_library("md5") is lib
    assert loads == [str(keyed)]


def test_second_load_in_a_new_process_fetches_without_nvcc(lib_env, compiles, loads,
                                                           monkeypatch):
    kernels.load_library("md5")
    monkeypatch.setattr(kernels, "_libs", {})  # as a new process finds the build directory
    kernels.load_library("md5")
    assert len(compiles) == 1
    assert loads == [str(kernels.library_path("md5"))] * 2


def test_nvcc_version_is_read_once_a_process(monkeypatch):
    runs = []

    class Done:
        stdout = NVCC_VERSION

    def fake_run(cmd, **kw):
        runs.append(cmd)
        return Done()

    monkeypatch.setattr(kernels, "_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    kernels._nvcc_version.cache_clear()
    try:
        assert kernels._nvcc_version() == NVCC_VERSION
        assert kernels._nvcc_version() == NVCC_VERSION
        assert runs == [["/opt/cuda/bin/nvcc", "--version"]]
    finally:
        kernels._nvcc_version.cache_clear()
