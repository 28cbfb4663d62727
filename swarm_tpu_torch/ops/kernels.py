"""Build, bind and launch the port's hand-written CUDA kernels.

``csrc/cluster.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, and bound with ``ctypes``.
The build goes to ``swarm_tpu_torch/_build/`` and uses only the sources in
the repository.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``, launches on
PyTorch's current stream, raises if the launcher reports a CUDA error,
and adds one to its launch count. A tensor on the CPU goes to the plain
PyTorch version in ``ops/cluster.py`` instead; a CUDA tensor always
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

FP_WORDS = 16

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "cluster.cu",)
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB_PATH = BUILD_DIR / "libswarm_cluster.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches made by each wrapper, for showing which kernels a run went
#: through; :func:`reset_launches` zeroes them
LAUNCHES: dict[str, int] = {"cluster_counts": 0, "cluster_parent": 0}

_lib: Optional[ctypes.CDLL] = None  # guarded-by: _load_lock
_load_lock = threading.Lock()
#: compiler output of the last build (ptxas register / shared-memory use)
build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _SOURCES)


def compile_library(sources: tuple[Path, ...], lib_path: Path) -> str:
    """Compile ``sources`` with nvcc for sm_90a into the shared library
    ``lib_path`` → the compiler's output (ptxas register / shared-memory
    use). Builds into a private file and renames it into place, so
    concurrent builds never load a half-written library."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f".{lib_path.name}.{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return proc.stdout + proc.stderr


def build() -> float:
    """Compile the kernels if the library is missing or older than its
    sources; → seconds spent compiling (0 when up to date)."""
    global build_log
    if not _stale():
        return 0.0
    t0 = time.perf_counter()
    build_log = compile_library(_SOURCES, _LIB_PATH)
    return time.perf_counter() - t0


def ptxas_report(log: str) -> list[dict]:
    """Each compiled kernel's registers, shared memory and spills from
    ``nvcc -Xptxas -v`` output (the build log)."""
    report: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if found:
            name = found.group(1)
            report.setdefault(name, {"kernel": _short_name(name)})
            continue
        if name is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            report[name]["spill_stores"] = int(spills.group(1))
            report[name]["spill_loads"] = int(spills.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return list(report.values())


def _short_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_121cluster_parent_kernelIjEEv...' → 'cluster_parent_kernel<uint32>'."""
    found = re.search(r"([a-z][a-z_]*_kernel)(?:I([jy])E)?", mangled)
    if not found:
        return mangled
    base, key = found.groups()
    return f"{base}<{'uint32' if key == 'j' else 'uint64'}>" if key else base


def load_library() -> ctypes.CDLL:
    """Build on first use and bind the launchers."""
    global _lib
    with _load_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
            lib.cluster_counts.argtypes = [vp, i32, f32, vp, vp]
            lib.cluster_counts.restype = ctypes.c_int
            lib.cluster_parent.argtypes = [vp, vp, i32, i32, vp, vp, vp]
            lib.cluster_parent.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_packed(packed: torch.Tensor) -> None:
    if packed.dtype != torch.int32:
        raise TypeError(f"packed must be int32, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[1] != FP_WORDS:
        raise ValueError(f"packed must be [N, {FP_WORDS}], got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def cluster_counts(packed: torch.Tensor, radius: float) -> torch.Tensor:
    """rho[i] = #{j : hamming(i, j) <= radius}, self included → int32 [N]."""
    _check_packed(packed)
    if packed.device.type == "cpu":
        from swarm_tpu_torch.ops.cluster import neighbor_counts_plain

        return neighbor_counts_plain(packed, radius)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    lib = load_library()
    n = packed.shape[0]
    rho = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return rho
    with torch.cuda.device(packed.device):  # the launcher uses the current device
        rc = lib.cluster_counts(
            ctypes.c_void_p(packed.data_ptr()), n, float(radius),
            ctypes.c_void_p(rho.data_ptr()), _stream(packed),
        )
    _raise_on(rc, "cluster_counts")
    LAUNCHES["cluster_counts"] += 1
    return rho


def parent_in_order(
    rows: torch.Tensor, order: torch.Tensor, key_shift: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The parent search on rows already in density order (rho
    descending, index ascending; ``order``: their original indices,
    int32 [N]) → (delta f32 [N], parent int32 [N]) in that order: the
    distance and original index of the nearest earlier row, ties to the
    lower original index; 3.0e38 and -1 for the first row. The key is
    32-bit (shift 21) up to ``cluster.KEY32_MAX_ROWS`` rows, 64-bit
    (shift 32) above, or as ``key_shift`` says."""
    from swarm_tpu_torch.ops.cluster import parent_in_order_plain, parent_key_shift

    _check_packed(rows)
    n = rows.shape[0]
    if order.dtype != torch.int32 or order.shape != (n,) or not order.is_contiguous():
        raise ValueError("order must be a contiguous int32 [N]")
    if order.device != rows.device:
        raise ValueError("order and rows must be on the same device")
    shift = parent_key_shift(n) if key_shift is None else key_shift
    if shift not in (21, 32) or (shift == 21 and parent_key_shift(n) != 21):
        raise ValueError(f"key shift {shift} cannot hold {n} rows")
    if rows.device.type == "cpu":
        return parent_in_order_plain(rows, order, shift)
    if rows.data_ptr() % 16 or order.data_ptr() % 16:
        raise ValueError("rows and order must be 16-byte aligned")
    lib = load_library()
    delta = torch.empty(n, dtype=torch.float32, device=rows.device)
    parent = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n == 0:
        return delta, parent
    with torch.cuda.device(rows.device):  # the launcher uses the current device
        rc = lib.cluster_parent(
            ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(order.data_ptr()), n,
            int(shift == 32),
            ctypes.c_void_p(delta.data_ptr()), ctypes.c_void_p(parent.data_ptr()),
            _stream(rows),
        )
    _raise_on(rc, "cluster_parent")
    LAUNCHES["cluster_parent"] += 1
    return delta, parent
