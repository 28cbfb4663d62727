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


def build() -> float:
    """Compile the kernels if the library is missing or older than its
    sources; → seconds spent compiling (0 when up to date). Builds into a
    private file and renames it into place, so concurrent builds never
    load a half-written library."""
    global build_log
    if not _stale():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{_LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, _LIB_PATH)
    build_log = proc.stdout + proc.stderr
    return time.perf_counter() - t0


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
            lib.cluster_parent.argtypes = [vp, vp, i32, vp, vp, vp]
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


def cluster_parent(
    packed: torch.Tensor, rho: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(delta f32 [N], parent int32 [N]): distance and index of the
    nearest strictly denser row (ties in rho go to the lower index);
    3.0e38 and -1 where there is none."""
    _check_packed(packed)
    n = packed.shape[0]
    if rho.dtype != torch.int32 or rho.shape != (n,) or not rho.is_contiguous():
        raise ValueError("rho must be a contiguous int32 [N]")
    if rho.device != packed.device:
        raise ValueError("rho and packed must be on the same device")
    if packed.device.type == "cpu":
        from swarm_tpu_torch.ops.cluster import nearest_denser_plain

        return nearest_denser_plain(packed, rho)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    lib = load_library()
    delta = torch.empty(n, dtype=torch.float32, device=packed.device)
    parent = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return delta, parent
    with torch.cuda.device(packed.device):  # the launcher uses the current device
        rc = lib.cluster_parent(
            ctypes.c_void_p(packed.data_ptr()), ctypes.c_void_p(rho.data_ptr()), n,
            ctypes.c_void_p(delta.data_ptr()), ctypes.c_void_p(parent.data_ptr()),
            _stream(packed),
        )
    _raise_on(rc, "cluster_parent")
    LAUNCHES["cluster_parent"] += 1
    return delta, parent
