"""Build, bind and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` — ``cluster.cu`` (the density-peaks kernels),
``match.cu`` (phase A, the gather-verify and the regex scan of the
template match), ``md5.cu`` (the body's md5) and ``verdicts.cu`` (the
verdict lowering) — is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface at first use, and
bound with ``ctypes``. The builds go to ``swarm_tpu_torch/_build/`` and
use only the sources in the repository; the libraries can build in
parallel. Each library's file name carries its key, a digest of what it
is built from (its sources, ``NVCC_FLAGS``, ``nvcc --version`` and the
card's compute capability): a library whose keyed file exists is loaded
without running ``nvcc``, and a change of any of the four builds a new
one (:func:`library_key`, :func:`library_path`). Each load and build
goes to the ``swarm_aot_*`` families (:func:`load_library`).

An AOT client attached to the process (:func:`attach_aot`,
``aot/store.py`` ``AotClient``) lets a worker fetch the libraries the
fleet has built instead of compiling them: a library whose keyed file
is absent is fetched from the store first, and built only on a miss;
a build is published. ``nvcc --version`` is still read, for the key:
a joining worker needs ``nvcc`` on its path, but runs no compile. How a
load maps onto the ``swarm_aot_*`` families:

- no client: a keyed file on disk is a ``hit`` (``fetch`` bring-up), its
  absence a ``miss``; a build is a ``compile`` bring-up and a ``stored``
  publish; a keyed file ``ctypes.CDLL`` refuses is a
  ``deserialize_error``, deleted and built once;
- a client: this host's keyed files are the client's pool, as the
  reference's loaded executables are: a keyed file on disk, or one the
  prewarm fetched, is a pool ``hit`` with no store traffic. Anything
  else is the reference's fetch: a store ``hit`` (the payload checked and
  written, a ``fetch`` bring-up), a ``miss``, or a ``deserialize_error``
  (the payload refused: nothing written); the two last build, a
  ``compile`` bring-up, then publish (``stored``, ``fenced``, ``error``;
  nothing with ``aot_publish`` off). The client counts all of it, so the
  counts equal the JAX client's on the same sequence of loads.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its outputs with ``torch.empty``/``zeros``,
launches on PyTorch's current stream, raises if the launcher reports a
CUDA error, and adds one to its launch count. A tensor on the CPU goes
to the plain PyTorch version (``ops/cluster.py``, ``ops/match.py``,
``ops/regexdev.py``, ``ops/md5.py``) instead; a CUDA tensor always
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from swarm_tpu_torch.ops.hashing import BLOOM_WORDS
from swarm_tpu_torch.telemetry import aot_export

FP_WORDS = 16

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: library name -> (its sources, the stem of the shared library they
#: build: ``BUILD_DIR / f"{stem}-{key[:16]}.so"``, :func:`library_path`)
LIBRARIES = {
    "cluster": ((_CSRC / "cluster.cu",), "libswarm_cluster"),
    "match": ((_CSRC / "match.cu",), "libswarm_match"),
    "md5": ((_CSRC / "md5.cu",), "libswarm_md5"),
    "verdicts": ((_CSRC / "verdicts.cu",), "libswarm_verdicts"),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches made by each wrapper, for showing which kernels a run went
#: through; :func:`reset_launches` zeroes them
LAUNCHES: dict[str, int] = {
    "cluster_counts": 0, "cluster_parent": 0,
    "match_phase_a": 0, "match_verify": 0, "match_regex_scan": 0,
    "match_md5": 0, "match_verdicts": 0,
}
#: the ``__global__`` functions each wrapper launches on every call, as
#: a profiler trace names them (template arguments left off)
SYMBOLS: dict[str, tuple[str, ...]] = {
    "cluster_counts": ("cluster_counts_kernel",),
    "cluster_parent": ("cluster_parent_kernel",),
    "match_phase_a": ("match_phase_a_probe_kernel", "match_phase_a_rank_kernel"),
    "match_verify": ("match_verify_kernel",),
    "match_regex_scan": ("match_regex_scan_kernel",),
    "match_md5": ("match_md5_kernel",),
    "match_verdicts": ("match_verdicts_pack_kernel", "match_verdicts_kernel"),
}

_libs: dict[str, ctypes.CDLL] = {}  # guarded-by: _load_locks[name]
#: one lock a library, so that the libraries build in parallel
_load_locks = {name: threading.Lock() for name in LIBRARIES}
#: compiler output of each library's last build (ptxas register /
#: shared-memory use), by library name
build_logs: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: while :func:`record_calls` is active, the (name, args) of each match
#: wrapper call, in call order
_recorded: Optional[list] = None


@contextlib.contextmanager
def record_calls():
    """Collect the arguments of every match-kernel wrapper call made in
    the block, as ``(name, args)`` in call order, so that the exact
    calls a path made can be replayed (against a kernel's plain version,
    or to time it). Recording never launches or counts anything."""
    global _recorded
    saved, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = saved


def _record(name: str, args: tuple) -> None:
    if _recorded is not None:
        _recorded.append((name, args))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    """``nvcc --version``'s output, read once a process."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout


def _device_capability() -> tuple[int, int]:
    """The compute capability of the current card, which the libraries
    are built for."""
    return torch.cuda.get_device_capability()


def library_key(name: str) -> str:
    """sha256 over what library ``name`` is built from: each source's
    name and bytes, ``NVCC_FLAGS``, ``nvcc --version`` and the card's
    compute capability (hex)."""
    sources, _stem = LIBRARIES[name]
    digest = hashlib.sha256()
    for part in (
        *(piece for src in sources for piece in (src.name.encode(), src.read_bytes())),
        "\0".join(NVCC_FLAGS).encode(),
        _nvcc_version().encode(),
        "sm_{}{}".format(*_device_capability()).encode(),
    ):
        # each part with its length, so that no two lists of parts hash alike
        digest.update(len(part).to_bytes(8, "little"))
        digest.update(part)
    return digest.hexdigest()


def library_path(name: str) -> Path:
    """The file library ``name`` is built into and loaded from: its stem
    and the first 16 hex digits of :func:`library_key`."""
    return BUILD_DIR / f"{LIBRARIES[name][1]}-{library_key(name)[:16]}.so"


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


#: the AOT client the loader consults (``aot/store.py`` ``AotClient``),
#: one a process as the loaded libraries are; None: every library is
#: built here
_aot = None


def attach_aot(client) -> None:
    """Attach an AOT client to this process's loader (``None``
    detaches): libraries not loaded yet are fetched from its store
    before they are built, and builds are published to it."""
    global _aot
    _aot = client


def aot_client():
    """The attached AOT client, or None."""
    return _aot


def aot_digest(client, name: str) -> str:
    """The artifact digest of library ``name`` under ``client``'s program
    group: its name and its key; the statics and the shapes of the
    reference's digest are empty, since a library serves every shape."""
    return client.key_digest(name, library_key(name), "", "")


def aot_prewarm() -> int:
    """Fetch every library the attached client's store holds for this
    process's program group into its keyed file → the libraries pooled
    (0 without a client)."""
    client = _aot
    return client.prewarm() if client is not None else 0


def aot_publish(name: str) -> str:
    """Publish library ``name``'s keyed file through the attached client
    (what a build does after it compiles) → the outcome, ``disabled``
    without a client."""
    client = _aot
    return "disabled" if client is None else _publish(client, name)


def _publish(client, name: str) -> str:
    return client.publish(aot_digest(client, name), {"k": name, "s": "", "a": ""}, name)


def _compile(name: str, lib_path: Path, client) -> float:
    """Compile library ``name`` into ``lib_path`` → seconds; counted, and
    published through ``client`` when there is one."""
    t0 = time.perf_counter()
    build_logs[name] = compile_library(LIBRARIES[name][0], lib_path)
    seconds = time.perf_counter() - t0
    if client is None:
        aot_export.AOT_BRINGUP_SECONDS.labels(source="compile").observe(seconds)
        aot_export.AOT_PUBLISHES.labels(outcome="stored").inc()
    else:
        client.note_compile_seconds(seconds)
        _publish(client, name)
    return seconds


def build(name: str) -> float:
    """Compile library ``name`` into its keyed path unless that file
    exists or the attached client fetches it; → seconds spent compiling
    (0 when it was there or fetched)."""
    lib_path = library_path(name)
    if lib_path.exists():
        return 0.0
    client = _aot
    if client is not None and client.fetch_loaded(aot_digest(client, name)) is not None:
        return 0.0
    return _compile(name, lib_path, client)


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
    """'_ZN12_GLOBAL__N_121cluster_parent_kernelIjEEv...' → 'cluster_parent_kernel<uint32>',
    '..match_regex_scan_kernelILi3EEv..' → 'match_regex_scan_kernel<3>'. The
    name is the innermost length-prefixed identifier that ends in
    ``_kernel``: the unnamed namespace before it carries nvcc's file
    hash, whose digits can read as a longer length prefix that also
    ends there."""
    found = None
    for cand in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        n = int(cand.group(1))
        base = cand.group(2)[:n]
        if len(base) == n and base.endswith("_kernel"):
            found = (base, cand.group(2)[n:])
    if found is None:
        return mangled
    base, rest = found
    args = re.match(r"I([jy])E|ILi(\d+)E", rest)
    if args is None:
        return base
    key, lanes = args.groups()
    return f"{base}<{lanes}>" if lanes else f"{base}<{'uint32' if key == 'j' else 'uint64'}>"


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
    if name == "cluster":
        lib.cluster_counts.argtypes = [vp, i32, f32, vp, vp]
        lib.cluster_parent.argtypes = [vp, vp, i32, i32, vp, vp, vp]
        fns = (lib.cluster_counts, lib.cluster_parent)
    elif name == "md5":
        lib.match_md5.argtypes = [vp, vp, i32, i32, vp, vp]
        fns = (lib.match_md5,)
    elif name == "verdicts":
        lib.match_verdicts.argtypes = [vp, i32, vp, vp, i32] + [vp] * 13
        fns = (lib.match_verdicts,)
    else:
        lib.match_phase_a.argtypes = [vp, i32, vp, i32, i32, vp, vp, vp, vp]
        lib.match_verify.argtypes = [vp, vp, i32, vp, i32, i32, vp, vp, i32, i32, vp]
        lib.match_regex_scan.argtypes = (
            [i32, i32, vp, vp, vp, vp] + [vp] * 14 + [i32, i32, i32, vp, vp]
        )
        fns = (lib.match_phase_a, lib.match_verify, lib.match_regex_scan)
    for fn in fns:
        fn.restype = ctypes.c_int


def load_library(name: str) -> ctypes.CDLL:
    """Load library ``name`` once a process and bind its launchers. With
    no AOT client attached: its keyed file when it is there (a ``hit``),
    else built first (a ``miss``); a keyed file that ``ctypes.CDLL``
    refuses (a ``deserialize_error``: a truncated or foreign file) is
    deleted and built once from the sources, and if that build does not
    load either, the error is raised. The outcomes, the seconds of each
    load of a keyed file and the loaded file's size go to the
    ``swarm_aot_*`` families (``telemetry/aot_export.py``). With a client,
    :func:`_load_through`."""
    with _load_locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = _load_through(_aot, name) if _aot is not None else _load_local(name)
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _load_local(name: str) -> ctypes.CDLL:
    lib_path = library_path(name)
    lib = None
    if lib_path.exists():
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            aot_export.AOT_FETCHES.labels(outcome="deserialize_error").inc()
            lib_path.unlink(missing_ok=True)
        else:
            aot_export.AOT_BRINGUP_SECONDS.labels(source="fetch").observe(
                time.perf_counter() - t0)
            aot_export.AOT_FETCHES.labels(outcome="hit").inc()
    else:
        aot_export.AOT_FETCHES.labels(outcome="miss").inc()
    if lib is None:
        _compile(name, lib_path, None)
        lib = ctypes.CDLL(str(lib_path))
    aot_export.AOT_ARTIFACT_BYTES.set(lib_path.stat().st_size)
    return lib


def _load_through(client, name: str) -> ctypes.CDLL:
    """:func:`load_library`'s path with a client attached: this host's
    keyed file joins the client's pool; then the client's pool, then its
    store; a build on a miss or a refused payload. A pooled file that
    ``ctypes.CDLL`` refuses is dropped, deleted and built once."""
    lib_path = library_path(name)
    digest = aot_digest(client, name)
    if lib_path.exists():
        client.pool_local(digest, lib_path)
    if client.fetch_loaded(digest) is None:
        _compile(name, lib_path, client)
        return ctypes.CDLL(str(lib_path))
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        client.drop(digest)
        lib_path.unlink(missing_ok=True)
    _compile(name, lib_path, client)
    return ctypes.CDLL(str(lib_path))


def _check_packed(packed: torch.Tensor) -> None:
    if packed.dtype != torch.int32:
        raise TypeError(f"packed must be int32, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[1] != FP_WORDS:
        raise ValueError(f"packed must be [N, {FP_WORDS}], got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of card ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib = load_library("cluster")
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
    lib = load_library("cluster")
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


# ---------------------------------------------------------------------------
# Template-match kernels (csrc/match.cu)

MATCH_MAX_TABLES = 64  # kMaxTables in csrc/match.cu
MATCH_MAX_VARIANTS = 16  # kMaxVariants
VERIFY_WIDTH = 64  # kVerifyWidth: the bytes of a slot that are verified


class StreamView(NamedTuple):
    """One stream a match kernel reads: uint8 [B, W] bytes, int32 [B]
    lengths, read ASCII-lowercased when ``lowered``."""

    data: torch.Tensor
    lengths: torch.Tensor
    lowered: bool


def _need(t: torch.Tensor, dtype: torch.dtype, name: str, device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _host(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _check_views(views, limit: int) -> torch.device:
    """Check 1..``limit`` stream views: uint8 [B, W] and int32 [B],
    contiguous, one row count and one device → the device."""
    if not 1 <= len(views) <= limit:
        raise ValueError(f"{len(views)} streams, the kernels take 1..{limit}")
    device = views[0].data.device
    rows = views[0].data.shape[0]
    for i, v in enumerate(views):
        _need(v.data, torch.uint8, f"stream {i}", device)
        _need(v.lengths, torch.int32, f"lengths {i}", device)
        if v.data.dim() != 2 or v.data.shape[0] != rows or v.lengths.shape != (rows,):
            raise ValueError(f"stream {i}: shapes {tuple(v.data.shape)} / {tuple(v.lengths.shape)}")
    return device


def _views(views: list, device: torch.device, limit: int) -> tuple:
    """Check the stream views → host descriptor arrays (data pointers,
    length pointers, widths, lowered flags); the caller keeps them alive
    across the launch."""
    if _check_views(views, limit) != device:
        raise ValueError(f"the streams are on {views[0].data.device}, expected {device}")
    return (
        np.array([v.data.data_ptr() for v in views], dtype=np.int64),
        np.array([v.lengths.data_ptr() for v in views], dtype=np.int64),
        np.array([v.data.shape[1] for v in views], dtype=np.int32),
        np.array([int(v.lowered) for v in views], dtype=np.int32),
    )


#: tables of one (stream, lowered) view that phase A hashes together
#: (kGroupTables in csrc/match.cu)
GROUP_TABLES = 2
#: windows of a phase A word (kWordWindows): a row's mask slots are each
#: table's ceil(width / 32) words
WORD_WINDOWS = 32


class StreamRefC(ctypes.Structure):
    """csrc/match.cu's StreamRef."""

    _fields_ = [("data", ctypes.c_void_p), ("len", ctypes.c_void_p),
                ("width", ctypes.c_int32), ("lowered", ctypes.c_int32)]


class TableSetC(ctypes.Structure):
    """csrc/match.cu's TableSet: the batch's word tables."""

    _fields_ = [
        ("n_tables", ctypes.c_int32), ("n_groups", ctypes.c_int32),
        ("scan_words", ctypes.c_int32), ("back", ctypes.c_int32), ("fwd", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("s", StreamRefC * MATCH_MAX_TABLES), ("q", ctypes.c_int32 * MATCH_MAX_TABLES),
        ("off", ctypes.c_int32 * MATCH_MAX_TABLES),
        ("col_start", ctypes.c_int32 * (MATCH_MAX_TABLES + 1)),
        ("word_base", ctypes.c_int32 * (MATCH_MAX_TABLES + 1)),
        ("group_table", (ctypes.c_int32 * GROUP_TABLES) * MATCH_MAX_TABLES),
    ]


def table_groups(views: list) -> list:
    """The tables phase A hashes together: those that read one (stream,
    lowered) view, in first-appearance order, at most
    :data:`GROUP_TABLES` a group → lists of table indices."""
    by_view: dict = {}
    for t, v in enumerate(views):
        by_view.setdefault((v.data.data_ptr(), v.lowered), []).append(t)
    return [ts[i:i + GROUP_TABLES] for ts in by_view.values()
            for i in range(0, len(ts), GROUP_TABLES)]


def table_offsets(pos_offset, n_tables: int) -> tuple:
    """Each table's global offset (``pos_offset``: one int a table, or
    None for all zero) as a tuple of ints."""
    if pos_offset is None:
        return (0,) * n_tables
    offs = tuple(int(o) for o in pos_offset)
    if len(offs) != n_tables or min(offs, default=0) < 0:
        raise ValueError(f"need {n_tables} offsets >= 0, got {list(offs)}")
    return offs


class MatchTables(tuple):
    """The word tables of one batch: its :class:`StreamView` s (the tuple
    itself, as the plain versions read them) with their gram sizes
    ``qs``, column starts ``col_starts`` (T + 1), halos ``back`` and
    ``fwd`` and global offsets ``offsets`` (one a table), checked once,
    and ``struct``, the :class:`TableSetC` that ``match_phase_a`` and
    ``match_verify`` launch with. ``DeviceDB.dispatch`` builds one a batch
    and hands it to both wrappers, so the descriptor is built once a
    dispatch; a wrapper given plain views builds its own.

    A view of a seq-sharded grid is its slice of the row with ``back``
    bytes of the slice before it and ``fwd`` of the one after: a table's
    windows, and its run of columns, are its local width
    ``width - back - fwd``."""

    def __new__(cls, views, qs, col_starts, back_halo: int = 0, fwd_halo: int = 0,
                pos_offset=None):
        self = super().__new__(cls, views)
        device = _check_views(self, MATCH_MAX_TABLES)
        q = np.ascontiguousarray(qs, dtype=np.int32)
        cs = np.ascontiguousarray(col_starts, dtype=np.int32)
        if q.shape != (len(self),) or cs.shape != (len(self) + 1,):
            raise ValueError("one q per table and T + 1 column starts")
        if q.min() < 1 or q.max() > 8:
            raise ValueError("gram sizes must lie in 1..8")
        if back_halo < 0 or fwd_halo < 0:
            raise ValueError(f"halos must be >= 0, got {back_halo} / {fwd_halo}")
        offs = table_offsets(pos_offset, len(self))
        widths = np.array([v.data.shape[1] for v in self], dtype=np.int64) - back_halo - fwd_halo
        if widths.min() < 0:
            raise ValueError(f"a view is narrower than its halos {back_halo} + {fwd_halo}")
        if cs[0] != 0 or not np.array_equal(np.diff(cs.astype(np.int64)), widths):
            raise ValueError(f"column starts {cs.tolist()} are not the tables' local widths "
                             f"{widths.tolist()} laid end to end")
        self.qs, self.col_starts, self.device = qs, col_starts, device
        self.back, self.fwd, self.offsets = int(back_halo), int(fwd_halo), offs
        self.rows = self[0].data.shape[0]
        groups = table_groups(self)
        st = TableSetC()
        st.n_tables, st.n_groups = len(self), len(groups)
        st.back, st.fwd = self.back, self.fwd
        words = np.concatenate([[0], np.cumsum((widths + WORD_WINDOWS - 1) // WORD_WINDOWS)])
        st.scan_words = int(words[-1])
        st.word_base[: len(words)] = words.tolist()
        for t, v in enumerate(self):
            st.s[t] = StreamRefC(v.data.data_ptr(), v.lengths.data_ptr(), v.data.shape[1],
                                 int(v.lowered))
            st.q[t] = int(q[t])
            st.off[t] = offs[t]
        st.col_start[: len(cs)] = cs.tolist()
        for g, ts in enumerate(groups):
            st.group_table[g][:] = ts + [-1] * (GROUP_TABLES - len(ts))
        self.struct = st
        return self


def match_tables(views, qs, col_starts, back_halo: int = 0, fwd_halo: int = 0,
                 pos_offset=None) -> MatchTables:
    """``views`` itself when it is the :class:`MatchTables` built for
    these ``qs``, ``col_starts``, halos and offsets, else a new one."""
    if (isinstance(views, MatchTables) and views.qs is qs and views.col_starts is col_starts
            and (views.back, views.fwd) == (back_halo, fwd_halo)
            and views.offsets == table_offsets(pos_offset, len(views))):
        return views
    return MatchTables(views, qs, col_starts, back_halo, fwd_halo, pos_offset)


def match_phase_a(
    views, qs, col_starts, bloom: torch.Tensor, budget: int, kclamp: int,
    back_halo: int = 0, fwd_halo: int = 0, pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase A of the match: each table's bloom probe over every window
    of its stream, and the first ``kclamp`` fired (table, window)
    columns of each row in ascending order → (col int32 [B, budget],
    -1 past them; n_surv int32 [B], the row's count of fired windows).
    ``bloom`` is the stacked int32 [T, BLOOM_WORDS] bitmap; ``views``
    the tables' stream views, or the batch's :class:`MatchTables`. A
    seq-sharded rank's views carry ``back_halo`` and ``fwd_halo`` bytes
    of its neighbours, and ``pos_offset`` is each table's global offset
    (:class:`MatchTables`). On the card a call is two launches, the
    probe and the rank pass, and its launch count adds both."""
    _record("match_phase_a", (views, qs, col_starts, bloom, budget, kclamp, back_halo,
                              fwd_halo, pos_offset))
    device = views[0].data.device
    if device.type == "cpu":
        from swarm_tpu_torch.ops.match import phase_a_plain

        return phase_a_plain(views, qs, col_starts, bloom, budget, kclamp, back_halo,
                             fwd_halo, pos_offset)
    tabs = match_tables(views, qs, col_starts, back_halo, fwd_halo, pos_offset)
    _need(bloom, torch.int32, "bloom", device)
    if bloom.dim() != 2 or bloom.shape[0] < len(tabs) or bloom.shape[1] != BLOOM_WORDS:
        raise ValueError(f"bloom must be [T, {BLOOM_WORDS}], got {tuple(bloom.shape)}")
    if not 1 <= kclamp <= budget:
        raise ValueError(f"need 1 <= kclamp ({kclamp}) <= budget ({budget})")
    rows = tabs.rows
    col = torch.empty((rows, budget), dtype=torch.int32, device=device)
    n_surv = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows == 0:
        return col, n_surv
    lib = load_library("match")
    # scratch: each row's fired-window masks, a (table, word) slot each
    masks = torch.empty(rows * tabs.struct.scan_words, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.match_phase_a(ctypes.byref(tabs.struct), rows, _ptr(bloom), budget, kclamp,
                               _ptr(masks), _ptr(col), _ptr(n_surv), _stream(bloom))
    _raise_on(rc, "match_phase_a")
    LAUNCHES["match_phase_a"] += 2  # the probe and the rank pass
    return col, n_surv


#: the stacked table arrays match_verify reads, in the order of
#: csrc/match.cu's VerifyCorpus
VERIFY_TABLE_KEYS = (
    "group_h1", "entry_start", "entry_count", "n_groups", "entry_h2",
    "entry_slot", "entry_off", "entry_len", "entry_suf_delta",
    "entry_suf_h1", "entry_suf_h2",
)


class VerifyCorpusC(ctypes.Structure):
    """csrc/match.cu's VerifyCorpus."""

    _fields_ = [(key, ctypes.c_void_p) for key in VERIFY_TABLE_KEYS] + [
        ("slot_bytes", ctypes.c_void_p), ("slot_len", ctypes.c_void_p),
        ("gmax", ctypes.c_int32), ("emax", ctypes.c_int32), ("max_group", ctypes.c_int32),
        ("n_tables", ctypes.c_int32),
    ]


class VerifyCorpus(dict):
    """The corpus half of ``match_verify``: the stacked tables (the dict
    itself, as the plain version reads them), ``max_group``,
    ``slot_bytes`` and ``slot_len``, checked once, and ``struct``, the
    :class:`VerifyCorpusC` of their pointers. ``DeviceDB`` builds one a
    corpus; a wrapper given a plain dict builds its own."""

    def __init__(self, tab: dict, max_group: int, slot_bytes: torch.Tensor,
                 slot_len: torch.Tensor):
        super().__init__(tab)
        device = tab["group_h1"].device
        for key in VERIFY_TABLE_KEYS:
            _need(tab[key], torch.int32, key, device)
        _need(slot_bytes, torch.uint8, "slot_bytes", device)
        _need(slot_len, torch.int32, "slot_len", device)
        n_tables, gmax = tab["group_h1"].shape
        emax = tab["entry_h2"].shape[1]
        if tab["n_groups"].shape != (n_tables,) or any(
                tab[k].shape != (n_tables, gmax) for k in ("entry_start", "entry_count")) or any(
                tab[k].shape != (n_tables, emax) for k in VERIFY_TABLE_KEYS[4:]):
            raise ValueError("the verify tables must be [T], [T, gmax] and [T, emax]")
        if slot_bytes.dim() != 2 or slot_bytes.shape[1] != VERIFY_WIDTH or slot_len.shape != (
                slot_bytes.shape[0],):
            raise ValueError(f"slot_bytes must be [NS, {VERIFY_WIDTH}] and slot_len [NS]")
        self.max_group, self.slot_bytes, self.slot_len = max_group, slot_bytes, slot_len
        self.device = device
        self.struct = VerifyCorpusC(
            *(tab[key].data_ptr() for key in VERIFY_TABLE_KEYS), slot_bytes.data_ptr(),
            slot_len.data_ptr(), gmax, emax, int(max_group), n_tables)


def match_verify(
    views, qs, col_starts, col: torch.Tensor, kc: int, tab: dict,
    max_group: int, slot_bytes: torch.Tensor, slot_len: torch.Tensor,
    plane_width: int, back_halo: int = 0, fwd_halo: int = 0, pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase B's gather-verify of the candidates ``col[:, :kc]`` →
    (value bool [B, plane_width], uncertain bool [B, plane_width]) slot
    planes. ``tab`` holds the stacked tables (int32 tensors, the uint32
    ones as their bits), or is the corpus's :class:`VerifyCorpus`;
    ``views``, the halos and offsets as :func:`match_phase_a` takes
    them. On the card the two planes are one zeroed [2, B, plane_width]
    tensor (one fill)."""
    _record("match_verify", (views, qs, col_starts, col, kc, tab, max_group,
                             slot_bytes, slot_len, plane_width, back_halo, fwd_halo,
                             pos_offset))
    device = col.device
    if device.type == "cpu":
        from swarm_tpu_torch.ops.match import verify_plain

        return verify_plain(views, qs, col_starts, col, kc, tab, max_group,
                            slot_bytes, slot_len, plane_width, back_halo, fwd_halo,
                            pos_offset)
    tabs = match_tables(views, qs, col_starts, back_halo, fwd_halo, pos_offset)
    corpus = tab if (isinstance(tab, VerifyCorpus) and tab.max_group == max_group
                     and tab.slot_bytes is slot_bytes and tab.slot_len is slot_len) else (
        VerifyCorpus(tab, max_group, slot_bytes, slot_len))
    _need(col, torch.int32, "col", device)
    if tabs.device != device or corpus.device != device:
        raise ValueError(f"tables on {tabs.device} / {corpus.device}, col on {device}")
    rows = tabs.rows
    if col.dim() != 2 or col.shape[0] != rows or not 0 <= kc <= col.shape[1]:
        raise ValueError(f"col {tuple(col.shape)} cannot give {kc} columns")
    if corpus.struct.n_tables != len(tabs):
        raise ValueError(f"{len(tabs)} tables for a corpus of {corpus.struct.n_tables}")
    planes = torch.zeros((2, rows, plane_width), dtype=torch.bool, device=device)
    value, unc = planes[0], planes[1]
    if rows == 0 or kc == 0:
        return value, unc
    lib = load_library("match")
    with torch.cuda.device(device):
        rc = lib.match_verify(
            ctypes.byref(tabs.struct), ctypes.byref(corpus.struct), rows, _ptr(col),
            col.shape[1], kc, _ptr(value), _ptr(unc), plane_width, _sm_count(device.index),
            _stream(col),
        )
    _raise_on(rc, "match_verify")
    LAUNCHES["match_verify"] += 1
    return value, unc


#: the regex arrays match_regex_scan reads, in launcher order, and dtypes
REGEX_KEYS = (
    ("var_of_seq", torch.int32), ("bytemap", torch.int32), ("seed", torch.int32),
    ("skip", torch.int32), ("accept", torch.int32), ("self", torch.int32),
    ("anchored", torch.bool), ("end_mode", torch.int32),
    ("start_wb", torch.bool), ("end_wb", torch.bool),
)


def match_regex_scan(
    variants: list, pair_b: torch.Tensor, pair_s: torch.Tensor,
    valid: torch.Tensor, rx: dict, word_tab: torch.Tensor, r_closure: int,
) -> torch.Tensor:
    """The shift-and scan of K compacted (row, sequence) pairs over
    their stream variants → matched bool [K] (False where not
    ``valid``). ``rx`` holds the device regex arrays (bytemap [NSEQ,
    256, L] and the [NSEQ, L] lane masks as int32 bits)."""
    _record("match_regex_scan", (variants, pair_b, pair_s, valid, rx, word_tab, r_closure))
    device = pair_b.device
    if device.type == "cpu":
        from swarm_tpu_torch.ops.regexdev import regex_scan_plain

        return regex_scan_plain(variants, pair_b, pair_s, valid, rx, word_tab, r_closure)
    desc = _views(variants, device, MATCH_MAX_VARIANTS)
    k = pair_b.shape[0]
    _need(pair_b, torch.int64, "pair_b", device)
    _need(pair_s, torch.int64, "pair_s", device)
    _need(valid, torch.bool, "valid", device)
    if pair_s.shape != (k,) or valid.shape != (k,):
        raise ValueError("pair_b, pair_s and valid must be [K]")
    for key, dtype in REGEX_KEYS:
        _need(rx[key], dtype, key, device)
    _need(word_tab, torch.bool, "word_tab", device)
    lanes = rx["bytemap"].shape[2]
    if not 1 <= lanes <= 3 or word_tab.shape != (256,):
        raise ValueError(f"{lanes} state lanes (1..3) / word table {tuple(word_tab.shape)}")
    matched = torch.empty((k,), dtype=torch.bool, device=device)
    if k == 0:
        return matched
    lib = load_library("match")
    with torch.cuda.device(device):
        rc = lib.match_regex_scan(
            k, len(variants), *map(_host, desc), _ptr(pair_b), _ptr(pair_s),
            _ptr(valid), *(_ptr(rx[key]) for key, _ in REGEX_KEYS),
            _ptr(word_tab), lanes, int(r_closure), _sm_count(device.index),
            _ptr(matched), _stream(pair_b),
        )
    _raise_on(rc, "match_regex_scan")
    LAUNCHES["match_regex_scan"] += 1
    return matched


# ---------------------------------------------------------------------------
# md5 (csrc/md5.cu) and the verdict lowering (csrc/verdicts.cu)


def match_md5(
    stream: torch.Tensor, lengths: torch.Tensor, max_len: Optional[int] = None
) -> torch.Tensor:
    """MD5 of each row's first ``lengths[b]`` bytes of ``stream`` (uint8
    [B, W], W a multiple of 64) → int64 [B, 4], the four little-endian
    state words as uint32 values (the JAX ``md5_words``). Bytes at or
    past a row's length are not read as message bytes. ``max_len`` (a
    host int, at least every length) bounds the plain version's block
    loop; the kernel takes each row's block count from its length on
    the card."""
    _record("match_md5", (stream, lengths, max_len))
    device = stream.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    _need(stream, torch.uint8, "stream", device)
    _need(lengths, torch.int32, "lengths", device)
    if stream.dim() != 2 or stream.shape[1] % 64 or lengths.shape != (stream.shape[0],):
        raise ValueError(
            f"stream must be [B, W] with W % 64 == 0 and lengths [B], got "
            f"{tuple(stream.shape)} / {tuple(lengths.shape)}")
    if device.type == "cpu":
        from swarm_tpu_torch.ops.md5 import md5_words

        return md5_words(stream, lengths, max_len=max_len)
    rows, width = stream.shape
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned")
    digest = torch.empty((rows, 4), dtype=torch.int64, device=device)
    if rows == 0:
        return digest
    lib = load_library("md5")
    with torch.cuda.device(device):
        rc = lib.match_md5(_ptr(stream), _ptr(lengths), rows, width, _ptr(digest),
                           _stream(stream))
    _raise_on(rc, "match_md5")
    LAUNCHES["match_md5"] += 1
    return digest


#: the verdict layout's arrays (``ops/match.py`` ``verdict_layout_np``)
#: in the order of csrc/verdicts.cu's VerdictLayout, with their dtypes
VERDICT_LAYOUT_KEYS = (
    ("m_slot_off", torch.int32), ("m_slot_idx", torch.int32),
    ("m_neg_off", torch.int32), ("m_neg_idx", torch.int32),
    ("op_m_off", torch.int32), ("op_m_idx", torch.int32),
    ("t_op_off", torch.int32), ("t_op_idx", torch.int32),
    ("m_flags", torch.int32), ("op_flags", torch.int32), ("m_rx", torch.int32),
    ("scalar_src", torch.int32), ("scalar_cmp", torch.float32),
    ("scalar_mask", torch.int32), ("m_status", torch.int32), ("m_size", torch.int32),
    ("m_size_src", torch.int32), ("m_md5", torch.int32), ("chunks", torch.int32),
)
#: shared memory a block may use on Hopper (csrc/verdicts.cu keeps a
#: chunk's matcher, op and template words there: ``match.chunk_smem``)
MAX_SHARED_BYTES = 232448


class VerdictLayoutC(ctypes.Structure):
    """csrc/verdicts.cu's VerdictLayout: device pointers, then counts."""

    _fields_ = [(key, ctypes.c_void_p) for key, _ in VERDICT_LAYOUT_KEYS] + [
        (key, ctypes.c_int32)
        for key in ("nm", "nop", "nt", "n_conj", "n_status", "n_rx", "n_chunks", "chunk_smem")
    ]


def verdict_struct(layout) -> VerdictLayoutC:
    """The kernel's struct for a ``match.VerdictLayout``, made once per
    corpus (its tensors stay alive on the layout). Checks the arrays'
    dtypes, device and shapes."""
    from swarm_tpu_torch.ops.match import CHUNK_FIELDS

    csr = layout.csr
    for key, dtype in VERDICT_LAYOUT_KEYS:
        _need(csr[key], dtype, key, layout.device)
    nm, nop, nt = layout.nm, layout.nop, layout.nt
    for key, n in (("m_slot_off", nm + 1), ("m_neg_off", nm + 1), ("op_m_off", nop + 1),
                   ("t_op_off", nt + 1), ("m_flags", nm), ("op_flags", nop), ("m_rx", nm),
                   ("m_size_src", nm)):
        if csr[key].shape != (n,):
            raise ValueError(f"{key} must be [{n}], got {tuple(csr[key].shape)}")
    n_conj = csr["scalar_src"].shape[1]
    n_status = csr["m_status"].shape[1]  # any width: the kernel takes them 32 a pass
    if n_conj > 32:  # the kernel loads them a lane each; the compiler caps them at 6
        raise ValueError(f"{n_conj} scalar conjuncts a matcher, the kernel takes at most 32")
    for key, shape in (("scalar_src", (nm, n_conj)), ("scalar_cmp", (nm, n_conj)),
                       ("scalar_mask", (nm, n_conj)), ("m_status", (nm, n_status)),
                       ("m_size", (nm, n_status)), ("m_md5", (nm, 4)),
                       ("chunks", (layout.n_chunks, len(CHUNK_FIELDS)))):
        if csr[key].shape != shape:
            raise ValueError(f"{key} must be {list(shape)}, got {tuple(csr[key].shape)}")
    return VerdictLayoutC(
        *(csr[key].data_ptr() for key, _ in VERDICT_LAYOUT_KEYS),
        nm, nop, nt, n_conj, n_status, layout.n_rx, layout.n_chunks, layout.chunk_smem,
    )


def match_verdicts(
    layout, value_bits: torch.Tensor, uncertain_bits: torch.Tensor, lengths: dict,
    status: torch.Tensor, md5_digest: Optional[torch.Tensor] = None, rx=None,
    split: Optional["torch.cuda.Event"] = None,
) -> tuple:
    """The verdict lowering (the JAX ``eval_verdicts``, full) of slot
    planes ``value_bits`` / ``uncertain_bits`` (bool [B, NS]) with the
    batch's ``lengths`` (int32 [B] for each of ``encoding.STREAMS``),
    ``status`` (int32 [B]), the md5 digest (int64 [B, 4]) or None (md5
    checks fail closed) and the device-regex overlay ``rx`` ((value,
    unc) bool [B, NRXM]) or None → (t_value, t_unc, op_value, op_unc,
    m_value, m_unc) bool planes, m_value None unless the corpus has
    workflow gates (``layout.has_gates``). ``layout`` is the corpus's
    ``match.VerdictLayout`` on the same device. On the card a call is two
    launches, the pack of the planes into row-sliced words and the
    evaluation, and its launch count adds both; ``split``, a created
    CUDA event, is recorded on the stream between them (for timing each
    launch with events)."""
    from swarm_tpu_torch.ops.encoding import STREAMS
    from swarm_tpu_torch.ops.match import CHECK_SOURCES

    _record("match_verdicts", (layout, value_bits, uncertain_bits, lengths, status,
                               md5_digest, rx))
    device = value_bits.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if layout.device != device:
        raise ValueError(f"the layout is on {layout.device}, the planes on {device}")
    _need(value_bits, torch.bool, "value_bits", device)
    _need(uncertain_bits, torch.bool, "uncertain_bits", device)
    rows = value_bits.shape[0]
    if value_bits.dim() != 2 or value_bits.shape[1] < 1 or uncertain_bits.shape != value_bits.shape:
        raise ValueError(f"slot planes {tuple(value_bits.shape)} / {tuple(uncertain_bits.shape)}")
    _need(status, torch.int32, "status", device)
    for name in STREAMS:
        _need(lengths[name], torch.int32, f"lengths[{name!r}]", device)
    if status.shape != (rows,) or any(lengths[n].shape != (rows,) for n in STREAMS):
        raise ValueError("status and every stream's lengths must be [B]")
    if md5_digest is not None:
        _need(md5_digest, torch.int64, "md5_digest", device)
        if md5_digest.shape != (rows, 4):
            raise ValueError(f"md5_digest must be [B, 4], got {tuple(md5_digest.shape)}")
    if rx is not None:
        for name, plane in zip(("rx_value", "rx_unc"), rx):
            _need(plane, torch.bool, name, device)
            if plane.shape != (rows, layout.n_rx):
                raise ValueError(f"{name} must be [B, {layout.n_rx}], got {tuple(plane.shape)}")
    if device.type == "cpu":
        from swarm_tpu_torch.ops.match import verdicts_plain

        return verdicts_plain(layout, value_bits, uncertain_bits, lengths, status,
                              md5_digest, rx)
    if layout.chunk_smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"the corpus's widest verdict chunk needs {layout.chunk_smem} bytes of shared "
            f"memory, more than the {MAX_SHARED_BYTES} a block may use")
    planes = tuple(
        None if n is None else torch.empty((rows, n), dtype=torch.bool, device=device)
        for n in (layout.nt, layout.nt, layout.nop, layout.nop,
                  layout.nm if layout.has_gates else None, layout.nm)
    )
    if rows == 0:
        return planes
    lib = load_library("verdicts")
    # scratch: the row-sliced words of the slot planes and the overlay
    cols = 2 * value_bits.shape[1] + (2 * layout.n_rx if rx is not None else 0)
    words = torch.empty(((rows + 31) // 32) * cols, dtype=torch.int32, device=device)
    sources = (ctypes.c_void_p * len(CHECK_SOURCES))(
        *(t.data_ptr() for t in (status if n == "status" else lengths[n] for n in CHECK_SOURCES)))
    rx_value, rx_unc = rx if rx is not None else (None, None)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(device):
        rc = lib.match_verdicts(
            ctypes.byref(layout.struct), rows, _ptr(value_bits), _ptr(uncertain_bits),
            value_bits.shape[1], sources,
            *(null if t is None else _ptr(t) for t in (md5_digest, rx_value, rx_unc, *planes)),
            _ptr(words), _stream(value_bits),
            null if split is None else ctypes.c_void_p(split.cuda_event),
        )
    _raise_on(rc, "match_verdicts")
    LAUNCHES["match_verdicts"] += 2  # the pack and the evaluation
    return planes
