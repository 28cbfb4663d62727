"""Build, bind and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` — ``cluster.cu`` (the density-peaks kernels),
``match.cu`` (phase A, the gather-verify and the regex scan of the
template match), ``md5.cu`` (the body's md5) and ``verdicts.cu`` (the
verdict lowering) — is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface at first use, and
bound with ``ctypes``. The builds go to ``swarm_tpu_torch/_build/`` and
use only the sources in the repository; the libraries can build in
parallel.

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

FP_WORDS = 16

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: library name -> (its sources, the shared library they build)
LIBRARIES = {
    "cluster": ((_CSRC / "cluster.cu",), BUILD_DIR / "libswarm_cluster.so"),
    "match": ((_CSRC / "match.cu",), BUILD_DIR / "libswarm_match.so"),
    "md5": ((_CSRC / "md5.cu",), BUILD_DIR / "libswarm_md5.so"),
    "verdicts": ((_CSRC / "verdicts.cu",), BUILD_DIR / "libswarm_verdicts.so"),
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


def _stale(sources: tuple[Path, ...], lib_path: Path) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources)


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


def build(name: str) -> float:
    """Compile library ``name`` if it is missing or older than its
    sources; → seconds spent compiling (0 when up to date)."""
    sources, lib_path = LIBRARIES[name]
    if not _stale(sources, lib_path):
        return 0.0
    t0 = time.perf_counter()
    build_logs[name] = compile_library(sources, lib_path)
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
    """'_ZN12_GLOBAL__N_121cluster_parent_kernelIjEEv...' → 'cluster_parent_kernel<uint32>',
    '..match_regex_scan_kernelILi3EEv..' → 'match_regex_scan_kernel<3>'. The
    name is the length-prefixed identifier that ends in ``_kernel``."""
    for found in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        n = int(found.group(1))
        base, rest = found.group(2)[:n], found.group(2)[n:]
        if len(base) != n or not base.endswith("_kernel"):
            continue
        args = re.match(r"I([jy])E|ILi(\d+)E", rest)
        if args is None:
            return base
        key, lanes = args.groups()
        return f"{base}<{lanes}>" if lanes else f"{base}<{'uint32' if key == 'j' else 'uint64'}>"
    return mangled


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
        lib.match_verdicts.argtypes = [vp, i32, vp, vp, i32] + [vp] * 11
        fns = (lib.match_verdicts,)
    else:
        tables = [i32, i32, vp, vp, vp, vp, vp, vp]  # rows, count, descriptors
        lib.match_phase_a.argtypes = tables + [vp, i32, i32, vp, vp, vp]
        lib.match_verify.argtypes = (
            tables + [vp, i32, i32] + [vp] * 11 + [i32, i32, i32]
            + [vp, vp, vp, vp, i32, vp]
        )
        lib.match_regex_scan.argtypes = (
            [i32, i32, vp, vp, vp, vp] + [vp] * 14 + [i32, i32, vp, vp]
        )
        fns = (lib.match_phase_a, lib.match_verify, lib.match_regex_scan)
    for fn in fns:
        fn.restype = ctypes.c_int


def load_library(name: str) -> ctypes.CDLL:
    """Build library ``name`` on first use and bind its launchers."""
    with _load_locks[name]:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(LIBRARIES[name][1]))
            _bind(name, lib)
            _libs[name] = lib
        return lib


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


def _views(views: list, device: torch.device, limit: int) -> tuple:
    """Check the stream views → host descriptor arrays (data pointers,
    length pointers, widths, lowered flags); the caller keeps them alive
    across the launch."""
    if not 1 <= len(views) <= limit:
        raise ValueError(f"{len(views)} streams, the kernels take 1..{limit}")
    rows = views[0].data.shape[0]
    for i, v in enumerate(views):
        _need(v.data, torch.uint8, f"stream {i}", device)
        _need(v.lengths, torch.int32, f"lengths {i}", device)
        if v.data.dim() != 2 or v.data.shape[0] != rows or v.lengths.shape != (rows,):
            raise ValueError(f"stream {i}: shapes {tuple(v.data.shape)} / {tuple(v.lengths.shape)}")
    return (
        np.array([v.data.data_ptr() for v in views], dtype=np.int64),
        np.array([v.lengths.data_ptr() for v in views], dtype=np.int64),
        np.array([v.data.shape[1] for v in views], dtype=np.int32),
        np.array([int(v.lowered) for v in views], dtype=np.int32),
    )


def _tables(views: list, qs, col_starts, device: torch.device) -> tuple:
    desc = _views(views, device, MATCH_MAX_TABLES)
    qs = np.ascontiguousarray(qs, dtype=np.int32)
    col_starts = np.ascontiguousarray(col_starts, dtype=np.int32)
    if qs.shape != (len(views),) or col_starts.shape != (len(views) + 1,):
        raise ValueError("one q per table and T + 1 column starts")
    if qs.min() < 1 or qs.max() > 8:
        raise ValueError("gram sizes must lie in 1..8")
    return (*desc, qs, col_starts)


def match_phase_a(
    views: list, qs, col_starts, bloom: torch.Tensor, budget: int, kclamp: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase A of the match: each table's bloom probe over every window
    of its stream, and the first ``kclamp`` fired (table, window)
    columns of each row in ascending order → (col int32 [B, budget],
    -1 past them; n_surv int32 [B], the row's count of fired windows).
    ``bloom`` is the stacked int32 [T, BLOOM_WORDS] bitmap."""
    _record("match_phase_a", (views, qs, col_starts, bloom, budget, kclamp))
    device = views[0].data.device
    if device.type == "cpu":
        from swarm_tpu_torch.ops.match import phase_a_plain

        return phase_a_plain(views, qs, col_starts, bloom, budget, kclamp)
    desc = _tables(views, qs, col_starts, device)
    _need(bloom, torch.int32, "bloom", device)
    if bloom.dim() != 2 or bloom.shape[0] < len(views):
        raise ValueError(f"bloom must be [T, words], got {tuple(bloom.shape)}")
    if not 1 <= kclamp <= budget:
        raise ValueError(f"need 1 <= kclamp ({kclamp}) <= budget ({budget})")
    rows = views[0].data.shape[0]
    col = torch.empty((rows, budget), dtype=torch.int32, device=device)
    n_surv = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows == 0:
        return col, n_surv
    lib = load_library("match")
    with torch.cuda.device(device):
        rc = lib.match_phase_a(
            rows, len(views), *map(_host, desc), _ptr(bloom), budget, kclamp,
            _ptr(col), _ptr(n_surv), _stream(bloom),
        )
    _raise_on(rc, "match_phase_a")
    LAUNCHES["match_phase_a"] += 1
    return col, n_surv


#: the stacked table arrays match_verify reads, in launcher order
VERIFY_TABLE_KEYS = (
    "group_h1", "entry_start", "entry_count", "n_groups", "entry_h2",
    "entry_slot", "entry_off", "entry_len", "entry_suf_delta",
    "entry_suf_h1", "entry_suf_h2",
)


def match_verify(
    views: list, qs, col_starts, col: torch.Tensor, kc: int, tab: dict,
    max_group: int, slot_bytes: torch.Tensor, slot_len: torch.Tensor,
    plane_width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase B's gather-verify of the candidates ``col[:, :kc]`` →
    (value bool [B, plane_width], uncertain bool [B, plane_width]) slot
    planes. ``tab`` holds the stacked tables (int32 tensors, the uint32
    ones as their bits)."""
    _record("match_verify", (views, qs, col_starts, col, kc, tab, max_group,
                             slot_bytes, slot_len, plane_width))
    device = col.device
    if device.type == "cpu":
        from swarm_tpu_torch.ops.match import verify_plain

        return verify_plain(views, qs, col_starts, col, kc, tab, max_group,
                            slot_bytes, slot_len, plane_width)
    desc = _tables(views, qs, col_starts, device)
    _need(col, torch.int32, "col", device)
    rows = views[0].data.shape[0]
    if col.dim() != 2 or col.shape[0] != rows or not 0 <= kc <= col.shape[1]:
        raise ValueError(f"col {tuple(col.shape)} cannot give {kc} columns")
    for key in VERIFY_TABLE_KEYS:
        _need(tab[key], torch.int32, key, device)
    gmax, emax = tab["group_h1"].shape[1], tab["entry_h2"].shape[1]
    _need(slot_bytes, torch.uint8, "slot_bytes", device)
    _need(slot_len, torch.int32, "slot_len", device)
    value = torch.zeros((rows, plane_width), dtype=torch.bool, device=device)
    unc = torch.zeros((rows, plane_width), dtype=torch.bool, device=device)
    if rows == 0 or kc == 0:
        return value, unc
    lib = load_library("match")
    with torch.cuda.device(device):
        rc = lib.match_verify(
            rows, len(views), *map(_host, desc), _ptr(col), col.shape[1], kc,
            *(_ptr(tab[key]) for key in VERIFY_TABLE_KEYS), gmax, emax,
            max_group, _ptr(slot_bytes), _ptr(slot_len), _ptr(value), _ptr(unc),
            plane_width, _stream(col),
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
            _ptr(word_tab), lanes, int(r_closure), _ptr(matched), _stream(pair_b),
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
    ("m_size_src", torch.int32), ("m_md5", torch.int32),
)
#: shared memory a block may use on Hopper (csrc/verdicts.cu keeps the
#: row's matcher and op planes there: 2 * (NM + NOP) bytes)
MAX_SHARED_BYTES = 232448


class VerdictLayoutC(ctypes.Structure):
    """csrc/verdicts.cu's VerdictLayout: device pointers, then counts."""

    _fields_ = [(key, ctypes.c_void_p) for key, _ in VERDICT_LAYOUT_KEYS] + [
        (key, ctypes.c_int32) for key in ("nm", "nop", "nt", "n_conj", "n_status", "n_rx")
    ]


def verdict_struct(layout) -> VerdictLayoutC:
    """The kernel's struct for a ``match.VerdictLayout``, made once per
    corpus (its tensors stay alive on the layout). Checks the arrays'
    dtypes, device and shapes."""
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
    n_status = csr["m_status"].shape[1]
    for key, shape in (("scalar_src", (nm, n_conj)), ("scalar_cmp", (nm, n_conj)),
                       ("scalar_mask", (nm, n_conj)), ("m_status", (nm, n_status)),
                       ("m_size", (nm, n_status)), ("m_md5", (nm, 4))):
        if csr[key].shape != shape:
            raise ValueError(f"{key} must be {list(shape)}, got {tuple(csr[key].shape)}")
    return VerdictLayoutC(
        *(csr[key].data_ptr() for key, _ in VERDICT_LAYOUT_KEYS),
        nm, nop, nt, n_conj, n_status, layout.n_rx,
    )


def match_verdicts(
    layout, value_bits: torch.Tensor, uncertain_bits: torch.Tensor, lengths: dict,
    status: torch.Tensor, md5_digest: Optional[torch.Tensor] = None, rx=None,
) -> tuple:
    """The verdict lowering (the JAX ``eval_verdicts``, full) of slot
    planes ``value_bits`` / ``uncertain_bits`` (bool [B, NS]) with the
    batch's ``lengths`` (int32 [B] for each of ``encoding.STREAMS``),
    ``status`` (int32 [B]), the md5 digest (int64 [B, 4]) or None (md5
    checks fail closed) and the device-regex overlay ``rx`` ((value,
    unc) bool [B, NRXM]) or None → (t_value, t_unc, op_value, op_unc,
    m_value, m_unc) bool planes, m_value None unless the corpus has
    workflow gates (``layout.has_gates``). ``layout`` is the corpus's
    ``match.VerdictLayout`` on the same device."""
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
    smem = 2 * (layout.nm + layout.nop)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"{layout.nm} matchers and {layout.nop} ops need {smem} bytes of shared "
            f"memory a row, more than the {MAX_SHARED_BYTES} a block may use")
    planes = tuple(
        None if n is None else torch.empty((rows, n), dtype=torch.bool, device=device)
        for n in (layout.nt, layout.nt, layout.nop, layout.nop,
                  layout.nm if layout.has_gates else None, layout.nm)
    )
    if rows == 0:
        return planes
    lib = load_library("verdicts")
    sources = (ctypes.c_void_p * len(CHECK_SOURCES))(
        *(t.data_ptr() for t in (status if n == "status" else lengths[n] for n in CHECK_SOURCES)))
    rx_value, rx_unc = rx if rx is not None else (None, None)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(device):
        rc = lib.match_verdicts(
            ctypes.byref(layout.struct), rows, _ptr(value_bits), _ptr(uncertain_bits),
            value_bits.shape[1], sources,
            *(null if t is None else _ptr(t) for t in (md5_digest, rx_value, rx_unc, *planes)),
            _stream(value_bits),
        )
    _raise_on(rc, "match_verdicts")
    LAUNCHES["match_verdicts"] += 1
    return planes
