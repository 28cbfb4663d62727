"""ctypes driver for the native crex regex VM (native/crex.cpp).

CDLL (not PyDLL): every call releases the GIL, so extraction work can
shard across host threads with true parallelism. Programs come from
ops/crexc.compile_crex; text is raw part bytes (the latin-1
correspondence the whole match stack uses).

Call-path design: ctypes argument marshalling dominates at these call
rates — ndpointer argtype validation plus numpy-scalar conversion
measured ~26 us/call vs ~4 us with raw pre-bound pointers — so the
program/mask pointers are cached on the program object and all scalars
cross as plain ints / c_int64.

The library is built from the repository's ``native/crex.cpp`` with
``make`` at first use into ``swarm_tpu_torch/_build/`` (as libscanio
and libfastpack are, ``native/scanio.py``); a failed build, or a
library whose ABI version is not the compiler's, raises.

Finditer/search return None on resource exhaustion (step budget, frame
stack, span cap overflow) — the caller must fall back to Python ``re``
for that (pattern, content) pair; exactness is never traded for speed.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from swarm_tpu_torch.native.scanio import _BUILD_DIR, _NATIVE_DIR, build_native

_SOURCE = _NATIVE_DIR / "crex.cpp"
_LIB_PATH = _BUILD_DIR / "libcrex.so"

_lib: Optional[ctypes.CDLL] = None  # guarded-by: _load_lock
# first use can come from several walk-pool threads at once: the make
# invocation and the CDLL load must happen exactly once
_load_lock = threading.Lock()

STEP_BUDGET = 4_000_000  # per finditer/search call, then fallback
_BUDGET = ctypes.c_int64(STEP_BUDGET)

#: budget exhaustions tolerated per program before the VM stops being
#: tried for that pattern — burning the full step budget costs real
#: time (tens to hundreds of ms) per call before the exact re
#: fallback runs, so a pattern that keeps blowing up (catastrophic
#: backtracking shapes) must not pay that tax on every row. Cheap
#: frame/trail-stack overflows (content-size-driven, ~0.1 ms, C code
#: -4) deliberately do NOT count: short contents still run natively.
MAX_BUDGET_FAILS = 3


def usable(cp) -> bool:
    """Whether the native VM should still be tried for this program."""
    return cp is not None and getattr(cp, "_budget_fails", 0) < MAX_BUDGET_FAILS


def _note_budget_fail(cp) -> None:
    cp._budget_fails = getattr(cp, "_budget_fails", 0) + 1


def ensure_crex() -> ctypes.CDLL:
    """Load libcrex, building it on first use (or when ``crex.cpp`` is
    newer than the library). Thread-safe: concurrent first calls
    serialize on _load_lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native("CREX", _LIB_PATH, _SOURCE)))
        # ABI handshake: the opcode numbering of the compiler
        # (ops/crexc.py) and of the VM must agree, or matches are wrong
        from swarm_tpu_torch.ops.crexc import CREX_ABI

        lib.sw_crex_abi.restype = ctypes.c_int32
        abi = lib.sw_crex_abi()
        if abi != CREX_ABI:
            raise RuntimeError(f"{_LIB_PATH} reports crex ABI {abi}, the compiler {CREX_ABI}")
        # no argtypes on purpose: pointers are pre-bound c_void_p, scalars
        # plain ints (see module docstring) — validation cost is the point
        lib.sw_crex_finditer.restype = ctypes.c_int64
        lib.sw_crex_finditer_batch.restype = ctypes.c_int64
        lib.sw_crex_search.restype = ctypes.c_int32
        lib.sw_crex_exists.restype = ctypes.c_int32
        lib.sw_crex_exists_batch.restype = None
        _lib = lib
        return lib


def _bind(cp) -> tuple:
    """Cache raw pointers + scalar fields on the program object.

    Published as ONE tuple attribute (atomic assignment): programs are
    shared across the extraction pool's threads via analyze()'s
    memoized PatternInfo, and a multi-attribute guard could observe a
    half-bound object. Benign if two threads race the build — both
    tuples are equivalent and either assignment wins whole."""
    bound = (
        cp.prog.ctypes.data_as(ctypes.c_void_p),
        cp.masks.ctypes.data_as(ctypes.c_void_p),
        int(cp.prog.shape[0]),
    )
    cp._bound = bound
    return bound


_scratch = threading.local()


def _out_buf(need: int) -> np.ndarray:
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.shape[0] < need:
        buf = np.empty(max(need, 4096), dtype=np.int32)
        _scratch.buf = buf
        _scratch.ptr = buf.ctypes.data_as(ctypes.c_void_p)
    return buf


def finditer_spans(cp, data: bytes, group: int) -> Optional[list]:
    """(start, end) span per match of ``group`` (0 = whole match;
    unparticipated -> (-1, -1)), exactly re.finditer order — or None
    when the native path can't answer (caller falls back to re)."""
    lib = ensure_crex()
    pp, mp, nprog = getattr(cp, "_bound", None) or _bind(cp)
    # unknown group index -> whole match (re.finditer IndexError
    # semantics, mirrored by fastre.finditer_values' except clause)
    g2 = 2 * group if group and group in cp.group_exists else 0
    # realistic match counts are tiny: start from a small cap and grow
    # on the -3 overflow return (mirrors finditer_spans_batch) instead
    # of pre-sizing for the ~16x-content-size theoretical worst case —
    # the per-thread scratch persists, so worst-case pre-sizing left a
    # lasting RSS spike per pool thread on multi-MB parts. The hard
    # ceiling (one empty + one non-empty match per position, plus the
    # trailing empty) bounds the retry loop.
    hard_cap = 2 * len(data) + 3
    cap = min(4096, hard_cap)
    while True:
        out = _out_buf(2 * cap)
        n = lib.sw_crex_finditer(
            pp, nprog, mp, data, len(data), g2, cp.n_saves,
            _scratch.ptr, ctypes.c_int64(cap), _BUDGET,
        )
        if n == -3 and cap < hard_cap:
            cap = min(cap * 4, hard_cap)
            continue
        break
    if n < 0:
        if n == -2:
            _note_budget_fail(cp)
        return None
    flat = out[: 2 * n].tolist()
    return list(zip(flat[0::2], flat[1::2]))


def finditer_spans_batch(cp, parts: "list[bytes]", group: int) -> list:
    """Per-item span lists for ONE pattern over many contents — one
    GIL-released dispatch for the whole batch. Items that did not
    complete natively come back as None entries — the caller must
    re-run exactly those under Python ``re``. A step-budget blowup on
    one item bails the REST of the batch too (all later items None,
    not attempted: burning a fresh budget per item inside one call
    would block the pool for minutes); cheap frame/trail overflows
    only fail their own item."""
    lib = ensure_crex()
    if not parts:
        return []
    pp, mp, nprog = getattr(cp, "_bound", None) or _bind(cp)
    g2 = 2 * group if group and group in cp.group_exists else 0
    n = len(parts)
    datas = (ctypes.c_char_p * n)(*parts)
    lens = np.fromiter((len(p) for p in parts), dtype=np.int32, count=n)
    counts = np.empty(n, dtype=np.int64)
    lens_p = lens.ctypes.data_as(ctypes.c_void_p)
    counts_p = counts.ctypes.data_as(ctypes.c_void_p)
    cap = 4096
    while True:
        out = np.empty(2 * cap, dtype=np.int32)
        total = lib.sw_crex_finditer_batch(
            pp, nprog, mp, datas, lens_p, n, g2, cp.n_saves,
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
            counts_p, _BUDGET,
        )
        if total == -3:
            cap *= 4
            continue
        break
    flat = out[: 2 * total].tolist()
    res: list = []
    off = 0
    budget_fail = False
    for c in counts.tolist():
        if c < 0:
            budget_fail = budget_fail or c == -2
            res.append(None)
            continue
        res.append(
            list(zip(flat[2 * off : 2 * (off + c) : 2],
                     flat[2 * off + 1 : 2 * (off + c) : 2]))
        )
        off += c
    if budget_fail:
        _note_budget_fail(cp)  # once per call, not per item
    return res


def _dfa_handle(cp, lib, pp, mp, nprog) -> int:
    """The program's lazy-DFA context handle (0 = doesn't qualify),
    built once and cached on the program object. A racing second
    build constructs one redundant context; attribute assignment is
    atomic and both get finalizers, so neither leaks."""
    dfa = getattr(cp, "_dfa", None)
    if dfa is None:
        lib.sw_crex_dfa_new.restype = ctypes.c_void_p
        dfa = lib.sw_crex_dfa_new(pp, nprog, mp) or 0
        if dfa:
            # the context must die WITH the program object: a program
            # from a saturated compile cache is throwaway, and an
            # orphaned context would leak its state tables
            import weakref

            weakref.finalize(cp, lib.sw_crex_dfa_free,
                             ctypes.c_void_p(dfa))
        cp._dfa = dfa
    return dfa


def exists(cp, data: bytes) -> Optional[bool]:
    """Linear-time ``re.search(pattern, text) is not None``. ``cp``
    must come from crexc.compile_crex_nfa (counter-free).

    Two native tiers, both exact and budget-free: the lazy DFA
    (subset construction with byte equivalence classes, built once
    per pattern and cached on the program object — ~ns/byte steady
    state) for anchor-free programs, then the bitset Thompson scan
    (O(len x program)) for the rest or when the DFA hits its state
    cap. Returns None when there is no program or it isn't simulable
    (caller falls back)."""
    if cp is None:
        return None
    lib = ensure_crex()
    pp, mp, nprog = getattr(cp, "_bound", None) or _bind(cp)
    dfa = _dfa_handle(cp, lib, pp, mp, nprog)
    if dfa:
        rc = lib.sw_crex_dfa_exists(ctypes.c_void_p(dfa), data, len(data))
        if rc >= 0:
            return bool(rc)
    rc = lib.sw_crex_exists(pp, nprog, mp, data, len(data))
    if rc < 0:
        return None
    return bool(rc)


def exists_batch(cp, parts: "list[bytes]") -> Optional["np.ndarray"]:
    """Per-part exact ``re.search is not None`` verdicts for ONE
    counter-free program — one GIL-released dispatch for the whole
    row group (the walk's batched regex confirm; per-call dispatch
    overhead dominated at confirm rates the same way it did for
    extraction). Returns an int8 array: 1/0 exact verdict, -1 = that
    part needs the Python fallback. None when there is no program —
    caller falls back wholesale."""
    if cp is None:
        return None
    lib = ensure_crex()
    fn = lib.sw_crex_exists_batch
    n = len(parts)
    if n == 0:
        return np.zeros(0, dtype=np.int8)
    pp, mp, nprog = getattr(cp, "_bound", None) or _bind(cp)
    dfa = _dfa_handle(cp, lib, pp, mp, nprog)
    datas = (ctypes.c_char_p * n)(*parts)
    lens = np.fromiter((len(p) for p in parts), dtype=np.int32, count=n)
    out = np.empty(n, dtype=np.int8)
    fn(
        ctypes.c_void_p(dfa) if dfa else None, pp, nprog, mp, datas,
        lens.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def search(cp, data: bytes) -> Optional[bool]:
    """``re.search(pattern, text) is not None`` — or None on resource
    exhaustion (caller falls back)."""
    lib = ensure_crex()
    pp, mp, nprog = getattr(cp, "_bound", None) or _bind(cp)
    rc = lib.sw_crex_search(
        pp, nprog, mp, data, len(data), cp.n_saves, _BUDGET,
    )
    if rc < 0:
        if rc == -2:
            _note_budget_fail(cp)
        return None
    return bool(rc)


__all__ = [
    "ensure_crex", "exists", "exists_batch", "finditer_spans",
    "finditer_spans_batch", "search", "usable", "MAX_BUDGET_FAILS",
    "STEP_BUDGET",
]
