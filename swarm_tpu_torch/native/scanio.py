"""ctypes bindings of the native scan I/O engine (``native/scanio.cpp``)
and of the engine's Python-aware batch passes (``native/fastpack.cpp``).

libscanio: the probe front-end's calls, ``swarm_tcp_scan_tls``
(epoll-driven batch connect + payload + banner grab, each target
plaintext or TLS-wrapped with its SNI), ``swarm_tls_available`` and
``swarm_dns_resolve`` (bulk UDP A-record resolution). Its CDLL calls
release the GIL.

libfastpack: the match engine's host passes over ``Response`` lists —
alive split, content dedup, row metadata and packing, the resident
verdict memo, the set-bit enumeration of a verdict plane, the
extraction driver and the batched word confirm. It is loaded with
``ctypes.PyDLL`` and HOLDS the GIL (it walks Python objects), except
in ``sw_rows_pack`` and ``sw_confirm_needles_batch``, which release it.

Both libraries are built from the repository's ``native/`` sources
with ``make`` at first use (and again when the source is newer), into
``swarm_tpu_torch/_build/``, so that the port never rewrites a library
another process may be loading. A failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

STATUS_OPEN = 0
STATUS_CLOSED = 1
STATUS_TIMEOUT = 2
STATUS_ERROR = 3

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_SOURCE = _NATIVE_DIR / "scanio.cpp"
_LIB_PATH = _BUILD_DIR / "libscanio.so"
_FASTPACK_SOURCE = _NATIVE_DIR / "fastpack.cpp"
_FASTPACK_PATH = _BUILD_DIR / "libfastpack.so"
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _load_lock
_fastpack: Optional[ctypes.PyDLL] = None  # guarded-by: _load_lock
# first use can come from several walk-pool threads at once: each
# build and each dlopen happens exactly once
_load_lock = threading.Lock()


def build_native(var: str, path: Path, source: Path) -> Path:
    """``make`` one library of ``native/Makefile`` (``var`` names its
    target variable: TARGET, FASTPACK or CREX) into a private file,
    then rename it into ``path``; skipped while ``path`` is newer than
    ``source``. The interpreter's own headers are passed as ``PY``:
    libfastpack bakes in PyObject layouts."""
    if path.exists() and path.stat().st_mtime >= source.stat().st_mtime:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(
        ["make", "-C", str(_NATIVE_DIR), f"PY={sys.executable}",
         f"{var}={tmp}", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building {path.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def ensure_lib() -> ctypes.CDLL:
    """Load libscanio, building it on first use (or when the source is
    newer than the library). Thread-safe."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native("TARGET", _LIB_PATH, _SOURCE)))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.swarm_tcp_scan_tls.argtypes = [
            u32p, u16p, i32,              # ips, ports, n
            u8p, i64p, i32p, i32p,        # payload blob/off/len, pay_idx
            i8p, u8p, i32p, i32p,         # tls_mask, sni blob/off/len
            i32, i32, i32, i32,           # conc, connect_to, read_to, cap
            u8p, i32p, i8p, i32p,         # banners, blens, status, rtt
        ]
        lib.swarm_tcp_scan_tls.restype = i32
        lib.swarm_tls_available.argtypes = []
        lib.swarm_tls_available.restype = i32
        lib.swarm_dns_resolve.argtypes = [
            u8p, i32p, i32p, i32,         # names, off, len, n
            u32p, i32, i32,               # resolvers, nres, port
            i32, i32, i32,                # timeout, retries, max_addrs
            u32p, i32p, i8p,              # addrs, naddrs, status
        ]
        lib.swarm_dns_resolve.restype = i32
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# Python-aware batch passes (libfastpack.so via PyDLL — GIL held, the
# functions walk the Response and bytes lists directly: no per-element
# conversions).
# ---------------------------------------------------------------------------


def ensure_fastpack() -> ctypes.PyDLL:
    """Load libfastpack, building it on first use (or when
    ``fastpack.cpp`` is newer than the library). Thread-safe like
    :func:`ensure_lib` (one dlopen, ever)."""
    global _fastpack
    if _fastpack is not None:
        return _fastpack
    with _load_lock:
        if _fastpack is not None:
            return _fastpack
        lib = ctypes.PyDLL(str(build_native("FASTPACK", _FASTPACK_PATH, _FASTPACK_SOURCE)))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        upp = np.ctypeslib.ndpointer(np.uintp, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        i64 = ctypes.c_int64
        obj = ctypes.py_object
        vp = ctypes.c_void_p
        sigs = {
            "sw_pack_list": ([obj, i32, u8p, i64p], ctypes.c_int),
            "sw_concat3_list": ([obj, obj, u8p, i32, u8p], ctypes.c_int),
            "sw_rows_meta": ([obj, i64p, i64p, i32p, u8p, upp, upp], ctypes.c_int),
            "sw_rows_pack": ([i64, upp, i64p, upp, i64p, u8p,
                              i32, u8p, i32, u8p, i32, u8p], ctypes.c_int),
            "sw_rows_dedup": ([obj, i64p, i64p], i64),
            "sw_rows_alive": ([obj, u8p], i64),
            "sw_memo_new": ([i64, i32], vp),
            "sw_memo_free": ([vp], None),
            "sw_memo_clear": ([vp], None),
            "sw_memo_len": ([vp], i64),
            "sw_memo_contains": ([vp, obj], ctypes.c_int),
            "sw_memo_contains_batch": ([vp, obj, u8p], i64),
            "sw_memo_insert": ([vp, obj, u8p, obj], ctypes.c_int),
            "sw_memo_insert_batch": ([vp, obj, u8p, u8p, obj], i64),
            "sw_memo_lookup": ([vp, obj, u8p, i64p, i64p, obj, obj], i64),
            "sw_plane_bits": ([u8p, i64, i64, i64, i64p, i64p, i64], i64),
            "sw_ext_resolve": ([u8p, i64, i64, i64, u8p, u8p, i64p, i64p, u8p, u8p,
                                i64, i64p, i64p, i64p, u8p, i64], i64),
            "sw_confirm_needles_batch": ([obj, u8p, i64p, i32, i32, i32, u8p], ctypes.c_int),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _fastpack = lib
        return lib


def pack_list(parts: list, width: int, out: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Pack a bytes list into the zero-prefilled padded matrix ``out``;
    writes each row's FULL (pre-clip) length into ``lens``."""
    if ensure_fastpack().sw_pack_list(parts, np.int32(width), out, lens) != 0:
        raise TypeError("parts must be a list of bytes")
    return lens


def rows_meta(
    rows: list,
    blens: np.ndarray,
    hlens: np.ndarray,
    status: np.ndarray,
    concat: np.ndarray,
    bptr: np.ndarray,
    hptr: np.ndarray,
) -> bool:
    """One C pass over the Response list: body/header lengths
    (banner-aliased, matching model.Response.part()), status codes, the
    per-row concat flag, and the raw byte pointers of each part
    (``bptr``/``hptr``, np.uintp) for :func:`rows_pack`. The pointers
    are owned by the rows — keep the list untouched until packing is
    done. Returns True when any row carries OOB interaction data."""
    rc = ensure_fastpack().sw_rows_meta(rows, blens, hlens, status, concat, bptr, hptr)
    if rc < 0:
        raise TypeError("rows must be Response objects with bytes parts")
    return bool(rc)


def rows_pack(
    n: int,
    bptr: np.ndarray,
    blens: np.ndarray,
    hptr: np.ndarray,
    hlens: np.ndarray,
    concat: np.ndarray,
    wb: int,
    body_out: np.ndarray,
    wh: int,
    header_out: np.ndarray,
    wa: int,
    all_out: np.ndarray,
) -> None:
    """Pack body/header/'all' matrices from the pointers
    :func:`rows_meta` cached, writing every byte of every row
    (payload + zero tail) — output buffers may be dirty/recycled.
    Pure memcpy with the GIL released. ``wa`` 0 skips 'all'."""
    ensure_fastpack().sw_rows_pack(
        np.int64(n), bptr, blens, hptr, hlens, concat,
        np.int32(wb), body_out, np.int32(wh), header_out,
        np.int32(wa), all_out,
    )


def rows_dedup(rows: list) -> "tuple[np.ndarray, np.ndarray]":
    """Content-dedup a list of Response rows in one C pass, keyed
    exactly as ``engine._content_key`` (exact compare on banner, body,
    header, status and the oob fields; the internal hash only picks
    buckets). Returns ``(uniq, back)``: ``uniq[s]`` is the first row
    index of unique slot s, ``back[i]`` the slot of row i."""
    n = len(rows)
    back = np.empty(n, dtype=np.int64)
    uniq = np.empty(n, dtype=np.int64)
    nu = ensure_fastpack().sw_rows_dedup(rows, back, uniq)
    if nu < 0:
        raise TypeError("rows must be Response objects with bytes parts")
    return uniq[:nu], back


def rows_alive(rows: list) -> "tuple[int, np.ndarray]":
    """(alive_count, uint8 mask) in one C pass over Response rows."""
    mask = np.empty(len(rows), dtype=np.uint8)
    n = ensure_fastpack().sw_rows_alive(rows, mask)
    if n < 0:
        raise TypeError("rows must be Response objects")
    return int(n), mask


def concat3_list(
    headers: list, bodies: list, concat: np.ndarray, width: int,
    out: np.ndarray,
) -> None:
    """Assemble the 'all' stream (header + CRLF + body, or body alone
    when ``concat[i]`` is 0) straight from the bytes lists."""
    if (
        ensure_fastpack().sw_concat3_list(
            headers, bodies, concat, np.int32(width), out
        )
        != 0
    ):
        raise TypeError("headers/bodies must be matching lists of bytes")


def _check_extras(extras) -> None:
    # the lookup pass unpacks extras as (ment, mdef) in C — reject
    # other shapes at the call that supplied them (a later lookup
    # would fail far from the cause)
    if extras is not None and not (
        isinstance(extras, tuple)
        and len(extras) == 2
        and isinstance(extras[0], tuple)
        and isinstance(extras[1], tuple)
    ):
        raise ValueError("extras must be a (ment, mdef) tuple pair or None")


class VerdictMemo:
    """Resident verdict cache (native/fastpack.cpp): content-keyed LRU
    whose lookup pass serves known rows by memcpy into the batch's
    verdict plane and in-batch-dedups the misses — the steady-state hot
    path of the exact engine with no per-row Python work for known
    content. Key semantics are exactly engine._content_key's (full
    compare; the internal hash only routes). Single-threaded per
    instance under the GIL (PyDLL)."""

    def __init__(self, capacity: int, row_bytes: int):
        self._lib = ensure_fastpack()
        self.row_bytes = int(row_bytes)
        self.capacity = int(capacity)
        self._h = self._lib.sw_memo_new(np.int64(capacity), np.int32(row_bytes))
        if not self._h:
            raise MemoryError("sw_memo_new failed")

    def lookup(self, rows: list, bits_out: np.ndarray):
        """Serve known rows into ``bits_out`` ([n, row_bytes], any prior
        content — served and dead rows are fully overwritten, miss rows
        are NOT touched). Returns
        ``(state, miss_uniq, extractions, deferred)``:
        ``state[i]`` is -1 for a memo-served row, -2 for a DEAD row
        (``alive`` falsy — zero verdicts written, no memo traffic),
        else its miss-slot id; ``miss_uniq[s]`` is the first row index
        of miss slot s. Served rows' extras come back APPLIED:
        ``extractions`` is ``{(row, tid): thawed-list}`` (fresh lists —
        callers may mutate) and ``deferred`` the ``(row, t_idx)``
        row-dependent template pairs."""
        n = len(rows)
        state = np.empty(n, dtype=np.int64)
        miss_uniq = np.empty(max(n, 1), dtype=np.int64)
        extractions: dict = {}
        deferred: list = []
        nm = self._lib.sw_memo_lookup(
            self._h, rows, bits_out, state, miss_uniq, extractions, deferred,
        )
        if nm < 0:
            raise TypeError("rows must be Response objects")
        return state, miss_uniq[:nm].tolist(), extractions, deferred

    def insert(self, row, bits_row: np.ndarray, extras) -> None:
        """Insert one row's verdict bits and its ``(ment, mdef)`` extras
        (or None)."""
        _check_extras(extras)
        if self._lib.sw_memo_insert(self._h, row, bits_row, extras) != 0:
            raise TypeError("memo insert failed")

    def insert_batch(
        self, rows: list, bits_plane: np.ndarray, skip: np.ndarray, extras_list: list,
    ) -> int:
        """Insert every non-skipped row of a walked plane in ONE native
        call (row i's bits at ``bits_plane[i]``). ``extras_list[i]`` is
        the (ment, mdef) tuple or None. Returns the inserted count."""
        if len(rows) != len(extras_list) or len(rows) != len(skip):
            raise ValueError("rows/skip/extras_list length mismatch")
        if (
            bits_plane.dtype != np.uint8
            or bits_plane.ndim != 2
            or bits_plane.shape[0] < len(rows)
            or bits_plane.shape[1] != self.row_bytes
        ):
            raise ValueError(f"bits_plane must be uint8 [>={len(rows)}, {self.row_bytes}]")
        for extras in extras_list:
            _check_extras(extras)
        bits_plane = np.ascontiguousarray(bits_plane)
        n = self._lib.sw_memo_insert_batch(self._h, rows, bits_plane, skip, extras_list)
        if n < 0:
            raise TypeError("memo batch insert failed")
        return int(n)

    def contains_batch(self, rows: list) -> np.ndarray:
        """uint8 mask: ``mask[i]`` nonzero iff ``rows[i]``'s content is
        resident — one native call, no LRU side effects."""
        mask = np.zeros(max(len(rows), 1), dtype=np.uint8)
        if rows and self._lib.sw_memo_contains_batch(self._h, rows, mask) < 0:
            raise TypeError("rows must be Response objects")
        return mask[: len(rows)]

    def contains(self, row) -> bool:
        rc = self._lib.sw_memo_contains(self._h, row)
        if rc < 0:
            raise TypeError("row must be a Response object")
        return bool(rc)

    def clear(self) -> None:
        self._lib.sw_memo_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.sw_memo_len(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sw_memo_free(h)
            self._h = None


def plane_bits(plane: np.ndarray, limit: int):
    """(rows, bits) index arrays of the set bits of a packed uint8
    [n, nb] plane (MSB-first, bit < limit), row-major — one C pass."""
    plane = np.ascontiguousarray(plane)
    lib = ensure_fastpack()
    cap = max(256, 2 * int(np.count_nonzero(plane)) * 8)
    while True:
        rs = np.empty(cap, dtype=np.int64)
        ts = np.empty(cap, dtype=np.int64)
        n = lib.sw_plane_bits(plane, plane.shape[0], plane.shape[1], limit, rs, ts, cap)
        if n >= 0:
            return rs[:n], ts[:n]
        cap *= 4


def ext_resolve(
    masked: np.ndarray,
    limit: int,
    rowdep: np.ndarray,
    skip_rows: np.ndarray,
    indptr: np.ndarray,
    opids: np.ndarray,
    pop_value: np.ndarray,
    pop_unc: np.ndarray,
):
    """(rows, templates, op_ids, states) for every extractor-plane hit
    whose op needs Python work — state 1 certainly-true (extract),
    state 2 undecided (resolve first). One C pass (sw_ext_resolve);
    the planes are copied row-major when they are not."""
    masked = np.ascontiguousarray(masked)
    pop_value = np.ascontiguousarray(pop_value)
    pop_unc = np.ascontiguousarray(pop_unc)
    lib = ensure_fastpack()
    cap = max(256, 16 * int(np.count_nonzero(masked)))
    while True:
        bs = np.empty(cap, dtype=np.int64)
        ts = np.empty(cap, dtype=np.int64)
        ops = np.empty(cap, dtype=np.int64)
        states = np.empty(cap, dtype=np.uint8)
        n = lib.sw_ext_resolve(
            masked, masked.shape[0], masked.shape[1], limit, rowdep,
            skip_rows, indptr, opids, pop_value, pop_unc,
            pop_value.shape[1], bs, ts, ops, states, cap,
        )
        if n >= 0:
            return bs[:n], ts[:n], ops[:n], states[:n]
        cap *= 4


def confirm_needles_batch(
    parts: list, needles: "list[bytes]", ci: bool, cond_and: bool,
) -> np.ndarray:
    """Raw (pre-negation) and/or-combined needle verdicts of ONE
    word/binary matcher over a list of part bytes — one C pass with
    the GIL released (the walk's batched confirm). ``needles`` must be
    pre-lowered when ``ci`` (bytes.lower() semantics) and not empty
    (the oracle defines that as False before the combine — the caller
    handles it). Returns a uint8 verdict array."""
    if not needles:
        raise ValueError("confirm_needles_batch needs at least one needle")
    n = len(parts)
    offs = np.zeros(len(needles) + 1, dtype=np.int64)
    np.cumsum([len(nd) for nd in needles], out=offs[1:])
    blob = np.frombuffer(b"".join(needles) or b"\0", dtype=np.uint8)
    out = np.empty(max(n, 1), dtype=np.uint8)
    if ensure_fastpack().sw_confirm_needles_batch(
        parts, blob, offs, len(needles), 1 if ci else 0, 1 if cond_and else 0, out,
    ) != 0:
        raise TypeError("parts must be a list of bytes")
    return out[:n]


@dataclasses.dataclass
class ScanResult:
    """Flat-buffer result of one tcp_scan batch (row i ↔ target i)."""

    banners: np.ndarray   # uint8 [n, banner_cap]
    banner_len: np.ndarray  # int32 [n]
    status: np.ndarray    # int8 [n] — STATUS_*
    rtt_us: np.ndarray    # int32 [n], -1 if never connected

    def banner(self, i: int) -> bytes:
        return self.banners[i, : self.banner_len[i]].tobytes()

    @property
    def open_mask(self) -> np.ndarray:
        return self.status == STATUS_OPEN


def parse_ipv4(hosts: Sequence[str]) -> np.ndarray:
    """Dotted-quad strings → uint32 network-order array."""
    out = np.empty(len(hosts), dtype=np.uint32)
    for i, h in enumerate(hosts):
        out[i] = struct.unpack("=I", socket.inet_aton(h))[0]
    return out


def format_ipv4(addrs: np.ndarray) -> list[str]:
    return [socket.inet_ntoa(struct.pack("=I", int(a))) for a in addrs]


def tls_available() -> bool:
    """Whether libssl could be loaded (TLS-wrapped probing works)."""
    return bool(ensure_lib().swarm_tls_available())


def tcp_scan(
    ips: np.ndarray | Sequence[str],
    ports: np.ndarray | Sequence[int],
    payloads: Optional[Sequence[Optional[bytes]]] = None,
    *,
    tls: Optional[Sequence[bool]] = None,
    sni: Optional[Sequence[Optional[str]]] = None,
    max_concurrency: int = 512,
    connect_timeout_ms: int = 1500,
    read_timeout_ms: int = 2000,
    banner_cap: int = 4096,
) -> ScanResult:
    """Batch TCP connect scan + banner/payload probe.

    ``payloads[i]`` (optional) is written right after connect — an HTTP
    request for httpx-style probing, a protocol nudge for banner
    grabbing, or None to listen silently (nmap-style banner wait).
    ``tls[i]`` wraps target i in TLS first (payload sent and banner read
    through the encrypted channel); ``sni[i]`` sets its SNI hostname.
    Targets where the handshake fails report STATUS_TLS_FAILED.
    """
    lib = ensure_lib()
    if len(ips) and isinstance(ips[0], str):
        ips = parse_ipv4(ips)  # type: ignore[arg-type]
    ips = np.ascontiguousarray(ips, dtype=np.uint32)
    ports_a = np.ascontiguousarray(ports, dtype=np.uint16)
    n = ips.shape[0]
    if ports_a.shape[0] != n:
        raise ValueError("ips and ports must be the same length")

    # dedupe payloads into one blob
    pay_idx = np.full(n, -1, dtype=np.int32)
    blob_parts: list[bytes] = []
    offsets: list[int] = []
    lens: list[int] = []
    seen: dict[bytes, int] = {}
    total = 0
    if payloads is not None:
        for i, p in enumerate(payloads):
            if not p:
                continue
            idx = seen.get(p)
            if idx is None:
                idx = len(offsets)
                seen[p] = idx
                offsets.append(total)
                lens.append(len(p))
                blob_parts.append(p)
                total += len(p)
            pay_idx[i] = idx
    blob = np.frombuffer(b"".join(blob_parts) or b"\0", dtype=np.uint8).copy()
    pay_off = np.asarray(offsets or [0], dtype=np.int64)
    pay_len = np.asarray(lens or [0], dtype=np.int32)

    # TLS mask + SNI name blob
    tls_mask = np.zeros(n, dtype=np.int8)
    if tls is not None:
        tls_mask[: len(tls)] = [1 if t else 0 for t in tls]
    sni_parts: list[bytes] = []
    sni_off = np.zeros(n, dtype=np.int32)
    sni_len = np.zeros(n, dtype=np.int32)
    stotal = 0
    if sni is not None:
        for i, name in enumerate(sni):
            if not name:
                continue
            try:
                enc = (
                    name.encode("idna")
                    if any(ord(c) > 127 for c in name)
                    else name.encode("ascii")
                )
            except UnicodeError:
                continue  # unencodable label → probe without SNI
            sni_off[i] = stotal
            sni_len[i] = len(enc)
            sni_parts.append(enc)
            stotal += len(enc)
    sni_blob = np.frombuffer(b"".join(sni_parts) or b"\0", dtype=np.uint8).copy()

    banners = np.zeros((n, banner_cap), dtype=np.uint8)
    blens = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int8)
    rtt = np.zeros(n, dtype=np.int32)
    if n:
        rc = lib.swarm_tcp_scan_tls(
            ips, ports_a, n,
            blob, pay_off, pay_len, pay_idx,
            tls_mask, sni_blob, sni_off, sni_len,
            max_concurrency, connect_timeout_ms, read_timeout_ms, banner_cap,
            banners, blens, status, rtt,
        )
        if rc != 0:
            raise OSError(f"swarm_tcp_scan failed (rc={rc})")
    return ScanResult(banners=banners, banner_len=blens, status=status, rtt_us=rtt)


@dataclasses.dataclass
class DnsResult:
    addrs: np.ndarray    # uint32 [n, max_addrs] network order
    naddrs: np.ndarray   # int32 [n]
    status: np.ndarray   # int8 [n]

    def addresses(self, i: int) -> list[str]:
        return format_ipv4(self.addrs[i, : self.naddrs[i]])


def _encode_name(s: str) -> bytes:
    """Hostname → DNS wire-ready bytes; b'' for unencodable names (the
    native layer reports those as an error rather than failing the wave)."""
    if not s:
        return b""
    s = s.rstrip(".")
    try:
        return s.encode("ascii")
    except UnicodeEncodeError:
        pass
    try:
        return s.encode("idna")
    except UnicodeError:
        return b""


def dns_resolve(
    names: Sequence[str],
    resolvers: Sequence[str],
    *,
    resolver_port: int = 53,
    timeout_ms: int = 2000,
    retries: int = 2,
    max_addrs: int = 8,
    wave: int = 50_000,
) -> DnsResult:
    """Bulk A-record resolution against a resolver pool.

    Waves of ≤50k keep inside the 16-bit DNS id namespace per socket.
    """
    lib = ensure_lib()
    n = len(names)
    addrs = np.zeros((max(n, 1), max_addrs), dtype=np.uint32)
    naddrs = np.zeros(max(n, 1), dtype=np.int32)
    status = np.zeros(max(n, 1), dtype=np.int8)
    res = parse_ipv4(list(resolvers))
    for start in range(0, n, wave):
        sub = names[start : start + wave]
        encoded = [_encode_name(s) for s in sub]
        blob = np.frombuffer(b"".join(encoded) or b"\0", dtype=np.uint8).copy()
        offs = np.zeros(len(sub), dtype=np.int32)
        lens = np.zeros(len(sub), dtype=np.int32)
        pos = 0
        for i, e in enumerate(encoded):
            offs[i] = pos
            lens[i] = len(e)
            pos += len(e)
        sub_addrs = np.zeros((len(sub), max_addrs), dtype=np.uint32)
        sub_naddrs = np.zeros(len(sub), dtype=np.int32)
        sub_status = np.zeros(len(sub), dtype=np.int8)
        rc = lib.swarm_dns_resolve(
            blob, offs, lens, len(sub),
            res, len(res), resolver_port,
            timeout_ms, retries, max_addrs,
            sub_addrs, sub_naddrs, sub_status,
        )
        if rc != 0:
            raise OSError(f"swarm_dns_resolve failed (rc={rc})")
        addrs[start : start + len(sub)] = sub_addrs
        naddrs[start : start + len(sub)] = sub_naddrs
        status[start : start + len(sub)] = sub_status
    return DnsResult(addrs=addrs[:n], naddrs=naddrs[:n], status=status[:n])
