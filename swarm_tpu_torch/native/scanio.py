"""ctypes binding of the native scan I/O engine (``native/scanio.cpp``).

The port's own binding of the two calls its jarm path needs:
``swarm_tcp_scan`` (epoll-driven batch connect + payload + banner grab,
plaintext) and ``swarm_dns_resolve`` (bulk UDP A-record resolution).
The library is built from the repository's ``native/`` sources with
``make`` at first use, as the JAX package's binding builds it; this one
builds into ``swarm_tpu_torch/_build/`` so that it never rewrites a
library another process may be loading.
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
_SOURCE = _NATIVE_DIR / "scanio.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "_build" / "libscanio.so"
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _load_lock
_load_lock = threading.Lock()


def _build() -> None:
    """``make`` the scanio target of ``native/Makefile`` into a private
    file, then rename it into place."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(
        ["make", "-C", str(_NATIVE_DIR), f"PY={sys.executable}",
         f"TARGET={tmp}", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building libscanio failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)


def ensure_lib() -> ctypes.CDLL:
    """Load libscanio, building it on first use (or when the source is
    newer than the library). Thread-safe."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        if (
            not _LIB_PATH.exists()
            or _SOURCE.stat().st_mtime > _LIB_PATH.stat().st_mtime
        ):
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.swarm_tcp_scan.argtypes = [
            u32p, u16p, i32,              # ips, ports, n
            u8p, i64p, i32p, i32p,        # payload blob/off/len, pay_idx
            i32, i32, i32, i32,           # conc, connect_to, read_to, cap
            u8p, i32p, i8p, i32p,         # banners, blens, status, rtt
        ]
        lib.swarm_tcp_scan.restype = i32
        lib.swarm_dns_resolve.argtypes = [
            u8p, i32p, i32p, i32,         # names, off, len, n
            u32p, i32, i32,               # resolvers, nres, port
            i32, i32, i32,                # timeout, retries, max_addrs
            u32p, i32p, i8p,              # addrs, naddrs, status
        ]
        lib.swarm_dns_resolve.restype = i32
        _lib = lib
        return lib


@dataclasses.dataclass
class ScanResult:
    """Flat-buffer result of one tcp_scan batch (row i ↔ target i)."""

    banners: np.ndarray   # uint8 [n, banner_cap]
    banner_len: np.ndarray  # int32 [n]
    status: np.ndarray    # int8 [n] — STATUS_*
    rtt_us: np.ndarray    # int32 [n], -1 if never connected

    def banner(self, i: int) -> bytes:
        return self.banners[i, : self.banner_len[i]].tobytes()


def parse_ipv4(hosts: Sequence[str]) -> np.ndarray:
    """Dotted-quad strings → uint32 network-order array."""
    out = np.empty(len(hosts), dtype=np.uint32)
    for i, h in enumerate(hosts):
        out[i] = struct.unpack("=I", socket.inet_aton(h))[0]
    return out


def format_ipv4(addrs: np.ndarray) -> list[str]:
    return [socket.inet_ntoa(struct.pack("=I", int(a))) for a in addrs]


def tcp_scan(
    ips: np.ndarray | Sequence[str],
    ports: np.ndarray | Sequence[int],
    payloads: Optional[Sequence[Optional[bytes]]] = None,
    *,
    max_concurrency: int = 512,
    connect_timeout_ms: int = 1500,
    read_timeout_ms: int = 2000,
    banner_cap: int = 4096,
) -> ScanResult:
    """Batch TCP connect scan + banner/payload probe, plaintext.

    ``payloads[i]`` (optional) is written right after connect; None
    listens silently.
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

    banners = np.zeros((n, banner_cap), dtype=np.uint8)
    blens = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int8)
    rtt = np.zeros(n, dtype=np.int32)
    if n:
        rc = lib.swarm_tcp_scan(
            ips, ports_a, n,
            blob, pay_off, pay_len, pay_idx,
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
