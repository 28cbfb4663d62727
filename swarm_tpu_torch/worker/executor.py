"""Probe executor of the port: bare targets → native I/O front-end →
Response rows (a copy of ``swarm_tpu/worker/executor.py`` on the port's
model and its own bindings of the repo-root ``native/`` library).

The reference's ``web`` module was a unix pipeline ``dnsx | httpx``
(``worker/modules/web.json``) and its nmap module grabbed banners via
``-sV``. Here those become one batch pipeline over the native engine
(``swarm_tpu_torch/native/scanio.py``): resolve hostnames (bulk UDP DNS), fan out
(host × ports) TCP connects with optional HTTP payloads, and parse the
raw responses into the fixed-shape rows the device matcher consumes.

Module spec (``modules/<name>.json``)::

    {"backend": "tpu", "templates": "...", "input_format": "targets",
     "probe": {"type": "http",          # or "banner"
               "ports": [80, 8080],
               "path": "/",             # http only
               "resolvers": ["1.1.1.1", "8.8.8.8"],
               "concurrency": 512, "connect_timeout_ms": 1500,
               "read_timeout_ms": 2000, "banner_cap": 4096}}

Target lines accept ``host``, ``host:port``, ``ip``, ``ip:port`` and
``http://host[:port][/path]`` forms; an explicit port overrides the
spec's port fan-out.
"""

from __future__ import annotations

import ipaddress
import re
from pathlib import Path
from typing import Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from swarm_tpu_torch.fingerprints.model import Response
from swarm_tpu_torch.native import scanio
from swarm_tpu_torch.tls import jarm as jarm_mod
from swarm_tpu_torch.tls import wire as tls_wire
from swarm_tpu_torch.tls.jarm import EMPTY_JARM, TlsFingerprint


_DEFAULTS = {
    "type": "http",
    "ports": [80],
    "path": "/",
    "resolvers": [],
    "concurrency": 512,
    "connect_timeout_ms": 1500,
    "read_timeout_ms": 2000,
    "banner_cap": 4096,
}


def parse_target(
    line: str,
) -> Optional[tuple[str, Optional[int], str, str]]:
    """→ (host, explicit_port | None, path, scheme) — scheme "" unless
    the line stated one; None for blank/comment lines.

    Malformed lines (bad URL, out-of-range port) raise ValueError — the
    caller turns those into dead rows so one bad line never sinks the
    chunk."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    path = "/"
    if "://" in line:
        parts = urlsplit(line)
        host = parts.hostname or ""
        port = parts.port  # raises ValueError when out of range
        if parts.path:
            path = parts.path
        if port is None and parts.scheme == "https":
            port = 443
        if not host:
            raise ValueError(f"no host in target {line!r}")
        return (host, port, path, parts.scheme.lower())
    host, sep, port_s = line.rpartition(":")
    if sep and port_s.isdigit():
        port = int(port_s)
        if not 0 < port < 65536:
            raise ValueError(f"port out of range in target {line!r}")
        return (host, port, path, "")
    return (line, None, path, "")


def tls_port(port: int) -> bool:
    """Default TLS heuristic when the target stated no scheme
    (url_of convention)."""
    return port in (443, 8443)


def use_tls(scheme: str, port: int) -> bool:
    """A user-stated scheme always wins over the port heuristic."""
    if scheme == "https":
        return True
    if scheme == "http":
        return False
    return tls_port(port)


def is_ip(host: str) -> bool:
    try:
        ipaddress.IPv4Address(host)
        return True
    except ValueError:
        return False


def parse_http_response(raw: bytes) -> tuple[int, bytes, bytes]:
    """raw bytes → (status_code, header, body); 0 when not HTTP."""
    head, sep, body = raw.partition(b"\r\n\r\n")
    if not sep:
        head, sep, body = raw.partition(b"\n\n")
    status = 0
    m = re.match(rb"HTTP/\d\.\d (\d{3})", head)
    if m:
        status = int(m.group(1))
    return status, head, body


_TOP_PORTS_FILE = (
    Path(__file__).resolve().parent.parent / "data" / "top-ports.txt"
)
_top_ports_cache: Optional[list[int]] = None


def top_ports(limit: Optional[int] = None) -> list[int]:
    """Default port fan-out for service scans (data/top-ports.txt)."""
    global _top_ports_cache
    if _top_ports_cache is None:
        ports: list[int] = []
        for line in _TOP_PORTS_FILE.read_text().splitlines():
            if line.startswith("#"):
                continue
            ports.extend(int(tok) for tok in line.split())
        _top_ports_cache = ports
    return _top_ports_cache[:limit] if limit else list(_top_ports_cache)


_resolv_cache: Optional[list[str]] = None


def _system_resolvers() -> list[str]:
    """IPv4 nameservers from /etc/resolv.conf (dnsx's default source)."""
    global _resolv_cache
    if _resolv_cache is None:
        out: list[str] = []
        try:
            with open("/etc/resolv.conf") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[0] == "nameserver" and is_ip(parts[1]):
                        out.append(parts[1])
        except OSError:
            pass
        _resolv_cache = out
    return _resolv_cache


class ProbeExecutor:
    def __init__(self, spec: Optional[dict] = None):
        self.explicit = set(spec or {})  # keys the caller actually set
        self.spec = {**_DEFAULTS, **(spec or {})}

    # ------------------------------------------------------------------
    def _parse_lines(
        self, target_lines: Sequence[str]
    ) -> tuple[list[tuple[str, Optional[int], str, str]], list[str]]:
        """→ (parsed targets, malformed lines). Malformed lines become
        dead rows downstream so every input line stays accounted for."""
        parsed: list[tuple[str, Optional[int], str, str]] = []
        malformed: list[str] = []
        for line in target_lines:
            try:
                t = parse_target(line)
            except ValueError:
                malformed.append(line.strip())
                continue
            if t is not None:
                parsed.append(t)
        return parsed, malformed

    def _resolve_names(
        self,
        parsed: Sequence[tuple[str, Optional[int], str, str]],
        all_addrs: bool = False,
    ) -> dict[str, list[str]]:
        """Bulk-resolve the non-IP hostnames in ``parsed`` → name→addrs
        (empty list when unresolvable)."""
        names = sorted({t[0] for t in parsed if not is_ip(t[0])})
        addr_of: dict[str, list[str]] = {n: [] for n in names}
        resolvers = list(self.spec["resolvers"]) or _system_resolvers()
        if names and resolvers:
            res = scanio.dns_resolve(
                names, resolvers, timeout_ms=int(self.spec["read_timeout_ms"])
            )
            for i, name in enumerate(names):
                addrs = res.addresses(i)
                addr_of[name] = addrs if all_addrs else addrs[:1]
        return addr_of

    # ------------------------------------------------------------------
    def resolve(self, target_lines: Sequence[str]) -> list[tuple[str, list[str]]]:
        """Resolve-only mode (the dnsx module): → [(name, [A records])].

        IP literals pass through as (ip, [ip]); unresolvable names keep
        an empty address list so callers see every input accounted for.
        """
        parsed, _malformed = self._parse_lines(target_lines)
        addr_of = self._resolve_names(parsed, all_addrs=True)
        seen: set[str] = set()
        out: list[tuple[str, list[str]]] = []
        for name, *_ in parsed:
            if name in seen:
                continue
            seen.add(name)
            out.append((name, [name] if is_ip(name) else addr_of.get(name, [])))
        return out

    # ------------------------------------------------------------------
    def run(self, target_lines: Sequence[str]) -> list[Response]:
        """Probe every target; one Response per (target, port) probe.

        Unresolvable or unreachable targets still yield a row (status 0,
        empty streams) so output row counts track input targets — the
        chunk contract the reference's tools also kept (every input line
        is accounted for in the output file).
        """
        parsed, malformed = self._parse_lines(target_lines)
        addr_of = self._resolve_names(parsed)

        # --- fan out (target × ports) ---
        # probes: (host, ip, port, path, tls)
        probes: list[tuple[str, str, int, str, bool]] = []
        dead: list[tuple[str, int]] = []  # unresolved rows
        spec_ports = [p for p in self.spec["ports"] if 0 < int(p) < 65536]
        for host, explicit_port, path, scheme in parsed:
            ip = host if is_ip(host) else next(iter(addr_of.get(host) or []), None)
            ports = [explicit_port] if explicit_port else spec_ports
            for port in ports:
                if ip is None:
                    dead.append((host, port))
                else:
                    probes.append((host, ip, port, path, use_tls(scheme, port)))

        rows: list[Response] = []
        if probes:
            http = self.spec["type"] == "http"
            payloads = None
            if http:
                payloads = [
                    (
                        f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                        "User-Agent: swarm-tpu/1.0\r\nAccept: */*\r\n"
                        "Connection: close\r\n\r\n"
                    ).encode()
                    for host, _ip, _port, path, _tls in probes
                ]
            result = scanio.tcp_scan(
                [ip for _h, ip, _p, _pa, _t in probes],
                np.asarray([p for _h, _ip, p, _pa, _t in probes], dtype=np.uint16),
                payloads,
                tls=[http and t for _h, _ip, _p, _pa, t in probes],
                sni=[
                    host if not is_ip(host) else None
                    for host, _ip, _p, _pa, _t in probes
                ],
                max_concurrency=int(self.spec["concurrency"]),
                connect_timeout_ms=int(self.spec["connect_timeout_ms"]),
                read_timeout_ms=int(self.spec["read_timeout_ms"]),
                banner_cap=int(self.spec["banner_cap"]),
            )
            for i, (host, _ip, port, _path, tls_used) in enumerate(probes):
                raw = result.banner(i)
                if int(result.status[i]) != scanio.STATUS_OPEN:
                    rows.append(Response(host=host, port=port, alive=False))
                    continue
                if http:
                    code, header, body = parse_http_response(raw)
                    rows.append(
                        Response(
                            host=host, port=port, status=code,
                            header=header, body=body, tls=tls_used,
                        )
                    )
                else:
                    rows.append(Response(host=host, port=port, banner=raw))
        rows.extend(Response(host=h, port=p, alive=False) for h, p in dead)
        rows.extend(Response(host=m, port=0, alive=False) for m in malformed)
        return rows

    # ------------------------------------------------------------------
    def run_service(
        self, target_lines: Sequence[str], classifier
    ) -> tuple[list[Response], list[Optional[str]]]:
        """Service-scan probing (the nmap -sV front half): per-port probe
        payload selection from the probes DB, raw banner capture.

        → (rows, sent_probe_names) aligned for
        ``ServiceClassifier.classify``. Targets without an explicit port
        fan out over the spec's ports (default: the bundled top-ports
        list).
        """
        parsed, malformed = self._parse_lines(target_lines)
        addr_of = self._resolve_names(parsed)

        # explicit ports only when the caller set them; service scans
        # default to the top-ports fan-out, not the HTTP default [80]
        spec_ports = (
            [int(p) for p in self.spec["ports"] if 0 < int(p) < 65536]
            if "ports" in self.explicit
            else []
        ) or top_ports()
        probes: list[tuple[str, str, int, str, bytes]] = []
        rows: list[Response] = []
        sent: list[Optional[str]] = []
        for line in malformed:
            rows.append(Response(host=line, port=0, alive=False))
            sent.append(None)
        for host, explicit_port, _path, _scheme in parsed:
            ip = host if is_ip(host) else next(iter(addr_of.get(host) or []), None)
            for port in [explicit_port] if explicit_port else spec_ports:
                if ip is None:
                    rows.append(Response(host=host, port=port, alive=False))
                    sent.append(None)
                    continue
                probe = classifier.probe_for_port(port)
                probes.append((host, ip, port, probe.name, probe.payload))

        if probes:
            result = scanio.tcp_scan(
                [ip for _h, ip, _p, _n, _pl in probes],
                np.asarray([p for _h, _ip, p, _n, _pl in probes], dtype=np.uint16),
                [pl if pl else None for _h, _ip, _p, _n, pl in probes],
                max_concurrency=int(self.spec["concurrency"]),
                connect_timeout_ms=int(self.spec["connect_timeout_ms"]),
                read_timeout_ms=int(self.spec["read_timeout_ms"]),
                banner_cap=int(self.spec["banner_cap"]),
            )
            for i, (host, _ip, port, probe_name, _pl) in enumerate(probes):
                alive = int(result.status[i]) == scanio.STATUS_OPEN
                rows.append(
                    Response(
                        host=host,
                        port=port,
                        banner=result.banner(i) if alive else b"",
                        alive=alive,
                    )
                )
                sent.append(probe_name)

            # second round: open ports that stayed silent under the NULL
            # listen get the lowest-rarity payload probe (nmap escalates
            # through payload probes when nothing announces itself)
            second = classifier.default_payload_probe()
            base = len(rows) - len(probes)
            retry = [
                (base + i, probes[i])
                for i in range(len(probes))
                if rows[base + i].alive
                and not rows[base + i].banner
                and not probes[i][4]  # no payload was sent the first time
            ]
            if second is not None and retry:
                result2 = scanio.tcp_scan(
                    [p[1] for _ri, p in retry],
                    np.asarray([p[2] for _ri, p in retry], dtype=np.uint16),
                    [second.payload] * len(retry),
                    max_concurrency=int(self.spec["concurrency"]),
                    connect_timeout_ms=int(self.spec["connect_timeout_ms"]),
                    read_timeout_ms=int(self.spec["read_timeout_ms"]),
                    banner_cap=int(self.spec["banner_cap"]),
                )
                for j, (ri, p) in enumerate(retry):
                    if (
                        int(result2.status[j]) == scanio.STATUS_OPEN
                        and result2.banner(j)
                    ):
                        rows[ri] = Response(
                            host=p[0], port=p[2], banner=result2.banner(j)
                        )
                        sent[ri] = second.name
        return rows, sent

    # ------------------------------------------------------------------
    def run_jarm(self, target_lines: Sequence[str]) -> list[TlsFingerprint]:
        """Active TLS fingerprinting: 10 JARM ClientHellos per target.

        → list[TlsFingerprint], one per (target, port), default port
        443. Every input line is accounted for (dead/malformed targets
        yield alive=False rows), matching the chunk contract of the
        other probe paths.
        """
        parsed, malformed = self._parse_lines(target_lines)
        addr_of = self._resolve_names(parsed)
        targets: list[tuple[str, str, int]] = []
        dead: list[tuple[str, int]] = []
        for host, explicit_port, _path, _scheme in parsed:
            ip = host if is_ip(host) else next(iter(addr_of.get(host) or []), None)
            port = explicit_port or 443
            if ip is None:
                dead.append((host, port))
            else:
                targets.append((host, ip, port))

        fps: list[TlsFingerprint] = []
        if targets:
            ips, ports, payloads = [], [], []
            for host, ip, port in targets:
                sni = "" if is_ip(host) else host
                for spec in jarm_mod.probe_set(sni):
                    ips.append(ip)
                    ports.append(port)
                    payloads.append(tls_wire.build_client_hello(spec))
            result = scanio.tcp_scan(
                ips,
                np.asarray(ports, dtype=np.uint16),
                payloads,
                max_concurrency=int(self.spec["concurrency"]),
                connect_timeout_ms=int(self.spec["connect_timeout_ms"]),
                read_timeout_ms=int(self.spec["read_timeout_ms"]),
                banner_cap=max(8192, int(self.spec["banner_cap"])),
            )
            np_count = jarm_mod.NUM_PROBES
            for t, (host, _ip, port) in enumerate(targets):
                statuses = [
                    int(result.status[t * np_count + k]) for k in range(np_count)
                ]
                banners = [
                    result.banner(t * np_count + k)
                    if statuses[k] == scanio.STATUS_OPEN
                    else b""
                    for k in range(np_count)
                ]
                fps.append(
                    jarm_mod.fingerprint_from_banners(
                        host, port, banners,
                        open_=scanio.STATUS_OPEN in statuses,
                    )
                )
        fps.extend(
            TlsFingerprint(host=h, port=p, jarmx=EMPTY_JARM, ja3s="", alive=False)
            for h, p in dead
        )
        fps.extend(
            TlsFingerprint(host=m, port=0, jarmx=EMPTY_JARM, ja3s="", alive=False)
            for m in malformed
        )
        return fps
