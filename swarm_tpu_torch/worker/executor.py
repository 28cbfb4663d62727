"""Probe executor of the port: bare targets → native I/O → TLS fingerprints.

The port of the jarm half of ``swarm_tpu/worker/executor.py``: target
parsing, bulk name resolution through the native engine, and
:meth:`ProbeExecutor.run_jarm`, which sends the ten JARM ClientHellos to
every target in one native batch and turns the server flights into
:class:`~swarm_tpu_torch.tls.jarm.TlsFingerprint` rows.

Target lines accept ``host``, ``host:port``, ``ip``, ``ip:port`` and
``scheme://host[:port][/path]`` forms; an explicit port overrides the
default (443 for jarm).
"""

from __future__ import annotations

import ipaddress
from typing import Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from swarm_tpu_torch.native import scanio
from swarm_tpu_torch.tls import jarm as jarm_mod
from swarm_tpu_torch.tls import wire as tls_wire
from swarm_tpu_torch.tls.jarm import EMPTY_JARM, TlsFingerprint

_DEFAULTS = {
    "resolvers": [],
    "concurrency": 512,
    "connect_timeout_ms": 1500,
    "read_timeout_ms": 2000,
    "banner_cap": 4096,
}

Target = tuple[str, Optional[int], str, str]


def parse_target(line: str) -> Optional[Target]:
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


def is_ip(host: str) -> bool:
    try:
        ipaddress.IPv4Address(host)
        return True
    except ValueError:
        return False


_resolv_cache: Optional[list[str]] = None


def _system_resolvers() -> list[str]:
    """IPv4 nameservers from /etc/resolv.conf."""
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
        self.spec = {**_DEFAULTS, **(spec or {})}

    def _parse_lines(
        self, target_lines: Sequence[str]
    ) -> tuple[list[Target], list[str]]:
        """→ (parsed targets, malformed lines). Malformed lines become
        dead rows downstream so every input line stays accounted for."""
        parsed: list[Target] = []
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

    def _resolve_names(self, parsed: Sequence[Target]) -> dict[str, list[str]]:
        """Bulk-resolve the non-IP hostnames in ``parsed`` → name → its
        first address (empty list when unresolvable)."""
        names = sorted({t[0] for t in parsed if not is_ip(t[0])})
        addr_of: dict[str, list[str]] = {n: [] for n in names}
        resolvers = list(self.spec["resolvers"]) or _system_resolvers()
        if names and resolvers:
            res = scanio.dns_resolve(
                names, resolvers, timeout_ms=int(self.spec["read_timeout_ms"])
            )
            for i, name in enumerate(names):
                addr_of[name] = res.addresses(i)[:1]
        return addr_of

    def run_jarm(self, target_lines: Sequence[str]) -> list[TlsFingerprint]:
        """Active TLS fingerprinting: 10 JARM ClientHellos per target.

        → one TlsFingerprint per (target, port), default port 443. Every
        input line is accounted for (dead/malformed targets yield
        alive=False rows).
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
