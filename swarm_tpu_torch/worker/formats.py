"""Output formatters for the probe/match modules (a copy of
``swarm_tpu/worker/formats.py`` on the port's model).

The original system's modules each emitted a distinct output shape
into the chunk file (``modules/*.json``):

- ``dnsx``   — resolved hostnames, one per line (dnsx default output)
- ``httprobe`` — live ``http(s)://host[:port]`` URLs (httprobe stdout)
- ``httpx`` / ``http2`` / ``web`` — httpx ``-json`` JSON-lines with url,
  status code, title, webserver, content length
- ``nuclei`` — ``[template-id] [protocol] [severity] url`` match lines

These formatters reproduce those shapes from the native front-end's
Response rows so downstream consumers of chunk files keep working when
the execution engine underneath is the device batch path.
"""

from __future__ import annotations

import json
import re
from typing import Iterable, Sequence

from swarm_tpu_torch.fingerprints.model import Response, Template

_TITLE_RE = re.compile(rb"<title[^>]*>(.*?)</title>", re.IGNORECASE | re.DOTALL)
_SERVER_RE = re.compile(rb"^server:[ \t]*(.+?)[ \t\r]*$", re.IGNORECASE | re.MULTILINE)


def url_of(row: Response) -> str:
    """Canonical URL for a probed row (httprobe/httpx conventions).

    A row that records how it was actually probed (``row.tls``) renders
    that scheme; otherwise the port heuristic applies."""
    if row.tls is not None:
        scheme = "https" if row.tls else "http"
    else:
        scheme = "https" if row.port in (443, 8443) else "http"
    default = 443 if scheme == "https" else 80
    if row.port in (default, 0):
        return f"{scheme}://{row.host}"
    return f"{scheme}://{row.host}:{row.port}"


def format_dnsx(resolutions: Iterable[tuple[str, list[str]]], with_a: bool = False) -> str:
    """dnsx default output: one line per name that resolved.

    ``with_a`` mirrors ``dnsx -a -resp``: ``name [ip]`` per address.
    """
    lines = []
    for name, addrs in resolutions:
        if not addrs:
            continue
        if with_a:
            lines.extend(f"{name} [{a}]" for a in addrs)
        else:
            lines.append(name)
    return "\n".join(lines) + ("\n" if lines else "")


def format_httprobe(rows: Sequence[Response]) -> str:
    """httprobe stdout: one live URL per row whose connect succeeded."""
    lines = [url_of(row) for row in rows if row.alive]
    return "\n".join(lines) + ("\n" if lines else "")


def extract_title(body: bytes) -> str:
    m = _TITLE_RE.search(body)
    if not m:
        return ""
    return m.group(1).decode("utf-8", "replace").strip()


def extract_server(header: bytes) -> str:
    m = _SERVER_RE.search(header)
    return m.group(1).decode("utf-8", "replace") if m else ""


def format_httpx_json(rows: Sequence[Response]) -> str:
    """httpx ``-json`` JSON-lines (the fields the reference pipeline used)."""
    lines = []
    for row in rows:
        # httpx emits only successfully probed URLs: the connect must have
        # succeeded AND a parseable HTTP status line must have come back
        # (a silent open socket, or an SSH/SMTP banner, produces nothing)
        if not row.alive or row.status == 0:
            continue
        obj = {
            "url": url_of(row),
            "host": row.host,
            "port": str(row.port),
            "status_code": row.status,
            "title": extract_title(row.body),
            "webserver": extract_server(row.header),
            "content_length": row.content_length,
        }
        lines.append(json.dumps(obj, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def format_nuclei(
    rows: Sequence[Response],
    results: Sequence,
    severity_of: dict[str, str],
    protocol_of: dict[str, str],
) -> str:
    """nuclei ``-o`` output: ``[template-id] [protocol] [severity] url``."""
    lines = []
    for row, matches in zip(rows, results):
        for tid in matches.template_ids:
            proto = protocol_of.get(tid, "http")
            sev = severity_of.get(tid, "info")
            target = url_of(row) if proto == "http" else f"{row.host}:{row.port}"
            lines.append(f"[{tid}] [{proto}] [{sev}] {target}")
    return "\n".join(lines) + ("\n" if lines else "")


def format_nmap_report(infos: Sequence) -> str:
    """nmap ``-oN``-shaped service report (the output consumers of the
    reference's nmap module parse): a per-host report block with a
    PORT/STATE/SERVICE/VERSION table over open ports."""
    by_host: dict[str, list] = {}
    for info in infos:
        if info.open:
            by_host.setdefault(info.host, []).append(info)
    blocks = []
    for host, ports in by_host.items():
        lines = [
            f"Nmap scan report for {host}",
            "PORT      STATE SERVICE        VERSION",
        ]
        for info in sorted(ports, key=lambda x: x.port):
            version = " ".join(
                x for x in (info.product, info.version) if x
            )
            if info.info:
                version = (version + f" ({info.info})").strip()
            svc = (info.service or "unknown") + ("?" if info.soft else "")
            lines.append(
                f"{str(info.port) + '/tcp':<9} open  {svc:<14} {version}".rstrip()
            )
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks) + ("\n" if blocks else "")


def severity_index(templates: Sequence[Template]) -> tuple[dict[str, str], dict[str, str]]:
    """(template_id → severity, template_id → protocol) lookup tables."""
    sev = {t.id: t.severity for t in templates}
    proto = {t.id: t.protocol for t in templates}
    return sev, proto
