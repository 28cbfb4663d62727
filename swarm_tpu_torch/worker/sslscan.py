"""ssl-protocol template execution (nuclei ``ssl`` templates) — a copy
of ``swarm_tpu/worker/sslscan.py`` on the port's model, dsl engine and
``cpu_ref``; it runs on the host only.

The reference corpus carries 5 ssl templates
(``worker/artifacts/templates/ssl/*.yaml``): a TLS handshake is made to
each target — optionally version-pinned per operation
(deprecated-tls.yaml pins sslv3/tls10/tls11) — and matchers/extractors
run over a JSON document describing the negotiated session and the
server certificate (tls_version, not_after, common_name,
issuer_common_name, dns_names, …). dsl matchers like
``unixtime() > not_after`` (expired-ssl.yaml) and
``common_name == issuer_common_name`` (self-signed-ssl.yaml) are
evaluated host-side with the session document merged into the dsl
environment; json extractors reuse the engine's jq-path evaluator.

Network I/O is a handful of handshakes per target — host threads, not
device work; the device engine is for the byte-matching corpus, and
these 5 templates are scalar predicates over handshake metadata.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import ssl as pyssl
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from swarm_tpu_torch.fingerprints import dslc
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.fingerprints.regexlin import quiet_warnings
from swarm_tpu_torch.ops import cpu_ref

# nuclei version-pin names → python ssl constants. SSLv3 has no
# client-side support in modern OpenSSL: a pin we cannot dial is an
# automatic no-match for that operation (same observable result as
# "server refused the old protocol"). TLSv1/TLSv1_1 are deprecated
# enum members and may disappear from a future Python — resolve them
# defensively so a missing member degrades to the same un-dialable-pin
# no-match instead of an ImportError time-bomb.
_VERSIONS = {}
for _pin, _member in (
    ("tls10", "TLSv1"),
    ("tls11", "TLSv1_1"),
    ("tls12", "TLSv1_2"),
    ("tls13", "TLSv1_3"),
):
    with quiet_warnings(DeprecationWarning):
        _v = getattr(pyssl.TLSVersion, _member, None)
    if _v is not None:
        _VERSIONS[_pin] = _v
del _pin, _member, _v

# Ports that are KNOWN plaintext protocols: the ssl fan-out excludes
# these from a module's probe ports (a TLS handshake there can only
# burn its timeout) and keeps everything else — nonstandard TLS ports
# (4433, appliance admin UIs, …) stay covered.
PLAINTEXT_PORTS = frozenset(
    {
        21, 22, 23, 25, 53, 69, 79, 80, 110, 111, 119, 123, 135, 137,
        139, 143, 161, 389, 445, 512, 513, 514, 515, 554, 587, 873,
        1080, 2049, 3000, 3128, 3306, 5000, 5060, 5432, 5900, 6000,
        6379, 8000, 8008, 8080, 8081, 8088, 9090, 9100, 9200, 11211,
        27017, 50000,
    }
)

_WIRE_TO_NUCLEI = {
    "SSLv3": "ssl30",
    "TLSv1": "tls10",
    "TLSv1.1": "tls11",
    "TLSv1.2": "tls12",
    "TLSv1.3": "tls13",
}


@dataclasses.dataclass
class SslFinding:
    template_id: str
    host: str
    port: int
    severity: str = "info"
    extractions: list[str] = dataclasses.field(default_factory=list)
    # named matchers that fired (workflow gates consume these — ssl
    # docs can't be re-confirmed through the generic cpu oracle)
    matcher_names: list[str] = dataclasses.field(default_factory=list)


def _cert_doc(der: bytes) -> dict:
    """Certificate fields in nuclei's tls-document shape."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import ExtensionOID, NameOID

    cert = x509.load_der_x509_certificate(der)
    cn = [
        a.value for a in cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
    ]
    issuer_cn = [
        a.value for a in cert.issuer.get_attributes_for_oid(NameOID.COMMON_NAME)
    ]
    dns_names: list[str] = []
    try:
        san = cert.extensions.get_extension_for_oid(
            ExtensionOID.SUBJECT_ALTERNATIVE_NAME
        )
        dns_names = san.value.get_values_for_type(x509.DNSName)
    except x509.ExtensionNotFound:
        pass
    return {
        "common_name": cn,
        "issuer_common_name": issuer_cn,
        "subject_dn": cert.subject.rfc4514_string(),
        "issuer_dn": cert.issuer.rfc4514_string(),
        "dns_names": dns_names,
        "not_before": int(cert.not_valid_before_utc.timestamp()),
        "not_after": int(cert.not_valid_after_utc.timestamp()),
        "serial": str(cert.serial_number),
        "fingerprint_sha256": cert.fingerprint(hashes.SHA256()).hex(),
        "self_signed": cert.subject == cert.issuer,
    }


def handshake(
    host: str,
    port: int,
    min_version: str = "",
    max_version: str = "",
    timeout: float = 4.0,
) -> Optional[dict]:
    """One TLS handshake; returns the session/cert document, or None
    when the connection or the (possibly version-pinned) handshake
    fails."""
    ctx = pyssl.SSLContext(pyssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = pyssl.CERT_NONE
    try:
        # legacy-protocol probing needs permissive ciphers
        ctx.set_ciphers("ALL:@SECLEVEL=0")
    except pyssl.SSLError:
        pass
    try:
        # legacy pins are deliberate here (probing what the SERVER
        # still speaks); quiet_warnings is the lock-serialized guard —
        # this runs in a ThreadPoolExecutor, where bare catch_warnings
        # would race on the process-global filter list
        with quiet_warnings(DeprecationWarning):
            if min_version:
                ctx.minimum_version = _VERSIONS[min_version]
            if max_version:
                ctx.maximum_version = _VERSIONS[max_version]
    except (KeyError, ValueError):
        return None  # pin not dialable on this client (e.g. sslv3)
    try:
        with socket.create_connection((host, port), timeout=timeout) as sock:
            with ctx.wrap_socket(sock, server_hostname=host) as tls:
                der = tls.getpeercert(binary_form=True)
                version = tls.version() or ""
                cipher = (tls.cipher() or ("", "", 0))[0]
    except (OSError, pyssl.SSLError, ValueError):
        return None
    doc = {
        "host": host,
        "port": str(port),
        "tls_version": _WIRE_TO_NUCLEI.get(version, version.lower()),
        "cipher": cipher,
    }
    if der:
        try:
            doc.update(_cert_doc(der))
        except Exception:
            # embedded-device garbage DER must not kill the scan; the
            # session half of the doc (version/cipher) is still usable
            pass
    return doc


def _parse_target(line: str) -> Optional[tuple[str, Optional[int]]]:
    """→ (host, explicit_port_or_None); None for blanks/comments. The
    caller applies its port default/fan-out to portless targets."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "://" in line:
        line = line.split("://", 1)[1]
    line = line.split("/", 1)[0]
    if line.startswith("["):
        # bracketed IPv6, with or without :port
        host, _, rest = line[1:].partition("]")
        if rest.startswith(":"):
            try:
                return host, int(rest[1:])
            except ValueError:
                return host, None
        return host, None
    if line.count(":") > 1:
        return line, None  # bare IPv6 address, no port syntax possible
    if ":" in line:
        host, _, p = line.rpartition(":")
        try:
            return host, int(p)
        except ValueError:
            return line, None
    return line, None


class SslScanner:
    """Execute ssl-protocol templates against host[:port] targets."""

    def __init__(
        self,
        templates: Sequence[Template],
        concurrency: int = 32,
        timeout: float = 4.0,
    ):
        self.templates = [t for t in templates if t.protocol == "ssl"]
        self.concurrency = max(1, concurrency)
        self.timeout = timeout

    # ------------------------------------------------------------------
    def _eval_operation(
        self, op, doc: dict, host: str, port: int
    ) -> tuple[bool, list[str], list[str]]:
        """(matched, extracted, fired_matcher_names) for one ssl op
        given a session doc."""
        body = json.dumps(doc, separators=(",", ":")).encode()
        row = Response(host=host, port=port, body=body, tls=True)
        # internal named extractors feed the dsl environment
        # (self-signed-ssl.yaml: common_name / issuer_common_name)
        env = dslc.build_env(row)
        for k, v in doc.items():
            if isinstance(v, (str, int, float, bool)):
                env.setdefault(k, v)
        out: list[str] = []
        for ex in op.extractors:
            values = cpu_ref._extract(
                dataclasses.replace(op, extractors=[ex]), row
            )
            if ex.internal and ex.name:
                if values:
                    env[ex.name] = values[0]
            else:
                out.extend(values)
        if not op.matchers:
            # extractor-only entries fire when anything extracted
            # (tls-version.yaml / ssl-dns-names.yaml)
            return bool(out), out, []
        verdicts: list[bool] = []
        fired_names: list[str] = []
        for m in op.matchers:
            if m.type == "dsl":
                vs = []
                for expr in m.dsl:
                    ast = dslc.try_parse(expr)
                    if ast is None:
                        vs.append(False)
                        continue
                    try:
                        vs.append(bool(dslc.evaluate(ast, env)))
                    except Exception:
                        # exotic expression errors degrade to no-match,
                        # never abort the scan (cpu_ref convention)
                        vs.append(False)
                v = all(vs) if m.condition == "and" else any(vs)
                verdicts.append((not v) if m.negative else v)
            else:
                v = cpu_ref.match_matcher(m, row)
                verdicts.append(bool(v))
            if verdicts[-1] and m.name:
                fired_names.append(m.name)
        matched = (
            all(verdicts) if op.matchers_condition == "and" else any(verdicts)
        )
        return matched, out, fired_names

    def _scan_target(self, host: str, port: int) -> list[SslFinding]:
        findings: list[SslFinding] = []
        # handshake cache: unpinned + per-distinct-pin (deprecated-tls
        # makes 3 pinned dials; everything else shares the free one)
        docs: dict[tuple[str, str], Optional[dict]] = {}

        def doc_for(op) -> Optional[dict]:
            key = (op.ssl_min_version, op.ssl_max_version)
            if key not in docs:
                docs[key] = handshake(
                    host, port, key[0], key[1], timeout=self.timeout
                )
            return docs[key]

        for t in self.templates:
            hits: list[str] = []
            names: list[str] = []
            matched = False
            for op in t.operations:
                doc = doc_for(op)
                if doc is None:
                    continue
                ok, values, fired = self._eval_operation(op, doc, host, port)
                if ok:
                    matched = True
                    hits.extend(values)
                    names.extend(fired)
            if matched:
                findings.append(
                    SslFinding(
                        template_id=t.id,
                        host=host,
                        port=port,
                        severity=t.severity,
                        extractions=hits,
                        matcher_names=sorted(set(names)),
                    )
                )
        return findings

    def scan(
        self,
        lines: Sequence[str],
        default_ports: Optional[Sequence[int]] = None,
    ) -> tuple[list[SslFinding], dict]:
        """``default_ports`` applies to portless target lines (the
        active module passes its probe ports so ssl templates follow
        the scan's port fan-out instead of assuming 443)."""
        defaults = list(dict.fromkeys(int(p) for p in default_ports or [443]))
        targets = []
        seen = set()
        for line in lines:
            t = _parse_target(line)
            if t is None:
                continue
            host, port = t
            for p in [port] if port is not None else defaults:
                if (host, p) not in seen:
                    seen.add((host, p))
                    targets.append((host, p))
        findings: list[SslFinding] = []
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            for result in pool.map(
                lambda hp: self._scan_target(*hp), targets
            ):
                findings.extend(result)
        stats = {
            "targets": len(targets),
            "templates": len(self.templates),
            "hits": len(findings),
        }
        return findings, stats


def format_lines(findings: Sequence[SslFinding]) -> list[str]:
    lines = []
    for h in findings:
        extra = (
            " [" + ",".join(repr(v) for v in h.extractions) + "]"
            if h.extractions
            else ""
        )
        lines.append(
            f"[{h.template_id}] [ssl] [{h.severity}] {h.host}:{h.port}{extra}"
        )
    return lines


def format_findings(findings: Sequence[SslFinding]) -> bytes:
    lines = format_lines(findings)
    return ("\n".join(lines) + "\n").encode() if lines else b""
