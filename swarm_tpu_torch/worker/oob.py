"""Self-hosted out-of-band interaction listener (interactsh analog) — a
copy of ``swarm_tpu/worker/oob.py`` for the port; it uses no device.

The reference delegates OOB detection to nuclei + a public interactsh
server: templates embed ``{{interactsh-url}}`` in their requests, a
vulnerable target calls that URL back over HTTP or resolves it over
DNS, and matchers then check ``interactsh_protocol`` /
``interactsh_request`` (SURVEY.md §2.3: 144 interactsh matchers; the
corpus only ever matches the protocols "http" and "dns").

This module is the self-hosted equivalent: one in-process listener
serving both protocols, correlation-token URL minting, and a poll API
the active scanner drains after its waves. No third-party interactsh
service is involved — the operator points ``advertise_host`` (and
optionally a delegated ``domain``) at the worker itself.

Correlation model: every minted token is a unique DNS-safe string that
appears verbatim in whatever the target sends back (HTTP path/Host or
DNS qname). Incoming payloads are scanned with one regex for
token-shaped substrings and matched against the registry — O(payload),
independent of how many tokens are outstanding.

URL forms (what ``{{interactsh-url}}`` renders to):
- with ``domain``:  ``<token>.<domain>``  — DNS-correlatable; requires
  the operator to delegate the domain's NS to this listener.
- without: ``<advertise_host>:<http_port>/<token>`` — HTTP-only
  correlation (no DNS delegation needed), enough for SSRF/redirect
  classes; log4j-style DNS-interaction templates need the domain form.
"""

from __future__ import annotations

import dataclasses
import os
import re
import secrets
import socket
import ssl
import struct
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

#: token shape: "si" + 14 hex chars — fixed-width, lowercase, DNS-safe,
#: and specific enough that free text never collides with the registry
_TOKEN_RE = re.compile(rb"si[0-9a-f]{14}")

#: hostile-target bounds: the token is handed to the SCANNED host, so
#: everything it sends back is attacker-controlled — cap both the raw
#: bytes kept per interaction and the interactions kept per token, or a
#: malicious target could OOM the worker during the poll window
_MAX_RAW_BYTES = 64 * 1024
_MAX_INTERACTIONS_PER_TOKEN = 32


@dataclasses.dataclass
class Interaction:
    protocol: str  # "http" | "dns"
    raw_request: bytes
    remote_addr: str
    at: float


class OOBListener:
    """HTTP + DNS callback listener with token correlation."""

    def __init__(
        self,
        advertise_host: str = "127.0.0.1",
        http_port: int = 0,
        dns_port: Optional[int] = 0,
        domain: Optional[str] = None,
        answer_ip: Optional[str] = None,
    ):
        self.advertise_host = advertise_host
        self.domain = domain.strip(".").lower() if domain else None
        # A-record the DNS responder answers with (chained interactions:
        # resolve → connect); defaults to the advertised host when that
        # is an address, else loopback
        self.answer_ip = answer_ip or (
            advertise_host if _is_ipv4(advertise_host) else "127.0.0.1"
        )
        self._lock = threading.Lock()  # guards: _interactions (reads)
        self._interactions: dict[bytes, list[Interaction]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._dns_sock: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._closed = False
        self._http_port_arg = http_port
        self._dns_port_arg = dns_port
        self.http_port = 0
        self.dns_port = 0

    # ------------------------------------------------------------------
    def start(self) -> "OOBListener":
        listener = self

        tls_ctx = _self_signed_tls_context()

        class Handler(BaseHTTPRequestHandler):
            def setup(self) -> None:
                # TLS auto-detect runs HERE, on the per-connection
                # handler thread — peeking (or handshaking) in the
                # accept loop would let one slow client stall every
                # other callback. The timeout stays on the socket so an
                # idle connection times its thread out instead of
                # leaking it.
                self.request.settimeout(10)
                if tls_ctx is not None:
                    try:
                        first = self.request.recv(1, socket.MSG_PEEK)
                        if first == b"\x16":  # TLS ClientHello
                            self.request = tls_ctx.wrap_socket(
                                self.request, server_side=True
                            )
                    except OSError:
                        pass  # plain read path will fail it cleanly
                super().setup()

            # one catch-all: every method records an interaction
            def _serve(self) -> None:
                # everything after the headers is attacker/target-
                # controlled: a malformed Content-Length or a body that
                # never arrives must not prevent the record (that would
                # turn a vulnerable host into a false negative), and a
                # slow body must not eat the scanner's poll window
                raw = self.raw_requestline + bytes(self.headers)
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    length = 0
                if 0 < length <= _MAX_RAW_BYTES:
                    try:
                        self.request.settimeout(2)
                        body = self.rfile.read(length)
                        if body:
                            raw += b"\r\n" + body
                    except OSError:
                        pass
                listener._record("http", raw, self.client_address[0])
                body = b"<html><head></head><body>ok</body></html>"
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a) -> None:  # no stderr spam per hit
                pass

        # dynamically legal: do_GET etc. resolved per-method at runtime
        for method in ("GET", "POST", "PUT", "HEAD", "OPTIONS", "DELETE", "PATCH"):
            setattr(Handler, f"do_{method}", Handler._serve)

        # One port, both schemes: templates embed http:// OR https://
        # around {{interactsh-url}}; Handler.setup peeks the first byte
        # (0x16 = TLS ClientHello) on the handler thread and wraps
        # conditionally — the dual-stack trick real interactsh servers
        # achieve with separate 80/443 listeners. Callbacks are "http"
        # protocol interactions either way (nuclei parity). TLS needs
        # the cryptography package for the self-signed cert; without it
        # the port is plain-HTTP only.
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self._http_port_arg), Handler)
        self.http_port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

        if self._dns_port_arg is not None:
            self._dns_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._dns_sock.bind(("0.0.0.0", self._dns_port_arg))
            self.dns_port = self._dns_sock.getsockname()[1]
            t = threading.Thread(target=self._dns_loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._dns_sock is not None:
            try:
                # unblock recvfrom with a self-addressed empty datagram
                poke = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                poke.sendto(b"", ("127.0.0.1", self.dns_port))
                poke.close()
            except OSError:
                pass
            self._dns_sock.close()

    def __enter__(self) -> "OOBListener":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def new_token(self) -> str:
        token = "si" + secrets.token_hex(7)
        with self._lock:
            self._interactions[token.encode()] = []
        return token

    def url_for(self, token: str) -> str:
        """What ``{{interactsh-url}}`` renders to for this token.

        Domain mode appends ``:http_port`` unless the listener sits on
        a standard web port — otherwise SSRF-class http:// callbacks
        would dial :80 where nothing listens. The port suffix is wrong
        for bare-hostname contexts (dns:// URIs), so operators wanting
        maximal template compatibility should bind (or NAT) 80/443.
        """
        if self.domain:
            if self.http_port in (80, 443):
                return f"{token}.{self.domain}"
            return f"{token}.{self.domain}:{self.http_port}"
        return f"{self.advertise_host}:{self.http_port}/{token}"

    def poll(self, token: str) -> list[Interaction]:
        """Drain the token's interactions (keeps the token registered)."""
        with self._lock:
            got = self._interactions.get(token.encode())
            if not got:
                return []
            out, got[:] = list(got), []
            return out

    def release(self, token: str) -> None:
        with self._lock:
            self._interactions.pop(token.encode(), None)

    def pending(self) -> int:
        with self._lock:
            return sum(1 for v in self._interactions.values() if v)

    # ------------------------------------------------------------------
    def _record(self, protocol: str, raw: bytes, remote: str) -> None:
        now = time.time()
        raw = raw[:_MAX_RAW_BYTES]
        hits = set(_TOKEN_RE.findall(raw.lower()))
        if not hits:
            return
        with self._lock:
            for token in hits:
                bucket = self._interactions.get(token)
                if (
                    bucket is not None
                    and len(bucket) < _MAX_INTERACTIONS_PER_TOKEN
                ):
                    bucket.append(Interaction(protocol, raw, remote, now))

    # ------------------------------------------------------------------
    def _dns_loop(self) -> None:
        sock = self._dns_sock
        assert sock is not None
        while not self._closed:
            try:
                data, addr = sock.recvfrom(4096)
            except OSError:
                return
            if self._closed or len(data) < 12:
                continue
            qname = _parse_qname(data)
            if qname is None:
                continue
            self._record("dns", qname, addr[0])
            reply = _build_a_reply(data, qname, self.answer_ip)
            if reply is not None:
                try:
                    sock.sendto(reply, addr)
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# process-wide shared listeners: the worker runtime caches one
# ActiveScanner per (templates, probe-spec, vars) key for process
# lifetime; per-scanner listeners would leak sockets per key and make a
# fixed-port spec EADDRINUSE on the second scanner. One listener per
# distinct OOB config serves every scanner that asks for it (tokens are
# minted per probe, so sharing cannot cross-correlate scans).

_SHARED: dict = {}  # guarded-by: _SHARED_LOCK (reads)
_SHARED_LOCK = threading.Lock()


def shared_listener(**kw) -> OOBListener:
    """Process-wide OOBListener for this exact config (started)."""
    import json

    key = json.dumps(kw, sort_keys=True)
    with _SHARED_LOCK:
        lst = _SHARED.get(key)
        if lst is None:
            lst = OOBListener(**kw).start()
            _SHARED[key] = lst
        return lst


def _self_signed_tls_context() -> Optional[ssl.SSLContext]:
    """Server SSLContext with a fresh self-signed cert, or None when
    the cryptography package is unavailable (plain-HTTP-only mode).
    Callers of an OOB URL never validate this cert — the vulnerable
    fetcher is the one dialing out."""
    try:
        import datetime

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ImportError:
        return None
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "oob.listener")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=365))
        .sign(key, hashes.SHA256())
    )
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    # load_cert_chain only reads files — stage the PEMs in a private
    # tempdir and remove them once loaded
    with tempfile.TemporaryDirectory(prefix="swarm_oob_tls_") as td:
        cert_pem = os.path.join(td, "cert.pem")
        key_pem = os.path.join(td, "key.pem")
        with open(cert_pem, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
        with open(key_pem, "wb") as f:
            f.write(
                key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.TraditionalOpenSSL,
                    serialization.NoEncryption(),
                )
            )
        ctx.load_cert_chain(cert_pem, key_pem)
    return ctx


# ---------------------------------------------------------------------------
# tiny wire helpers (query side lives in worker/dnsquery.py; the
# responder is intentionally minimal: one question, A-record answer)


def _is_ipv4(s: str) -> bool:
    try:
        socket.inet_aton(s)
        return True
    except OSError:
        return False


def _parse_qname(pkt: bytes) -> Optional[bytes]:
    """First question's qname as dotted lowercase bytes; None = bad."""
    labels = []
    pos = 12
    try:
        while True:
            n = pkt[pos]
            if n == 0:
                break
            if n > 63:  # compression pointers can't appear in a question
                return None
            labels.append(pkt[pos + 1 : pos + 1 + n])
            pos += 1 + n
            if pos > len(pkt) or len(labels) > 64:
                return None
    except IndexError:
        return None
    return b".".join(labels).lower() if labels else None


def _build_a_reply(query: bytes, qname: bytes, answer_ip: str) -> Optional[bytes]:
    """Echo the question, answer one A record (TTL 0)."""
    try:
        tid = query[:2]
        # question section: name + qtype + qclass
        qend = 12 + sum(len(lbl) + 1 for lbl in qname.split(b".")) + 1 + 4
        question = query[12:qend]
    except (IndexError, struct.error):
        return None
    header = tid + struct.pack(
        ">HHHHH",
        0x8580,  # QR | AA | RD|RA echoed loosely; NOERROR
        1,  # QDCOUNT
        1,  # ANCOUNT
        0,
        0,
    )
    answer = (
        b"\xc0\x0c"  # pointer to qname at offset 12
        + struct.pack(">HHIH", 1, 1, 0, 4)  # A, IN, TTL 0, RDLENGTH 4
        + socket.inet_aton(answer_ip)
    )
    return header + question + answer
