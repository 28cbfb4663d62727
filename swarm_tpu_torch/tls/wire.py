"""Minimal TLS wire codec: ClientHello construction + ServerHello parse.

Just enough TLS (no crypto) to drive active TLS fingerprinting: build
ClientHello probes with controlled version/cipher-order/extension
shapes, and parse whatever the server sends back — ServerHello fields
(version, chosen cipher, extension types in order, ALPN selection) or
an alert. The handshake is never completed; fingerprinting only needs
the server's first flight.

New capability relative to the reference (Jec00/swarm drives external
Go/C tools and has no TLS stack of its own — SURVEY.md §2.2); built for
BASELINE.json config #5 (JA3/JARM fingerprint + clustering).

The port's own copy of ``swarm_tpu/tls/wire.py``: same bytes out, same
parse.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

HANDSHAKE = 0x16
ALERT = 0x15
CCS = 0x14
APPDATA = 0x17

HELLO_CLIENT = 0x01
HELLO_SERVER = 0x02

TLS10 = 0x0301
TLS11 = 0x0302
TLS12 = 0x0303
TLS13 = 0x0304

EXT_SNI = 0x0000
EXT_GROUPS = 0x000A
EXT_EC_FORMATS = 0x000B
EXT_SIGALGS = 0x000D
EXT_ALPN = 0x0010
EXT_EMS = 0x0017
EXT_SESSION_TICKET = 0x0023
EXT_SUPPORTED_VERSIONS = 0x002B
EXT_PSK_MODES = 0x002D
EXT_KEY_SHARE = 0x0033
EXT_RENEG = 0xFF01

GREASE = 0x0A0A  # one fixed GREASE value keeps probes deterministic

X25519 = 0x001D
SECP256R1 = 0x0017
SECP384R1 = 0x0018


def _u8(v: int) -> bytes:
    return struct.pack("!B", v)


def _u16(v: int) -> bytes:
    return struct.pack("!H", v)


def _u24(v: int) -> bytes:
    return struct.pack("!I", v)[1:]


def _vec8(b: bytes) -> bytes:
    return _u8(len(b)) + b


def _vec16(b: bytes) -> bytes:
    return _u16(len(b)) + b


def ext(ext_type: int, body: bytes) -> bytes:
    return _u16(ext_type) + _vec16(body)


def sni_ext(hostname: str) -> bytes:
    name = hostname.encode("idna") if hostname else b""
    entry = _u8(0) + _vec16(name)
    return ext(EXT_SNI, _vec16(entry))


def alpn_ext(protocols: list[bytes]) -> bytes:
    blob = b"".join(_vec8(p) for p in protocols)
    return ext(EXT_ALPN, _vec16(blob))


def groups_ext(groups: list[int]) -> bytes:
    return ext(EXT_GROUPS, _vec16(b"".join(_u16(g) for g in groups)))


def sigalgs_ext() -> bytes:
    algs = [0x0403, 0x0804, 0x0401, 0x0503, 0x0805, 0x0501, 0x0806, 0x0601, 0x0201]
    return ext(EXT_SIGALGS, _vec16(b"".join(_u16(a) for a in algs)))


def supported_versions_ext(versions: list[int]) -> bytes:
    return ext(EXT_SUPPORTED_VERSIONS, _vec8(b"".join(_u16(v) for v in versions)))


def key_share_ext(group: int = X25519, pub: Optional[bytes] = None) -> bytes:
    # Any 32 bytes form a valid x25519 public key; the handshake is
    # abandoned after the server's first flight so the key never matters.
    pub = pub if pub is not None else bytes(range(1, 33))
    entry = _u16(group) + _vec16(pub)
    return ext(EXT_KEY_SHARE, _vec16(entry))


@dataclasses.dataclass
class HelloSpec:
    """One ClientHello probe shape (what varies across JARM probes)."""

    record_version: int = TLS12
    hello_version: int = TLS12
    ciphers: tuple[int, ...] = ()
    hostname: str = ""
    alpn: tuple[bytes, ...] = (b"h2", b"http/1.1")
    offer_tls13: bool = False
    grease: bool = False
    extension_order_reversed: bool = False
    minimal: bool = False  # SNI + groups only (rare-extension shape)


def build_client_hello(spec: HelloSpec, random: Optional[bytes] = None) -> bytes:
    """HelloSpec → full TLS record bytes ready to write to the socket."""
    rnd = random if random is not None else os.urandom(32)
    assert len(rnd) == 32
    session_id = os.urandom(32) if spec.offer_tls13 else b""

    ciphers = list(spec.ciphers)
    if spec.grease:
        ciphers = [GREASE] + ciphers
    cipher_blob = b"".join(_u16(c) for c in ciphers)

    exts: list[bytes] = []
    if spec.hostname:
        exts.append(sni_ext(spec.hostname))
    exts.append(groups_ext(([GREASE] if spec.grease else []) + [X25519, SECP256R1, SECP384R1]))
    if not spec.minimal:
        exts.append(ext(EXT_EC_FORMATS, _vec8(b"\x00")))
        exts.append(sigalgs_ext())
        if spec.alpn:
            exts.append(alpn_ext(list(spec.alpn)))
        exts.append(ext(EXT_EMS, b""))
        exts.append(ext(EXT_SESSION_TICKET, b""))
        exts.append(ext(EXT_RENEG, b"\x00"))
    if spec.offer_tls13:
        versions = ([GREASE] if spec.grease else []) + [TLS13, TLS12]
        exts.append(supported_versions_ext(versions))
        exts.append(ext(EXT_PSK_MODES, _vec8(b"\x01")))
        exts.append(key_share_ext())
    if spec.extension_order_reversed:
        exts = exts[::-1]
    ext_blob = b"".join(exts)

    body = (
        _u16(spec.hello_version)
        + rnd
        + _vec8(session_id)
        + _vec16(cipher_blob)
        + _vec8(b"\x00")  # null compression
        + _vec16(ext_blob)
    )
    handshake = _u8(HELLO_CLIENT) + _u24(len(body)) + body
    return _u8(HANDSHAKE) + _u16(spec.record_version) + _vec16(handshake)


# ---------------------------------------------------------------------------
# Server-side parse


@dataclasses.dataclass
class ServerHello:
    version: int  # negotiated (supported_versions-aware)
    legacy_version: int
    cipher: int
    extensions: tuple[int, ...]  # extension types, wire order
    alpn: bytes = b""
    alert: Optional[int] = None  # alert description when no hello came back

    @property
    def ok(self) -> bool:
        return self.cipher != -1


NO_HELLO = ServerHello(
    version=-1, legacy_version=-1, cipher=-1, extensions=(), alert=None
)


def parse_server_flight(raw: bytes) -> ServerHello:
    """Bytes off the wire → first ServerHello (or alert) found.

    Walks TLS records, reassembles handshake fragments, stops at the
    first ServerHello. Tolerates trailing garbage and truncation —
    internet scans see every malformed variant imaginable.
    """
    pos = 0
    handshake = b""
    alert_desc: Optional[int] = None
    while pos + 5 <= len(raw):
        rtype = raw[pos]
        rlen = struct.unpack("!H", raw[pos + 3 : pos + 5])[0]
        frag = raw[pos + 5 : pos + 5 + rlen]
        pos += 5 + rlen
        if rtype == ALERT and len(frag) >= 2 and alert_desc is None:
            alert_desc = frag[1]
        elif rtype == HANDSHAKE:
            handshake += frag
            hello = _parse_handshake(handshake)
            if hello is not None:
                return hello
        elif rtype not in (CCS, APPDATA):
            break  # not TLS at all
    if alert_desc is not None:
        return dataclasses.replace(NO_HELLO, alert=alert_desc)
    return NO_HELLO


def _parse_handshake(blob: bytes) -> Optional[ServerHello]:
    pos = 0
    while pos + 4 <= len(blob):
        mtype = blob[pos]
        mlen = struct.unpack("!I", b"\x00" + blob[pos + 1 : pos + 4])[0]
        if pos + 4 + mlen > len(blob):
            return None  # fragment incomplete; caller feeds more records
        if mtype == HELLO_SERVER:
            return _parse_server_hello(blob[pos + 4 : pos + 4 + mlen])
        pos += 4 + mlen
    return None


def _parse_server_hello(body: bytes) -> Optional[ServerHello]:
    try:
        pos = 0
        legacy = struct.unpack("!H", body[pos : pos + 2])[0]
        pos += 2 + 32  # random
        sid_len = body[pos]
        pos += 1 + sid_len
        cipher = struct.unpack("!H", body[pos : pos + 2])[0]
        pos += 2 + 1  # compression
        exts: list[int] = []
        version = legacy
        alpn = b""
        if pos + 2 <= len(body):
            ext_total = struct.unpack("!H", body[pos : pos + 2])[0]
            pos += 2
            end = min(pos + ext_total, len(body))
            while pos + 4 <= end:
                etype, elen = struct.unpack("!HH", body[pos : pos + 4])
                data = body[pos + 4 : pos + 4 + elen]
                pos += 4 + elen
                exts.append(etype)
                if etype == EXT_SUPPORTED_VERSIONS and len(data) >= 2:
                    version = struct.unpack("!H", data[:2])[0]
                elif etype == EXT_ALPN and len(data) >= 3:
                    # ALPN: u16 list len, u8 name len, name
                    nlen = data[2]
                    alpn = data[3 : 3 + nlen]
        return ServerHello(
            version=version,
            legacy_version=legacy,
            cipher=cipher,
            extensions=tuple(exts),
            alpn=alpn,
        )
    except (IndexError, struct.error):
        return None
