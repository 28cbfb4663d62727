"""Typed DNS queries with dig-style answer rendering (dns templates) — a
copy of ``swarm_tpu/worker/dnsquery.py``; the ``active`` backend's DNS
pass sends its queries through it.

The native engine handles bulk A-record resolution
(``native/scanio.cpp: swarm_dns_resolve`` — the dnsx-equivalent hot
path). DNS *templates* are a long tail (17 in the corpus, SURVEY.md
§2.3) that query one specific record type (CNAME/MX/TXT/CAA/NS/PTR/A)
and match substrings of the rendered response — so this client favors
completeness of rdata rendering over raw throughput: one UDP socket,
all queries in flight, answers collected by id.

Rendered text is dig-like (``name. ttl IN TYPE rdata`` lines) — the
corpus matchers look for substrings like ``zendesk.com`` or
``amazonaws.com`` in the answer section, plus rcode words
(``SERVFAIL``/``REFUSED`` — servfail-refused-hosts.yaml), all present
in this rendering.
"""

from __future__ import annotations

import dataclasses
import random
import select
import socket
import struct
import time
from typing import Optional, Sequence

QTYPES = {
    "A": 1, "NS": 2, "CNAME": 5, "SOA": 6, "PTR": 12, "MX": 15,
    "TXT": 16, "AAAA": 28, "DS": 43, "CAA": 257,
}
_TYPE_NAMES = {v: k for k, v in QTYPES.items()}
_RCODES = {0: "NOERROR", 1: "FORMERR", 2: "SERVFAIL", 3: "NXDOMAIN",
           4: "NOTIMP", 5: "REFUSED"}


@dataclasses.dataclass
class DnsAnswer:
    name: str
    type_name: str
    ttl: int
    rdata: str

    def line(self) -> str:
        return f"{self.name}\t{self.ttl}\tIN\t{self.type_name}\t{self.rdata}"


@dataclasses.dataclass
class DnsReply:
    qname: str
    qtype: str
    rcode: str
    answers: list[DnsAnswer]

    def render(self) -> bytes:
        """dig-like text the matchers run over."""
        lines = [
            f";; ->>HEADER<<- opcode: QUERY, status: {self.rcode}",
            f";; QUESTION SECTION:\n;{self.qname}.\tIN\t{self.qtype}",
        ]
        if self.answers:
            lines.append(";; ANSWER SECTION:")
            lines.extend(a.line() for a in self.answers)
        return "\n".join(lines).encode("utf-8", "surrogateescape")


def _encode_qname(name: str) -> Optional[bytes]:
    out = b""
    for label in name.strip(".").split("."):
        try:
            raw = (
                label.encode("ascii")
                if label.isascii()
                else label.encode("idna")
            )
        except UnicodeError:
            return None
        if not raw or len(raw) > 63:
            return None
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def _read_name(
    pkt: bytes, off: int, depth: int = 0, hard_end: Optional[int] = None
) -> tuple[str, int]:
    """Decompress a domain name; returns (name, next offset).

    ``hard_end`` bounds the *inline* walk (an rdata boundary) — labels
    running past it are malformed and truncate the name. Compression
    pointers may legitimately jump anywhere earlier in the packet."""
    labels: list[str] = []
    limit = len(pkt) if hard_end is None else min(hard_end, len(pkt))
    while True:
        if off >= limit or depth > 16:
            return ".".join(labels), off
        length = pkt[off]
        if length == 0:
            return ".".join(labels), off + 1
        if (length & 0xC0) == 0xC0:
            if off + 2 > limit:
                return ".".join(labels), off + 2
            ptr = ((length & 0x3F) << 8) | pkt[off + 1]
            tail, _ = _read_name(pkt, ptr, depth + 1)
            if tail:
                labels.append(tail)
            return ".".join(labels), off + 2
        if off + 1 + length > limit:  # inline label crosses the boundary
            return ".".join(labels), limit
        labels.append(
            pkt[off + 1 : off + 1 + length].decode("latin-1")
        )
        off += 1 + length


def _render_rdata(pkt: bytes, off: int, rdlen: int, rtype: int) -> str:
    end = off + rdlen
    try:
        if rtype == 1 and rdlen == 4:  # A
            return socket.inet_ntoa(pkt[off:end])
        if rtype == 28 and rdlen == 16:  # AAAA
            return socket.inet_ntop(socket.AF_INET6, pkt[off:end])
        if rtype in (2, 5, 12):  # NS / CNAME / PTR
            return _read_name(pkt, off, hard_end=end)[0]
        if rtype == 15:  # MX: pref + name
            pref = struct.unpack("!H", pkt[off : off + 2])[0]
            return f"{pref} {_read_name(pkt, off + 2, hard_end=end)[0]}"
        if rtype == 16:  # TXT: length-prefixed strings, clamped to rdata
            parts = []
            pos = off
            while pos < end:
                ln = min(pkt[pos], end - pos - 1)
                parts.append(
                    '"' + pkt[pos + 1 : pos + 1 + ln].decode("latin-1") + '"'
                )
                pos += 1 + ln
            return " ".join(parts)
        if rtype == 257:  # CAA: flags, tag, value
            flags = pkt[off]
            tag_len = min(pkt[off + 1], max(0, end - off - 2))
            tag = pkt[off + 2 : off + 2 + tag_len].decode("latin-1")
            value = pkt[off + 2 + tag_len : end].decode("latin-1")
            return f'{flags} {tag} "{value}"'
        if rtype == 6:  # SOA
            mname, pos = _read_name(pkt, off, hard_end=end)
            rname, pos = _read_name(pkt, pos, hard_end=end)
            serial = struct.unpack("!I", pkt[pos : pos + 4])[0]
            return f"{mname} {rname} {serial}"
    except (IndexError, struct.error, OSError):
        pass
    return pkt[off:end].hex()


def parse_reply(pkt: bytes, qname: str, qtype: str) -> Optional[DnsReply]:
    if len(pkt) < 12:
        return None
    flags, qd, an = struct.unpack("!HHH", pkt[2:8])
    rcode = _RCODES.get(flags & 0xF, str(flags & 0xF))
    off = 12
    for _ in range(qd):
        _, off = _read_name(pkt, off)
        off += 4
    answers: list[DnsAnswer] = []
    for _ in range(an):
        name, off = _read_name(pkt, off)
        if off + 10 > len(pkt):
            break
        rtype, _rclass, ttl, rdlen = struct.unpack(
            "!HHIH", pkt[off : off + 10]
        )
        off += 10
        if off + rdlen > len(pkt):
            break
        answers.append(
            DnsAnswer(
                name=name + ".",
                type_name=_TYPE_NAMES.get(rtype, f"TYPE{rtype}"),
                ttl=ttl,
                rdata=_render_rdata(pkt, off, rdlen, rtype),
            )
        )
        off += rdlen
    return DnsReply(qname=qname, qtype=qtype, rcode=rcode, answers=answers)


def reverse_name(ip: str) -> str:
    return ".".join(reversed(ip.split("."))) + ".in-addr.arpa"


def query_batch(
    queries: Sequence[tuple[str, str]],
    resolvers: Sequence[str],
    timeout_ms: int = 2000,
    retries: int = 1,
    port: int = 53,
) -> list[Optional[DnsReply]]:
    """[(qname, qtype)] → replies (None = no/invalid response).

    Batches larger than the usable 16-bit id namespace are split into
    sequential sub-batches so arbitrarily large query lists work.
    """
    out: list[Optional[DnsReply]] = []
    for lo in range(0, len(queries), _MAX_BATCH):
        out.extend(
            _query_batch_one(
                queries[lo : lo + _MAX_BATCH],
                resolvers,
                timeout_ms=timeout_ms,
                retries=retries,
                port=port,
            )
        )
    return out


_MAX_BATCH = 60000  # ids per socket, below the 65536 id namespace


def _query_batch_one(
    queries: Sequence[tuple[str, str]],
    resolvers: Sequence[str],
    timeout_ms: int,
    retries: int,
    port: int,
) -> list[Optional[DnsReply]]:
    """One shared-socket wave of at most _MAX_BATCH queries.

    Transaction ids are a random permutation of the id space (not the
    query index), drawn from the OS CSPRNG — an off-path forger must
    guess the id, and observing earlier waves must not let it
    reconstruct PRNG state to predict later ones.
    """
    n = len(queries)
    out: list[Optional[DnsReply]] = [None] * n
    if n == 0 or not resolvers:
        return out
    ids = random.SystemRandom().sample(range(65536), n)
    id_to_idx = {qid: i for i, qid in enumerate(ids)}
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setblocking(False)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    except OSError:
        pass
    resolver_addrs = {(r, port) for r in resolvers}
    try:
        pending = set(range(n))
        packets: list[Optional[bytes]] = []
        for i, (qname, qtype) in enumerate(queries):
            enc = _encode_qname(qname)
            tcode = QTYPES.get(qtype.upper())
            if enc is None or tcode is None:
                packets.append(None)
                pending.discard(i)
                continue
            packets.append(
                struct.pack("!HHHHHH", ids[i], 0x0100, 1, 0, 0, 0)
                + enc
                + struct.pack("!HH", tcode, 1)
            )

        def accept(data: bytes, addr) -> None:
            # forged-reply hygiene for a security scanner: the source
            # must be a resolver we queried, QR must be set, and the
            # echoed question must match what we asked
            if addr not in resolver_addrs or len(data) < 12:
                return
            rid = id_to_idx.get(struct.unpack("!H", data[:2])[0])
            if rid is None or rid not in pending:
                return
            flags = struct.unpack("!H", data[2:4])[0]
            if not flags & 0x8000:  # not a response
                return
            qname, qtype = queries[rid]
            echoed, off = _read_name(data, 12)
            if echoed.lower().rstrip(".") != qname.lower().rstrip("."):
                return
            if off + 2 > len(data) or struct.unpack(
                "!H", data[off : off + 2]
            )[0] != QTYPES.get(qtype.upper()):
                return
            reply = parse_reply(data, qname, qtype)
            if reply is not None:
                out[rid] = reply
                pending.discard(rid)

        def drain() -> None:
            while True:
                try:
                    data, addr = sock.recvfrom(4096)
                except (BlockingIOError, OSError):
                    return
                accept(data, addr)

        for attempt in range(retries + 1):
            if not pending:
                break
            for sent, i in enumerate(sorted(pending)):
                pkt = packets[i]
                if pkt is None:
                    continue
                resolver = resolvers[(i + attempt) % len(resolvers)]
                try:
                    sock.sendto(pkt, (resolver, port))
                except OSError:
                    continue
                # interleave receives: replies arrive during the send
                # blast and would overflow the kernel buffer otherwise
                if sent % 128 == 127:
                    drain()
            deadline = time.monotonic() + timeout_ms / 1000.0
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                ready, _, _ = select.select([sock], [], [], left)
                if not ready:
                    break
                drain()
    finally:
        sock.close()
    return out
