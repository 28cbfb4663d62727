"""JARM-style active TLS fingerprinting + JA3S, over the native scan I/O.

Ten crafted ClientHellos (varying TLS version, cipher order, GREASE,
ALPN, extension shape) are sent to each target; the server's choices —
cipher, version, ALPN, extension order — across all ten probes form the
fingerprint:

    62 chars = 30 (3 per probe: 2-hex cipher index + 1 version code)
             + 32 (truncated sha256 of the concatenated extension
                   choices across probes)

The construction mirrors the public JARM scheme (Salesforce): identical
probe *shapes* (forward/reverse/top-half/bottom-half/middle-out cipher
orders, 1.1/1.2/1.3 versions, no-overlap probe) and the same
30+32 output split; the byte-level encoding tables are this module's
own, so hashes are self-consistent within the framework rather than
comparable to upstream JARM strings. The output field is therefore
named ``jarmx`` (JARM-style, not upstream-comparable) — clustering and
intra-framework comparison are first-class. JA3S is the standard
algorithm (md5 of "version,cipher,ext-list" in decimals) and matches
any compliant implementation.

For interop with public TLS-intel feeds, :func:`upstream_jarm`
implements the upstream *encoding pipeline* exactly (per-probe raw
``cipher|version|alpn|extensions`` components; cipher encoded as the
zero-padded 1-based index into the upstream cipher-order table;
version as ``"abcdef"[minor]``; tail = sha256 of the concatenated
``alpn+extensions`` components, first 32 hex chars). The cipher-order
table ships in-repo as public-spec config data
(swarm_tpu_torch/tls/jarm_table.py — a reconstruction with its provenance
bound documented there), so ``TlsFingerprint.jarm`` populates out of
the box; ``SWARM_JARM_CIPHER_TABLE`` (path to a file with one
lowercase hex cipher per line, in the upstream list's order,
extracted from the Salesforce jarm repo) remains the authoritative
operator override and replaces the default entirely. The encoding
layer itself is held to the JAX package's copy by tests/test_torch_tls.py.

Fingerprints feed the density-peaks clustering kernel
(swarm_tpu_torch/ops/cluster.py) — BASELINE.json config #5.

This module is the port's own copy of ``swarm_tpu/tls/jarm.py``; the two
must give equal results on equal server flights.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Sequence

from swarm_tpu_torch.tls import wire

# Canonical cipher table: every suite the probes may offer, in one fixed
# order — a chosen cipher encodes as its 2-hex-digit index here.
CIPHERS_12 = (
    0xC02C, 0xC030, 0x009F, 0xCCA9, 0xCCA8, 0xCCAA, 0xC02B, 0xC02F,
    0x009E, 0xC024, 0xC028, 0x006B, 0xC023, 0xC027, 0x0067, 0xC00A,
    0xC014, 0x0039, 0xC009, 0xC013, 0x0033, 0x009D, 0x009C, 0x003D,
    0x003C, 0x0035, 0x002F, 0x00FF,
)
CIPHERS_13 = (0x1301, 0x1302, 0x1303, 0x1304)
CANONICAL = CIPHERS_13 + CIPHERS_12

_VERSION_CODE = {
    wire.TLS10: "1",
    wire.TLS11: "2",
    wire.TLS12: "3",
    wire.TLS13: "4",
    0x0300: "0",
}


def _top_half(c: Sequence[int]) -> tuple[int, ...]:
    return tuple(c[: len(c) // 2])


def _bottom_half(c: Sequence[int]) -> tuple[int, ...]:
    return tuple(c[len(c) // 2 :])


def _middle_out(c: Sequence[int]) -> tuple[int, ...]:
    out = []
    mid = len(c) // 2
    for k in range(len(c)):
        idx = mid + (k + 1) // 2 * (1 if k % 2 == 0 else -1)
        if 0 <= idx < len(c):
            out.append(c[idx])
    seen: set[int] = set()
    dedup = [x for x in out if not (x in seen or seen.add(x))]
    for x in c:  # parity edge: keep every cipher exactly once
        if x not in seen:
            dedup.append(x)
            seen.add(x)
    return tuple(dedup)


def probe_set(hostname: str) -> list[wire.HelloSpec]:
    """The 10 JARM probes for one target, deterministic order."""
    c12 = CIPHERS_12
    both = CIPHERS_13 + CIPHERS_12
    mk = wire.HelloSpec
    return [
        mk(hello_version=wire.TLS12, ciphers=c12, hostname=hostname),
        mk(hello_version=wire.TLS12, ciphers=c12[::-1], hostname=hostname),
        mk(hello_version=wire.TLS12, ciphers=_top_half(c12), hostname=hostname,
           alpn=(b"http/0.9", b"http/1.0", b"spdy/3", b"h2c")),
        mk(hello_version=wire.TLS12, ciphers=_bottom_half(c12), hostname=hostname,
           alpn=(), minimal=True),
        mk(hello_version=wire.TLS12, ciphers=_middle_out(c12), hostname=hostname,
           grease=True),
        mk(record_version=wire.TLS10, hello_version=wire.TLS11,
           ciphers=_middle_out(c12), hostname=hostname, alpn=(b"http/1.1",)),
        mk(hello_version=wire.TLS12, ciphers=both, hostname=hostname,
           offer_tls13=True),
        mk(hello_version=wire.TLS12, ciphers=both[::-1], hostname=hostname,
           offer_tls13=True),
        mk(hello_version=wire.TLS12, ciphers=(0x0A1A, 0x2A2A, 0x3A3A),
           hostname=hostname, offer_tls13=True, grease=True),
        mk(hello_version=wire.TLS12, ciphers=_middle_out(both),
           hostname=hostname, offer_tls13=True, grease=True,
           extension_order_reversed=True),
    ]


NUM_PROBES = 10
EMPTY_JARM = "0" * 62


def _probe_code(hello: wire.ServerHello) -> tuple[str, str]:
    """One probe's 3-char code + its extension-choice string."""
    if not hello.ok:
        return "000", ""
    try:
        idx = CANONICAL.index(hello.cipher) + 1
    except ValueError:
        idx = 0xFE  # server chose something we never offered
    code = f"{idx:02x}" + _VERSION_CODE.get(hello.version, "9")
    ext_str = (
        f"{hello.version:04x}|{hello.alpn.decode('latin1')}|"
        + "-".join(f"{e:04x}" for e in hello.extensions)
    )
    return code, ext_str


def jarm_hash(hellos: Sequence[Optional[wire.ServerHello]]) -> str:
    """10 parsed server flights → 62-char fingerprint."""
    assert len(hellos) == NUM_PROBES
    codes = []
    ext_parts = []
    for h in hellos:
        code, ext_str = _probe_code(h if h is not None else wire.NO_HELLO)
        codes.append(code)
        ext_parts.append(ext_str)
    head = "".join(codes)
    if head == "000" * NUM_PROBES:
        return EMPTY_JARM
    joined = ",".join(ext_parts)
    tail = (
        hashlib.sha256(joined.encode("latin1")).hexdigest()[:32]
        if any(ext_parts)
        else "0" * 32
    )
    return head + tail


def ja3s(hello: wire.ServerHello) -> str:
    """Standard JA3S: md5("version,cipher,ext1-ext2-...") decimals."""
    if not hello.ok:
        return ""
    s = (
        f"{hello.legacy_version},{hello.cipher},"
        + "-".join(str(e) for e in hello.extensions)
    )
    return hashlib.md5(s.encode()).hexdigest()


# --- upstream (Salesforce) JARM encoding pipeline --------------------------


def upstream_raw_result(hello: wire.ServerHello) -> str:
    """One probe's raw component string in the upstream format:
    ``cipher|version|alpn|ext1-ext2-...`` (lowercase 4-hex fields),
    empty components for a failed probe."""
    if not hello.ok:
        return "|||"
    exts = "-".join(f"{e:04x}" for e in hello.extensions)
    return (
        f"{hello.cipher:04x}|{hello.version:04x}|"
        f"{hello.alpn.decode('latin1')}|{exts}"
    )


@functools.lru_cache(maxsize=8)
def _cipher_codes(table: tuple) -> dict:
    """cipher hex -> upstream code, one dict per table (the hot
    fingerprint path must not re-scan the table per probe)."""
    return {c: f"{i + 1:x}".zfill(2) for i, c in enumerate(table)}


def _upstream_cipher_code(cipher_hex: str, table: Sequence[str]) -> str:
    if not cipher_hex:
        return "00"
    codes = _cipher_codes(tuple(table))
    # upstream cipher_bytes' search loop falls through to
    # count = len(table) + 1 when the cipher is absent — mirror it
    return codes.get(cipher_hex, f"{len(table) + 1:x}".zfill(2))


def _upstream_version_code(version_hex: str) -> str:
    if not version_hex:
        return "0"
    minor = int(version_hex[3], 16)
    if minor > 5:
        # upstream's "abcdef"[minor] would throw here too — it can only
        # ever see versions its own probes negotiated. A server feeding
        # us junk (0x4141) has no upstream-comparable encoding at all.
        raise ValueError(f"version {version_hex!r} outside JARM's domain")
    return "abcdef"[minor]


def upstream_jarm(raw_results: Sequence[str], table: Sequence[str]) -> str:
    """Upstream JARM hash from 10 raw component strings + the upstream
    cipher-order ``table`` (lowercase 4-hex entries, upstream order).

    Exact upstream scheme: 3 chars per probe (2-hex 1-based cipher
    index, 1-char version letter) + first 32 hex chars of sha256 over
    the concatenated ``alpn + extensions`` components."""
    assert len(raw_results) == NUM_PROBES
    if all(r == "|||" for r in raw_results):
        return "0" * 62
    fuzzy = []
    alpns_and_ext = []
    for raw in raw_results:
        cipher_hex, version_hex, alpn, exts = raw.split("|", 3)
        fuzzy.append(_upstream_cipher_code(cipher_hex, table))
        fuzzy.append(_upstream_version_code(version_hex))
        alpns_and_ext.append(alpn)
        alpns_and_ext.append(exts)
    # upstream hashes UNCONDITIONALLY once any probe succeeded —
    # an extension-less server gets sha256("")[:32] ("e3b0c442…"),
    # not zeros
    joined = "".join(alpns_and_ext)
    tail = hashlib.sha256(joined.encode()).hexdigest()[:32]
    return "".join(fuzzy) + tail


_UPSTREAM_TABLE: Optional[tuple] = None
_UPSTREAM_TABLE_LOADED = False


def upstream_cipher_table() -> Optional[tuple]:
    """The upstream cipher-order table: the operator-supplied one when
    ``SWARM_JARM_CIPHER_TABLE`` is set (authoritative — one lowercase
    hex cipher per line, in the Salesforce list's order), else the
    in-repo public-spec reconstruction
    (swarm_tpu_torch/tls/jarm_table.DEFAULT_UPSTREAM_TABLE), so the
    ``jarm`` field populates out of the box."""
    global _UPSTREAM_TABLE, _UPSTREAM_TABLE_LOADED
    if not _UPSTREAM_TABLE_LOADED:
        import os

        path = os.environ.get("SWARM_JARM_CIPHER_TABLE", "")
        if not path:
            from swarm_tpu_torch.tls.jarm_table import DEFAULT_UPSTREAM_TABLE

            _UPSTREAM_TABLE = DEFAULT_UPSTREAM_TABLE
            _UPSTREAM_TABLE_LOADED = True
            return _UPSTREAM_TABLE
        # the operator EXPLICITLY configured upstream comparability; a
        # broken table must fail loudly, not silently produce
        # non-comparable hashes
        try:
            with open(path) as fh:
                entries = tuple(
                    ln.strip().lower()
                    for ln in fh
                    if ln.strip() and not ln.strip().startswith("#")
                )
        except OSError as e:
            raise RuntimeError(
                f"SWARM_JARM_CIPHER_TABLE={path!r} is unreadable: {e}"
            ) from e
        bad = [c for c in entries if len(c) != 4
               or any(ch not in "0123456789abcdef" for ch in c)]
        if bad or not entries:
            raise RuntimeError(
                f"SWARM_JARM_CIPHER_TABLE={path!r} is malformed: "
                f"{'empty' if not entries else 'bad entries '}"
                f"{bad[:3]} (want one lowercase 4-hex cipher per "
                "line, upstream order)"
            )
        _UPSTREAM_TABLE = entries
        _UPSTREAM_TABLE_LOADED = True
    return _UPSTREAM_TABLE


@dataclasses.dataclass
class TlsFingerprint:
    host: str
    port: int
    jarmx: str  # JARM-style but NOT upstream-comparable (own tables)
    ja3s: str  # from the first successful probe
    alive: bool  # at least one probe produced a ServerHello
    open: bool = False  # TCP port accepted a connection
    # upstream-encoded JARM, on by default via the in-repo cipher table
    # (jarm_table.py; SWARM_JARM_CIPHER_TABLE overrides); "" only when
    # the server's version has no upstream encoding
    jarm: str = ""

    def line(self) -> str:
        if self.alive:
            up = f" jarm={self.jarm}" if self.jarm else ""
            return (
                f"{self.host}:{self.port} jarmx={self.jarmx}"
                f" ja3s={self.ja3s or '-'}{up}"
            )
        # the port-open fact from the socket layer survives even when no
        # probe elicited TLS — an open non-TLS service is not "dead"
        return f"{self.host}:{self.port} [{'open not-tls' if self.open else 'dead'}]"


def fingerprint_from_banners(
    host: str, port: int, banners: Sequence[bytes], open_: bool = True
) -> TlsFingerprint:
    """10 raw server flights (empty = no response) → TlsFingerprint."""
    hellos = [wire.parse_server_flight(b) if b else wire.NO_HELLO for b in banners]
    first_ok = next((h for h in hellos if h.ok), None)
    jh = jarm_hash(hellos)
    table = upstream_cipher_table()
    up = ""
    if table:
        try:
            up = upstream_jarm(
                [upstream_raw_result(h) for h in hellos], table
            )
        except ValueError:
            up = ""  # junk server version: no upstream encoding exists
    return TlsFingerprint(
        host=host,
        port=port,
        jarmx=jh,
        ja3s=ja3s(first_ok) if first_ok else "",
        alive=jh != EMPTY_JARM,
        open=open_,
        jarm=up,
    )
