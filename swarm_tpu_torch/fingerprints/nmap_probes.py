"""nmap-service-probes parser + service fingerprint model (a copy of
``swarm_tpu/fingerprints/nmap_probes.py``).

The original system's nmap module ran ``nmap -sV`` (service/version
detection, ``modules/nmap.json``), whose brain is the
``nmap-service-probes`` database: probe payloads to send per port, and
per-probe ordered ``match``/``softmatch`` regex directives that name the
service and extract product/version fields.

This module parses that file format (the real system DB when present,
else the bundled mini DB at ``swarm_tpu_torch/data/service-probes.txt``) into
a neutral model the device match path consumes: every match directive
lowers to a regex matcher over the banner stream (compiled through the
same word-table/required-literal infrastructure as the template corpus),
with host-side confirmation supplying the capture groups for version
template substitution (``$1``..``$9``).

Format reference (publicly documented by nmap):
  Probe <TCP|UDP> <name> q|<payload>|
  ports <spec>[,spec...]   sslports <spec>   rarity <n>
  totalwaitms <ms>         fallback <name>[,name...]
  match <service> m<delim><regex><delim>[flags] [p/…/ v/…/ i/…/ o/…/ h/…/ cpe:/…/]
  softmatch <service> m<delim><regex><delim>[flags]
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from swarm_tpu_torch.fingerprints.regexlin import quiet_warnings
from typing import Optional

BUNDLED_DB = Path(__file__).resolve().parent.parent / "data" / "service-probes.txt"
SYSTEM_DB = Path("/usr/share/nmap/nmap-service-probes")


@dataclasses.dataclass
class ServiceMatch:
    service: str
    pattern: str                    # raw regex source (perl-ish)
    flags: str = ""                 # subset of "si"
    soft: bool = False
    product: Optional[str] = None   # version-info templates, $N backrefs
    version: Optional[str] = None
    info: Optional[str] = None
    ostype: Optional[str] = None
    hostname: Optional[str] = None
    cpe: list[str] = dataclasses.field(default_factory=list)
    line_no: int = 0

    def compile(self) -> Optional[re.Pattern]:
        """Python re over raw bytes; None when the pattern uses PCRE
        constructs re lacks (those matches are skipped, counted by the
        loader)."""
        f = re.DOTALL if "s" in self.flags else 0
        if "i" in self.flags:
            f |= re.IGNORECASE
        try:
            # nmap DB patterns with literal '[[' trip re's nested-set
            # FutureWarning; their current semantics are the contract
            with quiet_warnings():
                return re.compile(self.pattern.encode("latin-1"), f)
        except (re.error, UnicodeEncodeError):
            return None


@dataclasses.dataclass
class ServiceProbe:
    proto: str                      # TCP | UDP
    name: str
    payload: bytes = b""
    ports: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    sslports: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    rarity: int = 5
    totalwaitms: int = 6000
    fallback: list[str] = dataclasses.field(default_factory=list)
    matches: list[ServiceMatch] = dataclasses.field(default_factory=list)

    def covers_port(self, port: int) -> bool:
        return any(lo <= port <= hi for lo, hi in self.ports)


_ESCAPES = {
    b"0": b"\0", b"a": b"\a", b"b": b"\b", b"f": b"\f", b"n": b"\n",
    b"r": b"\r", b"t": b"\t", b"v": b"\v", b"\\": b"\\",
}


def unescape_payload(raw: str) -> bytes:
    """nmap q|...| payload escapes: C-style chars + \\xHH."""
    data = raw.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(data):
        ch = data[i : i + 1]
        if ch != b"\\" or i + 1 >= len(data):
            out += ch
            i += 1
            continue
        nxt = data[i + 1 : i + 2]
        if nxt == b"x" and i + 3 < len(data):
            out.append(int(data[i + 2 : i + 4], 16))
            i += 4
        elif nxt in _ESCAPES:
            out += _ESCAPES[nxt]
            i += 2
        else:
            out += nxt
            i += 2
    return bytes(out)


def parse_port_spec(spec: str) -> list[tuple[int, int]]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, _, hi = part.partition("-")
            out.append((int(lo), int(hi)))
        else:
            out.append((int(part), int(part)))
    return out


_VERSION_FIELD_RE = re.compile(r"(cpe:|[pvidoh])(.)")


def _parse_version_info(rest: str, m: ServiceMatch) -> None:
    """p/…/ v/…/ i/…/ d/…/ o/…/ h/…/ cpe:/…/[a] annotations after the
    regex. Fields are consumed strictly left-to-right at field
    boundaries — never scanned for inside a previous field's value
    (``d/switch/`` must not yield a phantom ``h/`` field)."""
    i = 0
    n = len(rest)
    while i < n:
        if rest[i].isspace():
            i += 1
            continue
        mo = _VERSION_FIELD_RE.match(rest, i)
        if not mo:
            return  # unrecognized token: stop rather than mis-slice
        key, delim = mo.group(1), mo.group(2)
        start = mo.end()
        end = rest.find(delim, start)
        if end < 0:
            return
        value = rest[start:end]
        i = end + 1
        # cpe may carry a trailing 'a' (applies-to-app) flag
        while i < n and not rest[i].isspace():
            i += 1
        if key == "p":
            m.product = value
        elif key == "v":
            m.version = value
        elif key == "i":
            m.info = value
        elif key == "o":
            m.ostype = value
        elif key == "h":
            m.hostname = value
        elif key == "d":
            pass  # devicetype: parsed (so later fields stay aligned), not lifted
        elif key == "cpe:":
            m.cpe.append(value)


def _parse_match(line: str, line_no: int, soft: bool) -> Optional[ServiceMatch]:
    # match <service> m<delim><regex><delim>[flags] [version info]
    body = line.split(None, 1)[1] if " " in line else ""
    parts = body.split(None, 1)
    if len(parts) < 2:
        return None
    service, rest = parts
    if not rest.startswith("m") or len(rest) < 3:
        return None
    delim = rest[1]
    end = rest.find(delim, 2)
    if end < 0:
        return None
    pattern = rest[2:end]
    tail = rest[end + 1 :]
    flags = ""
    while tail and tail[0] in "si":
        flags += tail[0]
        tail = tail[1:]
    m = ServiceMatch(
        service=service, pattern=pattern, flags=flags, soft=soft, line_no=line_no
    )
    _parse_version_info(tail.strip(), m)
    return m


def parse_probes(text: str) -> tuple[list[ServiceProbe], int]:
    """→ (probes, skipped_match_count). Directives before any Probe line
    (Exclude etc.) are ignored."""
    probes: list[ServiceProbe] = []
    current: Optional[ServiceProbe] = None
    skipped = 0
    for line_no, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        word = line.split(None, 1)[0]
        if word == "Probe":
            parts = line.split(None, 3)
            if len(parts) < 4:
                continue
            _, proto, name, rest = parts
            payload = b""
            if rest.startswith("q") and len(rest) >= 3:
                delim = rest[1]
                end = rest.find(delim, 2)
                if end >= 0:
                    payload = unescape_payload(rest[2:end])
            current = ServiceProbe(proto=proto.upper(), name=name, payload=payload)
            probes.append(current)
        elif current is None:
            continue
        elif word == "ports":
            current.ports = parse_port_spec(line.split(None, 1)[1])
        elif word == "sslports":
            current.sslports = parse_port_spec(line.split(None, 1)[1])
        elif word == "rarity":
            current.rarity = int(line.split(None, 1)[1])
        elif word == "totalwaitms":
            current.totalwaitms = int(line.split(None, 1)[1])
        elif word == "fallback":
            current.fallback = [f.strip() for f in line.split(None, 1)[1].split(",")]
        elif word in ("match", "softmatch"):
            m = _parse_match(line, line_no, soft=(word == "softmatch"))
            if m is None or m.compile() is None:
                skipped += 1
            else:
                current.matches.append(m)
    return probes, skipped


def load_probes(path: Optional[str | Path] = None) -> tuple[list[ServiceProbe], int]:
    """Load a probes DB: explicit path > system nmap DB > bundled mini DB."""
    p = Path(path) if path else (SYSTEM_DB if SYSTEM_DB.is_file() else BUNDLED_DB)
    return parse_probes(p.read_text(encoding="latin-1"))


_HELPER_RE = re.compile(
    r"\$P\((\d)\)"                                  # printable filter
    r"|\$SUBST\((\d),\"([^\"]*)\",\"([^\"]*)\"\)"   # substring replace
    r"|\$I\((\d),\"([<>])\"\)"                      # unsigned int from bytes
    r"|\$(\d)"                                      # plain backref
)


def substitute_version(template: Optional[str], mo: re.Match) -> Optional[str]:
    """Backref substitution in p/v/i templates: ``$1``..``$9`` plus the
    nmap helper functions ``$P(n)`` (strip non-printable bytes),
    ``$SUBST(n,"a","b")`` and ``$I(n,"<"|">")`` (endian-tagged unsigned
    int). Missing groups substitute empty."""
    if template is None:
        return None

    def group(idx: str) -> bytes:
        try:
            return mo.group(int(idx)) or b""
        except (IndexError, re.error):
            return b""

    def repl(m: re.Match) -> str:
        p, s_n, s_a, s_b, i_n, i_e, plain = m.groups()
        if p is not None:
            return bytes(b for b in group(p) if 32 <= b < 127).decode("ascii")
        if s_n is not None:
            return group(s_n).decode("latin-1", "replace").replace(s_a, s_b)
        if i_n is not None:
            return str(
                int.from_bytes(group(i_n), "little" if i_e == "<" else "big")
            )
        return group(plain).decode("latin-1", "replace")

    return _HELPER_RE.sub(repl, template).strip()
