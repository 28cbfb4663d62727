"""Parsed fingerprint-template model and the response record it matches.

This is the framework-neutral form between the YAML corpus and the two
match engines (exact CPU oracle in ``ops/cpu_ref.py``, tensor DB in
``fingerprints/compile.py``). The matcher DSL surface mirrors what the
reference corpus actually uses (SURVEY.md §2.3: word 6,895 / status
2,558 / regex 1,779 / dsl 766 / kval 44 / json 23 / xpath 7 / binary 6;
parts body/header/interactsh_protocol; and/or conditions; negative and
named matchers; regex/kval extractors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

# Matcher types understood by the engines. kval/json/xpath (74 uses in
# the corpus) are parsed but marked unsupported-on-device; they evaluate
# on the host path only.
MATCHER_TYPES = (
    "word",
    "regex",
    "status",
    "size",
    "binary",
    "dsl",
    "kval",
    "json",
    "xpath",
)

# Response parts a matcher can address. "all" = header + body. For raw
# TCP (network templates) body/raw/all alias the banner bytes.
PARTS = ("body", "header", "all", "raw", "interactsh_protocol", "host")


@dataclasses.dataclass
class Matcher:
    type: str
    part: str = "body"
    words: list[str] = dataclasses.field(default_factory=list)
    regex: list[str] = dataclasses.field(default_factory=list)
    status: list[int] = dataclasses.field(default_factory=list)
    size: list[int] = dataclasses.field(default_factory=list)
    binary: list[str] = dataclasses.field(default_factory=list)  # hex strings
    dsl: list[str] = dataclasses.field(default_factory=list)
    kval: list[str] = dataclasses.field(default_factory=list)
    condition: str = "or"  # across this matcher's words/regexes/...
    negative: bool = False
    case_insensitive: bool = False
    name: Optional[str] = None

    def payload_count(self) -> int:
        return len(
            self.words or self.regex or self.status or self.size or self.binary
            or self.dsl or self.kval
        )


@dataclasses.dataclass
class Extractor:
    type: str  # regex | kval | json | xpath | dsl
    part: str = "body"
    name: Optional[str] = None
    regex: list[str] = dataclasses.field(default_factory=list)
    kval: list[str] = dataclasses.field(default_factory=list)
    json: list[str] = dataclasses.field(default_factory=list)  # jq-style paths
    xpath: list[str] = dataclasses.field(default_factory=list)
    attribute: Optional[str] = None  # xpath: extract this attr, else text
    group: int = 0
    internal: bool = False


@dataclasses.dataclass
class Operation:
    """One request/probe block inside a template.

    For http templates this is one ``requests`` entry (method + paths or
    raw requests); for network templates one ``network`` entry (inputs +
    hosts). The probe half is metadata consumed by the I/O front-end;
    the matcher half is what the match engines evaluate against the
    response.
    """

    matchers: list[Matcher] = dataclasses.field(default_factory=list)
    matchers_condition: str = "or"
    extractors: list[Extractor] = dataclasses.field(default_factory=list)
    # --- probe metadata ---
    method: Optional[str] = None
    paths: list[str] = dataclasses.field(default_factory=list)
    raw: list[str] = dataclasses.field(default_factory=list)
    headers: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    body: str = ""
    payloads: dict = dataclasses.field(default_factory=dict)  # fuzz lists
    attack: str = "batteringram"  # payload combination mode
    inputs: list[bytes] = dataclasses.field(default_factory=list)  # network send
    hosts: list[str] = dataclasses.field(default_factory=list)
    read_size: Optional[int] = None
    redirects: bool = False
    max_redirects: int = 0
    # dns protocol: record type + query-name template ("{{FQDN}}")
    dns_type: str = ""
    dns_name: str = ""
    # file protocol: extension gate (lowercased, no dot; "all" = any).
    # Reference corpus: worker/artifacts/templates/file/**.yaml and the
    # standalone worker/artifacts/s3-bucket.yaml:7-10.
    extensions: list[str] = dataclasses.field(default_factory=list)
    # ssl protocol: handshake version pin (nuclei names: sslv3, tls10,
    # tls11, tls12, tls13; "" = negotiate freely). Reference corpus:
    # worker/artifacts/templates/ssl/deprecated-tls.yaml pins per entry.
    ssl_min_version: str = ""
    ssl_max_version: str = ""
    # headless protocol: the raw browser action list (dicts with
    # "action"/"args"/"name"), e.g. reference corpus
    # worker/artifacts/templates/headless/*.yaml. Executed by
    # worker/headless.py's browserless subset.
    steps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Template:
    id: str
    protocol: str  # http | network | dns | file | headless | ssl | workflow
    severity: str = "info"
    name: Optional[str] = None
    tags: list[str] = dataclasses.field(default_factory=list)
    operations: list[Operation] = dataclasses.field(default_factory=list)
    source_path: Optional[str] = None
    # Raw parsed YAML for fields the model doesn't lift (workflows etc.)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def all_matchers(self) -> list[tuple[int, Matcher]]:
        out = []
        for op_idx, op in enumerate(self.operations):
            out.extend((op_idx, m) for m in op.matchers)
        return out


@dataclasses.dataclass
class Response:
    """One observed (host, port) response row — the unit the engines match.

    The TPU path batches these into fixed-shape padded arrays
    (``ops/encoding.py``); the CPU oracle consumes them directly.
    """

    host: str = ""
    port: int = 0
    status: int = 0
    body: bytes = b""
    header: bytes = b""
    duration_s: float = 0.0
    # For raw TCP banners, set banner and leave body/header empty.
    banner: Optional[bytes] = None
    # Whether the probe ran over TLS; None = unknown (port heuristic
    # applies when rendering URLs).
    tls: Optional[bool] = None
    # False = the probe never got a response (unresolvable/unreachable).
    # Dead rows are never matched — nuclei produces no output for failed
    # requests, and negative matchers must not fire on an empty phantom
    # response.
    alive: bool = True
    # Out-of-band interactions correlated to this row's request (filled
    # by worker/oob.py's callback listener after the poll window).
    # ``interactsh_protocol``/``interactsh_request`` matcher parts read
    # these; empty = no interaction observed (matchers stay False, the
    # no-OOB-configured behavior).
    oob_protocols: tuple = ()  # e.g. ("http",), ("dns", "http")
    oob_requests: bytes = b""  # raw callback requests, concatenated
    oob_ips: tuple = ()  # remote addresses (interactsh_ip extractor)

    def part(self, name: str) -> bytes:
        # Canonical part aliasing — MUST stay in lockstep with
        # encoding.PART_TO_STREAM (which is derived from this table) so the
        # oracle and the device agree on what every part name means.
        if self.banner is not None and name in (
            "body", "raw", "all", "data", "response", "body_1", "body_2",
        ):
            return self.banner
        if name in ("body", "data", "body_1", "body_2"):
            return self.body
        if name in ("header", "all_headers"):
            return self.header
        if name in ("all", "raw", "response"):
            return self.header + b"\r\n" + self.body if self.header else self.body
        if name == "host":
            return self.host.encode()
        if name == "interactsh_protocol":
            return " ".join(self.oob_protocols).encode()
        if name == "interactsh_request":
            return self.oob_requests
        return b""

    @property
    def content_length(self) -> int:
        return len(self.body if self.banner is None else self.banner)
