"""The port's ssl scanner (swarm_tpu_torch.worker.sslscan) against the
JAX package's.

A local TLS server with a certificate generated as the reference tests
generate it (``tests/test_ssl_templates.py``): handshake documents,
findings over ssl templates of the reference corpus's kinds (a
self-signed dsl check fed by internal json extractors, extractor-only
version and SAN templates, an expiry check, version-pinned deprecated
protocols), the port fan-out of portless targets and the output lines
must be equal. The scanner does no device work.
"""

import dataclasses
import textwrap

import pytest
import yaml

from swarm_tpu.fingerprints.nuclei import parse_template as j_parse
from swarm_tpu.worker import sslscan as j_sslscan
from swarm_tpu_torch.fingerprints.nuclei import parse_template as t_parse
from swarm_tpu_torch.worker import sslscan as t_sslscan
from test_ssl_templates import _make_cert, _tls_server, tls_port  # noqa: F401

SELF_SIGNED = """\
id: mini-self-signed
info:
  severity: low
ssl:
  - address: "{{Host}}:{{Port}}"
    matchers:
      - type: dsl
        name: self-signed
        dsl: ["common_name == issuer_common_name"]
    extractors:
      - type: json
        name: common_name
        internal: true
        json: [".common_name[]"]
      - type: json
        name: issuer_common_name
        internal: true
        json: [".issuer_common_name[]"]
"""

VERSION = """\
id: mini-tls-version
info:
  severity: info
ssl:
  - address: "{{Host}}:{{Port}}"
    extractors:
      - type: json
        json: [".tls_version"]
"""

DNS_NAMES = """\
id: mini-dns-names
info:
  severity: info
ssl:
  - address: "{{Host}}:{{Port}}"
    extractors:
      - type: json
        json: [".dns_names[]"]
"""

EXPIRED = """\
id: mini-expired
info:
  severity: medium
ssl:
  - address: "{{Host}}:{{Port}}"
    matchers:
      - type: dsl
        dsl: ["unixtime() > not_after"]
"""

DEPRECATED = """\
id: mini-deprecated
info:
  severity: info
ssl:
  - address: "{{Host}}:{{Port}}"
    min_version: sslv3
    max_version: sslv3
    matchers:
      - type: dsl
        dsl: ["tls_version == 'ssl30'"]
  - address: "{{Host}}:{{Port}}"
    min_version: tls10
    max_version: tls11
    matchers:
      - type: word
        part: body
        words: ["tls1"]
"""

HTTP = """\
id: not-ssl
info:
  severity: info
requests:
  - method: GET
    path: ["{{BaseURL}}"]
    matchers:
      - type: word
        words: ["x"]
"""

DOCS = [SELF_SIGNED, VERSION, DNS_NAMES, EXPIRED, DEPRECATED, HTTP]


def pair() -> tuple:
    raws = [yaml.safe_load(textwrap.dedent(d)) for d in DOCS]
    return [j_parse(r) for r in raws], [t_parse(r) for r in raws]


def scan_both(lines: list, default_ports=None) -> tuple:
    j_templates, t_templates = pair()
    j_found, j_stats = j_sslscan.SslScanner(j_templates, concurrency=4, timeout=5.0).scan(
        lines, default_ports=default_ports)
    t_found, t_stats = t_sslscan.SslScanner(t_templates, concurrency=4, timeout=5.0).scan(
        lines, default_ports=default_ports)
    assert [dataclasses.asdict(f) for f in t_found] == [dataclasses.asdict(f) for f in j_found]
    assert t_stats == j_stats
    assert t_sslscan.format_lines(t_found) == j_sslscan.format_lines(j_found)
    assert t_sslscan.format_findings(t_found) == j_sslscan.format_findings(j_found)
    return t_found, t_stats


def test_parse_target_equal():
    for line in ("example.com", "example.com:8443", "https://example.com/x", "  # c", "",
                 "[2001:db8::1]", "[2001:db8::1]:8443", "[::1]:x", "::1", "h:notaport"):
        assert t_sslscan._parse_target(line) == j_sslscan._parse_target(line)
    assert t_sslscan.PLAINTEXT_PORTS == j_sslscan.PLAINTEXT_PORTS
    assert t_sslscan._VERSIONS == j_sslscan._VERSIONS


def test_handshake_doc_equal(tls_port):  # noqa: F811
    t_doc = t_sslscan.handshake("127.0.0.1", tls_port, timeout=5.0)
    assert t_doc == j_sslscan.handshake("127.0.0.1", tls_port, timeout=5.0)
    assert t_doc["common_name"] == ["selfie.test"] and t_doc["self_signed"] is True
    assert t_sslscan.handshake("127.0.0.1", tls_port, "sslv3", "sslv3", timeout=2.0) is None
    assert t_sslscan.handshake("127.0.0.1", 1, timeout=1.0) is None


def test_scanner_equal(tls_port):  # noqa: F811
    found, stats = scan_both([f"127.0.0.1:{tls_port}", "127.0.0.1:1", "# c"])
    ids = {f.template_id for f in found}
    assert ids == {"mini-self-signed", "mini-tls-version", "mini-dns-names"}
    [ss] = [f for f in found if f.template_id == "mini-self-signed"]
    assert ss.matcher_names == ["self-signed"] and ss.severity == "low"
    assert stats == {"targets": 2, "templates": 5, "hits": 3}


def test_scanner_expired_equal(tmp_path):
    cert, key = _make_cert(tmp_path, expired=True)
    port, stop = _tls_server(cert, key)
    try:
        found, _stats = scan_both([f"127.0.0.1:{port}"])
        assert "mini-expired" in {f.template_id for f in found}
    finally:
        stop.set()


def test_portless_targets_follow_default_ports_equal(tls_port):  # noqa: F811
    found, stats = scan_both(["127.0.0.1", f"127.0.0.1:{tls_port}"],
                             default_ports=[tls_port, 1, tls_port])
    assert stats["targets"] == 2 and {f.port for f in found} == {tls_port}
