"""The port's OOB interaction listener (swarm_tpu_torch.worker.oob), its
engine path and the active scanner's OOB pass, against the JAX package.

The same callbacks reach one listener of each package and must be
recorded alike; the wire helpers must give equal bytes; the engines
must match the interactsh parts alike; and ``ActiveScanner`` with an
``oob`` spec must give the reference's hits and stats against the
reference tests' vulnerable and patched servers. Tokens are random per
process (``secrets`` in ``oob.py``): here both modules draw them from
one counter, so that the two scans mint the same tokens.
"""

import dataclasses
import os
import random
import socket
import threading

import pytest
import torch

from swarm_tpu.fingerprints import load_corpus as j_load_corpus
from swarm_tpu.fingerprints import model as j_model
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.worker import active as j_active
from swarm_tpu.worker import oob as j_oob
from swarm_tpu_torch.fingerprints import model as t_model
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.ops.engine import MatchEngine, _dedup_rows
from swarm_tpu_torch.worker import active as t_active
from swarm_tpu_torch.worker import oob as t_oob
from test_match_parity import fuzz_rows
from test_oob_listener import _dns_query
from test_oob_parity import _oob_rows, _write_corpus
from test_oob_scan import JNDI_TEMPLATE, PLAIN_TEMPLATE, SSRF_TEMPLATE, _vulnerable_server
from test_torch_active import close_shared, free_ports, hits_view, pair, tokens  


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread, and engines of both packages that walk
    inline (``SWARM_WALK_THREADS=1``) unless a test sets their walk: six
    test processes share the host, and no result depends on either."""
    saved = torch.get_num_threads(), os.environ.get("SWARM_WALK_THREADS")
    torch.set_num_threads(1)
    os.environ["SWARM_WALK_THREADS"] = "1"
    yield
    torch.set_num_threads(saved[0])
    if saved[1] is None:
        os.environ.pop("SWARM_WALK_THREADS", None)
    else:
        os.environ["SWARM_WALK_THREADS"] = saved[1]


# noqa: F401
PACKAGES = (j_oob, t_oob)


def view(interactions) -> list:
    return [(i.protocol, i.raw_request, i.remote_addr) for i in interactions]


def send_raw(port: int, payload: bytes) -> None:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(payload)
        try:
            while s.recv(4096):
                pass
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the listener


@pytest.mark.parametrize("payload", [
    b"GET /{tok} HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /x HTTP/1.1\r\nHost: x\r\nContent-Length: 19\r\n\r\ncb={tok}",
    b"GET / HTTP/1.1\r\nHost: {tok}.oob.test:8080\r\nUser-Agent: probe\r\n\r\n",
    b"GET /{tok} HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n",
    b"POST /{tok} HTTP/1.1\r\nHost: x\r\nContent-Length: 50\r\n\r\nshort",
], ids=["path", "post-body", "host-header", "bad-length", "short-body"])
def test_http_interactions_equal(tokens, payload):
    """One request to each package's listener, sent at once (the
    short-body case waits out the listener's 2-second body read)."""
    got = {}
    with j_oob.OOBListener() as j_lst, t_oob.OOBListener() as t_lst:
        pairs = [(j_lst, j_lst.new_token()), (t_lst, t_lst.new_token())]
        assert pairs[0][1] == pairs[1][1]
        sends = [threading.Thread(target=send_raw, args=(
            lst.http_port, payload.replace(b"{tok}", tok.encode()))) for lst, tok in pairs]
        for t in sends:
            t.start()
        for t in sends:
            t.join()
        for lst, tok in pairs:
            got[lst.__class__.__module__] = view(lst.poll(tok))
            assert lst.poll(tok) == [] and lst.pending() == 0
    assert got["swarm_tpu_torch.worker.oob"] == got["swarm_tpu.worker.oob"]
    assert len(got["swarm_tpu_torch.worker.oob"]) == 1


def test_https_on_the_same_port_equal(tokens):
    import ssl
    import urllib.request

    out = []
    for mod in PACKAGES:
        with mod.OOBListener() as lst:
            tok = lst.new_token()
            urllib.request.urlopen(f"https://127.0.0.1:{lst.http_port}/{tok}", timeout=5,
                                   context=ssl._create_unverified_context())
            tok2 = lst.new_token()
            send_raw(lst.http_port, f"GET /{tok2} HTTP/1.1\r\nHost: y\r\n\r\n".encode())
            out.append(([i.protocol for i in lst.poll(tok)], view(lst.poll(tok2))))
    assert out[0] == out[1]
    assert out[1][0] == ["http"] and len(out[1][1]) == 1


def test_dns_reply_equal(tokens):
    out = []
    for mod in PACKAGES:
        with mod.OOBListener(domain="OOB.test.", answer_ip="203.0.113.5") as lst:
            tok = lst.new_token()
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(5)
                s.sendto(_dns_query(f"a.{tok}.OOB.test"), ("127.0.0.1", lst.dns_port))
                reply = s.recvfrom(4096)[0]
            out.append((reply, view(lst.poll(tok)), lst.url_for(tok).split(":")[0]))
    assert out[0] == out[1]
    reply, inter, url = out[1]
    assert reply[:2] == b"\x12\x34" and reply.endswith(socket.inet_aton("203.0.113.5"))
    assert inter[0][:2] == ("dns", b"a.si00000000000001.oob.test")
    assert url == "si00000000000001.oob.test"


def test_eviction_bounds_equal(tokens):
    """A hostile target's callbacks: 40 to one token (32 kept), one of
    100 KiB (64 KiB kept), one to an unregistered token (dropped)."""
    out = []
    for mod in PACKAGES:
        lst = mod.OOBListener()
        tok = lst.new_token().encode()
        for i in range(40):
            lst._record("http", b"GET /%s?i=%d" % (tok, i), "198.51.100.7")
        other = lst.new_token().encode()
        lst._record("dns", other.upper() + b"." + b"x" * 100 * 1024, "198.51.100.8")
        lst._record("http", b"GET /si00000000000fff", "198.51.100.9")
        out.append((view(lst.poll(tok.decode())), view(lst.poll(other.decode())), lst.pending()))
        assert (mod._MAX_RAW_BYTES, mod._MAX_INTERACTIONS_PER_TOKEN) == (64 * 1024, 32)
    assert out[0] == out[1]
    assert len(out[1][0]) == 32 and len(out[1][1][0][1]) == 64 * 1024 and out[1][2] == 0


def test_unregistered_and_released_tokens_equal(tokens):
    out = []
    for mod in PACKAGES:
        with mod.OOBListener(dns_port=None) as lst:
            kept, gone = lst.new_token(), lst.new_token()
            lst.release(gone)
            for path in ("si00000000000000", gone, kept):
                send_raw(lst.http_port, f"GET /{path} HTTP/1.1\r\nHost: z\r\n\r\n".encode())
            out.append((lst.pending(), len(lst.poll(kept)), lst.poll(gone), lst.dns_port))
    assert out[0] == out[1] == (1, 1, [], 0)


@pytest.mark.parametrize("advertise_host,domain,port", [
    ("127.0.0.1", None, 8085), ("192.0.2.8", None, 80), ("scanner.example", None, 9000),
    ("127.0.0.1", "oob.example.", 8085), ("127.0.0.1", "OOB.Example", 80),
    ("127.0.0.1", "oob.example", 443),
])
def test_url_forms_equal(advertise_host, domain, port):
    lists = [mod.OOBListener(advertise_host=advertise_host, domain=domain) for mod in PACKAGES]
    for lst in lists:
        lst.http_port = port
    assert lists[1].url_for("si0123456789abcd") == lists[0].url_for("si0123456789abcd")
    assert lists[1].answer_ip == lists[0].answer_ip


def test_qname_and_reply_builders_equal():
    q = _dns_query("si00112233445566.oob.test")
    packets = [
        q, _dns_query("A.B.C"), _dns_query("x" * 63 + ".y"), q[:12] + b"\x00" + q[-4:],
        q[:12] + b"\xc0\x0c", q[:20], b"\x00" * 12, q[:12] + b"\x01a" * 70 + b"\x00",
        q[:12] + b"\x40" + b"a" * 64 + b"\x00",
    ]
    for pkt in packets:
        qn = t_oob._parse_qname(pkt)
        assert qn == j_oob._parse_qname(pkt), pkt
        if qn is not None:
            for ip in ("127.0.0.1", "203.0.113.5"):
                assert t_oob._build_a_reply(pkt, qn, ip) == j_oob._build_a_reply(pkt, qn, ip)
    assert t_oob._parse_qname(q) == b"si00112233445566.oob.test"
    assert t_oob._parse_qname(q[:12] + b"\xc0\x0c") is None
    assert t_oob._is_ipv4("10.0.0.1") and not t_oob._is_ipv4("host.example")


def test_shared_listener_keyed_by_config():
    kw = {"advertise_host": "127.0.0.1", "answer_ip": "203.0.113.77", "dns_port": None}
    a = t_oob.shared_listener(**kw)
    try:
        assert t_oob.shared_listener(**dict(reversed(kw.items()))) is a
        assert t_oob.shared_listener(**kw) is not j_oob.shared_listener(**kw)
        b = t_oob.shared_listener(**{**kw, "answer_ip": "203.0.113.78"})
        assert b is not a and b.http_port != a.http_port
        close_shared(t_oob, b.http_port)
    finally:
        close_shared(t_oob, a.http_port)
        close_shared(j_oob, j_oob.shared_listener(**kw).http_port)


def test_tls_context_as_the_reference():
    import ssl

    assert isinstance(t_oob._self_signed_tls_context(), ssl.SSLContext)
    assert isinstance(j_oob._self_signed_tls_context(), ssl.SSLContext)
    assert t_oob._TOKEN_RE.pattern == j_oob._TOKEN_RE.pattern


# ---------------------------------------------------------------------------
# the engine over the interactsh streams


@pytest.fixture(scope="module")
def oob_corpus(tmp_path_factory):
    root = _write_corpus(tmp_path_factory.mktemp("oob"))
    j_templates, errors = j_load_corpus(root)
    t_templates, t_errors = t_load_corpus(root)
    assert not errors and not t_errors and len(t_templates) == 4
    return j_templates, t_templates


def port_rows(rows) -> list:
    return [t_model.Response(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in rows]


def test_oob_engine_equal(oob_corpus):
    j_templates, t_templates = oob_corpus
    rows = _oob_rows() + fuzz_rows(j_templates, random.Random(3), 20)
    rows.append(j_model.Response(host="g", port=80, status=200, body=b"",
                                 oob_protocols=("dns",), oob_requests=b"y" * 5000,
                                 oob_ips=("203.0.113.9", "198.51.100.1")))
    want = JaxEngine(j_templates, mesh=None).match(rows)
    got = MatchEngine(t_templates, device="cpu", batch_rows=8).match(port_rows(rows))
    assert [(r.template_ids, r.extractions) for r in got] == [
        (r.template_ids, r.extractions) for r in want]
    assert "oob-http-callback" in got[1].template_ids
    assert got[0].template_ids == []


def test_oob_fields_prevent_content_dedup_merge(oob_corpus):
    """Rows alike but for their interactions stay apart in the engine's
    content dedup, as in the reference."""
    j_templates, t_templates = oob_corpus
    body = b"same page everywhere"
    rows = [
        j_model.Response(host="clean1", port=80, status=200, body=body),
        j_model.Response(host="vuln", port=80, status=200, body=body, oob_protocols=("http",),
                         oob_requests=b"GET /si0aaaaaaaaaaaaa HTTP/1.1\r\n\r\n"),
        j_model.Response(host="clean2", port=80, status=200, body=body),
        j_model.Response(host="vuln2", port=80, status=200, body=body, oob_protocols=("dns",),
                         oob_requests=b"x.si0bbbbbbbbbbbbb.oob.test"),
    ]
    uniq, back, _keys = _dedup_rows(port_rows(rows))
    assert len(uniq) == 3 and back[0] == back[2] and back[1] != back[0] != back[3]
    want = JaxEngine(j_templates, mesh=None).match(rows)
    got = MatchEngine(t_templates, device="cpu").match(port_rows(rows))
    assert [r.template_ids for r in got] == [r.template_ids for r in want]
    assert "oob-http-callback" in got[1].template_ids and got[0].template_ids == []


# ---------------------------------------------------------------------------
# ActiveScanner with an ``oob`` spec


EXTRACT_TEMPLATE = """\
id: demo-oob-extract
info:
  name: interaction details
  severity: high
requests:
  - method: GET
    path:
      - "{{BaseURL}}/fetch?url=http://{{interactsh-url}}/x"
    matchers:
      - type: word
        part: interactsh_protocol
        words: ["http"]
    extractors:
      - type: regex
        part: interactsh_request
        regex: ["si[0-9a-f]{14}"]
      - type: kval
        kval: ["interactsh_ip"]
"""


def scan_both(tokens, vulnerable: bool) -> tuple:
    """The reference tests' templates through each package's scanner,
    one after the other on one pair of fixed ports (each package's
    listener closed after its scan), against one server."""
    http_port, dns_port = free_ports()
    spec = {"read_timeout_ms": 4000, "oob": {"domain": "oob.test", "http_port": http_port,
                                             "dns_port": dns_port, "poll_s": 0.05}}
    j_templates, t_templates = pair([(SSRF_TEMPLATE, "t/ssrf.yaml"), (JNDI_TEMPLATE, "t/jndi.yaml"),
                                     (PLAIN_TEMPLATE, "t/plain.yaml"),
                                     (EXTRACT_TEMPLATE, "t/extract.yaml")])
    srv = _vulnerable_server(dns_port, http_port, vulnerable=vulnerable)
    target = f"127.0.0.1:{srv.server_address[1]}"
    out = []
    try:
        for mod, scanner_of in ((t_oob, lambda: t_active.ActiveScanner(
                MatchEngine(t_templates, device="cpu"), spec)),
                                (j_oob, lambda: j_active.ActiveScanner(JaxEngine(j_templates),
                                                                       spec))):
            scanner = scanner_of()
            try:
                assert scanner.oob_listener.http_port == http_port
                assert scanner.oob_limited == [] and sorted(scanner._oob_reqs) == [0, 1, 3]
                out.append((*scanner.run([target]), scanner))
            finally:
                scanner.close()
                close_shared(mod, http_port)
    finally:
        srv.shutdown()
    (t_hits, t_stats, _), (j_hits, j_stats, _) = out
    assert hits_view(t_hits) == hits_view(j_hits)
    assert t_stats == j_stats
    assert tokens[t_oob].n == tokens[j_oob].n == 3
    return t_hits, t_stats


def test_oob_scan_vulnerable_equal(tokens):
    hits, stats = scan_both(tokens, vulnerable=True)
    assert {h.template_id for h in hits} == {
        "demo-blind-ssrf", "demo-jndi-rce", "demo-plain", "demo-oob-extract"}
    [ext] = [h for h in hits if h.template_id == "demo-oob-extract"]
    assert ext.path == "/fetch?url=http://{{interactsh-url}}/x"
    # the token in the DNS qname and in the callback's Host header
    assert ext.extractions == ["si00000000000003"] * 2 + ["127.0.0.1"]
    assert stats["oob_probes"] == 3 and stats["oob_interactions"] == 5


def test_oob_scan_patched_equal(tokens):
    hits, stats = scan_both(tokens, vulnerable=False)
    assert {h.template_id for h in hits} == {"demo-plain"}
    assert stats["oob_probes"] == 3 and stats["oob_interactions"] == 0


def test_oob_probe_without_row_releases_its_token(tokens):
    """A dead target's OOB probe produces no row: its token is released
    in the wave and nothing is deferred, as in the reference."""
    http_port, dns_port = free_ports()
    spec = {"connect_timeout_ms": 500, "read_timeout_ms": 500,
            "oob": {"http_port": http_port, "dns_port": dns_port, "poll_s": 0.05}}
    j_templates, t_templates = pair([(SSRF_TEMPLATE, "t/ssrf.yaml")])
    out = []
    for mod, scanner_of in (
            (t_oob, lambda: t_active.ActiveScanner(MatchEngine(t_templates, device="cpu"), spec)),
            (j_oob, lambda: j_active.ActiveScanner(JaxEngine(j_templates), spec))):
        scanner = scanner_of()
        try:
            assert scanner.oob_listener.url_for("si0") == f"127.0.0.1:{http_port}/si0"
            rows = scanner._run_wave([("127.0.0.1", "127.0.0.1", 1, False, 0)])
            out.append((rows, scanner._pending_oob, scanner.oob_listener._interactions,
                        tokens[mod].n))
        finally:
            close_shared(mod, http_port)
    assert out[0] == out[1] == ([], [], {}, 1)
