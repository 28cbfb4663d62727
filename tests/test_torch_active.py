"""The port's active scanner (swarm_tpu_torch.worker.active) against the
JAX package's.

The planner's request tables, owners and skip classes must be equal on
the reference tests' inline templates and on ``chip_smoke.active_corpus(0)``;
the scanner (waves, the network, DNS and ssl passes, the workflow pass
with its batched gate re-confirm) must give equal hits and stats against
the same local listeners, the port's engine on the CPU. Both modules'
``_RANDSTR`` are set to one value, as it appears in planned paths. A
probe spec with ``oob`` runs the interaction listener and a corpus with
runnable headless templates the browserless executor, as in JAX, here
against ``chip_smoke``'s OOB fleet; both modules' OOB tokens are drawn
from one counter.
"""

import dataclasses
import json
import os
import socket
import struct
import textwrap
from pathlib import Path

import pytest
import torch
import yaml

from swarm_tpu.fingerprints.nuclei import parse_template as j_parse
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.ops.workflows import WorkflowRunner as JaxRunner
from swarm_tpu.worker import active as j_active
from swarm_tpu.worker import dnsquery as j_dnsquery
from swarm_tpu.worker import headless as j_headless
from swarm_tpu.worker import oob as j_oob
from swarm_tpu_torch.fingerprints.nuclei import load_corpus as t_load_corpus
from swarm_tpu_torch.fingerprints.nuclei import parse_template as t_parse
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.ops.workflows import WorkflowRunner
from swarm_tpu_torch.worker import active as t_active
from swarm_tpu_torch.worker import dnsquery as t_dnsquery
from swarm_tpu_torch.worker import headless as t_headless
from swarm_tpu_torch.worker import oob as t_oob
from test_active_scan import (
    CHAIN_TEMPLATE,
    LOGIN_TEMPLATE,
    NETWORK_TEMPLATE,
    OOB_TEMPLATE,
    PAYLOAD_TEMPLATE,
    RAW_TEMPLATE,
    ROOT_TEMPLATE,
    TOKEN_TEMPLATE,
    _serve,
)
from test_dns_templates import DNS_TEMPLATE, SERVFAIL_TEMPLATE, dns_server  # noqa: F401
from test_match_parity import DATA


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


RANDSTR = "swarm0123456789abcdef"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def same_randstr(monkeypatch):
    monkeypatch.setattr(j_active, "_RANDSTR", RANDSTR)
    monkeypatch.setattr(t_active, "_RANDSTR", RANDSTR)


def both(doc: str, path: str = "t/x.yaml") -> tuple:
    raw = yaml.safe_load(textwrap.dedent(doc))
    return j_parse(raw, source_path=path), t_parse(raw, source_path=path)


def pair(docs: list) -> tuple:
    """[(doc, path)] → (JAX templates, port templates)."""
    parsed = [both(d, p) for d, p in docs]
    return [j for j, _ in parsed], [t for _, t in parsed]


def plan_view(plan) -> dict:
    return {
        "requests": [dataclasses.asdict(r) for r in plan.requests],
        "owners": plan.owners,
        "skipped": plan.skipped,
        "planned": plan.planned_templates,
        "truncated": plan.payload_truncated,
        "net": [dataclasses.asdict(r) for r in plan.net_requests],
        "net_owners": plan.net_owners,
        "dns": plan.dns_qtypes,
        "dns_owners": plan.dns_owners,
    }


def hits_view(hits) -> list:
    return [dataclasses.asdict(h) for h in hits]


HEADLESS_SKIPPED = """\
id: demo-headless
info:
  severity: info
headless:
  - steps:
      - action: navigate
        args:
          url: "{{BaseURL}}"
      - action: script
        args:
          hook: true
          code: "() => window.foo"
"""

HEADLESS_RUNNABLE = """\
id: demo-headless-nav
info:
  severity: info
headless:
  - steps:
      - action: navigate
        args:
          url: "{{BaseURL}}"
      - action: waitload
    matchers:
      - type: word
        part: body
        words: ["acme-platform"]
"""

SSL_TEMPLATE = """\
id: mini-ssl
info:
  severity: low
ssl:
  - address: "{{Host}}:{{Port}}"
    matchers:
      - type: dsl
        dsl: ["common_name == issuer_common_name"]
"""

FILE_TEMPLATE = """\
id: mini-file
info:
  severity: info
file:
  - extensions: [conf]
    matchers:
      - type: word
        words: ["configure terminal"]
"""

TLS_NET = """\
id: net-tls-probe
info:
  name: x
  severity: info
network:
  - inputs:
      - data: "ping"
    host:
      - "tls://{{Host}}:3389"
    matchers:
      - type: word
        words: ["never-matches-here"]
"""

MIXED = [
    (ROOT_TEMPLATE, "t/root.yaml"),
    (ROOT_TEMPLATE.replace("demo-root-tech", "other-root"), "t/other.yaml"),
    (LOGIN_TEMPLATE, "t/login.yaml"),
    (RAW_TEMPLATE, "t/raw.yaml"),
    (PAYLOAD_TEMPLATE, "t/payload.yaml"),
    (LOGIN_TEMPLATE.replace("/admin/login", "/x/{{unknowable}}")
     .replace("demo-login-panel", "demo-dynamic"), "t/dyn.yaml"),
    (LOGIN_TEMPLATE.replace("/admin/login", "/probe/{{randstr}}")
     .replace("demo-login-panel", "demo-randstr"), "t/rand.yaml"),
    (LOGIN_TEMPLATE.replace("/admin/login", "/r?u={{Scheme}}://{{Hostname}}&p={{Port}}")
     .replace("demo-login-panel", "demo-scheme"), "t/scheme.yaml"),
    (LOGIN_TEMPLATE.replace("/admin/login", "/go?next={{BaseURL}}/home")
     .replace("demo-login-panel", "demo-interior"), "t/interior.yaml"),
    (TOKEN_TEMPLATE, "t/token.yaml"),
    (CHAIN_TEMPLATE, "t/chain.yaml"),
    (OOB_TEMPLATE, "t/oob.yaml"),
    (NETWORK_TEMPLATE % 8873, "network/net.yaml"),
    (TLS_NET, "network/tls.yaml"),
    (DNS_TEMPLATE, "dns/cname.yaml"),
    (DNS_TEMPLATE.replace("demo-cname-service", "other-cname"), "dns/cname2.yaml"),
    (SERVFAIL_TEMPLATE, "dns/servfail.yaml"),
    (HEADLESS_SKIPPED, "headless/h.yaml"),
    (SSL_TEMPLATE, "ssl/s.yaml"),
    (FILE_TEMPLATE, "file/f.yaml"),
]


# ---------------------------------------------------------------------------
# the planner


@pytest.mark.parametrize("user_vars", [None, {"token": "sekrit123"}])
def test_build_plan_equal(user_vars):
    j_templates, t_templates = pair(MIXED)
    j_plan = j_active.build_plan(j_templates, user_vars=user_vars)
    t_plan = t_active.build_plan(t_templates, user_vars=user_vars)
    assert plan_view(t_plan) == plan_view(j_plan)
    assert t_plan.skipped.get("oob-interactsh") == ["demo-oob-rce"]
    assert set(t_plan.skipped) >= {"protocol-headless", "protocol-ssl", "protocol-file",
                                   "extractor-chain"}
    for tls, port in ((False, 80), (True, 443), (True, 8443), (False, 8080)):
        for j_req, t_req in zip(j_plan.requests, t_plan.requests):
            assert t_req.wire("h.example", port, tls) == j_req.wire("h.example", port, tls)
            assert t_active._finalize(t_req.path, "h", port, tls) == j_active._finalize(
                j_req.path, "h", port, tls)


def test_oob_and_dynamic_classes_equal():
    j_templates, t_templates = pair(MIXED)
    for j_t, t_t in zip(j_templates, t_templates):
        assert t_active._uses_oob(t_t) == j_active._uses_oob(j_t)
        assert t_active._uses_indexed_vars(t_t) == j_active._uses_indexed_vars(j_t)
        assert t_active._classify_dynamic(t_t) == j_active._classify_dynamic(j_t)
        assert t_active._classify_dynamic(t_t, {"token": "x"}) == j_active._classify_dynamic(
            j_t, {"token": "x"})


def test_build_plan_equal_on_active_corpus():
    """The chip phase's corpus: the request table, owners and skip
    classes equal JAX's, about 3,200 distinct requests, 559 templates
    on the bare base URL."""
    from chip_smoke import ACTIVE_BARE, ACTIVE_REQUESTS, active_corpus

    docs, _plants = active_corpus(0)
    j_plan = j_active.build_plan([j_parse(d) for d in docs])
    t_plan = t_active.build_plan([t_parse(d) for d in docs])
    assert plan_view(t_plan) == plan_view(j_plan)
    assert len(t_plan.requests) == ACTIVE_REQUESTS
    [root] = [i for i, r in enumerate(t_plan.requests) if r.path == "/"]
    assert len(t_plan.owners[root]) == ACTIVE_BARE
    assert t_plan.skipped == {}


def test_headless_classify_equal():
    hook = HEADLESS_SKIPPED.replace(
        '"() => window.foo"',
        "\"() => { Window.prototype.addEventListener = function(type) { if (type === "
        "'message') { window.alerts.push(1) } } }\"")
    docs = [HEADLESS_SKIPPED, HEADLESS_RUNNABLE, hook,
            HEADLESS_RUNNABLE.replace("waitload", "screenshot"),
            HEADLESS_RUNNABLE.replace("action: waitload", "action: click\n        args: {by: css}"),
            ROOT_TEMPLATE]
    for doc in docs:
        j_t, t_t = both(doc)
        assert t_headless.classify(t_t) == j_headless.classify(j_t)
    assert t_headless.classify(both(HEADLESS_RUNNABLE)[1]) is None
    assert t_headless.classify(both(HEADLESS_SKIPPED)[1]) == "js-required"


# ---------------------------------------------------------------------------
# the scanner against local listeners


def engines(j_templates, t_templates, **kw) -> tuple:
    return JaxEngine(j_templates), MatchEngine(t_templates, device="cpu", **kw)


def run_both(j_templates, t_templates, spec: dict, targets: list, patch=None) -> tuple:
    j_eng, t_eng = engines(j_templates, t_templates)
    j_scan = j_active.ActiveScanner(j_eng, spec)
    t_scan = t_active.ActiveScanner(t_eng, spec)
    if patch is not None:
        patch(j_scan)
        patch(t_scan)
    j_hits, j_stats = j_scan.run(targets)
    t_hits, t_stats = t_scan.run(targets)
    assert hits_view(t_hits) == hits_view(j_hits)
    assert t_stats == j_stats
    assert t_scan.oob_limited == j_scan.oob_limited
    return t_hits, t_stats


@pytest.fixture(scope="module")
def servers():
    routes = [
        {"/": "welcome to the acme-platform homepage",
         "/admin/login": "the secret-admin-portal awaits",
         ("POST", "/api/check"): "raw-post-ok indeed",
         "/login?u=root": "never gonna match",
         f"/probe/{RANDSTR}": "acme-platform 404 page"},
        {"/": "plain page", "/admin/login": "secret-admin-portal again"},
        {"/admin/login": "locked"},
    ]
    srvs = [_serve(r) for r in routes]
    yield [f"127.0.0.1:{s.server_address[1]}" for s in srvs]
    for s in srvs:
        s.shutdown()


WAVE_TEMPLATES = [
    (ROOT_TEMPLATE, "t/root.yaml"),
    (LOGIN_TEMPLATE, "t/login.yaml"),
    (RAW_TEMPLATE, "t/raw.yaml"),
    (PAYLOAD_TEMPLATE, "t/payload.yaml"),
    (ROOT_TEMPLATE.replace('- "{{BaseURL}}"', '- "{{BaseURL}}/admin/login"')
     .replace("demo-root-tech", "demo-crossed"), "t/crossed.yaml"),
    (ROOT_TEMPLATE.replace('- "{{BaseURL}}"', '- "{{BaseURL}}/probe/{{randstr}}"')
     .replace("demo-root-tech", "demo-randstr"), "t/rand.yaml"),
    (OOB_TEMPLATE, "t/oob.yaml"),
    (TOKEN_TEMPLATE, "t/token.yaml"),
    (HEADLESS_SKIPPED, "headless/h.yaml"),
]


@pytest.mark.parametrize("wave_rows", [16384, 4])
def test_scan_waves_equal(servers, wave_rows):
    """Index-sliced waves (one, or many of 4 rows), per-request
    attribution, a dead target and a malformed line."""
    j_templates, t_templates = pair(WAVE_TEMPLATES)
    spec = {"read_timeout_ms": 2000, "connect_timeout_ms": 1000, "wave_rows": wave_rows,
            "resolvers": ["127.0.0.1"]}
    hits, stats = run_both(j_templates, t_templates, spec,
                           servers + ["127.0.0.1:1", "bad:99999", "# c"])
    got = {(h.template_id, h.path, h.port) for h in hits}
    port0 = int(servers[0].split(":")[1])
    assert ("demo-root-tech", "/", port0) in got
    assert ("demo-randstr", f"/probe/{RANDSTR}", port0) in got
    assert ("demo-raw-post", "/api/check", port0) in got
    assert not any(t == "demo-crossed" for t, _p, _q in got)
    assert stats["live_targets"] == 3 and stats["rows_probed"] == 3 * 6


def test_scan_network_pass_equal():
    import socketserver
    import threading

    class Banner(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                self.request.sendall(b"FAKED: 31.0\n")
                self.request.recv(64)
            except OSError:
                pass

    class S(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = S(("127.0.0.1", 0), Banner)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        j_templates, t_templates = pair([
            (NETWORK_TEMPLATE % port, "network/demo-net.yaml"),
            (TLS_NET.replace("3389", "1"), "network/tls.yaml"),
            (ROOT_TEMPLATE, "t/root.yaml"),
        ])
        hits, stats = run_both(j_templates, t_templates,
                               {"read_timeout_ms": 1500, "connect_timeout_ms": 1000,
                                "resolvers": ["127.0.0.1"]},
                               [f"127.0.0.1:{port}"])
        assert [(h.template_id, h.port, h.extractions) for h in hits] == [
            ("demo-net-banner", port, ["FAKED: 31.0"])]
    finally:
        srv.shutdown()


def test_scan_dns_pass_equal(dns_server, monkeypatch):  # noqa: F811
    for mod in (j_dnsquery, t_dnsquery):
        real = mod.query_batch
        monkeypatch.setattr(
            mod, "query_batch",
            lambda queries, resolvers, timeout_ms=2000, retries=1, port=53, _real=real:
                _real(queries, resolvers, timeout_ms, retries, port=dns_server))

    def local_names(scanner):
        scanner.executor._resolve_names = lambda parsed, all_addrs=False: {
            t[0]: ["127.0.0.1"] for t in parsed}

    j_templates, t_templates = pair([(DNS_TEMPLATE, "dns/a.yaml"),
                                     (SERVFAIL_TEMPLATE, "dns/b.yaml")])
    hits, stats = run_both(j_templates, t_templates,
                           {"resolvers": ["127.0.0.1"], "read_timeout_ms": 2000},
                           ["app.example.test:1", "app.servfail.test:1"], patch=local_names)
    assert {(h.template_id, h.host) for h in hits} == {
        ("demo-cname-service", "app.example.test"), ("demo-servfail", "app.servfail.test")}
    assert stats["rows_probed"] == 4


def test_dns_codec_equal():
    """Replies built as the reference tests build them, parsed and
    rendered by both packages."""
    from test_dns_templates import _answer, _reply_packet

    cases = [
        ("a.test", 5, [_answer(12, 5, t_dnsquery._encode_qname("ghs.googlehosted.com"))], 0),
        ("b.test", 15, [_answer(12, 15, struct.pack("!H", 10)
                                + t_dnsquery._encode_qname("mx.b.test"))], 0),
        ("c.test", 16, [_answer(12, 16, b"\x05hello\x03abc")], 0),
        ("d.test", 257, [_answer(12, 257, b"\x00\x05issueletsencrypt.org")], 0),
        ("e.test", 1, [_answer(12, 1, bytes([10, 0, 0, 1]))], 2),
        ("f.test", 28, [_answer(12, 28, bytes(range(16)))], 0),
    ]
    for qname, qtype, answers, rcode in cases:
        pkt = _reply_packet(7, qname, qtype, answers, rcode)
        name = t_dnsquery._TYPE_NAMES[qtype]
        t_reply = t_dnsquery.parse_reply(pkt, qname, name)
        j_reply = j_dnsquery.parse_reply(pkt, qname, name)
        assert t_reply.render() == j_reply.render()
        assert dataclasses.asdict(t_reply) == dataclasses.asdict(j_reply)
    assert t_dnsquery.reverse_name("10.1.2.3") == j_dnsquery.reverse_name("10.1.2.3")
    assert t_dnsquery.parse_reply(b"short", "x", "A") is None


# ---------------------------------------------------------------------------
# the workflow pass: named-matcher gates re-confirmed in one batch


WF_PAGE = "site powered by AcmeCMS, demo-build 3.11"


@pytest.fixture(scope="module")
def wf_servers():
    routes = [
        {"/": WF_PAGE, "/admin": "<title>Demo Admin</title> demo-build 2.0"},
        {"/": "powered by acmecms only"},
        {"/": "maintenance mode", "/admin": "nothing"},
    ]
    srvs = [_serve(r) for r in routes]
    yield [f"127.0.0.1:{s.server_address[1]}" for s in srvs]
    for s in srvs:
        s.shutdown()


def test_scan_workflow_gates_equal(wf_servers):
    """``tests/data/templates`` (a workflow gated on demo-tech's named
    matcher ``acme-cms``): per-(host, port) gating, the gate names
    resolved in one engine batch, as JAX's."""
    from swarm_tpu.fingerprints import load_corpus as j_load_corpus

    j_templates, _ = j_load_corpus(DATA)
    t_templates, _ = t_load_corpus(DATA)
    hits, stats = run_both(j_templates, t_templates,
                           {"read_timeout_ms": 2000, "connect_timeout_ms": 1000,
                            "resolvers": ["127.0.0.1"]}, wf_servers)
    assert stats["workflow_hits"] == 1
    [wf] = [h for h in hits if h.template_id == "demo-workflow"]
    assert wf.extractions == ["demo-acme-vuln"] and wf.port == int(wf_servers[0].split(":")[1])


@pytest.mark.parametrize("device", [True, False])
def test_resolve_gate_names_equal(device):
    from swarm_tpu.fingerprints import load_corpus as j_load_corpus
    from swarm_tpu.fingerprints.model import Response as JResponse
    from swarm_tpu_torch.fingerprints.model import Response as TResponse

    j_templates, _ = j_load_corpus(DATA)
    t_templates, _ = t_load_corpus(DATA)
    j_run = JaxRunner(j_templates, engine=JaxEngine(j_templates), device=device)
    t_run = WorkflowRunner(t_templates, engine=MatchEngine(t_templates, device="cpu"),
                           device=device)
    assert t_run.gate_template_ids == j_run.gate_template_ids == {"demo-tech"}
    assert t_run._plane_names == j_run._plane_names
    bodies = [WF_PAGE.encode(), b"powered by acmecms", b"maintenance mode AcmeCMS", b""]
    hdr = b"HTTP/1.1 200 OK\r\nX-Widget-Version: 4.2"
    j_rows = [JResponse(host="h", port=80, status=200, body=b, header=hdr) for b in bodies]
    t_rows = [TResponse(host="h", port=80, status=200, body=b, header=hdr) for b in bodies]
    needs = lambda rows: [(tid, r) for r in rows for tid in ("demo-tech", "demo-panel")]
    assert t_run.resolve_gate_names(needs(t_rows)) == j_run.resolve_gate_names(needs(j_rows))
    assert t_run.resolve_gate_names([]) == []
    assert t_run.auto_scan(t_rows) == j_run.auto_scan(j_rows)
    wapp = {"acme-cms": ["acme"], "widgetd": ["panel"]}
    assert WorkflowRunner(t_templates, engine=t_run.engine, wappalyzer=wapp).auto_scan(
        t_rows) == JaxRunner(j_templates, engine=j_run.engine, wappalyzer=wapp).auto_scan(j_rows)


# ---------------------------------------------------------------------------
# the OOB listener and headless execution


class CountingTokens:
    """Stands in for ``secrets`` in an ``oob`` module: ``token_hex``
    counts, so that two scans mint the same tokens."""

    def __init__(self):
        self.n = 0

    def token_hex(self, nbytes: int) -> str:
        self.n += 1
        return f"{self.n:0{2 * nbytes}x}"


@pytest.fixture
def tokens(monkeypatch):
    counters = {mod: CountingTokens() for mod in (j_oob, t_oob)}
    for mod, counter in counters.items():
        monkeypatch.setattr(mod, "secrets", counter)
    return counters


def free_ports() -> tuple:
    """A free TCP and a free UDP port on this host."""
    with socket.socket() as t, socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as u:
        t.bind(("0.0.0.0", 0))
        u.bind(("0.0.0.0", 0))
        return t.getsockname()[1], u.getsockname()[1]


def close_shared(mod, http_port: int) -> None:
    """Close and forget ``mod``'s shared listeners on ``http_port``."""
    with mod._SHARED_LOCK:
        keys = [k for k, lst in mod._SHARED.items() if lst.http_port == http_port]
        listeners = [mod._SHARED.pop(k) for k in keys]
    for lst in listeners:
        lst.close()


def oob_spec(http_port: int, dns_port: int) -> dict:
    """``modules/nuclei-oob.json``'s probe spec on fixed listener ports,
    the chip fleet's domain, local resolvers and a 50 ms poll window."""
    from chip_smoke import OOB_DOMAIN

    probe = json.loads((REPO / "modules" / "nuclei-oob.json").read_text())["probe"]
    return {**probe, "resolvers": ["127.0.0.1"], "read_timeout_ms": 2000,
            "connect_timeout_ms": 1000,
            "oob": {**probe["oob"], "http_port": http_port, "dns_port": dns_port,
                    "domain": OOB_DOMAIN, "poll_s": 0.05}}


def test_oob_spec_scan_equal(tokens):
    """``ActiveScanner`` with an ``oob`` spec over 24 of ``chip_smoke``'s OOB
    templates (both shapes, every variant) and 8 others against two listeners of its
    OOB fleet, the port's engine on the CPU: hits and stats equal JAX's,
    each package's listener on the same ports in turn; every OOB
    template fires on exactly its vulnerable (listener, path) pairs."""
    from chip_smoke import OobFleet, active_replies, oob_headless_corpus, oob_vulnerable

    docs, plants, oob = oob_headless_corpus(0)
    oob = dict(sorted(oob.items())[:24])
    picked = [(d, f"t/{d['id']}.yaml") for d in docs if d["id"] in oob]
    picked += [(d, f"t/{d['id']}.yaml") for d in docs[:40] if not d["id"].startswith("chip-")][:8]
    j_templates = [j_parse(d, source_path=p) for d, p in picked]
    t_templates = [t_parse(d, source_path=p) for d, p in picked]
    http_port, dns_port = free_ports()
    spec = oob_spec(http_port, dns_port)
    out = []
    with OobFleet(2, active_replies(docs, plants, 2), dns_port, headless=1) as fleet:
        for mod, scanner_of in (
                (t_oob, lambda: t_active.ActiveScanner(MatchEngine(t_templates, device="cpu"),
                                                       spec)),
                (j_oob, lambda: j_active.ActiveScanner(JaxEngine(j_templates), spec))):
            scanner = scanner_of()
            try:
                assert scanner.oob_limited == [] and len(scanner._oob_reqs) == len(oob)
                out.append(scanner.run(fleet.targets))
            finally:
                close_shared(mod, http_port)
        callbacks = fleet.callbacks
    (t_hits, t_stats), (j_hits, j_stats) = out
    assert hits_view(t_hits) == hits_view(j_hits)
    assert t_stats == j_stats
    ports = [int(t.split(":")[1]) for t in fleet.targets]
    want = {(ports[k], tid) for tid, (name, _shape) in oob.items() for k in range(2)
            if oob_vulnerable(k, name)}
    assert {(h.port, h.template_id) for h in t_hits if h.template_id in oob} == want
    assert callbacks == 2 * len(want)
    assert t_stats["oob_probes"] == 2 * len(oob)
    assert t_stats["oob_interactions"] == len(want)
    extracted = [h.extractions for h in t_hits if h.template_id in oob and h.extractions]
    assert ["127.0.0.1"] in extracted and any(e[0].startswith("si") for e in extracted)


def test_runnable_headless_scan_equal():
    """A corpus with runnable headless templates (one an idiom) and
    js-required ones: hits, stats and the ``protocol-headless`` skip
    list (the scope lines) equal JAX's."""
    from chip_smoke import HEADLESS_RUN, OobFleet, headless_docs

    docs = [(d, f"headless/{d['id']}.yaml") for d in headless_docs()]
    docs += [(yaml.safe_load(ROOT_TEMPLATE), "t/root.yaml"),
             (yaml.safe_load(HEADLESS_SKIPPED), "headless/skip.yaml")]
    j_templates = [j_parse(d, source_path=p) for d, p in docs]
    t_templates = [t_parse(d, source_path=p) for d, p in docs]
    page = b"HTTP/1.1 200 OK\r\nContent-Length: 21\r\n\r\nthe acme-platform app"
    spec = {"read_timeout_ms": 2000, "connect_timeout_ms": 1000, "resolvers": ["127.0.0.1"]}
    with OobFleet(2, lambda k, method, path: page, dns_port=0, headless=1) as fleet:
        j_scan = j_active.ActiveScanner(JaxEngine(j_templates), spec)
        t_scan = t_active.ActiveScanner(MatchEngine(t_templates, device="cpu"), spec)
        j_hits, j_stats = j_scan.run(fleet.targets)
        t_hits, t_stats = t_scan.run(fleet.targets)
    assert hits_view(t_hits) == hits_view(j_hits)
    assert t_stats == j_stats
    assert t_scan.plan.skipped == j_scan.plan.skipped == {
        "protocol-headless": ["chip-hl-js-required", "demo-headless"]}
    assert [t.id for t in t_scan.headless_scanner.templates] == [
        d["id"] for d, _p in docs[:HEADLESS_RUN]]
    headless_port = int(fleet.targets[1].split(":")[1])
    assert {h.template_id for h in t_hits if h.port == headless_port} >= {
        d["id"] for d, _p in docs[:HEADLESS_RUN]}
    assert t_stats["headless_templates"] == HEADLESS_RUN
    assert t_stats["headless_hits"] == sum(h.path == "" for h in t_hits)


# ---------------------------------------------------------------------------
# the chip phase's corpora, built here without a card


def test_chip_smoke_corpora_build():
    from chip_smoke import (
        ACTIVE_BARE, FILE_MATCHERS, FILE_TEMPLATES, active_corpus, file_corpus,
        workflow_docs,
    )

    docs, plants = active_corpus(0)
    assert len(docs) == len(plants) == 3989
    paths = [d["http"][0]["path"][0] for d in docs]
    assert paths.count("{{BaseURL}}") == ACTIVE_BARE
    assert len(workflow_docs(docs, plants)) == 12
    fdocs, fplants = file_corpus(0)
    assert len(fdocs) == len(fplants) == FILE_TEMPLATES
    kinds = [m["type"] for d in fdocs for op in d["file"] for m in op.get("matchers", [])]
    assert {k: kinds.count(k) for k in set(kinds)} == FILE_MATCHERS
    templates = [t_parse(d) for d in fdocs]
    assert all(t.protocol == "file" for t in templates)
    assert any(not any(op.matchers for op in t.operations) for t in templates)
