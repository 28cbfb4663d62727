"""The port's browserless headless executor (swarm_tpu_torch.worker.headless)
against the JAX package's.

Classification, the script-spec parsers, the version attribution and
the static script models must give equal values; ``HeadlessScanner``
must give equal hits (extractions and matcher names included) on the
reference tests' servers and on ``chip_smoke``'s headless pages, one
template for each idiom the reference executes; the shared pool's
rounds must equal the serial round, and ``run_async`` must leave the
caller free to drive a batch of the port's engine while the round runs.
"""

import copy
import dataclasses
import os
import textwrap
import threading

import pytest
import torch
import yaml

from chip_smoke import HEADLESS_RUN, HEADLESS_SKIP, _HOOKS, _PP_HOOK, OobFleet, headless_docs
from swarm_tpu.fingerprints.nuclei import parse_template as j_parse
from swarm_tpu.worker import headless as jh
from swarm_tpu_torch.fingerprints.model import Response
from swarm_tpu_torch.fingerprints.nuclei import load_corpus, parse_template as t_parse
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.worker import headless as th
from test_headless import (  # noqa: F401
    CLEAN_PAGE, CROSS_ORIGIN_TEMPLATE, DVWA_STYLE_TEMPLATE, EXT_JS, GUARDED_PAGE, HOOKED_PAGE,
    JS_TEMPLATE, NAV_PROBE_TEMPLATE, PLAIN_PAGE, REVEAL_JS, REVEAL_SAFE_JS, TEXTAREA_TEMPLATE,
    VULN_DEPARAM_PAGE, VULN_HASH_PAGE, dvwa_server, edges_server, hooked_server, pollution_server,
    reveal_server,
)
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


WANTS_PIXELS = """\
id: wants-pixels
info: {name: s, severity: info}
headless:
  - steps:
      - args: {url: "{{BaseURL}}"}
        action: navigate
      - action: screenshot
        name: shot
    matchers:
      - part: shot
        type: word
        words: ["x"]
"""


def both(doc) -> tuple:
    """A template from a YAML text or a parsed dict, by each package."""
    raw = yaml.safe_load(textwrap.dedent(doc)) if isinstance(doc, str) else doc
    return j_parse(raw), t_parse(raw)


def scan(docs, targets, paths=None) -> list:
    """Each package's ``HeadlessScanner`` over ``targets`` → the port's
    hits, after holding them equal to JAX's. ``paths`` re-points every
    navigate step (a copy of the templates)."""
    out = []
    for mod, parse in ((jh, j_parse), (th, t_parse)):
        templates = []
        for doc in docs:
            t = parse(yaml.safe_load(textwrap.dedent(doc)) if isinstance(doc, str) else doc)
            if paths is not None:
                t = copy.deepcopy(t)
                for op in t.operations:
                    for step in op.steps:
                        if step.get("action") == "navigate":
                            step["args"]["url"] = "{{BaseURL}}" + paths
            templates.append(t)
        out.append([dataclasses.asdict(h) for h in mod.HeadlessScanner(templates).run(targets)])
    assert out[1] == out[0]
    return out[1]


def local(port: int) -> list:
    return [("127.0.0.1", "127.0.0.1", port, False)]


# ---------------------------------------------------------------------------
# classification, parsers and models


def test_classify_equal():
    docs = headless_docs() + [DVWA_STYLE_TEMPLATE, NAV_PROBE_TEMPLATE, JS_TEMPLATE,
                              TEXTAREA_TEMPLATE, CROSS_ORIGIN_TEMPLATE, WANTS_PIXELS]
    verdicts = []
    for doc in docs:
        j_t, t_t = both(doc)
        verdicts.append(th.classify(t_t))
        assert verdicts[-1] == jh.classify(j_t), t_t.id
    assert verdicts[:HEADLESS_RUN] == [None] * HEADLESS_RUN
    assert verdicts[HEADLESS_RUN:HEADLESS_RUN + HEADLESS_SKIP] == ["js-required"]
    assert verdicts[-1] == "js-required-screenshot"


SCRIPTS = [
    *_HOOKS.values(), _PP_HOOK, "() => window.foo", "window.alerts", " window.alerts ; ",
    "() => { location.hash; eval(1); __proto__ }",
    "() => { Window.prototype.addEventListener = f; if (type == 'message') {} }",
    "() => { window.postMessage = f; if (origin == '*') {} }",
    "() => {\n return '\\n' + [...new Set(Array.from(document.querySelectorAll('[src], "
    "[href], [url], [action]')).map(i => i.src || i.href || i.url || i.action))]"
    ".join('\\r\\n') + '\\n'\n}",
    "Array.from(document.querySelectorAll('[src]')).map(x => x.src).join(',')",
    '() => {\nreturn (Reveal.VERSION <= "3.8.0" || Reveal.VERSION < "4.3.0")\n}',
    'return (Reveal.VERSION <= "3.8.0") || (Reveal.VERSION < "4.3.0")',
    'return ((Reveal.VERSION >= "3.0" && Reveal.VERSION < "4.3.0"))',
    'return (Reveal.VERSION < "4" || Foo.VERSION < "2")', 'return (document.cookie < "4")',
    "return (Reveal.VERSION === '4.2.1')",
]


def test_spec_parsers_equal():
    for code in SCRIPTS:
        assert th._hook_spec(code) == jh._hook_spec(code), code
        assert th._attr_collect_spec(code) == jh._attr_collect_spec(code), code
        assert th._version_check_spec(code) == jh._version_check_spec(code), code
        assert bool(th._ALERTS_READ_RE.match(code)) == bool(jh._ALERTS_READ_RE.match(code))
    kinds = [th._hook_spec(c)["kind"] for c in (*_HOOKS.values(), _PP_HOOK)]
    assert kinds == ["listen-message", "post-star", "window-name-sink", "location-sink",
                     "proto-pollution"]


#: (text, global, define position or None for the first define site)
VERSION_CASES = [
    ('Plugin.VERSION="1.0.0";var t="4.3.0";window.Reveal={VERSION:t};', "Reveal", None),
    ('x={VERSION:"1.0"};y={VERSION:"2.0"};', "Reveal", 30),
    ('var a={VERSION:"1.0.0"};var t="4.7.0";window.Reveal={VERSION:t};', "Reveal", None),
    ('!function(e){e.VERSION="3.8.0";window.Reveal=e}({});', "Reveal", None),
    ('!function(e){e.VERSION="1.0.0";window.Plugin=e}({});'
     '!function(e){e.VERSION="3.8.0";window.Reveal=e}({});', "Reveal", None),
    ('var MyReveal = q; Foo.Reveal = z; window.Reveal = e; e.VERSION="2.2.2";', "Reveal", None),
    ('var s="{"; Reveal = e; e.VERSION="5.0.0";', "Reveal", None),
    ('!function(e){if(typeof window!=="undefined"){window.Reveal=e}e.VERSION="4.0.6"}({});',
     "Reveal", None),
    ('!function(e){if(1){window.Plugin=e}e.VERSION="1.0.0"}({});'
     '!function(e){if(1){window.Reveal=e}e.VERSION="3.9.1"}({});', "Reveal", None),
    ('var e={};e.VERSION="3.8.0";if(typeof window!=="undefined"){window.Reveal=e}', "Reveal",
     None),
    ('var t="4.3.0";window.Reveal={VERSION:t};'
     + "OtherLibraryWithAVeryLongMinifiedExportName" * 2 + '.VERSION="7.7.7";', "Reveal", None),
    (REVEAL_JS.decode(), "Reveal", None),
]


def test_version_attribution_equal():
    import re

    for text, g, pos in VERSION_CASES:
        if pos is None:
            pos = re.search(rf"(?:window\.{g}\s*=|\b{g}\s*=|var {g}\b)", text).start()
        assert th._matched_brace_pairs(text) == jh._matched_brace_pairs(text), text
        assert th._module_window(text, pos) == jh._module_window(text, pos), text
        assert th._aliases_of(text, g, pos) == jh._aliases_of(text, g, pos), text
        assert th._script_version_of(text, g, pos) == jh._script_version_of(text, g, pos), text
    for text in ("pad. " + "Q" * 100 + '.VERSION="1.2.3"', "Z" * 300 + '.VERSION="9.9.9"',
                 'Acme.VERSION="2.0"', 'a.b.VERSION="1"'):
        pos = text.index("VERSION")
        assert th._qualifier_before(text, pos) == jh._qualifier_before(text, pos), text
    assert th._script_version_of(VERSION_CASES[4][0], "Reveal",
                                 VERSION_CASES[4][0].index("window.Reveal")) == "3.8.0"


def test_script_models_equal():
    values = [[], {}, "x", 3, [{"b": [1, 2], "a": {"z": "y"}}, ["p", "q"]], {"k": []}]
    for v in values:
        assert th._go_fmt(v) == jh._go_fmt(v)
    for page in (VULN_DEPARAM_PAGE, VULN_HASH_PAGE, GUARDED_PAGE, PLAIN_PAGE, HOOKED_PAGE,
                 CLEAN_PAGE, EXT_JS, b"$.extend(true, o, location.search.split('&'))"):
        text = page.decode()
        assert th._pollution_script_model(text) == jh._pollution_script_model(text)
        assert th._window_name_sinks(text) == jh._window_name_sinks(text)
        assert th._location_sinks(text) == jh._location_sinks(text)
    assert th._pollution_script_model(VULN_HASH_PAGE.decode()) == {"hash"}
    assert [s for s, _ in th._window_name_sinks(HOOKED_PAGE.decode())] == ["innerHTML"]


def test_page_and_submit_equal():
    """GET submission replaces the action's query; a page whose DOM did
    not build makes click and text no-ops."""
    html = (b"<html><body><form action=\"/search?stale=1&x=2\" method=\"get\">"
            b"<input type=\"text\" name=\"q\" value=\"needle\">"
            b"<select name=\"s\"><option value=\"a\">A</option>"
            b"<option selected value=\"b\">B</option></select>"
            b"<input type=\"checkbox\" name=\"c\" value=\"1\">"
            b"<input type=\"submit\" name=\"go\" value=\"go\"></form></body></html>")
    calls = []

    class RecordingSession:
        def fetch(self, url, *a, **kw):
            calls.append((url, a, kw))
            return True

    for mod in (jh, th):
        page = mod._Page("http://t/start", 200, b"", html)
        form = next(el for el in page.root.iter() if el.tag.lower() == "form")
        clicked = next(el for el in form.iter() if el.get("type", "").lower() == "submit")
        assert mod._submit(RecordingSession(), page, form, clicked)
        assert mod._same_origin("http://t:80/x", "http://t/")
        broken = mod._Page("http://t/", 200, b"", b"\x00\xff")
        broken.root = None
        sess = mod._Session("t", "t", 80, False, 1.0, 1.0)
        sess.page = broken
        steps = [{"action": "text", "args": {"by": "x", "xpath": "/html/body/input", "value": "v"}},
                 {"action": "click", "args": {"by": "x", "xpath": "/html/body/a"}}]
        assert mod._run_steps(None, steps, sess, {}) is True
    assert calls[0] == calls[1]
    assert calls[1][0] == "http://t/search?q=needle&s=b&go=go"


# ---------------------------------------------------------------------------
# HeadlessScanner


@pytest.fixture(scope="module")
def chip_pages():
    """``chip_smoke``'s headless listener alone (no OOB path is asked)."""
    with OobFleet(1, lambda k, method, path: b"", dns_port=0, headless=0) as fleet:
        yield int(fleet.targets[0].split(":")[1])


def test_hits_equal_on_chip_pages(chip_pages):
    hits = scan(headless_docs(), local(chip_pages))
    assert [h["template_id"] for h in hits] == [
        d["id"] for d in headless_docs()[:HEADLESS_RUN]]
    by_id = {h["template_id"]: h["extractions"] for h in hits}
    assert "sink:eval" in by_id["chip-hl-window-name-domxss"][0]
    assert "__proto__[e32a5ec9c99]=ddcb362f1d60" in by_id["chip-hl-prototype-pollution-check"][0]
    assert f"http://127.0.0.1:{chip_pages}/hl/rel/page" in by_id["chip-hl-extract-urls"][0]


TRACKERS = {"chip-hl-postmessage-tracker", "chip-hl-postmessage-outgoing-tracker",
            "chip-hl-window-name-domxss"}
PP = {"chip-hl-prototype-pollution-check"}


@pytest.mark.parametrize("server,docs,path,fired", [
    ("dvwa_server", [DVWA_STYLE_TEMPLATE, NAV_PROBE_TEMPLATE, JS_TEMPLATE], None,
     {"demo-form-login", "demo-nav-probe"}),
    ("edges_server", [TEXTAREA_TEMPLATE, CROSS_ORIGIN_TEMPLATE], None,
     {"demo-textarea", "demo-crossorigin"}),
    # the reference's hooked page has no location flow
    ("hooked_server", headless_docs()[2:6], "/", TRACKERS),
    ("hooked_server", headless_docs()[2:6], "/clean", set()),
    ("pollution_server", headless_docs()[6:7], "/", PP),
    ("pollution_server", headless_docs()[6:7], "/hash", PP),
    ("pollution_server", headless_docs()[6:7], "/guarded", set()),
    ("pollution_server", headless_docs()[6:7], "/clean", set()),
    ("reveal_server", headless_docs()[7:8], "/", {"chip-hl-revealjs-version"}),
    ("reveal_server", headless_docs()[7:8], "/plain", set()),
])
def test_hits_equal_on_reference_servers(request, server, docs, path, fired):
    got = request.getfixturevalue(server)
    port = got[0] if isinstance(got, tuple) else got
    hits = scan(docs, local(port), paths=path)
    assert {h["template_id"] for h in hits} == fired


def test_patched_library_silent_equal(reveal_server):
    port, state = reveal_server
    state["js"] = REVEAL_SAFE_JS
    assert scan(headless_docs()[7:8], local(port), paths="/") == []


def test_pooled_round_equal_to_serial(dvwa_server, chip_pages):
    """The shared pool at widths 4 and 1 against the serial round
    (``configure_headless(0)``), both packages, duplicated targets."""
    targets = local(dvwa_server) * 2 + local(chip_pages) * 2
    docs = [DVWA_STYLE_TEMPLATE, NAV_PROBE_TEMPLATE] + headless_docs()
    rounds = []
    try:
        for width in (0, 4, 1):
            for mod in (jh, th):
                mod.configure_headless(width)
            rounds.append(scan(docs, targets))
            assert th.headless_threads() == width
    finally:
        for mod in (jh, th):
            mod.configure_headless(None)
    assert rounds[0] == rounds[1] == rounds[2]
    # the dvwa page: the login, the probe and its links; the chip pages: all nine
    assert len(rounds[0]) == 2 * 3 + 2 * HEADLESS_RUN


def test_pool_width_from_env(monkeypatch):
    monkeypatch.setenv("SWARM_HEADLESS_THREADS", "3")
    th.configure_headless(None)
    try:
        assert th.headless_threads() == jh.headless_threads() == 3
        assert th._shared_pool()._max_workers == 3
        th.configure_headless(0)
        assert th._shared_pool() is None
    finally:
        th.configure_headless(None)


def test_run_async_overlaps_port_batch():
    """``run_async`` runs the round on a coordinator thread fanning jobs
    into the pool (width 1 here: a coordinator inside the pool would
    deadlock), while this thread drives a batch of the port's engine on
    the CPU to its end; jobs come back in order."""
    sc = th.HeadlessScanner([both(NAV_PROBE_TEMPLATE)[1]])
    targets = [(f"h{i}", "127.0.0.1", 1, False) for i in range(4)]
    release = threading.Event()
    started = threading.Event()

    def parked_exec(template, target):
        started.set()
        release.wait(30)
        return th.HeadlessHit(target[0], target[2], template.id, [], False)

    sc._exec = parked_exec
    try:
        th.configure_headless(1)
        fut = sc.run_async(targets)
        assert started.wait(10)
        templates, errors = load_corpus(DATA)
        assert not errors
        eng = MatchEngine(templates, device="cpu", batch_rows=8)
        got = eng.match([Response(host="x", port=80, status=200, header=b"HTTP/1.1 200 OK",
                                  body=b"site powered by AcmeCMS, demo-build 3.11")])
        assert "demo-tech" in got[0].template_ids
        assert not fut.done()
        release.set()
        hits = fut.result(timeout=30)
    finally:
        release.set()
        th.configure_headless(None)
    assert [h.host for h in hits] == ["h0", "h1", "h2", "h3"]
