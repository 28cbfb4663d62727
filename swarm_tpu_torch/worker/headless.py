"""Browserless execution of the JS-free headless-template subset — a
copy of ``swarm_tpu/worker/headless.py`` for the port. It uses no
device: matchers and extractors run on the host through the port's
``ops/cpu_ref``.

nuclei's headless protocol drives a real Chrome over CDP; this
framework has no browser engine, so the corpus class was previously
classified out with an honest ``[headless-skipped]`` marker. A
principled subset needs no JS runtime and executes here:

- **navigation**: ``navigate`` (HTTP fetch with redirects + cookie
  jar), ``waitload``/``sleep`` (no-ops without a renderer),
  ``setheader part=request``.
- **form interaction**: ``click``/``text`` steps addressed by xpath.
  ``text`` fills the addressed input; ``click`` on a submit control
  submits its enclosing form (method/action resolution, urlencoded
  fields), on an anchor navigates its href, on anything else is a
  focus no-op. This executes the reference corpus's
  ``headless/dvwa-headless-automatic-login.yaml`` end to end.
- **DOM attribute-collection scripts** (the
  ``headless/extract-urls.yaml`` idiom):
  ``document.querySelectorAll('[src], [href], …')`` mapped over
  property accessors — emulated exactly over the static DOM, with
  URL-valued properties (src/href/action) resolved against the page
  base the way the browser's property getters would.

- **API-instrumentation hooks** (the postmessage-tracker /
  postmessage-outgoing-tracker / window-name-domxss /
  location-domxss idiom): the hook
  script installs a wrapper that logs when the PAGE's own code calls
  the instrumented API at load time (``addEventListener('message')``,
  ``postMessage(.., '*')``, a ``window.name`` or ``location.hash`` /
  ``location.search`` flow into
  eval/document.write/innerHTML). Without a JS runtime the same
  load-time facts are read statically from the page's actual script
  content — inline ``<script>`` bodies, ``on*`` handler attributes,
  and same-origin external scripts (fetched) — and the synthesized
  ``window.alerts`` entries are serialized the way nuclei's Go side
  prints the evaluated value (``map[k:v]``/space-joined arrays), so
  the corpus matchers/extractors run unmodified. Documented bound:
  registrations created only by DYNAMIC code paths (script-built
  script tags, eval'd registrations) are invisible, exactly as DOM
  nodes built by JS are below.

- **prototype-pollution probing** (the PPScan hook in
  prototype-pollution-check.yaml): the hook's location-driven loop is
  replayed for real — the polluted-query URL and the bare-path page
  for the fragment probe are both fetched through the session — and
  the ``Object.prototype`` observation is a static property model
  over the probe page's load-time scripts (does any parse a
  location-derived string into object keys with a prototype-unguarded
  merge: deparam/parseQuery, split('&') + bracket assignment, deep
  extend). See the property-model section below for the bound.

- **library version-check scripts** (CVE-2022-0776's RevealJS
  probe): ``return (X.VERSION <op> "lit" || ...)`` evaluates against
  the VERSION value in the page's actual library source — only
  scripts that DEFINE the global are consulted, with one identifier
  hop for minified dists — under JS string-comparison semantics.
  Documented bound: library sources are fetched same-origin only
  (like every script surface here), so a CDN-hosted library yields no
  verdict (silent, never a guess); a page without the library yields
  no output, matching the browser's ReferenceError.

- **screenshot as a no-op**: the capture itself needs a renderer, but
  a template whose matchers/extractors only inspect response-derivable
  state (status/header/body, emulated script outputs) never CONSUMES
  the image — for those the ``screenshot`` step is an honest no-op and
  the rest of the flow executes. A template that reads the capture
  (a matcher/extractor part named after the screenshot step) keeps the
  skip with its ``js-required-screenshot`` reason: a real render is
  semantically required.

Anything else needing a JS runtime is classified ``js-required`` by
:func:`classify` and keeps the honest skip marker. The documented
bound of the emulation: nodes inserted by page JavaScript are
invisible (the DOM here is the served HTML, not a rendered tree).

Execution scales through one process-wide bounded pool of emulation
contexts (``SWARM_HEADLESS_THREADS`` / :func:`configure_headless`) —
the browser-pool analogue of the engine's walk pool — and
:meth:`HeadlessScanner.run_async` lets the active scanner overlap a
whole headless round with its device batches. The pooled round is
bit-identical to the serial reference path
(``SWARM_HEADLESS_THREADS=0``): every job owns its session, and
results assemble in job order.

Matchers evaluate on the final page via the exact CPU oracle with
nuclei's headless part names mapped (``resp``/``page``/``data`` → the
full response); matchers/extractors over a named script's output read
the emulated script result.

Reference: nuclei-templates' headless/*.yaml plus
cves/2022/CVE-2022-0776.yaml (8 headless templates: 8 execute —
2 browserless + 4 hook-emulated + 1 version-check + the screenshot
template, whose capture is a no-op because its matchers read only
response-derivable state).
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence
from urllib.parse import urljoin, urlencode, urlsplit, urlunsplit

from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.ops import cpu_ref
from swarm_tpu_torch.worker.executor import parse_http_response
from swarm_tpu_torch.worker.sessions import _request_once


# ---------------------------------------------------------------------------
# classification

def _origin(url: str) -> str:
    """Normalized origin key: lowercased hostname plus the port, with
    an explicit scheme-default port (:80 on http, :443 on https)
    collapsed to the implicit form — so a redirect that merely adds the
    default port is still same-origin, as in real browsers. Scheme
    stays OUT of the key (the session socket is pinned to one endpoint;
    an implicit-port http→https redirect rides the same policy the old
    netloc comparison applied: 'h' == 'h' follows)."""
    sp = urlsplit(url)
    if not sp.netloc:
        return ""
    host = (sp.hostname or "").lower()
    try:
        port = sp.port
    except ValueError:
        return sp.netloc.lower()  # unparsable port: compare verbatim
    default = 443 if sp.scheme.lower() == "https" else 80
    if port is None or port == default:
        return host
    return f"{host}:{port}"


def _same_origin(target: str, base: str) -> bool:
    """True when ``target`` stays on ``base``'s origin (relative URLs
    always do)."""
    t = _origin(target)
    return t == "" or t == _origin(base)


_QSA_RE = re.compile(r"querySelectorAll\(\s*['\"]([^'\"]+)['\"]\s*\)")
_ACCESSOR_RE = re.compile(
    r"\.map\(\s*(\w+)\s*=>\s*((?:\1\.\w+\s*\|\|\s*)*\1\.\w+)\s*\)"
)


def _attr_collect_spec(code: str) -> Optional[dict]:
    """Parse the attribute-collection script idiom, or None.

    Recognizes ``[...new Set(Array.from(document.querySelectorAll(
    '[a], [b]')).map(i => i.a || i.b))].join('SEP')`` (optionally
    wrapped in literal prefix/suffix concatenation) and returns
    ``{"attrs": [...], "sep": str, "dedupe": bool, "prefix": str,
    "suffix": str}``.
    """
    qsa = _QSA_RE.search(code)
    acc = _ACCESSOR_RE.search(code)
    if not qsa or not acc:
        return None
    sel_attrs = re.findall(r"\[\s*(\w+)\s*\]", qsa.group(1))
    if not sel_attrs:
        return None
    var = acc.group(1)
    attrs = re.findall(re.escape(var) + r"\.(\w+)", acc.group(2))
    join = re.search(r"\.join\(\s*'((?:\\.|[^'])*)'\s*\)", code)
    sep = join.group(1).encode().decode("unicode_escape") if join else "\n"

    def literal(pat: str) -> str:
        m = re.search(pat, code)
        return (
            m.group(1).encode().decode("unicode_escape") if m else ""
        )

    return {
        "select": sel_attrs,
        "attrs": attrs or sel_attrs,
        "sep": sep,
        "dedupe": "new Set" in code,
        "prefix": literal(r"return\s+'((?:\\.|[^'])*)'\s*\+"),
        "suffix": literal(r"\+\s*'((?:\\.|[^'])*)'\s*\n?\s*}?\s*$"),
    }


#: window.alerts read-back idiom closing every hook template
_ALERTS_READ_RE = re.compile(r"^\s*window\.alerts\s*;?\s*$")

#: library version-check idiom (CVE-2022-0776's RevealJS probe):
#: `return (X.VERSION <op> "lit" || X.VERSION <op> "lit" ...)` — a
#: boolean over a library global's VERSION string, which is a LOAD-TIME
#: fact readable from the page's actual script source (the same
#: honesty class as the hook emulation)
_VERSION_TERM_RE = re.compile(
    r"(\w+)\.VERSION\s*(<=|>=|<|>|===|==)\s*['\"]([^'\"]+)['\"]"
)


def _strip_outer_parens(expr: str) -> str:
    """Remove outer parens only when THE opening paren closes at the
    very end — ``(A) || (B)`` must not lose its per-term parens."""
    while expr.startswith("(") and expr.endswith(")"):
        depth = 0
        wraps = True
        for i, ch in enumerate(expr):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0 and i != len(expr) - 1:
                    wraps = False
                    break
                if depth < 0:
                    wraps = False
                    break
        if not wraps or depth != 0:
            break
        expr = expr[1:-1].strip()
    return expr


def _version_check_spec(code: str) -> Optional[dict]:
    """Parse the version-comparison script shape, or None.

    Accepts a single `return (...)` expression whose every term is
    `GLOBAL.VERSION <op> "literal"` over ONE global, joined by || / &&
    (JS precedence: && binds tighter); parens may wrap the whole
    expression and/or individual terms. Anything else stays
    js-required."""
    m = re.search(r"return\s*(.+?)\s*;?\s*}?\s*$", code, re.S)
    if not m:
        return None
    expr = _strip_outer_parens(m.group(1).strip())
    or_groups = []
    globals_seen = set()
    for part in expr.split("||"):
        and_terms = []
        part = _strip_outer_parens(part.strip())
        for term in part.split("&&"):
            term = _strip_outer_parens(term.strip())
            tm = _VERSION_TERM_RE.fullmatch(term)
            if tm is None:
                return None
            globals_seen.add(tm.group(1))
            and_terms.append((tm.group(2), tm.group(3)))
        or_groups.append(and_terms)
    if len(globals_seen) != 1 or not or_groups:
        return None
    return {"global": globals_seen.pop(), "or_groups": or_groups}


_VERSION_LITERAL_RE = re.compile(
    r"\bVERSION\s*[:=]\s*['\"]([0-9][\w.\-]*)['\"]"
)
#: minified dists hoist the value: ``VERSION:t`` with ``t="4.2.1"``
#: elsewhere — resolved with a single identifier hop
_VERSION_IDENT_RE = re.compile(r"\bVERSION\s*[:=]\s*([A-Za-z_$][\w$]*)\b")


_QUALIFIER_RE = re.compile(r"([A-Za-z_$][\w$]*)\s*\.\s*$")


def _qualifier_before(text: str, pos: int) -> Optional[str]:
    """Identifier qualifying a match at ``pos`` (``ident .`` directly
    before it), from a bounded lookbehind window — the qualifier is a
    few tokens, and an unbounded ``$``-anchored search re-scans the
    whole prefix per candidate (O(n·k) on minified bundles). The
    256-byte window covers the long qualified chains real minified
    bundles produce (the old 64-byte window clipped them); a match
    that begins EXACTLY at a clipped window's start may be the tail of
    a longer identifier the window cut in half — discard it rather
    than attribute the VERSION to a truncated name."""
    lo = max(0, pos - 256)
    qm = _QUALIFIER_RE.search(text, lo, pos)
    if qm is None:
        return None
    if lo > 0 and qm.start(1) == lo:
        return None  # possibly truncated identifier
    return qm.group(1)


def _matched_brace_pairs(text: str) -> tuple:
    """``(starts_sorted, ends_sorted, pairs)`` of the matched ``{...}``
    blocks — the best-effort block structure behind module-window
    scoping. ``pairs`` is the raw ``(start, end)`` list; the sorted
    twins answer depth queries via bisect. Braces inside string/regex
    literals can unbalance the scan; the consumers below all fail OPEN
    (toward the pre-scoping whole-script behavior) in that case."""
    stack: list = []
    pairs: list = []
    for i, ch in enumerate(text):
        if ch == "{":
            stack.append(i)
        elif ch == "}" and stack:
            pairs.append((stack.pop(), i + 1))
    starts = sorted(s for s, _e in pairs)
    ends = sorted(e for _s, e in pairs)
    return starts, ends, pairs


def _module_window(text: str, pos: int, structure=None) -> tuple:
    """``(lo, hi)`` bounds of the OUTERMOST balanced ``{...}`` block
    containing ``pos`` — the enclosing module/factory body in a
    concatenated UMD bundle. Identifiers (factory params like the
    ubiquitous minified ``e``) are only meaningful inside their own
    factory, so alias resolution must not cross this boundary.
    Outermost, not innermost: the export assignment is routinely
    wrapped in a guard (``if(typeof window!=="undefined"){window.X=e}``)
    whose inner block would exclude the rest of the factory body —
    sibling factories in a concatenated bundle are still separate
    top-level blocks either way. When ``pos`` sits at top level (or
    the brace scan is unbalanced) the whole script is the window."""
    _starts, _ends, pairs = (
        structure if structure is not None else _matched_brace_pairs(text)
    )
    best = (0, len(text))
    for s, e in pairs:
        if s <= pos < e and (best == (0, len(text)) or s < best[0]):
            best = (s, e)
    return best


def _aliases_of(
    text: str, g: str, define_pos: int = 0, window: Optional[tuple] = None
) -> set:
    """Local identifiers the enclosing module assigns TO global ``g``
    (UMD shape ``!function(e){e.VERSION="3.8.0"; window.Reveal = e}({})``):
    a ``VERSION`` literal qualified by such an alias belongs to ``g``
    itself, not to another library in the bundle.

    Two containment rules keep minified bundles from donating another
    module's VERSION to the target: the global is anchored with
    ``(?<![\\w$.])`` (``MyReveal = e`` and ``Plugin.Reveal = e`` are
    not assignments to the global), and the search is scoped to the
    module/factory block enclosing ``define_pos`` — a second factory
    reusing the same minified parameter name (``e``) must not have its
    parameter accepted as an alias of this module's export.
    ``window`` is an optional precomputed ``_module_window`` result
    (the brace scan is O(len(text)); callers that also need the window
    pass it in instead of paying the scan twice)."""
    lo, hi = window if window is not None else _module_window(
        text, define_pos
    )
    return {
        am.group(1)
        for am in re.finditer(
            rf"(?<![\w$.])(?:window\s*\.\s*)?(?<![\w$]){re.escape(g)}"
            rf"\s*=(?![=])\s*([A-Za-z_$][\w$]*)\b",
            text[lo:hi],
        )
        if am.group(1) != g
    }


def _script_version_of(
    text: str, g: str, define_pos: int
) -> Optional[str]:
    """The VERSION value script ``text`` carries FOR global ``g``
    (whose define site starts at ``define_pos``): an explicit
    ``g.VERSION = "lit"`` wins; otherwise VERSION literals (direct or
    one identifier hop, ``VERSION:t`` + ``t="4.2.1"``) are candidates
    — except those qualified with ANOTHER global (``Plugin.VERSION``
    in a bundle must not donate Reveal's version). Among candidates,
    the first at/after the define site is the defining object's own;
    with none there, a script-wide UNIQUE value is still unambiguous.
    Multiple distinct values before the define site → None (fail
    closed: no verdict rather than a guessed one)."""
    m = re.search(
        rf"\b{re.escape(g)}\.VERSION\s*=\s*['\"]([0-9][\w.\-]*)['\"]",
        text,
    )
    if m:
        return m.group(1)
    import bisect as _bisect

    structure = _matched_brace_pairs(text)
    starts, ends, _pairs = structure
    lo, hi = window = _module_window(text, define_pos, structure)
    aliases = _aliases_of(text, g, define_pos, window=window)

    def qual_ok(q: Optional[str], pos: int) -> bool:
        # g itself qualifies anywhere. An alias qualifies inside its
        # own module window — the same minified identifier in a
        # SIBLING factory is a different object — and at TOP LEVEL:
        # a top-level module body shares one scope with its (possibly
        # guard-wrapped) export assignment, so scoping it to the guard
        # block would drop the module's own VERSION.
        if q is None or q == g:
            return True
        if q not in aliases:
            return False
        if lo <= pos < hi:
            return True
        # depth 0 = inside no matched block (matched pairs nest, so
        # started-minus-ended counts the enclosing blocks)
        return (
            _bisect.bisect_right(starts, pos)
            - _bisect.bisect_right(ends, pos)
        ) == 0

    vals: list = []
    for vm in _VERSION_LITERAL_RE.finditer(text):
        q = _qualifier_before(text, vm.start())
        if q is not None and not qual_ok(q, vm.start()):
            continue
        vals.append((vm.start(), vm.group(1)))
    # identifier hops are candidates ALONGSIDE direct literals — a
    # pre-define literal of another object must not shadow the target's
    # own hoisted ``VERSION:t``
    for im in _VERSION_IDENT_RE.finditer(text):
        q = _qualifier_before(text, im.start())
        if q is not None and not qual_ok(q, im.start()):
            continue
        ident = re.escape(im.group(1))
        lit = re.search(
            rf"\b{ident}\s*=\s*['\"]([0-9][\w.\-]*)['\"]", text
        )
        if lit:
            vals.append((im.start(), lit.group(1)))
    vals.sort()
    for pos, val in vals:
        if pos >= define_pos:
            return val
    distinct = {v for _pos, v in vals}
    if len(distinct) == 1:
        return distinct.pop()
    return None


def _eval_version_check(sess: "_Session", spec: dict) -> Optional[str]:
    """Evaluate the version comparison against the VERSION value in
    the page's load-time scripts. Only scripts that DEFINE the library
    global (``var/let/const/window.GLOBAL =`` / ``GLOBAL:`` / UMD
    export) are consulted — a script that merely calls into the
    library must not donate an unrelated object's VERSION. A page
    without a fetchable defining script (no library, or the library on
    a cross-origin CDN — the emulation's standing same-origin bound)
    yields None: no output, like the browser's ReferenceError. JS
    string comparison is lexicographic over code units, exactly
    Python's str comparison for this ASCII domain."""
    g = re.escape(spec["global"])
    # `=(?![=])`: an assignment defines, a comparison (`Reveal ==`)
    # merely consults — consumers must not be treated as define sites
    define_re = re.compile(
        rf"(?:\b(?:var|let|const)\s+{g}\b|window\.{g}\s*=(?![=])|"
        rf"\b{g}\s*=(?![=])|[{{,]\s*{g}\s*:|exports\.{g}\s*=(?![=]))"
    )
    version = None
    for _label, text in _page_scripts(sess):
        dm = define_re.search(text)
        if dm is None:
            continue
        version = _script_version_of(text, spec["global"], dm.start())
        if version is not None:
            break
    if version is None:
        return None
    ops = {
        "<=": lambda a, b: a <= b,
        ">=": lambda a, b: a >= b,
        "<": lambda a, b: a < b,
        ">": lambda a, b: a > b,
        "==": lambda a, b: a == b,
        "===": lambda a, b: a == b,
    }
    result = any(
        all(ops[op](version, lit) for op, lit in and_terms)
        for and_terms in spec["or_groups"]
    )
    return "true" if result else "false"


def _hook_spec(code: str) -> Optional[dict]:
    """Classify a ``hook: true`` script by the instrumentation it
    installs, or None when the hook's behavior can't be emulated
    statically (e.g. prototype-pollution's location-driven loop).

    Recognition is structural (what APIs the wrapper intercepts), not
    textual equality — upstream reformatting of the same hook keeps
    working; genuinely different hooks stay js-required."""
    if "Object.prototype" in code and "__proto__" in code:
        # PPScan's location-driven pollution loop (prototype-pollution-
        # check.yaml): probe markers/payload parsed from the hook so an
        # upstream token rotation keeps working; a structurally
        # different pollution hook stays js-required
        q = re.search(
            r"searchParams\.append\(\s*['\"]__proto__\[(\w+)\]['\"]\s*,"
            r"\s*['\"](\w+)['\"]",
            code,
        )
        h = re.search(r"hash\s*=\s*['\"]__proto__\[(\w+)\]=(\w+)", code)
        if q and h and "location" in code:
            return {
                "kind": "proto-pollution",
                "qmark": q.group(1),
                "hmark": h.group(1),
                "value": q.group(2),
            }
        return None
    if "location" in code and "__proto__" in code:
        return None  # unrecognized pollution-style hook
    if (
        "Window.prototype.addEventListener" in code
        and re.search(r"type\s*===?\s*['\"]message['\"]", code)
    ):
        return {"kind": "listen-message"}
    if re.search(r"window\.postMessage\s*=", code) and re.search(
        r"origin\s*==?=?\s*['\"]\*['\"]", code
    ):
        return {"kind": "post-star"}
    if "window.name" in code and re.search(
        r"innerHTML|document\.write|eval", code
    ):
        return {"kind": "window-name-sink"}
    if re.search(
        r"location\.hash|location\.search|document\.URL", code
    ) and re.search(r"innerHTML|document\.write|eval", code):
        # location-domxss idiom: the hook logs URL-derived strings
        # (hash/search/href) flowing into the DOM-XSS sinks — same
        # static read-back as the window.name tracker, one source over
        # (the __proto__-style pollution hooks matched above, so a
        # location-driven pollution loop never lands here)
        return {"kind": "location-sink"}
    return None


def _screenshot_consumed(t: Template, step: dict) -> bool:
    """Whether anything reads the capture: a matcher/extractor part
    named after the screenshot step (or the literal ``screenshot``).
    Only then does the template semantically require a real render."""
    args = step.get("args") or {}
    name = str(step.get("name") or args.get("to") or "screenshot").lower()
    parts = {name, "screenshot"}
    for op in t.operations:
        for m in op.matchers:
            if (m.part or "").lower() in parts:
                return True
        for ex in op.extractors:
            if (ex.part or "").lower() in parts:
                return True
    return False


def classify(t: Template) -> Optional[str]:
    """None when the template executes browserlessly, else the reason
    it can't (js-required / unsupported-action-* / no-steps)."""
    if t.protocol != "headless":
        return "not-headless"
    saw_steps = False
    needs_js_env = False  # response-header rewrites etc.
    saw_hook = saw_alerts_read = False
    for op in t.operations:
        for step in op.steps:
            saw_steps = True
            act = str(step.get("action") or "")
            args = step.get("args") or {}
            if act in ("navigate", "waitload", "sleep"):
                continue
            if act == "setheader":
                # request headers we can send; response-header
                # rewriting (CSP relaxation for the hook's injected
                # frames) only matters to a JS runtime — a no-op under
                # hook emulation, js-required otherwise
                if str(args.get("part") or "request") != "request":
                    needs_js_env = True
                continue
            if act == "screenshot":
                # the capture needs a renderer; the FLOW doesn't. When
                # nothing consumes the image the step is an honest
                # no-op — otherwise keep the skip with its reason
                if _screenshot_consumed(t, step):
                    return "js-required-screenshot"
                continue
            if act in ("text", "click"):
                if str(args.get("by") or "") not in ("x", "xpath"):
                    return "unsupported-selector"
                continue
            if act == "script":
                code = str(args.get("code") or "")
                if args.get("hook"):
                    if _hook_spec(code) is None:
                        return "js-required"
                    saw_hook = True
                    continue
                if _attr_collect_spec(code) is not None:
                    continue
                if _ALERTS_READ_RE.match(code):
                    saw_alerts_read = True
                    continue
                if _version_check_spec(code) is not None:
                    continue
                return "js-required"
            return f"unsupported-action-{act or '?'}"
    if not saw_steps:
        return "no-steps"
    if saw_hook and not saw_alerts_read:
        return "js-required"  # hook without the known read-back idiom
    if needs_js_env and not saw_hook:
        return "js-required"
    return None


# ---------------------------------------------------------------------------
# execution

# Process-wide bounded pool of emulation contexts — the browser-pool
# analogue of the engine's walk pool (docs/HOST_WALK.md): every
# HeadlessScanner in the process shares it, so concurrent scans can't
# multiply thread counts, and an async round rides it while the device
# engine chews its own batches.
_POOL_LOCK = threading.Lock()  # guards: _POOL, _POOL_THREADS
_POOL: Optional[ThreadPoolExecutor] = None
_POOL_THREADS: Optional[int] = None


def headless_threads() -> int:
    """Effective shared-pool width: :func:`configure_headless` arg >
    ``SWARM_HEADLESS_THREADS`` > 16. 0 pins the serial reference
    path (every round runs inline, no pool)."""
    with _POOL_LOCK:
        n = _POOL_THREADS
    if n is None:
        env = os.environ.get("SWARM_HEADLESS_THREADS")
        n = int(env) if env else 16
    return max(0, int(n))


def configure_headless(threads: Optional[int]) -> None:
    """Re-point the shared emulation pool at runtime (bench A/B,
    tests): shuts any existing pool down, then re-decides lazily on
    next use. ``None`` restores env-derived sizing."""
    global _POOL, _POOL_THREADS
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
        _POOL_THREADS = threads
    if pool is not None:
        pool.shutdown(wait=True)


def _shared_pool() -> Optional[ThreadPoolExecutor]:
    """The process pool, lazily built at the configured width; None
    when the width is 0 (serial reference)."""
    n = headless_threads()
    if n <= 0:
        return None
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="headless"
            )
        return _POOL


_DEFAULT_HEADERS = (
    ("User-Agent", "Mozilla/5.0 (X11; Linux x86_64) swarm-tpu-headless"),
    ("Accept", "*/*"),
)
_URL_PROPS = {"src", "href", "action"}  # browser resolves these


@dataclasses.dataclass
class HeadlessHit:
    host: str
    port: int
    template_id: str
    extractions: list
    tls: bool
    matcher_names: list = dataclasses.field(default_factory=list)


class _Page:
    """One fetched page: parsed DOM + parent links for form lookup."""

    def __init__(self, url: str, status: int, header: bytes, body: bytes):
        from swarm_tpu_torch.fingerprints.extractors import parse_html

        self.url = url
        self.status = status
        self.header = header
        self.body = body
        self.root = parse_html(body.decode("utf-8", "replace"))
        self.parent: dict = {}
        if self.root is not None:
            stack = [self.root]
            while stack:
                node = stack.pop()
                for child in node:
                    self.parent[id(child)] = node
                    stack.append(child)

    def xpath(self, path: str):
        from swarm_tpu_torch.fingerprints.extractors import xpath_nodes

        if self.root is None:
            return None
        nodes = xpath_nodes(self.root, path)
        return nodes[0] if nodes else None

    def form_of(self, node):
        while node is not None:
            if node.tag == "form":
                return node
            node = self.parent.get(id(node))
        return None


class _Session:
    """Cookie jar + header state for one (target, template) run."""

    def __init__(self, host, ip, port, tls, timeout, connect_timeout):
        self.host = host
        self.ip = ip
        self.port = port
        self.tls = tls
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.cookies: dict = {}
        self.headers: dict = {}
        self.page: Optional[_Page] = None
        self.hooks: list = []  # installed hook-emulation specs
        default = (tls and port == 443) or (not tls and port == 80)
        self.base_url = (
            f"{'https' if tls else 'http'}://{host}"
            + ("" if default else f":{port}")
        )

    def fetch(self, url: str, method="GET", body=b"", content_type=None,
              redirects=5) -> bool:
        sp = urlsplit(url)
        path = (sp.path or "/") + (f"?{sp.query}" if sp.query else "")
        # browsers omit the scheme-default port from Host: a followed
        # redirect to http://h:80/... must still send "Host: h" or a
        # strict name-based vhost silently serves its default site
        host_hdr = sp.netloc or self.host
        default = 443 if sp.scheme.lower() == "https" else 80
        try:
            if sp.hostname and sp.port == default:
                host_hdr = sp.hostname
        except ValueError:
            # malformed/out-of-range port in a caller URL: keep the
            # verbatim netloc Host header (mirrors _origin) instead of
            # crashing the whole run()
            pass
        lines = [f"{method} {path} HTTP/1.1", f"Host: {host_hdr}"]
        sent = {"host"}
        for k, v in list(self.headers.items()) + list(_DEFAULT_HEADERS):
            if k.lower() in sent:
                continue
            sent.add(k.lower())
            lines.append(f"{k}: {v}")
        if self.cookies:
            lines.append(
                "Cookie: "
                + "; ".join(f"{k}={v}" for k, v in self.cookies.items())
            )
        if body or method not in ("GET", "HEAD"):
            if content_type:
                lines.append(f"Content-Type: {content_type}")
            lines.append(f"Content-Length: {len(body)}")
        lines.append("Connection: close")
        payload = ("\r\n".join(lines) + "\r\n\r\n").encode() + body
        raw = _request_once(
            self.ip or self.host, self.port, self.tls, payload,
            self.timeout, self.connect_timeout,
        )
        if raw is None:
            return False
        status, header, rbody = parse_http_response(raw)
        for m in re.finditer(
            rb"(?im)^set-cookie:\s*([^=;\s]+)=([^;\r\n]*)", header
        ):
            self.cookies[m.group(1).decode("latin-1")] = (
                m.group(2).decode("latin-1")
            )
        loc = re.search(rb"(?im)^location:\s*(\S+)", header)
        if status in (301, 302, 303, 307, 308) and loc and redirects > 0:
            target = urljoin(url, loc.group(1).decode("latin-1"))
            # same-origin only: the jar and socket are bound to the
            # scan target, and a scanner must not wander off-host
            if _same_origin(target, url):
                nxt_method = "GET" if status in (301, 302, 303) else method
                nxt_body = b"" if status in (301, 302, 303) else body
                return self.fetch(
                    target, nxt_method, nxt_body, content_type,
                    redirects - 1,
                )
        self.page = _Page(url, status, header, rbody)
        return True

    def fetch_resource(self, url: str) -> Optional["_Page"]:
        """Subresource fetch (external scripts): same request machinery
        and cookie jar, but the session's page state is untouched."""
        saved = self.page
        try:
            ok = self.fetch(url)
            return self.page if ok else None
        finally:
            self.page = saved


def _run_steps(t: Template, steps, sess: _Session, outputs: dict) -> bool:
    """Execute one op's step list; False on a dead/failed navigation."""
    for step in steps:
        act = str(step.get("action") or "")
        args = step.get("args") or {}
        if act in ("waitload", "sleep", "screenshot"):
            # screenshot: classify admitted only unconsumed captures —
            # the flow continues, the image is never read
            continue
        if act == "setheader":
            if str(args.get("part") or "request") != "request":
                continue  # response rewriting: no-op without a renderer
            key, val = str(args.get("key") or ""), str(args.get("value") or "")
            if key:
                sess.headers[key] = val
            continue
        if act == "navigate":
            url = str(args.get("url") or "{{BaseURL}}")
            url = url.replace("{{BaseURL}}", sess.base_url)
            url = url.replace("{{RootURL}}", sess.base_url)
            url = url.replace("{{Hostname}}", sess.host)
            if not sess.fetch(urljoin(sess.base_url + "/", url)):
                return False
            continue
        if act == "text":
            node = sess.page.xpath(str(args.get("xpath") or "")) if sess.page else None
            if node is not None:
                val = str(args.get("value") or "")
                node.set("value", val)
                if node.tag.lower() == "textarea":
                    node.text = val  # itertext() must yield the typed value
                    for child in list(node):
                        node.remove(child)
            continue
        if act == "click":
            page = sess.page
            node = page.xpath(str(args.get("xpath") or "")) if page else None
            if node is None:
                continue
            tag = node.tag.lower()
            typ = (node.get("type") or "").lower()
            if tag == "a" and node.get("href"):
                target = urljoin(page.url, node.get("href"))
                # same-origin only (matches the redirect policy): the
                # socket is bound to the scan target, and a foreign
                # Host header would silently produce vhost mismatches
                if not _same_origin(target, page.url):
                    continue
                if not sess.fetch(target):
                    return False
            elif (tag == "input" and typ in ("submit", "image")) or (
                tag == "button" and typ in ("", "submit")
            ):
                form = page.form_of(node)
                if form is None:
                    continue
                if not _submit(sess, page, form, clicked=node):
                    return False
            # any other element: focus — no page effect
            continue
        if act == "script":
            code = str(args.get("code") or "")
            if args.get("hook"):
                hook = _hook_spec(code)
                if hook is not None:
                    sess.hooks.append(hook)
                continue
            if _ALERTS_READ_RE.match(code):
                name = str(step.get("name") or args.get("name") or "alerts")
                outputs[name] = _emulate_alerts(sess)
                continue
            spec = _attr_collect_spec(code)
            if spec is not None and sess.page is not None:
                name = str(step.get("name") or args.get("name") or "script")
                outputs[name] = _collect_attrs(sess.page, spec)
                continue
            vspec = _version_check_spec(code)
            if vspec is not None and sess.page is not None:
                verdict = _eval_version_check(sess, vspec)
                if verdict is not None:
                    name = str(
                        step.get("name") or args.get("name") or "script"
                    )
                    outputs[name] = verdict
                # library absent: no output — the matcher over this
                # part cannot fire, matching the browser's thrown
                # ReferenceError producing no result
            continue
    return True


def _submit(sess: _Session, page: _Page, form, clicked) -> bool:
    method = (form.get("method") or "get").lower()
    action = urljoin(page.url, form.get("action") or page.url)
    if not _same_origin(action, page.url):
        return True  # cross-origin form: out of scan scope, no-op
    fields: list = []
    for el in form.iter():
        name = el.get("name")
        if not name:
            continue
        tag = el.tag.lower()
        typ = (el.get("type") or "").lower()
        if tag == "input":
            if typ in ("submit", "image", "button"):
                if el is clicked:
                    fields.append((name, el.get("value") or ""))
                continue
            if typ in ("checkbox", "radio") and el.get("checked") is None:
                continue
            fields.append((name, el.get("value") or ""))
        elif tag == "textarea":
            typed = el.get("value")
            fields.append(
                (name, typed if typed is not None else "".join(el.itertext()))
            )
        elif tag == "select":
            opts = [o for o in el.iter() if o.tag.lower() == "option"]
            sel = next(
                (o for o in opts if o.get("selected") is not None),
                opts[0] if opts else None,
            )
            if sel is not None:
                fields.append((name, sel.get("value") or "".join(sel.itertext())))
    data = urlencode(fields)
    if method == "post":
        return sess.fetch(
            action, "POST", data.encode(),
            content_type="application/x-www-form-urlencoded",
        )
    # GET submit REPLACES the action's query with the serialized
    # fields (browser semantics) — appending would produce a request
    # real Chrome never sends
    sp = urlsplit(action)
    return sess.fetch(
        urlunsplit((sp.scheme, sp.netloc, sp.path, data, ""))
    )


def _collect_attrs(page: _Page, spec: dict) -> str:
    vals: list = []
    if page.root is not None:
        for el in page.root.iter():
            if not any(el.get(a) is not None for a in spec["select"]):
                continue
            for a in spec["attrs"]:
                raw = el.get(a)
                if raw:
                    # browser property getters resolve URL-valued
                    # attributes against the document base
                    vals.append(
                        urljoin(page.url, raw) if a in _URL_PROPS else raw
                    )
                    break
    if spec["dedupe"]:
        vals = list(dict.fromkeys(vals))
    return spec["prefix"] + spec["sep"].join(vals) + spec["suffix"]


# ---------------------------------------------------------------------------
# hook emulation: static load-time instrumentation of the page's
# actual script content (see module docstring for the honesty bound)

_MAX_EXT_SCRIPTS = 5
_MAX_SCRIPT_BYTES = 512 * 1024


def _go_fmt(v) -> str:
    """Serialize the way nuclei's Go side prints an Evaluate result
    (fmt.Sprint of the JSON-decoded value): maps as ``map[k:v ...]``
    with sorted keys, arrays space-joined in brackets — the corpus's
    ``part: alerts`` word matchers are written against THIS shape
    (e.g. ``at Window.addEventListener``, ``sink:``)."""
    if isinstance(v, dict):
        return "map[" + " ".join(
            f"{k}:{_go_fmt(x)}" for k, x in sorted(v.items())
        ) + "]"
    if isinstance(v, (list, tuple)):
        return "[" + " ".join(_go_fmt(x) for x in v) + "]"
    return str(v)


def _page_scripts(sess: "_Session", page: Optional["_Page"] = None) -> list:
    """(label, text) of every load-time script the page runs: inline
    ``<script>`` bodies, ``on*`` handler attributes, and same-origin
    external scripts (fetched, bounded). ``page`` defaults to the
    session's current page (probe passes hand in a fetched page)."""
    page = page if page is not None else sess.page
    out: list = []
    if page is None or page.root is None:
        return out
    ext: list = []
    for el in page.root.iter():
        tag = str(getattr(el, "tag", "")).lower()
        for attr, val in (el.attrib or {}).items():
            if attr.lower().startswith("on") and val:
                out.append((f"{page.url}#{attr.lower()}", val))
        if tag != "script":
            continue
        src = el.get("src")
        if src:
            target = urljoin(page.url, src)
            if _same_origin(target, page.url) and target not in ext:
                ext.append(target)
            continue
        text = (el.text or "") + "".join(
            (c.tail or "") for c in el
        )
        if text.strip():
            out.append((page.url, text))
    for target in ext[:_MAX_EXT_SCRIPTS]:
        res = sess.fetch_resource(target)
        if res is not None and res.body:
            out.append(
                (target, res.body[:_MAX_SCRIPT_BYTES].decode("latin-1"))
            )
    return out


_LISTEN_RE = re.compile(r"addEventListener\s*\(\s*['\"]message['\"]")
_ONMESSAGE_RE = re.compile(r"\bonmessage\s*=")
_POSTMSG_RE = re.compile(r"\bpostMessage\s*\(")
_NAME_ALIAS_RE = re.compile(
    r"(?:var|let|const)\s+(\w+)\s*=\s*window\.name\b"
)
#: location-source aliases: ``var h = location.hash`` (the optional
#: trailing accessor — .substr(1), .slice(1) — still taints the alias)
_LOC_ALIAS_RE = re.compile(
    r"(?:var|let|const)\s+(\w+)\s*=\s*"
    r"(?:window\.)?(location\.hash|location\.search|document\.URL)\b"
)


def _source_sinks(text: str, sources: list) -> list:
    """(sink, source, snippet) for flows of the given source
    expressions into eval / document.write / innerHTML — direct or via
    one local alias. ``sources`` is ``[(label, pattern), ...]``."""
    out = []
    for label, name in sources:
        for sink, pat in (
            ("eval", rf"\beval\s*\(\s*[^;\n]*?\b{name}\b"),
            ("document.write", rf"document\.write\s*\(\s*[^;\n]*?\b{name}\b"),
            ("innerHTML", rf"\.innerHTML\s*[+]?=\s*[^;\n]*?\b{name}\b"),
        ):
            for m in re.finditer(pat, text):
                out.append((sink, label, m.group(0)[:120]))
    return out


def _window_name_sinks(text: str) -> list:
    """(sink, snippet) for flows of window.name into eval /
    document.write / innerHTML — direct or via one local alias."""
    sources = [("window.name", r"window\.name")]
    sources += [
        ("window.name", re.escape(m.group(1)))
        for m in _NAME_ALIAS_RE.finditer(text)
    ]
    return [
        (sink, snippet)
        for sink, _src, snippet in _source_sinks(text, sources)
    ]


def _location_sinks(text: str) -> list:
    """(sink, source, snippet) for flows of location.hash /
    location.search / document.URL into the DOM-XSS sinks — direct or
    via one local alias (the location-domxss hook's read-back)."""
    sources = [
        ("location.hash", r"location\.hash"),
        ("location.search", r"location\.search"),
        ("document.URL", r"document\.URL"),
    ]
    sources += [
        (m.group(2), re.escape(m.group(1)))
        for m in _LOC_ALIAS_RE.finditer(text)
    ]
    return _source_sinks(text, sources)


# --- prototype-pollution property model -----------------------------------
#
# PPScan (the hook in prototype-pollution-check.yaml) detects pollution
# dynamically: navigate with __proto__'d query params, then again with
# a __proto__'d fragment, and check Object.prototype for the payload.
# Without a JS runtime the navigation half runs for real (both probe
# URLs are fetched through the session) and the observation half is a
# static property model over the probe page's load-time scripts: a
# script pollutes Object.prototype from the URL iff it parses a
# location-derived string into object keys with a prototype-unguarded
# merge (deparam/parseQuery, split('&') + bracket assignment, or a
# deep extend over the split) — the client-side parser classes PPScan
# exists to catch. Documented bound: parsers reached only through
# dynamically built code are invisible, same as DOM nodes built by JS.

_POLLUTE_PARSE_RE = re.compile(
    r"\bdeparam\s*\(|\.parseQuery\s*\(|\bparse_str\s*\("
)
_POLLUTE_SPLIT_RE = re.compile(
    r"\.split\(\s*(?:['\"][&;=]['\"]|/[^/\n]*[&;][^/\n]*/)\s*\)"
)
# any computed-key assignment — `obj[k] =`, `obj[keys[i]] =` (nested
# brackets included, hence the lookback on the closing bracket only)
_POLLUTE_ASSIGN_RE = re.compile(r"\]\s*=(?![=>])")
_POLLUTE_EXTEND_RE = re.compile(r"\bextend\s*\(\s*true\s*,")
_POLLUTE_GUARD_RE = re.compile(
    r"hasOwnProperty\s*\(|['\"]__proto__['\"]|Object\.create\(\s*null\s*\)"
    r"|['\"]constructor['\"]"
)
_LOC_SEARCH_RE = re.compile(
    r"location\.search|location\.href|document\.URL\b"
    r"|window\.location(?![\w.])"
)
_LOC_HASH_RE = re.compile(
    r"location\.hash|location\.href|document\.URL\b"
    r"|window\.location(?![\w.])"
)


def _pollution_script_model(text: str) -> set:
    """Which location sources (``search`` / ``hash``) this script
    parses into object keys with a prototype-UNguarded merge; empty
    when the script doesn't parse the URL or guards its keys."""
    if _POLLUTE_GUARD_RE.search(text):
        return set()
    vulnerable = bool(
        _POLLUTE_PARSE_RE.search(text)
        or (
            _POLLUTE_SPLIT_RE.search(text)
            and _POLLUTE_ASSIGN_RE.search(text)
        )
        or (
            _POLLUTE_EXTEND_RE.search(text)
            and _POLLUTE_SPLIT_RE.search(text)
        )
    )
    if not vulnerable:
        return set()
    out = set()
    if _LOC_SEARCH_RE.search(text):
        out.add("search")
    if _LOC_HASH_RE.search(text):
        out.add("hash")
    return out


def _pollution_probe(sess: "_Session", hook: dict) -> list:
    """Run PPScan's two navigations for real and apply the property
    model; returns the ``logger(location.href)`` values a polluted run
    would record (URLs carrying the __proto__ markers)."""
    page = sess.page
    if page is None:
        return []
    val = hook["value"]
    out: list = []
    sp = urlsplit(page.url)
    # probe 1: searchParams.append on the current URL (query reaches
    # the server — the polluted page may differ from the base page)
    extra = (
        f"__proto__[{hook['qmark']}]={val}"
        f"&__proto__.{hook['qmark']}={val}"
    )
    q = f"{sp.query}&{extra}" if sp.query else extra
    qurl = urlunsplit((sp.scheme, sp.netloc, sp.path or "/", q, ""))
    qpage = sess.fetch_resource(qurl)
    if qpage is not None:
        srcs: set = set()
        for _label, text in _page_scripts(sess, page=qpage):
            srcs |= _pollution_script_model(text)
        if "search" in srcs:
            out.append(qurl)
    # probe 2: origin + pathname with the markers in the FRAGMENT —
    # never sent on the wire, so the fetched page is the bare path and
    # only hash/href-reading parsers can see the payload
    hurl = urlunsplit((sp.scheme, sp.netloc, sp.path or "/", "", ""))
    hfrag = (
        f"__proto__[{hook['hmark']}]={val}"
        f"&__proto__.{hook['hmark']}={val}&dummy"
    )
    hpage = sess.fetch_resource(hurl)
    if hpage is not None:
        srcs = set()
        for _label, text in _page_scripts(sess, page=hpage):
            srcs |= _pollution_script_model(text)
        if "hash" in srcs:
            out.append(hurl + "#" + hfrag)
    return out


def _emulate_alerts(sess: "_Session") -> str:
    """The ``window.alerts`` array the installed hooks would hold after
    load, synthesized from the page's static script content."""
    page = sess.page
    if page is None or not sess.hooks:
        return "[]"
    scripts = _page_scripts(sess)
    alerts: list = []
    for hook in sess.hooks:
        kind = hook["kind"]
        if kind == "listen-message":
            for label, text in scripts:
                n = len(_LISTEN_RE.findall(text)) + len(
                    _ONMESSAGE_RE.findall(text)
                )
                alerts.extend(
                    [f"at Window.addEventListener ({label})",
                     f"at {page.url}"]
                    for _ in range(n)
                )
        elif kind == "post-star":
            for label, text in scripts:
                for m in _POSTMSG_RE.finditer(text):
                    window = text[m.end(): m.end() + 200]
                    if re.search(r"['\"]\*['\"]", window):
                        alerts.append({
                            "args": {"origin": "*"},
                            "stack": [f"at window.postMessage ({label})"],
                        })
        elif kind == "window-name-sink":
            for label, text in scripts:
                for sink, snippet in _window_name_sinks(text):
                    alerts.append({
                        "code": snippet,
                        "sink": sink,
                        "source": "window.name",
                        "stack": [f"at {label}"],
                    })
        elif kind == "location-sink":
            for label, text in scripts:
                for sink, source, snippet in _location_sinks(text):
                    alerts.append({
                        "code": snippet,
                        "sink": sink,
                        "source": source,
                        "stack": [f"at {label}"],
                    })
        elif kind == "proto-pollution":
            alerts.extend(_pollution_probe(sess, hook))
    return _go_fmt(alerts)


_PART_ALIAS = {"resp": "response", "page": "response", "data": "response"}


class HeadlessScanner:
    """Run the browserless headless subset against live targets.

    Integrated by worker/active.py the same way the ssl/session passes
    are: templates :func:`classify` accepts execute here; the rest keep
    the honest skip marker.
    """

    def __init__(self, templates: Sequence[Template], probe_spec=None):
        self.templates = [t for t in templates if classify(t) is None]
        spec = probe_spec or {}
        self.timeout = float(spec.get("read_timeout_ms", 5000)) / 1000.0
        self.connect_timeout = (
            float(spec.get("connect_timeout_ms", 3000)) / 1000.0
        )
        # per-round in-flight cap on the SHARED pool (a wide fleet scan
        # must not starve every other scanner's rounds); the pool's own
        # width bounds the process
        self.concurrency = int(spec.get("headless_concurrency", 16))

    def run(self, targets) -> list:
        """targets: (host, ip, port, tls) tuples (the liveness shape).
        One batched round over the shared pool — bit-identical to the
        serial reference (results assemble in job order; every job
        owns its session)."""
        return self._run_round(targets)

    def run_async(self, targets) -> Future:
        """Start a round without blocking: the active scanner launches
        this right after liveness and joins after its device waves, so
        emulation I/O overlaps device batches. The round runs on a
        dedicated coordinator thread (never a pool slot — a width-1
        pool must not deadlock on its own coordinator) fanning jobs
        into the shared pool."""
        fut: Future = Future()

        def round_main() -> None:
            try:
                fut.set_result(self._run_round(targets))
            except BaseException as e:  # surfaced at .result()
                fut.set_exception(e)

        threading.Thread(
            target=round_main, name="headless-round", daemon=True
        ).start()
        return fut

    def _run_round(self, targets) -> list:
        if not self.templates or not targets:
            return []
        jobs = [
            (t, tgt) for tgt in targets for t in self.templates
        ]
        pool = _shared_pool()
        if pool is None:  # serial reference path
            results = [self._exec(*j) for j in jobs]
            return [h for h in results if h is not None]
        results = []
        cap = max(1, self.concurrency)
        for i in range(0, len(jobs), cap):
            futs = [
                pool.submit(self._exec, *j) for j in jobs[i: i + cap]
            ]
            results.extend(f.result() for f in futs)
        return [h for h in results if h is not None]

    # ------------------------------------------------------------------
    def _exec(self, t: Template, target) -> Optional[HeadlessHit]:
        host, ip, port, tls = target
        sess = _Session(
            host, ip, port, tls, self.timeout, self.connect_timeout
        )
        for op in t.operations:
            outputs: dict = {}
            if not _run_steps(t, op.steps, sess, outputs):
                return None
            if sess.page is None:
                return None
            row = Response(
                host=host, port=port, status=sess.page.status,
                body=sess.page.body, header=sess.page.header, tls=tls,
            )
            verdicts = []
            names = []
            for m in op.matchers:
                if (m.part or "") in outputs:
                    # matcher over a named script's emulated output
                    # (part: alerts) — same oracle, output as content
                    mm = dataclasses.replace(m, part="body")
                    out_row = Response(
                        host=host, port=port, status=sess.page.status,
                        body=outputs[m.part].encode("utf-8", "replace"),
                    )
                    v = cpu_ref.match_matcher(mm, out_row)
                else:
                    mm = dataclasses.replace(
                        m, part=_PART_ALIAS.get(m.part or "", m.part)
                    )
                    v = cpu_ref.match_matcher(mm, row)
                v = bool(v) if v is not None else False
                verdicts.append(v)
                if v and m.name:
                    names.append(m.name)
            if op.matchers:
                ok = (
                    all(verdicts)
                    if op.matchers_condition == "and"
                    else any(verdicts)
                )
                if not ok:
                    continue
            elif not op.extractors:
                continue
            extractions: list = []
            for ex in op.extractors:
                if ex.part in outputs:
                    val = outputs[ex.part]
                    if ex.type == "kval":
                        # nuclei stores a named script's output under
                        # its name; kval over that part yields it
                        if any(
                            k.lower().replace("-", "_")
                            == ex.part.lower().replace("-", "_")
                            for k in ex.kval
                        ):
                            extractions.append(val)
                    elif ex.type == "regex":
                        for pat in ex.regex:
                            try:
                                extractions.extend(
                                    mo.group(ex.group)
                                    for mo in re.finditer(pat, val)
                                )
                            except (re.error, IndexError):
                                continue  # RE2-only syntax / bad group
                    continue
                extractions.extend(cpu_ref.extract_one(ex, row))
            if op.matchers or extractions:
                return HeadlessHit(
                    host=host, port=port, template_id=t.id,
                    extractions=extractions, tls=tls,
                    matcher_names=names,
                )
        return None
