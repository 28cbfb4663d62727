"""Classification of headless templates — the part of
``swarm_tpu/worker/headless.py`` the ``active`` backend needs without
the browserless executor.

nuclei's headless protocol drives a real Chrome over CDP. The reference
executes a JS-free subset of those templates without a browser
(navigation, xpath form steps, DOM attribute-collection scripts, the
API-instrumentation hooks, library version checks, screenshots nothing
reads) and reports the rest as ``[headless-skipped]``. :func:`classify`
draws that line: None for a template the subset executes, else the
reason it cannot.

The executor (``HeadlessScanner``, its pool and the page emulation) is
not ported yet, so the port's ``ActiveScanner`` refuses a corpus with a
template :func:`classify` finds runnable, and reports the others as the
reference does.
"""

from __future__ import annotations

import re
from typing import Optional

from swarm_tpu_torch.fingerprints.model import Template

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
