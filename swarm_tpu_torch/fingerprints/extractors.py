"""Host-side extractor evaluation: kval, json (jq-lite), xpath.

The corpus uses four extractor types (measured: regex 581, kval 44,
json 16, xpath 7 — SURVEY.md §2.3); regex lives in ops/cpu_ref.py next
to the matcher loop, the structured three live here:

- ``kval``: response-header value by key, dashes normalized to
  underscores (same normalization the kval *matcher* uses).
- ``json``: jq-style dotted paths (``.a.b[0].c``) over the decoded
  body — the corpus only uses simple paths (``.baseUrl``,
  ``.gitVersion``), so this evaluates the dotted/indexed subset and
  emits scalars as text, composites as compact JSON.
- ``xpath``: absolute element paths with 1-based positional predicates
  (``/html/body/div[1]/form/input[2]``) against a lenient HTML parse;
  ``attribute:`` selects an attribute value, otherwise element text.
  All seven corpus uses are ``attribute: value`` form-input grabs.
"""

from __future__ import annotations

import json as jsonlib
import re
from html.parser import HTMLParser
from typing import Any, Optional
from xml.etree import ElementTree as ET

from swarm_tpu_torch.fingerprints.model import Extractor, Response

# ---------------------------------------------------------------------------
# kval


def parse_header_blob(header_blob: bytes) -> dict[str, str]:
    """Header normalization shared by the kval matcher and extractor:
    keys lowered with dashes → underscores, last value wins."""
    headers: dict[str, str] = {}
    for line in header_blob.split(b"\r\n"):
        if b":" in line:
            k, _, v = line.partition(b":")
            key = k.strip().decode("latin-1").lower().replace("-", "_")
            headers[key] = v.strip().decode("latin-1")
    return headers


def headers_of(response: Response) -> dict[str, str]:
    return parse_header_blob(response.part("header"))


def extract_kval(ex: Extractor, response: Response) -> list[str]:
    headers = headers_of(response)
    out = []
    for key in ex.kval:
        norm = key.lower().replace("-", "_")
        if norm == "interactsh_ip":
            # OOB pseudo-kval: "print the remote interaction IP"
            # (vulnerabilities/other/*-log4j-rce.yaml extractors)
            out.extend(response.oob_ips)
            continue
        val = headers.get(norm)
        if val is not None:
            out.append(val)
    return out


# ---------------------------------------------------------------------------
# json (jq-lite)

_SEG_RE = re.compile(r"\.([A-Za-z0-9_\-$]+)|\[(\d+)?\]")


def jq_path(expr: str, doc: Any) -> Optional[Any]:
    """Evaluate a dotted/indexed jq path; None when it doesn't resolve."""
    expr = expr.strip()
    if not expr.startswith("."):
        return None
    pos = 0
    node = doc
    while pos < len(expr):
        m = _SEG_RE.match(expr, pos)
        if m is None:
            return None  # unsupported jq syntax (pipes, functions, …)
        pos = m.end()
        if m.group(1) is not None:
            if not isinstance(node, dict) or m.group(1) not in node:
                return None
            node = node[m.group(1)]
        elif m.group(2) is not None:
            idx = int(m.group(2))
            if not isinstance(node, list) or idx >= len(node):
                return None
            node = node[idx]
        else:
            # ``[]`` — jq iterate-all; supported in trailing position
            # (corpus use: ssl templates' ``.dns_names[]``). The list
            # itself is returned; extract_json flattens it per element.
            if not isinstance(node, list) or pos < len(expr):
                return None
    return node


def extract_json(ex: Extractor, response: Response) -> list[str]:
    try:
        doc = jsonlib.loads(response.part(ex.part).decode("utf-8", "replace"))
    except ValueError:
        return []
    out = []
    for expr in ex.json:
        val = jq_path(expr, doc)
        if val is None:
            continue
        if isinstance(val, list) and expr.rstrip().endswith("[]"):
            # iterate-all path: one output per element (jq streaming)
            out.extend(
                v if isinstance(v, str)
                else jsonlib.dumps(v, separators=(",", ":"))
                for v in val
            )
        elif isinstance(val, str):
            out.append(val)
        else:
            out.append(jsonlib.dumps(val, separators=(",", ":")))
    return out


# ---------------------------------------------------------------------------
# xpath over lenient HTML

_VOID = frozenset(
    "area base br col embed hr img input link meta param source track wbr".split()
)


class _TreeBuilder(HTMLParser):
    """Tolerant HTML → ElementTree: unclosed tags close at parent close."""

    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.root = ET.Element("__doc__")
        self.stack = [self.root]

    def handle_starttag(self, tag: str, attrs) -> None:
        el = ET.SubElement(self.stack[-1], tag, {k: (v or "") for k, v in attrs})
        if tag not in _VOID:
            self.stack.append(el)

    def handle_startendtag(self, tag: str, attrs) -> None:
        ET.SubElement(self.stack[-1], tag, {k: (v or "") for k, v in attrs})

    def handle_endtag(self, tag: str) -> None:
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag:
                del self.stack[i:]
                return
        # stray close tag: ignore

    def handle_data(self, data: str) -> None:
        el = self.stack[-1]
        if len(el):
            last = el[-1]
            last.tail = (last.tail or "") + data
        else:
            el.text = (el.text or "") + data


def parse_html(text: str) -> Optional[ET.Element]:
    try:
        builder = _TreeBuilder()
        builder.feed(text)
        builder.close()
        return builder.root
    except Exception:
        return None


_XSEG_RE = re.compile(r"^([A-Za-z0-9_\-:*]+)(?:\[(\d+)\])?$")


def xpath_nodes(root: ET.Element, path: str) -> list[ET.Element]:
    """Absolute-path subset: /tag[i]/tag/... (1-based predicate)."""
    segs = [s for s in path.strip().split("/") if s]
    nodes = [root]
    for seg in segs:
        m = _XSEG_RE.match(seg)
        if m is None:
            return []
        tag, idx = m.group(1), m.group(2)
        nxt: list[ET.Element] = []
        for node in nodes:
            kids = [c for c in node if tag in ("*", c.tag)]
            if idx is not None:
                i = int(idx) - 1
                if 0 <= i < len(kids):
                    nxt.append(kids[i])
            else:
                nxt.extend(kids)
        nodes = nxt
        if not nodes:
            return []
    return nodes


def extract_xpath(ex: Extractor, response: Response) -> list[str]:
    root = parse_html(response.part(ex.part).decode("utf-8", "replace"))
    if root is None:
        return []
    out = []
    for path in ex.xpath:
        for node in xpath_nodes(root, path):
            if ex.attribute:
                val = node.get(ex.attribute)
                if val is not None:
                    out.append(val)
            else:
                out.append("".join(node.itertext()))
    return out


def extract_structured(ex: Extractor, response: Response) -> list[str]:
    """Dispatch for the non-regex extractor types ([] for unknown)."""
    if ex.type == "kval":
        return extract_kval(ex, response)
    if ex.type == "json":
        return extract_json(ex, response)
    if ex.type == "xpath":
        return extract_xpath(ex, response)
    return []
