"""nuclei-template YAML → :mod:`swarm_tpu_torch.fingerprints.model`.

Covers the template surface measured in the reference corpus
(the reference's ``worker/artifacts/templates``, SURVEY.md §2.3):
``requests`` (http), ``network``, ``dns``, ``file``, ``ssl``,
``headless`` blocks; word/regex/status/size/binary/dsl/kval/json/xpath
matchers with parts, and/or conditions, negation, case-insensitivity,
named matchers; regex/kval extractors; ``workflows`` templates are
loaded with their raw chain kept in ``Template.extra``.
"""

from __future__ import annotations

import binascii
from pathlib import Path
from typing import Any, Iterable, Optional

from swarm_tpu_torch.fingerprints.model import (
    Extractor,
    Matcher,
    Operation,
    Template,
)


class TemplateParseError(ValueError):
    pass


def _as_list(value: Any) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _parse_matcher(raw: dict) -> Matcher:
    mtype = raw.get("type")
    if mtype not in (
        "word", "regex", "status", "size", "binary", "dsl", "kval", "json", "xpath",
    ):
        raise TemplateParseError(f"unknown matcher type: {mtype!r}")
    m = Matcher(
        type=mtype,
        part=str(raw.get("part", "body")),
        words=[str(w) for w in _as_list(raw.get("words"))],
        regex=[str(r) for r in _as_list(raw.get("regex"))],
        status=[int(s) for s in _as_list(raw.get("status"))],
        size=[int(s) for s in _as_list(raw.get("size"))],
        binary=[str(b) for b in _as_list(raw.get("binary"))],
        dsl=[str(d) for d in _as_list(raw.get("dsl"))],
        kval=[str(k) for k in _as_list(raw.get("kval"))],
        condition=str(raw.get("condition", "or")),
        negative=bool(raw.get("negative", False)),
        case_insensitive=bool(raw.get("case-insensitive", False)),
        name=raw.get("name"),
    )
    return m


def _parse_extractor(raw: dict) -> Extractor:
    return Extractor(
        type=str(raw.get("type", "regex")),
        part=str(raw.get("part", "body")),
        name=raw.get("name"),
        regex=[str(r) for r in _as_list(raw.get("regex"))],
        kval=[str(k) for k in _as_list(raw.get("kval"))],
        json=[str(j) for j in _as_list(raw.get("json"))],
        xpath=[str(x) for x in _as_list(raw.get("xpath"))],
        attribute=raw.get("attribute"),
        group=int(raw.get("group", 0)),
        internal=bool(raw.get("internal", False)),
    )


def _network_input_bytes(entry: dict) -> Optional[bytes]:
    data = entry.get("data")
    if data is None:
        return None
    text = str(data)
    if entry.get("type") == "hex":
        try:
            return binascii.unhexlify(text.strip())
        except (binascii.Error, ValueError):
            return text.encode("utf-8", "surrogateescape")
    return text.encode("utf-8", "surrogateescape")


def _parse_operation(raw: dict, protocol: str) -> Operation:
    op = Operation(
        matchers=[_parse_matcher(m) for m in _as_list(raw.get("matchers"))],
        matchers_condition=str(raw.get("matchers-condition", "or")),
        extractors=[_parse_extractor(e) for e in _as_list(raw.get("extractors"))],
        method=raw.get("method"),
        paths=[str(p) for p in _as_list(raw.get("path"))],
        raw=[str(r) for r in _as_list(raw.get("raw"))],
        headers=(
            [(str(k), str(v)) for k, v in raw["headers"].items()]
            if isinstance(raw.get("headers"), dict)
            else []
        ),
        body=str(raw.get("body") or ""),
        payloads=raw.get("payloads") or {},
        attack=str(raw.get("attack") or "batteringram"),
        hosts=[str(h) for h in _as_list(raw.get("host"))],
        redirects=bool(raw.get("redirects", False)),
        max_redirects=int(raw.get("max-redirects", 0)),
    )
    if protocol == "ssl":
        # (the corpus's ``address`` field is always the default
        # "{{Host}}:{{Port}}" — the scanner dials the input target)
        op.ssl_min_version = str(raw.get("min_version") or "").lower()
        op.ssl_max_version = str(raw.get("max_version") or "").lower()
    if protocol == "file":
        op.extensions = [
            str(e).lower().lstrip(".") for e in _as_list(raw.get("extensions"))
        ]
    if protocol == "dns":
        op.dns_type = str(raw.get("type") or "A").upper()
        op.dns_name = str(raw.get("name") or "{{FQDN}}")
    if protocol == "headless":
        op.steps = [s for s in _as_list(raw.get("steps")) if isinstance(s, dict)]
    if protocol == "network":
        for entry in _as_list(raw.get("inputs")):
            if isinstance(entry, dict):
                data = _network_input_bytes(entry)
                if data is not None:
                    op.inputs.append(data)
                if entry.get("read"):
                    op.read_size = int(entry["read"])
        if raw.get("read-size"):
            op.read_size = int(raw["read-size"])
    return op


_PROTOCOL_KEYS = (
    ("requests", "http"),
    ("http", "http"),
    ("network", "network"),
    ("tcp", "network"),
    ("dns", "dns"),
    ("file", "file"),
    ("ssl", "ssl"),
    ("headless", "headless"),
    ("workflows", "workflow"),
)


def parse_template(
    doc: dict, source_path: Optional[str] = None
) -> Template:
    if not isinstance(doc, dict) or "id" not in doc:
        raise TemplateParseError(f"not a template document: {source_path}")
    info = doc.get("info") or {}
    tags = info.get("tags", "")
    if isinstance(tags, str):
        tags = [t.strip() for t in tags.split(",") if t.strip()]

    protocol = None
    operations: list[Operation] = []
    extra: dict[str, Any] = {}
    for key, proto in _PROTOCOL_KEYS:
        block = doc.get(key)
        if not block:
            continue
        protocol = protocol or proto
        if proto == "workflow":
            extra["workflows"] = block
            continue
        for entry in _as_list(block):
            if isinstance(entry, dict):
                operations.append(_parse_operation(entry, proto))
    if protocol is None:
        raise TemplateParseError(f"template {doc.get('id')!r} has no protocol block")

    return Template(
        id=str(doc["id"]),
        protocol=protocol,
        severity=str(info.get("severity", "info")),
        name=info.get("name"),
        tags=tags,
        operations=operations,
        source_path=source_path,
        extra=extra,
    )


def load_template_file(path: str | Path) -> Template:
    import yaml

    p = Path(path)
    doc = yaml.safe_load(p.read_text(encoding="utf-8", errors="replace"))
    return parse_template(doc, source_path=str(p))


def load_corpus(
    root: str | Path,
    protocols: Optional[set[str]] = None,
    limit: Optional[int] = None,
    strict: bool = False,
) -> tuple[list[Template], list[tuple[str, str]]]:
    """Load every ``*.yaml`` template under ``root``.

    Returns ``(templates, errors)`` where errors is a list of
    ``(path, message)`` for files that failed to parse (the reference
    corpus has a handful of helper YAMLs that are not templates).
    """
    import yaml

    root = Path(root)
    templates: list[Template] = []
    errors: list[tuple[str, str]] = []
    paths: Iterable[Path] = sorted(root.rglob("*.yaml"))
    for p in paths:
        if limit is not None and len(templates) >= limit:
            break
        # Skip corpus helper data (wordlists/payloads), not templates.
        rel = p.relative_to(root).as_posix()
        if rel.startswith("helpers/"):
            continue
        try:
            t = load_template_file(p)
        except TemplateParseError as e:
            errors.append((str(p), str(e)))
            continue
        except yaml.YAMLError as e:
            errors.append((str(p), f"yaml: {e}"))
            continue
        except Exception as e:  # corrupt file in a 4k-file corpus: record, move on
            if strict:
                raise
            errors.append((str(p), f"{type(e).__name__}: {e}"))
            continue
        if protocols is None or t.protocol in protocols:
            templates.append(t)
    return templates, errors
