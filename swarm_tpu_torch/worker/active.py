"""Active template-request scanning — the nuclei execution mode (a copy
of ``swarm_tpu/worker/active.py``; the responses match on the worker's
torch device through the port's ``MatchEngine``).

The reference's nuclei engine issues each template's *own* HTTP requests
(custom paths, methods, headers, bodies) and matches responses
per-request (`worker/modules/nuclei.json` runs it over the full corpus).
This module is the device-batched equivalent:

1. **Plan** (host, once per corpus): every http operation's requests are
   compiled and deduplicated into a flat request table — measured on the
   corpus: 2,816 simple-GET templates collapse onto ~3.2k distinct
   paths, 559 of them sharing bare ``{{BaseURL}}`` (SURVEY.md §2.3).
   Standard methods, payload fan-outs, and fully-resolvable ``raw``
   requests plan as batch work; extractor-chain and req-condition
   templates route to stateful per-target sessions
   (worker/sessions.py); the remaining skip classes are counted
   honestly (oob-interactsh / requires-var / external-target).
2. **Probe** (native I/O): the (target × request) fan-out runs in waves
   through the epoll front-end — the same massive concurrency nuclei
   gets from its internal scheduler, but as flat batches.
3. **Match** (device): every response row goes through the one compiled
   corpus DB in big vmap batches — no per-template dispatch.
4. **Attribute** (host): a row's hits only count for templates that own
   the row's request — nuclei's "matchers see their own request's
   response" semantics; a template fires on a target if any of its
   requests' rows fired.
"""

from __future__ import annotations

import dataclasses
import re
import secrets
from typing import Optional, Sequence

import numpy as np

from swarm_tpu_torch.fingerprints import dslc
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.native import scanio
from swarm_tpu_torch.worker.executor import (
    ProbeExecutor,
    is_ip,
    parse_http_response,
    use_tls,
)

_PLACEHOLDER_RE = re.compile(r"\{\{([^{}]+)\}\}")

# one deterministic-per-process random token: nuclei uses {{randstr}} to
# provoke 404s that are distinguishable from real content
_RANDSTR = "swarm" + secrets.token_hex(8)


@dataclasses.dataclass(frozen=True)
class PlannedRequest:
    method: str
    path: str  # begins with '/', placeholders already substituted
    headers: tuple[tuple[str, str], ...] = ()
    body: bytes = b""

    @property
    def uses_oob(self) -> bool:
        """Whether wiring this request needs a minted interaction URL."""
        return (
            "\x00OOB\x00" in self.path
            or b"\x00OOB\x00" in self.body
            or any("\x00OOB\x00" in v for _k, v in self.headers)
        )

    def wire(
        self, host: str, port: int, tls: bool = False,
        oob_url: Optional[str] = None,
    ) -> bytes:
        host_hdr = _host_hdr(host, port, tls)
        body = _finalize(
            self.body.decode("latin-1"), host, port, tls, oob_url
        ).encode("latin-1")
        lines = [
            f"{self.method} {_finalize(self.path, host, port, tls, oob_url)} HTTP/1.1",
            f"Host: {host_hdr}",
        ]
        has = {k.lower() for k, _ in self.headers}
        for k, v in self.headers:
            if k.lower() not in ("host", "connection", "content-length"):
                lines.append(f"{k}: {_finalize(v, host, port, tls, oob_url)}")
        if "user-agent" not in has:
            lines.append("User-Agent: swarm-tpu/1.0")
        if body:
            lines.append(f"Content-Length: {len(body)}")
        lines.append("Connection: close")
        raw = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1", "replace")
        return raw + body


@dataclasses.dataclass(frozen=True)
class NetRequest:
    """One network-protocol probe: raw bytes to a template-declared port.

    ``port`` 0 = the target's own port (a bare ``{{Hostname}}`` host
    entry); ``tls`` = the ``tls://`` host-entry prefix."""

    port: int
    payload: bytes
    tls: bool = False


@dataclasses.dataclass
class RequestPlan:
    requests: list[PlannedRequest]
    owners: list[set[int]]  # request idx -> template indices
    skipped: dict[str, list[str]]  # reason -> template ids
    planned_templates: set[int]  # template indices with ≥1 request
    # templates that RAN but with a truncated payload set (cap hit with
    # values actually dropped) — distinct from skipped: these produced
    # requests, just not the whole wordlist/product
    payload_truncated: list[str] = dataclasses.field(default_factory=list)
    net_requests: list[NetRequest] = dataclasses.field(default_factory=list)
    net_owners: list[set[int]] = dataclasses.field(default_factory=list)
    # dns protocol: record types to query, each owned by its templates
    dns_qtypes: list[str] = dataclasses.field(default_factory=list)
    dns_owners: list[set[int]] = dataclasses.field(default_factory=list)


def _substitute(
    text: str,
    payload_vars: Optional[dict] = None,
    oob: bool = False,
) -> Optional[str]:
    """Resolve standard nuclei placeholders to plan-time markers; None
    if any unknown placeholder remains. Markers are resolved per target
    in ``_finalize`` — the plan itself stays target-free.

    With ``payload_vars`` set (payload-attack expansion), bare variable
    placeholders take the combo's value and expression placeholders
    ({{base64('user:' + token)}}) are evaluated through the dsl
    engine with the combo as the environment.

    With ``oob`` (an interaction listener is running — worker/oob.py),
    ``{{interactsh-url}}`` resolves to a marker that the wire layer
    replaces with a freshly minted per-probe correlation URL; without
    it the placeholder stays unresolved and the template keeps its
    honest oob-interactsh skip class."""

    def repl(m: re.Match) -> str:
        name = m.group(1).strip()
        low = name.lower()
        if payload_vars is not None:
            if name in payload_vars:
                return str(payload_vars[name])
            ast = dslc.try_parse(name)
            if ast is not None and ast[0] != "var":
                try:
                    v = dslc.evaluate(ast, dict(payload_vars))
                    return v.decode("latin-1") if isinstance(v, bytes) else str(v)
                except Exception:
                    pass  # unknown fn/var → fall through to builtins
        if low in ("baseurl", "rooturl"):
            return "\x00BASE\x00"  # stripped later; plan paths are host-free
        if low == "hostname":
            return "\x00HOSTPORT\x00"
        if low == "host":
            return "\x00HOST\x00"
        if low == "port":
            return "\x00PORT\x00"
        if low == "path":
            return "/"
        if low == "scheme":
            return "\x00SCHEME\x00"
        if low.startswith("randstr") or low.startswith("rand_"):
            return _RANDSTR
        if oob and low == "interactsh-url":
            return "\x00OOB\x00"
        return m.group(0)  # unknown → leave; caller rejects

    out = _PLACEHOLDER_RE.sub(repl, text)
    if _PLACEHOLDER_RE.search(out):
        return None
    return out


def _host_hdr(host: str, port: int, tls: bool) -> str:
    """host[:port], omitting the port only when it is the scheme default."""
    default = 443 if tls else 80
    return host if port == default else f"{host}:{port}"


def _finalize(
    text: str, host: str, port: int, tls: bool,
    oob_url: Optional[str] = None,
) -> str:
    """Per-target resolution of the plan-time markers with the probe's
    actual scheme/port (not defaults). An *interior* BaseURL/RootURL
    (query params, bodies, headers) becomes the absolute URL; a path's
    leading BaseURL was already stripped at plan time. ``oob_url`` is
    this probe's minted correlation URL (worker/oob.py)."""
    scheme = "https" if tls else "http"
    hdr = _host_hdr(host, port, tls)
    out = (
        text.replace("\x00BASE\x00", f"{scheme}://{hdr}")
        .replace("\x00HOSTPORT\x00", hdr)
        .replace("\x00HOST\x00", host)
        .replace("\x00PORT\x00", str(port))
        .replace("\x00SCHEME\x00", scheme)
    )
    if oob_url is not None:
        out = out.replace("\x00OOB\x00", oob_url)
    return out


# payload fan-out bounds. nuclei walks wordlists in full (the corpus
# drives the 89,810-line helpers/wordlists/wordpress-plugins.txt —
# SURVEY §2.3), so the defaults now cover that scale; the env knobs
# let an operator bound per-job work instead. Hitting either bound is
# surfaced in plan stats (payload_truncated) — never a silent cap.
import os as _os

MAX_PAYLOAD_VALUES = int(
    _os.environ.get("SWARM_MAX_PAYLOAD_VALUES", "100000")
)
MAX_PAYLOAD_COMBOS = int(
    _os.environ.get("SWARM_MAX_PAYLOAD_COMBOS", "100000")
)


def _payload_values(
    spec, template_path: Optional[str]
) -> "tuple[Optional[list[str]], bool]":
    """One payload variable's (value list, truncated); file refs resolve
    against the template's ancestors (the corpus root holds
    helpers/wordlists). ``truncated`` is True only when values were
    actually dropped at the MAX_PAYLOAD_VALUES cap."""
    if isinstance(spec, list):
        vals = [str(v) for v in spec[:MAX_PAYLOAD_VALUES]]
        return vals, len(spec) > len(vals)
    if not isinstance(spec, str):
        return None, False
    import pathlib

    cand: list[pathlib.Path] = []
    if template_path:
        for parent in pathlib.Path(template_path).parents:
            cand.append(parent / spec)
    for path in cand:
        try:
            if path.is_file():
                out = []
                truncated = False
                with open(path, "r", encoding="utf-8", errors="replace") as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if len(out) >= MAX_PAYLOAD_VALUES:
                            if line:
                                truncated = True  # a value WAS dropped
                                break
                            continue
                        if line:
                            out.append(line)
                return out, truncated
        except OSError:
            continue
    return None, False


def _payload_combos(
    op, template_path: Optional[str]
) -> tuple[Optional[list[dict]], bool]:
    """Attack-mode expansion → (bounded list of var→value dicts,
    truncated) — truncated is True only when combos were actually
    dropped, so an exactly-cap-sized product isn't misreported.

    batteringram: one shared value stream; pitchfork: zip the lists;
    clusterbomb: cartesian product (capped)."""
    lists: dict[str, list[str]] = {}
    values_truncated = False
    for var, spec in op.payloads.items():
        vals, v_trunc = _payload_values(spec, template_path)
        if vals is None or not vals:
            return None, False
        values_truncated = values_truncated or v_trunc
        lists[str(var)] = vals
    if not lists:
        return [], False
    mode = (op.attack or "batteringram").lower()
    names = list(lists)
    combos: list[dict] = []
    if mode == "clusterbomb" and len(names) > 1:
        import itertools

        total = 1
        for n in names:
            total *= len(lists[n])
        for values in itertools.product(*(lists[n] for n in names)):
            combos.append(dict(zip(names, values)))
            if len(combos) >= MAX_PAYLOAD_COMBOS:
                break
    elif mode == "pitchfork" and len(names) > 1:
        total = min(len(lists[n]) for n in names)
        for values in zip(*(lists[n] for n in names)):
            combos.append(dict(zip(names, values)))
            if len(combos) >= MAX_PAYLOAD_COMBOS:
                break
    else:
        # batteringram (or single-var): one value stream, every var
        # takes the same value (nuclei's batteringram semantics)
        total = len(lists[names[0]])
        for v in lists[names[0]]:
            combos.append({n: v for n in names})
            if len(combos) >= MAX_PAYLOAD_COMBOS:
                break
    # either bound counts: values dropped at the per-variable cap are
    # as truncated as combos dropped at the product cap
    return combos, values_truncated or total > len(combos)


_INDEXED_VAR_RE = re.compile(
    r"\b(?:body|header|all_headers|status_code|response|raw|duration)_\d+\b"
)


def _uses_indexed_vars(t: Template) -> bool:
    """True when any matcher/extractor references per-step history vars
    (the req-condition idiom) — cross-request evaluation state. Indexed
    references appear both in dsl expressions and as matcher/extractor
    ``part`` names (e.g. ``part: body_2``,
    misconfiguration/google/insecure-firebase-database.yaml)."""
    for op in t.operations:
        for m in op.matchers:
            if _INDEXED_VAR_RE.search(m.part or ""):
                return True
            for expr in m.dsl:
                if _INDEXED_VAR_RE.search(expr):
                    return True
        for ex in op.extractors:
            if _INDEXED_VAR_RE.search(ex.part or ""):
                return True
    return False


def _parse_raw(raw: str) -> Optional[PlannedRequest]:
    """One raw HTTP request text → PlannedRequest (None = unsupported)."""
    raw = raw.replace("\r\n", "\n").strip("\n")
    if "\n\n" in raw:
        head, _, body = raw.partition("\n\n")
    else:
        head, body = raw, ""
    lines = head.split("\n")
    first = lines[0].split()
    if len(first) < 2:
        return None
    method, path = first[0].upper(), first[1]
    if not path.startswith("/"):
        if path.startswith("\x00BASE\x00"):
            path = path[len("\x00BASE\x00"):] or "/"
        elif path.startswith(("http://", "https://")):
            # absolute-URL raws target other hosts — out of scope
            return None
        # else: verbatim request-target (nuclei sends raws as written —
        # e.g. CVE-2018-16133's backslash path-traversal probe)
    headers = []
    for line in lines[1:]:
        if ":" not in line:
            return None
        k, _, v = line.partition(":")
        if k.strip().lower() == "host":
            continue  # rebuilt per target
        headers.append((k.strip(), v.strip()))
    return PlannedRequest(
        method=method,
        path=path,
        headers=tuple(headers),
        body=body.encode("latin-1", "replace"),
    )


def _ast_var_names(ast) -> set:
    """Variable names referenced anywhere in a parsed dsl expression."""
    names: set = set()

    def walk(node):
        if not isinstance(node, tuple):
            return
        if node[0] == "var":
            names.add(node[1])
        for part in node:
            if isinstance(part, tuple):
                walk(part)
            elif isinstance(part, list):
                for sub in part:
                    walk(sub)

    walk(ast)
    return names


def _unresolved_names(t: Template) -> set:
    """Placeholder names in the template's request text that the plain
    substitution layer cannot resolve."""
    out: set = set()
    for op in t.operations:
        texts = list(op.paths) + list(op.raw) + [op.body or ""]
        texts += [v for _k, v in op.headers]
        for text in texts:
            for m in _PLACEHOLDER_RE.finditer(text):
                name = m.group(1).strip()
                if _substitute("{{" + name + "}}") is None:
                    out.add(name)
    return out


def _classify_dynamic(t: Template, user_vars: Optional[dict] = None) -> str:
    """Honest skip bucket for a template with unresolved placeholders:

    - ``oob-interactsh`` — needs an out-of-band interaction server
      (already surfaced per-template in scan output);
    - ``extractor-chain`` — every unresolved value comes from the
      template's own (internal) extractors/payloads: a per-target
      session could execute it;
    - ``requires-var`` — needs operator-supplied values (nuclei's
      ``-var``; the token-spray class). Supply via the active module's
      ``"vars"`` object.
    """
    if _uses_oob(t):
        return "oob-interactsh"
    sources: set = set(user_vars or ())
    for op in t.operations:
        sources |= {ex.name for ex in op.extractors if ex.name}
        sources |= set(op.payloads.keys())
    unresolved = _unresolved_names(t)

    def covered(name: str) -> bool:
        if name in sources:
            return True
        ast = dslc.try_parse(name)
        if ast is None:
            return False
        refs = _ast_var_names(ast)
        return bool(refs) and refs <= sources

    if unresolved and all(covered(n) for n in unresolved):
        return "extractor-chain"
    return "requires-var"


def build_plan(
    templates: Sequence[Template],
    user_vars: Optional[dict] = None,
    oob: bool = False,
) -> RequestPlan:
    """Corpus → deduplicated request table + ownership map.

    ``user_vars`` are operator-supplied template variables (nuclei's
    ``-var token=…``), substituted wherever payload values would be —
    they unlock the requires-var class (API token-spray templates
    etc.) when the operator provides credentials."""
    dedup: dict[PlannedRequest, int] = {}
    owners: list[set[int]] = []
    skipped: dict[str, list[str]] = {}
    planned: set[int] = set()
    payload_truncated: list[str] = []

    current_added: list[list[int]] = [[]]  # per-template http indices

    def add(req: PlannedRequest, t_idx: int) -> None:
        idx = dedup.get(req)
        if idx is None:
            idx = dedup[req] = len(owners)
            owners.append(set())
        owners[idx].add(t_idx)
        current_added[0].append(idx)
        planned.add(t_idx)

    def skip(reason: str, t: Template) -> None:
        skipped.setdefault(reason, []).append(t.id)

    net_dedup: dict[NetRequest, int] = {}
    dns_qtype_idx: dict[str, int] = {}
    dns_qtypes_list: list[str] = []
    dns_owners_list: list[set[int]] = []

    def add_net(req: NetRequest, t_idx: int) -> None:
        idx = net_dedup.get(req)
        if idx is None:
            idx = net_dedup[req] = len(net_owners_list)
            net_owners_list.append(set())
        net_owners_list[idx].add(t_idx)
        planned.add(t_idx)

    net_owners_list: list[set[int]] = []

    for t_idx, t in enumerate(templates):
        if t.protocol == "network":
            # hosts entries declare the port ("{{Host}}:873", optionally
            # "tls://" prefixed); a bare "{{Hostname}}" rides the
            # target's own port (planned as port 0, expanded per target
            # at probe time). Each operation carries its own
            # (ports, payload) pair (SURVEY.md §2.3: network templates
            # send inputs.data and match banners).
            any_entry = False
            for op in t.operations:
                entries: set[tuple[int, bool]] = set()  # (port, tls)
                for h in op.hosts:
                    tls = False
                    if "://" in h:
                        scheme, _, h = h.partition("://")
                        tls = scheme.lower() in ("tls", "ssl")
                    _, sep, port_s = h.rpartition(":")
                    if sep and port_s.isdigit():
                        entries.add((int(port_s), tls))
                    else:
                        entries.add((0, tls))  # target's own port
                if not entries:
                    continue
                any_entry = True
                payload = b"".join(op.inputs)
                for port, tls in sorted(entries):
                    add_net(
                        NetRequest(port=port, payload=payload, tls=tls), t_idx
                    )
            if not any_entry:
                skip("network-no-port", t)
            continue
        if t.protocol == "dns":
            # dns templates query one record type for the target name;
            # several templates share a query (4 CNAME templates → one
            # CNAME query per host)
            from swarm_tpu_torch.worker.dnsquery import QTYPES

            any_q = False
            for op in t.operations:
                qtype = op.dns_type or "A"
                if qtype not in QTYPES:
                    continue
                any_q = True
                if qtype in dns_qtype_idx:
                    dns_owners_list[dns_qtype_idx[qtype]].add(t_idx)
                else:
                    dns_qtype_idx[qtype] = len(dns_qtypes_list)
                    dns_qtypes_list.append(qtype)
                    dns_owners_list.append({t_idx})
                planned.add(t_idx)
            if not any_q:
                skip("dns-qtype", t)
            continue
        if t.protocol != "http":
            # file and ssl templates run under their dedicated modules
            # (worker/filescan.py, worker/sslscan.py — modules/file.json,
            # modules/ssl.json), not the batch planner; headless
            # templates in the browserless JS-free subset execute via
            # worker/headless.py (ActiveScanner removes them from this
            # skip list), the js-required rest keep the honest marker
            skip(f"protocol-{t.protocol}", t)
            continue
        ok = False
        unsupported: Optional[str] = None
        current_added[0] = []
        planned_matchers = False  # did any PLANNED op carry matchers?
        for op in t.operations:
            # payload attacks (default-logins, fuzzing, token-spray):
            # expand the bounded combo set and plan one request per
            # combo — every combo's response batch-matches on device
            # and any hit attributes to the template
            if op.payloads:
                combos, truncated = _payload_combos(op, t.source_path)
                if combos is None:
                    unsupported = "payload-values"
                    continue
                if truncated and t.id not in payload_truncated:
                    # cap hit with values dropped: surfaced, never
                    # silent — but the template still RUNS, so this is
                    # its own stats channel, not a skip
                    payload_truncated.append(t.id)
            else:
                combos = [None]
            if user_vars:
                # operator vars are the base layer; payload combos
                # override on collision (nuclei -var semantics)
                combos = [{**user_vars, **(c or {})} for c in combos]
            for payload_vars in combos:
                if op.raw:
                    # multi-request raws: nuclei evaluates matchers per
                    # response (OR across steps) unless they reference
                    # indexed history vars (body_2, status_code_1 … /
                    # req-condition) — those need cross-request state
                    # this engine doesn't model, so they stay skipped
                    # rather than silently never-matching.
                    if len(op.raw) > 1 and _uses_indexed_vars(t):
                        unsupported = "multi-step-condition"
                        continue
                    # all-or-nothing: a step a matcher depends on must
                    # not silently drop while its siblings plan
                    step_reqs = []
                    step_fail = None
                    for step in op.raw:
                        sub = _substitute(step, payload_vars, oob=oob)
                        if sub is None:
                            step_fail = "dynamic-values"
                            break
                        req = _parse_raw(sub)
                        if req is None:
                            # @Host:-annotated and absolute-URL raws
                            # address third-party hosts, not the target
                            step_fail = (
                                "external-target"
                                if "@Host:" in step
                                or sub.lstrip().split(None, 2)[1:2]
                                and sub.lstrip().split(None, 2)[1].startswith(
                                    ("http://", "https://")
                                )
                                else "raw-unparseable"
                            )
                            break
                        step_reqs.append(req)
                    if step_fail:
                        unsupported = step_fail
                        continue
                    for req in step_reqs:
                        add(req, t_idx)
                    ok = True
                    planned_matchers = planned_matchers or bool(op.matchers)
                    continue
                method = (op.method or "GET").upper()
                if method not in (
                    "GET", "POST", "PUT", "HEAD", "OPTIONS",
                    "DELETE", "PATCH", "PURGE", "TRACE",
                ):
                    unsupported = f"method-{method}"
                    continue
                body_t = _substitute(op.body or "", payload_vars, oob=oob)
                if body_t is None:
                    unsupported = "dynamic-values"
                    continue
                body = body_t.encode("latin-1", "replace")
                for path_t in op.paths:
                    sub = _substitute(path_t, payload_vars, oob=oob)
                    if sub is None:
                        unsupported = "dynamic-values"
                        continue
                    # strip only the *leading* BaseURL; interior
                    # occurrences resolve to absolute URLs at wire time
                    if sub.startswith("\x00BASE\x00"):
                        sub = sub[len("\x00BASE\x00"):]
                    elif sub.startswith(("http://", "https://")):
                        # token-spray-style templates request third-party
                        # API hosts, not the scanned target — out of
                        # scope here
                        unsupported = "external-target"
                        continue
                    path = sub or "/"
                    if not path.startswith("/"):
                        path = "/" + path
                    headers = []
                    header_ok = True
                    for k, v in op.headers:
                        hv = _substitute(v, payload_vars, oob=oob)
                        if hv is None:
                            header_ok = False  # e.g. "Bearer {{token}}"
                            break
                        headers.append((k, hv))
                    if not header_ok:
                        unsupported = "dynamic-values"
                        continue
                    add(
                        PlannedRequest(
                            method=method,
                            path=path,
                            headers=tuple(headers),
                            body=body,
                        ),
                        t_idx,
                    )
                    ok = True
                    planned_matchers = planned_matchers or bool(op.matchers)
        if ok and unsupported and not planned_matchers:
            # the planned subset carries no matchers while sibling
            # ops/steps failed — nothing planned can ever fire, so a
            # silent partial plan would hide the gap; retract and skip
            for idx in current_added[0]:
                owners[idx].discard(t_idx)
            planned.discard(t_idx)
            ok = False
        if not ok and unsupported:
            if unsupported == "dynamic-values":
                unsupported = _classify_dynamic(t, user_vars)
            skip(unsupported, t)

    # drop orphaned requests (a retracted partial template may leave a
    # dedup entry whose owner set emptied — probing it would be wasted
    # I/O with no possible attribution)
    requests_list = list(dedup)
    keep = [i for i, o in enumerate(owners) if o]
    return RequestPlan(
        requests=[requests_list[i] for i in keep],
        owners=[owners[i] for i in keep],
        skipped=skipped,
        planned_templates=planned,
        payload_truncated=payload_truncated,
        net_requests=list(net_dedup),
        net_owners=net_owners_list,
        dns_qtypes=dns_qtypes_list,
        dns_owners=dns_owners_list,
    )


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ActiveHit:
    host: str
    port: int
    template_id: str
    path: str
    extractions: list[str]
    tls: bool = False  # how the hit's request was actually probed
    # the response that fired the hit (internal: workflow named-matcher
    # gates re-confirm against it; never rendered into output)
    row: Optional[Response] = None
    # fired named matchers, when the producing engine knows them (ssl
    # hits have no Response row to re-confirm against)
    matcher_names: list[str] = dataclasses.field(default_factory=list)


def _uses_oob(t: Template) -> bool:
    """True when the template references out-of-band interaction
    (interactsh) anywhere — matcher parts, dsl expressions, or request
    text embedding ``{{interactsh-url}}``. Such templates cannot fully
    evaluate without an interaction callback server (scope-excluded;
    SURVEY §2.3: 144 interactsh matchers), and scan output must say so
    rather than silently not matching."""
    for op in t.operations:
        for m in op.matchers:
            if (m.part or "").startswith("interactsh"):
                return True
            if any("interactsh" in e for e in m.dsl):
                return True
        texts = list(op.paths) + list(op.raw) + [op.body or ""]
        texts += [v for _k, v in op.headers]
        texts += [str(v) for v in op.payloads.values()]
        for text in texts:
            if "interactsh" in text:
                return True
    return False


class ActiveScanner:
    """(targets × planned requests) → device-matched, request-attributed
    template hits. ``engine`` is a MatchEngine over the same corpus the
    plan was built from."""

    def __init__(
        self,
        engine,
        probe_spec: Optional[dict] = None,
        user_vars: Optional[dict] = None,
    ):
        self.engine = engine
        # OOB interaction listener (worker/oob.py): opt-in via the
        # module's probe spec — "oob": true (defaults) or a config
        # object {"advertise_host", "http_port", "dns_port", "domain",
        # "answer_ip", "poll_s"}. With it running, {{interactsh-url}}
        # templates plan and execute; without it they keep the honest
        # oob-skipped marker.
        spec0 = probe_spec or {}
        oob_spec = spec0.get("oob")
        self.oob_listener = None
        self.oob_poll_s = 3.0
        if oob_spec:
            from swarm_tpu_torch.worker.oob import shared_listener

            kw = dict(oob_spec) if isinstance(oob_spec, dict) else {}
            kw.pop("enabled", None)
            self.oob_poll_s = float(kw.pop("poll_s", 3.0))
            # process-shared: the runtime caches scanners for process
            # lifetime, so per-scanner listeners would leak sockets and
            # EADDRINUSE on fixed ports (worker/oob.py shared_listener)
            self.oob_listener = shared_listener(**kw)
        self.plan = build_plan(
            engine.templates,
            user_vars=user_vars,
            oob=self.oob_listener is not None,
        )
        # honest scope marker: these ids are emitted as oob-skipped in
        # scan output (runtime._execute_active) so "didn't match" and
        # "can't match without OOB" stay distinguishable in /raw. With
        # a listener running, only oob templates that STILL could not
        # plan (e.g. ones also needing session state) keep the marker.
        planned_ids = {
            engine.templates[i].id for i in self.plan.planned_templates
        }
        self.oob_limited = sorted(
            t.id
            for t in engine.templates
            if _uses_oob(t)
            and (self.oob_listener is None or t.id not in planned_ids)
        )
        # request indices that need a minted correlation URL at wire time
        self._oob_reqs = {
            i for i, r in enumerate(self.plan.requests) if r.uses_oob
        }
        # deferred rows awaiting the interaction poll window:
        # (row, meta, token) triples collected across waves
        self._pending_oob: list = []
        # session-class templates (extractor chains, indexed-history
        # raw flows) execute statefully per target instead of batching
        session_ids = set(
            self.plan.skipped.get("extractor-chain", [])
        ) | set(self.plan.skipped.get("multi-step-condition", []))
        self.session_scanner = None
        if session_ids:
            from swarm_tpu_torch.worker.sessions import SessionScanner

            self.session_scanner = SessionScanner(
                [t for t in engine.templates if t.id in session_ids],
                probe_spec=probe_spec,
                user_vars=user_vars,
            )
        # ssl-protocol templates run alongside the http corpus (nuclei
        # host-scan parity); their hits join the workflow hit set
        self.ssl_scanner = None
        self._ssl_ports: list[int] = []
        ssl_templates = [t for t in engine.templates if t.protocol == "ssl"]
        if ssl_templates:
            from swarm_tpu_torch.worker import sslscan

            spec0 = probe_spec or {}
            self.ssl_scanner = sslscan.SslScanner(
                ssl_templates,
                concurrency=int(spec0.get("concurrency", 32)),
                timeout=float(spec0.get("connect_timeout_ms", 4000)) / 1000.0,
            )
            # portless targets follow the module's port fan-out minus
            # known-plaintext ports; explicit ssl_ports wins verbatim;
            # nothing TLS-plausible configured → nuclei's default 443
            if "ssl_ports" in spec0:
                self._ssl_ports = [
                    int(p) for p in spec0["ssl_ports"]
                ] or [443]
            else:
                self._ssl_ports = [
                    int(p)
                    for p in spec0.get("ports", [443])
                    if int(p) not in sslscan.PLAINTEXT_PORTS
                ] or [443]
        # headless-protocol templates: the browserless JS-free subset
        # (worker/headless.py) executes per live target — form flows
        # and DOM attribute-collection scripts; js-required ones stay
        # in the skip list with the honest [headless-skipped] marker
        self.headless_scanner = None
        headless_templates = [
            t for t in engine.templates if t.protocol == "headless"
        ]
        if headless_templates:
            from swarm_tpu_torch.worker import headless as headlesslite

            runnable = [
                t for t in headless_templates
                if headlesslite.classify(t) is None
            ]
            if runnable:
                self.headless_scanner = headlesslite.HeadlessScanner(
                    runnable, probe_spec=probe_spec
                )
                runnable_ids = {t.id for t in runnable}
                kept = [
                    i
                    for i in self.plan.skipped.get("protocol-headless", [])
                    if i not in runnable_ids
                ]
                if kept:
                    self.plan.skipped["protocol-headless"] = kept
                else:
                    self.plan.skipped.pop("protocol-headless", None)
        # workflow templates gate which hits report (ops/workflows.py);
        # evaluation reuses this scanner's engine — no extra compile
        self.workflow_runner = None
        if any(t.protocol == "workflow" for t in engine.templates):
            from swarm_tpu_torch.ops.workflows import WorkflowRunner

            self.workflow_runner = WorkflowRunner(
                engine.templates, engine=engine
            )
        self.executor = ProbeExecutor(probe_spec)
        spec = self.executor.spec
        self.wave_rows = int(spec.get("wave_rows", 16384))
        # template index -> id, and per-request owner id sets, once
        self._tid = [t.id for t in engine.templates]
        self._owner_ids = [
            {self._tid[i] for i in owner} for owner in self.plan.owners
        ]
        self._net_owner_ids = [
            {self._tid[i] for i in owner} for owner in self.plan.net_owners
        ]
        self._dns_owner_ids = [
            {self._tid[i] for i in owner} for owner in self.plan.dns_owners
        ]

    def run(self, target_lines: Sequence[str]) -> tuple[list[ActiveHit], dict]:
        parsed, malformed = self.executor._parse_lines(target_lines)
        addr_of = self.executor._resolve_names(parsed)
        spec_ports = [
            int(p) for p in self.executor.spec["ports"] if 0 < int(p) < 65536
        ]
        targets: list[tuple[str, str, int, bool]] = []  # (host, ip, port, tls)
        dead = 0
        for host, explicit_port, _path, scheme in parsed:
            ip = host if is_ip(host) else next(iter(addr_of.get(host) or []), None)
            ports = [explicit_port] if explicit_port else spec_ports
            for port in ports:
                if ip is None:
                    dead += 1
                else:
                    targets.append((host, ip, port, use_tls(scheme, port)))

        hits: list[ActiveHit] = []
        stats = {
            "targets": len(targets),
            "dead_targets": dead,
            "malformed": len(malformed),
            "requests_planned": len(self.plan.requests),
            "rows_probed": 0,
            # session-handled classes aren't skips: the session pass
            # below executes them
            "skipped_templates": {
                k: len(v)
                for k, v in self.plan.skipped.items()
                if self.session_scanner is None
                or k not in ("extractor-chain", "multi-step-condition")
            },
            "oob_limited": len(self.oob_limited),
            "payload_truncated": len(self.plan.payload_truncated),
        }
        plan_has_work = (
            self.plan.requests
            or self.plan.net_requests
            or self.plan.dns_qtypes
            or self.session_scanner is not None
            or self.ssl_scanner is not None
            or self.headless_scanner is not None
        )
        if not targets or not plan_has_work:
            return hits, stats

        # liveness pre-pass: one connect per target; only live targets
        # fan out over the full request table (and over sessions)
        need_live = (
            bool(self.plan.requests)
            or self.session_scanner is not None
            or self.headless_scanner is not None
        )
        live = self._liveness(targets) if need_live else []
        stats["live_targets"] = len(live)

        # headless offload: launch the emulation round NOW so its
        # network I/O overlaps the device waves below (shared pool,
        # worker/headless.py); joined where its hits are consumed
        headless_fut = None
        if self.headless_scanner is not None and live:
            headless_fut = self.headless_scanner.run_async(live)

        # index-sliced waves: never materialize the full (target × request)
        # cross product — 10k live targets × 3.2k requests is 32M tuples
        nreq = len(self.plan.requests)
        total = len(live) * nreq
        for w0 in range(0, total, self.wave_rows):
            wave = [
                (*live[i // nreq], i % nreq)
                for i in range(w0, min(w0 + self.wave_rows, total))
            ]
            stats["rows_probed"] += len(wave)
            hits.extend(self._run_wave(wave))

        # network-protocol pass: template-declared ports on each host
        # (port-0 requests ride the target's own port)
        if self.plan.net_requests:
            net_hits, net_rows = self._run_network(targets)
            hits.extend(net_hits)
            stats["rows_probed"] += net_rows

        # dns-protocol pass: typed queries per distinct hostname
        if self.plan.dns_qtypes:
            dns_hits, dns_rows = self._run_dns(parsed, addr_of)
            hits.extend(dns_hits)
            stats["rows_probed"] += dns_rows

        # session pass: extractor-chain / multi-step-condition templates
        # run stateful per-target flows (worker/sessions.py) — against
        # the liveness-gated set only (dead hosts would each burn a
        # connect timeout per session template)
        if self.session_scanner is not None and live:
            session_hits = self.session_scanner.run(live)
            stats["session_templates"] = len(self.session_scanner.templates)
            stats["session_hits"] = len(session_hits)
            hits.extend(
                ActiveHit(
                    host=h.host, port=h.port, template_id=h.template_id,
                    path="", extractions=h.extractions, tls=h.tls,
                    # the final step's response stands in for workflow
                    # named-matcher gates on session templates
                    row=h.row if self.workflow_runner is not None else None,
                )
                for h in session_hits
            )

        # ssl-protocol pass: version-pinned handshakes + session/cert
        # document matchers (worker/sslscan.py); hits participate in
        # workflow gating below like any other protocol's
        if self.ssl_scanner is not None:
            ssl_findings, ssl_stats = self.ssl_scanner.scan(
                target_lines, default_ports=self._ssl_ports
            )
            stats["ssl_targets"] = ssl_stats["targets"]
            hits.extend(
                ActiveHit(
                    host=f.host, port=f.port, template_id=f.template_id,
                    path="", extractions=f.extractions, tls=True,
                    matcher_names=f.matcher_names,
                )
                for f in ssl_findings
            )

        # headless join: the round launched after liveness ran
        # overlapped with every device wave above
        if headless_fut is not None:
            h_hits = headless_fut.result()
            stats["headless_templates"] = len(
                self.headless_scanner.templates
            )
            stats["headless_hits"] = len(h_hits)
            hits.extend(
                ActiveHit(
                    host=h.host, port=h.port, template_id=h.template_id,
                    path="", extractions=h.extractions, tls=h.tls,
                    matcher_names=h.matcher_names,
                )
                for h in h_hits
            )

        # OOB drain: wait out the interaction window (a vulnerable
        # target's callback races our response read), attach each
        # token's interactions to its probe row, then device-match the
        # deferred rows in one batch like any other wave
        if self._pending_oob:
            import time as _time

            if self.oob_poll_s > 0:
                _time.sleep(self.oob_poll_s)
            rows, meta = [], []
            n_inter = 0
            for row, m, tok in self._pending_oob:
                inter = self.oob_listener.poll(tok)
                self.oob_listener.release(tok)
                if inter:
                    n_inter += len(inter)
                    row.oob_protocols = tuple(
                        sorted({i.protocol for i in inter})
                    )
                    row.oob_requests = b"\n\n".join(
                        i.raw_request for i in inter
                    )
                    row.oob_ips = tuple(
                        dict.fromkeys(i.remote_addr for i in inter)
                    )
                rows.append(row)
                meta.append(m)
            self._pending_oob = []
            stats["oob_probes"] = len(rows)
            stats["oob_interactions"] = n_inter
            hits.extend(self._attribute(rows, meta, self._owner_ids))

        # one line per finding: a template observed via several requests
        # on the same endpoint (e.g. {{Hostname}} + {{Host}}:<port> both
        # landing on one service) reports once, as nuclei does
        seen: set = set()
        unique: list[ActiveHit] = []
        for h in hits:
            key = (h.host, h.port, h.template_id, h.path)
            if key not in seen:
                seen.add(key)
                unique.append(h)

        # workflow pass: per-(host, port) gating — nuclei's workflow
        # unit is one input target, so trigger and subtemplates must
        # have matched the same service. Port-less protocol hits (dns:
        # port 0) describe the host, not a service, and join every
        # service group of their host.
        if self.workflow_runner is not None:
            stats["workflow_hits"] = 0
            groups: dict[tuple, dict] = {}
            hostwide: dict[str, list] = {}
            for h in unique:
                if h.port == 0:
                    hostwide.setdefault(h.host, []).append(h)
                else:
                    groups.setdefault((h.host, h.port), {}).setdefault(
                        h.template_id, []
                    ).append(h)
            for host, hs in hostwide.items():
                host_groups = [
                    g for (gh, _p), g in groups.items() if gh == host
                ] or [groups.setdefault((host, 0), {})]
                for g in host_groups:
                    for h in hs:
                        g.setdefault(h.template_id, []).append(h)
            wf_hits: list[ActiveHit] = []
            seen_wf: set = set()
            # batched gate re-confirm: every row-carrying hit of a
            # gate-queried template rides ONE engine batch through the
            # scheduler (QoS lanes, in-flight overlap, memo families)
            # instead of a serial per-row host confirm inside
            # evaluate_hits; recorded names (ssl) keep precedence
            gate_tids = self.workflow_runner.gate_template_ids
            needs: list = []
            where: list = []
            for gkey, hitmap in groups.items():
                for tid, hhs in hitmap.items():
                    if tid not in gate_tids or any(
                        hh.matcher_names for hh in hhs
                    ):
                        continue
                    for hh in hhs:
                        if hh.row is not None:
                            needs.append((tid, hh.row))
                            where.append((gkey, tid))
            resolved: dict[tuple, set] = {}
            if needs:
                for loc, names in zip(
                    where, self.workflow_runner.resolve_gate_names(needs)
                ):
                    resolved.setdefault(loc, set()).update(names)
            for (host, port), hitmap in groups.items():
                # ssl hits carry no Response row; their fired matcher
                # names were recorded by the ssl scanner itself
                known = {
                    tid: sorted(
                        {n for hh in hhs for n in hh.matcher_names}
                    )
                    for tid, hhs in hitmap.items()
                    if any(hh.matcher_names for hh in hhs)
                }
                for (gkey, tid), names in resolved.items():
                    if gkey == (host, port):
                        known[tid] = sorted(names)
                per = self.workflow_runner.evaluate_hits(
                    set(hitmap),
                    lambda tid, _m=hitmap: [
                        hh.row for hh in _m.get(tid, [])
                    ],
                    known_names=known,
                )
                for wid, sub_ids in sorted(per.items()):
                    # report at the matched subtemplate's service
                    anchor = next(
                        (hitmap[s][0] for s in sub_ids if s in hitmap),
                        next(iter(hitmap.values()))[0],
                    )
                    key = (host, anchor.port, wid, tuple(sorted(sub_ids)))
                    if key in seen_wf:
                        # a hostwide (port-0) trigger+sub pair joined
                        # several service groups — report it once
                        continue
                    seen_wf.add(key)
                    wf_hits.append(
                        ActiveHit(
                            host=host, port=anchor.port, template_id=wid,
                            path="", extractions=sorted(sub_ids),
                            tls=anchor.tls,
                        )
                    )
            stats["workflow_hits"] = len(wf_hits)
            unique.extend(wf_hits)
        # the rows only existed for workflow re-confirmation — don't
        # keep every matched response body alive in the hit list
        for h in unique:
            h.row = None
        # wave-loop batching mode: with pipeline="on" every _attribute
        # device pass above rode the continuous-batching scheduler
        # (memo short-circuit + padding buckets + bounded in-flight) —
        # surface its feed-health counters next to the probe stats
        stats["pipeline"] = getattr(self.engine, "pipeline", "off")
        sched = getattr(self.engine, "_sched", None)
        if sched is not None:
            stats["sched"] = sched.stats.snapshot()
        return unique, stats

    def close(self) -> None:
        """Nothing to release: the OOB listener is process-shared
        (other scanners may be using it); its daemon threads die with
        the process. Kept so callers can treat scanners uniformly."""

    # ------------------------------------------------------------------
    def _liveness(self, targets):
        result = scanio.tcp_scan(
            [ip for _h, ip, _p, _t in targets],
            np.asarray([p for _h, _ip, p, _t in targets], dtype=np.uint16),
            None,
            max_concurrency=int(self.executor.spec["concurrency"]),
            connect_timeout_ms=int(self.executor.spec["connect_timeout_ms"]),
            read_timeout_ms=1,  # connect-only
            banner_cap=1,
        )
        # SW_OPEN = connect succeeded (banner may be empty at 1 ms read)
        return [
            t for t, s in zip(targets, result.status) if int(s) == scanio.STATUS_OPEN
        ]

    def _attribute(self, rows, meta, owner_table) -> list[ActiveHit]:
        """Device-match ``rows`` and keep each row's hits only for the
        templates owning its request (shared by http and network passes).
        ``meta``: (host, port, tls, r_idx, path) aligned with rows."""
        out: list[ActiveHit] = []
        if not rows:
            return out
        matched = self.engine.match(rows)
        keep_rows = self.workflow_runner is not None  # rows feed gates
        for row, (host, port, tls, r_idx, path), rm in zip(rows, meta, matched):
            owner_ids = owner_table[r_idx]
            for tid in rm.template_ids:
                if tid in owner_ids:
                    out.append(
                        ActiveHit(
                            host=host,
                            port=port,
                            template_id=tid,
                            path=path,
                            extractions=rm.extractions.get(tid, []),
                            tls=tls,
                            row=row if keep_rows else None,
                        )
                    )
        return out

    def _run_dns(self, parsed, addr_of) -> tuple[list[ActiveHit], int]:
        """Typed DNS queries per distinct target name → attributed hits.

        Matchers run over the dig-style rendering (dnsquery.render), so
        rcode words (SERVFAIL/REFUSED) and answer rdata both match."""
        from swarm_tpu_torch.worker import dnsquery
        from swarm_tpu_torch.worker.executor import _system_resolvers

        hosts = sorted({t[0] for t in parsed})
        if not hosts:
            return [], 0
        resolvers = list(self.executor.spec["resolvers"]) or _system_resolvers()
        if not resolvers:
            return [], 0
        queries: list[tuple[str, str]] = []
        meta_q: list[tuple[str, int]] = []  # (host, qtype idx)
        for host in hosts:
            for q_idx, qtype in enumerate(self.plan.dns_qtypes):
                qname = (
                    dnsquery.reverse_name(host)
                    if qtype == "PTR" and is_ip(host)
                    else host
                )
                queries.append((qname, qtype))
                meta_q.append((host, q_idx))
        replies = dnsquery.query_batch(
            queries,
            resolvers,
            timeout_ms=int(self.executor.spec["read_timeout_ms"]),
        )
        rows: list[Response] = []
        meta: list[tuple[str, int, bool, int, str]] = []
        for (host, q_idx), reply in zip(meta_q, replies):
            if reply is None:
                continue
            rows.append(Response(host=host, port=53, banner=reply.render()))
            meta.append((host, 53, False, q_idx, ""))
        return self._attribute(rows, meta, self._dns_owner_ids), len(queries)

    def _run_network(self, targets) -> tuple[list[ActiveHit], int]:
        """(host × net request) banner probes → attributed hits.

        Port-0 requests expand to each target's own port; explicit-port
        requests probe once per distinct host."""
        work: set[tuple[str, str, int, int]] = set()  # (host, ip, port, r_idx)
        for r_idx, req in enumerate(self.plan.net_requests):
            if req.port:
                for host, ip in {(h, ip) for h, ip, _p, _t in targets}:
                    work.add((host, ip, req.port, r_idx))
            else:
                for host, ip, port, _t in targets:
                    work.add((host, ip, port, r_idx))
        work_list = sorted(work)  # deterministic probe/hit ordering
        out: list[ActiveHit] = []
        for w0 in range(0, len(work_list), self.wave_rows):
            wave = work_list[w0 : w0 + self.wave_rows]
            reqs = [self.plan.net_requests[r] for _h, _ip, _p, r in wave]
            result = scanio.tcp_scan(
                [ip for _h, ip, _p, _r in wave],
                np.asarray([p for _h, _ip, p, _r in wave], dtype=np.uint16),
                [r.payload or None for r in reqs],
                tls=[r.tls for r in reqs],
                sni=[
                    h if not is_ip(h) else None for h, _ip, _p, _r in wave
                ],
                max_concurrency=int(self.executor.spec["concurrency"]),
                connect_timeout_ms=int(self.executor.spec["connect_timeout_ms"]),
                read_timeout_ms=int(self.executor.spec["read_timeout_ms"]),
                banner_cap=int(self.executor.spec["banner_cap"]),
            )
            rows: list[Response] = []
            meta: list[tuple[str, int, bool, int, str]] = []
            for i, (host, _ip, port, r_idx) in enumerate(wave):
                if int(result.status[i]) != scanio.STATUS_OPEN or not result.banner(i):
                    continue
                rows.append(Response(host=host, port=port, banner=result.banner(i)))
                meta.append((host, port, reqs[i].tls, r_idx, ""))
            out.extend(self._attribute(rows, meta, self._net_owner_ids))
        return out, len(work_list)

    def _run_wave(self, wave) -> list[ActiveHit]:
        # mint one correlation token per OOB probe: an interaction can
        # then be attributed to exactly one (target, request) pair
        tokens: dict[int, str] = {}
        if self._oob_reqs and self.oob_listener is not None:
            for i, (_h, _ip, _p, _t, r_idx) in enumerate(wave):
                if r_idx in self._oob_reqs:
                    tokens[i] = self.oob_listener.new_token()
        payloads = [
            self.plan.requests[r_idx].wire(
                host, port, tls,
                oob_url=(
                    self.oob_listener.url_for(tokens[i])
                    if i in tokens
                    else None
                ),
            )
            for i, (host, _ip, port, tls, r_idx) in enumerate(wave)
        ]
        result = scanio.tcp_scan(
            [ip for _h, ip, _p, _t, _r in wave],
            np.asarray([p for _h, _ip, p, _t, _r in wave], dtype=np.uint16),
            payloads,
            tls=[t for _h, _ip, _p, t, _r in wave],
            sni=[h if not is_ip(h) else None for h, _ip, _p, _t, _r in wave],
            max_concurrency=int(self.executor.spec["concurrency"]),
            connect_timeout_ms=int(self.executor.spec["connect_timeout_ms"]),
            read_timeout_ms=int(self.executor.spec["read_timeout_ms"]),
            banner_cap=int(self.executor.spec["banner_cap"]),
        )
        rows: list[Response] = []
        meta: list[tuple[str, int, bool, int, str]] = []
        for i, (host, _ip, port, t, r_idx) in enumerate(wave):
            if int(result.status[i]) != scanio.STATUS_OPEN:
                continue
            code, header, body = parse_http_response(result.banner(i))
            row = Response(
                host=host, port=port, status=code,
                header=header, body=body, tls=t,
            )
            # reported-path form: plan-time markers render as their
            # target-resolved values; the per-probe OOB token renders
            # as the canonical placeholder (one line per finding, not
            # one per minted token)
            m = (
                host, port, t, r_idx,
                _finalize(
                    self.plan.requests[r_idx].path, host, port, t,
                    "{{interactsh-url}}",
                ),
            )
            if i in tokens:
                # OOB probes defer: their matchers need the interaction
                # poll window to close first (run() drains _pending_oob)
                self._pending_oob.append((row, m, tokens.pop(i)))
            else:
                rows.append(row)
                meta.append(m)
        # probes that never produced a row can't be called back in any
        # attributable way later — release their tokens now
        if self.oob_listener is not None:
            for tok in tokens.values():
                self.oob_listener.release(tok)
        return self._attribute(rows, meta, self._owner_ids)
