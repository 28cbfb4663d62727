"""Stateful per-target template sessions (nuclei's dynamic-value flows)
— a copy of ``swarm_tpu/worker/sessions.py`` on the port's planner
(``worker/active.py``), dsl engine and ``cpu_ref``.

Two template classes need *sequential* per-target execution that the
batch planner (worker/active.py) cannot express:

- **extractor-chain** — a later request embeds a value an earlier
  step's *internal* extractor produced (CSRF tokens, auth cookies:
  ``{{csrf}}`` in step 2 from ``extractors: [name: csrf, internal]`` in
  step 1). 38 reference-corpus templates.
- **multi-step-condition** — matchers reference indexed history
  variables (``body_2``, ``status_code_1``, req-condition raw chains).
  79 reference-corpus templates.

A session executes one (target, template) pair: requests run in order
over plain sockets (TLS per the probe's scheme), each step's internal
extractors feed the variable environment for later steps, and matchers
evaluate host-side — per-step for plain matchers, against the full
response history for indexed ones. Sessions are the cold path (~100
templates × targets, each a handful of requests); the hot corpus still
runs as device batches. Matcher semantics stay oracle-exact: plain
parts reuse ops/cpu_ref on the step response; indexed parts/dsl build
the history environment the same way nuclei's req-condition does.
"""

from __future__ import annotations

import dataclasses
import re
import socket
import ssl as pyssl
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from swarm_tpu_torch.fingerprints import dslc
from swarm_tpu_torch.fingerprints.model import Response, Template
from swarm_tpu_torch.ops import cpu_ref
from swarm_tpu_torch.worker import active as planner
from swarm_tpu_torch.worker.executor import parse_http_response

_INDEXED_RE = re.compile(
    r"\b(body|header|all_headers|status_code|response|raw|duration)_(\d+)\b"
)


@dataclasses.dataclass
class SessionHit:
    host: str
    port: int
    template_id: str
    extractions: list[str]
    tls: bool = False
    # final step's response (workflow named-matcher gates re-confirm
    # against it; None outside workflow contexts)
    row: Optional[Response] = None


def _request_once(
    host: str,
    port: int,
    tls: bool,
    payload: bytes,
    timeout: float,
    connect_timeout: Optional[float] = None,
) -> Optional[bytes]:
    """One HTTP exchange over a fresh connection; None on any failure."""
    try:
        with socket.create_connection(
            (host, port), timeout=connect_timeout or timeout
        ) as sock:
            sock.settimeout(timeout)
            if tls:
                ctx = pyssl.SSLContext(pyssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = pyssl.CERT_NONE
                sock = ctx.wrap_socket(sock, server_hostname=host)
            sock.sendall(payload)
            chunks = []
            total = 0
            while total < 1 << 20:  # 1 MiB response cap
                try:
                    chunk = sock.recv(65536)
                except TimeoutError:
                    # server ignored Connection: close / keeps streaming
                    # — whatever arrived is still a usable response
                    break
                if not chunk:
                    break
                chunks.append(chunk)
                total += len(chunk)
            if tls:
                sock.close()
            return b"".join(chunks) if chunks else None
    except (OSError, pyssl.SSLError, ValueError):
        return None


def _history_env(responses: Sequence[Response]) -> dict:
    """dsl environment over the response history: unindexed names bind
    to the LAST response (nuclei's default), ``name_N`` to step N."""
    env = dslc.build_env(responses[-1])
    for i, r in enumerate(responses, 1):
        step = dslc.build_env(r)
        for key in (
            "body", "header", "all_headers", "raw", "status_code",
            "duration",
        ):
            env[f"{key}_{i}"] = step[key]
        env[f"response_{i}"] = step["raw"]
    return env


_MISSING = object()  # indexed step that was never fetched


def _indexed_part(responses: Sequence[Response], part: str):
    """bytes for an indexed part, None when the part isn't indexed, or
    ``_MISSING`` when the referenced step was never fetched (truncated
    session) — a missing step must evaluate False, never empty-match."""
    m = _INDEXED_RE.fullmatch(part or "")
    if not m:
        return None
    name, idx = m.group(1), int(m.group(2))
    if not 1 <= idx <= len(responses):
        return _MISSING
    base = {"response": "raw", "status_code": "status_code"}.get(name, name)
    if base == "status_code":
        return str(responses[idx - 1].status).encode()
    return responses[idx - 1].part(base)


def _eval_matcher(m, responses: Sequence[Response]) -> bool:
    """One matcher over the history: indexed parts/dsl see every step,
    plain matchers see the step they belong to (the last response)."""
    if m.type == "dsl":
        env = _history_env(responses)
        vs = []
        for expr in m.dsl:
            ast = dslc.try_parse(expr)
            if ast is None:
                vs.append(False)
                continue
            try:
                vs.append(bool(dslc.evaluate(ast, env)))
            except Exception:
                vs.append(False)
        v = all(vs) if m.condition == "and" else any(vs)
        return (not v) if m.negative else v
    data = _indexed_part(responses, m.part)
    if data is _MISSING:
        return False  # phantom step: no matcher may fire on it
    if data is not None:
        # evaluate against a synthetic response whose body is the
        # indexed slice, with the part rewritten to plain "body"
        row = Response(body=data, status=responses[-1].status)
        m = dataclasses.replace(m, part="body")
        return bool(cpu_ref.match_matcher(m, row))
    return bool(cpu_ref.match_matcher(m, responses[-1]))


class SessionScanner:
    """Execute session-class templates per target."""

    def __init__(
        self,
        templates: Sequence[Template],
        probe_spec: Optional[dict] = None,
        user_vars: Optional[dict] = None,
    ):
        spec = probe_spec or {}
        self.templates = list(templates)
        self.user_vars = dict(user_vars or {})
        self.timeout = float(spec.get("read_timeout_ms", 2500)) / 1000.0
        self.connect_timeout = (
            float(spec.get("connect_timeout_ms", 1500)) / 1000.0
        )
        self.concurrency = int(spec.get("session_concurrency", 32))
        self.max_steps = int(spec.get("max_session_steps", 8))

    # ------------------------------------------------------------------
    def _steps_of(self, t: Template):
        """Flatten a template into (op, PlannedRequest-template-text)
        steps; raw ops contribute one step per raw block."""
        steps = []
        for op in t.operations:
            if op.raw:
                for raw in op.raw:
                    steps.append((op, ("raw", raw)))
            else:
                method = (op.method or "GET").upper()
                for path in op.paths:
                    steps.append((op, ("req", method, path)))
        return steps[: self.max_steps]

    def _render(self, text: str, vars_: dict) -> Optional[str]:
        return planner._substitute(text, vars_ or None)

    def _run_one(
        self, t: Template, host: str, ip: str, port: int, tls: bool
    ) -> Optional[SessionHit]:
        """One (target, template): payload-bearing templates fan out
        over their (bounded) combo set, first hit wins — nuclei's
        payload semantics for stateful flows (default-logins with
        req-condition etc.)."""
        combos: list = [None]
        for op in t.operations:
            if op.payloads:
                combos, _trunc = planner._payload_combos(op, t.source_path)
                combos = combos or [None]
                break
        for combo in combos:
            hit = self._run_combo(
                t, host, ip, port, tls,
                {**self.user_vars, **(combo or {})},
            )
            if hit is not None:
                return hit
        return None

    def _run_combo(
        self, t: Template, host: str, ip: str, port: int, tls: bool,
        base_vars: dict,
    ) -> Optional[SessionHit]:
        vars_: dict = dict(base_vars)
        responses: list[Response] = []
        op_results: dict[int, list[bool]] = {}
        extractions: list[str] = []
        # req-condition semantics: templates referencing indexed history
        # vars evaluate their matchers ONCE after every step completed
        # (nuclei's cond mode) — per-step evaluation would see future
        # steps as empty, letting negative matchers false-positive
        indexed_mode = planner._uses_indexed_vars(t)
        deferred: list = []  # (op, history_len_at_op_end) for indexed mode
        for op, step in self._steps_of(t):
            if step[0] == "raw":
                rendered = self._render(step[1], vars_)
                if rendered is None:
                    return None  # a needed value never materialized
                req = planner._parse_raw(rendered)
                if req is None:
                    return None
            else:
                _, method, path_t = step
                path = self._render(path_t, vars_)
                body = self._render(op.body or "", vars_)
                if path is None or body is None:
                    return None
                if path.startswith("\x00BASE\x00"):
                    path = path[len("\x00BASE\x00"):] or "/"
                if not path.startswith("/"):
                    path = "/" + path
                headers = []
                for k, v in op.headers:
                    hv = self._render(v, vars_)
                    if hv is None:
                        return None
                    headers.append((k, hv))
                req = planner.PlannedRequest(
                    method=method,
                    path=path,
                    headers=tuple(headers),
                    body=body.encode("latin-1", "replace"),
                )
            raw = _request_once(
                ip, port, tls, req.wire(host, port, tls), self.timeout,
                connect_timeout=self.connect_timeout,
            )
            if raw is None:
                return None  # target gone mid-session
            status, header, body_b = parse_http_response(raw)
            row = Response(
                host=host, port=port, status=status,
                header=header, body=body_b, tls=tls,
            )
            responses.append(row)
            # internal extractors feed the variable environment;
            # non-internal ones contribute to output
            for ex in op.extractors:
                values = cpu_ref._extract(
                    dataclasses.replace(op, extractors=[ex]), row
                )
                if ex.internal and ex.name:
                    if values:
                        vars_.setdefault(ex.name, values[0])
                elif values:
                    extractions.extend(values)
            op_idx = id(op)
            if op.matchers:
                if indexed_mode:
                    deferred.append(op)
                else:
                    vs = [_eval_matcher(m, responses) for m in op.matchers]
                    verdict = (
                        all(vs)
                        if op.matchers_condition == "and"
                        else any(vs)
                    )
                    op_results.setdefault(op_idx, []).append(verdict)
        if indexed_mode:
            for op in {id(o): o for o in deferred}.values():
                vs = [_eval_matcher(m, responses) for m in op.matchers]
                verdict = (
                    all(vs) if op.matchers_condition == "and" else any(vs)
                )
                op_results.setdefault(id(op), []).append(verdict)
        # a template fires if any op matched on any of its steps (OR —
        # the same per-response semantics the batch path uses)
        if any(any(v) for v in op_results.values()):
            return SessionHit(
                host=host, port=port, template_id=t.id,
                extractions=extractions, tls=tls,
                row=responses[-1] if responses else None,
            )
        return None

    # ------------------------------------------------------------------
    def run(
        self, targets: Sequence[tuple[str, str, int, bool]]
    ) -> list[SessionHit]:
        """``targets``: (host, resolved_ip, port, tls) tuples — the
        connection dials the ip, the Host header carries the name."""
        jobs = [
            (t, host, ip, port, tls)
            for host, ip, port, tls in targets
            for t in self.templates
        ]
        hits: list[SessionHit] = []
        if not jobs:
            return hits
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            for hit in pool.map(lambda j: self._run_one(*j), jobs):
                if hit is not None:
                    hits.append(hit)
        return hits
