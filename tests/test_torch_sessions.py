"""The port's session scanner (swarm_tpu_torch.worker.sessions) against
the JAX package's.

The reference tests' session templates (a CSRF-token chain, a broken
chain, indexed-history dsl and part matchers, a negative indexed
matcher, a pitchfork payload flow) run through both packages'
``SessionScanner`` against the same local server, and through both
``ActiveScanner``s on a session-only corpus; the hits must be equal.
"""

import dataclasses
import textwrap

import pytest
import yaml

from swarm_tpu.fingerprints.model import Response as JResponse
from swarm_tpu.fingerprints.nuclei import parse_template as j_parse
from swarm_tpu.ops.engine import MatchEngine as JaxEngine
from swarm_tpu.worker import active as j_active
from swarm_tpu.worker import sessions as j_sessions
from swarm_tpu_torch.fingerprints.model import Response as TResponse
from swarm_tpu_torch.fingerprints.nuclei import parse_template as t_parse
from swarm_tpu_torch.ops.engine import MatchEngine
from swarm_tpu_torch.worker import active as t_active
from swarm_tpu_torch.worker import sessions as t_sessions
from test_sessions import (
    BROKEN_CHAIN,
    CHAIN_TEMPLATE,
    INDEXED_PART_TEMPLATE,
    INDEXED_TEMPLATE,
    NEGATIVE_INDEXED,
    PAYLOAD_SESSION,
    chain_port,  # noqa: F401
)

SPEC = {"read_timeout_ms": 3000, "connect_timeout_ms": 2000}
CASES = {
    "chain": (CHAIN_TEMPLATE, ["session-chain-login"]),
    "broken": (BROKEN_CHAIN, []),
    "indexed_dsl": (INDEXED_TEMPLATE, ["session-indexed"]),
    "indexed_part": (INDEXED_PART_TEMPLATE, ["session-indexed-part"]),
    "negative_indexed": (NEGATIVE_INDEXED, []),
    "payload": (PAYLOAD_SESSION, ["session-payload-login"]),
}


def both(doc: str) -> tuple:
    raw = yaml.safe_load(textwrap.dedent(doc))
    return j_parse(raw, source_path="t/x.yaml"), t_parse(raw, source_path="t/x.yaml")


def hit_view(h) -> dict:
    d = dataclasses.asdict(h)
    row = d.pop("row")
    # the server's Date header may move between the runs
    d["row"] = None if row is None else (row["status"], row["body"])
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_session_scanner_equal(chain_port, case):  # noqa: F811
    doc, want = CASES[case]
    j_t, t_t = both(doc)
    target = [("127.0.0.1", "127.0.0.1", chain_port, False)]
    t_hits = t_sessions.SessionScanner([t_t], SPEC).run(target)
    j_hits = j_sessions.SessionScanner([j_t], SPEC).run(target)
    assert [hit_view(h) for h in t_hits] == [hit_view(h) for h in j_hits]
    assert [h.template_id for h in t_hits] == want


def test_session_only_active_scan_equal(chain_port):  # noqa: F811
    """A corpus of only session templates through both ActiveScanners:
    nothing batchable, every session run against the live target."""
    pairs = [both(CASES[c][0]) for c in sorted(CASES)]
    spec = {**SPEC, "ports": [chain_port], "resolvers": ["127.0.0.1"]}
    j_scan = j_active.ActiveScanner(JaxEngine([j for j, _ in pairs]), spec)
    t_scan = t_active.ActiveScanner(MatchEngine([t for _, t in pairs], device="cpu"), spec)
    assert t_scan.plan.requests == [] == j_scan.plan.requests
    j_hits, j_stats = j_scan.run(["127.0.0.1"])
    t_hits, t_stats = t_scan.run(["127.0.0.1"])
    assert sorted(map(str, map(dataclasses.asdict, t_hits))) == sorted(
        map(str, map(dataclasses.asdict, j_hits)))
    assert t_stats == j_stats and t_stats["session_hits"] == 4


def test_history_helpers_equal():
    steps = [(200, b"HTTP/1.1 200 OK\r\nA: b", b"first-step-marker"),
             (404, b"HTTP/1.1 404 X", b"second")]
    j_rows = [JResponse(host="h", port=80, status=s, header=h, body=b) for s, h, b in steps]
    t_rows = [TResponse(host="h", port=80, status=s, header=h, body=b) for s, h, b in steps]
    j_env, t_env = j_sessions._history_env(j_rows), t_sessions._history_env(t_rows)
    assert t_env == j_env
    for part in ("body_1", "status_code_2", "response_2", "header_1", "body_3", "body", ""):
        got, want = t_sessions._indexed_part(t_rows, part), j_sessions._indexed_part(j_rows, part)
        if want is j_sessions._MISSING:
            assert got is t_sessions._MISSING
        else:
            assert got == want


def test_request_once_equal(chain_port):  # noqa: F811
    req = t_active.PlannedRequest(method="GET", path="/login")
    payload = req.wire("127.0.0.1", chain_port)
    t_raw = t_sessions._request_once("127.0.0.1", chain_port, False, payload, 3.0)
    j_raw = j_sessions._request_once("127.0.0.1", chain_port, False, payload, 3.0)
    assert t_raw.split(b"\r\n\r\n", 1)[1] == j_raw.split(b"\r\n\r\n", 1)[1]
    assert b'name="csrf"' in t_raw
    assert t_sessions._request_once("127.0.0.1", 1, False, payload, 0.5) is None
