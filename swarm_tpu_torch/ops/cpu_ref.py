"""Exact CPU reference matcher — the parity oracle.

Implements nuclei matcher semantics faithfully and readably, with zero
vectorization. The device engine (``ops/match.py``) is correct iff it
agrees with this module on every corpus/response pair — that's the
"100% match parity" metric from BASELINE.md, and the backbone of the
test suite (SURVEY.md §4e).

Semantics notes (verified against nuclei's matcher behavior):
- word: substring on the selected part; ``condition`` and/or across the
  word list; ``case-insensitive`` lowercases both sides.
- regex: Go-style RE2 search; evaluated here with Python ``re`` over a
  latin-1 decode so byte values map 1:1 to code points.
- status: response status ∈ list (condition across list entries).
- size: ``len(part)`` ∈ list.
- binary: hex-decoded byte-string substring search on the part.
- dsl: expression list via :mod:`swarm_tpu_torch.fingerprints.dslc`.
- kval: header key lookup (dashes normalized to underscores).
- negative: inverts the matcher verdict.
- operation verdict: ``matchers-condition`` and/or across matchers;
  template verdict: OR across operations.
"""

from __future__ import annotations

import binascii
import dataclasses
import re
from typing import Optional

from swarm_tpu_torch.fingerprints import dslc
from swarm_tpu_torch.fingerprints.model import Matcher, Operation, Response, Template


@dataclasses.dataclass
class MatchResult:
    template_id: str
    matched: bool
    matcher_names: list[str] = dataclasses.field(default_factory=list)
    extractions: list[str] = dataclasses.field(default_factory=list)
    unsupported: bool = False  # hit a matcher type the oracle can't evaluate


def _decode(part: bytes) -> str:
    # latin-1: every byte maps to the same code point, so byte-regexes
    # behave identically to matching over raw bytes.
    return part.decode("latin-1")


# shared compile cache (see dslc.compile_cached): the corpus has ~1.8k
# distinct regexes, which overflows re's internal 512-entry cache
_compile_cached = dslc.compile_cached


def _parse_headers(header_blob: bytes) -> dict[str, str]:
    # single implementation shared with the kval extractor so matcher
    # and extractor normalization can never diverge
    from swarm_tpu_torch.fingerprints import extractors

    return extractors.parse_header_blob(header_blob)


def match_matcher(matcher: Matcher, response: Response) -> Optional[bool]:
    """Evaluate one matcher. Returns None for unsupported types."""
    part = response.part(matcher.part)
    results: list[bool] = []

    if matcher.type == "word":
        hay = part.lower() if matcher.case_insensitive else part
        for word in matcher.words:
            needle = word.encode("utf-8", "surrogateescape")
            if matcher.case_insensitive:
                needle = needle.lower()
            results.append(needle in hay)
    elif matcher.type == "regex":
        text = _decode(part)
        for pattern in matcher.regex:
            try:
                results.append(_compile_cached(pattern).search(text) is not None)
            except re.error:
                return None
    elif matcher.type == "status":
        results = [response.status == s for s in matcher.status]
    elif matcher.type == "size":
        results = [len(part) == s for s in matcher.size]
    elif matcher.type == "binary":
        for hexstr in matcher.binary:
            try:
                needle = binascii.unhexlify(re.sub(r"\s", "", hexstr))
            except (binascii.Error, ValueError):
                return None
            results.append(needle in part)
    elif matcher.type == "dsl":
        env = dslc.build_env(response)
        for expr in matcher.dsl:
            ast = dslc.try_parse(expr)
            if ast is None:
                return None
            try:
                results.append(bool(dslc.evaluate(ast, env)))
            except Exception:
                # one exotic corpus expression (RE2-only regex syntax,
                # mixed-type arithmetic, bad base64…) must degrade to
                # "unsupported", never abort a whole scan
                return None
    elif matcher.type == "kval":
        headers = _parse_headers(response.part("header"))
        results = [k.lower().replace("-", "_") in headers for k in matcher.kval]
    else:
        # json/xpath appear only as *extractors* in the corpus (measured
        # §2.3: matchers are word/regex/status/size/binary/dsl/kval);
        # a matcher of an unknown type degrades to "unsupported"
        return None

    if not results:
        verdict = False
    elif matcher.condition == "and":
        verdict = all(results)
    else:
        verdict = any(results)
    return (not verdict) if matcher.negative else verdict


def extract_one(ex, response: Response) -> list[str]:
    """One extractor's values for one response row."""
    from swarm_tpu_torch.fingerprints import extractors as ext

    if ex.type != "regex":
        return ext.extract_structured(ex, response)
    out: list[str] = []
    text = _decode(response.part(ex.part))
    for pattern in ex.regex:
        try:
            for m in _compile_cached(pattern).finditer(text):
                try:
                    out.append(m.group(ex.group))
                except IndexError:
                    out.append(m.group(0))
        except re.error:
            continue
    return out


def _extract(op: Operation, response: Response) -> list[str]:
    out: list[str] = []
    for ex in op.extractors:
        out.extend(extract_one(ex, response))
    return out


def match_operation(
    op: Operation, response: Response
) -> tuple[bool, list[str], bool]:
    """Returns (matched, hit_matcher_names, any_unsupported)."""
    unsupported = False
    verdicts: list[bool] = []
    names: list[str] = []
    for matcher in op.matchers:
        v = match_matcher(matcher, response)
        if v is None:
            unsupported = True
            v = False
        verdicts.append(v)
        if v and matcher.name:
            names.append(matcher.name)
    if not verdicts:
        # extractor-only operation: nuclei reports such templates iff
        # any extractor extracts — the whole mechanism of the
        # exposures/tokens family (reference worker/artifacts/templates/
        # exposures/tokens/generic/credentials-disclosure.yaml:20-24,
        # ~600 regexes and no matchers). An op with neither matchers
        # nor extractors still never matches.
        matched = bool(op.extractors) and bool(_extract(op, response))
    elif op.matchers_condition == "and":
        matched = all(verdicts)
    else:
        matched = any(verdicts)
    return matched, names, unsupported


def match_template(template: Template, response: Response) -> MatchResult:
    if not response.alive:
        # no response was ever observed — nuclei produces no output for
        # failed requests, and negative matchers must not fire on a
        # phantom empty response (same gate as MatchEngine)
        return MatchResult(template_id=template.id, matched=False)
    matched = False
    names: list[str] = []
    extractions: list[str] = []
    unsupported = False
    for op in template.operations:
        op_hit, op_names, op_unsup = match_operation(op, response)
        unsupported = unsupported or op_unsup
        if op_hit:
            matched = True
            names.extend(op_names)
            extractions.extend(_extract(op, response))
    return MatchResult(
        template_id=template.id,
        matched=matched,
        matcher_names=names,
        extractions=extractions,
        unsupported=unsupported,
    )


def match_corpus(
    templates: list[Template], responses: list[Response]
) -> list[list[MatchResult]]:
    """[row][template] results — the oracle for parity tests."""
    return [[match_template(t, r) for t in templates] for r in responses]
