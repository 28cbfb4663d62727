"""Candidate-anchored regex execution for the host walk.

The fresh-content host walk's cost is dominated by Python ``re`` scans
over response bytes: extraction regexes on every hit row and the rare
slow confirm regexes (e.g. waf-detect's ``[a-zA-Z0-9]{,60}.cloudfront
.net`` at ~2 ms per scan). Both are accelerated *exactly* — never
approximately — by two pattern facts derived from the sre parse tree:

1. **Required literals** (``compile.required_literal_set``): every
   match contains one of a small set of lowered literals. If none is
   present (one C-speed ``bytes.find`` per literal over the lowered
   part), there is no match — skip the regex entirely.
2. **Mandatory prefix byte classes**: the set of bytes a match's
   first (and second) character can be. Every match start sits at a
   *candidate* position whose bytes satisfy these classes; candidates
   are found at C speed (``bytes.find`` loops for narrow classes,
   a table-translate scan otherwise) and the regex runs as anchored
   ``rex.match`` attempts only there.

``finditer_values`` reproduces ``re.finditer`` semantics exactly
(leftmost, non-overlapping, continue at ``m.end()``) because every
possible match start is a candidate and candidates are tried in
order; patterns whose first position is optional or anchored simply
don't qualify and fall back to plain ``re``.

The port's copy of ``swarm_tpu/ops/fastre.py``, held equal to it by
tests/test_torch_walk.py.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from swarm_tpu_torch.fingerprints import dslc, regexlin
from swarm_tpu_torch.fingerprints.compile import (
    required_literal_cnf,
    required_literal_ladder,
)

try:  # py3.11+
    import re._parser as sre_parse
except ImportError:  # pragma: no cover
    import sre_parse  # type: ignore


#: classes with at most this many member bytes use a bytes.find loop
#: (C speed, zero numpy overhead); wider classes use one translate scan
_NARROW = 4

#: candidate scans bail to plain re when the narrower prefix class is
#: denser than this fraction of the haystack (no pruning to be had)
_DENSITY_BAIL = 0.25

#: more candidates than this and per-candidate anchored match attempts
#: lose to re's own scan loop — fall back
_MAX_CANDS = 96


@dataclasses.dataclass
class PatternInfo:
    """Host-side acceleration facts for one regex pattern."""

    ok: bool  # pattern compiled under Python re
    rex: Optional[re.Pattern]
    # lowered required literals: every match contains >= 1 of them
    literals: Optional[list[bytes]]
    # mandatory prefix byte classes (bool[256] each), len 0..2; the
    # EMPTY list means "no usable prefix" -> no candidate scan
    prefix: list
    # CNF of required-literal groups: every match contains >= 1 member
    # of EVERY group (strictly stronger absent-proof than `literals`;
    # None when the walk yields no mandatory groups)
    cnf: Optional[list] = None
    # index (0 or 1) of the narrower prefix class, its member bytes
    # (when narrow enough for find loops), and the partner class
    scan_pos: int = 0
    scan_bytes: Optional[bytes] = None
    # translate table mapping member bytes -> 0x01 for the wide path
    scan_table: Optional[bytes] = None
    # multi-byte literal prefix (every prefix class a single byte):
    # candidates come from one substring-find loop — as fast as re's
    # own literal-prefix optimizer, but it composes with our anchored
    # non-overlap walk
    needle: Optional[bytes] = None
    # partner class as a 256-byte membership table (bytes indexing is
    # ~5x cheaper than a numpy bool-mask scalar lookup per candidate)
    partner_table: Optional[bytes] = None
    # native VM program (ops/crexc + native/crex.cpp) — when set, the
    # whole finditer/search runs in one GIL-released C call; None keeps
    # the candidate-scan + anchored re.match path
    cprog: Optional[object] = None
    # counter-free program for the linear-time NFA existence scan
    # (crexc.compile_crex_nfa); None when out of subset / oversized
    nfa: Optional[object] = None


def _prefix_classes(pattern: str) -> list:
    """Mandatory first/second byte-class masks of ``pattern``.

    Walks the top of the parse tree collecting positions every match
    must consume, stopping at anything optional, anchored, or too
    complex. Returns [] when no mandatory prefix is derivable.
    """
    try:
        tree = regexlin.parse_quiet(pattern)
    except re.error:
        return []
    if tree.state.flags & re.MULTILINE:
        # MULTILINE only changes ^/$ semantics; AT tokens stop the
        # walk anyway, so masks stay valid — no special handling
        pass
    if tree.state.flags & re.ASCII:
        # class/category masks below are computed under Unicode
        # semantics; (?a) flips what \w/\s/[^...] match for bytes
        # >= 0x80, so a mask-driven scan would silently drop matches.
        # No corpus pattern uses (?a) today — force the exact fallback.
        return []
    ci = bool(tree.state.flags & re.IGNORECASE)
    dotall = bool(tree.state.flags & re.DOTALL)

    def walk(seq, ci: bool, dotall: bool, depth: int = 0) -> list:
        if depth > 8:
            return []
        masks: list = []
        for op, arg in seq:
            if len(masks) >= 2:
                break
            name = str(op)
            try:
                if name == "LITERAL":
                    if arg > 255:
                        return masks  # can't match latin-1 text anyway
                    m = np.zeros(256, dtype=bool)
                    m[arg] = True
                    if ci:
                        c = chr(arg)
                        for o in (c.lower(), c.upper()):
                            if len(o) == 1 and ord(o) < 256:
                                m[ord(o)] = True
                    masks.append(m)
                elif name == "NOT_LITERAL":
                    m = np.ones(256, dtype=bool)
                    if 0 <= arg <= 255:
                        m[arg] = False
                        if ci:
                            c = chr(arg)
                            for o in (c.lower(), c.upper()):
                                if len(o) == 1 and ord(o) < 256:
                                    m[ord(o)] = False
                    masks.append(m)
                elif name == "IN":
                    masks.append(regexlin._class_mask(arg, ci))
                elif name == "ANY":
                    m = np.ones(256, dtype=bool)
                    if not dotall:
                        m[ord("\n")] = False
                    masks.append(m)
                elif name == "SUBPATTERN":
                    _gid, add_f, del_f, sub = arg
                    if add_f & re.ASCII:
                        break  # scoped (?a:) — same mask hazard as above
                    sub_ci = (ci or bool(add_f & re.IGNORECASE)) and not bool(
                        del_f & re.IGNORECASE
                    )
                    # scoped (?s:)/(?-s:) changes what '.' matches
                    # INSIDE the group — propagate, or '.' candidates
                    # would silently exclude newlines
                    sub_dotall = (
                        dotall or bool(add_f & re.DOTALL)
                    ) and not bool(del_f & re.DOTALL)
                    masks.extend(
                        walk(sub, sub_ci, sub_dotall, depth + 1)
                        [: 2 - len(masks)]
                    )
                    break  # offset past the group is not tracked
                elif name == "BRANCH":
                    buckets: list = []
                    for branch in arg[1]:
                        bm = walk(branch, ci, dotall, depth + 1)
                        if not bm:
                            return masks  # one branch unconstrained
                        buckets.append(bm)
                    depth_n = min(len(b) for b in buckets)
                    for i in range(min(depth_n, 2 - len(masks))):
                        u = np.zeros(256, dtype=bool)
                        for b in buckets:
                            u |= b[i]
                        masks.append(u)
                    break
                elif name in ("MAX_REPEAT", "MIN_REPEAT"):
                    lo, _hi, sub = arg
                    if lo == 0:
                        break  # optional: nothing mandatory from here
                    masks.extend(
                        walk(sub, ci, dotall, depth + 1)[: 2 - len(masks)]
                    )
                    break  # repeat tail offset unknown
                else:
                    break  # AT (anchors), GROUPREF, assertions, ...
            except regexlin._Unsupported:
                break
        return masks

    return walk(list(tree), ci, dotall)[:2]


_INFO_CACHE: dict = {}
_INFO_CACHE_MAX = 8192


def analyze(pattern: str) -> PatternInfo:
    info = _INFO_CACHE.get(pattern)
    if info is not None:
        return info
    try:
        # dslc.compile_cached: one warning-suppressed compile + one
        # shared pattern cache with the DSL evaluator / CPU oracle
        rex = dslc.compile_cached(pattern)
        ok = True
    except re.error:
        rex, ok = None, False
    # necessary-literal ladder: prefer 4-byte grams, relax to 3/2 for
    # patterns without one (email-style classes) — a necessary set at
    # ANY length is sound, and extraction gating (engine
    # _accel_extract_regex/_extract_pending) needs SOME set to skip
    # non-matching patterns of multi-hundred-pattern extractors
    literals = required_literal_ladder(pattern) if ok else None
    cnf = required_literal_cnf(pattern) if ok else None
    if cnf and literals:
        # the ladder's set usually reappears among the CNF groups —
        # drop the value-equal duplicate so literals_absent never
        # re-scans the same group
        cnf = [g for g in cnf if g != literals] or None
    prefix = _prefix_classes(pattern) if ok else []
    cprog = None
    nfa = None
    if ok:
        from swarm_tpu_torch.ops.crexc import compile_crex, compile_crex_nfa

        cprog = compile_crex(pattern)
        nfa = compile_crex_nfa(pattern)
    info = PatternInfo(
        ok=ok, rex=rex, literals=literals, prefix=prefix, cprog=cprog,
        nfa=nfa, cnf=cnf,
    )
    if prefix:
        counts = [int(m.sum()) for m in prefix]
        if len(prefix) == 2 and counts[0] == 1 and counts[1] == 1:
            info.needle = bytes(
                [int(np.flatnonzero(prefix[0])[0]),
                 int(np.flatnonzero(prefix[1])[0])]
            )
        else:
            info.scan_pos = int(np.argmin(counts))
            scan_mask = prefix[info.scan_pos]
            if counts[info.scan_pos] <= _NARROW:
                info.scan_bytes = bytes(
                    int(b) for b in np.flatnonzero(scan_mask)
                )
            else:
                info.scan_table = scan_mask.astype(np.uint8).tobytes()
            if len(prefix) > 1:
                info.partner_table = (
                    prefix[1 - info.scan_pos].astype(np.uint8).tobytes()
                )
    if len(_INFO_CACHE) >= _INFO_CACHE_MAX:
        for k in list(_INFO_CACHE)[: _INFO_CACHE_MAX // 2]:
            del _INFO_CACHE[k]
    _INFO_CACHE[pattern] = info
    return info


def literals_absent(info: PatternInfo, lowered: bytes) -> bool:
    """True when the pattern CERTAINLY has no match in the part whose
    ASCII-lowered bytes are ``lowered``: some required-literal group
    (every match must contain one of its members) is fully absent.
    Groups are rarity-ordered, so the first check is the most likely
    proof; the single `literals` set rides first for continuity."""
    lits = info.literals
    if lits and all(lowered.find(lit) < 0 for lit in lits):
        return True
    if info.cnf:
        for group in info.cnf:
            if all(lowered.find(lit) < 0 for lit in group):
                return True
    return False


def _candidates(info: PatternInfo, data: bytes) -> Optional[list]:
    """Sorted possible match-start positions, or None to fall back.

    Pure Python on purpose: a native twin was measured SLOWER — the
    scan is a few bytes.find calls (already C inside CPython), and a
    ctypes dispatch with marshalled nullable buffers costs ~7 µs/call
    vs ~3 µs for this loop on realistic parts."""
    n = len(data)
    if n == 0:
        return []
    if info.needle is not None:
        # both prefix positions are fixed bytes: one substring-find
        # loop yields the candidates directly
        out = []
        i = data.find(info.needle)
        while i >= 0:
            out.append(i)
            if len(out) > _MAX_CANDS:
                return None
            i = data.find(info.needle, i + 1)
        return out
    pos_off = info.scan_pos  # candidate start = scan hit - pos_off
    if info.scan_bytes is not None:
        hits: list = []
        for byte in info.scan_bytes:
            needle = bytes((byte,))
            i = data.find(needle)
            while i >= 0:
                hits.append(i)
                if len(hits) > _MAX_CANDS * 4:
                    return None
                i = data.find(needle, i + 1)
        if len(info.scan_bytes) > 1:
            hits.sort()
    elif info.scan_table is not None:
        marked = data.translate(info.scan_table)
        if len(marked) * _DENSITY_BAIL < marked.count(1):
            return None
        hits = []
        i = marked.find(1)
        while i >= 0:
            hits.append(i)
            if len(hits) > _MAX_CANDS * 4:
                return None
            i = marked.find(1, i + 1)
    else:
        return None
    if not hits:
        return []
    other = 1 - pos_off
    partner = info.partner_table
    out = []
    for h in hits:
        start = h - pos_off
        if start < 0:
            continue
        if partner is not None:
            j = start + other
            if j >= n or not partner[data[j]]:
                continue
        out.append(start)
        if len(out) > _MAX_CANDS:
            return None
    return out


def finditer_values(
    pattern: str, data: bytes, text: str, group
) -> Optional[list]:
    """Exactly ``[m.group(group) or m.group(0) for m in finditer]`` —
    the extraction loop's semantics (cpu_ref.extract_one) — or None
    when the pattern can't be accelerated (caller falls back)."""
    info = analyze(pattern)
    if not info.ok:
        return None
    if isinstance(group, int):
        from swarm_tpu_torch.native import crex as ncrex

        if ncrex.usable(info.cprog):
            spans = ncrex.finditer_spans(info.cprog, data, group)
            if spans is not None:
                return [None if s < 0 else text[s:e] for s, e in spans]
            # resource fallback: keep going on the candidate path below
    if not info.prefix:
        return None
    cands = _candidates(info, data)
    if cands is None:
        return None
    out: list = []
    if not cands:
        return out
    rex = info.rex
    pos = 0
    for c in cands:
        if c < pos:
            continue
        m = rex.match(text, c)
        if m is None:
            continue
        try:
            out.append(m.group(group))
        except IndexError:
            out.append(m.group(0))
        # a mandatory first position means matches are never empty, so
        # finditer's next scan resumes exactly at m.end()
        pos = m.end()
    return out


def search_bool(pattern: str, data: bytes, text: str) -> Optional[bool]:
    """Exactly ``re.search(pattern, text) is not None``, or None when
    not acceleratable."""
    info = analyze(pattern)
    if not info.ok:
        return None
    from swarm_tpu_torch.native import crex as ncrex

    # linear-time NFA existence first: worst-case-bounded (no budget,
    # no backtracking) — the leading-unbounded-repeat shapes that send
    # the backtracker O(n^2) (email-extractor: 19 ms/row) answer in
    # tens of microseconds here, and existence IS search's verdict
    if info.nfa is not None:
        got = ncrex.exists(info.nfa, data)
        if got is not None:
            return got
    if ncrex.usable(info.cprog):
        got = ncrex.search(info.cprog, data)
        if got is not None:
            return got
    if not info.prefix:
        return None
    cands = _candidates(info, data)
    if cands is None:
        return None
    rex = info.rex
    return any(rex.match(text, c) is not None for c in cands)
