"""Template corpus → dense tensor database for the device match kernels.

Lowering strategy (designed for TPU/XLA, not a port — the reference
shells out to nuclei/nmap for this entire layer):

- Every *word-like* payload (word matchers, binary matchers, dsl
  ``contains`` conjuncts, regex required-literals) becomes a **word
  slot**: a (bytes, stream, case) triple. Slots of length ≥ 4 register a
  q-gram (8-gram, or 4-gram for short words) in per-(stream, case, q)
  hash tables — sorted unique h1 groups + entry arrays + a Bloom bitmap
  probed by the kernel. Tiny slots (1–3 bytes) take a dense shifted
  compare (exact). The kernel screens q-gram hits via 128 hash bits
  (entry h1/h2 + suffix-gram h1/h2), then **byte-verifies** each hit on
  device by gathering the window under ``slot_bytes``/``slot_len`` and
  comparing — a verified hit is *certain* (no host confirm), a failed
  compare is a proven non-match, and only slots longer than
  ``VERIFY_WIDTH`` (prefix-verified) stay uncertain.
- Matchers lower to records over those bits plus scalar features
  (status, part lengths): word/binary → slot-bucket reductions,
  status/size → scalar compares, simple dsl → conjunctive scalar
  programs (len/status/content_length) with optional residues (md5 → a
  digest check the host or the device md5 kernel confirms), regex → a
  prefilter slot whose hits are uncertain-by-construction.
- Matchers that cannot be soundly approximated (kval/json/xpath,
  literal-less regex, exotic dsl) force their template onto the
  **host-always** list — evaluated by the exact CPU oracle so overall
  parity stays 100%; the compiler reports how much of the corpus that
  tail is.
- Out-of-band parts (``interactsh_protocol``/``interactsh_request``)
  lower onto their own tiny device streams (oobp/oobr), filled from
  ``Response.oob_*`` by the worker's interaction listener
  (worker/oob.py); rows without interactions carry empty streams, so
  the no-listener behavior is the old constant-False — exactly.

Uncertainty contract (the parity invariant): a matcher's device bit is
exact unless its ``uncertain`` bit is set, and uncertain bits can only
be set when the underlying superset signal *fired* — absence of a hit is
always exact. Host confirmation therefore only runs on (row, template)
pairs whose verdict actually fired an uncertain matcher.
"""

from __future__ import annotations

import binascii
import dataclasses
import re
import sys
from typing import Optional

import numpy as np

from swarm_tpu_torch.fingerprints import dslc, regexlin
from swarm_tpu_torch.fingerprints.model import Matcher, Template
from swarm_tpu_torch.ops import hashing
from swarm_tpu_torch.ops.encoding import (
    HOST_ONLY_PARTS,
    STREAMS,
    lower_bytes_np,
    stream_for_part,
)

# ---------------------------------------------------------------------------
# Constants / enums (shared with ops.match / ops.verdict)
# ---------------------------------------------------------------------------

VERIFY_WIDTH = 64  # byte-exact verify cap; longer slots are prefix+host

# Matcher kinds
MK_CONST_FALSE = 0
MK_WORDS = 1  # word/binary/contains — slots under this matcher's condition
MK_STATUS = 2
MK_SIZE = 3
MK_SCALAR_DSL = 4  # conjunctive scalar program (+ optional residue)
MK_REGEX_PREFILTER = 5  # slot bit is a superset; hit ⇒ uncertain

# Scalar-program variable ids
SV_STATUS = 0
SV_LEN_BODY = 1
SV_LEN_HEADER = 2
SV_LEN_ALL = 3
SV_CONTENT_LENGTH = 4
SCALAR_VARS = 5

# Scalar-program comparison ops
SOP_EQ, SOP_NE, SOP_LT, SOP_GT, SOP_LE, SOP_GE, SOP_TRUE = range(7)

MAX_SCALAR_CONJUNCTS = 6
MAX_GROUP = 8  # max word slots sharing one (table, h1) group
HARD_GROUP = 64  # degrade ceiling when gram shedding fails (see below)

# Rough byte-commonness weights for picking the rarest q-gram of a word.
# Calibrated for the actual haystacks (HTML bodies, HTTP headers):
# markup/structural bytes are the MOST common there — "</title>",
# "\r\nServer:", "=\"" style grams recur in nearly every response, so a
# gram of markup bytes must never beat a gram of letters. (A weight
# inversion here once made every "…</title>" word share the
# "</title>" gram — one shared table group, mass candidate collisions.)
_COMMON = np.zeros(256, dtype=np.float32)
for _c in b"<>/\"'=.-_:;()\r\n\t ":
    _COMMON[_c] = 1.3
for _c in b"etaoinshrdlucmfwygpb":
    _COMMON[_c] = 1.0
for _c in b"ETAOINSHRDLU0123456789":
    _COMMON[_c] = 0.8
for _c in b"&?%+,![]{}":
    _COMMON[_c] = 0.9


def _gram_offsets_by_rarity(data: bytes, q: int) -> list[int]:
    """Candidate gram offsets, rarest window first."""
    if len(data) <= q:
        return [0]
    weights = _COMMON[np.frombuffer(data, dtype=np.uint8)]
    window_scores = np.convolve(weights, np.ones(q), mode="valid")
    return list(np.argsort(window_scores, kind="stable").astype(int))


# ---------------------------------------------------------------------------
# Regex required-literal extraction (prefilter factory)
# ---------------------------------------------------------------------------


MAX_LITERAL_ALTS = 16  # cap on any-of literal sets from alternations


def _lower_ascii(data: bytes) -> bytes:
    return bytes(lower_bytes_np(np.frombuffer(data, np.uint8)).tobytes())


# Strings present in ~every HTTP(HTML) response: a required literal that
# is (or sits inside) one of these fires on all traffic, so candidates
# containing only such members rank below any discriminating set.
_UBIQUITOUS = (
    b"<title>", b"</title>", b"<html", b"</html>", b"<head", b"</head>",
    b"<body", b"</body>", b"<div", b"</div>", b"<span", b"</span>",
    b"<link", b"<meta", b"<script", b"</script>", b"href=", b"src=",
    b"http://", b"https://", b"content-type", b"text/html", b"charset=",
    b"</a>", b"utf-8", b"class=", b"style=", b"width=", b"id=",
)


def _lit_rarity(lit: bytes) -> int:
    """Effective discriminating length of one literal: a literal that is
    itself (a piece of) boilerplate prunes nothing; one that merely
    *contains* boilerplate plus more is judged by its full length."""
    if any(lit in u for u in _UBIQUITOUS):
        return 1
    return len(lit)


# Beyond this many bytes a literal's extra length adds no pruning power
# (a 16-byte exact substring is already as discriminating as any), so
# member COUNT becomes the deciding cost: a digit-crossing expansion
# that multiplies one signature into 10 near-identical word slots
# ("…reposerver pro 0".."…pro 9") must lose to the single two-bytes-
# shorter run — the 10 slots share every rare gram, overflow one
# word-table hash group, and buy nothing.
_RARITY_CAP = 16


def _litset_score(cand: list[bytes]) -> tuple[int, int, int]:
    """(capped min member rarity, -member count, true min rarity):
    every member must be rare for the set to prune, since any member
    firing routes to confirm; past _RARITY_CAP, fewer members wins."""
    r = min(_lit_rarity(c) for c in cand)
    return (min(r, _RARITY_CAP), -len(cand), r)


def required_literal_set(
    pattern: str, min_len: int = 4, max_alts: int = MAX_LITERAL_ALTS,
    collect: Optional[list] = None,
) -> Optional[list[bytes]]:
    """A set S of lowered byte literals such that **every** match of
    ``pattern`` contains at least one s ∈ S as a substring.

    Walks the sre parse tree keeping a *set* of literal runs: an
    alternation multiplies the run set by each branch's full literal
    expansions (so ``(?:InvalidURI|NoSuchBucket)`` and case-permutation
    chains like ``(f|F)(i|I)…`` both resolve — the latter collapses to
    one literal after ASCII lowering, since the probe always runs on
    the lowered stream). Optional nodes (``X?``) multiply the run set
    by {""} ∪ expansions(X) so adjacency survives (``db[_-]?pw`` →
    {dbpw, db_pw, db-pw}, not {db}); where a group/alternation has no
    full expansion, its literal *prefix* expansions extend the runs
    before the flush (``[.](com|co.uk)`` → {.com, .co}) — a prefix is
    forced contiguous with the consumed left context, so the combined
    runs stay necessary. Other non-literal nodes flush the run set as
    a candidate. Returns the best candidate (longest minimum member,
    then fewest members) with every member ≥ min_len, or None.

    Soundness: a run set is only considered when every member reflects
    a byte sequence forced by one complete alternation path; ASCII
    lowering is sound because the device probes the lowered stream
    (non-A-Z bytes are untouched on both sides). Runs collected under
    case-insensitivity with non-ASCII bytes are rejected — Python folds
    Unicode there, device lowering is ASCII-only.

    ``collect``: optional list; every candidate that clears ``min_len``
    from a *mandatory* position (top-level concatenation, mandatory
    group bodies, branch-union sets — never branch-local sets) is
    appended. Each collected set is independently necessary, so the
    list is a CNF (AND of OR-sets) usable as a host-side gate
    (``required_literal_cnf``)."""
    try:
        tree = regexlin.parse_quiet(pattern)
    except re.error:
        return None

    global_ci = bool(tree.state.flags & re.IGNORECASE)
    best: list[Optional[list[bytes]]] = [None]
    # >0 ⇒ inside a branch-local walk: candidates there are necessary
    # only for that branch, not the whole pattern — never collected
    branch_local = [0]

    def consider(cand: list[bytes]) -> None:
        if not cand or any(len(c) < min_len for c in cand):
            return
        if collect is not None and not branch_local[0]:
            collect.append(sorted(cand))
        cur = best[0]
        if cur is None or _litset_score(cand) > _litset_score(cur):
            best[0] = cand

    def class_alts(arg, ci: bool) -> Optional[list[bytes]]:
        """Small literal character class [Gg] → its (lowered) bytes.
        ``\\d`` expands to 0-9: over the latin-1 decode the oracle
        matches on (cpu_ref._decode), every code point is ≤ 0xFF and
        the only Nd-category ones are ASCII digits, so the expansion
        is exact."""
        alts = set()
        for kind, val in arg:
            skind = str(kind)
            if skind == "CATEGORY" and str(val) == "CATEGORY_DIGIT":
                alts.update(b"0123456789"[i : i + 1] for i in range(10))
            elif skind != "LITERAL" or not (0 <= val < 256):
                return None
            else:
                if ci and val >= 0x80:
                    # Python folds Unicode over the latin-1 decode;
                    # ASCII lowering can't reproduce that, so the set
                    # would not be necessary
                    return None
                alts.add(_lower_ascii(bytes([val])))
            if len(alts) > max_alts:
                return None
        return sorted(alts)

    def expansions(seq, ci: bool) -> Optional[list[bytes]]:
        """All full literal expansions of ``seq`` (lowered, deduped):
        None if any part is not literal/branch/class/fixed-repeat, []
        if the sequence is DEAD (can never match — see below).
        Lowering is sound: the probe always scans the lowered stream.

        Deadness: the oracle matches over the latin-1 decode
        (cpu_ref._decode), whose code points are all ≤ 0xFF — a
        case-sensitive LITERAL above 0xFF (e.g. the ⚡ in tech-detect's
        amp matcher) can never match, so an alternation branch
        containing one contributes nothing and the LIVE branches'
        literals remain necessary. Under IGNORECASE this is unsound
        (U+212A KELVIN SIGN folds to 'k') and stays unsupported."""
        outs = [b""]

        def cross(alts: list[bytes]) -> bool:
            nonlocal outs
            outs = sorted({o + a for o in outs for a in alts})
            return len(outs) <= max_alts

        for op, arg in seq:
            opname = str(op)
            if opname == "LITERAL" and arg >= 0:
                if ci and arg >= 0x80:
                    return None  # Unicode folding ≠ ASCII lowering
                if arg > 0xFF:
                    return []  # dead: can't occur in latin-1 text
                if not cross([_lower_ascii(bytes([arg]))]):
                    return None
            elif opname == "IN":
                alts = class_alts(arg, ci)
                if alts is None or not cross(alts):
                    return None
            elif opname == "SUBPATTERN":
                child_ci = (ci or bool(arg[1] & re.IGNORECASE)) and not bool(
                    arg[2] & re.IGNORECASE
                )
                child = expansions(arg[3], child_ci)
                if child is None or not cross(child):
                    return None
                if child == []:
                    return []  # dead group ⇒ dead sequence
            elif opname == "BRANCH":
                alts = []
                saw_live = False
                for branch in arg[1]:
                    exp = expansions(branch, ci)
                    if exp is None:
                        return None
                    if exp == []:
                        continue  # dead branch: drop it
                    saw_live = True
                    alts.extend(exp)
                if not saw_live:
                    return []  # every branch dead ⇒ dead sequence
                if not cross(alts):
                    return None
            elif opname == "MAX_REPEAT" or opname == "MIN_REPEAT":
                lo, hi, child = arg
                if lo == 0 and int(hi) == 1:
                    # optional: each match contains zero or one copy —
                    # {""} ∪ expansions keeps the sequence literal
                    exp = expansions(child, ci)
                    if exp is None:
                        return None
                    if exp == []:
                        continue  # dead optional: only the 0-copy path
                    if not cross([b""] + exp):
                        return None
                    continue
                if lo != hi:
                    return None
                exp = expansions(child, ci)
                if exp is None:
                    return None
                if exp == [] and lo >= 1:
                    return []  # dead child with a mandatory copy
                for _ in range(int(lo)):
                    if not cross(exp):
                        return None
            elif opname == "AT":
                continue
            else:
                return None
        return outs

    def prefix_exps(seq, ci: bool) -> Optional[list[bytes]]:
        """Literal expansions of the longest expandable PREFIX of
        ``seq`` (every member ≥ 1 byte), or None. Every match of the
        sequence *starts* with one member, so extending the current
        runs by these preserves necessity-with-adjacency even when the
        tail of the sequence has no full expansion."""

        def crossed(base: list[bytes], alts: list[bytes]):
            new = sorted({o + a for o in base for a in alts})
            return new if len(new) <= max_alts else None

        outs = [b""]
        for op, arg in seq:
            opname = str(op)
            nxt = None
            stop_after = False
            if opname == "AT":
                continue
            elif opname == "LITERAL" and 0 <= arg <= 0xFF:
                if not (ci and arg >= 0x80):
                    nxt = crossed(outs, [_lower_ascii(bytes([arg]))])
            elif opname == "IN":
                alts = class_alts(arg, ci)
                if alts is not None:
                    nxt = crossed(outs, alts)
            elif opname == "SUBPATTERN":
                child_ci = (
                    ci or bool(arg[1] & re.IGNORECASE)
                ) and not bool(arg[2] & re.IGNORECASE)
                exp = expansions(arg[3], child_ci)
                if exp is not None and exp != []:
                    nxt = crossed(outs, exp)
                if nxt is None:
                    child = prefix_exps(arg[3], child_ci)
                    if child is not None:
                        nxt = crossed(outs, child)
                    stop_after = True  # tail of a partial group unknown
            elif opname == "BRANCH":
                exp = expansions([(op, arg)], ci)
                if exp is not None and exp != []:
                    nxt = crossed(outs, exp)
                if nxt is None:
                    pres = [prefix_exps(b, ci) for b in arg[1]]
                    if all(p is not None for p in pres):
                        union = sorted({m for p in pres for m in p})
                        nxt = crossed(outs, union)
                    stop_after = True
            elif opname == "MAX_REPEAT" or opname == "MIN_REPEAT":
                lo, hi, child = arg
                if lo >= 1:
                    exp = expansions(child, ci)
                    if exp is not None and exp != []:
                        nxt = crossed(outs, exp)
                        if nxt is not None and lo == hi:
                            for _ in range(int(lo) - 1):
                                nxt = crossed(nxt, exp)
                                if nxt is None:
                                    break
                        else:
                            stop_after = True  # variable tail
            if nxt is None:
                break
            outs = nxt
            if stop_after:
                break
        if outs == [b""] or not all(outs):
            return None
        return outs

    def nec_set(seq, ci: bool) -> Optional[list[bytes]]:
        """Best necessary literal set of a subsequence (its own walk).
        Branch-local: candidates found here are necessary only for one
        alternation branch, so CNF collection is suspended."""
        saved = best[0]
        best[0] = None
        branch_local[0] += 1
        walk(seq, ci)
        branch_local[0] -= 1
        out = best[0]
        best[0] = saved
        return out

    def walk(seq, ci: bool) -> None:
        # runs: every member lowered; every match of the consumed prefix
        # contains one member as a contiguous substring
        runs: list[bytes] = [b""]

        def runs_candidate() -> None:
            if all(runs) and runs != [b""]:
                consider(sorted(set(runs)))

        def flush() -> None:
            nonlocal runs
            runs_candidate()
            runs = [b""]

        def extend(alts: list[bytes]) -> None:
            nonlocal runs
            if len(alts) > 1:
                # The pre-extension runs are already a sound necessary
                # set (bytes forced by the consumed prefix — necessity
                # holds for any prefix of the walk). A multiplying
                # extension can score WORSE than what it extends: ten
                # digit variants of one signature tail share every rare
                # gram and overflow a word-table hash group, where the
                # one-member run prunes just as hard. Offer the cheap
                # set; _litset_score picks.
                runs_candidate()
            new = sorted({r + a for r in runs for a in alts})
            if len(new) > max_alts:
                flush()
            else:
                runs = new

        for op, arg in seq:
            opname = str(op)
            if opname == "LITERAL" and 0 <= arg < 256:
                if ci and arg >= 0x80:
                    flush()
                else:
                    extend([_lower_ascii(bytes([arg]))])
            elif opname == "IN":
                alts = class_alts(arg, ci)
                if alts is not None:
                    extend(alts)
                else:
                    flush()
            elif opname == "SUBPATTERN":
                # groups are transparent: expand inline when possible so
                # literals on both sides stay adjacent
                child_ci = (ci or bool(arg[1] & re.IGNORECASE)) and not bool(
                    arg[2] & re.IGNORECASE
                )
                exp = expansions(arg[3], child_ci)
                if exp is not None:
                    extend(exp)
                else:
                    # partial group: its literal prefix is forced
                    # contiguous with the consumed left context —
                    # extend before flushing so e.g. [.](com|co.uk)
                    # keeps the dot (".com"/".co", not "com"/"co")
                    pre = prefix_exps(arg[3], child_ci)
                    if pre is not None:
                        extend(pre)
                    flush()
                    walk(arg[3], child_ci)
                    flush()
            elif opname == "BRANCH":
                exp = expansions([(op, arg)], ci)
                if exp is not None:
                    extend(exp)
                    continue
                pres = [prefix_exps(b, ci) for b in arg[1]]
                if all(p is not None for p in pres):
                    union = sorted({m for p in pres for m in p})
                    if len(union) <= max_alts:
                        extend(union)
                flush()
                # every branch with its own necessary set → the union
                # is necessary for the alternation as a whole
                sets = [nec_set(b, ci) for b in arg[1]]
                if all(s is not None for s in sets):
                    union = sorted({m for s in sets for m in s})
                    if len(union) <= max_alts:
                        consider(union)
            elif opname == "MAX_REPEAT" or opname == "MIN_REPEAT":
                lo, hi, child = arg
                if lo >= 1:
                    exp = expansions(child, ci)
                    if exp is not None:
                        # one guaranteed copy keeps runs adjacent; a
                        # variable tail breaks adjacency afterwards
                        extend(exp)
                        if hi == lo:
                            for _ in range(int(lo) - 1):
                                extend(exp)
                        else:
                            flush()
                    else:
                        flush()
                        walk(child, ci)
                        flush()
                elif lo == 0 and int(hi) == 1:
                    # optional node: every match contains zero or one
                    # copy — {""} ∪ expansions keeps runs adjacent
                    # (db[_-]?pw → dbpw|db_pw|db-pw)
                    exp = expansions(child, ci)
                    if exp is not None and exp != []:
                        extend([b""] + exp)
                    elif exp == []:
                        pass  # dead optional: only the 0-copy path
                    else:
                        flush()
                else:
                    flush()
            elif opname == "AT":
                # zero-width assertion: consumes nothing, so bytes on
                # either side are still adjacent in any match
                continue
            else:
                # ANY, CATEGORY, GROUPREF… — not a required literal
                flush()
        flush()

    walk(tree, global_ci)
    return best[0]


def required_literal_ladder(
    pattern: str, min_lens: tuple = (4, 3, 2)
) -> Optional[list]:
    """``required_literal_set`` at the first ``min_len`` that yields a
    set — the shared relax ladder for every literal gate (device
    superset lowering, extraction prefilters, fastre's host gate), so
    the host and device can never disagree about which literals a
    pattern requires."""
    for ml in min_lens:
        s = required_literal_set(pattern, min_len=ml)
        if s is not None:
            return s
    return None


def required_literal_cnf(
    pattern: str, min_len: int = 1, max_groups: int = 8
) -> Optional[list[list[bytes]]]:
    """Every *independently necessary* literal OR-set of ``pattern``
    (CNF: a match must contain ≥1 member of EVERY group). The groups
    come from mandatory positions of the parse walk — top-level
    concatenation segments, mandatory group bodies, and branch-union
    sets — never from inside a single alternation branch.

    A conjunctive host gate over all groups is strictly stronger than
    the single best set (``[a-z0-9]{4,}@[a-z0-9]+[.](com|…)`` requires
    BOTH "@" AND one of ".com"/".org"/… — either absence is an exact
    no-match proof), while each group alone stays sound for the device
    prefilter. Deduped, best-scored first, capped at ``max_groups``."""
    groups: list = []
    required_literal_set(pattern, min_len=min_len, collect=groups)
    if not groups:
        return None
    seen = set()
    uniq = []
    for g in groups:
        key = tuple(g)
        if key in seen:
            continue
        # a group that is a superset of an already-kept group adds no
        # pruning power in the absent-check direction; keep it anyway
        # only if distinct — the cap keeps the gate cheap
        seen.add(key)
        uniq.append(g)
    uniq.sort(key=_litset_score, reverse=True)
    return uniq[:max_groups]


def required_literal(pattern: str, min_len: int = 4) -> Optional[bytes]:
    """Single required literal (longest member of a singleton set)."""
    lits = required_literal_set(pattern, min_len=min_len, max_alts=1)
    return lits[0] if lits else None


def full_literal_expansions(
    pattern: str, max_alts: int = MAX_LITERAL_ALTS
) -> Optional[tuple[list[bytes], bool]]:
    """(alternatives, case_insensitive) when ``re.search(pattern, s)``
    is *exactly* equivalent to "s contains one of the alternatives" —
    i.e. the pattern is pure literals/alternations/fixed repeats with
    no classes, anchors, or variable quantifiers. Alternatives are
    lowered when ci (probe the lowered stream), raw bytes otherwise.

    This turns literal-shaped corpus "regexes" (MySqlException,
    (?i)x-frame-options, …) into exact word slots instead of
    uncertain prefilters.
    """
    try:
        tree = regexlin.parse_quiet(pattern)
    except re.error:
        return None
    ci = bool(tree.state.flags & re.IGNORECASE)

    def expand(seq, ci: bool) -> Optional[list[bytes]]:
        outs = [b""]
        for op, arg in seq:
            opname = str(op)
            if opname == "LITERAL" and 0 <= arg < 256:
                if ci and arg >= 0x80:
                    return None  # Unicode folding ≠ ASCII lowering
                b = bytes([arg])
                outs = [o + (_lower_ascii(b) if ci else b) for o in outs]
            elif opname == "SUBPATTERN":
                child_ci = (ci or bool(arg[1] & re.IGNORECASE)) and not bool(
                    arg[2] & re.IGNORECASE
                )
                if child_ci != ci:
                    return None  # mixed-case scopes don't map to one slot case
                child = expand(arg[3], ci)
                if child is None:
                    return None
                outs = [o + c for o in outs for c in child]
            elif opname == "BRANCH":
                alts = []
                for branch in arg[1]:
                    exp = expand(branch, ci)
                    if exp is None:
                        return None
                    alts.extend(exp)
                outs = [o + a for o in outs for a in alts]
            elif opname == "MAX_REPEAT" or opname == "MIN_REPEAT":
                lo, hi, child = arg
                if lo != hi:
                    return None
                exp = expand(child, ci)
                if exp is None:
                    return None
                for _ in range(int(lo)):
                    outs = [o + c for o in outs for c in exp]
                    if len(outs) > max_alts:
                        return None
            else:
                # IN, ANY, AT, CATEGORY… — not a pure literal pattern
                return None
            if len(outs) > max_alts:
                return None
        return outs

    outs = expand(tree, ci)
    if outs is None or any(not o for o in outs):
        return None  # an empty alternative matches everything
    return sorted(set(outs)), ci


# ---------------------------------------------------------------------------
# DSL lowering: conjunctive scalar programs + contains/md5 residues
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScalarProgram:
    conjuncts: list[tuple[int, int, float]]  # (var, op, value)
    contains: list[tuple[bytes, str, bool]]  # (needle, stream, case_insensitive)
    residue: bool = False  # sha/mmh3 residue → hit needs host confirm
    never: bool = False  # statically unsatisfiable (e.g. "AbC" in tolower(x))
    any_of: bool = False  # contains are OR-reduced (no conjuncts/residue)
    negated: bool = False  # value = NOT(OR of contains) — !contains() exprs
    # md5(body) == "<hex>" conjunct, lowered to the device digest
    # comparison (ops/md5.py) — exact, no host confirm
    md5: Optional[bytes] = None
    # conjuncts of the form !contains(...)/!regex('literal',...): every
    # listed needle must be ABSENT (NOT(OR)) — the missing-header
    # template shape (misconfiguration/http-missing-security-headers)
    neg_contains: list = dataclasses.field(default_factory=list)


def _lower_contains_call(node):
    """contains(part_var, "lit") → (needle, stream, ci) | "never" | None."""
    if not (node[0] == "call" and node[1] == "contains" and len(node[2]) == 2):
        return None
    hay, needle = node[2]
    loc = _part_stream_of_var(hay)
    if not (loc and needle[0] == "lit" and isinstance(needle[1], str)):
        return None
    stream, wrap = loc
    data = needle[1].encode()
    if len(data) == 0:
        return None
    if wrap is None:
        return (data, stream, False)
    if wrap == "lower":
        # an uppercase needle can never occur in a lowercased haystack
        return (data, stream, True) if data == data.lower() else "never"
    return (data.lower(), stream, True) if data == data.upper() else "never"


def _contains_equiv(node):
    """Substring-equivalence of a dsl node: a list of (needle, stream,
    ci) tuples whose OR is *exactly* the node's value, or "never"
    (statically False), or None (no equivalence).

    Covers contains() calls and pure-literal regex()/=~ applications —
    ``regex('(?i)x-frame-options', all_headers)`` is exactly a ci
    substring check, so security-header style matchers lower without
    any prefilter uncertainty.
    """
    c = _lower_contains_call(node)
    if c is not None:
        return c if c == "never" else [c]
    if node[0] == "call" and node[1] == "regex" and len(node[2]) == 2:
        pat, hay = node[2]
    elif node[0] == "bin" and node[1] == "=~":
        hay, pat = node[2], node[3]
    else:
        return None
    if pat[0] != "lit" or not isinstance(pat[1], str):
        return None
    loc = _part_stream_of_var(hay)
    if loc is None:
        return None
    stream, wrap = loc
    full = full_literal_expansions(pat[1])
    if full is None:
        return None
    alts, pat_ci = full
    out = []
    for alt in alts:
        if pat_ci or wrap is None:
            # ci alternatives are pre-lowered; raw ones keep their case
            out.append((alt, stream, pat_ci))
        elif wrap == "lower":
            if alt != alt.lower():
                continue  # can't occur in a lowered haystack
            out.append((alt, stream, True))
        else:  # upper wrap, case-sensitive pattern
            if alt != alt.upper():
                continue
            out.append((alt.lower(), stream, True))
    return out if out else "never"


def _regex_conjunct_prefilter(node):
    """regex("pat", part_var) / part_var =~ "pat" → one contains tuple
    when the pattern has a singleton required-literal set (prog.contains
    entries are AND-reduced, so only singletons are expressible)."""
    if node[0] == "call" and node[1] == "regex" and len(node[2]) == 2:
        pat, hay = node[2]
    elif node[0] == "bin" and node[1] == "=~":
        hay, pat = node[2], node[3]
    else:
        return None
    if pat[0] != "lit" or not isinstance(pat[1], str):
        return None
    loc = _part_stream_of_var(hay)
    if loc is None:
        return None
    stream, _wrap = loc  # tolower/toupper wrap is moot: probe is lowered
    lits = required_literal_set(pat[1])
    if lits is None or len(lits) != 1:
        return None
    return (lits[0], stream, True)


def _lower_negated_contains_conj(node):
    """``!contains(a) && !contains(b) && …`` → the [a, b, …] slot list
    (the value is NOT(a || b || …)); None if any conjunct differs.
    A "never" branch (statically-absent needle) drops out: !never ≡ True
    is the AND identity."""
    if node[0] == "bin" and node[1] == "&&":
        lhs = _lower_negated_contains_conj(node[2])
        if lhs is None:
            return None
        rhs = _lower_negated_contains_conj(node[3])
        if rhs is None:
            return None
        return lhs + rhs
    if node[0] == "un" and node[1] == "!":
        eq = _contains_equiv(node[2])
        if eq is None:
            return None
        return [] if eq == "never" else eq
    return None


def _lower_or_contains(node):
    """Flatten an ||-tree of contains() calls to its slot list, or None
    if the tree has any other node. Statically-false branches drop out
    (OR identity); an all-false tree returns []."""
    if node[0] == "bin" and node[1] == "||":
        lhs = _lower_or_contains(node[2])
        if lhs is None:
            return None
        rhs = _lower_or_contains(node[3])
        if rhs is None:
            return None
        return lhs + rhs
    eq = _contains_equiv(node)
    if eq is None:
        return None
    return [] if eq == "never" else eq


_CMP_OPS = {"==": SOP_EQ, "!=": SOP_NE, "<": SOP_LT, ">": SOP_GT, "<=": SOP_LE, ">=": SOP_GE}
_SWAP = {SOP_LT: SOP_GT, SOP_GT: SOP_LT, SOP_LE: SOP_GE, SOP_GE: SOP_LE}


def _scalar_var(node) -> Optional[int]:
    if node[0] == "var" and node[1] == "status_code":
        return SV_STATUS
    if node[0] == "var" and node[1] == "content_length":
        return SV_CONTENT_LENGTH
    if node[0] == "call" and node[1] == "len" and len(node[2]) == 1:
        inner = node[2][0]
        if inner[0] == "var":
            return {
                "body": SV_LEN_BODY,
                "header": SV_LEN_HEADER,
                "all_headers": SV_LEN_HEADER,
                "raw": SV_LEN_ALL,
            }.get(inner[1])
    return None


def _part_stream_of_var(node) -> Optional[tuple[str, Optional[str]]]:
    """(stream, case_wrap) for body/header vars; case_wrap ∈ {None,
    'lower', 'upper'} from a tolower()/toupper() wrapper."""
    wrap: Optional[str] = None
    while node[0] == "call" and node[1] in ("tolower", "toupper") and len(node[2]) == 1:
        wrap = "lower" if node[1] == "tolower" else "upper"
        node = node[2][0]
    if node[0] == "var":
        stream = {
            "body": "body",
            "header": "header",
            "all_headers": "header",
            "raw": "all",
            # OOB interaction vars lower onto their own (tiny) streams
            # — e.g. contains(interactsh_protocol, "dns") in
            # cves/2022/CVE-2022-26134.yaml-style dsl matchers
            "interactsh_protocol": "oobp",
            "interactsh_request": "oobr",
        }.get(node[1])
        if stream:
            return stream, wrap
    return None


_HASH_FNS = ("md5", "sha1", "sha256", "mmh3")


def lower_dsl(ast) -> Optional[ScalarProgram]:
    """Lower one dsl expression to a scalar program.

    Top-level conjuncts that fit the supported shape (scalar compares,
    contains/part-equality, hash equality, negated contains) lower
    exactly. Any other conjunct is *dropped*, keeping its required
    literal (if one exists) as a contains prefilter and flagging
    ``residue`` — the program is then a sound necessary condition whose
    fired rows are host-confirmed per matcher (sound under negation
    too: uncertainty is captured pre-negation, and a non-fired superset
    is exactly False pre-negation). None is only returned for
    whole-expression shapes with no conjunctive form (handled by the
    or-shape branches below returning None).
    """
    prog = ScalarProgram(conjuncts=[], contains=[])

    def handle(node) -> bool:
        ok = handle_exact(node)
        if not ok:
            # Drop the conjunct, keep its required literal (if any) as
            # a contains prefilter, and flag the residue: the lowered
            # program is a sound necessary condition whose fired rows
            # are host-confirmed PER MATCHER (m_residue & fired ⇒
            # m_unc) — this keeps one exotic conjunct from demoting a
            # whole op to the host-confirmed prefilter path. Sound for
            # negated matchers too: uncertainty is captured
            # pre-negation, and a non-fired superset is exactly False
            # pre-negation.
            c = _regex_conjunct_prefilter(node)
            if c is not None:
                prog.contains.append(c)
            prog.residue = True
            return True
        return ok

    def handle_exact(node) -> bool:
        if node[0] == "bin" and node[1] == "&&":
            return handle(node[2]) and handle(node[3])
        if node[0] == "bin" and node[1] in _CMP_OPS:
            op = _CMP_OPS[node[1]]
            lhs, rhs = node[2], node[3]
            for a, b, swapped in ((lhs, rhs, False), (rhs, lhs, True)):
                var = _scalar_var(a)
                if var is not None and b[0] == "lit" and isinstance(b[1], (int, float)):
                    real_op = _SWAP.get(op, op) if swapped else op
                    prog.conjuncts.append((var, real_op, float(b[1])))
                    return True
            # whole-part string equality:  body == "literal"  — exactly
            # len(part)==len(lit) AND contains(part, lit) (a substring
            # of equal length IS the part). The evaluator compares
            # utf-8 bytes (_cmp_coerce/_to_bytes) and tolower is ASCII
            # bytes.lower(), both matching the device streams.
            if op == SOP_EQ:
                for a, b in ((lhs, rhs), (rhs, lhs)):
                    loc = _part_stream_of_var(a)
                    if not (
                        loc and b[0] == "lit" and isinstance(b[1], str)
                    ):
                        continue
                    stream, wrap = loc
                    data = b[1].encode("utf-8", "surrogateescape")
                    if wrap == "lower" and data != data.lower():
                        prog.never = True  # uppercase can't survive
                        return True
                    if wrap == "upper" and data != data.upper():
                        prog.never = True
                        return True
                    lenvar = {
                        "body": SV_LEN_BODY,
                        "header": SV_LEN_HEADER,
                        "all": SV_LEN_ALL,
                    }.get(stream)
                    if lenvar is None:
                        # no scalar length var for this stream (oob):
                        # can't express whole-part equality exactly —
                        # drop to the residue path
                        continue
                    prog.conjuncts.append(
                        (lenvar, SOP_EQ, float(len(data)))
                    )
                    if data:
                        prog.contains.append(
                            (
                                data.lower() if wrap else data,
                                stream,
                                wrap is not None,
                            )
                        )
                    return True
            # hash equality:  md5(body) == "…"  (either side). The
            # md5-of-plain-body shape lowers to the on-device digest
            # compare (ops/md5.py) — exact; other hash fns / wrapped
            # args stay residues (host confirms fired rows).
            for a, b in ((lhs, rhs), (rhs, lhs)):
                if (
                    op == SOP_EQ
                    and a[0] == "call"
                    and a[1] in _HASH_FNS
                    and b[0] == "lit"
                    and isinstance(b[1], str)
                ):
                    digest = None
                    if (
                        a[1] == "md5"
                        and list(a[2]) == [("var", "body")]
                        and re.fullmatch(r"[0-9a-fA-F]{32}", b[1])
                    ):
                        digest = bytes.fromhex(b[1].lower())
                    if digest is not None:
                        if prog.md5 is not None and prog.md5 != digest:
                            prog.never = True  # two different body digests
                        prog.md5 = digest
                    else:
                        prog.residue = True
                    return True
            return False
        if node[0] == "un" and node[1] == "!":
            # negated substring conjunct: !contains(...) / !regex('lit')
            # ≡ "none of the needles present" — slot bits are exact, so
            # negation is exact (per-matcher neg_contains bucket)
            eq = _contains_equiv(node[2])
            if eq == "never":
                return True  # !False — vacuous conjunct
            if eq is not None:
                prog.neg_contains.extend(eq)
                return True
            return False
        eq = _contains_equiv(node)
        if eq is not None:
            if eq == "never":
                prog.never = True
                return True
            if len(eq) == 1:
                prog.contains.append(eq[0])
                return True
            # an embedded multi-alternative OR can't sit in the AND
            # bucket — only the whole-expression or-shape handles it
            return False
        return False

    # the whole expression is an OR over contains() calls — exactly an
    # OR-reduced slot bucket (jsf-detection-style fingerprint dsl)
    ors = _lower_or_contains(ast)
    if ors is not None:
        if not ors:
            return ScalarProgram(conjuncts=[], contains=[], never=True)
        # a singleton stays conjunctive so AND-merging keeps working
        return ScalarProgram(conjuncts=[], contains=ors, any_of=len(ors) > 1)

    # De Morgan: !contains(a) [&& !contains(b)…] ≡ NOT(a || b) — an
    # OR-reduced bucket under matcher-level negation (exact, since the
    # slots themselves are byte-verified)
    negs = _lower_negated_contains_conj(ast)
    if negs is not None:
        if not negs:
            # every negated branch is statically absent ⇒ always True
            return ScalarProgram(conjuncts=[], contains=[])
        return ScalarProgram(
            conjuncts=[], contains=negs, any_of=True, negated=True
        )

    handle(ast)  # always succeeds: unsupported conjuncts drop to residue
    if len(prog.conjuncts) > MAX_SCALAR_CONJUNCTS:
        # dropping conjuncts keeps the necessary-condition property;
        # the residue flag host-confirms fired rows per matcher
        prog.conjuncts = prog.conjuncts[:MAX_SCALAR_CONJUNCTS]
        prog.residue = True
    return prog


def _merge_dsl_progs(
    progs: list[ScalarProgram], condition: str, superset: bool = False
) -> Optional[ScalarProgram]:
    """Merge one program per dsl expression under the matcher's
    expression-list condition. Exact when the shapes allow it; with
    ``superset=True`` an OR-list weakens each branch to its most
    selective contains (a sound necessary condition), never failing
    unless some branch has no contains at all."""
    if len(progs) == 1:
        return progs[0]
    if condition == "and":
        if any(p.never for p in progs):
            return ScalarProgram(conjuncts=[], contains=[], never=True)
        negated = [p for p in progs if p.negated]
        plain = [p for p in progs if not p.negated]
        if negated and not plain:
            # !(A) && !(B) ≡ !(A ∪ B): one OR bucket under negation
            return ScalarProgram(
                conjuncts=[],
                contains=[c for p in negated for c in p.contains],
                any_of=True,
                negated=True,
            )
        if negated and not any(p.residue for p in negated):
            # a negated-OR branch is exactly a neg_contains conjunct:
            # NOT(OR(needles)) ≡ "none present" — fold it into the AND
            # bucket instead of failing the merge (the
            # missing-security-headers matcher shape: !regex(lit) in
            # one expression, scalar compares in the next)
            fold = ScalarProgram(
                conjuncts=[],
                contains=[],
                neg_contains=[c for p in negated for c in p.contains],
            )
            plain = plain + [fold]
            negated = []
        if negated or any(p.any_of for p in plain):
            # negated/OR-group members can't fold into the AND bucket;
            # superset mode drops them (widening an AND is sound)
            if not superset:
                return None
            plain = [p for p in plain if not p.any_of]
            out = _merge_dsl_progs(
                plain or [ScalarProgram(conjuncts=[], contains=[])],
                "and",
                superset=True,
            )
            out.residue = True
            return out
        out = ScalarProgram(conjuncts=[], contains=[])
        for p in plain:
            out.conjuncts += p.conjuncts
            out.contains += p.contains
            out.neg_contains += p.neg_contains
            out.residue |= p.residue
            if p.md5 is not None:
                if out.md5 is not None and out.md5 != p.md5:
                    out.never = True
                out.md5 = p.md5
        if len(out.conjuncts) > MAX_SCALAR_CONJUNCTS:
            if not superset:
                return None
            out.conjuncts = out.conjuncts[:MAX_SCALAR_CONJUNCTS]
            out.residue = True
        return out
    # condition "or"
    live = [p for p in progs if not p.never]
    if not live:
        return ScalarProgram(conjuncts=[], contains=[], never=True)
    if any(
        not p.contains
        and not p.conjuncts
        and not p.residue
        and p.md5 is None
        and not p.neg_contains
        for p in live
    ):
        # an always-True branch (e.g. every negated needle statically
        # absent) makes the whole OR always True
        return ScalarProgram(conjuncts=[], contains=[])
    if any(p.negated for p in live):
        return None  # !(…) under OR has no bucket form
    if all(
        not p.conjuncts
        and not p.residue
        and p.md5 is None
        and not p.neg_contains
        # AND-reduced multi-contains branches can't flatten into an OR
        and (p.any_of or len(p.contains) == 1)
        for p in live
    ):
        return ScalarProgram(
            conjuncts=[],
            contains=[c for p in live for c in p.contains],
            any_of=True,
        )
    if not superset:
        return None
    picked = []
    for p in live:
        if not p.contains:
            return None  # a literal-less OR branch widens to always-True
        if p.any_of:
            # the branch is itself an OR: every member must stay (the
            # union is the branch's necessary condition)
            picked.extend(p.contains)
        else:
            # AND branch: any single member is a sound weakening
            picked.append(max(p.contains, key=lambda c: len(c[0])))
    return ScalarProgram(conjuncts=[], contains=picked, any_of=True, residue=True)


# ---------------------------------------------------------------------------
# The compiled database
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WordTable:
    """One (stream, case, gram-size) hash table.

    A window hit must match the entry's (h1, h2) *and* the word's
    suffix-gram hashes at position ``pos + suf_delta`` — 128 hash bits
    total, computed entirely from the rolling-hash arrays the kernel
    already has (no byte gathers). Hits are still marked *uncertain*
    and host-confirmed, so a hash collision can never corrupt a verdict;
    the hashes exist to make candidate traffic ≈ true-hit traffic.
    """

    stream: str
    lowered: bool
    q: int
    group_h1: np.ndarray  # uint32 [G] sorted unique
    entry_start: np.ndarray  # int32 [G]
    entry_count: np.ndarray  # int32 [G]
    entry_h2: np.ndarray  # uint32 [E]
    entry_slot: np.ndarray  # int32 [E]
    entry_off: np.ndarray  # int32 [E] gram offset within the slot bytes
    entry_len: np.ndarray  # int32 [E] true word length
    entry_suf_delta: np.ndarray  # int32 [E] = (len - q) - off  (suffix pos - window pos)
    entry_suf_h1: np.ndarray  # uint32 [E]
    entry_suf_h2: np.ndarray  # uint32 [E]
    bloom: np.ndarray  # uint32 [BLOOM_WORDS]
    max_group: int = 1

    @property
    def num_groups(self) -> int:
        return int(self.group_h1.shape[0])


@dataclasses.dataclass
class IndexBucket:
    """One width-class of a ragged index table.

    ``rows[i]`` owns ``idx[i, :width]``; rows with fewer real entries are
    padded by repeating their first entry (neutral for both AND and OR
    reductions).
    """

    width: int
    rows: np.ndarray  # int32 [NB] — owner ids (matcher / op / template)
    idx: np.ndarray  # int32 [NB, width]


def bucket_ragged(ragged: list[list[int]], owner_count: int) -> list[IndexBucket]:
    """Ragged owner→members lists → power-of-two width buckets.

    Total gather volume stays Σ|members| × (≤2) instead of
    owners × max(|members|).
    """
    by_width: dict[int, list[tuple[int, list[int]]]] = {}
    for owner, members in enumerate(ragged):
        if not members:
            continue
        width = 1
        while width < len(members):
            width *= 2
        by_width.setdefault(width, []).append((owner, members))
    buckets = []
    for width in sorted(by_width):
        rows = np.array([o for o, _ in by_width[width]], dtype=np.int32)
        idx = np.zeros((len(rows), width), dtype=np.int32)
        for i, (_o, members) in enumerate(by_width[width]):
            for j in range(width):
                idx[i, j] = members[j] if j < len(members) else members[0]
        buckets.append(IndexBucket(width=width, rows=rows, idx=idx))
    return buckets


@dataclasses.dataclass
class CompiledDB:
    # --- word slots ---
    slot_bytes: np.ndarray  # uint8 [NW, VERIFY_WIDTH] (lowered for ci slots)
    slot_len: np.ndarray  # int32 [NW] true length (may exceed VERIFY_WIDTH)
    slot_long: np.ndarray  # bool [NW] — len > VERIFY_WIDTH ⇒ hit is uncertain
    tables: list[WordTable]
    # tiny slots, dense path: per (stream, lowered) padded byte matrix
    tiny_bytes: np.ndarray  # uint8 [NTINY, TINY_MAX]
    tiny_len: np.ndarray  # int32 [NTINY]
    tiny_slot: np.ndarray  # int32 [NTINY]
    tiny_stream: np.ndarray  # int32 [NTINY] index into STREAMS
    tiny_lowered: np.ndarray  # bool [NTINY]

    # --- matchers ---
    m_kind: np.ndarray  # int32 [NM]
    m_negative: np.ndarray  # bool [NM]
    m_cond_and: np.ndarray  # bool [NM]
    m_slot_buckets: list  # list[IndexBucket] matcher → word-slot ids
    # negated-contains bucket: matcher requires NONE of these slots to
    # be present (http-missing-security-headers-style dsl conjuncts)
    m_negslot_buckets: list  # list[IndexBucket] matcher → word-slot ids
    m_scalar: np.ndarray  # float32 [NM, MAX_SCALAR_CONJUNCTS, 3] (var, op, val)
    m_residue: np.ndarray  # bool [NM] — scalar pass still needs host confirm
    # device md5 digest equality (ops/md5.py): md5(body) == digest
    m_md5: np.ndarray  # uint32 [NM, 4] little-endian digest words
    m_md5_check: np.ndarray  # bool [NM]

    # --- device regex verify (ops/regexdev.py) ---
    # matchers whose every pattern compiled to linear shift-and
    # programs: fired rows re-check exactly on device, no host confirm
    rx_m_ids: np.ndarray  # int32 [NRXM] device matcher ids
    rx_seq_slot_buckets: list  # list[IndexBucket] seq → gate slot ids
    rx_seq_always: np.ndarray  # bool [NSEQ] — no gate: scan every row
    rx_seq_matcher: np.ndarray  # int32 [NSEQ] → index into rx_m_ids
    rx_seq_stream: np.ndarray  # int32 [NSEQ] index into STREAMS
    rx_seq_ci: np.ndarray  # bool [NSEQ] — run on the lowered stream
    rx_classes: np.ndarray  # uint32 [NSEQ, RX_MAX_M, 8] byte-class bitmaps
    rx_bytemap: np.ndarray  # uint32 [NSEQ, 256, L] byte → state-lane bits
    rx_m_count: np.ndarray  # int32 [NSEQ] positions used
    rx_seed: np.ndarray  # uint32 [NSEQ, L] start-closure mask
    rx_skip: np.ndarray  # uint32 [NSEQ, L] skippable positions
    rx_accept: np.ndarray  # uint32 [NSEQ, L] accepting positions
    rx_self: np.ndarray  # uint32 [NSEQ, L] self-loop positions
    rx_anchored: np.ndarray  # bool [NSEQ] — \A/^: seed only at byte 0
    rx_end_mode: np.ndarray  # int32 [NSEQ] — regexlin.END_* ($ / \Z)
    rx_start_wb: np.ndarray  # bool [NSEQ] — leading \b seed guard
    rx_end_wb: np.ndarray  # bool [NSEQ] — trailing \b accept guard
    rx_max_skip_run: int
    m_status: np.ndarray  # int32 [NM, MAX_STATUS] (pad = -1)
    m_size: np.ndarray  # int32 [NM, MAX_STATUS] (pad = -1)
    m_size_stream: np.ndarray  # int32 [NM] stream index for size matchers

    # --- operations & templates ---
    op_cond_and: np.ndarray  # bool [NOP]
    op_prefilter: np.ndarray  # bool [NOP] — superset-lowered: fired ⇒ host confirm
    op_m_buckets: list  # list[IndexBucket] op → matcher ids
    t_op_buckets: list  # list[IndexBucket] template → op ids
    t_prefilter: np.ndarray  # bool [NT] — any op superset-lowered (reporting)

    # host-side provenance (sparse confirmation, engine.py): device ids
    # back to source template/operation/matcher indices + ragged lists
    m_src: np.ndarray  # int32 [NM, 3] (template_idx, op_local, matcher_local)
    # (extractor_local, pattern_idx) for synthesized per-pattern
    # extraction prefilters; (-1, -1) for everything else
    m_ext_src: np.ndarray  # int32 [NM, 2]
    op_src: np.ndarray  # int32 [NOP, 2] (template_idx, op_local)
    op_matchers: list  # list[list[int]] op id → device matcher ids
    t_ops: list  # list[list[int]] template id → device op ids

    template_ids: list  # str [NT] — device-evaluated templates
    host_always: list  # list[Template] — exact-CPU-only tail
    templates: list  # the NT Template objects (for host confirmation)
    stats: dict

    # --- workflow DAG gate planes (docs/WORKFLOWS.md) ---
    # class-attribute default so pre-workflow dbcache pickles unpickle
    # to a plan-less db (engine then keeps the host twin for workflows)
    wf: Optional["WorkflowPlan"] = None

    def __getstate__(self):
        # the derived device layout (build_device_layout cache) must
        # not ride dbcache pickles: it duplicates every array and is
        # cheap to rebuild per process
        state = dict(self.__dict__)
        state.pop("_device_layout", None)
        return state

    @property
    def num_slots(self) -> int:
        return int(self.slot_bytes.shape[0])

    @property
    def num_templates(self) -> int:
        return len(self.template_ids)

    def rx_k_pairs(self, batch_rows: int) -> int:
        """Regex-verify compaction budget for one batch: up to 8 gated
        fires per row plus every always-on sequence's guaranteed row.
        Shared by the single-chip and sharded paths so overflow (and
        therefore host-confirm volume) behaves identically."""
        return (8 + int(self.rx_seq_always.sum())) * batch_rows


# ---------------------------------------------------------------------------
# Workflow DAG lowering (docs/WORKFLOWS.md)
# ---------------------------------------------------------------------------
# A workflow's trigger→subtemplate DAG flattens to DNF: every leaf emit
# (workflow id, reported template id) is reached through one or more
# conjunctions of *conditions* — trigger hits and named-matcher gates.
# Conditions reference the verdict planes eval_verdicts already builds,
# so the gate-apply stage is a gather + Kleene AND/OR over the batch.

#: condition kinds (cond_kind values)
WFC_HIT_DEV = 0  # device template verdict column (cond_idx = t_idx)
WFC_OP = 1  # device operation verdict (AND-op gate: op ⇒ matcher)
WFC_MATCHER = 2  # device matcher verdict (OR-op gate: matcher ⇒ op)
WFC_HIT_HOST = 3  # template not device-lowered — host hit set decides
WFC_GATE_HOST = 4  # gate needs the exact CPU oracle (cpu_ref names)

#: DNF shape caps — a workflow that exceeds them is NOT device-lowered
#: (it stays on the bit-identical host twin), never silently truncated
WF_MAX_CONDS = 8  # conditions per term (bounds DAG nesting depth)
WF_MAX_TERMS = 4096  # corpus-wide term budget
WF_MAX_TERMS_PER_WF = 512  # per-workflow fan-out budget


@dataclasses.dataclass
class WorkflowPlan:
    """Device-resident workflow gate tables (one per CompiledDB).

    Kleene semantics ride the existing verdict planes: a term is
    certainly-false as soon as one cond is certainly-false (the
    dominant no-trigger case — decided on device), certainly-true only
    when every cond is certainly-true; host kinds (3/4) are
    (False, uncertain) on device and resolved per row at condition
    granularity by the runner.
    """

    cond_kind: np.ndarray  # int32 [NC] — WFC_*
    cond_idx: np.ndarray  # int32 [NC] — t/op/m id (-1 for host kinds)
    cond_template: list  # str [NC] — source template id
    cond_name: list  # str [NC] — gate name ("" for hit conds)
    term_cond: np.ndarray  # int32 [NTERM, WF_MAX_CONDS] — pad -1 = TRUE
    term_emit: np.ndarray  # int32 [NTERM] — emit column this term sets
    emits: list  # [(workflow_id, template_id)] [NE]
    workflow_ids: list  # str — workflows lowered onto the device
    host_only_ids: list  # str — workflows the host twin still owns
    stats: dict

    @property
    def num_conds(self) -> int:
        return int(self.cond_kind.shape[0])

    @property
    def num_terms(self) -> int:
        return int(self.term_cond.shape[0])

    @property
    def num_emits(self) -> int:
        return len(self.emits)


def _empty_workflow_plan(host_only_ids: list, stats: dict) -> WorkflowPlan:
    return WorkflowPlan(
        cond_kind=np.zeros((0,), dtype=np.int32),
        cond_idx=np.zeros((0,), dtype=np.int32),
        cond_template=[],
        cond_name=[],
        term_cond=np.zeros((0, WF_MAX_CONDS), dtype=np.int32),
        term_emit=np.zeros((0,), dtype=np.int32),
        emits=[],
        workflow_ids=[],
        host_only_ids=host_only_ids,
        stats=stats,
    )


class _WfBail(Exception):
    """A workflow blew a DNF cap — fall back to the host twin."""


def lower_workflows(all_templates: list, db: "CompiledDB") -> WorkflowPlan:
    """Flatten every workflow DAG into the device gate tables.

    Gate decomposition mirrors ``cpu_ref`` name semantics exactly (a
    name fires iff its matcher individually matched AND its operation
    matched): AND-condition op ⇒ the op verdict suffices; OR-condition
    op ⇒ the matcher verdict suffices. Any alternative that is not
    device-exact demotes the WHOLE gate to one ``WFC_GATE_HOST`` cond —
    host resolution computes full gate truth anyway, and mixing exact
    and host alternatives would double-count terms.
    """
    from swarm_tpu_torch.fingerprints.workflows import TemplateIndex, parse_workflow

    workflows = [
        parse_workflow(t) for t in all_templates if t.protocol == "workflow"
    ]
    if not workflows:
        return _empty_workflow_plan([], {"workflows_total": 0})
    index = TemplateIndex(
        [t for t in all_templates if t.protocol != "workflow"]
    )
    tidx_of = {t.id: i for i, t in enumerate(db.templates)}
    op_of: dict[tuple, int] = {}
    for op_id in range(db.op_src.shape[0]):
        op_of[(int(db.op_src[op_id, 0]), int(db.op_src[op_id, 1]))] = op_id
    m_of: dict[tuple, int] = {}
    for m_id in range(db.m_src.shape[0]):
        ti, ol, ml = (int(x) for x in db.m_src[m_id])
        if ml >= 0:
            m_of[(ti, ol, ml)] = m_id

    cond_rows: list[tuple[int, int, str, str]] = []
    cond_index: dict[tuple, int] = {}

    def cond_id(kind: int, idx: int, tid: str, name: str = "") -> int:
        key = (kind, idx, tid, name)
        ci = cond_index.get(key)
        if ci is None:
            ci = len(cond_rows)
            cond_index[key] = ci
            cond_rows.append(key)
        return ci

    def hit_cond(t) -> int:
        ti = tidx_of.get(t.id)
        if ti is None:
            return cond_id(WFC_HIT_HOST, -1, t.id)
        return cond_id(WFC_HIT_DEV, ti, t.id)

    def gate_alts(t, name: str):
        """→ list of alternative cond ids (ORed via term duplication),
        or None when no matcher carries the name (dead gate)."""
        found = False
        host = False
        alts: list[int] = []
        ti = tidx_of.get(t.id)
        for ol, op in enumerate(t.operations):
            for ml, m in enumerate(op.matchers):
                if m.name != name:
                    continue
                found = True
                if ti is None:
                    host = True
                    continue
                op_id = op_of.get((ti, ol))
                if op_id is None:
                    host = True  # op not lowered (e.g. extractor-only)
                elif (op.matchers_condition or "or").lower() == "and":
                    # AND op: op fired ⇒ every matcher fired ⇒ name
                    alts.append(cond_id(WFC_OP, op_id, t.id, name))
                elif bool(db.op_prefilter[op_id]):
                    # superset-lowered op: per-matcher bits weakened
                    host = True
                else:
                    m_id = m_of.get((ti, ol, ml))
                    if m_id is None:
                        host = True
                    else:
                        alts.append(cond_id(WFC_MATCHER, m_id, t.id, name))
        if not found:
            return None
        if host or not alts:
            return [cond_id(WFC_GATE_HOST, -1, t.id, name)]
        return alts

    # (sorted cond tuple, (workflow_id, template_id)) — dedup via set
    term_list: list[tuple[tuple, tuple]] = []
    term_seen: set = set()
    workflow_ids: list = []
    host_only_ids: list = []
    steps_compiled = 0

    for wf in workflows:
        wf_terms: list[tuple[tuple, tuple]] = []

        def add_term(conds: list, tid: str, _wf=wf, _acc=wf_terms) -> None:
            cs = tuple(sorted(set(conds)))
            if len(cs) > WF_MAX_CONDS or len(_acc) >= WF_MAX_TERMS_PER_WF:
                raise _WfBail()
            _acc.append((cs, (_wf.id, tid)))

        def walk_ref(ref, conds: list) -> None:
            for t in index.resolve(ref):
                base = conds + [hit_cond(t)]
                if ref.matchers:
                    for gate in ref.matchers:
                        alts = gate_alts(t, gate.name)
                        if alts is None:
                            continue
                        for a in alts:
                            for sub in gate.subtemplates:
                                walk_ref(sub, base + [a])
                elif ref.subtemplates:
                    for sub in ref.subtemplates:
                        walk_ref(sub, base)
                else:
                    add_term(base, t.id)

        try:
            for step in wf.steps:
                triggers = []
                if step.template:
                    t = index.by_path(step.template)
                    if t is not None:
                        triggers.append(t)
                for tag in step.tags:
                    triggers.extend(index.by_tag.get(tag.lower(), []))
                for trigger in triggers:
                    base = [hit_cond(trigger)]
                    if step.matchers:
                        for gate in step.matchers:
                            alts = gate_alts(trigger, gate.name)
                            if alts is None:
                                continue
                            for a in alts:
                                for ref in gate.subtemplates:
                                    walk_ref(ref, base + [a])
                    elif step.subtemplates:
                        for ref in step.subtemplates:
                            walk_ref(ref, base)
                    else:
                        add_term(base, trigger.id)
            if len(term_list) + len(wf_terms) > WF_MAX_TERMS:
                raise _WfBail()
        except _WfBail:
            host_only_ids.append(wf.id)
            continue
        workflow_ids.append(wf.id)
        steps_compiled += len(wf.steps)
        for entry in wf_terms:
            if entry not in term_seen:
                term_seen.add(entry)
                term_list.append(entry)

    stats = {
        "workflows_total": len(workflows),
        "workflows_device": len(workflow_ids),
        "workflows_host_only": len(host_only_ids),
        "steps_compiled": steps_compiled,
        "terms": len(term_list),
    }
    if not term_list:
        return _empty_workflow_plan(host_only_ids, stats)

    # compact to the conds actually referenced (bailed workflows may
    # have allocated strays) and allocate emit columns
    used = sorted({c for cs, _ in term_list for c in cs})
    remap = {c: i for i, c in enumerate(used)}
    emits: list = []
    emit_of: dict[tuple, int] = {}
    term_cond = np.full((len(term_list), WF_MAX_CONDS), -1, dtype=np.int32)
    term_emit = np.zeros((len(term_list),), dtype=np.int32)
    for row, (cs, emit_key) in enumerate(term_list):
        for j, c in enumerate(cs):
            term_cond[row, j] = remap[c]
        ei = emit_of.get(emit_key)
        if ei is None:
            ei = len(emits)
            emit_of[emit_key] = ei
            emits.append(emit_key)
        term_emit[row] = ei
    stats["conds"] = len(used)
    stats["emits"] = len(emits)
    return WorkflowPlan(
        cond_kind=np.array([cond_rows[c][0] for c in used], dtype=np.int32),
        cond_idx=np.array([cond_rows[c][1] for c in used], dtype=np.int32),
        cond_template=[cond_rows[c][2] for c in used],
        cond_name=[cond_rows[c][3] for c in used],
        term_cond=term_cond,
        term_emit=term_emit,
        emits=emits,
        workflow_ids=workflow_ids,
        host_only_ids=host_only_ids,
        stats=stats,
    )


def wf_arrays_np(plan: WorkflowPlan) -> dict:
    """The workflow gate tables as one host pytree (the wf sub-layout
    of the verdict arguments). Host kinds gather with a clipped index
    and are masked to (False, uncertain) by ``cond_host``."""
    return {
        "cond_kind": plan.cond_kind,
        "cond_idx": np.maximum(plan.cond_idx, 0).astype(np.int32),
        "cond_host": (plan.cond_kind >= WFC_HIT_HOST),
        "term_cond": plan.term_cond,
        "term_emit": plan.term_emit,
        # zeros of shape [NE]: gives the kernel a static emit width
        "emit_pad": np.zeros((plan.num_emits,), dtype=np.bool_),
    }


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


class _SlotSpace:
    """Dedup (bytes, stream, lowered) → slot id."""

    def __init__(self) -> None:
        self.index: dict[tuple[bytes, str, bool], int] = {}
        self.entries: list[tuple[bytes, str, bool]] = []

    def get(self, data: bytes, stream: str, lowered: bool) -> int:
        if lowered:
            data = bytes(lower_bytes_np(np.frombuffer(data, np.uint8)).tobytes()) if data else data
        key = (data, stream, lowered)
        slot = self.index.get(key)
        if slot is None:
            slot = len(self.entries)
            self.index[key] = slot
            self.entries.append(key)
        return slot


def _word_payloads(matcher: Matcher) -> Optional[list[bytes]]:
    if matcher.type == "word":
        return [w.encode("utf-8", "surrogateescape") for w in matcher.words]
    if matcher.type == "binary":
        out = []
        for hexstr in matcher.binary:
            try:
                out.append(binascii.unhexlify(re.sub(r"\s", "", hexstr)))
            except (binascii.Error, ValueError):
                return None
        return out
    return None


# ---------------------------------------------------------------------------
# Device layout: corpus arrays as jit ARGUMENTS (stacked table-major)
# ---------------------------------------------------------------------------
#
# The match kernel used to capture every corpus array as an XLA constant
# (jnp.asarray inside the traced function): each padded-width bucket
# then compiled a corpus-sized program (~2 min compiles, constant-fold
# alarms, one big executable per shape, cold persistent cache across
# corpus refreshes). The layout below is the other calling convention:
# every array the kernel reads, gathered into ONE host pytree that
# DeviceDB / ShardedMatcher upload to the device once and pass as jit
# arguments on every call — the traced program is corpus-size-free, so
# one executable serves every corpus and the XLA cache keys stop
# depending on the corpus bytes. (The arrays are NOT donated: they are
# reused by every subsequent call, donation would invalidate them.)
#
# Word tables ship in a stacked TABLE-MAJOR layout ([T, Gmax]/[T, Emax]
# with sentinel padding, exactly the scheme parallel/sharded.py already
# uses per rank) so the kernel's prefilter runs over all tables at once
# instead of a per-table Python loop.


#: base rung of the survivor-compaction bucket ladder (ops/match.py,
#: docs/DEVICE_MATCH.md): phase B launches at the smallest power-of-two
#: candidate width that covers the batch's survivors, so a sparse fleet
#: batch (typically 0-2 fired windows per row) verifies at width 8
#: instead of the worst-case global budget. Power-of-two rungs bound the
#: live phase-B executable count at log2(budget / 8) + 1 per shape
#: class.
SURVIVOR_LADDER_MIN = 8


def survivor_bucket(n_survivors: int, budget: int) -> int:
    """Phase-B candidate width for a batch whose worst row fired
    ``n_survivors`` windows: the smallest ladder rung covering them,
    clamped to the global candidate ``budget`` (rows past the budget
    overflow to the host row-redo — the exactness escape hatch, so a
    width above the budget could never matter)."""
    k = SURVIVOR_LADDER_MIN
    while k < n_survivors:
        k <<= 1
    return max(1, min(k, budget))


@dataclasses.dataclass(frozen=True)
class DeviceLayoutMeta:
    """Static (trace-time) facts about a CompiledDB — everything the
    argument-driven kernel needs for control flow, none of it traced.
    Hashable so it can key jit caches if ever needed."""

    table_stream: tuple  # per table: stream name
    table_lowered: tuple  # per table: probe the lowered stream
    table_q: tuple  # per table: gram size
    max_group: int  # global verify unroll bound (max over tables)
    tiny: tuple  # per tiny slot: (length, stream name, lowered)
    has_md5: bool
    n_rx: int  # len(db.rx_m_ids)


def scalar_onehot_np(m_scalar: np.ndarray) -> np.ndarray:
    """[NCHECKS, NM, C] bool one-hot of the scalar-program op ids,
    computed ON HOST. Feeding this as an array (argument or ready-made
    constant) replaces the kernel's former per-op ``op_id == i``
    comparisons over the [NM, C] id plane — the ``pred[1,NM,C]`` reduce
    XLA's constant folder ground through on every compile
    (slow_operation_alarm, MULTICHIP_r05)."""
    op_id = m_scalar[:, :, 1].astype(np.int32)
    nchecks = SOP_TRUE + 1
    return np.stack([op_id == i for i in range(nchecks)])


def stack_tables_np(tables: list) -> dict:
    """WordTables → stacked table-major arrays with sentinel padding.

    Padding mirrors :func:`swarm_tpu_torch.parallel.sharded.shard_tables_np`:
    group_h1 pads with 0xFFFFFFFF and zero entry counts (a padded group
    can be "found" but yields no entries), entry_len pads with 2^30 (a
    padded entry can never fit in a stream). ``n_groups`` bounds the
    kernel's per-candidate binary search."""
    T = len(tables)
    gmax = max((t.num_groups for t in tables), default=0) or 1
    emax = max((int(t.entry_h2.shape[0]) for t in tables), default=0) or 1
    out = {
        "group_h1": np.full((max(T, 1), gmax), 0xFFFFFFFF, dtype=np.uint32),
        "entry_start": np.zeros((max(T, 1), gmax), dtype=np.int32),
        "entry_count": np.zeros((max(T, 1), gmax), dtype=np.int32),
        "entry_h2": np.zeros((max(T, 1), emax), dtype=np.uint32),
        "entry_slot": np.zeros((max(T, 1), emax), dtype=np.int32),
        "entry_off": np.zeros((max(T, 1), emax), dtype=np.int32),
        "entry_len": np.full((max(T, 1), emax), 1 << 30, dtype=np.int32),
        "entry_suf_delta": np.zeros((max(T, 1), emax), dtype=np.int32),
        "entry_suf_h1": np.zeros((max(T, 1), emax), dtype=np.uint32),
        "entry_suf_h2": np.zeros((max(T, 1), emax), dtype=np.uint32),
        "bloom": np.zeros(
            (max(T, 1), hashing.BLOOM_WORDS), dtype=np.uint32
        ),
        "n_groups": np.zeros((max(T, 1),), dtype=np.int32),
    }
    for t_idx, t in enumerate(tables):
        G = t.num_groups
        E = int(t.entry_h2.shape[0])
        out["group_h1"][t_idx, :G] = t.group_h1
        out["entry_start"][t_idx, :G] = t.entry_start
        out["entry_count"][t_idx, :G] = t.entry_count
        out["entry_h2"][t_idx, :E] = t.entry_h2
        out["entry_slot"][t_idx, :E] = t.entry_slot
        out["entry_off"][t_idx, :E] = t.entry_off
        out["entry_len"][t_idx, :E] = t.entry_len
        out["entry_suf_delta"][t_idx, :E] = t.entry_suf_delta
        out["entry_suf_h1"][t_idx, :E] = t.entry_suf_h1
        out["entry_suf_h2"][t_idx, :E] = t.entry_suf_h2
        out["bloom"][t_idx] = t.bloom
        out["n_groups"][t_idx] = G
    return out


def _bucket_arrays(buckets: list) -> tuple:
    """IndexBuckets → ((rows, idx), ...) array pairs (a pytree whose
    leaves the kernel gathers/scatters with — bucket COUNT and widths
    stay static via the array shapes)."""
    return tuple((b.rows, b.idx) for b in buckets)


def verdict_arrays_np(db: "CompiledDB") -> dict:
    """Every matcher/op/template array ``eval_verdicts`` reads, as one
    host pytree (the verdict half of the argument layout)."""
    kind = db.m_kind
    wf = getattr(db, "wf", None)
    out = {
        "m_cond_and": db.m_cond_and,
        "m_negative": db.m_negative,
        "m_residue": db.m_residue,
        "m_md5": db.m_md5,
        "m_md5_check": db.m_md5_check,
        "m_status": db.m_status,
        "m_size": db.m_size,
        "m_size_stream": db.m_size_stream.astype(np.int32),
        "scalar_var": db.m_scalar[:, :, 0].astype(np.int32),
        "scalar_cmp": db.m_scalar[:, :, 2].astype(np.float32),
        "scalar_onehot": scalar_onehot_np(db.m_scalar),
        "is_words": (kind == MK_WORDS) | (kind == MK_REGEX_PREFILTER),
        "is_rx_prefilter": kind == MK_REGEX_PREFILTER,
        "is_scalar": kind == MK_SCALAR_DSL,
        "is_status": kind == MK_STATUS,
        "is_size": kind == MK_SIZE,
        "m_slot_buckets": _bucket_arrays(db.m_slot_buckets),
        "m_negslot_buckets": _bucket_arrays(db.m_negslot_buckets),
        "op_cond_and": db.op_cond_and,
        "op_prefilter": db.op_prefilter,
        "op_m_buckets": _bucket_arrays(db.op_m_buckets),
        "t_op_buckets": _bucket_arrays(db.t_op_buckets),
        "rx_m_ids": db.rx_m_ids,
    }
    # workflow gate tables ride the same pytree — only when the corpus
    # actually lowered terms (keeps plan-less pytrees byte-identical)
    if wf is not None and wf.num_terms:
        out["wf"] = wf_arrays_np(wf)
    return out


def rx_variants(db: "CompiledDB") -> list:
    """Distinct (stream index, ci) pairs the rx sequences scan, in the
    canonical sorted order BOTH the static loop and ``var_of_seq``
    use — a single definition so they can never disagree."""
    return sorted(
        {(int(s), bool(c)) for s, c in zip(db.rx_seq_stream, db.rx_seq_ci)}
    )


def rx_arrays_np(db: "CompiledDB") -> dict:
    """Every array the device regex verify reads (ops/regexdev.py)."""
    variants = rx_variants(db)
    NSEQ = db.rx_seq_matcher.shape[0]
    var_of_seq = np.zeros((max(NSEQ, 1),), dtype=np.int32)
    for si in range(NSEQ):
        var_of_seq[si] = variants.index(
            (int(db.rx_seq_stream[si]), bool(db.rx_seq_ci[si]))
        )
    return {
        "seq_matcher": db.rx_seq_matcher,
        "seq_always": db.rx_seq_always,
        "slot_buckets": _bucket_arrays(db.rx_seq_slot_buckets),
        "var_of_seq": var_of_seq,
        "bytemap": db.rx_bytemap,
        "seed": db.rx_seed,
        "skip": db.rx_skip,
        "accept": db.rx_accept,
        "self": db.rx_self,
        "anchored": db.rx_anchored,
        "end_mode": db.rx_end_mode,
        "start_wb": db.rx_start_wb,
        "end_wb": db.rx_end_wb,
    }


def layout_meta(db: "CompiledDB") -> DeviceLayoutMeta:
    """Static layout metadata alone (the sharded path pairs it with
    per-rank table slices instead of the unsharded stack)."""
    tiny_count = int((np.asarray(db.tiny_len) > 0).sum())
    return DeviceLayoutMeta(
        table_stream=tuple(t.stream for t in db.tables),
        table_lowered=tuple(bool(t.lowered) for t in db.tables),
        table_q=tuple(int(t.q) for t in db.tables),
        max_group=max((int(t.max_group) for t in db.tables), default=1),
        tiny=tuple(
            (
                int(db.tiny_len[i]),
                STREAMS[int(db.tiny_stream[i])],
                bool(db.tiny_lowered[i]),
            )
            for i in range(tiny_count)
        ),
        has_md5=bool(db.m_md5_check.any()),
        n_rx=int(len(db.rx_m_ids)),
    )


def build_device_layout(db: "CompiledDB"):
    """→ (meta, arrays): the static metadata + the full host argument
    pytree for one CompiledDB. Cached on the instance — the arrays are
    views of the db's own numpy buffers wherever possible, so the
    layout costs one stacked-table copy, once."""
    cached = getattr(db, "_device_layout", None)
    if cached is not None:
        return cached
    meta = layout_meta(db)
    arrays = {
        "tab": stack_tables_np(db.tables),
        "slot_bytes": db.slot_bytes,
        "slot_len": db.slot_len,
        "tiny_bytes": db.tiny_bytes,
        "tiny_slot": db.tiny_slot,
        "verdict": verdict_arrays_np(db),
        "rx": rx_arrays_np(db),
    }
    db._device_layout = (meta, arrays)
    return meta, arrays


# ---------------------------------------------------------------------------
# Corpus-delta path (docs/AOT.md): a template add/remove/edit rebuilds
# only the touched stacked-table rows instead of the whole layout
# ---------------------------------------------------------------------------


def compile_corpus_delta(
    templates_new: list,
    db_old: "CompiledDB",
    verify_width: int = VERIFY_WIDTH,
) -> tuple["CompiledDB", dict]:
    """Recompile a corpus against its previous build: unchanged word
    tables are adopted by object identity (see ``compile_corpus``'s
    ``reuse_from``), then the device layout is delta-built so only
    the touched stacked-table rows are rewritten and every equal leaf
    keeps the OLD array object (→ zero re-upload for it). Returns
    ``(db_new, stats)``; the result is bit-identical to a from-scratch
    ``compile_corpus`` + ``build_device_layout``."""
    stats: dict = {}
    db_new = compile_corpus(
        templates_new, verify_width, reuse_from=db_old, delta_stats=stats
    )
    build_device_layout_delta(db_new, db_old, stats)
    return db_new, stats


def stack_tables_delta(
    tables_new: list, tables_old: list, tab_old: dict, stats: dict
) -> dict:
    """Delta twin of :func:`stack_tables_np`: stacked rows for tables
    adopted from the old build (object identity — the
    ``compile_corpus`` reuse contract) are COPIED from the old stacked
    arrays; only changed tables stack from their WordTable. When
    nothing changed and the padded widths are identical, the old
    stacked arrays are returned OUTRIGHT (array identity → the device
    skips their re-upload entirely). ``stats`` gains ``rows_reused`` /
    ``rows_rebuilt``."""
    old_pos = {id(t): i for i, t in enumerate(tables_old)}
    reused = [
        old_pos.get(id(t)) for t in tables_new
    ]  # old row index, or None = rebuild
    rows_reused = sum(1 for r in reused if r is not None)
    stats["rows_reused"] = rows_reused
    stats["rows_rebuilt"] = len(tables_new) - rows_reused
    gmax_new = max((t.num_groups for t in tables_new), default=0) or 1
    emax_new = (
        max((int(t.entry_h2.shape[0]) for t in tables_new), default=0) or 1
    )
    same_shape = (
        tables_old
        and len(tables_new) == len(tables_old)
        and tab_old["group_h1"].shape[1] == gmax_new
        and tab_old["entry_h2"].shape[1] == emax_new
    )
    if same_shape and all(r == i for i, r in enumerate(reused)):
        # nothing to do: every row identical, padding identical
        return tab_old
    if rows_reused == 0 or not tables_new:
        return stack_tables_np(tables_new)
    # mixed case: allocate at the new padded widths, copy reused rows
    # from the old stack (bit-identical to re-stacking them — old rows
    # hold real data up to the table's own G/E, sentinel padding
    # beyond), stack only the changed tables
    T = max(len(tables_new), 1)
    base = {
        "group_h1": (np.uint32, 0xFFFFFFFF, gmax_new),
        "entry_start": (np.int32, 0, gmax_new),
        "entry_count": (np.int32, 0, gmax_new),
        "entry_h2": (np.uint32, 0, emax_new),
        "entry_slot": (np.int32, 0, emax_new),
        "entry_off": (np.int32, 0, emax_new),
        "entry_len": (np.int32, 1 << 30, emax_new),
        "entry_suf_delta": (np.int32, 0, emax_new),
        "entry_suf_h1": (np.uint32, 0, emax_new),
        "entry_suf_h2": (np.uint32, 0, emax_new),
        "bloom": (np.uint32, 0, hashing.BLOOM_WORDS),
    }
    out = {
        name: np.full((T, width), fill, dtype=dt)
        for name, (dt, fill, width) in base.items()
    }
    out["n_groups"] = np.zeros((T,), dtype=np.int32)
    for t_idx, table in enumerate(tables_new):
        r_old = reused[t_idx]
        if r_old is not None:
            for name, (dt, _fill, width) in base.items():
                src_row = tab_old[name][r_old]
                w = min(width, src_row.shape[0])
                out[name][t_idx, :w] = src_row[:w]
            out["n_groups"][t_idx] = tab_old["n_groups"][r_old]
            continue
        G = table.num_groups
        E = int(table.entry_h2.shape[0])
        out["group_h1"][t_idx, :G] = table.group_h1
        out["entry_start"][t_idx, :G] = table.entry_start
        out["entry_count"][t_idx, :G] = table.entry_count
        out["entry_h2"][t_idx, :E] = table.entry_h2
        out["entry_slot"][t_idx, :E] = table.entry_slot
        out["entry_off"][t_idx, :E] = table.entry_off
        out["entry_len"][t_idx, :E] = table.entry_len
        out["entry_suf_delta"][t_idx, :E] = table.entry_suf_delta
        out["entry_suf_h1"][t_idx, :E] = table.entry_suf_h1
        out["entry_suf_h2"][t_idx, :E] = table.entry_suf_h2
        out["bloom"][t_idx] = table.bloom
        out["n_groups"][t_idx] = G
    return out


def layout_leaves(tree, path: tuple = ()):
    """Every leaf of a layout tree (nested dicts, tuples and lists of
    arrays; None holds no leaf) as ``(path, leaf)`` in walk order, the
    path the tuple of keys and indices from the root: the port's
    ``jax.tree_util.tree_flatten_with_path`` over a layout."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from layout_leaves(sub, path + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from layout_leaves(sub, path + (i,))
    elif tree is not None:
        yield path, tree


def map_layout(fn, tree, path: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, its dicts,
    tuples and lists rebuilt as they are (the paths of
    :func:`layout_leaves`)."""
    if isinstance(tree, dict):
        return {key: map_layout(fn, sub, path + (key,)) for key, sub in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_layout(fn, sub, path + (i,)) for i, sub in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _adopt_equal_leaves(new_tree, old_tree, stats: dict):
    """Replace every leaf of ``new_tree`` that is byte-equal to the
    same-path leaf of ``old_tree`` with the OLD ARRAY OBJECT, so the
    device update can skip its re-upload by identity. Only paths
    present in both trees with matching shape/dtype participate;
    structural changes (bucket counts) simply upload. The walk is
    :func:`map_layout`'s; the paths, and so the counts, are the
    reference's."""
    old_leaves = dict(layout_leaves(old_tree))
    counts = {"adopted": 0, "total": 0}

    def adopt(path, leaf):
        counts["total"] += 1
        old = old_leaves.get(path)
        if (
            old is not None
            and isinstance(old, np.ndarray)
            and isinstance(leaf, np.ndarray)
            and old.dtype == leaf.dtype
            and old.shape == leaf.shape
            and (old is leaf or np.array_equal(old, leaf))
        ):
            counts["adopted"] += 1
            return old
        return leaf

    out = map_layout(adopt, new_tree)
    stats["leaves_reused"] = counts["adopted"]
    stats["leaves_total"] = counts["total"]
    return out


def build_device_layout_delta(
    db_new: "CompiledDB", db_old: "CompiledDB", stats: Optional[dict] = None
):
    """Delta twin of :func:`build_device_layout`: rebuild only the
    touched stacked-table rows (``stack_tables_delta``) and adopt
    every unchanged leaf from the old layout by identity, so a
    one-template corpus refresh re-uploads a handful of arrays
    instead of the whole layout. Bit-identical to a from-scratch
    build; the result is cached on ``db_new`` exactly like
    :func:`build_device_layout` so every later consumer sees it."""
    if stats is None:
        stats = {}
    cached = getattr(db_new, "_device_layout", None)
    if cached is not None:
        return (*cached, stats)
    old = getattr(db_old, "_device_layout", None)
    if old is None:
        old = build_device_layout(db_old)
    _old_meta, old_arrays = old
    meta = layout_meta(db_new)
    arrays = {
        "tab": stack_tables_delta(
            db_new.tables, db_old.tables, old_arrays["tab"], stats
        ),
        "slot_bytes": db_new.slot_bytes,
        "slot_len": db_new.slot_len,
        "tiny_bytes": db_new.tiny_bytes,
        "tiny_slot": db_new.tiny_slot,
        "verdict": verdict_arrays_np(db_new),
        "rx": rx_arrays_np(db_new),
    }
    arrays = _adopt_equal_leaves(arrays, old_arrays, stats)
    db_new._device_layout = (meta, arrays)
    return meta, arrays, stats


def compile_corpus(
    templates: list[Template],
    verify_width: int = VERIFY_WIDTH,
    reuse_from: Optional["CompiledDB"] = None,
    delta_stats: Optional[dict] = None,
) -> CompiledDB:
    """Compile a template corpus into a :class:`CompiledDB`.

    ``reuse_from`` is the corpus-delta lever (docs/AOT.md): pass the
    PREVIOUS corpus's CompiledDB and every word table whose content —
    the exact post-shedding (h1, h2, slot, offset) member list plus
    the member payload bytes — is unchanged is adopted by OBJECT
    IDENTITY instead of re-derived (gram hashing, suffix selection,
    bloom build all skipped), which also lets the stacked-layout delta
    (:func:`build_device_layout_delta`) reuse the old stacked rows and
    :class:`~swarm_tpu_torch.ops.match.DeviceDB` skip their re-upload. The
    result is BIT-IDENTICAL to a from-scratch compile by construction
    (the reuse key captures every input of the table build).
    ``delta_stats`` (optional dict) receives the rebuild accounting
    (``tables_total`` / ``tables_reused`` / ``tables_rebuilt``)."""
    slots = _SlotSpace()
    matchers: list[dict] = []
    ops: list[dict] = []
    t_ops: list[list[int]] = []
    kept_templates: list[Template] = []
    t_prefilter_flags: list[bool] = []
    host_always: list[Template] = []
    # regex sequences with no gating literal scan every row — ration
    # them corpus-wide so the verify stage's worklist stays bounded
    rx_always_budget = [4]

    def lower_matcher(m: Matcher) -> Optional[dict]:
        """→ matcher record dict, or None if not device-loweable."""
        rec = {
            "kind": MK_CONST_FALSE,
            "negative": m.negative,
            "cond_and": m.condition == "and",
            "slots": [],
            "scalar": [],
            "residue": False,
            "status": [],
            "size": [],
            "size_stream": 0,
            "md5": None,
            "neg_slots": [],
            "rx": None,
        }

        def const(value: bool) -> dict:
            # constant matcher: encode as MK_CONST_FALSE with the
            # negation flag folded in (negative ^ value ≡ value after
            # the kernel's generic `value ^= negative` step)
            rec["kind"] = MK_CONST_FALSE
            rec["negative"] = bool(m.negative) ^ bool(value)
            return rec
        if m.type in ("word", "binary"):
            payloads = _word_payloads(m)
            if payloads is None:
                return None
            if not payloads:
                # oracle: empty word list → no results → verdict False
                # (negation applies) — a compile-time constant
                return const(False)
            if m.part in HOST_ONLY_PARTS:
                return None  # oracle has real bytes here; not device-loweable
            stream = stream_for_part(m.part)
            if stream is None:
                return rec  # unknown/OOB part: constant False on both engines
            if any(len(p) == 0 for p in payloads):
                # an empty needle is always present (b"" in hay ≡ True):
                # under OR the matcher is constantly True; under AND the
                # empty words are identity conjuncts — drop them
                if m.condition != "and":
                    return const(True)
                payloads = [p for p in payloads if p]
                if not payloads:
                    return const(True)
            # cpu_ref (like nuclei) ignores case-insensitive for binary
            # payloads — keep the device identical.
            lowered = m.case_insensitive and m.type == "word"
            rec["kind"] = MK_WORDS
            rec["slots"] = [slots.get(p, stream, lowered) for p in payloads]
            return rec
        if m.type == "status":
            if not m.status:
                return None
            rec["kind"] = MK_STATUS
            rec["status"] = list(m.status)
            return rec
        if m.type == "size":
            stream = stream_for_part(m.part)
            if not m.size:
                return None
            if stream is None:
                # oracle sees b"" for this part: len==0 is a compile-time
                # constant (size [0] matches the empty part!)
                return const(0 in m.size)
            rec["kind"] = MK_SIZE
            rec["size"] = list(m.size)
            rec["size_stream"] = STREAMS.index(stream)
            return rec
        if m.type == "regex":
            # a pattern Python's re rejects makes the oracle return
            # "unsupported" → constant False, negation NOT applied
            # (cpu_ref.match_matcher returns None pre-negation) — e.g.
            # waf-detect's '(?)content="CloudWAF"'. Exact, and it keeps
            # one broken pattern from demoting 86 siblings to a
            # host-confirmed prefilter op.
            try:
                for pattern in m.regex:
                    dslc.compile_cached(pattern)
            except re.error:
                rec["negative"] = False
                return rec
            stream = stream_for_part(m.part)
            if stream is None:
                # oracle runs the regex over the empty string — also a
                # compile-time constant (e.g. `.*` matches empty)
                results = []
                for pattern in m.regex:
                    results.append(
                        dslc.compile_cached(pattern).search("") is not None
                    )
                if not results:
                    return None
                value = all(results) if m.condition == "and" else any(results)
                return const(value)
            # pure-literal patterns are *exact* substring checks — no
            # prefilter uncertainty at all (MySqlException,
            # (?i)x-drupal, Set-Cookie: (Craft|CRAFT) …)
            pure = [full_literal_expansions(p) for p in m.regex]
            if all(p is not None for p in pure) and (
                m.condition != "and"
                or all(len(alts) == 1 for alts, _ in pure)
            ):
                rec["kind"] = MK_WORDS
                rec["cond_and"] = m.condition == "and"
                rec["slots"] = [
                    slots.get(lit, stream, ci)
                    for alts, ci in pure
                    for lit in alts
                ]
                return rec
            # every regex in the list needs a required literal *set*
            # (any-of — alternations yield several members). The matcher
            # bit is AND of singletons when condition=and, else the flat
            # OR union — both sound supersets, and MK_REGEX_PREFILTER is
            # uncertain-on-fire either way, so weaker only costs extra
            # confirms, never misses. Literals probe the lowered stream.
            lit_sets = []
            for pattern in m.regex:
                # relax the length floor before failing: a 2–3 byte
                # anchor is a weak but still exact-on-miss prefilter
                # (waf-detect's '(?i)ray.id' family)
                lits = None
                for ml in (4, 3, 2):
                    lits = required_literal_set(pattern, min_len=ml)
                    if lits is not None:
                        break
                lit_sets.append(lits)  # None = no gating literal
            # device regex verify (ops/regexdev.py): when every pattern
            # compiles to linear shift-and programs (and the matcher is
            # OR-reduced, the corpus norm), fired rows are re-checked
            # ON DEVICE — the matcher becomes exact, no host confirm.
            # A pattern with no gating literal runs on EVERY row, so
            # those are rationed (rx_always_budget).
            rx_progs = None
            if m.condition != "and" or len(m.regex) == 1:
                progs = [regexlin.compile_linear(p) for p in m.regex]
                if all(p is not None for p in progs):
                    # budget counts expanded SEQUENCES (each always-on
                    # sequence scans every row of every batch)
                    n_always = sum(
                        len(pr[0])
                        for lits, pr in zip(lit_sets, progs)
                        if not lits
                    )
                    if n_always == 0 or rx_always_budget[0] >= n_always:
                        rx_progs = progs
                        rx_always_budget[0] -= n_always
            if rx_progs is None and any(s is None for s in lit_sets):
                # a literal-less pattern with no device program: one
                # bad pattern demotes the whole op (prefilter)
                return None
            rec["kind"] = MK_REGEX_PREFILTER
            rec["cond_and"] = (
                m.condition == "and"
                and all(s is not None and len(s) == 1 for s in lit_sets)
            )
            rec["slots"] = [
                slots.get(lit, stream, True)
                for s in lit_sets
                if s
                for lit in s
            ]
            if rx_progs is not None:
                rec["rx"] = []
                for lits, (alts, ci) in zip(lit_sets, rx_progs):
                    gate = (
                        [slots.get(lit, stream, True) for lit in lits]
                        if lits
                        else []
                    )
                    for lp in alts:
                        rec["rx"].append((lp, ci, stream, gate))
            return rec
        if m.type == "dsl":
            progs = []
            solo = m.condition == "and" or len(m.dsl) == 1
            for expr in m.dsl:
                ast = dslc.try_parse(expr)
                if ast is None or dslc.always_errors(ast):
                    # oracle semantics: a parse failure or an expression
                    # that errors in every env (unknown var/function —
                    # the multi-step status_code_2/body_1 tail) makes
                    # the whole matcher "unsupported" → constant False
                    # with negation NOT applied (cpu_ref.match_matcher
                    # returns None before the negation step)
                    rec["negative"] = False
                    return rec
                if solo and dslc.effectively_false(ast):
                    # every row either errors (matcher unsupported →
                    # False, unnegated) or yields False (expr False →
                    # under AND/single-expr the matcher is False, which
                    # negation could flip) — but False-by-error wins on
                    # exactly the rows where the guard passes, so only
                    # the unnegated constant is sound for both cases…
                    # unless the matcher is negated, where the two
                    # disagree; keep those on the uncertain path.
                    if not m.negative:
                        rec["negative"] = False
                        return rec
                prog = lower_dsl(ast)
                if prog is None:
                    return None
                progs.append(prog)
            merged = _merge_dsl_progs(progs, m.condition)
            if merged is None:
                return None
            if merged.never:
                return rec  # statically unsatisfiable: constant False
            rec["kind"] = MK_SCALAR_DSL
            rec["scalar"] = merged.conjuncts
            rec["residue"] = merged.residue
            rec["cond_and"] = not merged.any_of
            rec["negative"] = bool(m.negative) ^ merged.negated
            rec["slots"] = [
                slots.get(needle, stream, lowered)
                for needle, stream, lowered in merged.contains
            ]
            rec["md5"] = merged.md5
            rec["neg_slots"] = [
                slots.get(needle, stream, lowered)
                for needle, stream, lowered in merged.neg_contains
            ]
            return rec
        return None  # kval / json / xpath

    def const_true_unc() -> dict:
        """Fires on every row; the template-level prefilter flag routes
        fired rows to host confirmation (MK_SCALAR_DSL with an empty
        program evaluates vacuously True pre-negation)."""
        return {
            "kind": MK_SCALAR_DSL,
            "negative": False,
            "cond_and": True,
            "slots": [],
            "scalar": [],
            "residue": False,
            "status": [],
            "size": [],
            "size_stream": 0,
            "md5": None,
            "neg_slots": [],
            "rx": None,
        }

    def lower_matcher_superset(m: Matcher) -> dict:
        """Necessary-condition lowering — never fails. The matcher's
        device value is a superset of its oracle value (post-negation),
        so a template built from these can only over-fire; not-fired
        rows are exact. Only meaningful under a template prefilter flag.
        """
        rec = lower_matcher(m)
        if rec is not None:
            return rec
        if m.negative:
            # a partial (widened) pre-negation value would flip into a
            # *narrowed* post-negation value — unsound as a superset
            return const_true_unc()
        if m.type == "dsl":
            progs = []
            for expr in m.dsl:
                ast = dslc.try_parse(expr)
                if ast is None:  # unreachable: exact path consts these
                    return const_true_unc()
                progs.append(lower_dsl(ast))
            merged = _merge_dsl_progs(progs, m.condition, superset=True)
            if merged is None:
                return const_true_unc()
            if merged.never:
                rec = const_true_unc()
                rec["negative"] = True  # constant False, exact
                return rec
            if merged.negated:
                # negated buckets don't widen monotonically — play safe
                return const_true_unc()
            rec = const_true_unc()
            rec["scalar"] = merged.conjuncts
            # no m-level residue here: a weakened matcher firing every
            # row would make the template *always* uncertain; the
            # op_prefilter flag already confirms exactly the fired rows
            rec["cond_and"] = not merged.any_of
            rec["slots"] = [
                slots.get(needle, stream, lowered)
                for needle, stream, lowered in merged.contains
            ]
            return rec
        if m.type == "regex":
            stream = stream_for_part(m.part)
            if stream is not None:
                # relax the length floor before giving up: a 2–3 byte
                # anchor (binary protocol magic like "N\x00\x0e") takes
                # the exact tiny-slot path and still beats fire-always
                lit_sets = [required_literal_ladder(p) for p in m.regex]
                if m.condition == "and" or len(m.regex) == 1:
                    # any single pattern's set is already necessary —
                    # the union of the available ones is sound (weaker)
                    avail = [s for s in lit_sets if s]
                    lit_sets = avail if avail else None
                else:
                    # OR needs a set for every pattern
                    if any(s is None for s in lit_sets):
                        lit_sets = None
                if lit_sets:
                    rec = const_true_unc()
                    rec["kind"] = MK_REGEX_PREFILTER
                    rec["cond_and"] = False
                    rec["slots"] = [
                        slots.get(lit, stream, True)
                        for s in lit_sets
                        for lit in s
                    ]
                    return rec
            return const_true_unc()
        if m.type == "kval":
            # header KEY presence; the key bytes (either separator
            # form) occurring anywhere in the header is a necessary
            # condition, and OR over forms/keys is a superset of both
            # kval conditions
            slot_ids = []
            for key in m.kval:
                for form in {key.lower().replace("_", "-"), key.lower()}:
                    data = form.encode()
                    if data:
                        slot_ids.append(slots.get(data, "header", True))
            if slot_ids:
                rec = const_true_unc()
                rec["kind"] = MK_WORDS
                rec["cond_and"] = False
                rec["slots"] = slot_ids
                return rec
            return const_true_unc()
        return const_true_unc()

    def lower_extraction_prefilter(op) -> Optional[list]:
        """Pseudo-matchers for an operation with extractors but NO
        matchers: nuclei reports such templates iff any extractor
        extracts (reference worker/artifacts/templates/exposures/
        tokens/generic/credentials-disclosure.yaml:20-24 — the
        exposures/tokens family's entire mechanism).

        One MK_REGEX_PREFILTER pseudo-matcher PER extraction pattern,
        carrying that pattern's required literals: the device q-gram
        pass then reports WHICH patterns could match (the pm-plane
        uncertainty bits), so a fired multi-hundred-pattern extractor
        costs the host only the one or two literal-hit patterns — the
        gram work rides the kernel the corpus matchers already use,
        instead of a per-fire host scan over every pattern. No literal
        present anywhere ⇒ every pseudo-matcher is certain-false and
        the op resolves with zero host work. ``pseudo_ext`` on each
        rec records (extractor_local, pattern_idx) provenance
        (db.m_ext_src) for the engine's per-pattern confirm and the
        extraction pass's bit-driven gating.

        Returns None when any extractor is non-regex or any pattern
        has no required literal — the caller degrades to ONE
        fire-always prefilter rec for the whole op (every row
        host-confirmed — correct, just slower). The whole reference
        http/dns population lowers per-pattern
        (tests/test_extractor_only.py pins that)."""
        recs: list = []
        for ex_local, ex in enumerate(op.extractors):
            if ex.type != "regex" or not ex.regex:
                return None
            stream = stream_for_part(ex.part or "body")
            if stream is None:
                return None
            for p_idx, p in enumerate(ex.regex):
                s = required_literal_ladder(p)
                if s is None:
                    return None
                rec = const_true_unc()
                rec["kind"] = MK_REGEX_PREFILTER
                rec["cond_and"] = False
                rec["slots"] = [slots.get(lit, stream, True) for lit in s]
                rec["pseudo_ext"] = (ex_local, p_idx)
                recs.append(rec)
        return recs or None

    for template in templates:
        if template.protocol == "workflow" or not template.operations:
            continue
        lowered_ops: list[dict] = []
        for op_local, op in enumerate(template.operations):
            if not op.matchers:
                # extractor-only op: matches iff extraction succeeds —
                # but only for the protocol families THIS engine
                # executes. file/ssl/headless extractor-only templates
                # are owned by their subsystems (worker/filescan.py:79,
                # worker/sslscan.py:246, worker/headless.py), which
                # already implement extraction-implies-match; lowering
                # them here would double-claim them against http rows.
                if op.extractors and template.protocol in (
                    "http", "network", "dns",
                ):
                    recs = lower_extraction_prefilter(op)
                    if recs is not None:
                        # per-pattern matchers, OR'd; NOT an op-level
                        # prefilter — the walk confirms exactly the
                        # pattern-matchers whose literals fired
                        lowered_ops.append(
                            {
                                "cond_and": False,
                                "matchers": recs,
                                "prefilter": False,
                                "op_local": op_local,
                            }
                        )
                    else:
                        # degrade: one fire-always rec, whole-op
                        # host confirm on every row (correct, slower)
                        fallback = const_true_unc()
                        fallback["pseudo_ext"] = (-1, -1)
                        lowered_ops.append(
                            {
                                "cond_and": False,
                                "matchers": [fallback],
                                "prefilter": True,
                                "op_local": op_local,
                            }
                        )
                continue
            recs = []
            exact = True
            for m in op.matchers:
                rec = lower_matcher(m)
                if rec is None:
                    exact = False
                    break
                recs.append(rec)
            if not exact:
                # per-op superset re-lowering: this op becomes a device
                # *prefilter* — rows where it fires are host-confirmed
                # (op_prefilter & op_value ⇒ t_unc), rows where it
                # doesn't are exact; sibling exact ops are unaffected.
                # Refund any always-on rx budget the discarded sibling
                # recs had claimed.
                for rec in recs:
                    for _lp, _ci, _stream, gate in rec.get("rx") or []:
                        if not gate:
                            rx_always_budget[0] += 1
                recs = [lower_matcher_superset(m) for m in op.matchers]
            lowered_ops.append(
                {
                    "cond_and": op.matchers_condition == "and",
                    "matchers": recs,
                    "prefilter": not exact,
                    "op_local": op_local,
                }
            )
        op_ids = []
        prefiltered = False
        t_idx = len(t_ops)  # this template's index once kept
        for lop in lowered_ops:
            if not lop["matchers"]:
                continue
            m_ids = []
            for m_local, rec in enumerate(lop["matchers"]):
                m_ids.append(len(matchers))
                # provenance back to the source nuclei matcher so the
                # host can re-evaluate exactly this matcher (engine's
                # sparse confirmation path) instead of the whole template.
                # A synthesized extraction prefilter has no source
                # matcher: m_local = -1 (the op is always a prefilter,
                # so confirmation re-runs the whole op, never this slot)
                rec["src"] = (
                    t_idx,
                    lop["op_local"],
                    -1 if rec.get("pseudo_ext") else m_local,
                )
                matchers.append(rec)
            ops.append(
                {
                    "cond_and": lop["cond_and"],
                    "matchers": m_ids,
                    "prefilter": lop["prefilter"],
                    "src": (t_idx, lop["op_local"]),
                }
            )
            op_ids.append(len(ops) - 1)
            prefiltered |= lop["prefilter"]
        if not op_ids:
            # no matchers and no extractors anywhere: never matches
            # (same as oracle)
            continue
        t_ops.append(op_ids)
        kept_templates.append(template)
        t_prefilter_flags.append(prefiltered)

    # --- build slot arrays ---
    NW = len(slots.entries)
    slot_bytes = np.zeros((max(NW, 1), verify_width), dtype=np.uint8)
    slot_len = np.zeros((max(NW, 1),), dtype=np.int32)
    for i, (data, _stream, _lowered) in enumerate(slots.entries):
        view = data[:verify_width]
        slot_bytes[i, : len(view)] = np.frombuffer(view, dtype=np.uint8)
        slot_len[i] = len(data)
    slot_long = slot_len > verify_width

    # --- build q-gram tables + tiny path ---
    # Each slot picks its rarest gram; oversized (table, h1) groups then
    # shed members to their next-rarest gram so the kernel's per-group
    # loop bound stays small.
    table_members: dict[tuple[str, bool, int], list[tuple[int, int, int, int]]] = {}
    tiny: list[int] = []
    placements: dict[int, tuple[tuple, int, int, int]] = {}  # slot -> (tkey, h1, h2, off)
    candidates: dict[int, list[int]] = {}
    group_sizes: dict[tuple, int] = {}  # (tkey, h1) -> count

    def _hash_at(data: bytes, off: int, q: int) -> tuple[int, int]:
        return hashing.gram_hash_np(data[off : off + q], q)

    for slot_id, (data, stream, lowered) in enumerate(slots.entries):
        if len(data) < hashing.GRAM_SHORT:
            tiny.append(slot_id)
            continue
        q = hashing.GRAM_LONG if len(data) >= hashing.GRAM_LONG else hashing.GRAM_SHORT
        tkey = (stream, lowered, q)
        offs = _gram_offsets_by_rarity(data, q)
        candidates[slot_id] = offs
        off = offs[0]
        h1, h2 = _hash_at(data, off, q)
        placements[slot_id] = (tkey, h1, h2, off)
        group_sizes[(tkey, h1)] = group_sizes.get((tkey, h1), 0) + 1

    for _round in range(12):
        oversized = {k for k, n in group_sizes.items() if n > MAX_GROUP}
        if not oversized:
            break
        moved = False
        for slot_id, (tkey, h1, h2, off) in list(placements.items()):
            if (tkey, h1) not in oversized or group_sizes[(tkey, h1)] <= MAX_GROUP:
                continue
            data = slots.entries[slot_id][0]
            q = tkey[2]
            for alt in candidates[slot_id]:
                if alt == off:
                    continue
                ah1, ah2 = _hash_at(data, alt, q)
                if group_sizes.get((tkey, ah1), 0) < MAX_GROUP:
                    group_sizes[(tkey, h1)] -= 1
                    group_sizes[(tkey, ah1)] = group_sizes.get((tkey, ah1), 0) + 1
                    placements[slot_id] = (tkey, ah1, ah2, alt)
                    moved = True
                    break
        if not moved:
            break

    for slot_id, (tkey, h1, h2, off) in placements.items():
        table_members.setdefault(tkey, []).append((h1, h2, slot_id, off))

    tables: list[WordTable] = []
    # corpus-delta table reuse: content key = the sorted member list
    # (post-shedding placements) + a digest of the member payload
    # bytes — together they determine every output array, so a key
    # match makes the old WordTable bit-identical to what this build
    # would produce and it is adopted by object identity
    reuse_keys: dict = getattr(reuse_from, "_table_keys", None) or {}
    reuse_tables: dict = (
        {
            (t.stream, t.lowered, t.q): t
            for t in getattr(reuse_from, "tables", ())
        }
        if reuse_from is not None
        else {}
    )
    table_keys: dict = {}
    tables_reused = 0

    def _members_key(members: list) -> tuple:
        import hashlib as _hashlib

        h = _hashlib.sha256()
        for _h1, _h2, slot_id, _off in members:
            data = slots.entries[slot_id][0]
            h.update(len(data).to_bytes(8, "little"))
            h.update(data)
        return (tuple(members), h.hexdigest())

    for (stream, lowered, q), members in sorted(table_members.items()):
        members.sort()
        tkey = (stream, lowered, q)
        content_key = _members_key(members)
        table_keys[tkey] = content_key
        if (
            reuse_keys.get(tkey) == content_key
            and tkey in reuse_tables
        ):
            tables.append(reuse_tables[tkey])
            tables_reused += 1
            continue
        group_h1: list[int] = []
        entry_start: list[int] = []
        entry_count: list[int] = []
        e_h2: list[int] = []
        e_slot: list[int] = []
        e_off: list[int] = []
        e_len: list[int] = []
        e_sufd: list[int] = []
        e_sufh1: list[int] = []
        e_sufh2: list[int] = []
        for h1, h2, slot_id, off in members:
            if not group_h1 or group_h1[-1] != h1:
                group_h1.append(h1)
                entry_start.append(len(e_h2))
                entry_count.append(0)
            entry_count[-1] += 1
            data = slots.entries[slot_id][0]
            # suffix gram: the rarest window *different* from the main
            # gram. The last-q-bytes choice made same-suffix families
            # ("…</title>") share a trivially-true check (delta 0) —
            # the false-fire storm the device verify then had to absorb.
            suf_off = next(
                (a for a in candidates.get(slot_id, [0]) if a != off),
                len(data) - q,
            )
            sh1, sh2 = _hash_at(data, suf_off, q)
            e_h2.append(h2)
            e_slot.append(slot_id)
            e_off.append(off)
            e_len.append(len(data))
            e_sufd.append(suf_off - off)
            e_sufh1.append(sh1)
            e_sufh2.append(sh2)
        max_group = max(entry_count)
        if max_group > MAX_GROUP:
            # A pathological slot population (many near-identical
            # literals sharing every rare gram) can defeat the shedding
            # loop. Correctness never depends on the bound — every
            # entry hit is byte-verified in the kernel — so degrade:
            # this one table's unrolled verify loop grows to the actual
            # group size (device cost, not a verdict risk). Crashing
            # the compile would lose the whole DB to save device time.
            # The degrade is itself bounded: past HARD_GROUP the unroll
            # would dominate XLA compile and the hot loop, so that
            # stays a loud failure.
            if max_group > HARD_GROUP:
                raise ValueError(
                    f"word-table group overflow ({max_group} > hard cap "
                    f"{HARD_GROUP}); diversify gram offsets or split "
                    "the slot population"
                )
            print(
                f"[compile] word-table group overflow ({max_group} > "
                f"{MAX_GROUP}) on table {(stream, lowered, q)}; "
                f"unrolling that table's verify loop to {max_group}",
                file=sys.stderr,
            )
        # Bloom carries every entry's (h1, h2) pair so a probe can only
        # pass where some entry's gram might start.
        tables.append(
            WordTable(
                stream=stream,
                lowered=lowered,
                q=q,
                group_h1=np.array(group_h1, dtype=np.uint32),
                entry_start=np.array(entry_start, dtype=np.int32),
                entry_count=np.array(entry_count, dtype=np.int32),
                entry_h2=np.array(e_h2, dtype=np.uint32),
                entry_slot=np.array(e_slot, dtype=np.int32),
                entry_off=np.array(e_off, dtype=np.int32),
                entry_len=np.array(e_len, dtype=np.int32),
                entry_suf_delta=np.array(e_sufd, dtype=np.int32),
                entry_suf_h1=np.array(e_sufh1, dtype=np.uint32),
                entry_suf_h2=np.array(e_sufh2, dtype=np.uint32),
                bloom=hashing.build_bloom_np(
                    np.repeat(
                        np.array(group_h1, dtype=np.uint32),
                        np.array(entry_count, dtype=np.int64),
                    ),
                    np.array(e_h2, dtype=np.uint32),
                ),
                max_group=max_group,
            )
        )

    NTINY = len(tiny)
    tiny_bytes = np.zeros((max(NTINY, 1), hashing.TINY_MAX), dtype=np.uint8)
    tiny_len = np.zeros((max(NTINY, 1),), dtype=np.int32)
    tiny_slot = np.zeros((max(NTINY, 1),), dtype=np.int32)
    tiny_stream = np.zeros((max(NTINY, 1),), dtype=np.int32)
    tiny_lowered = np.zeros((max(NTINY, 1),), dtype=bool)
    for i, slot_id in enumerate(tiny):
        data, stream, lowered = slots.entries[slot_id]
        tiny_bytes[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        tiny_len[i] = len(data)
        tiny_slot[i] = slot_id
        tiny_stream[i] = STREAMS.index(stream)
        tiny_lowered[i] = lowered

    # --- matcher arrays ---
    NM = max(len(matchers), 1)
    max_status = max(
        (max(len(r["status"]), len(r["size"])) for r in matchers), default=1
    ) or 1
    m_kind = np.zeros((NM,), dtype=np.int32)
    m_negative = np.zeros((NM,), dtype=bool)
    m_cond_and = np.zeros((NM,), dtype=bool)
    m_scalar = np.zeros((NM, MAX_SCALAR_CONJUNCTS, 3), dtype=np.float32)
    m_scalar[:, :, 1] = SOP_TRUE
    m_residue = np.zeros((NM,), dtype=bool)
    m_status = np.full((NM, max_status), -1, dtype=np.int32)
    m_size = np.full((NM, max_status), -1, dtype=np.int32)
    m_size_stream = np.zeros((NM,), dtype=np.int32)
    m_md5 = np.zeros((NM, 4), dtype=np.uint32)
    m_md5_check = np.zeros((NM,), dtype=bool)
    for i, rec in enumerate(matchers):
        m_kind[i] = rec["kind"]
        m_negative[i] = rec["negative"]
        m_cond_and[i] = rec["cond_and"]
        for j, (var, op, val) in enumerate(rec["scalar"][:MAX_SCALAR_CONJUNCTS]):
            m_scalar[i, j] = (var, op, val)
        m_residue[i] = rec["residue"]
        if rec.get("md5") is not None:
            m_md5[i] = np.frombuffer(rec["md5"], dtype="<u4")
            m_md5_check[i] = True
        for j, s in enumerate(rec["status"]):
            m_status[i, j] = s
        for j, s in enumerate(rec["size"]):
            m_size[i, j] = s
        m_size_stream[i] = rec["size_stream"]
    m_slot_buckets = bucket_ragged([r["slots"] for r in matchers], NM)
    m_negslot_buckets = bucket_ragged(
        [r.get("neg_slots", []) for r in matchers], NM
    )

    # --- device-regex sequence tables ---
    rx_matchers = [
        (i, rec) for i, rec in enumerate(matchers) if rec.get("rx")
    ]
    rx_m_ids = np.array([i for i, _ in rx_matchers], dtype=np.int32)
    seqs: list[tuple[int, object, bool, str, list]] = []
    for rxi, (_m_id, rec) in enumerate(rx_matchers):
        for lp, ci, stream, gate in rec["rx"]:
            seqs.append((rxi, lp, ci, stream, gate))
    rx_seq_slot_buckets = bucket_ragged(
        [s[4] for s in seqs], max(len(seqs), 1)
    )
    rx_seq_always = np.array(
        [not s[4] for s in seqs] or [False], dtype=bool
    )
    NSEQ = max(len(seqs), 1)
    rx_max_m = max((s[1].m for s in seqs), default=1)
    rx_lanes = (rx_max_m + 31) // 32  # uint32 state lanes
    rx_seq_matcher = np.zeros((NSEQ,), dtype=np.int32)
    rx_seq_stream = np.zeros((NSEQ,), dtype=np.int32)
    rx_seq_ci = np.zeros((NSEQ,), dtype=bool)
    rx_classes = np.zeros((NSEQ, rx_max_m, 8), dtype=np.uint32)
    rx_m_count = np.ones((NSEQ,), dtype=np.int32)
    rx_seed = np.zeros((NSEQ, rx_lanes), dtype=np.uint32)
    rx_skip = np.zeros((NSEQ, rx_lanes), dtype=np.uint32)
    rx_accept = np.zeros((NSEQ, rx_lanes), dtype=np.uint32)
    rx_self = np.zeros((NSEQ, rx_lanes), dtype=np.uint32)
    rx_anchored = np.zeros((NSEQ,), dtype=bool)
    rx_end_mode = np.zeros((NSEQ,), dtype=np.int32)
    rx_start_wb = np.zeros((NSEQ,), dtype=bool)
    rx_end_wb = np.zeros((NSEQ,), dtype=bool)
    rx_max_skip_run = 0
    for si, (rxi, lp, ci, stream, _gate) in enumerate(seqs):
        rx_seq_matcher[si] = rxi
        rx_seq_stream[si] = STREAMS.index(stream)
        rx_seq_ci[si] = ci
        rx_classes[si, : lp.m] = lp.classes
        rx_m_count[si] = lp.m
        rx_anchored[si] = lp.anchored
        rx_end_mode[si] = lp.end_mode
        rx_start_wb[si] = lp.start_wb
        rx_end_wb[si] = lp.end_wb
        seed, skip, accept, sl = regexlin.derived_masks(lp)
        for j, v in enumerate((seed, skip, accept, sl)):
            arr = (rx_seed, rx_skip, rx_accept, rx_self)[j]
            for ln in range(rx_lanes):
                arr[si, ln] = (v >> (32 * ln)) & 0xFFFFFFFF
        rx_max_skip_run = max(rx_max_skip_run, lp.max_skip_run)
    # byte → position-bits lookup (the kernel's per-byte B[c] masks):
    # transpose of rx_classes into state lanes.
    rx_bytemap = np.zeros((NSEQ, 256, rx_lanes), dtype=np.uint32)
    if seqs:
        for c in range(256):
            bits = (rx_classes[:, :, c >> 5] >> np.uint32(c & 31)) & 1
            for i in range(rx_max_m):
                rx_bytemap[:, c, i // 32] |= bits[:, i].astype(
                    np.uint32
                ) << np.uint32(i % 32)

    # --- operation / template arrays ---
    NOP = max(len(ops), 1)
    op_cond_and = np.zeros((NOP,), dtype=bool)
    op_prefilter = np.zeros((NOP,), dtype=bool)
    for i, o in enumerate(ops):
        op_cond_and[i] = o["cond_and"]
        op_prefilter[i] = o["prefilter"]
    op_m_buckets = bucket_ragged([o["matchers"] for o in ops], NOP)
    t_op_buckets = bucket_ragged(t_ops, max(len(t_ops), 1))

    t_prefilter = np.array(t_prefilter_flags or [False], dtype=bool)

    # provenance for the engine's sparse host-confirmation: device
    # matcher/op id → source (template, operation[, matcher]) indices
    m_src = np.zeros((NM, 3), dtype=np.int32)
    for i, rec in enumerate(matchers):
        m_src[i] = rec["src"]
    # per-pattern extraction provenance: matcher id -> (extractor_local,
    # pattern_idx) for synthesized extraction prefilters, (-1, -1)
    # otherwise (incl. the fire-always degrade, which confirms whole-op)
    m_ext_src = np.full((NM, 2), -1, dtype=np.int32)
    for i, rec in enumerate(matchers):
        pe = rec.get("pseudo_ext")
        if isinstance(pe, tuple):
            m_ext_src[i] = pe
    op_src = np.zeros((NOP, 2), dtype=np.int32)
    for i, o in enumerate(ops):
        op_src[i] = o["src"]
    op_matchers = [list(o["matchers"]) for o in ops]

    stats = {
        "templates_in": len(templates),
        "templates_device": len(kept_templates),
        "templates_prefilter": int(sum(t_prefilter_flags)),
        "ops_prefilter": int(op_prefilter.sum()),
        "templates_host_always": len(host_always),
        "matchers": len(matchers),
        "rx_matchers": len(rx_matchers),
        "rx_sequences": len(seqs),
        "word_slots": NW,
        "tiny_slots": NTINY,
        "tables": {
            f"{t.stream}/{'ci' if t.lowered else 'cs'}/q{t.q}": int(
                t.entry_h2.shape[0]
            )
            for t in tables
        },
    }

    if delta_stats is not None:
        delta_stats["tables_total"] = len(tables)
        delta_stats["tables_reused"] = tables_reused
        delta_stats["tables_rebuilt"] = len(tables) - tables_reused
    out_db = CompiledDB(
        slot_bytes=slot_bytes,
        slot_len=slot_len,
        slot_long=slot_long,
        tables=tables,
        tiny_bytes=tiny_bytes,
        tiny_len=tiny_len,
        tiny_slot=tiny_slot,
        tiny_stream=tiny_stream,
        tiny_lowered=tiny_lowered,
        m_kind=m_kind,
        m_negative=m_negative,
        m_cond_and=m_cond_and,
        m_slot_buckets=m_slot_buckets,
        m_negslot_buckets=m_negslot_buckets,
        m_scalar=m_scalar,
        m_residue=m_residue,
        m_md5=m_md5,
        m_md5_check=m_md5_check,
        rx_m_ids=rx_m_ids,
        rx_seq_slot_buckets=rx_seq_slot_buckets,
        rx_seq_always=rx_seq_always,
        rx_seq_matcher=rx_seq_matcher,
        rx_seq_stream=rx_seq_stream,
        rx_seq_ci=rx_seq_ci,
        rx_classes=rx_classes,
        rx_bytemap=rx_bytemap,
        rx_m_count=rx_m_count,
        rx_seed=rx_seed,
        rx_skip=rx_skip,
        rx_accept=rx_accept,
        rx_self=rx_self,
        rx_anchored=rx_anchored,
        rx_end_mode=rx_end_mode,
        rx_start_wb=rx_start_wb,
        rx_end_wb=rx_end_wb,
        rx_max_skip_run=rx_max_skip_run,
        m_status=m_status,
        m_size=m_size,
        m_size_stream=m_size_stream,
        op_cond_and=op_cond_and,
        op_prefilter=op_prefilter,
        op_m_buckets=op_m_buckets,
        t_op_buckets=t_op_buckets,
        t_prefilter=t_prefilter,
        m_src=m_src,
        m_ext_src=m_ext_src,
        op_src=op_src,
        op_matchers=op_matchers,
        t_ops=[list(o) for o in t_ops],
        template_ids=[t.id for t in kept_templates],
        host_always=host_always,
        templates=kept_templates,
        stats=stats,
    )
    # the delta-reuse registry (rides dbcache pickles: plain tuples,
    # a few ints per entry) — absent on pre-delta pickles, which then
    # simply take the full-rebuild path
    out_db._table_keys = table_keys
    # workflow DAGs lower against the finished device id spaces (the
    # delta path rebuilds the plan too — gate tables are tiny)
    out_db.wf = lower_workflows(list(templates), out_db)
    stats["workflows"] = out_db.wf.stats
    return out_db
