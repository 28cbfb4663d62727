"""crex compiler: Python ``re`` pattern -> native VM program.

Lowers a conservative sre-parse-tree subset to the flat instruction
format ``native/crex.cpp`` executes: byte classes, ordered alternation
(preference-first SPLIT), greedy/lazy repeats (single-class repeats as
counted REP instructions, general bounded repeats unrolled, unbounded
general repeats as SPLIT loops), capturing groups (SAVE slots), and
end/boundary anchors. Anything outside the subset — backreferences,
lookarounds, (?a) semantics, empty-matchable loop bodies, oversized
programs — returns None and the caller stays on Python ``re``.

Exactness: masks are built by the same machinery the device lowering
trusts (``regexlin._class_mask`` — per-byte membership matching re's
latin-1 semantics), and the VM's backtracking order (leftmost start,
preference-ordered alternatives, longest-first greedy) is Python re's
own strategy, so results are byte-identical for the supported subset.

The port's copy of ``swarm_tpu/ops/crexc.py``, held equal to it by
tests/test_torch_native.py and tests/test_torch_walk.py.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from swarm_tpu_torch.fingerprints.regexlin import (
    _class_mask,
    _case_fold,
    _category_mask,
    _Unsupported,
    parse_quiet,
)

# instruction opcodes — keep in lockstep with native/crex.cpp
OP_CHAR, OP_CLASS, OP_SPLIT, OP_JMP, OP_SAVE, OP_MATCH = 0, 1, 2, 3, 4, 5
OP_REPG, OP_REPL, OP_AT, OP_LOOP = 6, 7, 8, 9

#: ABI version — bump on ANY change to the opcode set, instruction
#: encoding, or driver return codes, in lockstep with
#: CREX_ABI_VERSION in native/crex.cpp. native/crex.py verifies the
#: loaded .so reports this value and refuses a stale build.
CREX_ABI = 4

_INT32_MAX = 2**31 - 1

#: Codepoints > 0xFF that Python re's IGNORECASE folds INTO latin-1
#: (so a latin-1 byte can match them): chars whose single-char
#: ``str.lower`` lands < 0x100 (K→k, Å→å, ẞ→ß, Ÿ→ÿ) plus the
#: ``re._casefix._EXTRA_CASES`` pairs that cross the byte boundary
#: (ı↔i, ſ↔s, μ↔µ). Patterns touching these under (?i) stay on exact
#: Python re; every OTHER >0xFF char can never match latin-1 text and
#: lowers to an impossible class. tests/test_crex.py re-derives this
#: set from the running interpreter (unicode-data drift guard).
CI_LATIN1_FOLDERS = frozenset(
    {0x131, 0x178, 0x17F, 0x1E9E, 0x212A, 0x212B, 0x3BC}
)
AT_BOS, AT_EOS, AT_EOD, AT_WB, AT_NWB, AT_BOL, AT_EOL = 0, 1, 2, 3, 4, 5, 6

MAX_PROG = 2048     # instructions (the corpus's largest lowerable
                    # pattern, technologies' el-table alternation,
                    # needs 1,233; a program is 16 B/instr of compile-
                    # time memory and size does not slow the VM's
                    # per-attempt execution)
MAX_GROUP = 31      # save slots 2..63 (group 0 handled by the driver)
MAX_SLOTS = 64      # total save slots (group pairs + loop marks)
_MAXREPEAT = 2**32 - 1  # sre MAXREPEAT compares equal to this

_DOT = np.ones(256, dtype=bool)
_DOT[ord("\n")] = False
_DOTALL = np.ones(256, dtype=bool)


@dataclasses.dataclass
class CrexProgram:
    prog: np.ndarray       # int32 [n, 4] flattened C-order
    masks: np.ndarray      # uint8 [n_masks, 32] bitsets
    n_saves: int           # save slots used (2 * (max group + 1))
    group_exists: dict     # gid -> True for groups the pattern defines


def _guard_ci_fold(arg: int, ci: bool, what: str) -> None:
    """Shared rejection for (?i) literals that fold INTO latin-1
    (kelvin K matches k, long-s matches s) — only Python re gets
    those right. One guard for all four literal sites (compile_seq
    and _single_class, LITERAL and NOT_LITERAL)."""
    if ci and arg in CI_LATIN1_FOLDERS:
        raise _Unsupported(f"latin-1-folding {what} under (?i)")


class _Compiler:
    def __init__(self, counted_reps: bool = True):
        self.instrs: list[list[int]] = []
        self.masks: list[bytes] = []
        self._mask_idx: dict[bytes, int] = {}
        self.max_group = 0
        self.n_loops = 0  # loop-mark slots, allocated from MAX_SLOTS down
        # False: lower single-class repeats as unrolled SPLIT chains
        # instead of counted OP_REPG/OP_REPL — the NFA existence scan
        # (native sw_crex_exists) cannot simulate counters
        self.counted_reps = counted_reps

    def loop_slot(self) -> int:
        self.n_loops += 1
        slot = MAX_SLOTS - self.n_loops
        # group-pair slots grow from 0, loop marks from the top —
        # overlap is checked at finalize (compile_crex)
        return slot

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        if len(self.instrs) >= MAX_PROG:
            raise _Unsupported("program too large")
        self.instrs.append([op, a, b, c])
        return len(self.instrs) - 1

    def mask_id(self, mask: np.ndarray) -> int:
        key = np.packbits(mask, bitorder="little").tobytes()
        idx = self._mask_idx.get(key)
        if idx is None:
            idx = self._mask_idx[key] = len(self.masks)
            self.masks.append(key)
        return idx

    # ---- tree walk ----

    def compile_seq(self, seq, ci: bool, dotall: bool, multiline: bool):
        for op, arg in seq:
            name = str(op)
            if name == "LITERAL":
                if arg > 255:
                    _guard_ci_fold(arg, ci, "literal")
                    # cannot occur in latin-1 text; the whole pattern
                    # can never match — emit an impossible class
                    self.emit(OP_CLASS, self.mask_id(np.zeros(256, bool)))
                elif ci:
                    m = np.zeros(256, dtype=bool)
                    m[arg] = True
                    self.emit(OP_CLASS, self.mask_id(_case_fold(m)))
                else:
                    self.emit(OP_CHAR, arg)
            elif name == "NOT_LITERAL":
                _guard_ci_fold(arg, ci, "not-literal")
                m = np.zeros(256, dtype=bool)
                if 0 <= arg <= 255:
                    m[arg] = True
                if ci:
                    m = _case_fold(m)
                self.emit(OP_CLASS, self.mask_id(~m))
            elif name == "IN":
                _guard_ci_nonlatin(arg, ci)
                self.emit(OP_CLASS, self.mask_id(_class_mask(arg, ci)))
            elif name == "ANY":
                self.emit(OP_CLASS, self.mask_id(_DOTALL if dotall else _DOT))
            elif name == "SUBPATTERN":
                gid, add_f, del_f, sub = arg
                if add_f & re.ASCII:
                    raise _Unsupported("(?a:) scope")
                sub_ci = (ci or bool(add_f & re.IGNORECASE)) and not bool(
                    del_f & re.IGNORECASE
                )
                sub_dotall = (dotall or bool(add_f & re.DOTALL)) and not bool(
                    del_f & re.DOTALL
                )
                sub_ml = (multiline or bool(add_f & re.MULTILINE)) and not bool(
                    del_f & re.MULTILINE
                )
                if gid is not None:
                    if gid > MAX_GROUP:
                        raise _Unsupported("too many groups")
                    self.max_group = max(self.max_group, gid)
                    self.emit(OP_SAVE, 2 * gid)
                self.compile_seq(sub, sub_ci, sub_dotall, sub_ml)
                if gid is not None:
                    self.emit(OP_SAVE, 2 * gid + 1)
            elif name == "BRANCH":
                branches = arg[1]
                jmps = []
                for i, br in enumerate(branches):
                    if i < len(branches) - 1:
                        sp = self.emit(OP_SPLIT)
                    else:
                        sp = None
                    start = len(self.instrs)
                    self.compile_seq(br, ci, dotall, multiline)
                    if i < len(branches) - 1:
                        jmps.append(self.emit(OP_JMP))
                        self.instrs[sp][1] = start
                        self.instrs[sp][2] = len(self.instrs)
                after = len(self.instrs)
                for j in jmps:
                    self.instrs[j][1] = after
            elif name in ("MAX_REPEAT", "MIN_REPEAT"):
                lo, hi, sub = arg
                if hi >= _MAXREPEAT:
                    hi = -1  # unbounded
                self.compile_repeat(
                    lo, hi, sub, name == "MIN_REPEAT", ci, dotall, multiline
                )
            elif name == "AT":
                at = str(arg).rsplit(".", 1)[-1]
                wb = self.mask_id(_category_mask("CATEGORY_WORD"))
                if at in ("AT_BEGINNING",):
                    self.emit(OP_AT, AT_BOL if multiline else AT_BOS)
                elif at == "AT_BEGINNING_STRING":
                    self.emit(OP_AT, AT_BOS)
                elif at == "AT_END":
                    self.emit(OP_AT, AT_EOL if multiline else AT_EOD)
                elif at == "AT_END_STRING":
                    self.emit(OP_AT, AT_EOS)
                elif at == "AT_BOUNDARY":
                    self.emit(OP_AT, AT_WB, wb)
                elif at == "AT_NON_BOUNDARY":
                    self.emit(OP_AT, AT_NWB, wb)
                else:
                    raise _Unsupported(f"anchor {at}")
            else:
                # GROUPREF / ASSERT / ASSERT_NOT / GROUPREF_EXISTS /
                # ATOMIC_GROUP / POSSESSIVE repeats / ...
                raise _Unsupported(f"op {name}")

    def _single_class(self, sub, ci: bool, dotall: bool):
        """The class mask when ``sub`` is one single-byte item, else
        None (drives the counted-REP fast instruction). Raises
        _Unsupported for the same (?i) non-latin-1 fold cases
        compile_seq rejects."""
        if len(sub) != 1:
            return None
        op, arg = sub[0]
        name = str(op)
        if name == "LITERAL":
            if arg > 255:
                _guard_ci_fold(arg, ci, "literal")
                return np.zeros(256, dtype=bool)
            m = np.zeros(256, dtype=bool)
            m[arg] = True
            return _case_fold(m) if ci else m
        if name == "NOT_LITERAL":
            _guard_ci_fold(arg, ci, "not-literal")
            m = np.zeros(256, dtype=bool)
            if 0 <= arg <= 255:
                m[arg] = True
            if ci:
                m = _case_fold(m)
            return ~m
        if name == "IN":
            _guard_ci_nonlatin(arg, ci)
            return _class_mask(arg, ci)
        if name == "ANY":
            return _DOTALL if dotall else _DOT
        return None

    def compile_repeat(self, lo, hi, sub, lazy, ci, dotall, multiline):
        if lo > _INT32_MAX or hi > _INT32_MAX:
            # re accepts counts up to 2**32-2; they don't fit the
            # int32 instruction fields (and an a{3000000000} unroll
            # would be absurd anyway) — stay on Python re
            raise _Unsupported("repeat bound exceeds int32")
        mask = self._single_class(sub, ci, dotall)
        if mask is not None and self.counted_reps:
            self.emit(OP_REPL if lazy else OP_REPG,
                      self.mask_id(mask), lo, hi)
            return
        # general body. Bounded repeats with empty-matchable bodies
        # unroll to finite SPLIT chains — Python verifiably runs
        # trailing empty iterations there (((a)|){2} on "a" leaves
        # group 1 at the empty (1,1)), exactly what the preference
        # encoding produces. Unbounded ones additionally need Python's
        # empty-iteration break rule: a mark slot records each
        # iteration's entry position and OP_LOOP exits when the body
        # consumed nothing (else the SPLIT loop would spin forever).
        for _ in range(lo):
            self.compile_seq(sub, ci, dotall, multiline)
        if hi < 0:
            mark = self.loop_slot() if _can_empty(sub) else None
            l0 = len(self.instrs)
            sp = self.emit(OP_SPLIT)
            if mark is not None:
                self.emit(OP_SAVE, mark)
            self.compile_seq(sub, ci, dotall, multiline)
            if mark is not None:
                self.emit(OP_LOOP, l0, mark)
            else:
                self.emit(OP_JMP, l0)
            after = len(self.instrs)
            if lazy:
                self.instrs[sp][1], self.instrs[sp][2] = after, sp + 1
            else:
                self.instrs[sp][1], self.instrs[sp][2] = sp + 1, after
        else:
            # optional copies carry the same zero-width protection as
            # CPython's >=min repeat phase: an optional copy that
            # consumed nothing skips the REMAINING copies (but itself
            # counts — ((a)|){2} on "a" keeps the trailing empty
            # iteration; (?:(?:a|)(?:|b)){0,2} on "ba" must not let an
            # empty copy 1 spawn a copy 2). Mandatory (count < min)
            # copies are unprotected, as in CPython.
            mark = self.loop_slot() if _can_empty(sub) else None
            splits = []
            skip_jmps = []
            for _ in range(hi - lo):
                splits.append(self.emit(OP_SPLIT))
                if mark is not None:
                    self.emit(OP_SAVE, mark)
                self.compile_seq(sub, ci, dotall, multiline)
                if mark is not None:
                    lp = self.emit(OP_LOOP, 0, mark)
                    skip_jmps.append(self.emit(OP_JMP))  # empty: done
                    # progress: continue at the next copy (== `after`
                    # for the final copy, by construction)
                    self.instrs[lp][1] = len(self.instrs)
            after = len(self.instrs)
            for sp in splits:
                if lazy:
                    self.instrs[sp][1], self.instrs[sp][2] = after, sp + 1
                else:
                    self.instrs[sp][1], self.instrs[sp][2] = sp + 1, after
            for j in skip_jmps:
                self.instrs[j][1] = after


def _guard_ci_nonlatin(items, ci: bool) -> None:
    """Reject class items that (?i)-fold non-latin-1 chars into the
    byte domain: ``(?i)[\\u212a]`` matches ``k`` and a range spanning
    past 0xFF can contain such members ((?i)[\\u2100-\\u2200] matches
    ``k`` under re, large or small) — ``_class_mask`` clamps them
    away, so these patterns must stay on exact Python ``re``. Members
    outside ``CI_LATIN1_FOLDERS`` can never match latin-1 text and
    the clamp is exact for them."""
    if not ci:
        return
    for op, arg in items:
        name = str(op)
        if name == "LITERAL" and arg in CI_LATIN1_FOLDERS:
            raise _Unsupported("latin-1-folding class literal under (?i)")
        if name == "RANGE" and arg[1] > 255 and any(
            arg[0] <= d <= arg[1] for d in CI_LATIN1_FOLDERS
        ):
            raise _Unsupported("latin-1-folding class range under (?i)")


def _can_empty(seq) -> bool:
    """Whether ``seq`` can match the empty string (conservative: any
    unknown construct counts as maybe-empty)."""
    for op, arg in seq:
        name = str(op)
        if name in ("LITERAL", "NOT_LITERAL", "IN", "ANY"):
            return False  # consumes a byte: the sequence can't be empty
        if name == "AT":
            continue
        if name in ("MAX_REPEAT", "MIN_REPEAT"):
            lo, _hi, sub = arg
            if lo > 0 and not _can_empty(sub):
                return False
            continue
        if name == "SUBPATTERN":
            _g, _af, _df, sub = arg
            if not _can_empty(sub):
                return False
            continue
        if name == "BRANCH":
            if not any(_can_empty(b) for b in arg[1]):
                return False
            continue
        return True  # unknown: assume it may be empty
    return True


_COMPILE_CACHE: dict = {}
_CACHE_MAX = 16384


def compile_crex(pattern: str) -> Optional[CrexProgram]:
    """Pattern -> native VM program, or None when out of subset."""
    hit = _COMPILE_CACHE.get(pattern)
    if hit is not None or pattern in _COMPILE_CACHE:
        return hit
    out = _compile(pattern)
    if len(_COMPILE_CACHE) < _CACHE_MAX:
        _COMPILE_CACHE[pattern] = out
    return out


def compile_crex_nfa(pattern: str) -> Optional[CrexProgram]:
    """Pattern -> counter-free program for the linear-time NFA
    existence scan (native sw_crex_exists): single-class repeats
    unroll like general bodies instead of emitting counted OP_REP
    instructions. Oversized unrolls (huge {m,n}) fall out via
    MAX_PROG -> None, and the caller stays on the backtracking /
    Python-re paths."""
    hit = _NFA_CACHE.get(pattern)
    if hit is not None or pattern in _NFA_CACHE:
        return hit
    out = _compile(pattern, counted_reps=False)
    if len(_NFA_CACHE) < _CACHE_MAX:
        _NFA_CACHE[pattern] = out
    return out


_NFA_CACHE: dict = {}


def _compile(
    pattern: str, counted_reps: bool = True
) -> Optional[CrexProgram]:
    try:
        tree = parse_quiet(pattern)
    except re.error:
        return None
    flags = tree.state.flags
    if flags & (re.ASCII | re.LOCALE):
        return None  # mask semantics are Unicode-for-latin-1 only
    ci = bool(flags & re.IGNORECASE)
    dotall = bool(flags & re.DOTALL)
    multiline = bool(flags & re.MULTILINE)
    c = _Compiler(counted_reps=counted_reps)
    try:
        c.compile_seq(list(tree), ci, dotall, multiline)
        c.emit(OP_MATCH)
    except _Unsupported:
        return None
    except re.error:
        return None
    group_slots = 2 * (c.max_group + 1)
    if group_slots > MAX_SLOTS - c.n_loops:
        return None  # group pairs and loop marks would collide
    try:
        prog = np.array(c.instrs, dtype=np.int32).reshape(-1, 4)
    except OverflowError:
        # belt for any count that escaped into an int32 field (the
        # compile_repeat bound guard is the primary defense)
        return None
    masks = (
        np.frombuffer(b"".join(c.masks), dtype=np.uint8).reshape(-1, 32)
        if c.masks
        else np.zeros((1, 32), dtype=np.uint8)
    )
    groups = {g: True for g in range(1, c.max_group + 1)}
    return CrexProgram(
        prog=np.ascontiguousarray(prog),
        masks=np.ascontiguousarray(masks),
        n_saves=MAX_SLOTS if c.n_loops else group_slots,
        group_exists=groups,
    )


__all__ = ["compile_crex", "compile_crex_nfa", "CrexProgram", "MAX_PROG"]
