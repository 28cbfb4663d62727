"""Regex → linear class-sequence programs for the device verify kernel.

The corpus's 1,180 distinct matcher regexes are overwhelmingly "version
sniffer" shaped: byte classes, fixed repeats, small alternations, an
occasional ``+``/``*``. Those compile to a **linear pattern**: a
sequence of ≤64 positions, each a 256-bit byte-class with a repeat kind
(one / optional / self-loop), executed by bit-parallel shift-and
(Baeza-Yates/Gonnet; extended per Navarro–Raffinot for classes and
gaps) — exactly the compiler-friendly, branch-free inner loop the TPU
wants. Alternations expand to several linear patterns (OR of results),
capped.

Semantics target: Python ``re.search`` over the latin-1 decode of the
stream — the oracle's exact semantics (ops/cpu_ref.py). Every compiled
pattern is therefore *exactly* verifiable on device; patterns that
don't fit (lookarounds, backrefs, >64 positions, huge expansions)
return None and keep the host-confirm path.

Execution recurrence, per byte c over state bits D (bit i = "some
match prefix ends at position i"):

    D = (((D << 1) | SEED) & B[c]) | (D & SL[c])
    repeat r times:  D |= (D << 1) & SKIP          (epsilon closure)
    matched |= (D & ACCEPT) != 0

with B[c] position-classes, SL[c] self-loop classes, SEED the start
epsilon-closure, SKIP the skippable positions, r the longest skippable
run, ACCEPT the accepting positions (final position plus any position
from which the tail is all-skippable).
"""

from __future__ import annotations

import dataclasses
import re
import threading
import warnings
from contextlib import contextmanager
from typing import Optional

import numpy as np

try:  # py3.11+
    import re._parser as sre_parse
    import re._constants as sre_c
except ImportError:  # pragma: no cover
    import sre_parse  # type: ignore
    import sre_constants as sre_c  # type: ignore


# swarmlint-exempt: _WARN_LOCK serializes the PROCESS-GLOBAL warnings
# filter save/mutate/restore window (see quiet_warnings below) — there
# is no module attribute to guard
_WARN_LOCK = threading.Lock()


@contextmanager
def quiet_warnings(category=FutureWarning):
    """Thread-correct narrow warning suppression.

    ``catch_warnings`` saves/restores the PROCESS-GLOBAL filter list;
    unsynchronized enter/exit from worker thread pools can interleave
    so a temporary ignore-filter is restored as the permanent state
    (or a concurrent compile warns nondeterministically). The shared
    lock serializes the save/mutate/restore window. A module-import
    ``filterwarnings`` is no alternative: pytest wraps every test in
    its own catch_warnings that resets to configured filters, which
    would resurface the noise the suite must stay free of."""
    with _WARN_LOCK:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category)
            yield


def parse_quiet(pattern: str):
    """``sre_parse.parse`` with the nested-set FutureWarning silenced.

    Corpus patterns contain literal ``[[`` (e.g. ``[[:alpha:]]`` POSIX
    classes written for PCRE engines); their *current* Python-re
    semantics are exactly what every lowering here must reproduce, and
    the warning re-fires on each corpus compile otherwise. Shared by
    all sre-tree walks (regexlin, fastre, compile)."""
    with quiet_warnings():
        return sre_parse.parse(pattern)

MAX_POSITIONS = 96  # 3 uint32 state lanes
MAX_SEQUENCES = 48  # branch-expansion cap per pattern
MAX_SKIP_RUN = 8  # longest consecutive-optional run we unroll

K_ONE, K_OPT, K_LOOP, K_OPTLOOP = 0, 1, 2, 3  # X, X?, X+ (loop), X*

# end-of-match anchor modes
END_NONE, END_Z, END_DOLLAR = 0, 1, 2

_WORD_BYTES = np.array(
    [re.match(r"\w", chr(b)) is not None for b in range(256)], dtype=bool
)


@dataclasses.dataclass
class LinearPattern:
    """One branch-free alternative of a compiled regex."""

    classes: np.ndarray  # uint32 [m, 8] — bit b of word b>>5: byte in class
    kinds: np.ndarray  # int8 [m] — K_* repeat kind
    max_skip_run: int
    unbounded: bool  # any self-loop ⇒ match length unbounded
    anchored: bool = False  # \A/^ — match must start at byte 0
    end_mode: int = END_NONE  # \Z / $ — match must end at stream end
    start_wb: bool = False  # leading \b
    end_wb: bool = False  # trailing \b

    @property
    def m(self) -> int:
        return int(self.classes.shape[0])

    @property
    def max_len(self) -> Optional[int]:
        return None if self.unbounded else self.m


# --- byte-class construction -----------------------------------------------

_CATEGORY_BYTES: dict = {}


def _category_mask(cat) -> np.ndarray:
    """256-bool membership for an sre CATEGORY, via Python's own regex
    semantics over latin-1 code points (so \\w includes e.g. µ exactly
    when re does)."""
    got = _CATEGORY_BYTES.get(cat)
    if got is not None:
        return got
    name = str(cat)
    base = {
        "CATEGORY_DIGIT": r"\d",
        "CATEGORY_NOT_DIGIT": r"\D",
        "CATEGORY_WORD": r"\w",
        "CATEGORY_NOT_WORD": r"\W",
        "CATEGORY_SPACE": r"\s",
        "CATEGORY_NOT_SPACE": r"\S",
    }.get(name.split(".")[-1])
    if base is None:
        raise _Unsupported(f"category {name}")
    rex = re.compile(base)
    mask = np.array(
        [rex.match(chr(b)) is not None for b in range(256)], dtype=bool
    )
    _CATEGORY_BYTES[cat] = mask
    return mask


class _Unsupported(Exception):
    pass


def _case_fold(mask: np.ndarray) -> np.ndarray:
    """IGNORECASE closure: both cases of every member match.
    Multi-char case maps ('ß'.upper() == 'SS') don't fold to a single
    byte and are left alone — matching Python's simple casefold for
    single-char classes."""
    folded = mask.copy()
    for b in np.flatnonzero(mask):
        c = chr(int(b))
        for other in (c.lower(), c.upper()):
            if len(other) == 1 and ord(other) < 256:
                folded[ord(other)] = True
    return folded


def _class_mask(items, ci: bool) -> np.ndarray:
    """256-bool membership for an IN item list (or a single token).

    Under IGNORECASE the fold applies to the *positive* member set
    before negation ([^a] must reject both 'a' and 'A')."""
    mask = np.zeros(256, dtype=bool)
    negate = False
    for op, arg in items:
        name = str(op)
        if name == "NEGATE":
            negate = True
        elif name == "LITERAL":
            if arg > 255:
                continue  # can't occur in latin-1 text
            mask[arg] = True
        elif name == "RANGE":
            lo, hi = arg
            mask[max(0, lo) : min(255, hi) + 1] = True
        elif name == "CATEGORY":
            mask |= _category_mask(arg)
        else:
            raise _Unsupported(f"class item {name}")
    if ci:
        mask = _case_fold(mask)
    if negate:
        mask = ~mask
    return mask


def _lower_fold(mask: np.ndarray) -> np.ndarray:
    """Project a raw-byte mask onto the ASCII-lowered stream domain:
    observed byte x could be original x or (if x is a lowercase
    letter) its uppercase form."""
    out = mask.copy()
    for b in range(ord("a"), ord("z") + 1):
        out[b] = mask[b] or mask[b - 32]
    # uppercase letters never appear in a lowered stream
    out[ord("A") : ord("Z") + 1] = False
    return out


# --- parse-tree walk --------------------------------------------------------


def _expand(
    seq, ci: bool, dotall: bool = False
) -> list[list[tuple[np.ndarray, int]]]:
    """sre subpattern → list of alternatives, each a list of
    (byte-mask, kind). Raises _Unsupported to reject."""
    outs: list[list[tuple[np.ndarray, int]]] = [[]]

    def cross(alts: list[list[tuple[np.ndarray, int]]]) -> None:
        nonlocal outs
        nxt = [o + a for o in outs for a in alts]
        if len(nxt) > MAX_SEQUENCES:
            raise _Unsupported("alternation explosion")
        outs = nxt

    for op, arg in seq:
        name = str(op)
        if name == "LITERAL":
            if arg > 255:
                raise _Unsupported("non-latin literal")
            mask = np.zeros(256, dtype=bool)
            mask[arg] = True
            if ci:
                c = chr(arg)
                for other in (c.lower(), c.upper()):
                    if len(other) == 1 and ord(other) < 256:
                        mask[ord(other)] = True
            cross([[(mask, K_ONE)]])
        elif name == "NOT_LITERAL":
            mask = np.ones(256, dtype=bool)
            if arg <= 255:
                mask[arg] = False
                if ci:
                    c = chr(arg)
                    for other in (c.lower(), c.upper()):
                        if len(other) == 1 and ord(other) < 256:
                            mask[ord(other)] = False
            cross([[(mask, K_ONE)]])
        elif name == "ANY":
            mask = np.ones(256, dtype=bool)
            if not dotall:
                mask[ord("\n")] = False
            cross([[(mask, K_ONE)]])
        elif name == "IN":
            cross([[(_class_mask(arg, ci), K_ONE)]])
        elif name == "SUBPATTERN":
            _gid, add_flags, del_flags, sub = arg
            if add_flags & re.ASCII:
                # scoped (?a:) — same Unicode-vs-ASCII mask hazard as
                # the top-level guard in compile_linear
                raise _Unsupported("ascii-flag scope")
            sub_ci = (ci or bool(add_flags & re.IGNORECASE)) and not bool(
                del_flags & re.IGNORECASE
            )
            if sub_ci != ci:
                raise _Unsupported("mixed-case scopes")
            # scoped (?s:)/(?-s:) only changes ANY masks — no stream
            # choice involved, so mixing is fine
            sub_dotall = (
                dotall or bool(add_flags & re.DOTALL)
            ) and not bool(del_flags & re.DOTALL)
            cross(_expand(sub, sub_ci, sub_dotall))
        elif name == "BRANCH":
            alts: list[list[tuple[np.ndarray, int]]] = []
            for branch in arg[1]:
                alts.extend(_expand(branch, ci, dotall))
                if len(alts) > MAX_SEQUENCES:
                    raise _Unsupported("alternation explosion")
            cross(alts)
        elif name in ("MAX_REPEAT", "MIN_REPEAT"):
            lo, hi, sub = arg
            if hi == 0:
                continue  # X{0} / (X+){0} matches only the empty string
            sub_alts = _expand(sub, ci, dotall)
            single = (
                len(sub_alts) == 1 and len(sub_alts[0]) == 1
            )
            if single:
                mask, kind = sub_alts[0][0]
                # kind algebra for nested repeats of one position:
                # (X+)? = X*, (X?)*= X*, (X+){2,3} = X{2,}, …
                skippable = kind in (K_OPT, K_OPTLOOP)
                loopy = kind in (K_LOOP, K_OPTLOOP)
                eff_lo = 0 if skippable else lo
                unbounded = loopy or hi == sre_c.MAXREPEAT
                if unbounded:
                    if eff_lo > MAX_POSITIONS:
                        raise _Unsupported("huge repeat")
                    fixed = [(mask, K_ONE)] * max(eff_lo - 1, 0)
                    loop = [(mask, K_LOOP if eff_lo >= 1 else K_OPTLOOP)]
                    cross([fixed + loop])
                else:
                    if hi > MAX_POSITIONS:
                        raise _Unsupported("huge repeat")
                    cross(
                        [
                            [(mask, K_ONE)] * eff_lo
                            + [(mask, K_OPT)] * (hi - eff_lo)
                        ]
                    )
            else:
                # multi-position group: expand counts as alternatives
                if hi == sre_c.MAXREPEAT or hi > 4:
                    raise _Unsupported("unbounded group repeat")
                alts = []
                for n in range(lo, hi + 1):
                    reps: list[list[tuple[np.ndarray, int]]] = [[]]
                    for _ in range(n):
                        reps = [r + a for r in reps for a in sub_alts]
                        if len(reps) > MAX_SEQUENCES:
                            raise _Unsupported("group repeat explosion")
                    alts.extend(reps)
                if len(alts) > MAX_SEQUENCES:
                    raise _Unsupported("group repeat explosion")
                cross(alts)
        elif name == "AT":
            # anchors need absolute stream positions — host keeps them
            raise _Unsupported("anchor")
        else:
            raise _Unsupported(name)
    return outs


def compile_linear(pattern: str) -> Optional[tuple[list[LinearPattern], bool]]:
    """→ (alternatives, case_insensitive) or None.

    ``re.search(pattern, text)`` is True iff any alternative's
    shift-and run accepts — alternatives are an exact OR-decomposition.
    ci alternatives run on the ASCII-lowered stream (their masks are
    pre-folded to the lowered byte domain).

    Edge assertions are supported when they sit at the pattern's very
    ends: ``\\A``/``^`` (anchored start), ``\\Z``/``$`` (anchored
    end; ``$`` keeps its before-final-newline semantics), and ``\\b``
    (word boundary). Interior assertions reject.
    """
    try:
        tree = parse_quiet(pattern)
    except re.error:
        return None
    ci = bool(tree.state.flags & re.IGNORECASE)
    dotall = bool(tree.state.flags & re.DOTALL)
    if tree.state.flags & re.MULTILINE:
        return None  # ^/$ become per-line — out of scope
    if tree.state.flags & re.ASCII:
        # class/category masks below are computed under Unicode
        # semantics; (?a) flips \w/\s/[^...] membership for bytes
        # >= 0x80 — lowering would be a silent false negative on the
        # exact no-host-confirm device path. Keep the host path.
        return None
    toks = list(tree)
    anchored = start_wb = end_wb = False
    end_mode = END_NONE
    while toks and str(toks[0][0]) == "AT":
        at = str(toks[0][1]).rsplit(".", 1)[-1]
        if at in ("AT_BEGINNING", "AT_BEGINNING_STRING"):
            anchored = True
        elif at == "AT_BOUNDARY":
            start_wb = True
        else:
            return None
        toks.pop(0)
    while toks and str(toks[-1][0]) == "AT":
        at = str(toks[-1][1]).rsplit(".", 1)[-1]
        if at == "AT_END_STRING":
            end_mode = END_Z
        elif at == "AT_END":
            end_mode = END_DOLLAR
        elif at == "AT_BOUNDARY":
            end_wb = True
        else:
            return None
        toks.pop(-1)
    if end_wb and end_mode != END_NONE:
        return None  # unusual combo; keep the host path
    try:
        alts = _expand(toks, ci, dotall)
    except _Unsupported:
        return None
    out = []
    for seq in alts:
        if not seq or all(k in (K_OPT, K_OPTLOOP) for _msk, k in seq):
            # matches the empty string — search is always True; the
            # shift-and recurrence only accepts after consuming ≥1 byte
            return None
        if len(seq) > MAX_POSITIONS:
            return None
        m = len(seq)
        classes = np.zeros((m, 8), dtype=np.uint32)
        kinds = np.zeros((m,), dtype=np.int8)
        run = mx = 0
        for i, (mask, kind) in enumerate(seq):
            if ci:
                mask = _lower_fold(mask)
            bits = np.packbits(mask.astype(np.uint8), bitorder="little")
            classes[i] = bits.view("<u4")
            kinds[i] = kind
            if kind in (K_OPT, K_OPTLOOP):
                run += 1
                mx = max(mx, run)
            else:
                run = 0
        if mx > MAX_SKIP_RUN:
            return None
        out.append(
            LinearPattern(
                classes=classes,
                kinds=kinds,
                max_skip_run=mx,
                unbounded=bool(
                    np.isin(kinds, (K_LOOP, K_OPTLOOP)).any()
                ),
                anchored=anchored,
                end_mode=end_mode,
                start_wb=start_wb,
                end_wb=end_wb,
            )
        )
    return out, ci


# --- reference simulator (numpy; the device kernel mirrors this) -----------


def derived_masks(p: LinearPattern):
    """(seed, skip, accept, self_loop_mask) as python ints over m bits."""
    m = p.m
    skippable = np.isin(p.kinds, (K_OPT, K_OPTLOOP))
    self_loop = np.isin(p.kinds, (K_LOOP, K_OPTLOOP))
    seed = 0
    for i in range(m):
        seed |= 1 << i
        if not skippable[i]:
            break
    skip = 0
    accept = 1 << (m - 1)
    for i in range(m):
        if skippable[i]:
            skip |= 1 << i
    for i in range(m - 2, -1, -1):
        if skippable[i + 1:].all():
            accept |= 1 << i
    sl = 0
    for i in range(m):
        if self_loop[i]:
            sl |= 1 << i
    return seed, skip, accept, sl


def byte_in_class(p: LinearPattern, i: int, c: int) -> bool:
    return bool((p.classes[i, c >> 5] >> (c & 31)) & 1)


def search_ref(p: LinearPattern, data: bytes) -> bool:
    """Pure-python shift-and over ``data`` — the spec the device kernel
    and the fuzz tests both check against."""
    seed, skip, accept, sl = derived_masks(p)
    m = p.m
    D = 0
    pending = False  # accept awaiting the trailing-\b check
    pending_word = False  # wordness of that accept's final char
    n = len(data)
    for t, c in enumerate(data):
        w_c = bool(_WORD_BYTES[c])
        if pending and (pending_word != w_c):
            return True
        pending = False
        bc = 0
        for i in range(m):
            if byte_in_class(p, i, c):
                bc |= 1 << i
        s = seed
        if p.anchored and t > 0:
            s = 0
        if p.start_wb:
            w_prev = t > 0 and bool(_WORD_BYTES[data[t - 1]])
            if not (w_c != w_prev):
                s = 0
        D = (((D << 1) | s) & bc) | (D & sl & bc)
        for _ in range(p.max_skip_run):
            D |= (D << 1) & skip
        D &= (1 << m) - 1
        if D & accept:
            if p.end_wb:
                pending = True
                pending_word = w_c
            elif p.end_mode == END_NONE:
                return True
            elif p.end_mode == END_Z:
                if t == n - 1:
                    return True
            else:  # END_DOLLAR: end, or just before a final newline
                if t == n - 1 or (t == n - 2 and data[n - 1] == 0x0A):
                    return True
    # end of stream is a boundary exactly after a word char
    return pending and pending_word


def search_pattern(
    alts: list[LinearPattern], ci: bool, data: bytes
) -> bool:
    if ci:
        data = bytes(
            c + 32 if 65 <= c <= 90 else c for c in data
        )
    return any(search_ref(p, data) for p in alts)
