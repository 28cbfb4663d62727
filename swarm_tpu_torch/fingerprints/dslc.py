"""nuclei matcher-DSL compiler: parse → AST → evaluate (host) / lower (device).

The corpus's 766 ``dsl`` matchers are govaluate-style expressions such as
``len(body)==2336 && status_code==200 && md5(body)=="…"``
(``technologies/favicon-detection.yaml:23-27`` in the reference corpus).
This module parses them once into a small AST that both the exact host
evaluator (here) and the device lowering (``fingerprints/compile.py``,
``lower_dsl``) consume.

AST node forms (plain tuples, trivially traversable):
  ("lit", value) · ("var", name) · ("call", fname, [args])
  ("bin", op, lhs, rhs) · ("un", op, expr)
"""

from __future__ import annotations

import base64 as _b64
import hashlib
import re
import time as _time

from swarm_tpu_torch.fingerprints.regexlin import quiet_warnings
from typing import Any, Callable, Optional


class DslError(ValueError):
    pass


# Backslashes that do NOT start a recognized escape sequence stay
# literal ("\d" in a dsl regex string). unicode_escape currently warns
# on them and will eventually raise — pre-doubling the invalid ones
# pins today's pass-through semantics, warning-free and future-proof.
# One pass, consuming each escape atomically (a "\\-" must not have its
# second backslash re-examined as the start of an invalid "\-").
_ESC_SCAN = re.compile(
    r"\\(?:(\n|[\\'\"abfnrtv]|[0-7]{1,3}|x[0-9a-fA-F]{2}"
    r"|u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|N\{[^}]+\})|(.)|$)",
    re.DOTALL,
)


def _unescape_literal(body: str) -> str:
    def fix(m: "re.Match[str]") -> str:
        if m.group(1) is not None:
            return m.group(0)  # recognized escape — decode below
        if m.group(2) is not None:
            return "\\\\" + m.group(2)  # invalid — backslash is literal
        return "\\\\"  # lone trailing backslash
    return _ESC_SCAN.sub(fix, body).encode().decode("unicode_escape")


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>\d+\.\d+|\d+)
      | (?P<str>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>\|\||&&|==|!=|<=|>=|=~|!~|<<|>>|[-+*/%()!,<>])
    )""",
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise DslError(f"bad token at {text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("num", "str", "name", "op"):
            val = m.group(kind)
            if val is not None:
                tokens.append((kind, val))
                break
    tokens.append(("eof", ""))
    return tokens


# ---------------------------------------------------------------------------
# Pratt parser
# ---------------------------------------------------------------------------

_BINARY_PRECEDENCE = {
    "||": 1,
    "&&": 2,
    "==": 3, "!=": 3, "=~": 3, "!~": 3,
    "<": 4, ">": 4, "<=": 4, ">=": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
}


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.tokens[self.i]

    def next(self) -> tuple[str, str]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, val = self.next()
        if val != value:
            raise DslError(f"expected {value!r}, got {val!r}")

    def parse_expression(self, min_prec: int = 0) -> tuple:
        left = self.parse_unary()
        while True:
            kind, val = self.peek()
            prec = _BINARY_PRECEDENCE.get(val)
            if kind != "op" or prec is None or prec < min_prec:
                return left
            self.next()
            right = self.parse_expression(prec + 1)
            left = ("bin", val, left, right)

    def parse_unary(self) -> tuple:
        kind, val = self.peek()
        if kind == "op" and val == "!":
            self.next()
            return ("un", "!", self.parse_unary())
        if kind == "op" and val == "-":
            self.next()
            return ("un", "-", self.parse_unary())
        return self.parse_primary()

    def parse_primary(self) -> tuple:
        kind, val = self.next()
        if kind == "num":
            return ("lit", float(val) if "." in val else int(val))
        if kind == "str":
            body = val[1:-1]
            if "\\" in body:
                body = _unescape_literal(body)
            return ("lit", body)
        if kind == "name":
            if val in ("true", "false"):
                return ("lit", val == "true")
            nkind, nval = self.peek()
            if nkind == "op" and nval == "(":
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_expression())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_expression())
                self.expect(")")
                return ("call", val, args)
            return ("var", val)
        if kind == "op" and val == "(":
            expr = self.parse_expression()
            self.expect(")")
            return expr
        raise DslError(f"unexpected token {val!r}")


def parse_dsl(text: str) -> tuple:
    parser = _Parser(_tokenize(text))
    ast = parser.parse_expression()
    if parser.peek()[0] != "eof":
        raise DslError(f"trailing input after expression: {text!r}")
    return ast


# ---------------------------------------------------------------------------
# Host evaluator (the exact/oracle semantics)
# ---------------------------------------------------------------------------


def _to_bytes(v: Any) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("utf-8", "surrogateescape")
    return str(v).encode()


def _text(v: Any) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return str(v)


_REGEX_CACHE: dict[str, "re.Pattern[str]"] = {}


def compile_cached(pattern: str) -> "re.Pattern[str]":
    """Unbounded pattern→compiled cache shared by the DSL evaluator and
    the CPU oracle (the corpus outgrows re's 512-entry internal cache).

    The nested-set FutureWarning family ("possible nested set" —
    corpus patterns with literal '[[') is suppressed through
    regexlin.quiet_warnings, the lock-serialized guard (compiles also
    run from worker thread pools, where bare catch_warnings races on
    the process-global filter list)."""
    compiled = _REGEX_CACHE.get(pattern)
    if compiled is None:
        with quiet_warnings():
            compiled = _REGEX_CACHE[pattern] = re.compile(pattern)
    return compiled


def _search(pattern: str, text: str):
    return compile_cached(pattern).search(text)


_FUNCTIONS: dict[str, Callable] = {
    "len": lambda v: len(_to_bytes(v)) if isinstance(v, (bytes, str)) else len(v),
    "md5": lambda v: hashlib.md5(_to_bytes(v)).hexdigest(),
    "sha1": lambda v: hashlib.sha1(_to_bytes(v)).hexdigest(),
    "sha256": lambda v: hashlib.sha256(_to_bytes(v)).hexdigest(),
    "contains": lambda hay, needle: _to_bytes(needle) in _to_bytes(hay),
    "tolower": lambda v: _to_bytes(v).lower(),
    "toupper": lambda v: _to_bytes(v).upper(),
    "trim_space": lambda v: _to_bytes(v).strip(),
    "base64": lambda v: _b64.b64encode(_to_bytes(v)).decode(),
    "base64_decode": lambda v: _b64.b64decode(_to_bytes(v)),
    "hex_encode": lambda v: _to_bytes(v).hex(),
    "regex": lambda pattern, v: _search(_text(pattern), _text(v)) is not None,
    "mmh3": None,  # installed below (needs helper)
    # wall-clock seconds; corpus use: ssl/expired-ssl.yaml
    # ``unixtime() > not_after`` (evaluated host-side by the ssl scanner)
    "unixtime": lambda: int(_time.time()),
}


def _mmh3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit — the hash nuclei's favicon dsl uses.

    Pure-python reference; the device version lives in ops/hashes.py.
    Returns the *signed* 32-bit value (Shodan/nuclei convention).
    """
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


_FUNCTIONS["mmh3"] = lambda v: str(_mmh3_32(_to_bytes(v)))


def _cmp_coerce(a: Any, b: Any) -> tuple[Any, Any]:
    """Make ==/</> tolerant of bytes-vs-str and str-vs-number mixes."""
    if isinstance(a, bool) or isinstance(b, bool):
        return a, b
    if isinstance(a, (bytes, str)) and isinstance(b, (bytes, str)):
        return _to_bytes(a), _to_bytes(b)
    if isinstance(a, (int, float)) and isinstance(b, (bytes, str)):
        try:
            return a, float(_text(b))
        except ValueError:
            return str(a), _text(b)
    if isinstance(b, (int, float)) and isinstance(a, (bytes, str)):
        b2, a2 = _cmp_coerce(b, a)
        return a2, b2
    return a, b


def evaluate(ast: tuple, env: dict[str, Any]) -> Any:
    kind = ast[0]
    if kind == "lit":
        return ast[1]
    if kind == "var":
        name = ast[1]
        if name not in env:
            raise DslError(f"unknown variable {name!r}")
        return env[name]
    if kind == "un":
        v = evaluate(ast[2], env)
        return (not v) if ast[1] == "!" else -v
    if kind == "call":
        fn = _FUNCTIONS.get(ast[1])
        if fn is None:
            raise DslError(f"unknown function {ast[1]!r}")
        return fn(*(evaluate(a, env) for a in ast[2]))
    if kind == "bin":
        op = ast[1]
        if op == "&&":
            return bool(evaluate(ast[2], env)) and bool(evaluate(ast[3], env))
        if op == "||":
            return bool(evaluate(ast[2], env)) or bool(evaluate(ast[3], env))
        a, b = evaluate(ast[2], env), evaluate(ast[3], env)
        if op in ("==", "!=", "<", ">", "<=", ">="):
            a, b = _cmp_coerce(a, b)
            try:
                result = {
                    "==": a == b, "!=": a != b,
                    "<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b,
                }[op]
            except TypeError:
                result = False if op != "!=" else True
            return result
        if op == "=~":
            return _search(_text(b), _text(a)) is not None
        if op == "!~":
            return _search(_text(b), _text(a)) is None
        if op == "+":
            if isinstance(a, (bytes, str)) or isinstance(b, (bytes, str)):
                return _to_bytes(a) + _to_bytes(b)
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return a % b
    raise DslError(f"bad AST node {ast!r}")


def build_env(response) -> dict[str, Any]:
    """DSL variable environment for one :class:`Response`."""
    body = response.part("body")
    header = response.part("header")
    return {
        "body": body,
        "header": header,
        "all_headers": header,
        "raw": response.part("raw"),
        "status_code": response.status,
        "content_length": response.content_length,
        "host": response.host,
        "port": response.port,
        "duration": response.duration_s,
        # OOB interaction vars: filled by the worker's callback
        # listener (worker/oob.py); empty without one — the matchers
        # then evaluate False, same as nuclei with OOB disabled
        "interactsh_protocol": " ".join(response.oob_protocols),
        "interactsh_request": response.oob_requests,
    }


_PARSE_CACHE: dict[str, Optional[tuple]] = {}


def try_parse(text: str) -> Optional[tuple]:
    """Parse-or-None, memoized: the corpus has a few thousand distinct
    expressions but the engine's sparse confirmation path re-evaluates
    the hot ones per fired row — parsing must not dominate that."""
    try:
        return _PARSE_CACHE[text]
    except KeyError:
        try:
            ast = parse_dsl(text)
        except DslError:
            ast = None
        if len(_PARSE_CACHE) < 65536:
            _PARSE_CACHE[text] = ast
        return ast


#: Names ``build_env`` defines — the oracle's complete variable surface.
ENV_VARS = frozenset(
    {
        "body", "header", "all_headers", "raw", "status_code",
        "content_length", "host", "port", "duration",
        "interactsh_protocol", "interactsh_request",
    }
)


def always_errors(ast: tuple) -> bool:
    """True if evaluating ``ast`` raises for *every* environment —
    i.e. an unknown variable/function sits on an unconditionally
    evaluated path (&&/|| short-circuit only protects the RIGHT
    operand; comparisons/arithmetic/calls evaluate both sides).

    The oracle maps an evaluation error to "matcher unsupported" →
    verdict False with negation NOT applied (cpu_ref.match_matcher),
    so an always-erroring expression makes its whole matcher a
    compile-time constant False — the multi-step template tail
    (status_code_2, body_1, set_cookie…) lowers exactly this way.
    """
    kind = ast[0]
    if kind == "lit":
        return False
    if kind == "var":
        return ast[1] not in ENV_VARS
    if kind == "un":
        return always_errors(ast[2])
    if kind == "call":
        if ast[1] not in _FUNCTIONS:
            return True
        return any(always_errors(a) for a in ast[2])
    if kind == "bin":
        if ast[1] in ("&&", "||"):
            return always_errors(ast[2])
        return always_errors(ast[2]) or always_errors(ast[3])
    return False


def effectively_false(ast: tuple) -> bool:
    """True if every evaluation either errors or yields falsy — both of
    which make a single-expression (or AND-listed) dsl matcher False:
    an error marks the whole matcher unsupported → False, and a falsy
    value is False outright. The canonical corpus shape is
    ``status_code==200 && "…" == mmh3(base64_py(body))`` — the unknown
    function only errors when the guard passes, so ``always_errors``
    alone can't fold it, but False-or-error still holds row-wise.
    """
    if always_errors(ast):
        return True
    kind = ast[0]
    if kind == "bin":
        if ast[1] == "&&":
            return effectively_false(ast[2]) or effectively_false(ast[3])
        if ast[1] == "||":
            return effectively_false(ast[2]) and effectively_false(ast[3])
    return False
