"""First-party jq evaluator (recursive-descent parser + stream semantics).

A copy of ``sdtk_tpu/utils/jqlite.py`` (pure Python, the same outputs
and errors).

The reference shells out to the ``jq`` binary for ad-hoc queries
(speaker_detection:705-728, speaker-catalog:655-688) and its docs pipe
full jq programs (speaker-report.README.md:413, speaker_segments.README
.md:155).  This environment has no jq, and the framework's design
replaces external binaries with first-party code (like BLAKE3 and the
audio codecs) — so this module implements the jq language subset the
reference's documented workflows actually use, with real jq semantics:

- streams: every expression maps one input to zero-or-more outputs;
- paths ``.a.b[2].c``, iteration ``.[]``, slices ``.[1:3]``, optional
  ``?`` (suppresses type errors), recursive pipe ``a | b``, comma
  ``a, b`` (output concatenation), alternative ``a // b``;
- arithmetic ``+ - * / %`` (jq type rules: string/array concat, object
  merge), comparisons with jq's total value order, ``and``/``or``/
  ``not`` with jq truthiness (null/false are falsy);
- string interpolation ``"\\(expr)"``;
- array ``[expr]`` and object ``{a: f, "b": g, c}`` construction;
- variables: ``EXPR as $x | BODY`` bindings and ``$x`` references
  (lexically scoped; ``.end``-style keyword fields still work — the
  tokenizer distinguishes attached ``.as`` from ``. as``);
- conditionals ``if C then A elif C2 then B else D end`` (missing
  ``else`` defaults to identity, jq semantics);
- folds: ``reduce SRC as $x (INIT; UPDATE)`` and
  ``foreach SRC as $x (INIT; UPDATE[; EXTRACT])``;
- user functions: ``def f: BODY;``, ``def f(g; $x): BODY;`` — filter
  params are call-site closures, ``$params`` bind the evaluated
  argument stream, recursion works, defs shadow builtins (jq
  semantics; scoped over the remainder of the program);
- error handling: ``try EXPR``, ``try EXPR catch HANDLER`` (handler
  input = the error message);
- regex builtins (Python ``re`` as the engine; jq's ``(?<name>…)``
  named groups are translated): test, match, capture, scan, splits,
  split/2, sub, gsub — with ``g``/``i``/``x``/``s``/``m`` modifier
  flags and jq-shaped match/capture objects;
- builtins: length, keys, keys_unsorted, values, has, contains, inside,
  select, map, group_by, sort, sort_by, unique, unique_by, add, min,
  max, min_by, max_by, reverse, flatten, range, floor, ceil, round,
  sqrt, abs, fabs, tostring, tonumber, type, not, empty, error, first,
  last, any, all, startswith, endswith, ltrimstr, rtrimstr,
  ascii_downcase, ascii_upcase, join, split, to_entries, from_entries.

Out of scope — and failing LOUDLY with :class:`JqError`, never silently
returning wrong data: destructuring patterns after ``as``, ``label``,
paths/``del``/assignment, ``@base64``-style formats, recursive descent
``..``.

Public API (unchanged): :func:`query`, :func:`query_lines`,
:class:`JqError`.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Callable, Iterable, Iterator


class JqError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TWO_CHAR = ("==", "!=", ">=", "<=", "//", "|=", "+=", "-=")
_ONE_CHAR = ".[](){}:;,|+-*/%<>?="
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_NUMBER = re.compile(r"\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


class _Tok:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any = None):
        self.kind = kind
        self.value = value

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"Tok({self.kind!r}, {self.value!r})"


def _tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "#":  # comment to end of line
            while i < n and src[i] != "\n":
                i += 1
            continue
        if ch == '"':
            parts, i = _scan_string(src, i)
            toks.append(_Tok("string", parts))
            continue
        if ch == "'":
            # jq has no single-quoted strings, but shell-quoted queries
            # often reach us this way; treat as a plain string literal.
            j = src.find("'", i + 1)
            if j < 0:
                raise JqError("unterminated string")
            toks.append(_Tok("string", [src[i + 1 : j]]))
            i = j + 1
            continue
        if ch == "$":
            m = _IDENT.match(src, i + 1)
            if not m:
                raise JqError("expected a name after '$'")
            toks.append(_Tok("var", m.group(0)))
            i = m.end()
            continue
        if ch == "@":
            raise JqError("@format strings are not supported (jqlite subset)")
        two = src[i : i + 2]
        if two in _TWO_CHAR:
            if two in ("|=", "+=", "-="):
                raise JqError(f"assignment '{two}' is not supported (jqlite subset)")
            toks.append(_Tok(two))
            i += 2
            continue
        if ch.isdigit():
            m = _NUMBER.match(src, i)
            assert m is not None
            text = m.group(0)
            toks.append(
                _Tok("number", float(text) if ("." in text or "e" in text.lower())
                     else int(text))
            )
            i = m.end()
            continue
        if ch == "." and i + 1 < n and _IDENT.match(src, i + 1):
            # ".name" with NO whitespace is a field access (jq allows
            # keyword-named fields like `.end`); ". name" keeps the dot
            # separate so `. as $x` parses as a binding.
            m = _IDENT.match(src, i + 1)
            toks.append(_Tok("field", m.group(0)))
            i = m.end()
            continue
        m = _IDENT.match(src, i)
        if m:
            toks.append(_Tok("ident", m.group(0)))
            i = m.end()
            continue
        if ch in _ONE_CHAR:
            if ch == "=":
                raise JqError("assignment '=' is not supported (jqlite subset)")
            toks.append(_Tok(ch))
            i += 1
            continue
        raise JqError(f"unexpected character {ch!r} in query")
    toks.append(_Tok("eof"))
    return toks


def _scan_string(src: str, i: int) -> tuple[list[Any], int]:
    """Scan a double-quoted string starting at src[i] == '"'.  Returns a
    list of parts — plain ``str`` pieces and ``("interp", node)`` tuples
    for ``\\(expr)`` interpolations — plus the index after the close."""
    assert src[i] == '"'
    i += 1
    parts: list[Any] = []
    buf: list[str] = []
    n = len(src)
    while i < n:
        ch = src[i]
        if ch == '"':
            if buf:
                parts.append("".join(buf))
            return parts, i + 1
        if ch == "\\":
            if i + 1 >= n:
                raise JqError("unterminated escape in string")
            nxt = src[i + 1]
            if nxt == "(":
                # interpolation: find the matching close paren
                depth, j = 1, i + 2
                while j < n and depth:
                    if src[j] == '"':
                        # skip nested strings wholesale
                        _, j = _scan_string(src, j)
                        continue
                    if src[j] == "(":
                        depth += 1
                    elif src[j] == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                if depth:
                    raise JqError("unterminated \\( interpolation")
                if buf:
                    parts.append("".join(buf))
                    buf = []
                parts.append(("interp", _parse(src[i + 2 : j])))
                i = j + 1
                continue
            escape = {"n": "\n", "t": "\t", "r": "\r", '"': '"',
                      "\\": "\\", "/": "/", "b": "\b", "f": "\f"}
            if nxt == "u":
                if i + 6 > n:
                    raise JqError("bad \\u escape")
                buf.append(chr(int(src[i + 2 : i + 6], 16)))
                i += 6
                continue
            if nxt not in escape:
                raise JqError(f"bad escape \\{nxt}")
            buf.append(escape[nxt])
            i += 2
            continue
        buf.append(ch)
        i += 1
    raise JqError("unterminated string")


# ---------------------------------------------------------------------------
# Parser — AST nodes are ("kind", ...) tuples
# ---------------------------------------------------------------------------

_RESERVED = {"and", "or", "not", "as", "def", "reduce", "foreach", "if",
             "then", "elif", "else", "end", "try", "catch", "import",
             "include", "label"}
_UNSUPPORTED_KW = {"import", "include", "label"}
# Keywords that terminate an expression (consumed by the if/reduce
# parsers, never valid as a function call).
_STOP_KW = {"then", "elif", "else", "end", "as", "catch"}


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.pos = 0

    def peek(self) -> _Tok:
        return self.toks[self.pos]

    def next(self) -> _Tok:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, kind: str) -> _Tok:
        t = self.next()
        if t.kind != kind:
            raise JqError(f"expected {kind!r}, got {t.kind!r}")
        return t

    # pipe := 'def' NAME params? ':' pipe ';' pipe
    #       | comma ('as' $var '|' pipe | ('|' pipe-tail)*)
    def parse_pipe(self):
        t = self.peek()
        if t.kind == "ident" and t.value == "def":
            return self._parse_def()
        node = self.parse_comma()
        if self.peek().kind == "ident" and self.peek().value == "as":
            self.next()
            t = self.next()
            if t.kind != "var":
                raise JqError("destructuring patterns after 'as' are not "
                              "supported (jqlite subset: 'EXPR as $name')")
            self.expect("|")
            return ("bind", node, t.value, self.parse_pipe())
        while self.peek().kind == "|":
            self.next()
            nxt = self.peek()
            if nxt.kind == "ident" and nxt.value == "def":
                # `a | def f: ...; b` — the def scopes over the whole
                # remainder, which parse_pipe handles recursively.
                return ("pipe", node, self.parse_pipe())
            node = ("pipe", node, self.parse_comma())
        return node

    def _parse_def(self):
        """def NAME: BODY; REST / def NAME(p1; p2): BODY; REST — the
        definition is lexically scoped over REST (jq semantics).  Params
        are either filter names (callable inside the body with the
        call-site argument expression as a closure) or ``$names`` (the
        argument stream is evaluated at the call site and bound as a
        variable)."""
        self.next()  # 'def'
        t = self.next()
        if t.kind != "ident":
            raise JqError("expected a function name after 'def'")
        fname = t.value
        params: list[str] = []
        if self.peek().kind == "(":
            self.next()
            while True:
                p = self.next()
                if p.kind == "var":
                    params.append("$" + p.value)
                elif p.kind == "ident":
                    params.append(p.value)
                else:
                    raise JqError("expected parameter name in def")
                if self.peek().kind == ";":
                    self.next()
                    continue
                self.expect(")")
                break
        self.expect(":")
        body = self.parse_pipe()
        self.expect(";")
        rest = self.parse_pipe()
        return ("funcdef", fname, params, body, rest)

    # comma := alt (',' alt)*
    def parse_comma(self):
        node = self.parse_alt()
        while self.peek().kind == ",":
            self.next()
            node = ("comma", node, self.parse_alt())
        return node

    # alt := or ('//' or)*
    def parse_alt(self):
        node = self.parse_or()
        while self.peek().kind == "//":
            self.next()
            node = ("alt", node, self.parse_or())
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek().kind == "ident" and self.peek().value == "or":
            self.next()
            node = ("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek().kind == "ident" and self.peek().value == "and":
            self.next()
            node = ("and", node, self.parse_cmp())
        return node

    def parse_cmp(self):
        node = self.parse_add()
        if self.peek().kind in ("==", "!=", "<", ">", "<=", ">="):
            op = self.next().kind
            node = ("cmp", op, node, self.parse_add())
        return node

    def parse_add(self):
        node = self.parse_mul()
        while self.peek().kind in ("+", "-"):
            op = self.next().kind
            node = ("arith", op, node, self.parse_mul())
        return node

    def parse_mul(self):
        node = self.parse_unary()
        while self.peek().kind in ("*", "/", "%"):
            op = self.next().kind
            node = ("arith", op, node, self.parse_unary())
        return node

    def parse_unary(self):
        if self.peek().kind == "-":
            self.next()
            return ("neg", self.parse_postfix())
        return self.parse_postfix()

    def parse_postfix(self):
        node = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "field":
                # .ident after an expression (e.g. (.a).b, .a.b)
                self.next()
                node = ("index", node, ("lit", t.value))
            elif t.kind == ".":
                # . followed by a quoted key: ."a b"
                self.next()
                nxt = self.next()
                if nxt.kind == "string":
                    node = ("index", node, _string_node(nxt.value))
                elif nxt.kind == "ident":
                    node = ("index", node, ("lit", nxt.value))
                else:
                    raise JqError("expected a field name after '.'")
            elif t.kind == "[":
                self.next()
                node = self._bracket_suffix(node)
            elif t.kind == "?":
                self.next()
                node = ("try", node)
            else:
                return node

    def _bracket_suffix(self, node):
        if self.peek().kind == "]":
            self.next()
            return ("iterate", node)
        if self.peek().kind == ":":
            self.next()
            hi = self.parse_pipe()
            self.expect("]")
            return ("slice", node, None, hi)
        inner = self.parse_pipe()
        if self.peek().kind == ":":
            self.next()
            if self.peek().kind == "]":
                self.next()
                return ("slice", node, inner, None)
            hi = self.parse_pipe()
            self.expect("]")
            return ("slice", node, inner, hi)
        self.expect("]")
        return ("index", node, inner)

    def parse_primary(self):
        t = self.peek()
        if t.kind == "field":
            # ".name" fused by the tokenizer (jq allows `.end`, `.and`
            # etc. — keyword-named fields — when directly attached).
            self.next()
            return ("index", ("identity",), ("lit", t.value))
        if t.kind == ".":
            self.next()
            nxt = self.peek()
            if nxt.kind == "string":
                self.next()
                return ("index", ("identity",), _string_node(nxt.value))
            if nxt.kind == ".":
                raise JqError("recursive descent '..' is not supported "
                              "(jqlite subset)")
            return ("identity",)
        if t.kind == "number":
            self.next()
            return ("lit", t.value)
        if t.kind == "string":
            self.next()
            return _string_node(t.value)
        if t.kind == "(":
            self.next()
            node = self.parse_pipe()
            self.expect(")")
            return node
        if t.kind == "[":
            self.next()
            if self.peek().kind == "]":
                self.next()
                return ("array", None)
            inner = self.parse_pipe()
            self.expect("]")
            return ("array", inner)
        if t.kind == "{":
            self.next()
            return self._parse_object()
        if t.kind == "var":
            self.next()
            return ("var", t.value)
        if t.kind == "ident":
            name = t.value
            if name in ("true", "false", "null"):
                self.next()
                return ("lit", {"true": True, "false": False, "null": None}[name])
            if name == "if":
                return self._parse_if()
            if name in ("reduce", "foreach"):
                return self._parse_reduce(name)
            if name == "try":
                # try EXPR (catch HANDLER)? — errors in EXPR are
                # suppressed; with catch, the handler runs with the
                # error message as its input (jq semantics).
                self.next()
                tried = self.parse_postfix()
                handler = None
                t2 = self.peek()
                if t2.kind == "ident" and t2.value == "catch":
                    self.next()
                    handler = self.parse_postfix()
                return ("trycatch", tried, handler)
            if name in _STOP_KW:
                raise JqError(f"unexpected keyword '{name}'")
            if name in _UNSUPPORTED_KW:
                raise JqError(
                    f"'{name}' is not supported (jqlite subset — see "
                    "sdtk_tpu_torch/utils/jqlite.py docstring for the grammar)"
                )
            self.next()
            args: list[Any] = []
            if self.peek().kind == "(":
                self.next()
                args.append(self.parse_pipe())
                while self.peek().kind == ";":
                    self.next()
                    args.append(self.parse_pipe())
                self.expect(")")
            return ("call", name, args)
        raise JqError(f"unexpected token {t.kind!r} in query")

    def _kw(self) -> str | None:
        t = self.peek()
        return t.value if t.kind == "ident" and t.value in (
            "then", "elif", "else", "end") else None

    def _parse_if(self):
        """if C then A (elif C2 then B)* (else D)? end — missing else
        defaults to identity (jq semantics)."""
        self.next()  # 'if'
        branches = []
        cond = self.parse_pipe()
        if self._kw() != "then":
            raise JqError("expected 'then' after if condition")
        self.next()
        branches.append((cond, self.parse_pipe()))
        while self._kw() == "elif":
            self.next()
            c = self.parse_pipe()
            if self._kw() != "then":
                raise JqError("expected 'then' after elif condition")
            self.next()
            branches.append((c, self.parse_pipe()))
        else_node = None
        if self._kw() == "else":
            self.next()
            else_node = self.parse_pipe()
        if self._kw() != "end":
            raise JqError("expected 'end' to close if")
        self.next()
        return ("if", branches, else_node)

    def _parse_reduce(self, which: str):
        """reduce SRC as $x (INIT; UPDATE) /
        foreach SRC as $x (INIT; UPDATE[; EXTRACT])."""
        self.next()  # keyword
        src = self.parse_postfix()
        t = self.next()
        if not (t.kind == "ident" and t.value == "as"):
            raise JqError(f"expected 'as' after {which} source")
        v = self.next()
        if v.kind != "var":
            raise JqError(f"expected $name after '{which} ... as'")
        self.expect("(")
        init = self.parse_pipe()
        self.expect(";")
        update = self.parse_pipe()
        extract = None
        if which == "foreach" and self.peek().kind == ";":
            self.next()
            extract = self.parse_pipe()
        self.expect(")")
        return (which, src, v.value, init, update, extract)

    def _parse_object(self):
        fields: list[tuple[Any, Any]] = []
        if self.peek().kind == "}":
            self.next()
            return ("object", fields)
        while True:
            t = self.next()
            if t.kind == "ident":
                key = t.value
            elif t.kind == "string":
                if len(t.value) == 1 and isinstance(t.value[0], str):
                    key = t.value[0]
                elif not t.value:
                    key = ""
                else:
                    raise JqError("interpolated object keys are not supported")
            elif t.kind == ".":
                # {.name} shorthand is not jq; but {name} handled above
                raise JqError("expected object key")
            else:
                raise JqError(f"expected object key, got {t.kind!r}")
            if self.peek().kind == ":":
                self.next()
                val = self.parse_alt()
            else:
                val = ("index", ("identity",), ("lit", key))
            fields.append((key, val))
            if self.peek().kind == ",":
                self.next()
                continue
            self.expect("}")
            return ("object", fields)


def _string_node(parts: list[Any]):
    if all(isinstance(p, str) for p in parts):
        return ("lit", "".join(parts))
    return ("interp_string", parts)


def _parse(src: str):
    src = src.strip()
    if not src:
        return ("identity",)
    p = _Parser(_tokenize(src))
    node = p.parse_pipe()
    if p.peek().kind != "eof":
        raise JqError(f"trailing tokens after expression: {p.peek().kind!r}")
    return node


# ---------------------------------------------------------------------------
# Evaluator — eval(node, value) yields zero-or-more outputs
# ---------------------------------------------------------------------------


def _truthy(v: Any) -> bool:
    return v is not None and v is not False


def _type_name(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    return type(v).__name__


_ORDER = {"null": 0, "boolean": 1, "number": 2, "string": 3, "array": 4,
          "object": 5}


def _cmp_values(a: Any, b: Any) -> int:
    """jq's total order: null < false < true < numbers < strings <
    arrays < objects."""
    ta, tb = _type_name(a), _type_name(b)
    if ta != tb:
        return -1 if _ORDER[ta] < _ORDER[tb] else 1
    if ta == "null":
        return 0
    if ta == "boolean":
        return (a > b) - (a < b)
    if ta in ("number", "string"):
        return (a > b) - (a < b)
    if ta == "array":
        for x, y in zip(a, b):
            c = _cmp_values(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    # objects: compare sorted key arrays, then values in key order
    ka, kb = sorted(a.keys()), sorted(b.keys())
    c = _cmp_values(ka, kb)
    if c:
        return c
    for k in ka:
        c = _cmp_values(a[k], b[k])
        if c:
            return c
    return 0


class _SortKey:
    __slots__ = ("v",)

    def __init__(self, v: Any):
        self.v = v

    def __lt__(self, other: "_SortKey") -> bool:
        return _cmp_values(self.v, other.v) < 0


def _index(value: Any, key: Any) -> Any:
    if isinstance(key, str):
        if value is None:
            return None
        if isinstance(value, dict):
            return value.get(key)
        raise JqError(f"Cannot index {_type_name(value)} with \"{key}\"")
    if isinstance(key, bool) or not isinstance(key, (int, float)):
        raise JqError(f"Cannot index {_type_name(value)} with {_type_name(key)}")
    if value is None:
        return None
    if isinstance(value, list):
        i = int(key)
        if -len(value) <= i < len(value):
            return value[i]
        return None
    raise JqError(f"Cannot index {_type_name(value)} with number")


def _arith(op: str, a: Any, b: Any) -> Any:
    if op == "+":
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, bool) or isinstance(b, bool):
            raise JqError(f"{_type_name(a)} and {_type_name(b)} cannot be added")
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a + b
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        if isinstance(a, dict) and isinstance(b, dict):
            return {**a, **b}
        raise JqError(f"{_type_name(a)} and {_type_name(b)} cannot be added")
    if op == "-":
        if isinstance(a, list) and isinstance(b, list):
            return [x for x in a if not any(_cmp_values(x, y) == 0 for y in b)]
        if (isinstance(a, (int, float)) and not isinstance(a, bool)
                and isinstance(b, (int, float)) and not isinstance(b, bool)):
            return a - b
        raise JqError(
            f"{_type_name(a)} and {_type_name(b)} cannot be subtracted")
    if not (isinstance(a, (int, float)) and not isinstance(a, bool)
            and isinstance(b, (int, float)) and not isinstance(b, bool)):
        raise JqError(
            f"{_type_name(a)} and {_type_name(b)} cannot be "
            f"{'multiplied' if op == '*' else 'divided'}")
    if op == "*":
        return a * b
    if b == 0:
        raise JqError(f"{a} and {b} cannot be divided because the divisor is zero")
    if op == "/":
        return a / b
    # jq `%` truncates both operands to ints and uses C remainder
    # semantics (result takes the dividend's sign); Python's `%` takes
    # the divisor's sign, and a fractional divisor can truncate to 0.
    ia, ib = int(a), int(b)
    if ib == 0:
        raise JqError(f"{a} and {b} cannot be divided because the divisor is zero")
    return int(math.fmod(ia, ib))


def _to_json(v: Any) -> str:
    return json.dumps(v, ensure_ascii=False, default=str)


def _stringify(v: Any) -> str:
    return v if isinstance(v, str) else _to_json(v)


def _contains(a: Any, b: Any) -> bool:
    """jq `contains`: strings → substring; arrays → every element of b is
    contained in some element of a; objects → recursive subset."""
    if isinstance(a, str) and isinstance(b, str):
        return b in a
    if isinstance(a, list) and isinstance(b, list):
        return all(any(_contains(x, y) for x in a) for y in b)
    if isinstance(a, dict) and isinstance(b, dict):
        return all(k in a and _contains(a[k], v) for k, v in b.items())
    return _cmp_values(a, b) == 0


def _eval(node, value: Any, env: dict[str, Any] | None = None) -> Iterator[Any]:
    kind = node[0]
    if kind == "identity":
        yield value
    elif kind == "lit":
        yield node[1]
    elif kind == "pipe":
        for mid in _eval(node[1], value, env):
            yield from _eval(node[2], mid, env)
    elif kind == "comma":
        yield from _eval(node[1], value, env)
        yield from _eval(node[2], value, env)
    elif kind == "alt":
        produced = False
        try:
            for v in _eval(node[1], value, env):
                if _truthy(v):
                    produced = True
                    yield v
        except JqError:
            pass
        if not produced:
            yield from _eval(node[2], value, env)
    elif kind == "or":
        for a in _eval(node[1], value, env):
            if _truthy(a):
                yield True
            else:
                for b in _eval(node[2], value, env):
                    yield _truthy(b)
    elif kind == "and":
        for a in _eval(node[1], value, env):
            if not _truthy(a):
                yield False
            else:
                for b in _eval(node[2], value, env):
                    yield _truthy(b)
    elif kind == "cmp":
        op = node[1]
        for b in _eval(node[3], value, env):
            for a in _eval(node[2], value, env):
                c = _cmp_values(a, b)
                yield {"==": c == 0, "!=": c != 0, "<": c < 0,
                       ">": c > 0, "<=": c <= 0, ">=": c >= 0}[op]
    elif kind == "arith":
        op = node[1]
        for b in _eval(node[3], value, env):
            for a in _eval(node[2], value, env):
                yield _arith(op, a, b)
    elif kind == "neg":
        for a in _eval(node[1], value, env):
            if isinstance(a, bool) or not isinstance(a, (int, float)):
                raise JqError(f"{_type_name(a)} cannot be negated")
            yield -a
    elif kind == "index":
        for base in _eval(node[1], value, env):
            for key in _eval(node[2], value, env):
                yield _index(base, key)
    elif kind == "slice":
        _, base_n, lo_n, hi_n = node
        los = [None] if lo_n is None else list(_eval(lo_n, value, env))
        his = [None] if hi_n is None else list(_eval(hi_n, value, env))
        for base in _eval(base_n, value, env):
            for hi in his:
                for lo in los:
                    if base is None:
                        yield None
                        continue
                    if not isinstance(base, (list, str)):
                        raise JqError(
                            f"Cannot slice {_type_name(base)}")
                    yield base[
                        None if lo is None else int(lo):
                        None if hi is None else int(hi)]
    elif kind == "iterate":
        for base in _eval(node[1], value, env):
            if isinstance(base, list):
                yield from base
            elif isinstance(base, dict):
                yield from base.values()
            else:
                raise JqError(f"Cannot iterate over {_type_name(base)}")
    elif kind == "try":
        try:
            yield from list(_eval(node[1], value, env))
        except JqError:
            return
    elif kind == "trycatch":
        try:
            yield from list(_eval(node[1], value, env))
        except JqError as e:
            if node[2] is not None:
                # handler input = the error message (jq strips the
                # "error: " prefix from error(msg) payloads)
                msg = str(e)
                msg = msg[7:] if msg.startswith("error: ") else msg
                yield from _eval(node[2], msg, env)
    elif kind == "funcdef":
        _, fname, params, body, rest = node
        rec = {"name": fname, "params": params, "body": body, "env": env}
        yield from _eval(
            rest, value, {**(env or {}), f"fn:{fname}/{len(params)}": rec}
        )
    elif kind == "array":
        yield [] if node[1] is None else list(_eval(node[1], value, env))
    elif kind == "object":
        fields = node[1]
        combos: list[dict[str, Any]] = [{}]
        for key, val_node in fields:
            vals = list(_eval(val_node, value, env))
            combos = [{**c, key: v} for v in vals for c in combos]
        yield from combos
    elif kind == "interp_string":
        pieces: list[list[str]] = [[]]
        for part in node[1]:
            if isinstance(part, str):
                for p in pieces:
                    p.append(part)
            else:
                vals = [_stringify(v) for v in _eval(part[1], value, env)]
                pieces = [p + [v] for v in vals for p in pieces]
        for p in pieces:
            yield "".join(p)
    elif kind == "call":
        yield from _call(node[1], node[2], value, env)
    elif kind == "var":
        if env is None or node[1] not in env:
            raise JqError(f"${node[1]} is not defined")
        yield env[node[1]]
    elif kind == "bind":
        for v in _eval(node[1], value, env):
            yield from _eval(node[3], value, {**(env or {}), node[2]: v})
    elif kind == "if":
        branches, else_node = node[1], node[2]

        def _run_if(i: int, val):
            if i == len(branches):
                if else_node is None:
                    yield val
                else:
                    yield from _eval(else_node, val, env)
                return
            cond, then = branches[i]
            for c in _eval(cond, val, env):
                if _truthy(c):
                    yield from _eval(then, val, env)
                else:
                    yield from _run_if(i + 1, val)

        yield from _run_if(0, value)
    elif kind == "reduce":
        _, src, var, init, update, _ = node
        for acc0 in _eval(init, value, env):
            acc = acc0
            for v in _eval(src, value, env):
                e2 = {**(env or {}), var: v}
                nxt = None  # jq: empty update stream -> null accumulator
                for o in _eval(update, acc, e2):
                    nxt = o
                acc = nxt
            yield acc
    elif kind == "foreach":
        _, src, var, init, update, extract = node
        for acc0 in _eval(init, value, env):
            acc = acc0
            for v in _eval(src, value, env):
                e2 = {**(env or {}), var: v}
                for o in _eval(update, acc, e2):
                    acc = o
                    if extract is None:
                        yield o
                    else:
                        yield from _eval(extract, o, e2)
    else:  # pragma: no cover
        raise JqError(f"internal: unknown node {kind!r}")


def _one_arg(name: str, args: list) -> Any:
    if len(args) != 1:
        raise JqError(f"{name} expects 1 argument")
    return args[0]


def _const_arg(name: str, args: list, value: Any, env: dict[str, Any] | None = None) -> Any:
    outs = list(_eval(_one_arg(name, args), value, env))
    if len(outs) != 1:
        raise JqError(f"{name}: argument must produce exactly one value")
    return outs[0]


def _call_user(rec: dict, args: list, value: Any,
               call_env: dict[str, Any] | None) -> Iterator[Any]:
    """Invoke a user-defined function (``def``).  Filter params bind the
    call-site argument EXPRESSION as a zero-arg closure (evaluated in the
    call-site env each time the body invokes it); ``$name`` params
    evaluate the argument at the call site and bind the value stream
    (cartesian over multiple outputs, jq semantics).  The function's own
    record is re-inserted into its env so recursion works."""
    params, body = rec["params"], rec["body"]
    base = dict(rec["env"] or {})
    base[f"fn:{rec['name']}/{len(params)}"] = rec

    def go(i: int, acc: dict) -> Iterator[Any]:
        if i == len(params):
            yield from _eval(body, value, acc)
            return
        p, a = params[i], args[i]
        if p.startswith("$"):
            for v in _eval(a, value, call_env):
                yield from go(i + 1, {**acc, p[1:]: v})
        else:
            closure = {"name": p, "params": [], "body": a, "env": call_env}
            yield from go(i + 1, {**acc, f"fn:{p}/0": closure})

    yield from go(0, base)


def _compile_regex(pat: Any, flags: Any) -> tuple["re.Pattern[str]", bool]:
    """jq (Oniguruma) regex + modifier string → compiled Python pattern +
    global flag.  Named groups use jq's ``(?<name>…)`` spelling, which is
    rewritten to Python's ``(?P<name>…)`` (lookbehinds excluded)."""
    if not isinstance(pat, str):
        raise JqError(f"{_type_name(pat)} cannot be matched, as it is not "
                      "a string")
    f, global_ = 0, False
    for ch in flags or "":
        if ch == "g":
            global_ = True
        elif ch == "i":
            f |= re.IGNORECASE
        elif ch == "x":
            f |= re.VERBOSE
        elif ch == "s":
            f |= re.DOTALL
        elif ch == "m":
            f |= re.MULTILINE
        elif ch == "n":
            pass  # "ignore empty matches" — Python's finditer already
            # advances past empty matches safely
        else:
            raise JqError(f"{flags} is not a valid modifier string")
    try:
        return re.compile(re.sub(r"\(\?<(?![=!])", "(?P<", pat), f), global_
    except re.error as e:
        raise JqError(f"invalid regex {pat!r}: {e}") from None


def _regex_args(name: str, args: list, value: Any,
                env: dict[str, Any] | None,
                n_extra: int = 0) -> tuple["re.Pattern[str]", bool, list]:
    """Evaluate (re[, …extras][, flags]) arguments for a regex builtin."""
    if not (1 + n_extra) <= len(args) <= (2 + n_extra):
        raise JqError(f"{name} expects {1 + n_extra} or {2 + n_extra} "
                      "arguments")
    vals = [_const_arg(name, [a], value, env) for a in args]
    pat = vals[0]
    extras = vals[1 : 1 + n_extra]
    flags = vals[1 + n_extra] if len(vals) > 1 + n_extra else ""
    if flags and not isinstance(flags, str):
        raise JqError(f"{name}: flags must be a string")
    if not isinstance(value, str):
        raise JqError(f"{_type_name(value)} cannot be matched, as it is "
                      "not a string")
    rx, global_ = _compile_regex(pat, flags)
    return rx, global_, extras


def _match_object(m: "re.Match[str]") -> dict:
    names = {v: k for k, v in m.re.groupindex.items()}
    captures = []
    for gi in range(1, m.re.groups + 1):
        s = m.group(gi)
        captures.append({
            "offset": m.start(gi) if s is not None else -1,
            "length": 0 if s is None else m.end(gi) - m.start(gi),
            "string": s,
            "name": names.get(gi),
        })
    return {"offset": m.start(), "length": m.end() - m.start(),
            "string": m.group(0), "captures": captures}


def _capture_object(m: "re.Match[str]") -> dict:
    return {k: m.group(k) for k in m.re.groupindex}


def _call(name: str, args: list, value: Any, env: dict[str, Any] | None = None) -> Iterator[Any]:
    # user-defined functions (def) shadow builtins at the same arity
    if env is not None:
        rec = env.get(f"fn:{name}/{len(args)}")
        if rec is not None:
            yield from _call_user(rec, args, value, env)
            return
    if name == "select":
        f = _one_arg("select", args)
        for ok in _eval(f, value, env):
            if _truthy(ok):
                yield value
    elif name == "map":
        f = _one_arg("map", args)
        if not isinstance(value, list):
            raise JqError(f"Cannot iterate over {_type_name(value)} (map)")
        out: list[Any] = []
        for item in value:
            out.extend(_eval(f, item, env))
        yield out
    elif name == "length":
        _no_args(name, args)
        if value is None:
            yield 0
        elif isinstance(value, bool):
            raise JqError("boolean has no length")
        elif isinstance(value, (int, float)):
            yield abs(value)
        else:
            yield len(value)
    elif name in ("keys", "keys_unsorted"):
        _no_args(name, args)
        if isinstance(value, dict):
            ks = list(value.keys())
            yield sorted(ks) if name == "keys" else ks
        elif isinstance(value, list):
            yield list(range(len(value)))
        else:
            raise JqError(f"{_type_name(value)} has no keys")
    elif name == "values":
        _no_args(name, args)
        if value is not None:
            yield value
    elif name == "has":
        k = _const_arg("has", args, value, env)
        if isinstance(value, dict):
            yield isinstance(k, str) and k in value
        elif isinstance(value, list):
            yield isinstance(k, (int, float)) and 0 <= int(k) < len(value)
        else:
            raise JqError(f"Cannot check has() on {_type_name(value)}")
    elif name == "contains":
        yield _contains(value, _const_arg("contains", args, value, env))
    elif name == "inside":
        yield _contains(_const_arg("inside", args, value, env), value)
    elif name == "group_by":
        f = _one_arg("group_by", args)
        _need_array(name, value)
        keyed = [(_first(f, item, env), item) for item in value]
        keyed.sort(key=lambda kv: _SortKey(kv[0]))
        groups: list[list[Any]] = []
        last: Any = object()
        for k, item in keyed:
            if groups and _cmp_values(k, last) == 0:
                groups[-1].append(item)
            else:
                groups.append([item])
                last = k
        yield groups
    elif name == "sort":
        _no_args(name, args)
        _need_array(name, value)
        yield sorted(value, key=_SortKey)
    elif name == "sort_by":
        f = _one_arg("sort_by", args)
        _need_array(name, value)
        yield sorted(value, key=lambda item: _SortKey(_first(f, item, env)))
    elif name == "unique":
        _no_args(name, args)
        _need_array(name, value)
        yield _unique(sorted(value, key=_SortKey))
    elif name == "unique_by":
        f = _one_arg("unique_by", args)
        _need_array(name, value)
        keyed = sorted(((_first(f, i, env), i) for i in value),
                       key=lambda kv: _SortKey(kv[0]))
        out, last = [], object()
        for k, item in keyed:
            if not out or _cmp_values(k, last) != 0:
                out.append(item)
                last = k
        yield out
    elif name == "add":
        _no_args(name, args)
        _need_array(name, value)
        acc: Any = None
        for item in value:
            acc = _arith("+", acc, item)
        yield acc
    elif name in ("min", "max"):
        _no_args(name, args)
        _need_array(name, value)
        if not value:
            yield None
        else:
            pick = min if name == "min" else max
            yield pick(value, key=_SortKey)
    elif name in ("min_by", "max_by"):
        f = _one_arg(name, args)
        _need_array(name, value)
        if not value:
            yield None
        else:
            pick = min if name == "min_by" else max
            yield pick(value, key=lambda item: _SortKey(_first(f, item, env)))
    elif name == "reverse":
        _no_args(name, args)
        if isinstance(value, str):
            yield value[::-1]
        else:
            _need_array(name, value)
            yield value[::-1]
    elif name == "flatten":
        depth = int(_const_arg(name, args, value, env)) if args else 1 << 30
        _need_array(name, value)

        def flat(arr, d):
            for x in arr:
                if isinstance(x, list) and d > 0:
                    yield from flat(x, d - 1)
                else:
                    yield x

        yield list(flat(value, depth))
    elif name == "range":
        if not 1 <= len(args) <= 3:
            raise JqError("range expects 1-3 arguments")
        vals = [_const_arg("range", [a], value, env) for a in args]
        lo, hi, step = ((0, vals[0], 1) if len(vals) == 1 else
                        (vals[0], vals[1], 1) if len(vals) == 2 else
                        (vals[0], vals[1], vals[2]))
        if step == 0:
            raise JqError("range: step cannot be 0")
        x = lo
        while (x < hi) if step > 0 else (x > hi):
            yield x
            x += step
    elif name in ("floor", "ceil", "round", "sqrt", "fabs", "abs"):
        _no_args(name, args)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise JqError(f"{_type_name(value)} number required ({name})")
        fn: Callable[[float], float] = {
            "floor": math.floor, "ceil": math.ceil, "round": round,
            "sqrt": math.sqrt, "fabs": abs, "abs": abs,
        }[name]
        yield fn(value)
    elif name == "tostring":
        _no_args(name, args)
        yield _stringify(value)
    elif name == "tonumber":
        _no_args(name, args)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            yield value
        elif isinstance(value, str):
            try:
                yield json.loads(value)
            except ValueError:
                raise JqError(f"Cannot parse {value!r} as number") from None
        else:
            raise JqError(f"Cannot parse {_type_name(value)} as number")
    elif name == "type":
        _no_args(name, args)
        yield _type_name(value)
    elif name == "not":
        _no_args(name, args)
        yield not _truthy(value)
    elif name == "empty":
        _no_args(name, args)
        return
    elif name == "error":
        msg = _const_arg("error", args, value, env) if args else value
        raise JqError(f"error: {msg}")
    elif name == "first":
        if args:
            for v in _eval(args[0], value, env):
                yield v
                return
        else:
            _need_array(name, value)
            yield value[0] if value else None
    elif name == "last":
        if args:
            outs = list(_eval(args[0], value, env))
            yield outs[-1] if outs else None
        else:
            _need_array(name, value)
            yield value[-1] if value else None
    elif name in ("any", "all"):
        comb = any if name == "any" else all
        if len(args) == 2:  # any(gen; cond): cond over each gen output
            gen, cond = args
            yield comb(_truthy(c)
                       for g in _eval(gen, value, env) for c in _eval(cond, g, env))
        elif len(args) == 1:  # any(f): f over each array element
            _need_array(name, value)
            yield comb(_truthy(v)
                       for item in value for v in _eval(args[0], item, env))
        else:
            _need_array(name, value)
            yield comb(_truthy(v) for v in value)
    elif name == "split" and len(args) == 2:
        rx, _, _ = _regex_args(name, args, value, env)
        yield rx.split(value)
    elif name in ("startswith", "endswith", "ltrimstr", "rtrimstr", "split",
                  "join"):
        arg = _const_arg(name, args, value, env)
        if name == "join":
            _need_array(name, value)
            if not isinstance(arg, str):
                raise JqError("join: separator must be a string")
            yield arg.join(
                "" if v is None else _stringify(v) for v in value)
            return
        if not isinstance(value, str) or not isinstance(arg, str):
            raise JqError(f"{name}: string required")
        if name == "startswith":
            yield value.startswith(arg)
        elif name == "endswith":
            yield value.endswith(arg)
        elif name == "ltrimstr":
            yield value[len(arg):] if value.startswith(arg) else value
        elif name == "rtrimstr":
            yield value[: -len(arg)] if arg and value.endswith(arg) else value
        else:
            yield value.split(arg)
    elif name in ("ascii_downcase", "ascii_upcase"):
        _no_args(name, args)
        if not isinstance(value, str):
            raise JqError(f"{name}: string required")
        yield value.lower() if name == "ascii_downcase" else value.upper()
    elif name == "to_entries":
        _no_args(name, args)
        if not isinstance(value, dict):
            raise JqError("to_entries: object required")
        yield [{"key": k, "value": v} for k, v in value.items()]
    elif name == "from_entries":
        _no_args(name, args)
        _need_array(name, value)
        out = {}
        for e in value:
            if not isinstance(e, dict):
                raise JqError("from_entries: array of objects required")
            k = e.get("key", e.get("k", e.get("name")))
            out[_stringify(k)] = e.get("value", e.get("v"))
        yield out
    elif name == "tojson":
        _no_args(name, args)
        yield _to_json(value)
    elif name == "fromjson":
        _no_args(name, args)
        if not isinstance(value, str):
            raise JqError("fromjson: string required")
        try:
            yield json.loads(value)
        except ValueError as e:
            raise JqError(f"fromjson: {e}") from None
    elif name == "test":
        rx, _, _ = _regex_args(name, args, value, env)
        yield rx.search(value) is not None
    elif name == "match":
        rx, global_, _ = _regex_args(name, args, value, env)
        if global_:
            for m in rx.finditer(value):
                yield _match_object(m)
        else:
            m = rx.search(value)
            if m is not None:
                yield _match_object(m)
    elif name == "capture":
        rx, global_, _ = _regex_args(name, args, value, env)
        if global_:
            for m in rx.finditer(value):
                yield _capture_object(m)
        else:
            m = rx.search(value)
            if m is not None:
                yield _capture_object(m)
    elif name == "scan":
        rx, _, _ = _regex_args(name, args, value, env)
        for m in rx.finditer(value):
            if m.re.groups:
                yield [m.group(gi) for gi in range(1, m.re.groups + 1)]
            else:
                yield m.group(0)
    elif name == "splits":
        rx, _, _ = _regex_args(name, args, value, env)
        yield from rx.split(value)
    elif name in ("sub", "gsub"):
        # repl is a jq expression evaluated with the match's CAPTURE
        # object as input (so "\(.name)" interpolation reaches the named
        # groups — jq semantics).
        if not 2 <= len(args) <= 3:
            raise JqError(f"{name} expects 2 or 3 arguments")
        rx, _, _ = _regex_args(name, [args[0]] + args[2:], value, env)
        out, pos = [], 0
        count = 0
        for m in rx.finditer(value):
            if name == "sub" and count >= 1:
                break
            reps = list(_eval(args[1], _capture_object(m), env))
            if len(reps) != 1 or not isinstance(reps[0], str):
                raise JqError(f"{name}: replacement must produce exactly "
                              "one string")
            out.append(value[pos : m.start()])
            out.append(reps[0])
            pos = m.end()
            count += 1
        out.append(value[pos:])
        yield "".join(out)
    else:
        raise JqError(
            f"unknown function '{name}' (jqlite subset — see "
            "sdtk_tpu_torch/utils/jqlite.py docstring for the supported grammar)"
        )


def _no_args(name: str, args: list) -> None:
    if args:
        raise JqError(f"{name} takes no arguments")


def _need_array(name: str, value: Any) -> None:
    if not isinstance(value, list):
        raise JqError(f"{name}: array required, got {_type_name(value)}")


def _first(node, value: Any, env: dict[str, Any] | None = None) -> Any:
    for v in _eval(node, value, env):
        return v
    return None


def _unique(sorted_vals: list[Any]) -> list[Any]:
    out: list[Any] = []
    for v in sorted_vals:
        if not out or _cmp_values(v, out[-1]) != 0:
            out.append(v)
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def query(expr: str, value: Any) -> list[Any]:
    """Evaluate a jq expression; returns the list of outputs."""
    return list(_eval(_parse(expr), value))


def query_lines(expr: str, value: Any) -> str:
    """jq-CLI-style output: one JSON document per line."""
    return "\n".join(_to_json(v) for v in query(expr, value))
