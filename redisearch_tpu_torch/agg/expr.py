# Copy of redisearch_tpu/agg/expr.py: the port imports nothing of the JAX package.
"""APPLY/FILTER expression engine.

Reference: src/aggregate/expr/ (own Lemon grammar) + function registry
src/aggregate/functions/ (RegisterAllFunctions, function.c:45).  Implemented
as a Pratt parser producing a small expression tree evaluated per row.

Supported (matching the reference surface):
  literals, @property refs, arithmetic + - * / % ^, comparisons
  == != < <= > >=, logical && || !, function calls.
  math:   abs ceil exp floor log log2 sqrt
  string: upper lower substr format split startswith contains strlen
          to_number to_str case exists matched_terms
  date:   timefmt parsetime hour minute day month year dayofweek
          dayofmonth dayofyear monthofyear
  geo:    geodistance
"""

from __future__ import annotations

import calendar
import math
import time as _time
from typing import Any, Callable, Optional

from ..utils.errors import QuerySyntaxError

NULL = None


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TWO_CHAR = {"==", "!=", "<=", ">=", "&&", "||"}
_ONE_CHAR = set("+-*/%^()<>!,@")


def _tokenize(s: str) -> list[tuple[str, Any]]:
    toks: list[tuple[str, Any]] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in " \t\r\n":
            i += 1
            continue
        if s[i:i + 2] in _TWO_CHAR:
            toks.append(("op", s[i:i + 2]))
            i += 2
            continue
        if c in "\"'":
            j = i + 1
            buf = []
            while j < n and s[j] != c:
                if s[j] == "\\" and j + 1 < n:
                    buf.append(s[j + 1])
                    j += 2
                else:
                    buf.append(s[j])
                    j += 1
            if j >= n:
                raise QuerySyntaxError("unterminated string in expression")
            toks.append(("str", "".join(buf)))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and s[i + 1].isdigit()):
            j = i
            while j < n and (s[j].isdigit() or s[j] in ".eE"
                             or (s[j] in "+-" and j > i and s[j - 1] in "eE")):
                j += 1
            toks.append(("num", float(s[i:j])))
            i = j
            continue
        if c == "@":
            j = i + 1
            while j < n and (s[j].isalnum() or s[j] in "_.[]-"):
                j += 1
            toks.append(("prop", s[i + 1:j]))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (s[j].isalnum() or s[j] == "_"):
                j += 1
            toks.append(("ident", s[i:j]))
            i = j
            continue
        if c in _ONE_CHAR:
            toks.append(("op", c))
            i += 1
            continue
        raise QuerySyntaxError(f"bad character {c!r} in expression")
    toks.append(("eof", None))
    return toks


# ---------------------------------------------------------------------------
# Parser (Pratt)
# ---------------------------------------------------------------------------

_BIN_PREC = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "^": 7,
}


class Expr:
    __slots__ = ("kind", "val", "args")

    def __init__(self, kind: str, val: Any = None, args: tuple = ()):
        self.kind = kind
        self.val = val
        self.args = args

    def __repr__(self):
        return f"Expr({self.kind},{self.val},{self.args})"


class _P:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise QuerySyntaxError(f"expected {op!r}, got {v!r}")


def parse(s: str) -> Expr:
    p = _P(_tokenize(s))
    e = _parse_expr(p, 0)
    if p.peek()[0] != "eof":
        raise QuerySyntaxError(f"trailing tokens in expression: {p.peek()}")
    return e


def _parse_expr(p: _P, min_prec: int) -> Expr:
    left = _parse_unary(p)
    while True:
        k, v = p.peek()
        if k != "op" or v not in _BIN_PREC or _BIN_PREC[v] < min_prec:
            return left
        p.next()
        right = _parse_expr(p, _BIN_PREC[v] + 1)
        left = Expr("bin", v, (left, right))


def _parse_unary(p: _P) -> Expr:
    k, v = p.peek()
    if k == "op" and v == "-":
        p.next()
        return Expr("neg", None, (_parse_unary(p),))
    if k == "op" and v == "!":
        p.next()
        return Expr("not", None, (_parse_unary(p),))
    return _parse_atom(p)


def _parse_atom(p: _P) -> Expr:
    k, v = p.next()
    if k == "num":
        return Expr("num", v)
    if k == "str":
        return Expr("str", v)
    if k == "prop":
        return Expr("prop", v)
    if k == "ident":
        nk, nv = p.peek()
        if nk == "op" and nv == "(":
            p.next()
            args = []
            if not (p.peek() == ("op", ")")):
                while True:
                    args.append(_parse_expr(p, 0))
                    if p.peek() == ("op", ","):
                        p.next()
                        continue
                    break
            p.expect_op(")")
            return Expr("call", v.lower(), tuple(args))
        low = v.lower()
        if low == "null":
            return Expr("null")
        if low == "true":
            return Expr("num", 1.0)
        if low == "false":
            return Expr("num", 0.0)
        # bare identifier acts as property ref (reference allows both)
        return Expr("prop", v)
    if k == "op" and v == "(":
        e = _parse_expr(p, 0)
        p.expect_op(")")
        return e
    raise QuerySyntaxError(f"unexpected token {v!r} in expression")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _num(x) -> Optional[float]:
    if x is NULL:
        return None
    if isinstance(x, bool):
        return float(x)
    if isinstance(x, (int, float)):
        return float(x)
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _to_str(x) -> Optional[str]:
    if x is NULL:
        return None
    if isinstance(x, float) and x == int(x):
        return str(int(x))
    return str(x)


def _fn_substr(s, start, length):
    if s is NULL:
        return NULL
    s = str(s)
    start = int(_num(start) or 0)
    length = int(_num(length) if length is not NULL else -1)
    if start < 0:
        start = max(len(s) + start, 0)
    end = len(s) if length < 0 else min(start + length, len(s))
    return s[start:end]


def _fn_format(fmt, *args):
    if fmt is NULL:
        return NULL
    out = []
    ai = 0
    i = 0
    fmt = str(fmt)
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
            elif spec == "s":
                out.append(_to_str(args[ai]) or "")
                ai += 1
            elif spec in "dif":
                v = _num(args[ai])
                ai += 1
                if spec == "d" or spec == "i":
                    out.append(str(int(v)) if v is not None else "")
                else:
                    out.append(str(v) if v is not None else "")
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _fn_geodistance(*args):
    """geodistance(@g1, @g2) or geodistance(@g, "lon,lat") etc. — meters."""
    def coords(v):
        if v is NULL:
            return None
        if isinstance(v, (list, tuple)) and len(v) == 2:
            return float(v[0]), float(v[1])
        parts = str(v).split(",")
        return float(parts[0]), float(parts[1])

    def is_num(v):
        try:
            return _num(v) is not None and not (isinstance(v, str)
                                                and "," in v)
        except (TypeError, ValueError):
            return False

    if len(args) == 2:
        a, b = coords(args[0]), coords(args[1])
    elif len(args) == 4:
        a = (float(_num(args[0])), float(_num(args[1])))
        b = (float(_num(args[2])), float(_num(args[3])))
    elif len(args) == 3:
        # reference geo.c:71-84: (lon, lat, "lon,lat") or ("lon,lat", lon, lat)
        if is_num(args[0]):
            a = (float(_num(args[0])), float(_num(args[1])))
            b = coords(args[2])
        else:
            a = coords(args[0])
            b = (float(_num(args[1])), float(_num(args[2])))
    else:
        raise QuerySyntaxError("geodistance takes 2 to 4 args")
    if a is None or b is None:
        return NULL
    lon1, lat1, lon2, lat2 = map(math.radians, (a[0], a[1], b[0], b[1]))
    h = (math.sin((lat2 - lat1) / 2) ** 2
         + math.cos(lat1) * math.cos(lat2) * math.sin((lon2 - lon1) / 2) ** 2)
    return 2 * 6372797.560856 * math.asin(math.sqrt(min(h, 1.0)))


def _fn_timefmt(ts, fmt=NULL):
    n = _num(ts)
    if n is None:
        return NULL
    f = str(fmt) if fmt is not NULL else "%FT%TZ"
    return _time.strftime(f, _time.gmtime(n))


def _fn_parsetime(s, fmt):
    if s is NULL:
        return NULL
    try:
        st = _time.strptime(str(s), str(fmt))
        return float(calendar.timegm(st))
    except ValueError:
        return NULL


def _tm(ts, attr):
    n = _num(ts)
    if n is None:
        return NULL
    t = _time.gmtime(n)
    return float(getattr(t, attr))


_FUNCS: dict[str, Callable] = {
    # math
    "abs": lambda x: abs(_num(x)) if _num(x) is not None else NULL,
    "ceil": lambda x: math.ceil(_num(x)) if _num(x) is not None else NULL,
    "floor": lambda x: math.floor(_num(x)) if _num(x) is not None else NULL,
    "exp": lambda x: math.exp(_num(x)) if _num(x) is not None else NULL,
    "log": lambda x: (math.log(_num(x)) if _num(x) and _num(x) > 0 else NULL),
    "log2": lambda x: (math.log2(_num(x)) if _num(x) and _num(x) > 0
                       else NULL),
    "sqrt": lambda x: (math.sqrt(_num(x)) if _num(x) is not None
                       and _num(x) >= 0 else NULL),
    # string
    "upper": lambda s: str(s).upper() if s is not NULL else NULL,
    "lower": lambda s: str(s).lower() if s is not NULL else NULL,
    "substr": _fn_substr,
    "format": _fn_format,
    "split": lambda s, sep=",", strip=" ": (
        [t.strip(str(strip)) for t in str(s).split(str(sep))]
        if s is not NULL else NULL),
    "startswith": lambda s, p: (1.0 if s is not NULL and p is not NULL
                                and str(s).startswith(str(p)) else 0.0),
    "contains": lambda s, p: (float(str(s).count(str(p)))
                              if s is not NULL and p is not NULL else 0.0),
    "strlen": lambda s: float(len(str(s))) if s is not NULL else NULL,
    "to_number": lambda s: _num(s) if _num(s) is not None else NULL,
    "to_str": _to_str,
    "exists": lambda v: 1.0 if v is not NULL else 0.0,
    "case": lambda c, a, b: a if _truthy(c) else b,
    "matched_terms": lambda *a: NULL,  # filled by pipeline when available
    # date
    "timefmt": _fn_timefmt,
    "parsetime": _fn_parsetime,
    "hour": lambda t: _tm(t, "tm_hour"),
    "minute": lambda t: _tm(t, "tm_min"),
    "day": lambda t: _tm(t, "tm_mday"),
    "month": lambda t: _tm(t, "tm_mon"),
    "year": lambda t: _tm(t, "tm_year"),
    "dayofweek": lambda t: _tm(t, "tm_wday"),
    "dayofmonth": lambda t: _tm(t, "tm_mday"),
    "dayofyear": lambda t: _tm(t, "tm_yday"),
    "monthofyear": lambda t: (_tm(t, "tm_mon") - 1
                              if _tm(t, "tm_mon") is not NULL else NULL),
    # geo
    "geodistance": _fn_geodistance,
}


def _truthy(v) -> bool:
    if v is NULL:
        return False
    n = _num(v)
    if n is not None:
        return n != 0.0
    return bool(v)


def evaluate(e: Expr, row: dict[str, Any]) -> Any:
    """Evaluate expression against a row (property name -> value)."""
    k = e.kind
    if k == "num" or k == "str":
        return e.val
    if k == "null":
        return NULL
    if k == "prop":
        return row.get(e.val, NULL)
    if k == "neg":
        v = _num(evaluate(e.args[0], row))
        return -v if v is not None else NULL
    if k == "not":
        return 0.0 if _truthy(evaluate(e.args[0], row)) else 1.0
    if k == "bin":
        op = e.val
        if op == "&&":
            l = evaluate(e.args[0], row)
            return (evaluate(e.args[1], row) if _truthy(l) else 0.0)
        if op == "||":
            l = evaluate(e.args[0], row)
            return l if _truthy(l) else evaluate(e.args[1], row)
        a = evaluate(e.args[0], row)
        b = evaluate(e.args[1], row)
        if op in ("==", "!="):
            eq = _vals_equal(a, b)
            return 1.0 if (eq if op == "==" else not eq) else 0.0
        na, nb = _num(a), _num(b)
        if op in ("<", "<=", ">", ">="):
            if na is None or nb is None:
                # string comparison fallback
                if a is NULL or b is NULL:
                    return 0.0
                sa, sb = str(a), str(b)
                return 1.0 if _cmp_ok(op, (sa > sb) - (sa < sb)) else 0.0
            return 1.0 if _cmp_ok(op, (na > nb) - (na < nb)) else 0.0
        if na is None or nb is None:
            return NULL
        if op == "+":
            return na + nb
        if op == "-":
            return na - nb
        if op == "*":
            return na * nb
        if op == "/":
            return na / nb if nb != 0 else NULL
        if op == "%":
            return float(int(na) % int(nb)) if nb != 0 else NULL
        if op == "^":
            return na ** nb
    if k == "call":
        fn = _FUNCS.get(e.val)
        if fn is None:
            raise QuerySyntaxError(f"Unknown function `{e.val}`")
        args = [evaluate(a, row) for a in e.args]
        return fn(*args)
    raise AssertionError(k)


def _vals_equal(a, b) -> bool:
    if a is NULL or b is NULL:
        return a is b
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None:
        return na == nb
    return str(a) == str(b)


def _cmp_ok(op: str, c: int) -> bool:
    return {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]


def properties(e: Expr) -> set[str]:
    """All @properties referenced by an expression."""
    out = set()
    if e.kind == "prop":
        out.add(e.val)
    for a in e.args:
        out |= properties(a)
    return out
