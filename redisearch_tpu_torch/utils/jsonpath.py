# Copy of redisearch_tpu/utils/jsonpath.py: the port imports nothing of the JAX package.
"""JSONPath resolution for ON JSON indexes.

Reference: ReJSON API consumption (src/json.c, rejson_api.h) — schema
fields of JSON indexes are JSONPaths like `$.title` or `$.tags[*]`,
usually aliased with AS.  Full path grammar (matching ReJSON's JSONPath):

  $                     root
  .name  ['name']       member access (single- or double-quoted)
  .*  [*]               wildcard (dict values / list items)
  ..name  ..*  ..[0]    recursive descent
  [N]  [-N]             array index (negative from the end)
  [s:e:k]               array slice
  [i,j]  ['a','b']      union of indices / member names
  [?(expr)]             filter: comparisons over @ paths and literals,
                        && || !, parentheses, bare-path existence tests

A path whose shape can yield several values (wildcard, descent, slice,
union, filter) resolves to a list; a definite path resolves to the single
value or None.
"""

from __future__ import annotations

import re
from typing import Any, Optional


def is_json_path(name: str) -> bool:
    return name.startswith("$")


class JSONPathError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parsing: a path compiles to a list of step tuples
#   ("member", name) ("wild",) ("index", i) ("slice", s, e, k)
#   ("union", [items]) ("filter", expr_ast) ("descend", inner_step)
# ---------------------------------------------------------------------------

_NAME = re.compile(r"[A-Za-z_\$][\w\$-]*")
_NUM = re.compile(r"-?\d+(\.\d+)?([eE][-+]?\d+)?")


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, c: str) -> None:
        if not self.s.startswith(c, self.i):
            raise JSONPathError(
                f"expected {c!r} at {self.i} in {self.s!r}")
        self.i += len(c)

    def ws(self) -> None:
        while self.peek() in (" ", "\t"):
            self.i += 1


def _parse_bracket(p: _P):
    """Parse one [...] selector body (after the '[')."""
    p.ws()
    c = p.peek()
    if c == "*":
        p.i += 1
        p.ws()
        p.eat("]")
        return ("wild",)
    if c == "?":
        p.i += 1
        p.ws()
        paren = p.peek() == "("
        if paren:
            p.eat("(")
        expr = _parse_or(p)
        p.ws()
        if paren:
            p.eat(")")
        p.ws()
        p.eat("]")
        return ("filter", expr)
    if c in ("'", '"'):
        names = [_parse_quoted(p)]
        p.ws()
        while p.peek() == ",":
            p.i += 1
            p.ws()
            names.append(_parse_quoted(p))
            p.ws()
        p.eat("]")
        if len(names) == 1:
            return ("member", names[0])
        return ("union", [("member", nm) for nm in names])
    # numeric index / slice / union
    items = []
    is_slice = False
    parts: list[Optional[int]] = []
    cur: Optional[str] = None

    def flushnum():
        nonlocal cur
        v = int(cur) if cur is not None and cur != "" else None
        cur = None
        return v

    while True:
        p.ws()
        ch = p.peek()
        if ch == "]":
            p.i += 1
            break
        if ch == ":":
            is_slice = True
            parts.append(flushnum())
            p.i += 1
            continue
        if ch == ",":
            items.append(flushnum())
            p.i += 1
            continue
        m = _NUM.match(p.s, p.i)
        if m is None:
            raise JSONPathError(f"bad selector at {p.i} in {p.s!r}")
        cur = m.group(0)
        p.i = m.end()
    if is_slice:
        parts.append(flushnum())
        while len(parts) < 3:
            parts.append(None)
        return ("slice", parts[0], parts[1], parts[2])
    items.append(flushnum())
    items = [i for i in items if i is not None]
    if len(items) == 1:
        return ("index", items[0])
    return ("union", [("index", i) for i in items])


def _parse_quoted(p: _P) -> str:
    q = p.peek()
    if q not in ("'", '"'):
        raise JSONPathError(f"expected quote at {p.i}")
    p.i += 1
    out = []
    while p.peek() and p.peek() != q:
        ch = p.peek()
        if ch == "\\":
            p.i += 1
            ch = p.peek()
        out.append(ch)
        p.i += 1
    p.eat(q)
    return "".join(out)


def _parse_steps(p: _P) -> list:
    steps = []
    while p.i < len(p.s):
        c = p.peek()
        if c == ".":
            if p.s.startswith("..", p.i):
                p.i += 2
                if p.peek() == "[":
                    p.i += 1
                    steps.append(("descend", _parse_bracket(p)))
                elif p.peek() == "*":
                    p.i += 1
                    steps.append(("descend", ("wild",)))
                else:
                    m = _NAME.match(p.s, p.i)
                    if m is None:
                        raise JSONPathError(
                            f"bad descent at {p.i} in {p.s!r}")
                    p.i = m.end()
                    steps.append(("descend", ("member", m.group(0))))
            else:
                p.i += 1
                if p.peek() == "*":
                    p.i += 1
                    steps.append(("wild",))
                else:
                    m = _NAME.match(p.s, p.i)
                    if m is None:
                        raise JSONPathError(
                            f"bad member at {p.i} in {p.s!r}")
                    p.i = m.end()
                    steps.append(("member", m.group(0)))
        elif c == "[":
            p.i += 1
            steps.append(_parse_bracket(p))
        elif c in (" ", "\t"):
            p.i += 1
        else:
            raise JSONPathError(f"unexpected {c!r} at {p.i} in {p.s!r}")
    return steps


# -- filter expression grammar: or -> and -> not -> cmp -> atom -------------

def _parse_or(p: _P):
    left = _parse_and(p)
    p.ws()
    while p.s.startswith("||", p.i):
        p.i += 2
        right = _parse_and(p)
        left = ("or", left, right)
        p.ws()
    return left


def _parse_and(p: _P):
    left = _parse_not(p)
    p.ws()
    while p.s.startswith("&&", p.i):
        p.i += 2
        right = _parse_not(p)
        left = ("and", left, right)
        p.ws()
    return left


def _parse_not(p: _P):
    p.ws()
    if p.peek() == "!":
        p.i += 1
        return ("not", _parse_not(p))
    if p.peek() == "(":
        p.i += 1
        e = _parse_or(p)
        p.ws()
        p.eat(")")
        return e
    return _parse_cmp(p)


_CMP_OPS = ("==", "!=", "<=", ">=", "<", ">", "=~")


def _parse_cmp(p: _P):
    left = _parse_atom(p)
    p.ws()
    for op in _CMP_OPS:
        if p.s.startswith(op, p.i):
            p.i += len(op)
            right = _parse_atom(p)
            return ("cmp", op, left, right)
    return ("exists", left)


def _parse_atom(p: _P):
    p.ws()
    c = p.peek()
    if c in ("@", "$"):
        root = c
        p.i += 1
        # sub-path until an operator/paren boundary
        start = p.i
        depth = 0
        while p.i < len(p.s):
            ch = p.peek()
            if ch == "[":
                depth += 1
            elif ch == "]":
                if depth == 0:
                    break
                depth -= 1
            elif depth == 0 and (ch in (" ", "\t", ")", "&", "|", "=",
                                        "!", "<", ">")):
                break
            p.i += 1
        sub = p.s[start:p.i]
        return ("path", root, _parse_steps(_P(sub)))
    if c in ("'", '"'):
        return ("lit", _parse_quoted(p))
    m = _NUM.match(p.s, p.i)
    if m is not None:
        p.i = m.end()
        t = m.group(0)
        return ("lit", float(t) if any(x in t for x in ".eE") else int(t))
    for kw, v in (("true", True), ("false", False), ("null", None)):
        if p.s.startswith(kw, p.i):
            p.i += len(kw)
            return ("lit", v)
    raise JSONPathError(f"bad filter atom at {p.i} in {p.s!r}")


_COMPILED: dict[str, tuple] = {}


def compile_path(path: str) -> tuple:
    ent = _COMPILED.get(path)
    if ent is None:
        p = _P(path[1:])  # skip '$'
        steps = _parse_steps(p)
        multi = _is_multi(steps)
        ent = (steps, multi)
        if len(_COMPILED) > 4096:
            _COMPILED.clear()
        _COMPILED[path] = ent
    return ent


def _is_multi(steps) -> bool:
    for st in steps:
        if st[0] in ("wild", "slice", "union", "filter", "descend"):
            return True
    return False


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _descend_all(node, out: list) -> None:
    out.append(node)
    if isinstance(node, dict):
        for v in node.values():
            _descend_all(v, out)
    elif isinstance(node, list):
        for v in node:
            _descend_all(v, out)


def _apply_step(nodes: list, step) -> list:
    kind = step[0]
    out: list = []
    if kind == "member":
        name = step[1]
        for c in nodes:
            if isinstance(c, dict) and name in c:
                out.append(c[name])
    elif kind == "wild":
        for c in nodes:
            if isinstance(c, dict):
                out.extend(c.values())
            elif isinstance(c, list):
                out.extend(c)
    elif kind == "index":
        i = step[1]
        for c in nodes:
            if isinstance(c, list):
                j = i if i >= 0 else len(c) + i
                if 0 <= j < len(c):
                    out.append(c[j])
    elif kind == "slice":
        s, e, k = step[1], step[2], step[3]
        for c in nodes:
            if isinstance(c, list):
                out.extend(c[slice(s, e, k)])
    elif kind == "union":
        for sub in step[1]:
            out.extend(_apply_step(nodes, sub))
    elif kind == "filter":
        expr = step[1]
        for c in nodes:
            items = c if isinstance(c, list) else \
                (list(c.values()) if isinstance(c, dict) else [])
            for it in items:
                if _eval_filter(expr, it):
                    out.append(it)
    elif kind == "descend":
        inner = step[1]
        allnodes: list = []
        for c in nodes:
            _descend_all(c, allnodes)
        out = _apply_step(allnodes, inner)
    return out


_MISSING = object()


def _eval_path_atom(atom, current):
    root, steps = atom[1], atom[2]
    nodes = [current]
    for st in steps:
        nodes = _apply_step(nodes, st)
        if not nodes:
            return _MISSING
    return nodes[0]


def _atom_value(atom, current):
    if atom[0] == "lit":
        return atom[1]
    return _eval_path_atom(atom, current)


def _eval_filter(expr, current) -> bool:
    k = expr[0]
    if k == "or":
        return _eval_filter(expr[1], current) or \
            _eval_filter(expr[2], current)
    if k == "and":
        return _eval_filter(expr[1], current) and \
            _eval_filter(expr[2], current)
    if k == "not":
        return not _eval_filter(expr[1], current)
    if k == "exists":
        v = _atom_value(expr[1], current)
        return v is not _MISSING and v is not None and v is not False
    if k == "cmp":
        op, la, ra = expr[1], expr[2], expr[3]
        lv = _atom_value(la, current)
        rv = _atom_value(ra, current)
        if lv is _MISSING or rv is _MISSING:
            return False
        try:
            if op == "==":
                return lv == rv
            if op == "!=":
                return lv != rv
            if op == "=~":
                return bool(re.search(str(rv), str(lv)))
            if not isinstance(lv, (int, float)) \
                    or not isinstance(rv, (int, float)) \
                    or isinstance(lv, bool) or isinstance(rv, bool):
                # relational ops compare strings too (lexicographic)
                if isinstance(lv, str) and isinstance(rv, str):
                    pass
                else:
                    return False
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            if op == ">=":
                return lv >= rv
        except TypeError:
            return False
    return False


def resolve(doc: Any, path: str):
    """Resolve a JSONPath against a dict/list document.  Returns the
    value (definite path), a list of values (wildcard/descent/slice/
    union/filter paths), or None when nothing matches."""
    if not is_json_path(path):
        return doc.get(path) if isinstance(doc, dict) else None
    steps, multi = compile_path(path)
    nodes = _apply_steps_all(doc, steps)
    if not nodes:
        return None
    if not multi and len(nodes) == 1:
        return nodes[0]
    return nodes


def _apply_steps_all(doc, steps) -> list:
    nodes = [doc]
    for st in steps:
        nodes = _apply_step(nodes, st)
        if not nodes:
            return []
    return nodes


def get_field_value(fields: dict, name: str):
    """Field lookup that understands both flat hash names and JSONPaths."""
    if name in fields:
        return fields[name]
    if is_json_path(name):
        try:
            return resolve(fields, name)
        except JSONPathError:
            return None
    return None
