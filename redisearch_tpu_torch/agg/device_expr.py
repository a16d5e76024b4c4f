"""Device compilation of numeric APPLY/FILTER expressions, in torch.

Counterpart of `redisearch_tpu/agg/device_expr.py`.  A compiled
expression is a closure `fn(cols) -> (values f32, present bool)` over a
dict of named (values, present) tensor pairs; NULL is present=False and
propagates with the semantics of agg/expr.py:evaluate: comparisons with
NULL give a DEFINED 0.0, arithmetic with NULL is NULL, `/ 0`, `% 0` and
domain errors are NULL, && and || select values by truthiness.

Constants are 0-dim tensors on the device of the columns in `cols` (the
CPU when the expression reads no column); callers broadcast results to
their lane shape.  `compile_device_expr` returns None for any shape it
cannot prove device-safe (strings, dates beyond modular arithmetic,
unknown properties).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..agg.expr import Expr

F32 = torch.float32


def _device(cols) -> torch.device:
    for v, _p in cols.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _const(cols, v: float, present: bool):
    dev = _device(cols)
    return (torch.tensor(v, dtype=F32, device=dev),
            torch.tensor(present, device=dev))


def _where(c, a, b):
    return torch.where(c, a, b).to(F32)


_MATH_CALLS = {
    "abs": lambda v, p: (torch.abs(v), p),
    "ceil": lambda v, p: (torch.ceil(v), p),
    "floor": lambda v, p: (torch.floor(v), p),
    "exp": lambda v, p: (torch.exp(v), p),
    # host semantics: log/log2 of <= 0 (or NULL/0) is NULL
    "log": lambda v, p: (torch.log(torch.where(v > 0, v, 1.0)), p & (v > 0)),
    "log2": lambda v, p: (torch.log2(torch.where(v > 0, v, 1.0)),
                          p & (v > 0)),
    "sqrt": lambda v, p: (torch.sqrt(torch.where(v >= 0, v, 0.0)),
                          p & (v >= 0)),
    # date helpers that are pure modular arithmetic on epoch seconds;
    # torch.floor_divide and torch.remainder round toward -inf, as
    # jnp.floor_divide and jnp.mod do
    "hour": lambda v, p: (torch.remainder(torch.floor_divide(v, 3600.0),
                                          24.0), p),
    "minute": lambda v, p: (torch.remainder(torch.floor_divide(v, 60.0),
                                            60.0), p),
    "dayofweek": lambda v, p: (torch.remainder(
        torch.floor_divide(v, 86400.0) + 4.0, 7.0), p),
}


def _truthy(v, p):
    return p & (v != 0.0)


def compile_device_expr(e: Expr, available: set[str]) \
        -> Optional[Callable]:
    """Compile `e` to fn(cols)->(values, present), or None.

    `available`: property names resolvable as numeric device columns
    (numeric fields and earlier device-compiled APPLY aliases).
    `cols[name]` must hold an (f32 values, bool present) pair.
    """
    k = e.kind
    if k == "num":
        c = float(e.val)
        return lambda cols: _const(cols, c, True)
    if k == "null":
        return lambda cols: _const(cols, 0.0, False)
    if k == "prop":
        name = e.val
        if name not in available:
            return None
        return lambda cols: cols[name]
    if k == "neg":
        a = compile_device_expr(e.args[0], available)
        if a is None:
            return None
        return lambda cols: (lambda va, pa: (-va, pa))(*a(cols))
    if k == "not":
        a = compile_device_expr(e.args[0], available)
        if a is None:
            return None

        def f_not(cols, _a=a):
            va, pa = _a(cols)
            return (_where(_truthy(va, pa), 0.0, 1.0),
                    torch.ones_like(pa, dtype=torch.bool))
        return f_not
    if k == "bin":
        a = compile_device_expr(e.args[0], available)
        b = compile_device_expr(e.args[1], available)
        if a is None or b is None:
            return None
        op = e.val

        def f_bin(cols, _a=a, _b=b, _op=op):
            va, pa = _a(cols)
            vb, pb = _b(cols)
            t = torch.ones(torch.broadcast_shapes(va.shape, vb.shape),
                           dtype=torch.bool, device=va.device)
            if _op == "&&":
                ta = _truthy(va, pa)
                return _where(ta, vb, 0.0), torch.where(ta, pb, True) & t
            if _op == "||":
                ta = _truthy(va, pa)
                return _where(ta, va, vb), torch.where(ta, pa, pb) & t
            if _op in ("==", "!=", "<", "<=", ">", ">="):
                both = pa & pb
                cmp = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                       "<=": torch.le, ">": torch.gt,
                       ">=": torch.ge}[_op](va, vb)
                # NULL operands compare false but the RESULT is defined
                return _where(both & cmp, 1.0, 0.0), t
            both = pa & pb
            if _op == "+":
                return (va + vb).to(F32), both & t
            if _op == "-":
                return (va - vb).to(F32), both & t
            if _op == "*":
                return (va * vb).to(F32), both & t
            if _op == "/":
                ok = both & (vb != 0)
                return (va / torch.where(vb != 0, vb, 1.0)).to(F32), ok & t
            if _op == "%":
                ok = both & (vb != 0)
                r = torch.remainder(torch.trunc(va),
                                    torch.where(vb != 0, torch.trunc(vb),
                                                1.0))
                return r.to(F32), ok & t
            if _op == "^":
                return torch.pow(va, vb).to(F32), both & t
            raise AssertionError(_op)
        return f_bin
    if k == "call":
        fn = _MATH_CALLS.get(e.val)
        if fn is not None and len(e.args) == 1:
            a = compile_device_expr(e.args[0], available)
            if a is None:
                return None
            return lambda cols, _a=a, _f=fn: _f(*_a(cols))
        if e.val == "exists" and len(e.args) == 1:
            a = compile_device_expr(e.args[0], available)
            if a is None:
                return None

            def f_ex(cols, _a=a):
                va, pa = _a(cols)
                return (_where(pa, 1.0, 0.0),
                        torch.ones(va.shape, dtype=torch.bool,
                                   device=va.device))
            return f_ex
        if e.val == "case" and len(e.args) == 3:
            parts = [compile_device_expr(x, available) for x in e.args]
            if any(p is None for p in parts):
                return None
            c, a, b = parts

            def f_case(cols, _c=c, _a=a, _b=b):
                vc, pc = _c(cols)
                va, pa = _a(cols)
                vb, pb = _b(cols)
                t = _truthy(vc, pc)
                return _where(t, va, vb), torch.where(t, pa, pb)
            return f_case
        if e.val == "to_number" and len(e.args) == 1:
            return compile_device_expr(e.args[0], available)
        return None
    return None
