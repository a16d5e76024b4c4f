"""A NUMERIC range's window: the port's bind against the JAX package's.

The port's bind searches the float32 sorted column with bounds rounded
to float32 (`window_key`), the JAX package with the bound promoted to
float64.  The windows, and so the transport rows, must be the same byte
for byte, at bounds float32 cannot hold, at bounds between two adjacent
float32 values, at +-0.0, +-inf and +-1e39, on a single-valued (hash)
and a multi-valued (JSON array) column.  The helper itself is held to
the promoted search on seeded bounds.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu_torch.query.engine import window_key

NOW = 1_700_000_000
F32 = np.float32


def _values(rng):
    """Prices with repeats, signed zeros, 0.1 as float32 holds it,
    neighbours one float32 step apart and float32's largest value."""
    base = rng.integers(-40, 40, 240).astype(F32) * F32(0.25)
    extra = [F32(-0.0), F32(0.0), F32(0.1), F32(-0.1), F32(7.5),
             np.nextafter(F32(7.5), F32(np.inf)),
             np.nextafter(F32(7.5), F32(-np.inf)),
             np.finfo(F32).max, -np.finfo(F32).max]
    return [float(v) for v in np.concatenate([base, extra])]


def _fmt(x: float) -> str:
    """`x` as a query token both parsers read back exactly."""
    if np.isinf(x):
        return "+inf" if x > 0 else "-inf"
    return repr(float(x)).replace("e+", "e")


def _between(a) -> float:
    """The float64 midway between float32 `a` and the next float32 up."""
    a = F32(a)
    return (float(a) + float(np.nextafter(a, F32(np.inf)))) / 2


BOUNDS = {
    "present": 7.5,
    "present_neg": -2.25,
    "between": _between(7.5),
    "between_neg": _between(-2.25),
    "pos_zero": 0.0,
    "neg_zero": -0.0,
    "tenth": 0.1,
    "neg_tenth": -0.1,
    "pos_inf": np.inf,
    "neg_inf": -np.inf,
    "pos_1e39": 1e39,
    "neg_1e39": -1e39,
}

#: the bound as the range's low or high end, inclusive or exclusive
FORMS = {
    "lo_incl": "[{x} +inf]",
    "lo_excl": "[({x} +inf]",
    "hi_incl": "[-inf {x}]",
    "hi_excl": "[-inf ({x}]",
}


def _pair(kind):
    rng = np.random.default_rng(41)
    vals = _values(rng)
    out = []
    for pkg, kw in ((rs, {}), (rt, {"device": "cpu"})):
        c = pkg.Client(**kw)
        F, T = pkg.Field, pkg.FieldType
        if kind == "hash":
            ix = c.ft_create("n", [F("p", T.NUMERIC),
                                   F("t", T.TEXT)])
            for i, v in enumerate(vals):
                c.hset(f"d{i}", {"p": v, "t": "w"})
            for i in range(8):                       # absent: +inf entries
                c.hset(f"e{i}", {"t": "w"})
        else:
            ix = c.ft_create("n", [F("$.p", T.NUMERIC, alias="p"),
                                   F("$.t", T.TEXT, alias="t")],
                             on_json=True)
            for i in range(0, len(vals) - 2, 3):
                c.hset(f"d{i}", {"p": vals[i:i + 3], "t": "w"})
            c.hset("one", {"p": [vals[-1]], "t": "w"})
            c.hset("none", {"t": "w"})
        ix.commit()
        out.append(ix)
    return out


@pytest.fixture(scope="module")
def indexes():
    return {kind: _pair(kind) for kind in ("hash", "json")}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bound", list(BOUNDS))
@pytest.mark.parametrize("kind", ["hash", "json"])
def test_numeric_window_rows_match_jax(indexes, kind, bound, form):
    """bind_row rows, layouts and buckets are byte-identical to the JAX
    package's, and the window holds exactly the values in range."""
    jix, tix = indexes[kind]
    x = BOUNDS[bound]
    q = "@p:" + FORMS[form].format(x=_fmt(x))
    jseg, tseg = jix.segments[0], tix.segments[0]
    jcq = jix.prepare(q, None, rs.QueryOptions(k=10, now=NOW), 2)
    tcq = tix.prepare(q, None, rt.QueryOptions(k=10, now=NOW), 2)
    lo, hi = tcq.num_bounds[0]
    got = lo if form.startswith("lo") else hi
    assert got == x and np.signbit(got) == np.signbit(x), q
    assert jcq.num_bounds == tcq.num_bounds, q
    col = tseg.numerics["p"]
    assert col.multi == (kind == "json")
    jrow, jent = jcq.bind_row(jseg)
    trow, tent = tcq.bind_row(tseg)
    assert jrow.dtype == trow.dtype == np.int32
    assert jrow.tobytes() == trow.tobytes(), q
    assert jent[2] == tent[2] and jent[4] == tent[4], q   # layout, bk
    assert jent[6] == tent[6] and jent[7] == tent[7], q   # group key
    dyn = tcq.bind(tseg)[0].dyn
    for key in ("numw_start", "numw_len", "num_lo", "num_hi"):
        assert dyn[key].tobytes() == jcq.bind(jseg)[0].dyn[key].tobytes()
    sv = col.sorted_vals_np.astype(np.float64)
    ok = {"lo_incl": sv >= x, "lo_excl": sv > x,
          "hi_incl": sv <= x, "hi_excl": sv < x}[form]
    start, n = int(dyn["numw_start"][0]), int(dyn["numw_len"][0])
    assert n == int(ok.sum()), q
    assert ok[start:start + n].all(), q


def test_window_key_matches_promoted_search():
    """The key has the column's dtype and finds the index the float64
    search finds, on both sides, over repeated values and +inf padding;
    a float64 column's key is the bound itself."""
    rng = np.random.default_rng(7)
    sv = np.sort(np.concatenate([
        rng.integers(-30, 30, 2000).astype(F32) * F32(0.1),
        rng.standard_normal(1000).astype(F32) * F32(1e3),
        [F32(-0.0), F32(0.0), np.finfo(F32).max, -np.finfo(F32).max],
        np.full(300, np.inf, F32)]))
    sv64 = sv.astype(np.float64)
    finite = sv[np.isfinite(sv)].astype(np.float64)
    xs = np.concatenate([
        rng.choice(finite, 1500),
        rng.choice(finite, 1500) * (1 + rng.choice([1e-9, -1e-9, 1e-7,
                                                    -1e-7], 1500)),
        rng.uniform(-4e3, 4e3, 1500),
        [0.0, -0.0, 0.1, -0.1, np.inf, -np.inf, 1e39, -1e39, 1e-50,
         -1e-50, 3.4028235e38, 3.4028236e38, -3.4028236e38]])
    for x in xs:
        for side in ("left", "right"):
            key = window_key(sv, x, side)
            assert key.dtype == sv.dtype, (x, side)
            assert (np.searchsorted(sv, key, side)
                    == np.searchsorted(sv64, x, side)), (x, side)
            key64 = window_key(sv64, x, side)
            assert key64.dtype == np.float64 and key64 == x, (x, side)
