"""Randomized differential test for FT.AGGREGATE pipelines.

Random GROUPBY/reducer/FILTER/APPLY/SORTBY plans over a random corpus,
checked against a naive Python evaluator (same strategy as
test_fuzz_differential.py for search).  Numeric accumulators compare to
1e-4 relative; group membership and row counts exactly.

Parity file of tests/test_fuzz_aggregate.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import math

import numpy as np
import pytest


Field = rs.Field
FieldType = rs.FieldType

N_DOCS = 400
TAGS_A = ["x", "y", "z"]
TAGS_B = ["p", "q", "r", "s"]


@pytest.fixture(scope="module")
def corpus():
    return per_side(lambda: _corpus_make())


def _corpus_make():
    rng = np.random.default_rng(7)
    rows = []
    c = rs.Client()
    c.ft_create("ag", [Field("t", FieldType.TEXT),
                       Field("a", FieldType.TAG),
                       Field("b", FieldType.TAG),
                       Field("v", FieldType.NUMERIC),
                       Field("w", FieldType.NUMERIC)])
    for i in range(N_DOCS):
        row = {"a": TAGS_A[int(rng.integers(0, 3))],
               "b": TAGS_B[int(rng.integers(0, 4))],
               "v": float(rng.integers(-50, 200)),
               "w": float(rng.integers(1, 30))}
        rows.append(row)
        c.hset(f"d{i}", {"t": "all even" if i % 2 == 0 else "all",
                         **row})
        rows[-1]["even"] = (i % 2 == 0)
    return c, rows


REDUCERS = [
    ("COUNT", [], lambda vs, ws: float(len(vs))),
    ("SUM", ["@v"], lambda vs, ws: float(np.sum(vs))),
    ("MIN", ["@v"], lambda vs, ws: float(np.min(vs))),
    ("MAX", ["@v"], lambda vs, ws: float(np.max(vs))),
    ("AVG", ["@v"], lambda vs, ws: float(np.mean(vs))),
    ("COUNT_DISTINCT", ["@v"], lambda vs, ws: float(len(set(vs)))),
    ("STDDEV", ["@v"], lambda vs, ws:
     float(np.std(vs, ddof=1)) if len(vs) > 1 else 0.0),
]


@pytest.mark.parametrize("seed", range(16))
@parity
def test_random_groupby_pipeline(corpus, seed):
    c, rows = corpus
    rng = np.random.default_rng(2000 + seed)

    # random plan: [query] -> [optional FILTER] -> GROUPBY -> SORTBY
    use_even = bool(rng.integers(0, 2))
    query = "even" if use_even else "all"
    by = [["@a"], ["@b"], ["@a", "@b"]][int(rng.integers(0, 3))]
    n_red = int(rng.integers(1, 4))
    picks = [REDUCERS[int(j)] for j in
             rng.integers(0, len(REDUCERS), n_red)]
    flt = None
    if rng.integers(0, 2):
        thresh = float(rng.integers(0, 100))
        flt = f"@v >= {thresh}"

    req = rs.AggregateRequest(query)
    req.load("@a", "@b", "@v", "@w")
    if flt:
        req.filter(flt)
    req.group_by(by, *[(name, args, f"r{j}")
                       for j, (name, args, _) in enumerate(picks)])
    out = c.ft_aggregate("ag", req)

    # model
    sel = [r for r in rows if (r["even"] if use_even else True)]
    if flt:
        sel = [r for r in sel if r["v"] >= thresh]
    groups: dict = {}
    for r in sel:
        key = tuple(r[k.lstrip("@")] for k in by)
        groups.setdefault(key, []).append(r)
    assert len(out.rows) == len(groups), (query, by, flt, len(out.rows),
                                          len(groups))
    for row in out.rows:
        key = tuple(row[k.lstrip("@")] for k in by)
        assert key in groups, (key, sorted(groups))
        vs = np.array([g["v"] for g in groups[key]])
        ws = np.array([g["w"] for g in groups[key]])
        for j, (name, args, model) in enumerate(picks):
            got = float(row[f"r{j}"])
            want = model(vs, ws)
            assert got == pytest.approx(want, rel=1e-4, abs=1e-4), (
                name, key, got, want)


@pytest.mark.parametrize("seed", range(8))
@parity
def test_random_apply_sort_limit(corpus, seed):
    c, rows = corpus
    rng = np.random.default_rng(3000 + seed)
    off = int(rng.integers(0, 5))
    num = int(rng.integers(1, 10))
    req = (rs.AggregateRequest("all")
           .load("@v", "@w")
           .apply("@v * 2 + @w", "c")
           .sort_by(("@c", bool(rng.integers(0, 2)) and rs.ASC or rs.DESC),
                    max=0)
           .limit(off, num))
    # determine direction from the built step for the model
    step = [s for s in req.steps if s.__class__.__name__ == "SortStep"][0]
    asc = step.keys[0][1]
    out = c.ft_aggregate("ag", req)
    model = sorted((r["v"] * 2 + r["w"] for r in rows), reverse=not asc)
    want = model[off:off + num]
    got = [float(r["c"]) for r in out.rows]
    assert got == pytest.approx(want), (asc, off, num, got[:5], want[:5])


@pytest.fixture(scope="module")
def sortable_corpus():
    return per_side(lambda: _sortable_corpus_make())


def _sortable_corpus_make():
    rng = np.random.default_rng(9)
    rows = []
    c = rs.Client()
    c.ft_create("agd", [Field("t", FieldType.TEXT),
                        Field("a", FieldType.TAG, sortable=True),
                        Field("v", FieldType.NUMERIC, sortable=True)])
    for i in range(500):
        row = {"a": TAGS_A[int(rng.integers(0, 3))],
               "v": float(rng.integers(-50, 200))}
        rows.append(row)
        c.hset(f"d{i}", {"t": "all", **row})
    return c, rows


@pytest.mark.parametrize("seed", range(8))
@parity
def test_device_groupby_matches_host(sortable_corpus, seed):
    """The one-hot-MXU device GROUPBY (group_by as first step over a
    sortable TAG) must agree with the host pipeline (forced via a
    leading LOAD) and with the numpy model."""
    c, rows = sortable_corpus
    rng = np.random.default_rng(4000 + seed)
    n_red = int(rng.integers(1, 4))
    picks = [REDUCERS[int(j)] for j in
             rng.integers(0, len(REDUCERS), n_red)]
    reducers = [(name, args, f"r{j}")
                for j, (name, args, _) in enumerate(picks)]

    dev = c.ft_aggregate("agd", rs.AggregateRequest("all")
                         .group_by(["@a"], *reducers))
    host = c.ft_aggregate("agd", rs.AggregateRequest("all")
                          .load("@a", "@v")
                          .group_by(["@a"], *reducers))
    dev_rows = {r["a"]: r for r in dev.rows}
    host_rows = {r["a"]: r for r in host.rows}
    assert set(dev_rows) == set(host_rows)
    for a, hrow in host_rows.items():
        vs = np.array([r["v"] for r in rows if r["a"] == a])
        for j, (name, args, model) in enumerate(picks):
            want = model(vs, None)
            for src, row in (("device", dev_rows[a]), ("host", hrow)):
                got = float(row[f"r{j}"])
                assert got == pytest.approx(want, rel=1e-4, abs=1e-3), (
                    src, name, a, got, want)


@parity
def test_aggregate_many_matches_sequential(sortable_corpus):
    c, rows = sortable_corpus
    reqs = [
        rs.AggregateRequest("all").group_by(
            ["@a"], ("SUM", ["@v"], "s"), ("COUNT", [], "n")),
        rs.AggregateRequest("all").group_by(
            ["@a"], ("MIN", ["@v"], "lo"), ("MAX", ["@v"], "hi")),
        # host-fallback shape in the same batch (multi-key group)
        rs.AggregateRequest("all").load("@a", "@v").group_by(
            ["@a"], ("AVG", ["@v"], "m")),
    ]
    batch = c.ft_aggregate_many("agd", reqs)
    seq = [c.ft_aggregate("agd", r) for r in reqs]
    for b, s in zip(batch, seq):
        bb = sorted(map(str, ({k: round(float(v), 4) if isinstance(v, (int, float)) else v
                               for k, v in r.items()} for r in b.rows)))
        ss = sorted(map(str, ({k: round(float(v), 4) if isinstance(v, (int, float)) else v
                               for k, v in r.items()} for r in s.rows)))
        assert bb == ss
        assert b.total == s.total


@parity
def test_quantile_and_tolist(corpus):
    c, rows = corpus
    req = (rs.AggregateRequest("all")
           .group_by(["@a"], ("QUANTILE", ["@v", "0.25"], "q25"),
                     ("TOLIST", ["@b"], "bl")))
    out = c.ft_aggregate("ag", req)
    for row in out.rows:
        vs = np.array([r["v"] for r in rows if r["a"] == row["a"]])
        q = float(row["q25"])
        lo = np.quantile(vs, 0.25, method="lower")
        hi = np.quantile(vs, 0.25, method="higher")
        assert lo - 1e-9 <= q <= hi + 1e-9, (row["a"], q, lo, hi)
        want_bl = {r["b"] for r in rows if r["a"] == row["a"]}
        assert set(row["bl"]) == want_bl
