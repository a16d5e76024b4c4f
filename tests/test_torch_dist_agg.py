"""Distributed aggregation (parallel/dist_agg.py) through the port against the JAX package, on the CPU.

Parity file of tests/test_dist_agg.py (tests/torch_parity.py): the
DISTRIBUTE-step plan split (reducer rewrites, per-shard pass, host
merge, local tail) on the JAX package's ShardedIndex over its 8 virtual
CPU devices, then on the port's over 8 CPU slots; each case must pass
its own assertions on both, and the results of the calls it makes must
be equal: group keys, counts and row order exactly, floats within rtol
1e-5, atol 1e-6.
"""

import numpy as np
import pytest

from tests.torch_parity import parity, per_side, rs, shard


@pytest.fixture(scope="module")
def setup(eight_devices):
    return per_side(_setup_make)


def _setup_make():
    schema = rs.Schema(name="da", fields=[
        rs.Field("name", rs.FieldType.TEXT),
        rs.Field("brand", rs.FieldType.TAG, sortable=True),
        rs.Field("price", rs.FieldType.NUMERIC, sortable=True),
    ])
    ix = rs.SearchIndex(schema)
    rng = np.random.default_rng(7)
    brands = ["alpha", "beta", "gamma", "delta"]
    for i in range(120):
        ix.add_document(f"p{i}", {
            "name": f"product {i} model{'x' if i % 2 else 'y'}",
            "brand": brands[i % 4],
            "price": float(rng.integers(1, 1000))})
    sharded = shard(ix, rs.parallel.dist.make_mesh(8))
    return ix, sharded


def _rowmap(rows, key="brand"):
    return {r[key]: {k: v for k, v in r.items() if k != key} for r in rows}


def _approx_eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) < 1e-6 * max(1.0, abs(a), abs(b))
    if isinstance(a, list) and isinstance(b, list):
        return set(map(str, a)) == set(map(str, b))
    return a == b


@pytest.mark.parametrize("reducer", [
    ("COUNT", [], "r"),
    ("SUM", ["@price"], "r"),
    ("MIN", ["@price"], "r"),
    ("MAX", ["@price"], "r"),
    ("AVG", ["@price"], "r"),
    ("STDDEV", ["@price"], "r"),
    ("COUNT_DISTINCT", ["@price"], "r"),
    ("QUANTILE", ["@price", "0.5"], "r"),
    ("TOLIST", ["@price"], "r"),
])
@parity
def test_dist_reducer_parity(setup, reducer):
    ix, sharded = setup
    req_local = rs.AggregateRequest("*").group_by("@brand", reducer)
    req_dist = rs.AggregateRequest("*").group_by("@brand", reducer)
    local = _rowmap(ix.aggregate(req_local).rows)
    dist = _rowmap(sharded.aggregate(req_dist).rows)
    assert local.keys() == dist.keys()
    for brand in local:
        for k in local[brand]:
            assert _approx_eq(local[brand][k], dist[brand][k]), (
                reducer[0], brand, local[brand][k], dist[brand][k])


@parity
def test_dist_countdistinctish(setup):
    ix, sharded = setup
    req = rs.AggregateRequest("*").group_by(
        "@brand", ("COUNT_DISTINCTISH", ["@price"], "c"))
    local = _rowmap(ix.aggregate(
        rs.AggregateRequest("*").group_by(
            "@brand", ("COUNT_DISTINCT", ["@price"], "c"))).rows)
    dist = _rowmap(sharded.aggregate(req).rows)
    for brand in local:
        exact = local[brand]["c"]
        est = dist[brand]["c"]
        assert abs(est - exact) <= max(2, exact * 0.1)


@parity
def test_dist_agg_with_filter_and_tail(setup):
    ix, sharded = setup

    def mk():
        return (rs.AggregateRequest("@brand:{alpha|beta}")
                .group_by("@brand", ("AVG", ["@price"], "avg"))
                .apply("floor(@avg)", "avg_floor")
                .sort_by(("@avg_floor", rs.DESC)))
    local = ix.aggregate(mk())
    dist = sharded.aggregate(mk())
    assert [r["brand"] for r in local.rows] == [r["brand"]
                                                for r in dist.rows]
    assert [r["avg_floor"] for r in local.rows] == [
        r["avg_floor"] for r in dist.rows]


@parity
def test_dist_agg_no_groupby(setup):
    ix, sharded = setup

    def mk():
        return (rs.AggregateRequest("*").load("price")
                .sort_by(("@price", rs.DESC)).limit(0, 5))
    local = ix.aggregate(mk())
    dist = sharded.aggregate(mk())
    assert [r["price"] for r in local.rows] == [r["price"]
                                                for r in dist.rows]
