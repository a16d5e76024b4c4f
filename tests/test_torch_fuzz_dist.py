"""Distributed-vs-local differential fuzz through the port against the JAX package, on the CPU.

Parity file of tests/test_fuzz_dist.py (tests/torch_parity.py): random
queries over a random corpus must return the same result set from the
sharded path (the JAX package's ShardedIndex over its 8 virtual CPU
devices, the port's over 8 CPU slots) as from the local single-index
path, and the two packages' recorded results must be equal: ids,
totals and tie order exactly, scores within rtol 1e-5, atol 1e-6,
vector distances within atol 1e-5.
"""

import numpy as np
import pytest

from tests.torch_parity import parity, per_side, rs, shard

WORDS = ["ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen",
         "ibis", "jay"]


@pytest.fixture(scope="module")
def pair(eight_devices):
    return per_side(_pair_make)


def _pair_make():
    rng = np.random.default_rng(11)
    schema = rs.Schema(name="fz", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("g", rs.FieldType.TAG, sortable=True),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=8,
                                        metric=rs.VectorMetric.L2))])
    ix = rs.SearchIndex(schema)
    vecs = rng.standard_normal((120, 8)).astype(np.float32)
    for i in range(120):
        ix.add_document(f"d{i}", {
            "t": " ".join(WORDS[j] for j in rng.integers(0, 10, 4)),
            "g": "pq"[i % 2], "n": float(i % 50), "v": vecs[i]})
    ix.commit()
    return ix, shard(ix, rs.parallel.dist.make_mesh(8)), vecs


QUERIES = [
    "ant", "ant bee", "ant | bee", "cat -dog", "ant ~bee",
    '"ant bee"', "@g:{p}", "@n:[10 30]", "@g:{q} @n:[5 45]",
    "(ant | cat) @g:{p}", "ib*", "%bea%", "*",
]


@pytest.mark.parametrize("q", QUERIES)
@parity
def test_dist_matches_local(pair, q):
    ix, sh, _ = pair
    loc = ix.search(q, num=120)
    dst = sh.search(q, num=120)
    assert {h.key for h in dst.hits} == {h.key for h in loc.hits}, q
    assert dst.total == loc.total, q


@pytest.mark.parametrize("seed", range(6))
@parity
def test_dist_knn_matches_local(pair, seed):
    ix, sh, vecs = pair
    rng = np.random.default_rng(6000 + seed)
    qv = rng.standard_normal(8).astype(np.float32)
    loc = ix.search("*=>[KNN 7 @v $b]", params={"b": qv}, num=7)
    dst = sh.search("*=>[KNN 7 @v $b]", params={"b": qv}, num=7)
    assert [h.key for h in dst.hits] == [h.key for h in loc.hits]
    for a, b in zip(loc.hits, dst.hits):
        assert a.vector_distance == pytest.approx(b.vector_distance,
                                                  rel=1e-4)


@pytest.mark.parametrize("seed", range(4))
@parity
def test_dist_filtered_knn_matches_local(pair, seed):
    ix, sh, vecs = pair
    rng = np.random.default_rng(7000 + seed)
    qv = rng.standard_normal(8).astype(np.float32)
    q = "(@g:{p})=>[KNN 5 @v $b]"
    loc = ix.search(q, params={"b": qv}, num=5)
    dst = sh.search(q, params={"b": qv}, num=5)
    assert [h.key for h in dst.hits] == [h.key for h in loc.hits], seed


@parity
def test_dist_sortby_matches_local(pair):
    ix, sh, _ = pair
    for asc in (True, False):
        loc = ix.search("ant", sort_by="n", sort_asc=asc, num=120)
        dst = sh.search("ant", sort_by="n", sort_asc=asc, num=120)
        assert [h.sortkey for h in loc.hits] == \
            [h.sortkey for h in dst.hits], asc
        assert {h.key for h in loc.hits} == {h.key for h in dst.hits}
