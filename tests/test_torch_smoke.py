"""End-to-end smoke tests: index build + BM25 search + filters.

Parity file of tests/test_smoke.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import numpy as np
import pytest

Field = rs.Field
FieldType = rs.FieldType
Schema = rs.Schema
SearchIndex = rs.SearchIndex
VectorParams = rs.VectorParams


@pytest.fixture()
def idx():
    return per_side(lambda: _idx_make())


def _idx_make():
    schema = Schema(
        name="smoke",
        fields=[
            Field("title", FieldType.TEXT, weight=2.0),
            Field("body", FieldType.TEXT),
            Field("genre", FieldType.TAG, sortable=True),
            Field("price", FieldType.NUMERIC, sortable=True),
            Field("loc", FieldType.GEO),
        ],
    )
    ix = SearchIndex(schema)
    docs = [
        ("doc:1", {"title": "hello world", "body": "the quick brown fox",
                   "genre": "fiction", "price": 10, "loc": "2.34,48.86"}),
        ("doc:2", {"title": "world news today", "body": "jumping foxes run",
                   "genre": "news", "price": 25, "loc": "-0.12,51.5"}),
        ("doc:3", {"title": "goodbye world", "body": "hello again my friend",
                   "genre": "fiction,drama", "price": 5, "loc": "13.4,52.52"}),
        ("doc:4", {"title": "unrelated title", "body": "nothing to see here",
                   "genre": "docs", "price": 100, "loc": "2.35,48.85"}),
    ]
    for key, fields in docs:
        ix.add_document(key, fields)
    ix.commit()
    return ix


@parity
def test_single_term(idx):
    res = idx.search("hello")
    keys = {h.key for h in res}
    assert keys == {"doc:1", "doc:3"}
    assert res.total == 2


@parity
def test_and(idx):
    res = idx.search("hello world")
    assert {h.key for h in res} == {"doc:1", "doc:3"}


@parity
def test_field_scoped_and(idx):
    res = idx.search("@title:hello @body:fox")
    assert {h.key for h in res} == {"doc:1"}


@parity
def test_or(idx):
    # "fox" also matches doc:2's "foxes" via stemming
    res = idx.search("fox | friend")
    assert {h.key for h in res} == {"doc:1", "doc:2", "doc:3"}
    res = idx.search("'fox' | 'friend'")  # verbatim: no stem expansion
    assert {h.key for h in res} == {"doc:1", "doc:3"}


@parity
def test_not(idx):
    res = idx.search("world -hello")
    assert {h.key for h in res} == {"doc:2"}


@parity
def test_title_weight_boost(idx):
    # "world" in title for all three; doc:1 also has "hello" in title
    res = idx.search("hello")
    assert res.hits[0].key == "doc:1"  # title weight 2.0 beats body-only


@parity
def test_stemming(idx):
    res = idx.search("jump")  # doc:2 has "jumping"
    assert {h.key for h in res} == {"doc:2"}


@parity
def test_exact_phrase(idx):
    res = idx.search('"hello world"')
    assert {h.key for h in res} == {"doc:1"}
    res = idx.search('"world hello"')
    assert len(res) == 0


@parity
def test_prefix(idx):
    res = idx.search("worl*")
    assert {h.key for h in res} == {"doc:1", "doc:2", "doc:3"}


@parity
def test_fuzzy(idx):
    res = idx.search("%wrld%")
    assert {h.key for h in res} == {"doc:1", "doc:2", "doc:3"}


@parity
def test_tag(idx):
    res = idx.search("@genre:{fiction}")
    assert {h.key for h in res} == {"doc:1", "doc:3"}
    res = idx.search("@genre:{fiction|news}")
    assert {h.key for h in res} == {"doc:1", "doc:2", "doc:3"}


@parity
def test_numeric_range(idx):
    res = idx.search("@price:[5 25]")
    assert {h.key for h in res} == {"doc:1", "doc:2", "doc:3"}
    res = idx.search("@price:[(5 25]")
    assert {h.key for h in res} == {"doc:1", "doc:2"}
    res = idx.search("@price>=25")
    assert {h.key for h in res} == {"doc:2", "doc:4"}


@parity
def test_numeric_combined(idx):
    res = idx.search("world @price:[0 15]")
    assert {h.key for h in res} == {"doc:1", "doc:3"}


@parity
def test_geo(idx):
    # 10km around central Paris: doc:1 and doc:4
    res = idx.search("@loc:[2.349 48.853 10 km]")
    assert {h.key for h in res} == {"doc:1", "doc:4"}


@parity
def test_sortby(idx):
    res = idx.search("world", sort_by="price", sort_asc=True)
    assert [h.key for h in res] == ["doc:3", "doc:1", "doc:2"]
    assert res.hits[0].sortkey == 5.0


@parity
def test_wildcard_all(idx):
    res = idx.search("*")
    assert res.total == 4


@parity
def test_delete(idx):
    idx.delete_document("doc:1")
    res = idx.search("hello")
    assert {h.key for h in res} == {"doc:3"}


@parity
def test_update_document(idx):
    idx.add_document("doc:2", {"title": "replaced entirely",
                               "genre": "news", "price": 1})
    res = idx.search("news")
    assert all(h.key != "doc:2" for h in res)  # "news" no longer in title
    res = idx.search("replaced")
    assert {h.key for h in res} == {"doc:2"}


@parity
def test_paging(idx):
    res = idx.search("world", offset=1, num=1)
    assert len(res) == 1
    assert res.total == 3


@parity
def test_optional_boost(idx):
    res = idx.search("world ~fox")
    assert res.total == 3
    assert res.hits[0].key == "doc:1"  # fox match boosts doc:1


@parity
def test_explain(idx):
    out = idx.explain("hello world @price:[5 10]")
    assert "INTERSECT" in out
    assert "NUMERIC" in out


@parity
def test_vector_knn():
    schema = Schema(name="v", fields=[
        Field("txt", FieldType.TEXT),
        Field("v", FieldType.VECTOR, vector=VectorParams(dim=4, metric=
              rs.VectorMetric.L2)),
    ])
    ix = SearchIndex(schema)
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(20, 4)).astype(np.float32)
    for i in range(20):
        ix.add_document(f"d{i}", {"txt": f"doc number {i}",
                                  "v": vecs[i]})
    q = vecs[7] + 0.01
    res = ix.search("*=>[KNN 3 @v $vec]", params={"vec": q})
    assert res.hits[0].key == "d7"
    assert len(res) == 3
    # filtered KNN
    res = ix.search("(number)=>[KNN 5 @v $vec]", params={"vec": q})
    assert res.hits[0].key == "d7"


@parity
def test_prepared_query_cache_knn_rebind():
    """Same KNN query string with a fresh $vec must rebind the blob on the
    cached CompiledQuery (prepare())."""
    rs2 = rs
    schema = rs2.Schema(name="pq", fields=[
        rs2.Field("v", rs2.FieldType.VECTOR,
                  vector=rs2.VectorParams(dim=4,
                                          metric=rs2.VectorMetric.L2))])
    ix = rs2.SearchIndex(schema)
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(10, 4)).astype(np.float32)
    for i in range(10):
        ix.add_document(f"d{i}", {"v": vecs[i]})
    ix.commit()
    r1 = ix.search("*=>[KNN 1 @v $q]", params={"q": vecs[3]})
    r2 = ix.search("*=>[KNN 1 @v $q]", params={"q": vecs[7]})
    assert r1.hits[0].key == "d3"
    assert r2.hits[0].key == "d7"  # would be d3 if the blob were stale
    assert len(ix._prepared) == 1  # one cache entry, rebound twice


@parity
def test_prepared_query_views_do_not_alias_blobs():
    """A batch of the SAME KNN query string with a different $vec per
    entry must execute each blob: prepare() returns per-call views over
    the shared compiled structure, never the mutable cached object."""
    rs2 = rs
    QueryOptions = rs.query.engine.QueryOptions
    execute_batch = rs.query.engine.execute_batch
    schema = rs2.Schema(name="pqv", fields=[
        rs2.Field("v", rs2.FieldType.VECTOR,
                  vector=rs2.VectorParams(dim=4,
                                          metric=rs2.VectorMetric.L2))])
    ix = rs2.SearchIndex(schema)
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(32, 4)).astype(np.float32)
    for i in range(32):
        ix.add_document(f"d{i}", {"v": vecs[i]})
    ix.commit()
    cqs = [ix.prepare("*=>[KNN 1 @v $q]", {"q": vecs[i]},
                      QueryOptions(k=1), 2) for i in (3, 7, 11)]
    res = execute_batch(cqs, ix.segments[0], 1)
    got = [int(r.local_idx[0]) for r in res]
    assert got == [3, 7, 11], got
    # raw search_many too (the serving surface)
    rs_ = ix.search_many(["*=>[KNN 1 @v $q]"] * 3,
                         params=[{"q": vecs[5]}, {"q": vecs[9]},
                                 {"q": vecs[2]}], k=1)
    assert [r.hits[0].key for r in rs_] == ["d5", "d9", "d2"]
