"""The prepared-query cache's aliasing invariant.

index.prepare() returns the SHARED cached CompiledQuery (no view) for
text queries with identical options — correctness then depends on no
execute path ever mutating cq.opts or other per-call state in place
(the engine's _filter_only copies first).  These tests pin that
invariant: if a future change mutates a prepared query's opts during
execution, they fail instead of silently aliasing every concurrent
caller of the same cached query string.

Parity file of tests/test_prepared_aliasing.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import numpy as np
import pytest


QueryOptions = rs.query.engine.QueryOptions
execute_batch = rs.query.engine.execute_batch


@pytest.fixture(scope="module")
def ix():
    return per_side(lambda: _ix_make())


def _ix_make():
    schema = rs.Schema(name="alias", fields=[
        rs.Field("title", rs.FieldType.TEXT),
        rs.Field("price", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("tag", rs.FieldType.TAG),
    ])
    ix = rs.SearchIndex(schema)
    rng = np.random.default_rng(7)
    words = ["alpha", "beta", "gamma", "delta", "omega"]
    for i in range(200):
        ix.add_document(f"d{i}", {
            "title": " ".join(rng.choice(words, 4)),
            "price": float(i % 50),
            "tag": ["red", "blue"][i % 2]})
    ix.commit()
    return ix


def _snap(cq):
    return dict(vars(cq.opts)), cq.knn, tuple(map(id, cq.vec_blobs))


@parity
def test_fast_path_returns_shared_object(ix):
    opts = QueryOptions(k=10, now=12345)
    a = ix.prepare("alpha beta", None, opts, 2)
    b = ix.prepare("alpha beta", None, opts, 2)
    assert a is b  # no view: the fast path returns the cached object


@parity
def test_execute_paths_do_not_mutate_prepared_opts(ix):
    opts = QueryOptions(k=10, now=12345)
    cq = ix.prepare("alpha beta @tag:{red}", None, opts, 2)
    before = _snap(cq)
    seg = ix.segments[0]
    execute_batch([cq] * 4, seg, 10)
    assert _snap(cq) == before
    # single-query path (bind + fallback executors)
    ix.search("alpha beta @tag:{red}", num=10)
    assert _snap(cq) == before
    # sorted + filtered path
    ix.search("alpha beta @tag:{red}", num=5, sort_by="price")
    assert _snap(cq) == before


@parity
def test_view_isolates_knn_payload(ix):
    """KNN/vector queries get per-call views: two prepares with
    different $vec payloads must not alias each other's blobs."""
    schema = rs.Schema(name="aliasv", fields=[
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(
                     dim=4, metric=rs.VectorMetric.L2))])
    ixv = rs.SearchIndex(schema)
    for i in range(32):
        ixv.add_document(f"k{i}", {"v": np.full(4, i, np.float32)})
    ixv.commit()
    opts = QueryOptions(k=3, now=99)
    a = ixv.prepare("*=>[KNN 3 @v $q]",
                    {"q": np.zeros(4, np.float32)}, opts, 2)
    b = ixv.prepare("*=>[KNN 3 @v $q]",
                    {"q": np.full(4, 31, np.float32)}, opts, 2)
    assert a is not b
    ra = execute_batch([a], ixv.segments[0], 3)[0]
    rb = execute_batch([b], ixv.segments[0], 3)[0]
    ga = [h.gid for h in ra.hits] if hasattr(ra, "hits") else None
    # whatever the result surface, the two blobs must stay distinct
    assert not np.array_equal(a.knn.blob, b.knn.blob)
    del ga
