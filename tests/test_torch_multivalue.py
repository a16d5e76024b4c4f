"""Multi-value field tests (JSON arrays).

Reference behaviors: multi-value numeric fields index every array element
into the range tree (a doc matches if ANY value is in range); multi-value
vector fields score a doc by its BEST vector (VecSim multi-value support,
src/vector_index.h).  SORTBY uses the first value.

Parity file of tests/test_multivalue.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import os
import tempfile

import numpy as np
import pytest

Client = rs.api.Client
checkpoint = rs.aux.checkpoint
Field = rs.schema.Field
FieldType = rs.schema.FieldType
VectorParams = rs.schema.VectorParams


@pytest.fixture()
def nclient():
    return per_side(lambda: _nclient_make())

def _nclient_make():
    c = Client()
    c.ft_create("j", [Field("$.nums", FieldType.NUMERIC, alias="nums"),
                      Field("$.name", FieldType.TEXT, alias="name")],
                on_json=True)
    c.hset("d1", {"name": "alpha", "nums": [5, 100, 250]})
    c.hset("d2", {"name": "beta", "nums": [7]})
    c.hset("d3", {"name": "gamma", "nums": [300, 400]})
    c.hset("d4", {"name": "delta"})
    return c


class TestMultiNumeric:
    @parity
    def test_any_value_matches_predicate(self, nclient):
        r = nclient.ft_search("j", "alpha @nums:[90 110]", no_content=True)
        assert r.total == 1 and r.hits[0].key == "d1"

    @parity
    def test_generator_path_and_dedup(self, nclient):
        # pure range query drives the window generator; a doc with two
        # in-range values must appear exactly once
        r = nclient.ft_search("j", "@nums:[0 1000]", no_content=True)
        assert r.total == 3
        assert sorted(h.key for h in r.hits) == ["d1", "d2", "d3"]

    @parity
    def test_range_touching_later_values(self, nclient):
        r = nclient.ft_search("j", "@nums:[240 260]", no_content=True)
        assert [h.key for h in r.hits] == ["d1"]
        r = nclient.ft_search("j", "@nums:[390 500]", no_content=True)
        assert [h.key for h in r.hits] == ["d3"]

    @parity
    def test_sortby_uses_first_value(self, nclient):
        # d4 has no nums value: it still matches and ranks last
        # (reference: cmp_fields — missing sort keys rank "worst")
        r = nclient.ft_search("j", "*", sort_by="nums", no_content=True)
        assert [h.key for h in r.hits] == ["d1", "d2", "d3", "d4"]


@pytest.fixture()
def vclient():
    return per_side(lambda: _vclient_make())

def _vclient_make():
    c = Client()
    c.ft_create("mv", [
        Field("$.name", FieldType.TEXT, alias="name"),
        Field("$.vecs", FieldType.VECTOR, alias="vecs",
              vector=VectorParams(dim=4, algo="FLAT", metric="L2")),
    ], on_json=True)
    c.hset("d1", {"name": "alpha",
                  "vecs": [[0.1, 0, 0, 0], [10, 10, 10, 10]]})
    c.hset("d2", {"name": "beta", "vecs": [[5, 5, 5, 5]]})
    c.hset("d3", {"name": "gamma",
                  "vecs": [[0.2, 0, 0, 0], [0.3, 0, 0, 0]]})
    return c


Q = np.zeros(4, np.float32)


class TestMultiVector:
    @parity
    def test_knn_best_vector_wins(self, vclient):
        r = vclient.ft_search("mv", "*=>[KNN 3 @vecs $b]",
                              params={"b": Q}, no_content=True, dialect=2)
        assert [h.key for h in r.hits] == ["d1", "d3", "d2"]
        assert r.hits[0].vector_distance < 0.02

    @parity
    def test_filtered_knn_exact_gather(self, vclient):
        r = vclient.ft_search("mv", "(alpha|beta)=>[KNN 2 @vecs $b]",
                              params={"b": Q}, no_content=True, dialect=2)
        assert [h.key for h in r.hits] == ["d1", "d2"]

    @parity
    def test_vector_range_any_vector(self, vclient):
        r = vclient.ft_search("mv", "@vecs:[VECTOR_RANGE 0.2 $b]",
                              params={"b": Q}, no_content=True, dialect=2)
        assert sorted(h.key for h in r.hits) == ["d1", "d3"]

    @parity
    def test_no_duplicate_docs(self, vclient):
        r = vclient.ft_search("mv", "*=>[KNN 10 @vecs $b]",
                              params={"b": Q}, no_content=True, dialect=2)
        assert sorted(h.key for h in r.hits) == ["d1", "d2", "d3"]

    @parity
    def test_checkpoint_roundtrip(self, vclient):
        ix = vclient._index("mv")
        ix.commit()
        with tempfile.TemporaryDirectory() as td:
            pth = os.path.join(td, "ck")
            checkpoint.save(ix, pth)
            ix2 = checkpoint.load(pth)
            r = ix2.search("*=>[KNN 3 @vecs $b]", params={"b": Q},
                           no_content=True)
            assert [h.key for h in r.hits] == ["d1", "d3", "d2"]


class TestQueryBlobDtypes:
    """Query blobs decode against the field's storage dtype (reference:
    blobs are raw VecSimType arrays); int8/uint8 run integer MXU matmuls."""

    def _mk(self, metric, dtype, dim=8):
        c = Client()
        c.ft_create("ix", [Field("v", FieldType.VECTOR,
                                 vector=VectorParams(dim=dim, algo="FLAT",
                                                     metric=metric,
                                                     dtype=dtype))])
        return c

    @parity
    def test_int8_exact(self):
        rng = np.random.default_rng(0)
        c = self._mk("L2", "INT8")
        data = rng.integers(-100, 100, size=(50, 8), dtype=np.int8)
        for i, row in enumerate(data):
            c.hset(f"d{i}", {"v": row.tobytes().decode("latin-1")})
        q = rng.integers(-100, 100, size=8, dtype=np.int8)
        r = c.ft_search("ix", "*=>[KNN 5 @v $b]", params={"b": q.tobytes()},
                        no_content=True, dialect=2)
        d = ((data.astype(np.int64) - q.astype(np.int64)) ** 2).sum(1)
        expect = [f"d{i}" for i in np.argsort(d, kind="stable")[:5]]
        assert [h.key for h in r.hits] == expect
        assert np.allclose(sorted(d)[:5],
                           sorted(h.vector_distance for h in r.hits))

    @parity
    def test_uint8_cosine(self):
        rng = np.random.default_rng(1)
        c = self._mk("COSINE", "UINT8")
        du = rng.integers(1, 255, size=(30, 8), dtype=np.uint8)
        for i, row in enumerate(du):
            c.hset(f"u{i}", {"v": row.tobytes().decode("latin-1")})
        qu = rng.integers(1, 255, size=8, dtype=np.uint8)
        r = c.ft_search("ix", "*=>[KNN 3 @v $b]",
                        params={"b": qu.tobytes()}, no_content=True,
                        dialect=2)
        f = du.astype(np.float64)
        qf = qu.astype(np.float64)
        cos = 1 - (f @ qf) / (np.linalg.norm(f, axis=1)
                              * np.linalg.norm(qf))
        expect = [f"u{i}" for i in np.argsort(cos, kind="stable")[:3]]
        assert [h.key for h in r.hits] == expect

    @parity
    def test_bfloat16_blob(self):
        import ml_dtypes
        rng = np.random.default_rng(2)
        c = self._mk("L2", "BFLOAT16", 4)
        db = rng.normal(size=(20, 4)).astype(ml_dtypes.bfloat16)
        for i, row in enumerate(db):
            c.hset(f"b{i}", {"v": row.tobytes().decode("latin-1")})
        qb = rng.normal(size=4).astype(ml_dtypes.bfloat16)
        r = c.ft_search("ix", "*=>[KNN 3 @v $b]",
                        params={"b": qb.tobytes()}, no_content=True,
                        dialect=2)
        d = ((db.astype(np.float32) - qb.astype(np.float32)) ** 2).sum(1)
        expect = [f"b{i}" for i in np.argsort(d, kind="stable")[:3]]
        assert [h.key for h in r.hits] == expect

    @parity
    def test_float64_blob(self):
        rng = np.random.default_rng(3)
        c = self._mk("IP", "FLOAT64", 4)
        dd = rng.normal(size=(10, 4))
        for i, row in enumerate(dd):
            c.hset(f"f{i}", {"v": row.tobytes().decode("latin-1")})
        qd = rng.normal(size=4)
        r = c.ft_search("ix", "*=>[KNN 2 @v $b]",
                        params={"b": qd.tobytes()}, no_content=True,
                        dialect=2)
        expect = [f"f{i}" for i in np.argsort(1 - dd @ qd,
                                              kind="stable")[:2]]
        assert [h.key for h in r.hits] == expect

    @parity
    def test_blob_size_mismatch_errors(self):
        c = self._mk("L2", "INT8")
        c.hset("d0", {"v": np.zeros(8, np.int8).tobytes().decode("latin-1")})
        import pytest as _pytest
        QuerySyntaxError = rs.utils.errors.QuerySyntaxError
        with _pytest.raises(resolve(QuerySyntaxError)):
            c.ft_search("ix", "*=>[KNN 1 @v $b]",
                        params={"b": np.zeros(4, np.int8).tobytes()},
                        dialect=2)


@parity
def test_batched_knn_binds_per_query_blob():
    """execute_batch must bind each query's own vector blob (the blob is
    per-query dynamic state, not batch-prototype state)."""
    rng = np.random.default_rng(7)
    c = Client()
    c.ft_create("bk", [Field("v", FieldType.VECTOR,
                             vector=VectorParams(dim=8, algo="FLAT",
                                                 metric="L2"))])
    data = rng.normal(size=(40, 8)).astype(np.float32)
    for i, row in enumerate(data):
        c.hset(f"d{i}", {"v": row.tobytes().decode("latin-1")})
    q1 = data[3] + 0.01
    q2 = data[29] + 0.01
    res = c.ft_search_many(
        "bk", ["*=>[KNN 1 @v $b]", "*=>[KNN 1 @v $b]"],
        params=[{"b": q1.tobytes()}, {"b": q2.tobytes()}], k=1)
    assert res[0].hits[0].key == "d3"
    assert res[1].hits[0].key == "d29"
