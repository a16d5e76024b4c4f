"""FLAT vector search through the port's entry points against the JAX
package, on the CPU.

Both packages index the same documents (seeded numpy generators): a
TEXT field, a single-valued TAG, a NUMERIC, a TAG with INDEXMISSING, an
f32 L2 vector field (two-phase: bf16 candidate scan, f32 rescore) and a
multi-value int8 vector field.  The port also serves the JAX segment
carried across by `convert.segment_from_jax`.  Compared:
`SearchIndex.search` and `search_many` with PARAMS blobs (a different
blob a query, one query string per batch), and FT.AGGREGATE over a KNN
query.  Cases: pure KNN, TAG / NUMERIC / MISSING filters and NOT/OPT
wrapping (dense-filter executor), a text filter sent to the hoisted
executor by HYBRID_POLICY BATCHES (the corpus is too small for a
32,768-lane window), a narrow text filter (knn-row), an underfilled
hoisted query that re-runs through `execute`, multi-value documents,
VECTOR_RANGE, YIELD_DISTANCE_AS and AS, field TTL on the vector field,
and two segments with deletions.  Each batch asserts the executor
family it rides (`QUERY_PATH_STATS`).

Equal: totals, hit keys and their order (ties by doc id, as the JAX
merge orders them), scores within rtol 1e-5.  Vector distances within
rtol 1e-5, atol 1e-6 (both sides sum in f32, in different orders).
"""

import time

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.query import engine as TE

RTOL, ATOL = 1e-5, 1e-6
N, D, DW = 1500, 32, 8
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "eta"]


def _fields(p):
    F, T = p.Field, p.FieldType
    return [F("t", T.TEXT), F("c", T.TAG), F("p", T.NUMERIC),
            F("m", T.TAG, indexmissing=True),
            F("v", T.VECTOR, vector=p.VectorParams(dim=D, metric="L2")),
            F("w", T.VECTOR, vector=p.VectorParams(dim=DW, metric="L2",
                                                   dtype="INT8"))]


def _docs(n, seed=0, lo=0):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    out = []
    for i in range(n):
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), 3)]
        if i % 97 == 0:
            words.append("zeta")          # a rare word
        f = {"t": " ".join(words), "c": f"c{i % 7}", "p": float(i % 50),
             "v": vecs[i],
             "w": [rng.integers(-20, 21, DW).astype(np.float32)
                   for _ in range(1 + i % 3)]}
        if i % 3:
            f["m"] = f"m{i % 4}"
        out.append((f"d{lo + i}", f))
    return out


def _query_vecs(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)).astype(np.float32),
            rng.integers(-20, 21, size=(n, DW)).astype(np.float32))


@pytest.fixture(scope="module")
def idx():
    """One clean segment in both packages, and the port over the JAX
    segment (`segment_from_jax`)."""
    docs = _docs(N)
    jix = rs.SearchIndex(rs.Schema(name="k", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="k", fields=_fields(rt)),
                         device="cpu")
    cix = rt.SearchIndex(rt.Schema(name="k", fields=_fields(rt)),
                         device="cpu")
    for ix in (jix, tix, cix):
        ix.add_documents(docs)
    cix.segments = [segment_from_jax(jix.segments[0], "cpu")]
    return jix, tix, cix


@pytest.fixture(scope="module")
def idx2():
    """Two segments: the first with deletions (re-indexed keys), the
    second added one by one with field TTLs on the vector field (lapsed
    and live) and doc TTLs."""
    docs = _docs(900, seed=3)
    now = time.time()
    jix = rs.SearchIndex(rs.Schema(name="k2", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="k2", fields=_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        ix.add_documents(docs[:700])
        for i, (key, f) in enumerate(docs[700:]):
            fe = ({"v": now - 100} if i % 4 == 0
                  else {"v": now + 3600} if i % 4 == 1 else None)
            ttl = -100.0 if i % 9 == 0 else None
            ix.add_document(key, dict(f), field_expiration=fe, ttl=ttl)
        for key, f in docs[:40]:           # re-index: deletes in segment 1
            ix.add_document(key, dict(f, t=f["t"] + " alpha"))
        ix.commit()
        assert len(ix.segments) == 2
    return jix, tix


def _same(j, t, what):
    assert t.total == j.total, (what, j.total, t.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=RTOL,
                               atol=1e-7, err_msg=str(what))
    jd = [h.vector_distance for h in j.hits]
    td = [h.vector_distance for h in t.hits]
    assert [x is None for x in td] == [x is None for x in jd], what
    if any(x is not None for x in jd):
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL,
                                   err_msg=str(what))


def _params(i, extra=None):
    qv, qw = _query_vecs(8)
    p = {"b": qv[i], "q": qw[i]}
    p.update(extra or {})
    return p


def _batch(jix, tix, q, path, k=10, n=4, extra=None):
    """search_many of n copies of q, each with its own blobs, in both
    packages; the port's batch must ride `path`."""
    params = [_params(i, extra) for i in range(n)]
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many([q] * n, params=params, k=k)
    assert TE.QUERY_PATH_STATS == {path: n}, (q, TE.QUERY_PATH_STATS)
    jres = jix.search_many([q] * n, params=params, k=k)
    for i, (j, t) in enumerate(zip(jres, tres)):
        _same(j, t, (q, i))
    return tres


BATCHED = [
    ("*=>[KNN 10 @v $b]", "knn-pure"),
    ("(@c:{c1})=>[KNN 10 @v $b]", "knn-dense"),
    ("(@p:[10 30])=>[KNN 10 @v $b]", "knn-dense"),
    ("(ismissing(@m))=>[KNN 10 @v $b]", "knn-dense"),
    ("(@c:{c1|c2} -@p:[0 10])=>[KNN 10 @v $b]", "knn-dense"),
    ("(@c:{c2} ~@p:[0 10])=>[KNN 10 @v $b]", "knn-dense"),
    ("(alpha)=>[KNN 10 @v $b HYBRID_POLICY BATCHES]", "knn-batches"),
    ("(alpha beta)=>[KNN 10 @v $b]", "knn-row"),
    ("*=>[KNN 5 @w $q]", "window"),
    ("(@c:{c3})=>[KNN 5 @w $q]", "window"),
]


@pytest.mark.parametrize("q,path", BATCHED, ids=[p + ":" + q[:18]
                                                 for q, p in BATCHED])
def test_knn_search_many_matches_jax(idx, q, path):
    jix, tix, _cix = idx
    _batch(jix, tix, q, path)
    _same(jix.search(q, params=_params(5)), tix.search(q, params=_params(5)),
          q)


@pytest.mark.parametrize("q", [
    "*=>[KNN 10 @v $b]", "(@c:{c1})=>[KNN 10 @v $b]",
    "(alpha)=>[KNN 10 @v $b HYBRID_POLICY BATCHES]",
    "(alpha beta)=>[KNN 10 @v $b]", "(@c:{c3})=>[KNN 5 @w $q]"])
def test_converted_segment_matches_jax(idx, q):
    """The port's executors over the JAX segment itself."""
    jix, _tix, cix = idx
    params = [_params(i) for i in range(3)]
    for j, t in zip(jix.search_many([q] * 3, params=params, k=10),
                    cix.search_many([q] * 3, params=params, k=10)):
        _same(j, t, q)
    _same(jix.search(q, params=params[0]), cix.search(q, params=params[0]),
          q)


def test_underfilled_hoisted_query_reruns(idx, monkeypatch):
    """A rare filter on the hoisted executor: fewer than k of its top-M
    candidates pass, so the query is flagged and re-runs through
    `execute` on the same device, and still equals the JAX package."""
    jix, tix, _cix = idx
    calls = []
    real = TE.execute

    def counting(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(TE, "execute", counting)
    q = "(zeta)=>[KNN 10 @v $b HYBRID_POLICY BATCHES]"
    tres = _batch(jix, tix, q, "knn-batches", n=3)
    assert len(calls) == 3
    assert all(len(t.hits) == 10 for t in tres)


@pytest.mark.parametrize("q", [
    "@v:[VECTOR_RANGE $r $b]", "alpha @v:[VECTOR_RANGE $r $b]",
    "@w:[VECTOR_RANGE 900 $q]",
    "@v:[VECTOR_RANGE $r $b]=>{$yield_distance_as: dist}"])
def test_vector_range_matches_jax(idx, q):
    jix, tix, _cix = idx
    extra = {"r": 48.0}
    res = _batch(jix, tix, q, "window", k=20, extra=extra)
    assert all(0 < r.total < N for r in res)
    _same(jix.search(q, params=_params(1, extra), num=20),
          tix.search(q, params=_params(1, extra), num=20), q)


def test_knn_yield_alias_and_offsets(idx):
    """`AS dist` and YIELD_DISTANCE_AS parse and serve as without them
    (the JAX package keeps the alias on the AST only); LIMIT offsets
    slice the merged KNN hits."""
    jix, tix, _cix = idx
    for q in ("*=>[KNN 12 @v $b AS dist]",
              "(@c:{c4})=>[KNN 12 @v $b]=>{$yield_distance_as: dd}"):
        for kw in ({}, dict(offset=3, num=5)):
            _same(jix.search(q, params=_params(2), **kw),
                  tix.search(q, params=_params(2), **kw), (q, kw))


def test_same_string_distinct_blobs_in_one_batch(idx):
    """One query string, a different blob a row: each row keeps its own
    (the JAX package's tests/test_fields.py pins this for itself)."""
    _jix, tix, _cix = idx
    qv, _ = _query_vecs(3, seed=7)
    res = tix.search_many(["*=>[KNN 1 @v $b]"] * 3,
                          params=[{"b": tix.segments[0].vectors["v"]
                                   .vecs[i * 11].numpy()} for i in range(3)],
                          k=1)
    assert [r.hits[0].key for r in res] == ["d0", "d11", "d22"]
    assert [r.hits[0].vector_distance for r in res] == pytest.approx(
        [0.0] * 3, abs=1e-4)


@pytest.mark.parametrize("q,path", [
    ("*=>[KNN 10 @v $b]", "knn-pure"),
    ("(@c:{c1})=>[KNN 10 @v $b]", "knn-dense"),
    ("(alpha)=>[KNN 10 @v $b HYBRID_POLICY BATCHES]", "knn-batches"),
    ("(alpha beta)=>[KNN 10 @v $b]", "knn-row")])
def test_two_segments_field_ttl_match_jax(idx2, q, path):
    """Deletions, doc TTLs and field TTLs on the vector field, and the
    merge of two segments by (distance, doc id)."""
    jix, tix = idx2
    params = [_params(i) for i in range(3)]
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many([q] * 3, params=params, k=10)
    assert TE.QUERY_PATH_STATS == {path: 6}     # 3 queries x 2 segments
    for j, t in zip(jix.search_many([q] * 3, params=params, k=10), tres):
        _same(j, t, q)
    _same(jix.search(q, params=params[0]), tix.search(q, params=params[0]),
          q)


def test_aggregate_over_knn_matches_jax(idx):
    jix, tix, _cix = idx
    q = "(@p:[0 30])=>[KNN 40 @v $b]"

    def req(p):
        return (p.AggregateRequest(q, params=_params(3))
                .apply("@p * 2", "p2")
                .group_by("@c", ("COUNT", [], "n"), ("SUM", ["@p2"], "s"),
                          ("TOLIST", ["@m"], "ms"))
                .sort_by(("@n", p.DESC), "@c").limit(0, 5))

    j = jix.aggregate(req(rs))
    TP.AGG_PATH_STATS.clear()
    t = tix.aggregate(req(rt))
    many = tix.aggregate_many([req(rt), req(rt)])
    assert TP.AGG_PATH_STATS == {"knn": 3}
    assert t.total == j.total
    for r in [t] + many:
        assert [{kk: (sorted(v) if isinstance(v, list) else v)
                 for kk, v in row.items()} for row in r.rows] == \
            [{kk: (sorted(v) if isinstance(v, list) else v)
              for kk, v in row.items()} for row in j.rows]


@pytest.mark.parametrize("vp,item", [
    (dict(algo="HNSW"), "A8"), (dict(algo="IVF"), "A8"),
    (dict(algo="TIERED"), "A8"), (dict(storage="host"), "A8"),
    (dict(storage="host", compression="LVQ8"), "A8")],
    ids=["hnsw", "ivf", "tiered", "host", "lvq8"])
def test_unported_vector_options_are_refused(vp, item):
    """These options were refused at FT.CREATE until A8 landed; now
    `Client.ft_create` builds them (an IVF structure on the device, or
    the host tier's HostIVF), and at nprobe = nlist a KNN query returns
    the JAX package's answer."""
    del item
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(300, 4)).astype(np.float32)
    kw = dict(dim=4, nlist=4, nprobe=4, flat_buffer_limit=64, **vp)
    out = []
    for p in (rs, rt):
        c = p.Client() if p is rs else p.Client(device="cpu")
        ix = c.ft_create("x", [p.Field("v", p.FieldType.VECTOR,
                                       vector=p.VectorParams(**kw))])
        for i in range(300):
            c.hset(f"d{i}", {"v": vecs[i]})
        res = c.ft_search("x", "*=>[KNN 5 @v $b]",
                          params={"b": vecs[9] + 0.01})
        out.append([h.key for h in res.hits])
    col = ix.segments[0].vectors["v"]
    if vp.get("storage") == "host":
        assert col.host and col.host_ivf is not None
        assert col.host_ivf.compression == vp.get("compression", "")
    else:
        assert col.ivf is not None and col.ivf.nlist == 4
    assert out[0] == out[1] and out[1][0] == "d9"


def test_hybrid_is_refused():
    """Client.ft_hybrid is served now: tests/test_client.py's
    test_hybrid_rrf on both packages, RRF and LINEAR, equal rows."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(10, 4)).astype(np.float32)
    out = []
    for pkg, c in ((rs, rs.Client()), (rt, rt.Client(device="cpu"))):
        c.ft_create("h", [pkg.Field("txt", pkg.FieldType.TEXT),
                          pkg.Field("v", pkg.FieldType.VECTOR,
                                    vector=pkg.VectorParams(
                                        dim=4, metric=pkg.VectorMetric.L2))])
        for i in range(10):
            c.hset(f"d{i}", {"txt": f"common word{'s' if i % 2 else ''} "
                                    f"{i}", "v": vecs[i]})
        rows = c.ft_hybrid("h", pkg.HybridQuery(
            search="common", vsim_field="v", vsim_vector=vecs[4],
            combine="RRF", limit=5))
        rows2 = c.ft_hybrid("h", pkg.HybridQuery(
            search="common", vsim_field="v", vsim_vector=vecs[4],
            combine="LINEAR", alpha=0.1, beta=0.9, limit=5))
        assert rows[0]["__key"] == "d4" and rows2[0]["__key"] == "d4"
        out.append((rows, rows2))
    for j, t in zip(out[0], out[1]):
        assert [r["__key"] for r in t] == [r["__key"] for r in j]
        for rt_, rj in zip(t, j):
            assert list(rt_) == list(rj)
            for key, vj in rj.items():
                if isinstance(vj, float):
                    assert abs(rt_[key] - vj) <= ATOL + RTOL * abs(vj)


def test_client_params_blobs(idx):
    """Client.ft_search / ft_search_many with PARAMS, bytes blobs."""
    jix, _tix, _cix = idx
    docs = [(jix.doctable.get(g).key, jix.doctable.get(g).fields)
            for g in range(1, 401)]
    jc, tc = rs.Client(), rt.Client(device="cpu")
    for c, pkg in ((jc, rs), (tc, rt)):
        c.ft_create("i", _fields(pkg))
        for key, f in docs:
            c.hset(key, f)
    qv, _ = _query_vecs(2, seed=9)
    for blob in (qv[0], qv[0].tobytes()):
        q = "(@c:{c2})=>[KNN 5 @v $b]"
        _same(jc.ft_search("i", q, params={"b": blob}),
              tc.ft_search("i", q, params={"b": blob}), q)
        for j, t in zip(jc.ft_search_many("i", [q, q], params=[
                {"b": blob}, {"b": qv[1]}], k=5),
                tc.ft_search_many("i", [q, q], params=[
                    {"b": blob}, {"b": qv[1]}], k=5)):
            _same(j, t, q)
