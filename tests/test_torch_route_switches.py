"""The JAX package's three route switches, read by the port where the
JAX package reads them, on the CPU against the JAX package.

* RS_TPU_NO_INTERSECT_KERNEL: `_kernel_plan` (and so `_kernel_route`'s
  wide plan) and `_kernel_plan_phrase` return None, and every term and
  phrase query takes the window program;
* RS_TPU_NO_DENSE_KNN: `_knn_dense_plan` returns None;
* RS_TPU_NO_BF16_SCAN: `bf16_scan_copy` returns None, so a vector field
  sealed under it has no bf16 scan copy.

Each case holds the port's route (the plan, and the executor each batch
counts under `QUERY_PATH_STATS`) equal to the JAX package's with the
switch and without it, and the served results (totals, hit keys in
order, scores within rtol 1e-5, vector distances within 1e-5) equal
between the packages and to the results without the switch (a
filtered KNN batch reports its executor's count as its total, in both
packages: off the dense executor its hits are held to the default's,
its total to the JAX package's).  The environment is read at call time,
so `monkeypatch.setenv` takes effect.
The JAX package names the general window program's executor "scan"; the
port names it "window" ("knn-row" for a KNN query).  The JAX package
decides a batch's route when it first builds the batch's executor, which
it caches by signature for the process: each JAX batch here starts from
an empty executor cache (the test's own, `jax_executors`).
"""

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.index import segment as JS
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.index import segment as TS
from redisearch_tpu_torch.query import engine as TE

RTOL, DIST_ATOL = 1e-5, 1e-5
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "omega"]
#: the port's executor names in the JAX package's words
JAX_PATH = {"window": "scan", "knn-row": "scan"}


def _text_index(pkg, **kw):
    """tests/test_intersect_kernel.py's fixture index."""
    rng = np.random.default_rng(17)
    ix = pkg.SearchIndex(pkg.Schema(name="ik", fields=[
        pkg.Field("a", pkg.FieldType.TEXT, weight=2.0),
        pkg.Field("b", pkg.FieldType.TEXT)]), **kw)
    for i in range(800):
        ix.add_document(f"d{i}", {
            "a": " ".join(rng.choice(WORDS, 4)),
            "b": " ".join(rng.choice(WORDS, 7))})
    ix.commit()
    return ix


D = 8


def _vector_index(pkg, **kw):
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(700, D)).astype(np.float32)
    ix = pkg.SearchIndex(pkg.Schema(name="kv", fields=[
        pkg.Field("c", pkg.FieldType.TAG),
        pkg.Field("p", pkg.FieldType.NUMERIC),
        pkg.Field("v", pkg.FieldType.VECTOR,
                  vector=pkg.VectorParams(dim=D, metric="L2"))]), **kw)
    ix.add_documents([(f"d{i}", {"c": f"c{i % 5}", "p": float(i % 40),
                                 "v": vecs[i]}) for i in range(700)])
    ix.commit()
    return ix


@pytest.fixture(scope="module")
def text_idx():
    return _text_index(rs), _text_index(rt, device="cpu")


@pytest.fixture(scope="module")
def vec_idx():
    return _vector_index(rs), _vector_index(rt, device="cpu")


def _query_vecs(n):
    return np.random.default_rng(6).normal(size=(n, D)).astype(np.float32)


@pytest.fixture(autouse=True)
def jax_executors(monkeypatch):
    """The JAX package's executor caches, the test's own."""
    monkeypatch.setattr(JE, "_COMPILE_CACHE", {})
    monkeypatch.setattr(JE, "_COMBINED_CACHE", {})


def _served(ix, eng, queries, params=None, verbatim=True):
    """search_many of `queries` and the executors it counted (the JAX
    package's routes decided afresh)."""
    if eng is JE:
        JE._COMPILE_CACHE.clear()
        JE._COMBINED_CACHE.clear()
    eng.QUERY_PATH_STATS.clear()
    opts = [eng.QueryOptions(k=10, verbatim=verbatim)] * len(queries)
    res = ix.search_many(queries, params=params, k=10, opts_list=opts)
    return res, dict(eng.QUERY_PATH_STATS)


def _same(a, b, what, total=True):
    assert a.total == b.total or not total, what
    assert [h.key for h in a.hits] == [h.key for h in b.hits], what
    np.testing.assert_allclose([h.score for h in a.hits],
                               [h.score for h in b.hits], rtol=RTOL,
                               err_msg=str(what))
    da = [h.vector_distance for h in a.hits]
    db = [h.vector_distance for h in b.hits]
    assert [x is None for x in da] == [x is None for x in db], what
    if any(x is not None for x in da):
        np.testing.assert_allclose(da, db, rtol=0, atol=DIST_ATOL,
                                   err_msg=str(what))


def _compare(jix, tix, queries, params=None, verbatim=True):
    """Both packages' batch: equal results and equal executors.  Returns
    (the port's results, its executor counts)."""
    jres, jpaths = _served(jix, JE, queries, params, verbatim)
    tres, tpaths = _served(tix, TE, queries, params, verbatim)
    named = {}
    for p, n in tpaths.items():
        named[JAX_PATH.get(p, p)] = named.get(JAX_PATH.get(p, p), 0) + n
    assert named == jpaths, (queries[0], tpaths, jpaths)
    for q, j, t in zip(queries, jres, tres):
        _same(j, t, q)
    return tres, tpaths


def _bind(ix, q, pkg_engine, params=None, verbatim=True):
    seg = ix.segments[0]
    cq = ix.prepare(q, params, pkg_engine.QueryOptions(
        k=10, verbatim=verbatim), 2)
    return cq, seg, cq.bind_row(seg)[1][4]


TERM_QUERIES = ["alpha beta", "alpha -beta", "alpha ~beta", "alpha | beta",
                "gamma delta eps"]


@pytest.mark.parametrize("switch", [False, True], ids=["default", "off"])
def test_intersect_kernel_switch(text_idx, monkeypatch, switch):
    """test_intersect_kernel.py::test_kernel_disabled_env on both
    packages: with RS_TPU_NO_INTERSECT_KERNEL the intersection plan is
    None in both (and the port's wide route too), and every term query
    takes the window program; without it both plan the kernel."""
    jix, tix = text_idx
    base, base_paths = _compare(jix, tix, TERM_QUERIES)
    assert base_paths == {"kernel": len(TERM_QUERIES)}
    if switch:
        monkeypatch.setenv("RS_TPU_NO_INTERSECT_KERNEL", "1")
    for q in TERM_QUERIES:
        jcq, jseg, jbk = _bind(jix, q, JE)
        tcq, tseg, tbk = _bind(tix, q, TE)
        jplan = JE._kernel_plan(jcq, jseg, jbk, 16)
        tplan = TE._kernel_plan(tcq, tseg, tbk, 16)
        assert tplan == jplan, q
        assert (jplan is None) == switch, q
        assert (TE._kernel_route(tcq, tseg, tbk, 16) is None) == switch, q
    res, paths = _compare(jix, tix, TERM_QUERIES)
    assert paths == ({"window": len(TERM_QUERIES)} if switch
                     else {"kernel": len(TERM_QUERIES)})
    for q, a, b in zip(TERM_QUERIES, base, res):
        _same(a, b, q)


PHRASES = ['"alpha beta"', '"gamma delta eps"', '"omega zeta"']


@pytest.mark.parametrize("switch", [False, True], ids=["default", "off"])
def test_phrase_kernel_switch(text_idx, monkeypatch, switch):
    """The phrase kernel's plan under the same switch, in both packages,
    and the phrases served on each route."""
    jix, tix = text_idx
    base, base_paths = _compare(jix, tix, PHRASES)
    assert base_paths == {"phrase-kernel": len(PHRASES)}
    if switch:
        monkeypatch.setenv("RS_TPU_NO_INTERSECT_KERNEL", "1")
    for q in PHRASES:
        jcq, jseg, jbk = _bind(jix, q, JE)
        tcq, tseg, tbk = _bind(tix, q, TE)
        jplan = JE._kernel_plan_phrase(jcq, jseg, jbk, 16)
        tplan = TE._kernel_plan_phrase(tcq, tseg, tbk, 16)
        assert tplan == jplan, q
        assert (jplan is None) == switch, q
    res, paths = _compare(jix, tix, PHRASES)
    assert paths == ({"window": len(PHRASES)} if switch
                     else {"phrase-kernel": len(PHRASES)})
    for q, a, b in zip(PHRASES, base, res):
        _same(a, b, q)


DENSE_QUERIES = ["(@c:{c1})=>[KNN 10 @v $b]",
                 "(@p:[5 20])=>[KNN 10 @v $b]",
                 "(@c:{c2} -@p:[0 10])=>[KNN 10 @v $b]"]


@pytest.mark.parametrize("q", DENSE_QUERIES)
@pytest.mark.parametrize("switch", [False, True], ids=["default", "off"])
def test_dense_knn_switch(vec_idx, monkeypatch, switch, q):
    """RS_TPU_NO_DENSE_KNN: the dense-filter KNN plan is None in both
    packages, and both send the batch to the same other executor."""
    jix, tix = vec_idx
    params = [{"b": v} for v in _query_vecs(4)]
    base, base_paths = _compare(jix, tix, [q] * 4, params)
    assert base_paths == {"knn-dense": 4}
    if switch:
        monkeypatch.setenv("RS_TPU_NO_DENSE_KNN", "1")
    jcq, jseg, jbk = _bind(jix, q, JE, params[0])
    tcq, tseg, tbk = _bind(tix, q, TE, params[0])
    jplan = JE._knn_dense_plan(jcq, jseg, jbk)
    tplan = TE._knn_dense_plan(tcq, tseg, tbk)
    assert tplan == jplan
    assert (jplan is None) == switch
    res, paths = _compare(jix, tix, [q] * 4, params)
    assert ("knn-dense" in paths) != switch, paths
    # the hits are the same; the total a filtered KNN batch reports is
    # its executor's count, in both packages (10 dense, 16 on the window
    # program for the first query)
    for a, b in zip(base, res):
        _same(a, b, q, total=False)


@pytest.mark.parametrize("switch", [False, True], ids=["default", "off"])
def test_bf16_scan_switch(monkeypatch, switch):
    """RS_TPU_NO_BF16_SCAN: `bf16_scan_copy` returns None in both
    packages (and always for storage that is not f32), a field sealed
    under it has no scan copy, and KNN serves the same hits as the
    default build's, in both packages."""
    mat = np.random.default_rng(3).normal(size=(16, D)).astype(np.float32)
    q = ["*=>[KNN 10 @v $b]", "(@c:{c3})=>[KNN 10 @v $b]"] * 2
    params = [{"b": v} for v in _query_vecs(4)]
    base = _vector_index(rt, device="cpu")
    want = base.search_many(q, params=params, k=10)
    if switch:
        monkeypatch.setenv("RS_TPU_NO_BF16_SCAN", "1")
    assert TS.bf16_scan_copy(torch.from_numpy(mat.astype(np.int8))) is None
    assert (JS.bf16_scan_copy(mat) is None) == switch
    tcopy = TS.bf16_scan_copy(torch.from_numpy(mat))
    assert (tcopy is None) == switch
    if not switch:
        np.testing.assert_array_equal(
            tcopy.float().numpy(),
            np.asarray(JS.bf16_scan_copy(mat)).astype(np.float32))
    jix, tix = _vector_index(rs), _vector_index(rt, device="cpu")
    for ix in (jix, tix):
        assert (ix.segments[0].vectors["v"].scan_vecs is None) == switch
    res, _paths = _compare(jix, tix, q, params)
    for qq, a, b in zip(q, want, res):
        _same(a, b, qq)
