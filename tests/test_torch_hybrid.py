"""FT.HYBRID through the port (aux/hybrid.py) against the JAX package, on the CPU.

Ports of tests/test_hybrid_fusion.py on a corpus engineered for
cross-branch duplicates (half the docs share one of 4 tokens, vectors
clustered around 4 centres, seed 11): the port's vectorized fusion
(`run_hybrid_many`) equals its hit-list fusion (`_run_hybrid_hits`) row
for row, keys and their order equal, every float within 1e-6 (the
vectorized path computes 1/(1+dist) from f32 distances, the hit-list
path from Python floats, in both packages, so the `_norm` rounding of
that file may round the two either way at a boundary), and both equal
the JAX
package's `run_hybrid_many`: keys, their order and every field name
equal, RRF scores and text scores within 1e-6, vector distances and the
LINEAR scores that carry them (and their YIELD_SCORE_AS copies) within the KNN parity tolerance of
tests/test_torch_knn.py (rtol 1e-5, atol 1e-6: both sides sum the L2
distance in f32, in different orders).  A rare word with fewer matches
than the window checks that exhausted text lanes drop out; a
two-segment index checks the merge across segments.
test_hybrid_fusion.py's test_fusion_after_delete is in
tests/test_torch_lifecycle.py.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.aux import hybrid as JH
from redisearch_tpu_torch.aux import hybrid as TH
from redisearch_tpu_torch.query import engine as TE

SCORE_ATOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
N, DIM = 3000, 16
WORDS = ["alpha", "beta", "gamma", "delta"]


def _fields(p):
    return [p.Field("txt", p.FieldType.TEXT),
            p.Field("year", p.FieldType.NUMERIC, sortable=True),
            p.Field("v", p.FieldType.VECTOR,
                    vector=p.VectorParams(dim=DIM,
                                          metric=p.VectorMetric.L2))]


def _corpus():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(4, DIM)).astype(np.float32)
    vecs = (centers[np.arange(N) % 4]
            + 0.3 * rng.normal(size=(N, DIM)).astype(np.float32))
    docs = [(f"d{i}", {"txt": f"{WORDS[i % 4]} common w{i % 7}"
                       + (" rare" if i % 500 == 3 else ""),
                       "year": float(1990 + i % 30), "v": vecs[i]})
            for i in range(N)]
    return docs, centers


def _pair(n_segments):
    docs, centers = _corpus()
    jix = rs.SearchIndex(rs.Schema(name="hf", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="hf", fields=_fields(rt)),
                         device="cpu")
    step = N // n_segments
    for ix in (jix, tix):
        for s in range(n_segments):
            ix.add_documents(docs[s * step:(s + 1) * step])
        assert len(ix.segments) == n_segments
    return jix, tix, centers


@pytest.fixture(scope="module")
def ix():
    return _pair(1)


@pytest.fixture(scope="module")
def ix2():
    return _pair(2)


def _same_fusion(fast, slow):
    """Vectorized against hit-list fusion: equal keys and order, floats
    within 1e-6."""
    assert [r["__key"] for r in fast] == [r["__key"] for r in slow]
    for ra, rb in zip(fast, slow):
        assert list(ra) == list(rb)
        for key, vb in rb.items():
            if isinstance(vb, float):
                assert abs(ra[key] - vb) <= SCORE_ATOL, (key, ra[key], vb)
            else:
                assert ra[key] == vb, (key, ra[key], vb)


def _same_rows(trows, jrows):
    """Equal keys, order and field names; distance-carrying floats within
    the KNN tolerance, the others within 1e-6."""
    assert [r["__key"] for r in trows] == [r["__key"] for r in jrows]
    for t, j in zip(trows, jrows):
        assert list(t) == list(j)
        for key, vj in j.items():
            vt = t[key]
            if "__vector_distance" in j and key in (
                    "__vector_distance", "__score", "fscore"):
                assert abs(vt - vj) <= ATOL + RTOL * abs(vj), (key, vt, vj)
            elif isinstance(vj, float):
                assert abs(vt - vj) <= SCORE_ATOL, (key, vt, vj)
            else:
                assert vt == vj, (key, vt, vj)


def _queries(pkg, centers, combine, n=12):
    rng = np.random.default_rng(3)
    words = WORDS + ["common", "rare"]
    return [pkg.HybridQuery(
        search=words[i % 6], vsim_field="v",
        vsim_vector=(centers[i % 4]
                     + 0.1 * rng.normal(size=DIM).astype(np.float32)),
        combine=combine, window=10 + (i % 3) * 5, limit=5 + i % 4,
        alpha=0.3, beta=0.7, rrf_constant=60 if i % 2 else 10)
        for i in range(n)]


@pytest.mark.parametrize("combine", ["RRF", "LINEAR"])
def test_fusion_matches_hitlist_path(ix, combine):
    jix, tix, centers = ix
    fast = TH.run_hybrid_many(tix, _queries(rt, centers, combine))
    slow = TH._run_hybrid_hits(tix, _queries(rt, centers, combine), None)
    for i, (f, s) in enumerate(zip(fast, slow)):
        _same_fusion(f, s)
    jres = JH.run_hybrid_many(jix, _queries(rs, centers, combine))
    for f, j in zip(fast, jres):
        _same_rows(f, j)


def test_fusion_rrf_tie_breaks_by_gid(ix):
    """Two docs at the same rank in different branches score identically
    under RRF; the lower doc id wins in both paths and both packages."""
    jix, tix, centers = ix
    mk = lambda p: p.HybridQuery(search="common", vsim_field="v",
                                 vsim_vector=centers[0], combine="RRF",
                                 window=20, limit=20)
    fast = TH.run_hybrid_many(tix, [mk(rt)])[0]
    slow = TH._run_hybrid_hits(tix, [mk(rt)], None)[0]
    _same_fusion(fast, slow)
    scores = [r["__score"] for r in fast]
    assert scores == sorted(scores, reverse=True)
    _same_rows(fast, JH.run_hybrid_many(jix, [mk(rs)])[0])


def test_fusion_with_tail_and_yield(ix):
    jix, tix, centers = ix

    def mk(p, P):
        hq = p.HybridQuery(search="alpha", vsim_field="v",
                           vsim_vector=centers[0], combine="LINEAR",
                           window=15, limit=10, yield_score_as="fscore")
        tail = (P.AggregateRequest("*").load("year")
                .filter("@year >= 2000").limit(0, 6))
        return hq, tail

    hq, tail = mk(rt, rt)
    hq2, tail2 = mk(rt, rt)
    fast = TH.run_hybrid_many(tix, [hq], [tail])[0]
    slow = TH._run_hybrid_hits(tix, [hq2], [tail2])[0]
    assert 0 < len(fast) <= 6
    _same_fusion(fast, slow)
    assert all("fscore" in r for r in fast)
    jhq, jtail = mk(rs, rs)
    _same_rows(fast, JH.run_hybrid_many(jix, [jhq], [jtail])[0])


@pytest.mark.parametrize("combine", ["RRF", "LINEAR"])
def test_rare_word_fewer_matches_than_window(ix, combine):
    """"rare" matches 6 docs, a window of 20: the text branch's 14
    exhausted lanes drop out (score <= -3.3e38 on every executor the
    branch takes), the KNN branch fills its window."""
    jix, tix, centers = ix
    mk = lambda p: [p.HybridQuery(search="rare", vsim_field="v",
                                  vsim_vector=centers[j], combine=combine,
                                  window=20, limit=40) for j in range(4)]
    TE.QUERY_PATH_STATS.clear()
    fast = TH.run_hybrid_many(tix, mk(rt))
    assert TE.QUERY_PATH_STATS.get("window") == 4
    for rows in fast:
        assert sum("__text_score" in r for r in rows) == 6
        assert sum("__vector_distance" in r for r in rows) == 20
    for f, s in zip(fast, TH._run_hybrid_hits(tix, mk(rt), None)):
        _same_fusion(f, s)
    for f, j in zip(fast, JH.run_hybrid_many(jix, mk(rs))):
        _same_rows(f, j)


@pytest.mark.parametrize("combine", ["RRF", "LINEAR"])
def test_two_segments_match_jax(ix2, combine):
    jix, tix, centers = ix2
    fast = TH.run_hybrid_many(tix, _queries(rt, centers, combine))
    for f, s in zip(fast, TH._run_hybrid_hits(
            tix, _queries(rt, centers, combine), None)):
        _same_fusion(f, s)
    for f, j in zip(fast, JH.run_hybrid_many(
            jix, _queries(rs, centers, combine))):
        _same_rows(f, j)


def test_async_handle_and_run_hybrid(ix):
    """async_=True returns a handle whose result() fuses; run_hybrid
    gives what the batch gives (distances within the KNN tolerance: the
    batch's distance product has another shape)."""
    _jix, tix, centers = ix
    hqs = _queries(rt, centers, "RRF", n=3)
    h = TH.run_hybrid_many(tix, hqs, async_=True)
    assert isinstance(h, TE.Deferred)
    many = h.result()
    for hq, rows in zip(hqs, many):
        _same_rows(TH.run_hybrid(tix, hq), rows)


def test_bad_requests_raise(ix):
    _jix, tix, centers = ix
    with pytest.raises(rt.utils.errors.QuerySyntaxError):
        TH.run_hybrid_many(tix, [rt.HybridQuery(search="alpha",
                                                vsim_vector=centers[0])])
    with pytest.raises(rt.utils.errors.QuerySyntaxError):
        TH.run_hybrid_many(tix, [rt.HybridQuery(
            search="alpha", vsim_field="v", vsim_vector=centers[0],
            combine="MAX")])
