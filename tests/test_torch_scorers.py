"""Scorer behaviors: TFIDF/BM25/DISMAX/DOCSCORE/HAMMING + EXPLAINSCORE +
profile counters (reference: tests over src/ext/default.c scorers).

Parity file of tests/test_scorers.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import numpy as np
import pytest


@pytest.fixture()
def idx():
    return per_side(lambda: _idx_make())


def _idx_make():
    ix = rs.SearchIndex(rs.Schema(name="sc", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("short", {"t": "apple banana"}, score=1.0)
    ix.add_document("long", {"t": "apple " + "filler " * 50}, score=1.0)
    ix.add_document("boosted", {"t": "apple pie"}, score=2.0)
    ix.add_document("multi", {"t": "apple apple apple banana"}, score=1.0)
    ix.commit()
    return ix


@parity
def test_bm25_length_normalization(idx):
    res = idx.search("apple", scorer="BM25STD")
    keys = [h.key for h in res]
    # doc score 2.0 boost wins; long doc is penalized by length norm
    assert keys[0] == "boosted"
    assert keys.index("multi") < keys.index("long")


@parity
def test_tfidf(idx):
    res = idx.search("apple banana", scorer="TFIDF")
    assert res.hits[0].score > 0


@parity
def test_bm25_tanh_normalized(idx):
    res = idx.search("apple", scorer="BM25STD.TANH")
    assert all(0.0 <= h.score <= 1.0 for h in res)


@parity
def test_docscore(idx):
    res = idx.search("apple", scorer="DOCSCORE")
    assert res.hits[0].key == "boosted"
    assert res.hits[0].score == 2.0


@parity
def test_dismax(idx):
    res = idx.search("apple | banana", scorer="DISMAX")
    assert res.total == 4


@parity
def test_hamming():
    ix = rs.SearchIndex(rs.Schema(name="h", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("a", {"t": "x"}, payload=bytes([0b1111]))
    ix.add_document("b", {"t": "x"}, payload=bytes([0b1110]))
    ix.add_document("c", {"t": "x"}, payload=bytes([0b0000]))
    res = ix.search("x", scorer="HAMMING", payload=bytes([0b1111]))
    assert [h.key for h in res] == ["a", "b", "c"]
    assert res.hits[0].score == 1.0
    assert res.hits[1].score == 0.5


@parity
def test_explainscore():
    c = rs.Client()
    c.ft_create("e", [rs.Field("t", rs.FieldType.TEXT)])
    c.hset("d1", {"t": "apple banana cherry"})
    c.hset("d2", {"t": "apple apple"})
    exp = c.ft_explainscore("e", "apple banana", "d1")
    assert exp["value"] > 0
    assert exp["children"], "needs an explanation tree"
    # the tree's computed value matches the search score
    res = c.ft_search("e", "apple banana")
    d1_score = next(h.score for h in res if h.key == "d1")
    assert abs(exp["value"] - d1_score) < 1e-4


@parity
def test_profile_iterators():
    c = rs.Client()
    c.ft_create("p", [rs.Field("t", rs.FieldType.TEXT),
                      rs.Field("n", rs.FieldType.NUMERIC)])
    for i in range(30):
        c.hset(f"d{i}", {"t": "alpha" if i % 2 else "beta", "n": i})
    res, prof = c.ft_profile("p", "SEARCH", "alpha @n:[0 9]")
    it = prof["iterators"]
    assert it["type"] == "Intersect"
    counts = {k.get("term", k["type"]): k["counter"]
              for k in it["children"]}
    assert counts["alpha"] == 15
    assert counts["Numeric"] == 10
    assert it["counter"] == 5


@parity
def test_extension_api():
    ext = rs.ext

    @ext.scorer("BOOSTER")
    def booster(key, fields, base):
        return base * float(fields.get("boost", 1))

    @ext.expander("REVEXP")
    def revexp(token):
        return [token, token[::-1]]

    ix = rs.SearchIndex(rs.Schema(name="ext", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("boost", rs.FieldType.NUMERIC)]))
    ix.add_document("plain", {"t": "target word", "boost": 1})
    ix.add_document("boosted", {"t": "target word", "boost": 50})
    ix.add_document("rev", {"t": "tegrat only"})
    ix.commit()
    res = ix.search("target", scorer="BOOSTER")
    assert res.hits[0].key == "boosted"
    # custom expander matches the reversed form too
    QueryOptions = rs.query.engine.QueryOptions
    execute = rs.query.engine.execute
    cq = ix.compile(ix.parse_query("target"),
                    QueryOptions(expander="REVEXP"))
    r = execute(cq, ix.segments[0], 10)
    import numpy as np
    keys = {ix.doctable.get(int(ix.segments[0].gids_host[i])).key
            for i, s in zip(r.local_idx, r.scores) if s > -3.3e38}
    assert keys == {"plain", "boosted", "rev"}


# ---------------------------------------------------------------------------
# Exact-value pins: legacy BM25 formula + the GetSlop proximity divisor
# (reference: ext/default.c bm25Recursive:165-171, tfIdfInternal:131,
# BM25Scorer:226, IndexResult_MinOffsetDelta index_result.c:51)
# ---------------------------------------------------------------------------

import math


def _logb_idf(df, N):
    v = 1.0 + (N + 1) / max(df, 1.0)
    return math.frexp(v)[1] - 1


@pytest.fixture()
def prox_idx():
    return per_side(lambda: _prox_idx_make())


def _prox_idx_make():
    ix = rs.SearchIndex(rs.Schema(name="prox", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    # a: hello/world adjacent (min delta 1); b: 5 tokens apart
    ix.add_document("a", {"t": "hello world filler filler filler"})
    ix.add_document("b", {"t": "hello x1 x2 x3 x4 world"})
    ix.add_document("c", {"t": "hello only here"})
    ix.commit()
    return ix


@parity
def test_tfidf_slop_divisor_values(prox_idx):
    res = prox_idx.search("hello world", scorer="TFIDF")
    got = {h.key: h.score for h in res}
    N = 3
    idf_h, idf_w = _logb_idf(3, N), _logb_idf(2, N)
    # a: maxfreq 3 (filler x3), slop 1;  b: maxfreq 1, min delta 5
    exp_a = (idf_h / 3 + idf_w / 3) / 1
    exp_b = (idf_h / 1 + idf_w / 1) / 5
    assert got["a"] == pytest.approx(exp_a, rel=1e-5)
    assert got["b"] == pytest.approx(exp_b, rel=1e-5)
    assert "c" not in got


@parity
def test_legacy_bm25_formula_values(prox_idx):
    res = prox_idx.search("hello world", scorer="BM25")
    got = {h.key: h.score for h in res}
    N = 3
    avgdl = (5 + 6 + 3) / 3
    norm = 1.2 * (1 - 0.5 + 0.5 * avgdl)   # legacy: avgdl only, b=0.5
    idf_h, idf_w = _logb_idf(3, N), _logb_idf(2, N)
    per = idf_h * 1 / (1 + norm) + idf_w * 1 / (1 + norm)
    assert got["a"] == pytest.approx(per / 1, rel=1e-5)
    assert got["b"] == pytest.approx(per / 5, rel=1e-5)


@parity
def test_legacy_bm25_differs_from_bm25std(prox_idx):
    legacy = {h.key: h.score
              for h in prox_idx.search("hello world", scorer="BM25")}
    std = {h.key: h.score
           for h in prox_idx.search("hello world", scorer="BM25STD")}
    assert legacy != std


@parity
def test_bm25std_has_no_slop_divisor(prox_idx):
    # BM25STD ignores proximity entirely: same tf/doclen -> b only
    # differs through length norm, not the 5x slop penalty
    std = {h.key: h.score
           for h in prox_idx.search("hello world", scorer="BM25STD")}
    assert std["b"] > std["a"] / 2   # no /5 cliff


@parity
def test_phrase_slop_divisor(prox_idx):
    res = prox_idx.search('"hello world"', scorer="TFIDF")
    got = {h.key: h.score for h in res}
    # only a matches the exact phrase; adjacent terms -> slop 1
    N = 3
    exp_a = (_logb_idf(3, N) / 3 + _logb_idf(2, N) / 3)
    assert got == {"a": pytest.approx(exp_a, rel=1e-5)}


@parity
def test_explainscore_matches_engine_slop():
    explain_score = rs.aux.explain.explain_score
    ix = rs.SearchIndex(rs.Schema(name="exsl", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("b", {"t": "hello x1 x2 x3 x4 world"})
    ix.commit()
    for sc in ("TFIDF", "BM25"):
        eng = ix.search("hello world", scorer=sc).hits[0].score
        exp = explain_score(ix, "hello world", "b", scorer=sc)
        assert exp["value"] == pytest.approx(eng, rel=1e-5)
        assert "slop 5" in exp["description"]


@parity
def test_union_slop_single_match_is_one():
    # OR query where a doc matches only one branch: num children <= 1
    # at that doc -> slop 1 (reference: MinOffsetDelta early return)
    ix = rs.SearchIndex(rs.Schema(name="orsl", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("one", {"t": "hello a b c"})
    ix.add_document("both", {"t": "hello a b c d e f world"})
    ix.commit()
    got = {h.key: h.score
           for h in ix.search("hello | world", scorer="TFIDF")}
    N = 2
    idf_h, idf_w = _logb_idf(2, N), _logb_idf(1, N)
    assert got["one"] == pytest.approx(idf_h / 1, rel=1e-5)
    # both: min delta hello..world = 7 -> dist 49 -> slop 7
    assert got["both"] == pytest.approx((idf_h + idf_w) / 7, rel=1e-5)


@parity
def test_profile_measured_timings():
    """FT.PROFILE timings are measured (warm) and reconcile: the root
    iterator's warm time is within ~10x of the warm execution clock,
    and aggregate profiles carry per-stage measured clocks."""

    c = rs.Client()
    c.ft_create("prof2", [rs.Field("t", rs.FieldType.TEXT),
                          rs.Field("x", rs.FieldType.NUMERIC)])
    for i in range(500):
        c.hset(f"p{i}", {"t": f"apple w{i % 17} pie", "x": i})
    res, prof = c.ft_profile("prof2", "SEARCH", "apple w3")
    assert prof["results_count"] == res.total
    assert "warm_execution_time_ms" in prof
    it = prof["iterators"]
    assert it["counter"] == res.total
    assert it["time_ms"] > 0.0
    # child term nodes carry their own executed counters
    kids = it.get("children", [])
    assert kids and all(k["counter"] >= 0 for k in kids)

    AggregateRequest = rs.agg.pipeline.AggregateRequest
    req = (AggregateRequest("*").load("@x")
           .apply("upper(@t)", "u")
           .group_by("@u", ("COUNT", [], "n"))
           .sort_by(("@n", True)))
    res2, prof2 = c.ft_profile("prof2", "AGGREGATE", req)
    rps = prof2["result_processors"]
    assert rps[0]["name"] == "RP_INDEX"
    names = [r["name"] for r in rps]
    assert "GROUP" in names and "SORT" in names
    assert all(r["time_ms"] >= 0.0 for r in rps)
    assert rps[-1]["rows"] == len(res2.rows)
