"""The general window program against the JAX package, on the CPU.

Both packages index the same documents (made from seeded numpy
generators) and run the same queries through

* `query.engine.execute` in both modes ("topk" and "window"),
* `SearchIndex.search` (single FT.SEARCH: all seven scorers, TAG and
  NUMERIC filters, NOT/OPT, phrases the phrase kernel refuses, prefix,
  fuzzy and wildcard expansions, SORTBY both ways, INKEYS, a segment
  with deletions, TTLs and non-uniform doc scores, two segments), and
* `search_many` on query groups neither kernel takes (`_WindowExecutor`).

Totals, hit keys and their order must be equal; scores agree to rtol
1e-5 (the same f32 operations, but the JAX program is fused by XLA).
Window-mode outputs match lane for lane.  A phrase inside an AND is held
against the set intersection of its parts instead (ROADMAP §C: the JAX
block membership misses docs there).
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.query import engine as TE

RTOL = 1e-5
NOW = 1_700_000_000


def _fields(p):
    F, T = p.Field, p.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True), F("lab", T.TAG)]


def _docs(n, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array(["w%04d" % i for i in range(300)])
    zipf = np.clip(rng.zipf(1.3, size=(n, 12)) - 1, 0, 299)
    return [(f"d{i}", {"title": " ".join(words[zipf[i, :3]]),
                       "body": " ".join(words[zipf[i, 3:]]),
                       "cat": "cat%02d" % (i % 16), "grp": "g%03d" % (i % 50),
                       "price": float(rng.integers(1, 1000)),
                       "lab": ",".join(sorted({"x%d" % (i % 3),
                                               "y%d" % (i % 5)}))})
            for i in range(n)]


@pytest.fixture(scope="module")
def idx():
    """One clean 1,500-doc segment."""
    docs = _docs(1500)
    jix = rs.SearchIndex(rs.Schema(name="s", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="s", fields=_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        ix.add_documents(docs)
    return jix, tix


@pytest.fixture(scope="module")
def dirty_idx():
    """Two segments: the first with deletions (re-indexed keys), the
    second with TTLs (lapsed and live) and doc scores other than 1."""
    docs = _docs(900, seed=3)
    jix = rs.SearchIndex(rs.Schema(name="s", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="s", fields=_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        ix.add_documents(docs[:700])
        for i, (key, f) in enumerate(docs[700:]):
            ttl = -100.0 if i % 7 == 0 else (3600.0 if i % 7 == 1 else None)
            ix.add_document(key, dict(f), score=1.0 + (i % 3) * 0.5,
                            ttl=ttl)
        for key, f in docs[:60]:           # re-index: deletes in segment 1
            ix.add_document(key, dict(f, body=f["body"] + " w0001"))
        ix.commit()
        assert len(ix.segments) == 2
    return jix, tix


def _same(j, t, what):
    assert t.total == j.total, (what, j.total, t.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=RTOL,
                               atol=1e-7, err_msg=str(what))


QUERIES = ["w0001 w0002", "w0001|w0003", "w0001 -w0002", "w0001 ~w0002",
           "@price:[100 500]", "w0001 @price:[100 (500]", "*",
           "@cat:{cat01|cat02}", "w0002 @lab:{x1}", '"w0000 w0001"',
           "w00*", "%w0001%", "(w0001|w0002) (w0003|w0004)", "-w0001",
           "w0000 w0001 w0002 w0003 w0004", "@title:w0001 @body:w0002",
           "w0001 @grp:{g001}", "@price:[-inf 50]", "w*1", "w0005 -@cat:{cat03}"]


@pytest.mark.parametrize("q", QUERIES)
def test_search_matches_jax(idx, q):
    jix, tix = idx
    _same(jix.search(q, num=10), tix.search(q, num=10), q)


@pytest.mark.parametrize("scorer", ["BM25STD", "BM25STD.TANH", "TFIDF",
                                    "TFIDF.DOCNORM", "BM25", "DISMAX",
                                    "DOCSCORE"])
def test_scorers_match_jax(idx, scorer):
    jix, tix = idx
    for q in ("w0001 w0002", "w0001|w0003 ~w0004"):
        _same(jix.search(q, num=10, scorer=scorer),
              tix.search(q, num=10, scorer=scorer), (scorer, q))


@pytest.mark.parametrize("kw", [
    dict(sort_by="price"), dict(sort_by="price", sort_asc=False),
    dict(sort_by="grp"), dict(sort_by="grp", sort_asc=False),
    dict(slop=2), dict(slop=1, inorder=True), dict(offset=5, num=7),
    dict(in_keys=[f"d{i}" for i in range(0, 1500, 3)]),
    dict(in_fields=["title"]), dict(verbatim=True)],
    ids=["sort-price", "sort-price-desc", "sort-grp", "sort-grp-desc",
         "slop2-unordered", "slop1-inorder", "offset", "inkeys", "infields",
         "verbatim"])
def test_search_options_match_jax(idx, kw):
    jix, tix = idx
    for q in ("w0001|w0002", "w0001 w0002 w0003"):
        j, t = jix.search(q, **kw), tix.search(q, **kw)
        _same(j, t, (q, kw))
        if "sort_by" in kw:
            assert [h.sortkey for h in t.hits] == [h.sortkey for h in j.hits]


def test_phrases_the_kernel_refuses_match_jax(idx):
    jix, tix = idx
    for q, kw in (('"w0000 w0001 w0002 w0000 w0001"', {}),
                  ("w0000 w0001", dict(slop=3)),
                  ('"w0001 w0000 w0002"', {})):
        _same(jix.search(q, **kw), tix.search(q, **kw), q)


def test_dirty_two_segments_match_jax(dirty_idx):
    """Deletions, lapsed and live TTLs, doc scores other than 1, and the
    merge of two segments."""
    jix, tix = dirty_idx
    for q in ("w0001", "w0001 w0002", "w0001|w0004", "*", "@price:[1 300]",
              '"w0000 w0001"'):
        for scorer in ("BM25STD", "TFIDF"):
            _same(jix.search(q, scorer=scorer), tix.search(q, scorer=scorer),
                  (q, scorer))
    j = jix.search("w0001", sort_by="grp", num=20)
    t = tix.search("w0001", sort_by="grp", num=20)
    _same(j, t, "sort across segments")


@pytest.mark.parametrize("mode", ["topk", "window"])
def test_execute_matches_jax(idx, mode):
    jix, tix = idx
    for q in ("w0001 w0002", "w0001|w0003", '"w0000 w0001"', "*",
              "@price:[100 500] -w0001"):
        jcq = jix.prepare(q, None, rs.QueryOptions(k=10, now=NOW), 2)
        tcq = tix.prepare(q, None, rt.QueryOptions(k=10, now=NOW), 2)
        j = JE.execute(jcq, jix.segments[0], 10, mode=mode)
        t = TE.execute(tcq, tix.segments[0], 10, mode=mode)
        assert t.count == j.count, q
        if mode == "window":
            np.testing.assert_array_equal(t.valid, j.valid)
            np.testing.assert_array_equal(t.local_idx[t.valid],
                                          j.local_idx[j.valid])
            np.testing.assert_allclose(t.scores[t.valid], j.scores[j.valid],
                                       rtol=RTOL)
        else:
            live = j.scores > -3.3e38
            np.testing.assert_array_equal(t.local_idx[live],
                                          j.local_idx[live])
            np.testing.assert_allclose(t.scores, j.scores, rtol=RTOL)


def test_phrase_inside_and_is_the_set_intersection(idx):
    """ROADMAP §C: the port serves `term "phrase"` as the intersection of
    its parts; the JAX block membership drops docs there."""
    jix, tix = idx
    phrase = {h.key for h in tix.search('"w0000 w0001"', num=5000).hits}
    term = {h.key for h in tix.search("w0003", num=5000).hits}
    want = phrase & term
    t = tix.search('w0003 "w0000 w0001"', num=5000)
    assert t.total == len(want) > 0
    assert {h.key for h in t.hits} == want
    assert jix.search('w0003 "w0000 w0001"', num=5000).total < len(want)


def test_search_many_window_groups_match_jax(idx):
    """Groups no kernel takes run on the window program, per query."""
    jix, tix = idx
    queries = ["@price:[100 500]", "w0001 @price:[1 300]",
               '"w0000 w0001 w0002 w0000 w0001"', "*", "-w0002",
               "@cat:{cat01}", "w0001 w0002"]
    opts = [rt.QueryOptions(k=10, now=NOW) for _ in queries]
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many(queries, k=10, opts_list=opts)
    assert TE.QUERY_PATH_STATS == {"window": 6, "kernel": 1}
    jres = jix.search_many(queries, k=10, opts_list=[
        rs.QueryOptions(k=10, now=NOW) for _ in queries])
    for q, j, t in zip(queries, jres, tres):
        _same(j, t, q)


def test_client_ft_search(idx):
    jix, _tix = idx
    docs = [(jix.doctable.get(g).key, jix.doctable.get(g).fields)
            for g in range(1, 801)]
    jc, tc = rs.Client(), rt.Client(device="cpu")
    for c, pkg in ((jc, rs), (tc, rt)):
        c.ft_create("i", _fields(pkg))
        for key, f in docs:
            c.hset(key, f)
    for q in ("w0001 w0002", "@price:[100 200]"):
        _same(jc.ft_search("i", q), tc.ft_search("i", q), q)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        tc.ft_search("i", "w0001", scorer="HAMMING")
