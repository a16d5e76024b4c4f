"""Batched FT.SEARCH through the port against the JAX package, on the CPU.

Both packages index the same documents (made from seeded numpy
generators) and serve the same query batches through `search_many`: the
queries of tests/test_intersect_kernel.py (`QUERIES`, `TAG_QUERIES`, the
multi-slot stem queries) and bench.py's seven intersection-kernel
families on a 2k-doc corpus of the bench's shape.  Totals and hit keys
must be equal and in the same order; scores agree to rtol 1e-5.  The
planner is a copy of the JAX one, so its transport rows and kernel plans
must be byte-identical.  Queries outside the kernel run on the general
window program, as single `search()` does.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.query import engine as TE

RTOL = 1e-5
NOW = 1_700_000_000

QUERIES = ["alpha beta", "alpha -beta", "alpha ~beta", "alpha",
           "gamma delta eps", "omega -alpha", "zeta beta",
           "alpha | beta", "gamma | delta | eps", "omega | omega"]

TAG_QUERIES = [
    "alpha beta @color:{r}",
    "alpha @color:{r|g}",
    "alpha beta -@color:{b}",
    "alpha @color:{r} @labels:{x}",      # two tag fields (two aux arrays)
    "alpha @color:{nosuchvalue}",        # empty tag window
    "alpha ~@color:{g}",                 # optional tag
]

STEM_QUERIES = ["running jumping", "walking -talking", "runs ~quickly",
                "jumped", "running | walking", "talked quicker"]

FAMILIES = {
    "and2": lambda qt, i: f"{qt[2 * i]} {qt[2 * i + 1]}",
    "and2_tag": lambda qt, i: (f"{qt[2 * i]} {qt[2 * i + 1]} "
                               f"@cat:{{cat{i % 16:02d}}}"),
    "and3": lambda qt, i: f"{qt[3 * i]} {qt[3 * i + 1]} {qt[3 * i + 2]}",
    "or2": lambda qt, i: f"{qt[2 * i]}|{qt[2 * i + 1]}",
    "not2": lambda qt, i: f"{qt[2 * i]} -{qt[2 * i + 1]}",
    "opt2": lambda qt, i: f"{qt[2 * i]} ~{qt[2 * i + 1]}",
    "fields2": lambda qt, i: f"@title:{qt[2 * i]} @body:{qt[2 * i + 1]}",
}


def _pair(fields_fn, docs):
    jix = rs.SearchIndex(rs.Schema(name="s", fields=fields_fn(rs)))
    tix = rt.SearchIndex(rt.Schema(name="s", fields=fields_fn(rt)),
                         device="cpu")
    for ix in (jix, tix):
        for key, f in docs:
            ix.add_document(key, dict(f))
        ix.commit()
    return jix, tix


@pytest.fixture(scope="module")
def plain_idx():
    rng = np.random.default_rng(17)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "omega"]
    docs = [(f"d{i}", {"a": " ".join(rng.choice(words, 4)),
                       "b": " ".join(rng.choice(words, 7))})
            for i in range(800)]
    return _pair(lambda p: [p.Field("a", p.FieldType.TEXT, weight=2.0),
                            p.Field("b", p.FieldType.TEXT)], docs)


@pytest.fixture(scope="module")
def tag_idx():
    rng = np.random.default_rng(23)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "omega"]
    docs = [(f"d{i}", {"a": " ".join(rng.choice(words, 6)),
                       "color": "rgb"[i % 3],
                       "labels": ",".join({"xy"[i % 2],
                                           "yz"[(i * 3 + 1) % 2]})})
            for i in range(1500)]
    return _pair(lambda p: [p.Field("a", p.FieldType.TEXT),
                            p.Field("color", p.FieldType.TAG),
                            p.Field("labels", p.FieldType.TAG)], docs)


@pytest.fixture(scope="module")
def stem_idx():
    rng = np.random.default_rng(23)
    vocab = ["running", "runs", "jumped", "jumping", "quickly",
             "quicker", "walker", "walking", "talked", "talking"]
    docs = [(f"d{i}", {"t": " ".join(rng.choice(vocab, 5))})
            for i in range(600)]
    return _pair(lambda p: [p.Field("t", p.FieldType.TEXT)], docs)


def _bench_fields(p):
    F, T = p.Field, p.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True)]


@pytest.fixture(scope="module")
def bench_idx():
    """bench.py's corpus shape (4 title + 20 body zipf(1.25) tokens, 16
    cats, 1000 groups, prices) at 2k docs; a 2,000-word vocab and query
    terms among the 30 most frequent words keep the intersections
    non-empty at this size."""
    rng = np.random.default_rng(0)
    vocab = 2000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(2000, 24)) - 1, 0, vocab - 1)
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "cat": "cat%02d" % (i % 16),
                       "grp": "g%04d" % (i % 1000),
                       "price": float(rng.integers(1, 10_000))})
            for i in range(2000)]
    qt = ["w%06d" % i for i in rng.integers(0, 30, size=64)]
    jix = rs.SearchIndex(rs.Schema(name="bm25", fields=_bench_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="bm25", fields=_bench_fields(rt)),
                         device="cpu")
    jix.add_documents(docs)
    tix.add_documents(docs)
    return jix, tix, qt


def _opts(pkg, n, **kw):
    return [pkg.QueryOptions(k=10, now=NOW, **kw) for _ in range(n)]


def _compare(jix, tix, queries, **kw):
    jres = jix.search_many(queries, k=10,
                           opts_list=_opts(rs, len(queries), **kw))
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many(queries, k=10,
                           opts_list=_opts(rt, len(queries), **kw))
    assert TE.QUERY_PATH_STATS == {"kernel": len(queries)}
    for q, j, t in zip(queries, jres, tres):
        assert t.total == j.total, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL,
                                   err_msg=q)
    return jres


def test_queries_match_jax(plain_idx):
    res = _compare(*plain_idx, QUERIES * 2, verbatim=True)
    assert all(r.total > 0 for r in res)


def test_queries_default_pipeline_match_jax(plain_idx):
    _compare(*plain_idx, QUERIES)


def test_tag_queries_match_jax(tag_idx):
    res = _compare(*tag_idx, TAG_QUERIES, verbatim=True)
    assert sum(r.total > 0 for r in res) == len(TAG_QUERIES) - 1


def test_stem_queries_match_jax(stem_idx):
    _compare(*stem_idx, STEM_QUERIES * 2)


def test_bench_families_match_jax(bench_idx):
    jix, tix, qt = bench_idx
    queries = [fn(qt, i) for fn in FAMILIES.values() for i in range(6)]
    res = _compare(jix, tix, queries)
    for f, fam in enumerate(FAMILIES):
        assert any(r.total > 0 for r in res[6 * f:6 * f + 6]), fam


@pytest.mark.parametrize("which", ["plain", "tag", "stem"])
def test_transport_rows_and_plans_match_jax(which, plain_idx, tag_idx,
                                            stem_idx):
    """bind_row rows, layouts, buckets and kernel plans are identical in
    both packages: the planner copy has not drifted."""
    (jix, tix), queries, kw = {
        "plain": (plain_idx, QUERIES, {"verbatim": True}),
        "tag": (tag_idx, TAG_QUERIES, {"verbatim": True}),
        "stem": (stem_idx, STEM_QUERIES, {}),
    }[which]
    jseg, tseg = jix.segments[0], tix.segments[0]
    for q in queries:
        jcq = jix.prepare(q, None, rs.QueryOptions(k=10, now=NOW, **kw), 2)
        tcq = tix.prepare(q, None, rt.QueryOptions(k=10, now=NOW, **kw), 2)
        jrow, jent = jcq.bind_row(jseg)
        trow, tent = tcq.bind_row(tseg)
        assert jrow.dtype == trow.dtype == np.int32
        assert jrow.tobytes() == trow.tobytes(), q
        assert jent[2] == tent[2] and jent[4] == tent[4], q   # layout, bk
        assert jent[6] == tent[6] and jent[7] == tent[7], q   # group key
        jplan = JE._kernel_plan(jcq, jseg, jent[4], 16)
        tplan = TE._kernel_plan(tcq, tseg, tent[4], 16)
        assert tplan is not None and tplan == jplan, q


@pytest.mark.parametrize("query,item", [
    # a phrase of 5 terms: past the phrase kernel's 2-4
    ('"w000001 w000002 w000003 w000004 w000005"', "window"),
    ("@price:[1 5000]", "window"),            # numeric leaf
    ("w000001 @price:[1 5000]", "window"),    # numeric inside an AND
])
def test_queries_outside_the_kernel_raise(bench_idx, query, item):
    """Queries outside the kernels' shapes no longer raise: their groups
    run on the general window program and serve what the JAX package
    serves."""
    jix, tix, _qt = bench_idx
    TE.QUERY_PATH_STATS.clear()
    t = tix.search_many([query], k=10, opts_list=_opts(rt, 1))[0]
    assert TE.QUERY_PATH_STATS == {item: 1}
    j = jix.search_many([query], k=10, opts_list=_opts(rs, 1))[0]
    assert t.total == j.total, query
    assert [h.key for h in t.hits] == [h.key for h in j.hits], query
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=RTOL)


def test_single_query_search_is_not_ported(plain_idx):
    """Single-query search() rides the general window program and serves
    what the JAX package's serves."""
    jix, tix = plain_idx
    for q in ("alpha beta", "alpha | beta", "omega -alpha"):
        j, t = jix.search(q), tix.search(q)
        assert t.total == j.total > 0, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL)


def test_client_front_door(bench_idx):
    """Client.ft_create + hset + ft_search_many serve the same hits as
    the JAX Client on the same documents."""
    jix, _tix, qt = bench_idx
    jc, tc = rs.Client(), rt.Client(device="cpu")
    docs = [(jix.doctable.get(g).key, jix.doctable.get(g).fields)
            for g in range(1, 1201)]
    for c, pkg in ((jc, rs), (tc, rt)):
        c.ft_create("bm25", _bench_fields(pkg))
        for key, f in docs:
            c.hset(key, f)
    queries = [FAMILIES["and2"](qt, i) for i in range(4)] + [
        FAMILIES["or2"](qt, i) for i in range(4)]
    jres = jc.ft_search_many("bm25", queries, k=10)
    tres = tc.ft_search_many("bm25", queries, k=10)
    for q, j, t in zip(queries, jres, tres):
        assert t.total == j.total and t.total > 0, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL)
