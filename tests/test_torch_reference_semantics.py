"""End-to-end behavior parity battery.

Each test pins a behavior documented in the reference (file:line cites)
with expectations computed by hand — not by replaying engine code — so
regressions in query semantics surface as failures here even when the
plumbing tests stay green.

Parity file of tests/test_reference_semantics.py (tests/torch_parity.py): each case runs
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


@pytest.fixture()
def c():
    return per_side(lambda: _c_make())


def _c_make():
    return rs.Client()


def _keys(res):
    return [h.key for h in res.hits]


# ---------------------------------------------------------------------------
# Phrase slop / inorder (reference: intersection iterator slop checks,
# src/redisearch_rs/rqe_iterators intersection.rs:22-50)
# ---------------------------------------------------------------------------

@pytest.fixture()
def phrase_ix(c):
    return per_side(lambda: _phrase_ix_make(c))


def _phrase_ix_make(c):
    c.ft_create("ph", [Field("t", FieldType.TEXT)])
    c.hset("adj", {"t": "alpha bravo charlie"})        # a,b adjacent
    c.hset("gap1", {"t": "alpha xx bravo charlie"})    # one token between
    c.hset("gap2", {"t": "alpha xx yy bravo"})         # two tokens between
    c.hset("rev", {"t": "bravo alpha charlie"})        # reversed, adjacent
    c.hset("far", {"t": "alpha xx yy zz qq ww bravo"})
    return c


@parity
def test_exact_phrase_matches_adjacent_only(phrase_ix):
    res = phrase_ix.ft_search("ph", '"alpha bravo"', num=10)
    assert set(_keys(res)) == {"adj"}
    # reference: an exact (quoted) phrase forces slop=0 + in-order even
    # when a global SLOP is given (query_eval/src/nodes/phrase.rs:54-56)
    res = phrase_ix.ft_search("ph", '"alpha bravo"', slop=2, num=10)
    assert set(_keys(res)) == {"adj"}


@parity
def test_slop_allows_bounded_gaps(phrase_ix):
    # global SLOP turns an unquoted term intersection into a proximity
    # match (reference: RSSearchOptions slop -> intersection max_slop)
    res = phrase_ix.ft_search("ph", "alpha bravo", slop=1,
                              inorder=True, num=10)
    assert set(_keys(res)) == {"adj", "gap1"}
    res = phrase_ix.ft_search("ph", "alpha bravo", slop=2,
                              inorder=True, num=10)
    assert set(_keys(res)) == {"adj", "gap1", "gap2"}


@parity
def test_slop_without_inorder_accepts_reversed(phrase_ix):
    # unordered slop: span = max-min-(n-1) <= slop in any order
    # (proximity.rs within_range_unordered), so even slop=0 accepts
    # reversed-adjacent terms; INORDER forbids them
    res = phrase_ix.ft_search("ph", "alpha bravo", slop=0, num=10)
    assert set(_keys(res)) == {"adj", "rev"}
    res = phrase_ix.ft_search("ph", "alpha bravo", slop=1, num=10)
    assert set(_keys(res)) == {"adj", "gap1", "rev"}
    res_in = phrase_ix.ft_search("ph", "alpha bravo", slop=1,
                                 inorder=True, num=10)
    assert set(_keys(res_in)) == {"adj", "gap1"}


@parity
def test_phrase_multi_match_doc_returned_once(c):
    # The intersection iterator yields ONE IndexResult per doc id no
    # matter how many phrase occurrences the doc has.  Regression: with
    # pivot positions [t-match, b-fail, b-match] the failed candidate
    # split the duplicate across non-adjacent lanes and the doc came
    # back twice (dedup_adjacent compared neighbors, not previous valid).
    c.ft_create("pd", [Field("t", FieldType.TEXT),
                       Field("b", FieldType.TEXT)])
    c.hset("d1", {"t": "apple banana", "b": "apple apple banana"})
    c.hset("d2", {"t": "zz", "b": "yy"})
    res = c.ft_search("pd", '"apple banana"', num=10)
    assert _keys(res) == ["d1"]
    assert res.total == 1


@parity
def test_slop_span_is_cumulative_across_terms(c):
    # reference within_range_in_order sums gaps across ALL terms: three
    # terms with two 1-token gaps need slop >= 2, not slop >= 1
    c.ft_create("ph3", [Field("t", FieldType.TEXT)])
    c.hset("dense", {"t": "one two three"})
    c.hset("spread", {"t": "one xx two yy three"})
    res = c.ft_search("ph3", "one two three", slop=1, inorder=True,
                      num=10)
    assert set(_keys(res)) == {"dense"}
    res = c.ft_search("ph3", "one two three", slop=2, inorder=True,
                      num=10)
    assert set(_keys(res)) == {"dense", "spread"}


# ---------------------------------------------------------------------------
# Field weights (reference: FieldSpec TEXT weight, scored via fieldmask,
# ext/default.c BM25)
# ---------------------------------------------------------------------------

@parity
def test_title_weight_outranks_body(c):
    c.ft_create("w", [Field("title", FieldType.TEXT, weight=5.0),
                      Field("body", FieldType.TEXT)])
    c.hset("in_body", {"title": "meh", "body": "needle plus filler words"})
    c.hset("in_title", {"title": "needle", "body": "other filler words"})
    res = c.ft_search("w", "needle", num=10)
    assert _keys(res)[0] == "in_title"
    assert set(_keys(res)) == {"in_title", "in_body"}


# ---------------------------------------------------------------------------
# NOT / optional semantics (reference: not.rs, optional = score boost,
# query_parser v2)
# ---------------------------------------------------------------------------

@parity
def test_not_excludes_and_optional_boosts(c):
    c.ft_create("no", [Field("t", FieldType.TEXT)])
    c.hset("both", {"t": "apple banana"})
    c.hset("only_a", {"t": "apple cherry"})
    c.hset("only_b", {"t": "banana cherry"})
    res = c.ft_search("no", "apple -banana", num=10)
    assert set(_keys(res)) == {"only_a"}
    # optional: does not filter, but ranks docs containing it higher
    res = c.ft_search("no", "apple ~banana", num=10)
    assert set(_keys(res)) == {"both", "only_a"}
    assert _keys(res)[0] == "both"


# ---------------------------------------------------------------------------
# Tag field options (reference: tag_index.c separator/case handling)
# ---------------------------------------------------------------------------

@parity
def test_tag_separator_and_default_case_folding(c):
    c.ft_create("tg", [Field("t", FieldType.TAG, separator=";")])
    c.hset("d1", {"t": "New York;LA"})
    c.hset("d2", {"t": "new york"})
    res = c.ft_search("tg", "@t:{new york}", num=10)
    assert set(_keys(res)) == {"d1", "d2"}     # default: case-insensitive
    res = c.ft_search("tg", "@t:{la}", num=10)
    assert set(_keys(res)) == {"d1"}


@parity
def test_tag_casesensitive(c):
    c.ft_create("tgc", [Field("t", FieldType.TAG, casesensitive=True)])
    c.hset("d1", {"t": "Apple"})
    c.hset("d2", {"t": "apple"})
    assert _keys(c.ft_search("tgc", "@t:{Apple}", num=10)) == ["d1"]
    assert _keys(c.ft_search("tgc", "@t:{apple}", num=10)) == ["d2"]


@parity
def test_tag_prefix(c):
    c.ft_create("tgp", [Field("t", FieldType.TAG)])
    c.hset("d1", {"t": "electronics"})
    c.hset("d2", {"t": "elections"})
    c.hset("d3", {"t": "food"})
    res = c.ft_search("tgp", "@t:{ele*}", num=10)
    assert set(_keys(res)) == {"d1", "d2"}


# ---------------------------------------------------------------------------
# Stopwords (reference: stopwords.c default list; stopword-only query
# matches nothing; stopwords inside phrases are skipped)
# ---------------------------------------------------------------------------

@parity
def test_stopword_only_query_returns_empty(c):
    c.ft_create("sw", [Field("t", FieldType.TEXT)])
    c.hset("d1", {"t": "the quick brown fox"})
    res = c.ft_search("sw", "the", num=10)
    assert res.total == 0
    res = c.ft_search("sw", "quick", num=10)
    assert _keys(res) == ["d1"]


# ---------------------------------------------------------------------------
# PARAMS substitution everywhere (reference: param.c / dialect 2)
# ---------------------------------------------------------------------------

@parity
def test_params_in_numeric_and_tag(c):
    c.ft_create("pp", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC),
                       Field("g", FieldType.TAG)])
    for i in range(20):
        c.hset(f"d{i}", {"t": "row", "n": i, "g": "even" if i % 2 == 0
                         else "odd"})
    res = c.ft_search("pp", "@n:[$lo $hi]",
                      params={"lo": 5, "hi": 8}, num=20)
    assert sorted(_keys(res)) == [f"d{i}" for i in range(5, 9)]
    res = c.ft_search("pp", "@g:{$v}", params={"v": "odd"}, num=20)
    assert len(res.hits) == 10


# ---------------------------------------------------------------------------
# LIMIT 0 0: count only (reference: aggregate_exec sendChunk honors
# num=0 returning just the total)
# ---------------------------------------------------------------------------

@parity
def test_limit_zero_returns_count_only(c):
    c.ft_create("lz", [Field("t", FieldType.TEXT)])
    for i in range(7):
        c.hset(f"d{i}", {"t": "common term"})
    res = c.ft_search("lz", "common", offset=0, num=0)
    assert res.total == 7 and res.hits == []


# ---------------------------------------------------------------------------
# SORTBY paging + direction (reference: sorter RP + pager)
# ---------------------------------------------------------------------------

@parity
def test_sortby_direction_and_paging(c):
    c.ft_create("so", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC, sortable=True)])
    for i in range(10):
        c.hset(f"d{i}", {"t": "x", "n": i})
    asc = c.ft_search("so", "x", sort_by="n", sort_asc=True, num=3)
    assert _keys(asc) == ["d0", "d1", "d2"]
    desc = c.ft_search("so", "x", sort_by="n", sort_asc=False, num=3)
    assert _keys(desc) == ["d9", "d8", "d7"]
    page2 = c.ft_search("so", "x", sort_by="n", sort_asc=True,
                        offset=3, num=3)
    assert _keys(page2) == ["d3", "d4", "d5"]


@parity
def test_sortby_missing_values_rank_last(c):
    # reference: value/src/comparison.rs cmp_fields — a missing sort key
    # ranks "worst" (last) regardless of ASC/DESC; the doc still matches
    c.ft_create("sn", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC, sortable=True),
                       Field("s", FieldType.TEXT, sortable=True)])
    c.hset("a", {"t": "x", "n": 5, "s": "bb"})
    c.hset("b", {"t": "x"})
    c.hset("cc", {"t": "x", "n": 1, "s": "aa"})
    for fld, asc, want in [("n", True, ["cc", "a", "b"]),
                           ("n", False, ["a", "cc", "b"]),
                           ("s", True, ["cc", "a", "b"]),
                           ("s", False, ["a", "cc", "b"])]:
        got = _keys(c.ft_search("sn", "x", sort_by=fld, sort_asc=asc,
                                num=10))
        assert got == want, (fld, asc, got)
    # aggregation SORTBY: same rule
    for asc in (rs.ASC, rs.DESC):
        req = (rs.AggregateRequest("x").load("@n").sort_by(("@n", asc)))
        rows = c.ft_aggregate("sn", req).rows
        assert rows[-1].get("n") in (None, "", "None"), rows


# ---------------------------------------------------------------------------
# Numeric operators / geo units / fuzzy distance / wildcard (regression
# pins for verified-correct behaviors)
# ---------------------------------------------------------------------------

@parity
def test_numeric_operator_forms(c):
    c.ft_create("nf", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC)])
    for i in range(10):
        c.hset(f"d{i}", {"t": "x", "n": i})
    cases = {"@n:[3 5]": [3, 4, 5], "@n:[(3 5]": [4, 5],
             "@n:[3 (5]": [3, 4], "@n>=7": [7, 8, 9], "@n<2": [0, 1],
             "@n==4": [4], "@n:[-inf 2]": [0, 1, 2],
             "@n:[8 +inf]": [8, 9]}
    for q, want in cases.items():
        got = sorted(int(h.key[1:]) for h in c.ft_search("nf", q,
                                                         num=20).hits)
        assert got == want, (q, got)


@parity
def test_geo_radius_units(c):
    c.ft_create("ge", [Field("t", FieldType.TEXT),
                       Field("g", FieldType.GEO)])
    for i in range(10):
        c.hset(f"d{i}", {"t": "x", "g": f"{2.0 + i * 0.01},48.0"})
    km = {int(h.key[1:]) for h in
          c.ft_search("ge", "@g:[2.0 48.0 2 km]", num=20).hits}
    m = {int(h.key[1:]) for h in
         c.ft_search("ge", "@g:[2.0 48.0 2000 m]", num=20).hits}
    mi = {int(h.key[1:]) for h in
          c.ft_search("ge", "@g:[2.0 48.0 2 mi]", num=20).hits}
    assert km == m == {0, 1, 2}
    assert mi == {0, 1, 2, 3, 4}      # 2 mi = 3.22 km


@parity
def test_fuzzy_edit_distance_levels(c):
    c.ft_create("fz", [Field("t", FieldType.TEXT)])
    c.hset("w0", {"t": "hello"})
    c.hset("w1", {"t": "hallo"})    # distance 1
    c.hset("w2", {"t": "hillol"})   # distance 2
    r1 = set(_keys(c.ft_search("fz", "%hello%", verbatim=True, num=10)))
    r2 = set(_keys(c.ft_search("fz", "%%hello%%", verbatim=True, num=10)))
    assert r1 == {"w0", "w1"}
    assert r2 >= {"w0", "w1", "w2"}


@parity
def test_wildcard_query_forms(c):
    c.ft_create("wc", [Field("t", FieldType.TEXT)])
    for w in ("interest", "interesting", "internal", "testing", "contest"):
        c.hset(w, {"t": w})
    assert set(_keys(c.ft_search("wc", "inter*", verbatim=True, num=10))) \
        == {"interest", "interesting", "internal"}
    assert set(_keys(c.ft_search("wc", "*ing", verbatim=True, num=10))) \
        == {"interesting", "testing"}
    assert set(_keys(c.ft_search("wc", "w'int*l'", verbatim=True,
                                 num=10))) == {"internal"}
    assert set(_keys(c.ft_search("wc", "w'*test*'", verbatim=True,
                                 num=10))) == {"contest", "testing"}


# ---------------------------------------------------------------------------
# Verbatim vs stemming (reference: stemmer expander, VERBATIM flag)
# ---------------------------------------------------------------------------

@parity
def test_verbatim_disables_stemming(c):
    c.ft_create("vb", [Field("t", FieldType.TEXT)])
    c.hset("run", {"t": "running shoes"})
    res = c.ft_search("vb", "run", num=10)
    assert _keys(res) == ["run"]           # stemmer: run ~ running
    res = c.ft_search("vb", "run", verbatim=True, num=10)
    assert res.total == 0                   # exact term only


# ---------------------------------------------------------------------------
# Aggregate: multi-key GROUPBY + statistical reducers vs numpy
# (reference: group_by.c + reducers/)
# ---------------------------------------------------------------------------

@parity
def test_multikey_groupby_stats_match_numpy(c):
    c.ft_create("ag", [Field("t", FieldType.TEXT),
                       Field("a", FieldType.TAG),
                       Field("b", FieldType.TAG),
                       Field("v", FieldType.NUMERIC)])
    rng = np.random.default_rng(7)
    rows = []
    for i in range(300):
        a = ["x", "y"][i % 2]
        b = ["p", "q", "r"][i % 3]
        v = float(rng.integers(0, 100))
        rows.append((a, b, v))
        c.hset(f"d{i}", {"t": "all", "a": a, "b": b, "v": v})
    req = (rs.AggregateRequest("all")
           .group_by(["@a", "@b"],
                     ("COUNT", [], "n"),
                     ("SUM", ["@v"], "s"),
                     ("STDDEV", ["@v"], "sd"),
                     ("QUANTILE", ["@v", "0.5"], "med")))
    out = c.ft_aggregate("ag", req)
    assert len(out.rows) == 6
    for row in out.rows:
        vals = np.array([v for a, b, v in rows
                         if a == row["a"] and b == row["b"]])
        assert int(float(row["n"])) == len(vals)
        assert abs(float(row["s"]) - vals.sum()) < 1e-6
        # reference STDDEV is the sample stddev (reducers/stddev)
        assert abs(float(row["sd"]) - vals.std(ddof=1)) < 1e-3
        med = float(row["med"])
        assert np.quantile(vals, 0.5, method="lower") - 1e-9 <= med \
            <= np.quantile(vals, 0.5, method="higher") + 1e-9


@parity
def test_apply_date_and_geo_functions(c):
    c.ft_create("fn", [Field("t", FieldType.TEXT),
                       Field("ts", FieldType.NUMERIC),
                       Field("loc", FieldType.GEO)])
    # 2021-03-04T05:06:07Z
    c.hset("d1", {"t": "x", "ts": 1614834367, "loc": "2.35,48.86"})
    req = (rs.AggregateRequest("x")
           .load("@ts", "@loc")
           .apply("hour(@ts)", "h")
           .apply("dayofmonth(@ts)", "dom")
           .apply("monthofyear(@ts)", "moy")
           .apply("year(@ts)", "yr")
           .apply("geodistance(@loc, 2.29, 48.85)", "dist"))
    out = c.ft_aggregate("fn", req)
    row = out.rows[0]
    assert int(float(row["yr"])) == 2021
    assert int(float(row["moy"])) == 2      # 0-based month (reference)
    assert int(float(row["dom"])) == 4
    assert int(float(row["h"])) == 5
    # Paris: Notre-Dame to Eiffel ~ 4.1-4.5 km
    assert 3500 <= float(row["dist"]) <= 5500


@parity
def test_filter_expression_and_ordering(c):
    c.ft_create("fl", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC)])
    for i in range(10):
        c.hset(f"d{i}", {"t": "z", "n": i})
    req = (rs.AggregateRequest("z")
           .load("@n")
           .filter("@n >= 3 && @n < 7")
           .sort_by(("@n", rs.DESC)))
    out = c.ft_aggregate("fl", req)
    assert [int(float(r["n"])) for r in out.rows] == [6, 5, 4, 3]


# ---------------------------------------------------------------------------
# ismissing / INDEXEMPTY (reference: spec.c INDEXMISSING/INDEXEMPTY,
# missingFieldDict)
# ---------------------------------------------------------------------------

@parity
def test_ismissing_requires_flag_and_matches(c):
    c.ft_create("mi", [Field("t", FieldType.TEXT),
                       Field("opt", FieldType.TAG, indexmissing=True)])
    c.hset("has", {"t": "x", "opt": "set"})
    c.hset("not1", {"t": "x"})
    c.hset("not2", {"t": "x"})
    res = c.ft_search("mi", "ismissing(@opt)", num=10)
    assert set(_keys(res)) == {"not1", "not2"}


# ---------------------------------------------------------------------------
# EXPLAINSCORE structure (reference: score_explain.c)
# ---------------------------------------------------------------------------

@parity
def test_explainscore_returns_tree(c):
    c.ft_create("ex", [Field("t", FieldType.TEXT)])
    c.hset("d1", {"t": "hello world"})
    out = c.ft_explainscore("ex", "hello world", "d1")
    s = str(out)
    assert "hello" in s.lower() or "weight" in s.lower() or \
        "idf" in s.lower() or "score" in s.lower()


# ---------------------------------------------------------------------------
# Highlight / summarize (reference: highlight_processor.c defaults
# <b>...</b> tags)
# ---------------------------------------------------------------------------

@parity
def test_highlight_wraps_matched_terms(c):
    c.ft_create("hl", [Field("t", FieldType.TEXT)])
    c.hset("d1", {"t": "the quick brown fox jumps"})
    res = c.ft_search("hl", "quick fox",
                      highlight={"fields": ["t"]})
    body = res.hits[0].fields["t"]
    assert "<b>quick</b>" in body and "<b>fox</b>" in body
    assert "<b>brown</b>" not in body


# ---------------------------------------------------------------------------
# Scorer formula exactness (reference: ext/default.c CalculateBM25Std,
# k1=1.2 b=0.75; idf crate ln(1+(N-n+0.5)/(n+0.5)); BM25StdTanhScorer
# tanh(score / BM25STD_TANH_FACTOR), default factor 4)
# ---------------------------------------------------------------------------

@parity
def test_bm25std_matches_reference_formula(c):
    import math
    c.ft_create("bm", [Field("t", FieldType.TEXT)])
    # 4 docs; "hello" in 2; doc lens 2,3,4,5 -> avgdl known
    c.hset("a", {"t": "hello world"})                  # dl 2, tf 1
    c.hset("b", {"t": "hello hello there"})            # dl 3, tf 2
    c.hset("cc", {"t": "one two three four"})          # dl 4
    c.hset("d", {"t": "five six seven eight nine"})    # dl 5
    res = c.ft_search("bm", "hello", num=10, verbatim=True)
    got = {h.key: h.score for h in res.hits}
    N, n = 4, 2
    idf = math.log(1 + (N - n + 0.5) / (n + 0.5))
    avgdl = (2 + 3 + 4 + 5) / 4
    k1, b = 1.2, 0.75

    def bm25(tf, dl):
        return idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))

    assert got["a"] == pytest.approx(bm25(1, 2), rel=1e-5)
    assert got["b"] == pytest.approx(bm25(2, 3), rel=1e-5)
    # TANH variant: tanh(score / 4) with the reference's default factor
    res = c.ft_search("bm", "hello", num=10, verbatim=True,
                      scorer="BM25STD.TANH")
    gt = {h.key: h.score for h in res.hits}
    assert gt["a"] == pytest.approx(math.tanh(bm25(1, 2) / 4), rel=1e-5)
    assert gt["b"] == pytest.approx(math.tanh(bm25(2, 3) / 4), rel=1e-5)


@parity
def test_tfidf_matches_reference_formula(c):
    # reference: tfIdfInternal (ext/default.c:109) — score = doc_score *
    # sum(weight * tf * idf) / maxTermFreq, idf = logb(1 + (N+1)/df)
    # (idf/src/lib.rs calculate_idf: the BINARY EXPONENT step function)
    import math
    c.ft_create("tf", [Field("t", FieldType.TEXT)])
    c.hset("a", {"t": "apple apple pie"})     # tf(apple)=2, maxfreq 2
    c.hset("b", {"t": "apple tart"})          # tf 1, maxfreq 1
    c.hset("cc", {"t": "cherry pie crumble"})
    res = c.ft_search("tf", "apple", num=10, verbatim=True,
                      scorer="TFIDF")
    got = {h.key: h.score for h in res.hits}
    N, df = 3, 2
    idf = float(math.floor(math.log2(1 + (N + 1) / df)))   # logb(3)=1
    assert got["a"] == pytest.approx(2 * idf / 2, rel=1e-5)
    assert got["b"] == pytest.approx(1 * idf / 1, rel=1e-5)


@parity
def test_dismax_matches_reference_formula(c):
    # reference dismaxRecursive: term = weight * freq; intersections
    # sum, unions take the max; no idf / normalization / doc score
    c.ft_create("dm", [Field("t", FieldType.TEXT)], score_field="__score")
    c.hset("a", {"t": "red red blue", "__score": 0.2})   # tf r=2, b=1
    c.hset("b", {"t": "red green", "__score": 1.0})      # tf r=1, g=1
    res = c.ft_search("dm", "red blue", num=10, verbatim=True,
                      scorer="DISMAX")
    got = {h.key: h.score for h in res.hits}
    assert got == {"a": pytest.approx(3.0)}   # 2 + 1; doc score ignored
    res = c.ft_search("dm", "red|green", num=10, verbatim=True,
                      scorer="DISMAX")
    got = {h.key: h.score for h in res.hits}
    assert got["a"] == pytest.approx(2.0)     # max(2, 0)
    assert got["b"] == pytest.approx(1.0)     # max(1, 1)


# ---------------------------------------------------------------------------
# Synonyms / phonetics expansion (reference: synonym_map.c,
# phonetic_manager.c; expanders registered at ext/default.c:788-806)
# ---------------------------------------------------------------------------

@parity
def test_synonym_group_expansion(c):
    c.ft_create("sy", [Field("t", FieldType.TEXT)])
    c.ft_synupdate("sy", "g1", ["car", "automobile", "vehicle"])
    c.hset("d1", {"t": "my automobile is fast"})
    c.hset("d2", {"t": "my boat is fast"})
    assert _keys(c.ft_search("sy", "car", num=10)) == ["d1"]
    dump = c.ft_syndump("sy")
    assert dump == {"car": ["g1"], "automobile": ["g1"],
                    "vehicle": ["g1"]}


@parity
def test_phonetic_field_matches_homophones(c):
    c.ft_create("pho", [Field("t", FieldType.TEXT, phonetic="dm:en")])
    c.hset("p1", {"t": "smith"})
    c.hset("p2", {"t": "jones"})
    assert _keys(c.ft_search("pho", "smyth", num=10)) == ["p1"]


@parity
def test_exists_function_and_profile_shape(c):
    c.ft_create("mt", [Field("t", FieldType.TEXT),
                       Field("opt", FieldType.NUMERIC)])
    c.hset("m1", {"t": "hello world", "opt": 3})
    c.hset("m2", {"t": "hello there"})
    req = (rs.AggregateRequest("hello").load("@opt")
           .apply("exists(@opt)", "has"))
    rows = {r["__key"]: float(r["has"]) for r in
            c.ft_aggregate("mt", req).rows}
    assert rows == {"m1": 1.0, "m2": 0.0}
    res, prof = c.ft_profile("mt", "SEARCH", "hello world")
    for key in ("parsing_time_ms", "execution_time_ms", "query_tree",
                "results_count", "iterators"):
        assert key in prof, prof.keys()


# ---------------------------------------------------------------------------
# Multi-field modifier @a|b: (dialect 2, parser.y field list)
# ---------------------------------------------------------------------------

@parity
def test_inkeys_and_infields(c):
    # reference: FT.SEARCH INKEYS (id-list intersection) and INFIELDS
    # (default field mask for unscoped terms; explicit @field wins)
    c.ft_create("ik", [Field("a", FieldType.TEXT),
                       Field("b", FieldType.TEXT)])
    c.hset("d1", {"a": "needle here", "b": "x"})
    c.hset("d2", {"a": "x", "b": "needle there"})
    c.hset("d3", {"a": "needle again", "b": "x"})
    r = c.ft_search("ik", "needle", in_keys=["d1", "d2", "nope"], num=10)
    assert sorted(_keys(r)) == ["d1", "d2"] and r.total == 2
    r = c.ft_search("ik", "needle", in_fields=["a"], num=10)
    assert sorted(_keys(r)) == ["d1", "d3"]
    r = c.ft_search("ik", "@b:needle", in_fields=["a"], num=10)
    assert sorted(_keys(r)) == ["d2"]
    r = c.ft_search("ik", "needle", in_keys=["d3"], in_fields=["a"],
                    num=10)
    assert _keys(r) == ["d3"]


@parity
def test_cursor_pages_every_row_exactly_once(c):
    # reference: FT.AGGREGATE WITHCURSOR + FT.CURSOR READ (cursor.c)
    c.ft_create("cu", [Field("t", FieldType.TEXT),
                       Field("n", FieldType.NUMERIC)])
    for i in range(57):
        c.hset(f"d{i}", {"t": "x", "n": i})
    req = (rs.AggregateRequest("x").load("@n")
           .sort_by(("@n", rs.ASC)).cursor(10))
    res = c.ft_aggregate("cu", req)
    rows, cid, reads = list(res.rows), res.cursor_id, 0
    while cid:
        nrows, cid = c.ft_cursor_read("cu", cid)
        rows += nrows
        reads += 1
        assert reads < 20
    vals = [int(float(r["n"])) for r in rows]
    assert vals == sorted(vals) and len(set(vals)) == 57


@parity
def test_checkpoint_roundtrip_preserves_search_and_stats(c):
    import tempfile

    import numpy as np

    VectorMetric = rs.VectorMetric
    VectorParams = rs.VectorParams
    ckpt = rs.aux.checkpoint
    c.ft_create("cp", [Field("t", FieldType.TEXT),
                       Field("g", FieldType.TAG),
                       Field("n", FieldType.NUMERIC, sortable=True),
                       Field("v", FieldType.VECTOR,
                             vector=VectorParams(dim=4,
                                                 metric=VectorMetric.L2))])
    rng = np.random.default_rng(0)
    for i in range(30):
        c.hset(f"k{i}", {"t": f"word{i % 5} common", "g": "ab"[i % 2],
                         "n": i,
                         "v": rng.standard_normal(4,
                                                  dtype=np.float32)
                         .tobytes()})
    ix = c._index("cp")
    d = tempfile.mkdtemp()
    ckpt.save(ix, d)
    ix2 = ckpt.load(d)
    q = "common @g:{a} @n:[5 25]"
    assert ([h.key for h in ix.search(q, num=50).hits]
            == [h.key for h in ix2.search(q, num=50).hits])
    b = rng.standard_normal(4, dtype=np.float32).tobytes()
    k1 = [h.key for h in ix.search("*=>[KNN 5 @v $b]", params={"b": b},
                                   num=5).hits]
    k2 = [h.key for h in ix2.search("*=>[KNN 5 @v $b]", params={"b": b},
                                    num=5).hits]
    assert k1 == k2
    # BM25 avgdl statistics must survive the roundtrip
    assert ix.doctable.avg_doclen == ix2.doctable.avg_doclen != 0


@parity
def test_multi_field_modifier(c):
    c.ft_create("mf", [Field("a", FieldType.TEXT),
                       Field("b", FieldType.TEXT),
                       Field("cf", FieldType.TEXT)])
    c.hset("in_a", {"a": "needle", "b": "x", "cf": "x"})
    c.hset("in_b", {"a": "x", "b": "needle", "cf": "x"})
    c.hset("in_c", {"a": "x", "b": "x", "cf": "needle"})
    res = c.ft_search("mf", "@a|b:(needle)", num=10)
    assert set(_keys(res)) == {"in_a", "in_b"}


# ---------------------------------------------------------------------------
# Stemming parity (reference: Snowball english/Porter2, stemmer.c:70;
# StemmerExpander bare-stem expansion, ext/default.c:617-619)
# ---------------------------------------------------------------------------


@parity
def test_english_stems_are_porter2():
    Stemmer = rs.analysis.stemmer.Stemmer
    st = Stemmer("english")
    # Porter2-vs-Porter1 divergers (Porter-1980 gives gener/-ology etc.)
    assert st.stem("generously") == "generous"
    assert st.stem("running") == "run"
    assert st.stem("dying") == "die"
    assert st.stem("happiness") == "happi"


@parity
def test_query_matches_bare_stem_docs():

    ix = rs.SearchIndex(rs.Schema(name="stq", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("a", {"t": "run fast"})
    ix.add_document("b", {"t": "running fast"})
    ix.commit()
    # "running" expands to (running | +run | run): both docs match
    assert sorted(h.key for h in ix.search("running")) == ["a", "b"]
    assert sorted(h.key for h in ix.search("run")) == ["a", "b"]


@parity
def test_snowball_languages_match_nltk():
    from nltk.stem.snowball import SnowballStemmer
    Stemmer = rs.analysis.stemmer.Stemmer
    cases = {
        "french": ["nationalement", "mangeront", "heureuses"],
        "german": ["aufeinander", "verständnis", "kindern"],
        "spanish": ["corriendo", "nacionales", "felicidad"],
        "russian": ["выражение", "книгами", "бегущий"],
    }
    for lang, words in cases.items():
        ours = Stemmer(lang)
        ref = SnowballStemmer(lang)
        for w in words:
            got = ours.stem(w) or w
            assert got == ref.stem(w), (lang, w)


@parity
def test_bulk_index_stems_match_incremental():
    """Native bulk path (stem post-merge) must produce the same stem
    postings as the incremental Python builder."""
    import numpy as np


    docs = [(f"d{i}", {"t": t}) for i, t in enumerate([
        "running runs ran runner",
        "generously generous generosity",
        "the quick brown foxes jumped",
        "dying dies died",
        "run walk fly",
    ])]
    sch = lambda nm: rs.Schema(name=nm, fields=[
        rs.Field("t", rs.FieldType.TEXT)])
    bulk = rs.SearchIndex(sch("blk"))
    bulk.add_documents(docs)          # native path
    inc = rs.SearchIndex(sch("inc"))
    for k, f in docs:
        inc.add_document(k, f)
    inc.commit()

    sb, si = bulk.segments[0], inc.segments[0]
    assert sorted(sb.terms.ids) == sorted(si.terms.ids)
    for t in si.terms.ids:
        ib, ii = sb.terms.lookup(t), si.terms.lookup(t)
        ob = np.asarray(sb.text.term_offsets_np)
        oi = np.asarray(si.text.term_offsets_np)
        db = np.asarray(sb.text.doc_ids[ob[ib]:ob[ib + 1]])
        di = np.asarray(si.text.doc_ids[oi[ii]:oi[ii + 1]])
        assert list(db) == list(di), t
        fb = np.asarray(sb.text.freqs[ob[ib]:ob[ib + 1]])
        fi = np.asarray(si.text.freqs[oi[ii]:oi[ii + 1]])
        assert list(fb) == list(fi), t
        pb = np.asarray(sb.text.pos_offsets_np)
        pi = np.asarray(si.text.pos_offsets_np)
        for j in range(len(db)):
            kb = np.asarray(sb.text.poskeys[pb[ob[ib] + j]:
                                            pb[ob[ib] + j + 1]])
            ki = np.asarray(si.text.poskeys[pi[oi[ii] + j]:
                                            pi[oi[ii] + j + 1]])
            assert list(kb % sb.text.pos_stride) == \
                list(ki % si.text.pos_stride), t
    assert np.allclose(np.asarray(sb.max_freq)[:5],
                       np.asarray(si.max_freq)[:5])


@parity
def test_quote_styles_verbatim(c):
    """Single and double quotes are identical verbatim terms in dialect 2:
    content is tokenized (a trailing `*` never becomes a wildcard) and
    expansion is skipped; escaped punctuation stays IN the term
    (reference: tests/pytests/test_quotes.py)."""

    c.ft_create("qt", [rs.Field("t1", rs.FieldType.TEXT, nostem=True),
                       rs.Field("t2", rs.FieldType.TAG)])
    c.hset("h1", {"t1": "James Brown", "t2": "NYC"})
    c.hset("h2", {"t1": "James Lore", "t2": "MIA"})
    c.hset("h3", {"t1": "James\\!\\* Exclaim", "t2": "PHX"})
    both = {"h1", "h2"}
    for q in ("@t1:'James*'", '@t1:"James*"', "@t1:'James'",
              '@t1:"James"', "@t1:(James)"):
        assert set(_keys(c.ft_search("qt", q, no_content=True))) == both, q
    # parenthesized wildcard DOES expand
    assert set(_keys(c.ft_search("qt", "@t1:(James*)",
                                 no_content=True))) == {"h1", "h2", "h3"}
    # escaped punctuation inside quotes stays in the term
    for q in ('@t1:("James\\!\\*")', "@t1:('James\\!\\*')"):
        assert set(_keys(c.ft_search("qt", q, no_content=True))) == {"h3"}, q
    # quoted tag values
    for q in ('@t2:{"NYC"}', "@t2:{'NYC'}", "@t2:{NYC}"):
        assert set(_keys(c.ft_search("qt", q, no_content=True))) == {"h1"}, q
