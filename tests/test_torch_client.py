"""Client command-surface tests (reference: tests/pytests command flows).

Parity file of tests/test_client.py (tests/torch_parity.py): each case runs
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
def client():
    return per_side(lambda: _client_make())


def _client_make():
    c = rs.Client()
    c.ft_create("books", [
        rs.Field("title", rs.FieldType.TEXT, weight=2.0),
        rs.Field("summary", rs.FieldType.TEXT),
        rs.Field("genre", rs.FieldType.TAG, sortable=True),
        rs.Field("year", rs.FieldType.NUMERIC, sortable=True),
    ], prefixes=("book:",))
    c.hset("book:1", {"title": "dune", "summary":
                      "a desert planet with giant sandworms and spice",
                      "genre": "scifi", "year": 1965})
    c.hset("book:2", {"title": "neuromancer", "summary":
                      "a hacker navigates cyberspace and ai constructs",
                      "genre": "scifi,cyberpunk", "year": 1984})
    c.hset("book:3", {"title": "emma", "summary":
                      "a young woman meddles in the romances of her friends",
                      "genre": "romance", "year": 1815})
    c.hset("note:1", {"title": "not a book"})  # prefix mismatch
    return c


@parity
def test_prefix_rule(client):
    res = client.ft_search("books", "*")
    assert res.total == 3
    assert all(h.key.startswith("book:") for h in res)


@parity
def test_keyspace_update_and_delete(client):
    client.hset("book:1", {"title": "dune messiah", "genre": "scifi",
                           "year": 1969})
    res = client.ft_search("books", "messiah")
    assert [h.key for h in res] == ["book:1"]
    client.hdel("book:2")
    assert client.ft_search("books", "*").total == 2


@parity
def test_create_scans_existing_keys(client):
    client.ft_create("books2", [rs.Field("title", rs.FieldType.TEXT)],
                     prefixes=("book:",))
    assert client.ft_search("books2", "*").total == 3


@parity
def test_filter_rule():
    c = rs.Client()
    c.ft_create("expensive", [rs.Field("name", rs.FieldType.TEXT),
                              rs.Field("price", rs.FieldType.NUMERIC)],
                filter_expr="@price > 100")
    c.hset("p1", {"name": "cheap thing", "price": 10})
    c.hset("p2", {"name": "pricey thing", "price": 500})
    res = c.ft_search("expensive", "*")
    assert [h.key for h in res] == ["p2"]


@parity
def test_alias(client):
    client.ft_aliasadd("b", "books")
    assert client.ft_search("b", "dune").total == 1
    assert client.ft_aliaslist() == {"b": "books"}
    assert client.ft_aliaslist("books") == {"b": "books"}
    client.ft_aliasdel("b")
    assert client.ft_aliaslist() == {}
    with pytest.raises(resolve(rs.errors.IndexNotFound)):
        client.ft_search("b", "dune")


@parity
def test_per_query_nostopwords_and_expander(client):
    client.ft_create("nsw", fields=[rs.Field("t", rs.FieldType.TEXT)])
    client.hset("n1", {"t": "the walrus sings"})
    client.hset("n2", {"t": "walrus sings"})
    # "the" is a default stopword: dropped from the query normally...
    assert client.ft_search("nsw", "the walrus", verbatim=True).total == 2
    # ...but kept as a required term with NOSTOPWORDS — and since index-
    # side tokenization also drops stopwords, the term has no postings
    # and the intersection is empty (reference: RSSearchOptions flag
    # parsed by aggregate_request.c; indexing skips stopwords too)
    res = client.ft_search("nsw", "the walrus", verbatim=True,
                           nostopwords=True)
    assert res.total == 0
    # per-query EXPANDER selects a registered expander (ext registry)
    ext = rs.ext
    ext.register_expander("SYNO42", lambda t: ["walrus"]
                          if t == "seacow" else [])
    try:
        assert client.ft_search("nsw", "seacow").total == 0
        assert client.ft_search("nsw", "seacow",
                                expander="SYNO42").total == 2
    finally:
        ext._EXPANDERS.pop("SYNO42", None)


@parity
def test_dropindex(client):
    client.ft_dropindex("books")
    assert "books" not in client.ft_list()
    with pytest.raises(resolve(rs.errors.IndexNotFound)):
        client.ft_search("books", "*")


@parity
def test_alter_adds_field(client):
    client.ft_alter("books", rs.Field("pages", rs.FieldType.NUMERIC))
    client.hset("book:4", {"title": "new book", "genre": "scifi",
                           "year": 2000, "pages": 350})
    res = client.ft_search("books", "@pages:[300 400]")
    assert [h.key for h in res] == ["book:4"]


@parity
def test_synonyms(client):
    client.ft_synupdate("books", "g1", ["hacker", "cracker"])
    res = client.ft_search("books", "cracker")
    assert [h.key for h in res] == ["book:2"]
    dump = client.ft_syndump("books")
    assert dump["hacker"] == ["g1"]


@parity
def test_spellcheck(client):
    out = client.ft_spellcheck("books", "sandwrms")
    assert out and out[0]["term"] == "sandwrms"
    suggestions = [s for _, s in out[0]["suggestions"]]
    assert "sandworms" in suggestions


@parity
def test_dict_commands(client):
    assert client.ft_dictadd("slang", "gnarly", "rad") == 2
    assert client.ft_dictdump("slang") == ["gnarly", "rad"]
    assert client.ft_dictdel("slang", "rad") == 1
    out = client.ft_spellcheck("books", "gnarl", include=["slang"])
    assert any(s == "gnarly" for _, s in out[0]["suggestions"])


@parity
def test_suggestions(client):
    client.ft_sugadd("ac", "hello world", 1.0)
    client.ft_sugadd("ac", "hello there", 0.5)
    client.ft_sugadd("ac", "help me", 0.8)
    assert client.ft_suglen("ac") == 3
    got = client.ft_sugget("ac", "hel")
    assert "hello world" in got and len(got) == 3
    got = client.ft_sugget("ac", "helo", fuzzy=True)
    assert got  # fuzzy prefix match
    assert client.ft_sugdel("ac", "help me")
    assert client.ft_suglen("ac") == 2
    scored = client.ft_sugget("ac", "hello", with_scores=True)
    assert scored[0][0] == "hello world"
    # pinned score normalization (reference: src/trie/trie.c:271-279 —
    # prefix mode divides by sqrt(1 + |len(candidate) - len(query)|))
    import math
    assert abs(scored[0][1] - 1.0 / math.sqrt(1 + 6)) < 1e-6
    assert abs(scored[1][1] - 0.5 / math.sqrt(1 + 6)) < 1e-6
    # a candidate equal to the query scores (float)INT_MAX pre-shaping
    client.ft_sugadd("ac", "hello", 0.1)
    scored = client.ft_sugget("ac", "hello", with_scores=True)
    assert scored[0][0] == "hello" and scored[0][1] == float(2**31 - 1)
    # fuzzy multiplies by exp(-2*dist): dist-1 candidates are discounted
    client.ft_sugadd("ac", "belly", 100.0)
    fz = dict(client.ft_sugget("ac", "hell", fuzzy=True,
                               with_scores=True))
    assert abs(fz["belly"] - 100.0 * math.exp(-2.0)
               / math.sqrt(2.0)) < 1e-4
    client.ft_sugdel("ac", "hello")
    client.ft_sugdel("ac", "belly")


@parity
def test_tagvals(client):
    vals = client.ft_tagvals("books", "genre")
    assert vals == ["cyberpunk", "romance", "scifi"]


@parity
def test_config(client):
    assert client.ft_config_get("MAXPREFIXEXPANSIONS") == 200
    client.ft_config_set("MAXPREFIXEXPANSIONS", 50)
    assert client.ft_config_get("MAXPREFIXEXPANSIONS") == 50
    with pytest.raises(resolve(rs.errors.ConfigError)):
        client.ft_config_set("WORKERS", 4)  # immutable in this design


@parity
def test_highlight(client):
    res = client.ft_search("books", "hacker",
                           highlight={"fields": ["summary"]})
    assert "<b>hacker</b>" in res.hits[0].fields["summary"]


@parity
def test_summarize(client):
    res = client.ft_search(
        "books", "sandworms",
        summarize={"fields": ["summary"], "frag_len": 5},
        highlight={})
    assert "<b>sandworms</b>" in res.hits[0].fields["summary"]


@parity
def test_profile(client):
    res, prof = client.ft_profile("books", "SEARCH", "dune | emma")
    assert res.total == 2
    assert prof["parsing_time_ms"] >= 0
    assert "UNION" in prof["query_tree"]


@parity
def test_cursor(client):
    req = (rs.AggregateRequest("*").load("title")
           .sort_by("@year").cursor(count=2))
    res = client.ft_aggregate("books", req)
    assert len(res.rows) == 2 and res.cursor_id != 0
    rows2, cid2 = client.ft_cursor_read("books", res.cursor_id)
    assert len(rows2) == 1 and cid2 == 0


@parity
def test_hybrid_rrf(client):
    c = rs.Client()
    c.ft_create("h", [
        rs.Field("txt", rs.FieldType.TEXT),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=4,
                                        metric=rs.VectorMetric.L2))])
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(10, 4)).astype(np.float32)
    for i in range(10):
        c.hset(f"d{i}", {"txt": f"common word{'s' if i % 2 else ''} {i}",
                         "v": vecs[i]})
    hq = rs.HybridQuery(search="common", vsim_field="v",
                        vsim_vector=vecs[4], combine="RRF", limit=5)
    rows = c.ft_hybrid("h", hq)
    assert rows and rows[0]["__key"] == "d4"  # top by both rank lists
    hq2 = rs.HybridQuery(search="common", vsim_field="v",
                         vsim_vector=vecs[4], combine="LINEAR",
                         alpha=0.1, beta=0.9, limit=5)
    rows2 = c.ft_hybrid("h", hq2)
    assert rows2[0]["__key"] == "d4"


@parity
def test_hybrid_many_matches_single(client):
    """run_hybrid_many must return exactly what per-query run_hybrid
    does — batching is a serving optimization, not a semantics change."""
    c = rs.Client()
    c.ft_create("hm", [
        rs.Field("txt", rs.FieldType.TEXT),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=4,
                                        metric=rs.VectorMetric.L2))])
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(12, 4)).astype(np.float32)
    for i in range(12):
        c.hset(f"m{i}", {"txt": f"shared tok{i % 3} extra{i}",
                         "v": vecs[i]})
    ix = c._index("hm")
    hqs = [rs.HybridQuery(search="shared", vsim_field="v",
                          vsim_vector=vecs[i], combine=cmb, limit=5,
                          alpha=0.3, beta=0.7)
           for i, cmb in [(1, "RRF"), (4, "LINEAR"), (9, "RRF")]]
    batched = rs.run_hybrid_many(ix, hqs)
    run_hybrid = rs.aux.hybrid.run_hybrid
    singles = [run_hybrid(ix, hq) for hq in hqs]
    assert batched == singles
    assert batched[0][0]["__key"] == "m1"


@parity
def test_checkpoint_roundtrip(tmp_path, client):
    client.save_index("books", str(tmp_path / "ckpt"))
    c2 = rs.Client()
    c2.load_index("books", str(tmp_path / "ckpt"))
    res = c2.ft_search("books", "dune")
    assert [h.key for h in res] == ["book:1"]
    res = c2.ft_search("books", "@genre:{cyberpunk}")
    assert [h.key for h in res] == ["book:2"]


@parity
def test_doc_ttl(client):
    client.hset("book:9", {"title": "ephemeral tome", "genre": "scifi",
                           "year": 2020}, ttl=-1)  # already expired
    res = client.ft_search("books", "ephemeral")
    assert res.total == 0


@parity
def test_search_many_batched(client):
    res = client.ft_search_many(
        "books", ["dune", "emma", "cyberspace", "nomatchterm"])
    assert [r.hits[0].key if r.hits else None for r in res] == [
        "book:1", "book:3", "book:2", None]
    assert res[3].total == 0


@parity
def test_search_many_multi_segment(client):
    client.hset("book:9", {"title": "dune awakening", "genre": "scifi",
                           "year": 2024})  # second segment after commit
    res = client.ft_search_many("books", ["dune"])
    keys = {h.key for h in res[0].hits}
    assert keys == {"book:1", "book:9"}
    assert res[0].total == 2


@parity
def test_ft_debug(client):
    out = client.ft_debug("DUMP_INVIDX", "books", "dune")
    assert out == [("book:1", 2.0)]  # tf carries the field weight (2.0)
    out = client.ft_debug("DUMP_NUMIDX", "books", "year")
    assert [k for k, v in out] == ["book:3", "book:1", "book:2"]
    out = client.ft_debug("DUMP_TAGIDX", "books", "genre")
    assert set(out["scifi"]) == {"book:1", "book:2"}
    segs = client.ft_debug("SEGMENTS", "books")
    assert segs and segs[0]["n_docs"] == 3
    assert "dune" in client.ft_debug("DUMP_TERMS", "books")
    client.hdel("book:2")
    assert client.ft_debug("GC_FORCEINVOKE", "books") == "DONE"
    assert client.ft_debug("SEGMENTS", "books")[0]["n_deleted"] == 0


@parity
def test_dialect_stats():
    """Dialect usage tracking (reference: per-index dialect_stats in
    FT.INFO + search_dialect_N module INFO, global_stats.h)."""
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType
    AggregateRequest = rs.agg.pipeline.AggregateRequest

    c = Client()
    c.ft_create("ds", [Field("t", FieldType.TEXT)])
    c.hset("a", {"t": "word"})
    info = c.ft_info("ds")
    assert info["dialect_stats"] == {"dialect_1": 0, "dialect_2": 0,
                                     "dialect_3": 0, "dialect_4": 0}
    c.ft_search("ds", "word", dialect=3)
    c.ft_search("ds", "word", dialect=1)
    req = AggregateRequest("word").load("t")
    req.dialect = 2
    c.ft_aggregate("ds", req)
    info = c.ft_info("ds")
    assert info["dialect_stats"] == {"dialect_1": 1, "dialect_2": 1,
                                     "dialect_3": 1, "dialect_4": 0}
    # EXPLAIN does not mark usage
    c.ft_explain("ds", "word")
    assert c.ft_info("ds")["dialect_stats"]["dialect_4"] == 0


@parity
def test_ft_add_conditional_updates(client):
    """FT.ADD REPLACE/PARTIAL/NOCREATE/IF semantics pinned to the
    reference (src/document_add.c:140-226,
    tests/pytests/test_conditional_updates.py)."""
    DocumentExists = rs.utils.errors.DocumentExists
    DocumentNotFound = rs.utils.errors.DocumentNotFound
    c = client
    assert c.ft_add("books", "doc1", 1.0, {"title": "x", "year": "5"}) == "OK"
    # exists without REPLACE -> error
    with pytest.raises(resolve(DocumentExists)):
        c.ft_add("books", "doc1", 1.0, {"title": "y"})
    # NOCREATE on missing doc -> error
    with pytest.raises(resolve(DocumentNotFound)):
        c.ft_add("books", "nope", 1.0, {"title": "y"},
                 replace=True, nocreate=True)
    # ANY comparison dereferencing a missing property -> NOADD,
    # including != (reference NO_PROP_VAL handling)
    for expr in ("@year > @id2", "@year < @id2", "@year == @id2",
                 "@year != @id2"):
        assert c.ft_add("books", "doc1", 1.0,
                        {"year": "3", "id2": "4"},
                        replace=True, partial=True,
                        if_expr=expr) == "NOADD"
    # falsy condition -> NOADD
    assert c.ft_add("books", "doc1", 1.0, {"year": "3"},
                    replace=True, partial=True,
                    if_expr="@year == 4") == "NOADD"
    # exists() may probe missing properties without tripping NOADD
    assert c.ft_add("books", "doc1", 1.0, {"year": "3"},
                    replace=True, partial=True,
                    if_expr="!exists(@id2)") == "OK"
    # truthy numeric coercion: "5"... now year is 3 after the update above
    assert c.ft_add("books", "doc1", 1.0, {"year": "7", "id2": "4"},
                    replace=True, partial=True,
                    if_expr="@year == 3") == "OK"
    # PARTIAL merges: title survives the partial updates
    assert c.ft_get("books", "doc1")["title"] == "x"
    assert c.ft_get("books", "doc1")["year"] == "7"
    # REPLACE without PARTIAL wipes old fields
    assert c.ft_add("books", "doc1", 1.0, {"summary": "fresh"},
                    replace=True) == "OK"
    doc = c.ft_get("books", "doc1")
    assert "title" not in doc and doc["summary"] == "fresh"


@parity
def test_ft_add_nosave_and_language(client):
    c = client
    # NOSAVE: indexed but not in the keyspace
    assert c.ft_add("books", "ghost", 1.0,
                    {"title": "phantom zone"}, nosave=True) == "OK"
    assert c.ft_get("books", "ghost") is None   # keyspace miss
    assert c.hget("ghost") is None
    res = c.ft_search("books", "phantom")
    assert any(h.key == "ghost" for h in res.hits)
    # LANGUAGE: stemming follows the per-doc override (spanish plural)
    assert c.ft_add("books", "es1", 1.0, {"title": "gatos negros"},
                    language="spanish") == "OK"
    res = c.ft_search("books", "gato", language="spanish")
    assert any(h.key == "es1" for h in res.hits)


def test_parity_runs_each_package_and_compares():
    """The harness itself: a `@parity` body runs on the JAX package,
    then on the port's `Client` on the CPU, and a call whose result
    differs between the two fails the comparison."""
    from tests.torch_parity import side, unwrap
    seen = []

    def body(port_alphas):
        c = rs.Client()
        seen.append((side(), type(unwrap(c)).__module__,
                     str(getattr(unwrap(c), "device", "-"))))
        c.ft_create("h", [rs.Field("t", rs.FieldType.TEXT)])
        for i in range(3):
            alpha = side() == "jax" or i < port_alphas
            c.hset(f"k{i}", {"t": "alpha" if alpha else "beta"})
        c.ft_search("h", "alpha")

    parity(lambda: body(3))()
    assert seen == [("jax", "redisearch_tpu.api", "-"),
                    ("torch", "redisearch_tpu_torch.api", "cpu")]
    with pytest.raises(AssertionError, match="total"):
        parity(lambda: body(2))()
