"""Field-type behaviors: geometry, ismissing/indexempty, TTL, tags options,
field masks, languages, payload (reference: per-feature pytest files).

Parity file of tests/test_fields.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import time

import numpy as np
import pytest


@parity
def test_geometry_predicates():
    ix = rs.SearchIndex(rs.Schema(name="g", fields=[
        rs.Field("shape", rs.FieldType.GEOMETRY,
                 geometry=rs.GeometryParams())]))
    ix.add_document("sq", {"shape": "POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))"})
    ix.add_document("inner", {"shape": "POLYGON((2 2, 4 2, 4 4, 2 4, 2 2))"})
    ix.add_document("far", {"shape": "POLYGON((100 100, 110 100, 110 110, "
                                     "100 110, 100 100))"})
    ix.add_document("pt", {"shape": "POINT(5 5)"})
    ix.commit()
    res = ix.search("@shape:[WITHIN $q]",
                    params={"q": "POLYGON((-1 -1, 20 -1, 20 20, -1 20, -1 -1))"})
    assert {h.key for h in res} == {"sq", "inner", "pt"}
    res = ix.search("@shape:[CONTAINS $q]", params={"q": "POINT(3 3)"})
    assert {h.key for h in res} == {"sq", "inner"}
    res = ix.search("@shape:[INTERSECTS $q]",
                    params={"q": "POLYGON((9 9, 12 9, 12 12, 9 12, 9 9))"})
    assert "sq" in {h.key for h in res}
    res = ix.search("@shape:[DISJOINT $q]", params={"q": "POINT(5 5)"})
    assert "far" in {h.key for h in res}


@parity
def test_ismissing():
    ix = rs.SearchIndex(rs.Schema(name="m", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("opt", rs.FieldType.TEXT, indexmissing=True)]))
    ix.add_document("has", {"t": "x", "opt": "present"})
    ix.add_document("hasnot", {"t": "x"})
    ix.commit()
    res = ix.search("ismissing(@opt)")
    assert {h.key for h in res} == {"hasnot"}
    # without INDEXMISSING the query errors
    ix2 = rs.SearchIndex(rs.Schema(name="m2", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix2.add_document("a", {"t": "x"})
    with pytest.raises(resolve(rs.errors.QuerySyntaxError)):
        ix2.search("ismissing(@t)")


@parity
def test_indexempty_tag():
    ix = rs.SearchIndex(rs.Schema(name="ie", fields=[
        rs.Field("tag", rs.FieldType.TAG, indexempty=True)]))
    ix.add_document("empty", {"tag": ""})
    ix.add_document("full", {"tag": "val"})
    ix.commit()
    res = ix.search('@tag:{""}', params=None)
    assert {h.key for h in res} == {"empty"}


@parity
def test_doc_ttl_expiry():
    ix = rs.SearchIndex(rs.Schema(name="ttl", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("fresh", {"t": "hello"}, ttl=3600)
    ix.add_document("stale", {"t": "hello"}, ttl=-5)
    ix.commit()
    res = ix.search("hello")
    assert {h.key for h in res} == {"fresh"}


@parity
def test_field_level_ttl():
    ix = rs.SearchIndex(rs.Schema(name="fttl", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("d", {"t": "hello"})
    meta = ix.doctable.get_by_key("d")
    meta.field_expiration = {"t": time.time() - 1}
    assert meta.field_expired("t")
    assert not meta.field_expired("other")


@parity
def test_tag_casesensitive():
    ix = rs.SearchIndex(rs.Schema(name="cs", fields=[
        rs.Field("a", rs.FieldType.TAG, casesensitive=True),
        rs.Field("b", rs.FieldType.TAG)]))
    ix.add_document("d1", {"a": "Hello", "b": "Hello"})
    ix.commit()
    assert ix.search("@a:{Hello}").total == 1
    assert ix.search("@a:{hello}").total == 0      # case preserved
    assert ix.search("@b:{HELLO}").total == 1      # folded


@parity
def test_tag_separator():
    ix = rs.SearchIndex(rs.Schema(name="sep", fields=[
        rs.Field("t", rs.FieldType.TAG, separator=";")]))
    ix.add_document("d", {"t": "a;b; c"})
    ix.commit()
    assert ix.search("@t:{a}").total == 1
    assert ix.search("@t:{c}").total == 1          # trimmed
    assert ix.search("@t:{a;b}").total == 0


@parity
def test_multifield_mask():
    ix = rs.SearchIndex(rs.Schema(name="mf", fields=[
        rs.Field("title", rs.FieldType.TEXT),
        rs.Field("body", rs.FieldType.TEXT),
        rs.Field("other", rs.FieldType.TEXT)]))
    ix.add_document("d1", {"title": "apple", "body": "pear", "other": "kiwi"})
    ix.add_document("d2", {"title": "pear", "body": "apple"})
    ix.commit()
    assert {h.key for h in ix.search("@title:apple")} == {"d1"}
    assert {h.key for h in ix.search("@title|body:apple")} == {"d1", "d2"}
    assert ix.search("@other:apple").total == 0


@parity
def test_language_stemming():
    ix = rs.SearchIndex(rs.Schema(name="fr", fields=[
        rs.Field("t", rs.FieldType.TEXT)], language="french"))
    ix.add_document("d", {"t": "les chanteuses magnifiques"})
    ix.commit()
    # "chanteuse" (singular-ish) stems to the same root as "chanteuses"
    res = ix.search("chanteuse")
    assert res.total == 1


@parity
def test_nostem_field():
    ix = rs.SearchIndex(rs.Schema(name="ns", fields=[
        rs.Field("t", rs.FieldType.TEXT, nostem=True)]))
    ix.add_document("d", {"t": "running"})
    ix.commit()
    assert ix.search("running").total == 1
    assert ix.search("'run'").total == 0  # verbatim, no stem indexed


@parity
def test_weights_affect_ranking():
    ix = rs.SearchIndex(rs.Schema(name="w", fields=[
        rs.Field("hi", rs.FieldType.TEXT, weight=5.0),
        rs.Field("lo", rs.FieldType.TEXT, weight=0.5)]))
    ix.add_document("in_hi", {"hi": "target", "lo": "x"})
    ix.add_document("in_lo", {"hi": "x", "lo": "target"})
    ix.commit()
    res = ix.search("target")
    assert [h.key for h in res] == ["in_hi", "in_lo"]


@parity
def test_query_weight_attribute():
    ix = rs.SearchIndex(rs.Schema(name="qw", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("a", {"t": "apple"})
    ix.add_document("b", {"t": "banana"})
    ix.commit()
    res = ix.search("(apple) => {$weight: 0.1;} | (banana) => {$weight: 9}")
    assert res.hits[0].key == "b"


@parity
def test_payload_roundtrip():
    ix = rs.SearchIndex(rs.Schema(name="pl", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    ix.add_document("d", {"t": "x"}, payload=b"\x01\x02")
    ix.commit()
    res = ix.search("x")
    assert res.hits[0].payload == b"\x01\x02"


@parity
def test_string_sortby_across_segments():
    """Per-segment dictionary ids are incomparable; the merge must rank on
    resolved strings (reference: WITHSORTKEYS merge, module.c:2453)."""
    ix = rs.SearchIndex(rs.Schema(name="ss", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("name", rs.FieldType.TAG, sortable=True)]))
    ix.add_document("d1", {"t": "x", "name": "zebra"})
    ix.add_document("d2", {"t": "x", "name": "mango"})
    ix.commit()  # segment 1
    ix.add_document("d3", {"t": "x", "name": "apple"})
    ix.add_document("d4", {"t": "x", "name": "peach"})
    ix.commit()  # segment 2
    res = ix.search("x", sort_by="name", sort_asc=True)
    assert [h.sortkey for h in res] == ["apple", "mango", "peach", "zebra"]
    res = ix.search("x", sort_by="name", sort_asc=False)
    assert [h.sortkey for h in res] == ["zebra", "peach", "mango", "apple"]


@parity
def test_field_ttl_match_time():
    """Field-level TTLs filter at MATCH time (reference: ttl_table +
    expiration_checker iterator), not just at reply time."""
    import time as _time
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    c.ft_create("fx", [Field("title", FieldType.TEXT),
                       Field("body", FieldType.TEXT),
                       Field("tags", FieldType.TAG),
                       Field("n", FieldType.NUMERIC)])
    c.hset("d1", {"title": "hello world", "body": "other words",
                  "tags": "red", "n": 5})
    c.hset("d2", {"title": "plain stuff", "body": "hello there",
                  "tags": "red", "n": 7})

    c.hexpire("d1", -1, ["title"])      # already expired
    assert c.ft_search("fx", "@title:hello", no_content=True).total == 0
    r = c.ft_search("fx", "hello", no_content=True)
    assert [h.key for h in r.hits] == ["d2"]       # d2 matches via body
    r = c.ft_search("fx", "@body:other", no_content=True)
    assert [h.key for h in r.hits] == ["d1"]       # d1's body still alive

    c.hexpire("d2", -1, ["tags"])
    r = c.ft_search("fx", "@tags:{red}", no_content=True)
    assert [h.key for h in r.hits] == ["d1"]

    c.hexpire("d1", -1, ["n"])
    r = c.ft_search("fx", "@n:[0 10]", no_content=True)
    assert [h.key for h in r.hits] == ["d2"]

    # a future TTL still matches
    c2 = Client()
    c2.ft_create("fy", [Field("t", FieldType.TEXT)])
    c2.hset("a", {"t": "soon gone"})
    c2.hexpire("a", 3600, ["t"])
    assert c2.ft_search("fy", "soon", no_content=True).total == 1
    # HEXPIRE return codes: 1 per existing field, -2 for missing key/field
    assert c2.hexpire("a", 10, ["t", "zz"]) == [1, -2]


@parity
def test_vector_field_ttl_knn():
    """HEXPIRE on a VECTOR field removes the doc from KNN / range results
    at match time (reference: ttl_table applies to every field type)."""
    import numpy as np
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType
    VectorParams = rs.schema.VectorParams

    c = Client()
    c.ft_create("vx", [Field("t", FieldType.TEXT),
                       Field("v", FieldType.VECTOR,
                             vector=VectorParams(dim=4, metric="L2"))])
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(6, 4)).astype(np.float32)
    for i in range(6):
        c.hset(f"d{i}", {"t": f"doc {i}", "v": vecs[i]})
    q = vecs[2]

    r = c.ft_search("vx", "*=>[KNN 3 @v $q]", params={"q": q},
                    no_content=True)
    assert r.hits[0].key == "d2"

    c.hexpire("d2", -1, ["v"])          # expire d2's vector field only
    r = c.ft_search("vx", "*=>[KNN 3 @v $q]", params={"q": q},
                    no_content=True)
    assert all(h.key != "d2" for h in r.hits)
    # the text field is untouched
    assert c.ft_search("vx", '@t:"doc"', no_content=True).total == 6

    # filtered KNN path too
    r = c.ft_search("vx", "(@t:doc)=>[KNN 3 @v $q]", params={"q": q},
                    no_content=True)
    assert all(h.key != "d2" for h in r.hits)

    # vector range query leaf
    r = c.ft_search("vx", "@v:[VECTOR_RANGE 100 $q]", params={"q": q},
                    no_content=True)
    assert all(h.key != "d2" for h in r.hits) and r.total == 5


@parity
def test_expired_field_counts_as_missing():
    """ismissing(@f) matches docs whose field TTL lapsed (expired fields
    behave like absent fields, reference field-expiration semantics)."""
    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    c.ft_create("mx", [Field("t", FieldType.TEXT, indexmissing=True),
                       Field("g", FieldType.TAG, indexmissing=True)])
    c.hset("a", {"t": "alpha words", "g": "x"})
    c.hset("b", {"g": "y"})                      # no t at all
    c.hset("cc", {"t": "gamma words", "g": "z"})

    r = c.ft_search("mx", "ismissing(@t)", no_content=True)
    assert sorted(h.key for h in r.hits) == ["b"]

    c.hexpire("cc", -1, ["t"])                   # text-field expiry
    r = c.ft_search("mx", "ismissing(@t)", no_content=True)
    assert sorted(h.key for h in r.hits) == ["b", "cc"]

    c.hexpire("a", -1, ["g"])                    # tag-field expiry
    r = c.ft_search("mx", "ismissing(@g)", no_content=True)
    assert sorted(h.key for h in r.hits) == ["a"]


@parity
def test_expire_on_staged_doc_survives_seal():
    """EXPIRE on a document still in the staging builder must carry into
    the sealed segment's TTL column (and into batched execution, whose
    QueryOptions previously defaulted now=0)."""
    import time as _time

    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType

    c = Client()
    c.ft_create("st", [Field("t", FieldType.TEXT)])
    for i in range(10):
        c.hset(f"k{i}", {"t": "alpha common"})
    c.hset("dx", {"t": "alpha gone"})
    c.expire("dx", 0.5)                     # dx is staged, not sealed
    _time.sleep(1.8)
    r = c.ft_search("st", "alpha", no_content=True)   # seals + queries
    assert r.total == 10
    # batched path honors the wall clock too
    many = c.ft_search_many("st", ["alpha", "common"])
    assert [m.total for m in many] == [10, 10]


@parity
def test_batched_same_string_knn_distinct_blobs():
    """Two identical KNN query strings with different $vec payloads in one
    batch must not alias through the prepared-query cache."""
    import numpy as np

    Client = rs.api.Client
    Field = rs.schema.Field
    FieldType = rs.schema.FieldType
    VectorParams = rs.schema.VectorParams

    c = Client()
    c.ft_create("kb", [Field("v", FieldType.VECTOR,
                             vector=VectorParams(dim=4, metric="L2"))])
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(12, 4)).astype(np.float32)
    for i in range(12):
        c.hset(f"d{i}", {"v": vecs[i]})
    q = "*=>[KNN 1 @v $q]"
    many = c.ft_search_many("kb", [q, q, q],
                            params=[{"q": vecs[2]}, {"q": vecs[7]},
                                    {"q": vecs[9]}])
    assert [m.hits[0].key for m in many] == ["d2", "d7", "d9"]


# ---------------------------------------------------------------------------
# >32 TEXT fields: multi-word field masks (reference: t_fieldMask is
# 128-bit, src/redisearch.h)
# ---------------------------------------------------------------------------


@parity
def test_many_text_fields_scoped_queries():

    F = 40
    fields = [rs.Field(f"f{i}", rs.FieldType.TEXT) for i in range(F)]
    ix = rs.SearchIndex(rs.Schema(name="wide", fields=fields))
    # each doc i puts its marker word in field f{i} only
    for i in range(F):
        ix.add_document(f"d{i}", {f"f{i}": f"marker common"})
    ix.commit()
    # unscoped: every doc matches
    assert ix.search("marker", num=100).total == F
    # field-scoped across both mask words (f1 = word 0, f35 = word 1)
    for i in (0, 1, 30, 31, 32, 35, 39):
        r = ix.search(f"@f{i}:marker", num=100)
        assert [h.key for h in r.hits] == [f"d{i}"], i
    # multi-field scope spanning the word boundary
    r = ix.search("@f31|f32:marker", num=100)
    assert sorted(h.key for h in r.hits) == ["d31", "d32"]
    # AND across fields + phrase in a high field
    ix.add_document("both", {"f5": "alpha beta", "f37": "gamma"})
    ix.commit()
    assert [h.key for h in ix.search('@f5:"alpha beta" @f37:gamma').hits] \
        == ["both"]


@parity
def test_exactly_32_text_fields_single_word_mask():

    F = 32
    fields = [rs.Field(f"g{i}", rs.FieldType.TEXT) for i in range(F)]
    ix = rs.SearchIndex(rs.Schema(name="w32", fields=fields))
    ix.add_document("hi", {"g31": "topbit"})   # bit 31: sign bit of int32
    ix.add_document("lo", {"g0": "topbit"})
    ix.commit()
    assert [h.key for h in ix.search("@g31:topbit").hits] == ["hi"]
    assert [h.key for h in ix.search("@g0:topbit").hits] == ["lo"]
    assert ix.search("topbit").total == 2


@parity
def test_geometry_spherical_antimeridian():
    """SPHERICAL (geographic) coordinates — the reference default —
    wrap longitudes: a query polygon spanning the antimeridian still
    matches points given at equivalent longitudes mod 360."""

    ix = rs.SearchIndex(rs.Schema(name="geosph", fields=[
        rs.Field("g", rs.FieldType.GEOMETRY)]))
    # fiji-ish point at lon 179.5 and its -180.5 alias
    ix.add_document("east", {"g": "POINT (179.5 -17)"})
    ix.add_document("west_alias", {"g": "POINT (-180.5 -17)"})
    ix.add_document("far", {"g": "POINT (10 50)"})
    ix.commit()
    # polygon around the antimeridian written in the +180 frame
    poly = "POLYGON ((178 -20, 182 -20, 182 -14, 178 -14, 178 -20))"
    r = ix.search("@g:[WITHIN $p]", params={"p": poly}, num=10)
    assert sorted(h.key for h in r.hits) == ["east", "west_alias"]


@parity
def test_geometry_flat_no_wrap():

    ix = rs.SearchIndex(rs.Schema(name="geoflat", fields=[
        rs.Field("g", rs.FieldType.GEOMETRY,
                 geometry=rs.GeometryParams(system="FLAT"))]))
    ix.add_document("a", {"g": "POINT (179.5 -17)"})
    ix.add_document("alias", {"g": "POINT (-180.5 -17)"})
    ix.commit()
    poly = "POLYGON ((178 -20, 182 -20, 182 -14, 178 -14, 178 -20))"
    r = ix.search("@g:[WITHIN $p]", params={"p": poly}, num=10)
    # cartesian: -180.5 is just a coordinate far away, no wrapping
    assert [h.key for h in r.hits] == ["a"]


@parity
def test_tag_codes_column_single_vs_multi_valued():
    """Single-valued TAG fields build the dense value-id column
    (TagPostings.codes) and the predicate lowers to a per-candidate code
    compare; multi-valued fields keep posting-window membership.  Both
    must return identical results (reference: tag_index.c predicates)."""
    slice_segment = rs.index.slice.slice_segment
    ix = rs.SearchIndex(rs.Schema(name="tagcodes", fields=[
        rs.Field("body", rs.FieldType.TEXT),
        rs.Field("color", rs.FieldType.TAG),     # one value per doc
        rs.Field("labels", rs.FieldType.TAG),    # several values per doc
    ]))
    colors = ["red", "green", "blue", "teal"]
    docs = {}
    for i in range(120):
        labels = sorted({colors[i % 4], colors[(3 * i + 1) % 4]})
        docs[i] = (colors[i % 4], labels)
        ix.add_document(f"d{i}", {"body": f"apple w{i % 5}",
                                  "color": colors[i % 4],
                                  "labels": ",".join(labels)})
    ix.commit()
    seg = ix.segments[0]
    assert seg.tags["color"].codes is not None
    assert seg.tags["labels"].codes is None

    def ids(res):
        return sorted(int(h.key[1:]) for h in res)

    got = ix.search("@color:{red|teal}", num=200)
    assert ids(got) == sorted(i for i, (c, _) in docs.items()
                              if c in ("red", "teal"))
    got = ix.search("apple -@color:{green}", num=200)
    assert ids(got) == sorted(i for i, (c, _) in docs.items() if c != "green")
    got = ix.search("@labels:{blue}", num=200)
    assert ids(got) == sorted(i for i, (_, ls) in docs.items() if "blue" in ls)
    # unknown tag value: the slot stays unbound (-2 sentinel) and matches
    # nothing, including docs with no value
    assert ix.search("@color:{nosuchvalue}", num=200).total == 0

    # slicing carries the column through the doc remap
    keep = np.zeros(seg.n_pad, bool)
    live = [i for i in range(120) if i % 3 != 0]
    for i in live:
        keep[i] = True
    sub = slice_segment(seg, np.nonzero(keep)[0])
    assert sub.tags["color"].codes is not None
    sub_ids = {v: k for k, v in sub.tags["color"].ids.items()}
    oc = np.asarray(seg.tags["color"].codes)
    nc = np.asarray(sub.tags["color"].codes)
    for new_pos, old in enumerate(np.nonzero(keep)[0]):
        assert nc[new_pos] == oc[old]
    assert (nc[len(live):] == -1).all()


@parity
def test_tag_codes_checkpoint_roundtrip(tmp_path):
    checkpoint = rs.aux.checkpoint
    ix = rs.SearchIndex(rs.Schema(name="tagck", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("kind", rs.FieldType.TAG)]))
    for i in range(40):
        ix.add_document(f"d{i}", {"t": "word", "kind": "ab"[i % 2]})
    ix.commit()
    assert ix.segments[0].tags["kind"].codes is not None
    checkpoint.save(ix, str(tmp_path / "ck"))
    ix2 = checkpoint.load(str(tmp_path / "ck"))
    assert ix2.segments[0].tags["kind"].codes is not None
    got = sorted(int(h.key[1:]) for h in ix2.search("@kind:{a}", num=50))
    assert got == list(range(0, 40, 2))


@parity
def test_tag_codes_bulk_path_matches_incremental():
    """The native bulk ingest (add_documents) must build the same dense
    tag-codes column as the incremental builder."""
    def build(bulk):
        ix = rs.SearchIndex(rs.Schema(name=f"tcb{bulk}", fields=[
            rs.Field("t", rs.FieldType.TEXT),
            rs.Field("color", rs.FieldType.TAG),
            rs.Field("labels", rs.FieldType.TAG)]))
        docs = [(f"d{i}", {"t": f"word{i % 5} filler",
                           "color": "rgb"[i % 3],
                           "labels": ",".join({"rgb"[i % 3],
                                               "rgb"[(i + 1) % 3]})})
                for i in range(90)]
        if bulk:
            ix.add_documents(docs)
        else:
            for k, f in docs:
                ix.add_document(k, f)
            ix.commit()
        return ix
    bi, ii = build(True), build(False)
    bs, is_ = bi.segments[0], ii.segments[0]
    assert bs.tags["color"].codes is not None
    assert bs.tags["labels"].codes is None
    bc = np.asarray(bs.tags["color"].codes)
    ic = np.asarray(is_.tags["color"].codes)
    assert (bc[:90] == ic[:90]).all()
    for q in ("@color:{r}", "@color:{g|b}", "word1 -@color:{r}"):
        assert ([h.key for h in bi.search(q, num=100)]
                == [h.key for h in ii.search(q, num=100)]), q
