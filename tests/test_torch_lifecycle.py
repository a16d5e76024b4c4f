"""The index lifecycle in the torch port against the JAX package, on the
CPU: deletes, compaction (`maybe_compact`, `compact`), and the write
commands of the `Client`.

* `maybe_compact`'s policy: a deleted share of 20% keeps the segment,
  25% compacts it (the JAX package's threshold), through `commit` too;
  tests/test_ivf.py::test_auto_compaction, and the same with an IVF
  field, whose lists are rebuilt over the new local ids.
* The parity cases of tests/test_slice.py (compaction takes the slice
  path and equals a rebuild), tests/test_host_tier.py (deletes and
  compaction of the host tier), tests/test_cold.py (mutations of a cold
  index), tests/test_hybrid_fusion.py (fusion after a delete) and
  tests/test_device_groupby.py (no stale group-by after deletes), each
  run on both packages with the same documents and operations.
* tests/test_fuzz_mutations.py's six seeds: the same random adds,
  overwrites, deletes and compactions go to a JAX `Client` and a port
  `Client`; after each step both return the same keys and totals, and
  both equal the model.
* Each write command against the JAX `Client`: hget, hdel, expire,
  hexpire, ft_add (its options and its errors), ft_del, ft_get,
  ft_mget, ft_alter (reindex), ft_dropindex, ft_list, ft_synupdate
  (a reanalyzing compaction) and ft_syndump.
* A compacted segment has a new `uid`, so no query reuses a bind
  template of the segment it replaced, and a 1,000-doc index routes its
  batch back to "kernel" / "phrase-kernel" once compacted.

Equal: totals, keys and their order; scores within rtol 1e-6, vector
distances within 1e-5.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.agg.pipeline import (run_aggregate as j_run_aggregate,
                                         run_aggregate_many as j_run_many)
from redisearch_tpu.aux import hybrid as JH
from redisearch_tpu_torch.agg.pipeline import (run_aggregate,
                                               run_aggregate_many)
from redisearch_tpu_torch.aux import hybrid as TH
from redisearch_tpu_torch.ops import ivf as TI
from redisearch_tpu_torch.query import engine as TE
from redisearch_tpu_torch.utils import errors as TERR
from redisearch_tpu.utils import errors as JERR

from tests.test_torch_hybrid import _pair, _same_fusion, _same_rows


def _ix(p, name, fields, **kw):
    schema = p.Schema(name=name, fields=fields(p), **kw)
    return (p.SearchIndex(schema) if p is rs
            else p.SearchIndex(schema, device="cpu"))


def _same(t, j, what, rtol=1e-6):
    assert t.total == j.total, (what, t.total, j.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=rtol,
                               err_msg=str(what))
    if any(h.vector_distance is not None for h in j.hits):
        np.testing.assert_allclose(
            [h.vector_distance for h in t.hits],
            [h.vector_distance for h in j.hits], rtol=1e-5, atol=1e-5,
            err_msg=str(what))


def _text(p):
    return [p.Field("t", p.FieldType.TEXT)]


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("n_dead,compacts", [(20, False), (25, True)])
def test_maybe_compact_threshold(n_dead, compacts):
    """100 docs: 20 deleted (20%) keep the segment, 25 (25%) compact it;
    the JAX package decides the same."""
    out = []
    for p in (rs, rt):
        ix = _ix(p, "pol", _text)
        for i in range(100):
            ix.add_document(f"d{i}", {"t": f"w{i % 3}"})
        ix.commit()
        old = ix.segments[0]
        for i in range(n_dead):
            ix.delete_document(f"d{i}")
        ix.maybe_compact()
        seg = ix.segments[0]
        assert (seg is not old) == compacts
        assert seg.n_deleted == (0 if compacts else n_dead)
        assert seg.n_docs == (100 - n_dead if compacts else 100)
        out.append(ix.search("w1", num=100))
    _same(out[1], out[0], "w1")
    if compacts:
        assert "last_compaction" in ix.stats
        assert ix.stats["last_compaction"]["path"] == "slice"


def test_auto_compaction():
    """tests/test_ivf.py::test_auto_compaction on both packages: commit
    compacts once deletes pass the threshold."""
    out = []
    for p in (rs, rt):
        ix = _ix(p, "cmp", _text)
        for i in range(40):
            ix.add_document(f"d{i}", {"t": f"tok{i % 4}"})
        ix.commit()
        for i in range(20):   # delete half: above the 25% dead threshold
            ix.delete_document(f"d{i}")
        ix.add_document("fresh", {"t": "tok1"})
        ix.commit()           # triggers maybe_compact
        assert sum(s.n_deleted for s in ix.segments) == 0
        assert len(ix.segments) == 1
        r = ix.search("tok1")
        assert r.total == 6   # 5 survivors + fresh
        out.append(r)
    _same(out[1], out[0], "tok1")


def test_commit_with_nothing_staged_skips_the_check():
    """As in the JAX package, `commit` with an empty builder returns
    before `maybe_compact`."""
    ix = _ix(rt, "cmp2", _text)
    for i in range(40):
        ix.add_document(f"d{i}", {"t": "w"})
    ix.commit()
    for i in range(20):
        ix.delete_document(f"d{i}")
    ix.commit()
    assert ix.segments[0].n_deleted == 20
    ix.search("w")        # search commits too: still no compaction
    assert ix.segments[0].n_deleted == 20


def _ivf_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("v", p.FieldType.VECTOR, vector=p.VectorParams(
                dim=8, metric="L2", algo=p.VectorAlgo.IVF, nlist=8,
                nprobe=8, flat_buffer_limit=64))]


def test_auto_compaction_rebuilds_ivf():
    """With an IVF field the slice's lists are rebuilt over the new
    local ids; with the JAX package's centroids carried across, KNN at
    nprobe = nlist equals the JAX package's."""
    vecs = np.random.default_rng(4).normal(size=(300, 8)).astype(np.float32)
    ixs = []
    for p in (rs, rt):
        ix = _ix(p, "ivfc", _ivf_fields)
        for i in range(300):
            ix.add_document(f"d{i}", {"t": f"w{i % 3}", "v": vecs[i]})
        ix.commit()
        for i in range(0, 300, 3):
            ix.delete_document(f"d{i}")
        ix.add_document("fresh", {"t": "w1", "v": vecs[0]})
        ix.commit()
        assert len(ix.segments) == 1 and ix.segments[0].n_deleted == 0
        ixs.append(ix)
    jix, tix = ixs
    col = tix.segments[0].vectors["v"]
    assert col.ivf is not None
    ids = col.ivf.bucket_ids.numpy()
    assert ids.max() < tix.segments[0].n_docs
    assert sorted(ids[ids >= 0].tolist()) == list(range(201))
    cents = np.asarray(jix.segments[0].vectors["v"].ivf.centroids)
    col.ivf = TI.IVFIndex.build(col.vecs.numpy(), col.present.numpy(), "L2",
                                centroids=cents)
    for q in (vecs[1], vecs[2] + 0.05):
        p = {"b": q}
        _same(tix.search("*=>[KNN 6 @v $b]", params=p),
              jix.search("*=>[KNN 6 @v $b]", params=p), "knn")


# ---------------------------------------------------------- parity cases
def _slice_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("cat", p.FieldType.TAG, sortable=True),
            p.Field("x", p.FieldType.NUMERIC, sortable=True),
            p.Field("g", p.FieldType.GEO),
            p.Field("v", p.FieldType.VECTOR,
                    vector=p.VectorParams(dim=8, metric=p.VectorMetric.L2))]


def _slice_docs():
    """tests/test_slice.py's 300 documents."""
    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    return [(f"d{i}", {
        "t": " ".join(rng.choice(words, 6)), "cat": f"c{i % 7}",
        "x": float(i % 50),
        "g": f"{rng.uniform(-10, 10):.4f},{rng.uniform(-10, 10):.4f}",
        "v": rng.normal(size=8).astype(np.float32)}) for i in range(300)]


SLICE_QUERIES = [
    ("alpha beta", {}), ('"alpha beta"', {}), ("@t:gamma -delta", {}),
    ("@cat:{c1|c3} @x:[5 30]", {}), ("ze*", {}), ("@g:[0 0 2000 km]", {}),
    ("*=>[KNN 7 @v $b]", {"b": np.zeros(8, np.float32)}),
]


def test_compact_uses_slice_and_matches():
    """tests/test_slice.py::test_compact_uses_slice_and_matches on both
    packages: the compacted index equals the JAX package's and a port
    index rebuilt from the live docs."""
    docs = _slice_docs()
    out = {}
    for p in (rs, rt):
        ix = _ix(p, "slcmp", _slice_fields)
        for k, f in docs:
            ix.add_document(k, dict(f))
        ix.commit()
        for i in range(0, 300, 2):
            ix.delete_document(f"d{i}")
        ix.compact()
        assert len(ix.segments) == 1
        assert ix.segments[0].n_docs == 150
        assert ix.segments[0].n_deleted == 0
        out[p] = ix
    ref = _ix(rt, "slcmpr", _slice_fields)
    for i in range(1, 300, 2):
        ref.add_document(*docs[i])
    ref.commit()
    for q, prm in SLICE_QUERIES:
        got = out[rt].search(q, params=prm or None, num=50)
        _same(got, out[rs].search(q, params=prm or None, num=50), q)
        _same(got, ref.search(q, params=prm or None, num=50), q)


def _host_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("price", p.FieldType.NUMERIC),
            p.Field("v", p.FieldType.VECTOR, vector=p.VectorParams(
                dim=16, metric="L2", algo=p.VectorAlgo.IVF, nlist=16,
                nprobe=16, flat_buffer_limit=1, storage="host"))]


def test_host_tier_deletes_and_compact():
    """tests/test_host_tier.py::test_host_tier_deletes_and_compact on
    both packages (the port on the JAX package's centroids): the two
    nearest docs deleted vanish, and compaction rebuilds the slabs around
    the kept centroids with the same results."""
    vecs = np.random.default_rng(3).normal(size=(600, 16)).astype(
        np.float32)
    ixs = []
    for p in (rs, rt):
        ix = _ix(p, "ht", _host_fields)
        for i in range(600):
            ix.add_document(f"d{i}", {"t": "even" if i % 2 == 0 else "odd",
                                      "price": float(i), "v": vecs[i]})
        ix.commit()
        ixs.append(ix)
    jix, tix = ixs
    col = tix.segments[0].vectors["v"]
    jh = jix.segments[0].vectors["v"].host_ivf
    col.host_ivf = TI.HostIVF.build(col.vecs, col.present.numpy(), "L2",
                                    centroids=np.asarray(jh.centroids))
    q = vecs[30] + 0.01
    order = np.argsort(((vecs - q[None, :]) ** 2).sum(1))
    expect = [f"d{i}" for i in order[2:7]]
    blob = {"b": q.astype(np.float32).tobytes()}
    for ix in ixs:
        for i in order[:2]:
            ix.delete_document(f"d{i}")
    res = [ix.search("*=>[KNN 5 @v $b]", params=blob) for ix in ixs]
    assert [h.key for h in res[1].hits] == expect
    _same(res[1], res[0], "after deletes")
    for ix in ixs:
        ix.compact()
    col = tix.segments[0].vectors["v"]
    assert col.host and col.host_ivf is not None
    np.testing.assert_array_equal(col.host_ivf.centroids.numpy(),
                                  np.asarray(jh.centroids))
    res = [ix.search("*=>[KNN 5 @v $b]", params=blob) for ix in ixs]
    assert [h.key for h in res[1].hits] == expect
    _same(res[1], res[0], "after compaction")


def _cold_fields(p):
    return [p.Field("a", p.FieldType.TEXT, weight=2.0),
            p.Field("b", p.FieldType.TEXT),
            p.Field("tagf", p.FieldType.TAG),
            p.Field("num", p.FieldType.NUMERIC, sortable=True)]


def _cold_corpus(n=1200, seed=9):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:02d}" for i in range(40)]
    return [(f"d{i}", {"a": " ".join(rng.choice(vocab, 8)),
                       "b": " ".join(rng.choice(vocab, 5)),
                       "tagf": "xyz"[i % 3], "num": float(i % 100)})
            for i in range(n)]


def test_cold_mutations():
    """tests/test_cold.py::test_cold_mutations on both packages, then a
    compaction of the two-segment cold index (the builder path), which
    keeps the CSR arrays on the host."""
    ixs = {}
    for p in (rs, rt):
        for storage in ("host", "hbm"):
            ix = _ix(p, f"cm_{storage}", _cold_fields, storage=storage)
            for k, f in _cold_corpus():
                ix.add_document(k, f)
            ix.commit()
            for i in range(0, 1200, 7):
                ix.delete_document(f"d{i}")
            ixs[p, storage] = ix
    for q in ["w00 w01", '"w02 w03"']:
        want = ixs[rs, "host"].search(q, num=25)
        for key in ((rs, "hbm"), (rt, "host"), (rt, "hbm")):
            _same(ixs[key].search(q, num=25), want, (key, q))
    for ix in ixs.values():
        ix.add_document("extra", {"a": "w00 w01 w00", "tagf": "x",
                                  "num": 1})
        ix.commit()
    assert ixs[rt, "host"].segments[1].cold
    want = ixs[rs, "host"].search("w00 w01", num=25)
    for key in ((rs, "hbm"), (rt, "host"), (rt, "hbm")):
        _same(ixs[key].search("w00 w01", num=25), want, key)
    for ix in ixs.values():
        ix.compact()
        assert len(ix.segments) == 1 and ix.segments[0].n_deleted == 0
    seg = ixs[rt, "host"].segments[0]
    assert seg.cold and isinstance(seg.text.doc_ids, np.ndarray)
    assert ixs[rt, "host"].stats["last_compaction"]["path"] == "builder"
    for q in ["w00 w01", '"w02 w03"', "@tagf:{x} w08"]:
        want = ixs[rs, "host"].search(q, num=25)
        for key in ((rt, "host"), (rt, "hbm")):
            _same(ixs[key].search(q, num=25), want, (key, q))


def test_cold_compact_slices_on_the_host():
    """tests/test_cold.py::test_cold_compact_and_checkpoint's compaction:
    one cold segment compacts by a slice whose CSR arrays stay numpy."""
    out = []
    for p in (rs, rt):
        ix = _ix(p, "cc", _cold_fields, storage="host")
        for k, f in _cold_corpus():
            ix.add_document(k, f)
        ix.commit()
        for i in range(0, 1200, 5):
            ix.delete_document(f"d{i}")
        ix.compact()
        seg = ix.segments[0]
        assert seg.cold and isinstance(seg.text.doc_ids, np.ndarray)
        assert seg.n_docs == 960
        out.append(ix.search("w00 w01", num=25))
    _same(out[1], out[0], "w00 w01")


def test_fusion_after_delete():
    """tests/test_hybrid_fusion.py::test_fusion_after_delete on both
    packages: the deleted doc is in neither branch, and for RRF and
    LINEAR the vectorized fusion equals the hit-list fusion and the JAX
    package's."""
    jix, tix, centers = _pair(1)

    def hq(p, combine):
        return p.HybridQuery(search="beta", vsim_field="v",
                             vsim_vector=centers[1], combine=combine,
                             window=10, limit=10)
    victim = TH.run_hybrid_many(tix, [hq(rt, "RRF")])[0][0]["__key"]
    for ix in (jix, tix):
        ix.delete_document(victim)
    for combine in ("RRF", "LINEAR"):
        after = TH.run_hybrid_many(tix, [hq(rt, combine)])[0]
        assert victim not in [r["__key"] for r in after]
        _same_fusion(after,
                     TH._run_hybrid_hits(tix, [hq(rt, combine)], None)[0])
        _same_rows(after, JH.run_hybrid_many(jix, [hq(rs, combine)])[0])


def _dgs_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("cat", p.FieldType.TAG, sortable=True),
            p.Field("x", p.FieldType.NUMERIC, sortable=True)]


def test_device_groupby_not_stale_after_delete():
    """tests/test_device_groupby.py::test_device_groupby_not_stale_after_
    delete on both packages: a group-by run before deletes is not reused
    after them, singly and batched."""
    outs = []
    for p, single, many in ((rs, j_run_aggregate, j_run_many),
                            (rt, run_aggregate, run_aggregate_many)):
        ix = _ix(p, "dgs", _dgs_fields)
        for i in range(300):
            ix.add_document(f"d{i}", {"t": "w", "cat": f"c{i % 5}",
                                      "x": float(i)})
        ix.commit()

        def mk():
            return p.AggregateRequest("*").group_by(
                "@cat", ("COUNT", [], "n"), ("SUM", ["@x"], "s"))
        pre_b = many(ix, [mk(), mk()])
        pre_s = single(ix, mk())
        assert pre_s.total == pre_b[0].total == 300
        ix.delete_document("d0")
        ix.delete_document("d5")
        ix.commit()
        post_b = many(ix, [mk(), mk()])
        post_s = single(ix, mk())
        assert post_s.total == 298
        assert post_b[0].total == 298 and post_b[1].total == 298
        by = {r["cat"]: r for r in post_b[0].rows}
        assert by["c0"]["n"] == 58
        assert by["c0"]["s"] == float(sum(range(0, 300, 5)) - 0 - 5)
        outs.append((sorted(post_s.rows, key=lambda r: r["cat"]),
                     sorted(post_b[1].rows, key=lambda r: r["cat"])))
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ fuzz
FUZZ_WORDS = ["ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen"]


def _fuzz_fields(p):
    return [p.Field("t", p.FieldType.TEXT), p.Field("g", p.FieldType.TAG),
            p.Field("n", p.FieldType.NUMERIC, sortable=True)]


@pytest.mark.parametrize("seed", range(6))
def test_random_mutation_sequence(seed):
    """tests/test_fuzz_mutations.py: random adds, overwrites, deletes and
    compactions on a JAX and a port Client; after each step both equal
    the model and each other."""
    rng = np.random.default_rng(5000 + seed)
    clients = {rs: rs.Client(), rt: rt.Client(device="cpu")}
    for p, c in clients.items():
        c.ft_create("mu", _fuzz_fields(p))
    model: dict[str, dict] = {}

    def random_doc():
        return {"t": " ".join(FUZZ_WORDS[j] for j in rng.integers(0, 8, 3)),
                "g": "ab"[int(rng.integers(0, 2))],
                "n": float(rng.integers(0, 100))}

    def searches(c, w1, w2):
        return ([c.ft_search("mu", w, num=200, verbatim=True)
                 for w in (w1, w2)]
                + [c.ft_search("mu", "@g:{a} @n:[20 70]", num=200),
                   c.ft_search("mu", "*", sort_by="n", num=200)])

    def check():
        w1 = FUZZ_WORDS[int(rng.integers(0, 8))]
        w2 = FUZZ_WORDS[int(rng.integers(0, 8))]
        jres = searches(clients[rs], w1, w2)
        tres = searches(clients[rt], w1, w2)
        for t, j in zip(tres, jres):
            _same(t, j, (seed, w1, w2))
        for w, r in zip((w1, w2), tres):
            want = {k for k, d in model.items() if w in d["t"].split()}
            assert {h.key for h in r.hits} == want, w
        want = {k for k, d in model.items()
                if d["g"] == "a" and 20 <= d["n"] <= 70}
        assert {h.key for h in tres[2].hits} == want
        keys = [h.key for h in tres[3].hits]
        assert sorted(keys) == sorted(model)
        assert tres[3].total == len(model)

    for step in range(12):
        for _ in range(int(rng.integers(5, 25))):
            op = rng.integers(0, 10)
            key = f"k{int(rng.integers(0, 40))}"
            if op < 5:          # add / overwrite
                doc = random_doc()
                for c in clients.values():
                    c.hset(key, doc)
                model[key] = doc
            elif op < 8:        # delete
                if model:
                    key = list(model)[int(rng.integers(0, len(model)))]
                    for c in clients.values():
                        c.ft_del("mu", key, delete_document=True)
                    model.pop(key)
            elif model:         # update a field (full re-add)
                key = list(model)[int(rng.integers(0, len(model)))]
                doc = dict(model[key], n=float(rng.integers(0, 100)))
                for c in clients.values():
                    c.hset(key, doc)
                model[key] = doc
        if step % 4 == 3:
            for c in clients.values():
                c._index("mu").compact()
        check()


# -------------------------------------------------------------- commands
def _doc_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("tag", p.FieldType.TAG),
            p.Field("n", p.FieldType.NUMERIC, sortable=True)]


def _clients(n=60, prefix=("doc:",)):
    out = {}
    for p in (rs, rt):
        c = rs.Client() if p is rs else rt.Client(device="cpu")
        c.ft_create("ix", _doc_fields(p), prefixes=prefix)
        for i in range(n):
            c.hset(f"doc:{i}", {"t": f"hello w{i % 4} world",
                                "tag": "ab"[i % 2], "n": float(i)})
        out[p] = c
    return out


def _both(cs, fn):
    """fn(client) on both packages' clients: (port, jax)."""
    return fn(cs[rt]), fn(cs[rs])


def _same_search(cs, q, **kw):
    t, j = _both(cs, lambda c: c.ft_search("ix", q, num=100, **kw))
    _same(t, j, q)
    return t


def test_hset_hget_hdel_and_rules():
    cs = _clients()
    t, j = _both(cs, lambda c: c.hget("doc:3"))
    assert t == j == {"t": "hello w3 world", "tag": "b", "n": 3.0}
    assert _both(cs, lambda c: c.hdel("doc:3")) == (True, True)
    assert _both(cs, lambda c: c.hdel("doc:3")) == (False, False)
    assert _both(cs, lambda c: c.hget("doc:3")) == (None, None)
    # a key outside the prefix is stored but not indexed; overwriting
    # an indexed key's fields re-indexes it
    for c in cs.values():
        c.hset("other:1", {"t": "hello"})
        c.hset("doc:5", {"t": "brand new", "tag": "c", "n": 500.0})
    assert _same_search(cs, "hello").total == 58
    assert [h.key for h in _same_search(cs, "brand").hits] == ["doc:5"]
    assert _same_search(cs, "@tag:{c}").total == 1


def test_expire_and_hexpire():
    cs = _clients()
    _same_search(cs, "hello")           # seal
    for c in cs.values():
        c.expire("doc:1", -5)           # already past its deadline
        c.expire("doc:2", 3600)
        c.expire("missing", 10)
    t = _same_search(cs, "hello")
    assert t.total == 59 and "doc:1" not in [h.key for h in t.hits]
    assert cs[rt]._index("ix").segments[0].has_ttl
    # field-level TTL: the expired field drops out of matches and of the
    # returned document
    for c in cs.values():
        out = c.hexpire("doc:4", -5, ["t", "nosuch"])
        assert out == [1, -2]
    t = _same_search(cs, "w0")
    assert "doc:4" not in [h.key for h in t.hits]
    t = _same_search(cs, "@n:[4 4]")
    assert [h.key for h in t.hits] == ["doc:4"]
    assert "t" not in t.hits[0].fields


def test_ft_add_options_and_errors():
    cs = _clients(n=10)
    for p, c in cs.items():
        E = JERR if p is rs else TERR
        with pytest.raises(E.DocumentExists):
            c.ft_add("ix", "doc:1", 1.0, {"t": "x"})
        with pytest.raises(E.DocumentNotFound):
            c.ft_add("ix", "doc:99", 1.0, {"t": "x"}, nocreate=True)
        assert c.ft_add("ix", "doc:1", 1.0, {"t": "x"}, replace=True,
                        if_expr="@n > 5") == "NOADD"
        assert c.ft_add("ix", "doc:1", 1.0, {"t": "x"}, replace=True,
                        if_expr="@missing == 1") == "NOADD"
        assert c.ft_add("ix", "doc:2", 1.0, {"t": "replaced text"},
                        replace=True, if_expr="@n == 2") == "OK"
        assert c.ft_add("ix", "doc:3", 1.0, {"t": "partial text"},
                        replace=True, partial=True) == "OK"
        assert c.ft_add("ix", "doc:50", 2.0, {"t": "nosave text",
                                              "n": 50.0},
                        nosave=True) == "OK"
        assert c.ft_add("ix", "doc:51", 1.0, {"t": "running fast"},
                        language="english") == "OK"
    t, j = _both(cs, lambda c: c.ft_get("ix", "doc:3"))
    assert t == j == {"t": "partial text", "tag": "b", "n": 3.0}
    assert _both(cs, lambda c: c.ft_get("ix", "doc:2")) == (
        {"t": "replaced text"}, {"t": "replaced text"})
    assert _both(cs, lambda c: c.ft_get("ix", "doc:50")) == (None, None)
    assert _both(cs, lambda c: c.ft_get("ix", "doc:1"))[0]["t"] == (
        "hello w1 world")
    assert _same_search(cs, "nosave").total == 1
    assert _same_search(cs, "text").total == 3
    assert _same_search(cs, "run").total == 1      # stemmed
    assert _same_search(cs, "@tag:{b}").total == 5  # doc:3 kept its tag


def test_ft_del_get_mget():
    cs = _clients(n=20)
    assert _both(cs, lambda c: c.ft_del("ix", "doc:4")) == (True, True)
    assert _both(cs, lambda c: c.ft_del("ix", "doc:4")) == (False, False)
    assert _both(cs, lambda c: c.ft_del(
        "ix", "doc:6", delete_document=True)) == (True, True)
    t, j = _both(cs, lambda c: c.ft_mget("ix", "doc:4", "doc:5", "doc:6"))
    assert t == j == [None, {"t": "hello w1 world", "tag": "b",
                             "n": 5.0}, None]
    assert _both(cs, lambda c: c.hget("doc:4"))[0] is not None
    assert _both(cs, lambda c: c.hget("doc:6")) == (None, None)
    assert _same_search(cs, "hello").total == 18


def test_ft_alter_dropindex_list():
    cs = _clients(n=30)
    for p, c in cs.items():
        c.ft_del("ix", "doc:0")
        c.hset("doc:1", {"t": "hello", "tag": "a", "n": 1.0, "extra": 7})
        c.ft_create("other", _doc_fields(p), prefixes=("doc:",))
        c.ft_alter("ix", p.Field("extra", p.FieldType.NUMERIC))
    assert _both(cs, lambda c: c.ft_list()) == (["ix", "other"],) * 2
    t = _same_search(cs, "@extra:[5 10]")
    assert [h.key for h in t.hits] == ["doc:1"]
    assert _same_search(cs, "hello").total == 29
    for c in cs.values():
        c.ft_dropindex("other", delete_docs=True)
    assert _both(cs, lambda c: c.ft_list()) == (["ix"], ["ix"])
    assert _both(cs, lambda c: c.hget("doc:1")) == (None, None)
    for p, c in cs.items():
        E = JERR if p is rs else TERR
        with pytest.raises(E.IndexNotFound):
            c.ft_search("other", "hello")


def test_synupdate_reanalyzes():
    cs = _clients(n=30)
    for c in cs.values():
        c.hset("doc:100", {"t": "a hacker story", "tag": "a", "n": 1.0})
        c.hset("doc:101", {"t": "the cracker", "tag": "b", "n": 2.0})
        c.ft_search("ix", "hello")
        c.ft_del("ix", "doc:7")
        c.ft_synupdate("ix", "g1", ["hacker", "cracker"])
    assert _both(cs, lambda c: c.ft_syndump("ix")) == (
        {"hacker": ["g1"], "cracker": ["g1"]},) * 2
    t = _same_search(cs, "hacker")
    assert sorted(h.key for h in t.hits) == ["doc:100", "doc:101"]
    ix = cs[rt]._index("ix")
    assert len(ix.segments) == 1 and ix.segments[0].n_deleted == 0
    assert ix.stats["last_compaction"]["path"] == "builder"
    # skip_initial_scan: only later docs see the group
    for c in cs.values():
        c.ft_synupdate("ix", "g2", ["hello", "salut"],
                       skip_initial_scan=True)
        c.hset("doc:102", {"t": "salut", "tag": "a", "n": 3.0})
    _same_search(cs, "hello")
    _same_search(cs, "salut")


# ------------------------------------------------------ uid and routing
def _route_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("c", p.FieldType.TAG)]


ROUTE_QUERIES = ["alpha beta", "alpha @c:{y}", "beta|gamma", "gamma -beta",
                 '"alpha beta"', '"beta alpha"']


def _route_docs(n=1000):
    return [(f"d{i}", {"t": "alpha beta" if i % 2 else "alpha gamma",
                       "c": "x" if i % 3 else "y"}) for i in range(n)]


def test_compaction_returns_batches_to_the_kernels():
    """A 1,000-doc index with 30% deleted serves its batch on the window
    program; compacted, on the kernels again ("kernel",
    "phrase-kernel"), equal to the JAX package's results and to a
    rebuild of the live docs."""
    ixs = {}
    for p in (rs, rt):
        ix = _ix(p, "route", _route_fields)
        ix.add_documents(_route_docs())
        for i in range(0, 1000, 10):
            for j in (0, 3, 7):
                ix.delete_document(f"d{i + j}")
        ixs[p] = ix
    tix = ixs[rt]
    TE.QUERY_PATH_STATS.clear()
    dirty = tix.search_many(ROUTE_QUERIES, k=5)
    assert TE.QUERY_PATH_STATS == {"window": len(ROUTE_QUERIES)}
    for q, a, j in zip(ROUTE_QUERIES, dirty,
                       ixs[rs].search_many(ROUTE_QUERIES, k=5)):
        _same(a, j, q)
    for ix in ixs.values():
        ix.maybe_compact()
    seg = tix.segments[0]
    assert seg.n_docs == 700 and seg.n_deleted == 0
    TE.QUERY_PATH_STATS.clear()
    clean = tix.search_many(ROUTE_QUERIES, k=5)
    assert TE.QUERY_PATH_STATS == {"kernel": 4, "phrase-kernel": 2}
    ref = _ix(rt, "route2", _route_fields)
    ref.add_documents([d for d in _route_docs()
                       if tix.doctable.get_by_key(d[0]) is not None])
    # compaction recounts doc_freq over the live docs, so scores (idf)
    # move; the rebuild has the same corpus stats and scores
    jres = ixs[rs].search_many(ROUTE_QUERIES, k=5)
    for q, a, b, j, r in zip(ROUTE_QUERIES, dirty, clean, jres,
                             ref.search_many(ROUTE_QUERIES, k=5)):
        assert b.total == a.total, q
        _same(b, j, q)
        _same(b, r, q)


def test_compacted_segment_gets_a_new_uid():
    """The compacted segment is a new Segment with a fresh uid: a
    compiled query bound on the old segment binds the new one afresh
    (its term windows start elsewhere) and serves the live docs."""
    ix = _ix(rt, "uid", _route_fields)
    ix.add_documents(_route_docs())
    old = ix.segments[0]
    cq = ix.prepare("alpha beta", None, TE.QueryOptions(k=5))
    cq.bind(old)
    assert old.uid in cq._bind_cache
    for i in range(1, 1000, 2):
        ix.delete_document(f"d{i}")         # every "alpha beta" doc
    ix.compact()
    new = ix.segments[0]
    assert new.uid != old.uid and new is not old
    assert new.uid not in cq._bind_cache
    cq.bind(new)
    assert new.uid in cq._bind_cache
    res = TE.execute(cq, new, 5)
    assert res.count == 0
    assert ix.search("alpha beta").total == 0
    assert ix.search("alpha").total == 500


def test_alter_and_load_keep_the_synonyms(tmp_path):
    """After FT.ALTER and after a checkpoint load, new documents are
    indexed with the index's synonym groups.  The JAX package's new
    index and loaded index keep a builder made with an empty synonym
    map, so a synonym's doc added after them is not found through the
    group (ROADMAP §C); the port's is."""
    from redisearch_tpu.aux import checkpoint as JC
    from redisearch_tpu_torch.aux import checkpoint as TC
    cs = _clients(n=10)
    for p, c in cs.items():
        c.ft_synupdate("ix", "g1", ["hacker", "cracker"])
        c.hset("doc:50", {"t": "a hacker", "tag": "a", "n": 1.0})
        c.ft_alter("ix", p.Field("extra", p.FieldType.NUMERIC))
        c.hset("doc:51", {"t": "a cracker", "tag": "a", "n": 2.0})
    t, j = _both(cs, lambda c: c.ft_search("ix", "hacker", num=10))
    assert sorted(h.key for h in t.hits) == ["doc:50", "doc:51"]
    assert [h.key for h in j.hits] == ["doc:50"]
    out = {}
    for p, mod in ((rs, JC), (rt, TC)):
        path = str(tmp_path / p.__name__)
        mod.save(cs[p]._index("ix"), path)
        ix = mod.load(path) if p is rs else mod.load(path, device="cpu")
        ix.add_document("doc:52", {"t": "the cracker"})
        out[p] = sorted(h.key for h in ix.search("hacker", num=10).hits)
    assert out[rt] == ["doc:50", "doc:51", "doc:52"]
    assert out[rs] == ["doc:50"]


def test_tail_decode_cache_holds_its_tables():
    """The device tail's decode cache is keyed by table ids: it keeps the
    tables it was built from alive, so no table of a later index can
    take a cached id."""
    from redisearch_tpu_torch.agg import pipeline as TP
    table = [f"g{i}" for i in range(5)]
    gsizes, tarrs, _divs = TP._tail_decode_arrays([(None, table)])
    assert gsizes == [6] and list(tarrs[0][:5]) == table
    ent = TP._TARR_CACHE[(id(table),)]
    assert ent[3][0] is table
