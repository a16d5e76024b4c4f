"""Cold segments (Schema(storage="host")) in the torch port against the JAX
package, on the CPU.

A cold segment keeps its posting, position and tag CSR arrays in host
memory; each query pages only its term windows to the device
(`_cold_slab_args`) and runs the hot path's window program over them
(`_execute_cold`; path "cold" in a batch).  The cases of tests/test_cold.py
that do not need deletes or compaction (those are in
tests/test_torch_lifecycle.py): cold against hot,
SORTBY and the TFIDF/BM25/DISMAX scorers, slop and INORDER, batched
search and FT.AGGREGATE, and memory that stays on the host; each cold
result is also held against the JAX package's cold index.
`_cold_slab_args` is pinned against the JAX function: the rewritten
dyn, the slab lengths and contents and the slab signature are equal.
One difference: a phrase none of whose terms the segment holds reads a
2,048-lane position window, wider than the JAX function's 1,024-lane
position slab, and the JAX package raises; the port sizes the slab to
the window and answers as the hot index does.
The port's bulk path seals cold segments too (the JAX package's falls
back to its incremental builder), with the same results.

Equal: totals, keys and their order, scores within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.query import engine as TE


def _corpus(n=1200, seed=9):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:02d}" for i in range(40)]
    return [(f"d{i}", {"a": " ".join(rng.choice(vocab, 8)),
                       "b": " ".join(rng.choice(vocab, 5)),
                       "tagf": "xyz"[i % 3], "num": float(i % 100)})
            for i in range(n)]


def _build(p, storage, bulk=False):
    schema = p.Schema(name=f"cold_{storage}", fields=[
        p.Field("a", p.FieldType.TEXT, weight=2.0),
        p.Field("b", p.FieldType.TEXT),
        p.Field("tagf", p.FieldType.TAG),
        p.Field("num", p.FieldType.NUMERIC, sortable=True)],
        storage=storage)
    ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(schema,
                                                             device="cpu")
    if bulk:
        ix.add_documents(_corpus())
    else:
        for k, f in _corpus():
            ix.add_document(k, f)
        ix.commit()
    return ix


@pytest.fixture(scope="module")
def ixs():
    """JAX cold; the port's cold (incremental builder), cold over the
    JAX segment, cold through the bulk path, and hot."""
    jcold = _build(rs, "host")
    cold = _build(rt, "host")
    conv = _build(rt, "host")
    conv.segments = [segment_from_jax(jcold.segments[0], "cpu")]
    bulk = _build(rt, "host", bulk=True)
    hot = _build(rt, "hbm")
    return jcold, (cold, conv, bulk), hot


QUERIES = [
    "w00 w01",
    "w02 | w03",
    "w04 -w05",
    "w06 ~w07",
    '"w00 w01"',
    '@a:"w02 w03"',
    "@tagf:{x} w08",
    "@num:[10 60] w09",
    "w10 @tagf:{x|y}",
    "*",
]


def _same(a, b, what, rtol=1e-6):
    assert a.total == b.total, (what, a.total, b.total)
    assert [h.key for h in a.hits] == [h.key for h in b.hits], what
    np.testing.assert_allclose([h.score for h in a.hits],
                               [h.score for h in b.hits], rtol=rtol,
                               err_msg=str(what))


def test_cold_segment_is_host_resident(ixs):
    _j, colds, hot = ixs
    for cold in colds:
        seg = cold.segments[0]
        assert seg.cold
        assert isinstance(seg.text.doc_ids, np.ndarray)
        assert isinstance(seg.text.poskeys, np.ndarray)
        assert isinstance(seg.tags["tagf"].doc_ids, np.ndarray)
        assert isinstance(seg.alive, torch.Tensor)
    assert not hot.segments[0].cold


@pytest.mark.parametrize("q", QUERIES)
def test_cold_matches_hot_and_jax(ixs, q):
    jcold, colds, hot = ixs
    rh = hot.search(q, num=25)
    rj = jcold.search(q, num=25)
    for cold in colds:
        rc = cold.search(q, num=25)
        _same(rc, rh, q)
        _same(rc, rj, q)


def test_cold_sort_and_scorers(ixs):
    jcold, colds, hot = ixs
    for cold in colds:
        for kw in [dict(sort_by="num", sort_asc=False),
                   dict(scorer="TFIDF"), dict(scorer="BM25"),
                   dict(scorer="DISMAX")]:
            q = "w00" if "sort_by" in kw else "w01 w02"
            rc = cold.search(q, num=15, **kw)
            _same(rc, hot.search(q, num=15, **kw), kw)
            _same(rc, jcold.search(q, num=15, **kw), kw)


@pytest.mark.parametrize("slop,inorder", [(0, True), (2, True), (1, False)])
def test_cold_slop_and_inorder(ixs, slop, inorder):
    jcold, colds, hot = ixs
    for cold in colds:
        rc = cold.search("w00 w03", num=20, slop=slop, inorder=inorder)
        _same(rc, hot.search("w00 w03", num=20, slop=slop,
                             inorder=inorder), (slop, inorder))
        _same(rc, jcold.search("w00 w03", num=20, slop=slop,
                               inorder=inorder), (slop, inorder))


def test_cold_batched_and_aggregate(ixs):
    jcold, colds, hot = ixs
    qs = ["w00 w01", "w02 w03", '"w04 w05"', "@tagf:{y} -w06"]
    mh = hot.search_many(qs, k=10)
    mj = jcold.search_many(qs, k=10)
    for cold in colds:
        TE.QUERY_PATH_STATS.clear()
        mc = cold.search_many(qs, k=10)
        assert TE.QUERY_PATH_STATS == {"cold": len(qs)}
        for q, c, h, j in zip(qs, mc, mh, mj):
            _same(c, h, q)
            _same(c, j, q)

    def req(p, key):
        return (p.AggregateRequest("w00")
                .group_by(key, ("COUNT", [], "cnt"), ("SUM", ["@num"], "s"))
                .sort_by(key))

    for key in ("@tagf", "@num"):
        rj = jcold.aggregate(req(rs, key))
        rh = hot.aggregate(req(rt, key))
        for cold in colds:
            TP.AGG_PATH_STATS.clear()
            outs = [cold.aggregate(req(rt, key))] + cold.aggregate_many(
                [req(rt, key), req(rt, key)])
            # an unsortable TAG key runs the host pipeline, a numeric one
            # the device GROUPBY over the paged window
            want = "host" if key == "@tagf" else "device"
            assert TP.AGG_PATH_STATS == {want: 3}, TP.AGG_PATH_STATS
            for rc in outs:
                assert rc.rows == rj.rows == rh.rows
                assert rc.total == rj.total


def test_cold_memory_stays_host(ixs):
    """The index's device holds no CSR array of a cold segment: its
    device bytes are the hot segment's minus the CSR arrays."""
    _j, colds, hot = ixs
    hseg = hot.segments[0]
    cache, hseg._pcode_cache = hseg._pcode_cache, {}   # the kernels' cache
    hot_bytes = hseg.memory_bytes()
    hseg._pcode_cache = cache
    for cold in colds:
        seg = cold.segments[0]
        tx = seg.text
        csr = sum(a.nbytes for a in (tx.term_offsets, tx.doc_ids, tx.freqs,
                                     tx.field_masks, tx.doclens,
                                     tx.pos_offsets, tx.poskeys))
        csr += sum(t.offsets.nbytes + t.doc_ids.nbytes
                   for t in seg.tags.values())
        assert seg.host_bytes() == csr > 0
        assert seg.memory_bytes() == hot_bytes - csr
        for t in (tx.doc_ids, tx.freqs, tx.poskeys,
                  seg.tags["tagf"].doc_ids):
            assert not isinstance(t, torch.Tensor)


@pytest.mark.parametrize("q", QUERIES[:9] + ['@b:"w01 w02"'])
def test_cold_slab_args_match_jax(ixs, q):
    """The slabs the port's program sees are the JAX package's: the same
    rewritten dyn (term and tag starts), slab lengths and contents."""
    jcold, colds, _hot = ixs
    conv = colds[1]            # the JAX segment carried across
    jseg, tseg = jcold.segments[0], conv.segments[0]
    jcq = jcold.prepare(q, None, JE.QueryOptions(k=10), 2)
    tcq = conv.prepare(q, None, TE.QueryOptions(k=10), 2)
    outs = []
    for cq, seg, fn in ((jcq, jseg, JE._cold_slab_args),
                        (tcq, tseg, TE._cold_slab_args)):
        binding, _P = cq.bind(seg)
        dyn = dict(binding.dyn)
        dyn.pop("_tagL", None)
        buckets = dyn.pop("_buckets")
        outs.append(fn(cq, seg, dyn, buckets))
    (ja, jd, jsig), (ta, td, tsig) = outs
    assert tsig == jsig
    assert sorted(td) == sorted(jd)
    for key in jd:
        np.testing.assert_array_equal(np.asarray(td[key]),
                                      np.asarray(jd[key]), err_msg=key)
    for key in ("doc_ids", "freqs", "field_masks", "posting_dl",
                "pos_offsets", "poskeys") + tuple(
                    k for k in ja if k.startswith("tag")):
        a = np.asarray(ja[key])
        b = ta[key].numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("q", ['"nosuch1 nosuch2"', '"w00 nosuch2"'])
def test_cold_phrase_with_an_absent_term(ixs, q):
    """A phrase of terms the segment lacks: the JAX package's cold path
    slices a 2,048-lane position window out of a 1,024-lane slab and
    raises when no term of the phrase has postings; the port answers as
    the hot index (no match)."""
    jcold, colds, hot = ixs
    if q.startswith('"nosuch1'):
        with pytest.raises(TypeError):
            jcold.search(q)
    else:
        _same(jcold.search(q), hot.search(q), q)
    rh = hot.search(q)
    assert rh.total == 0
    for cold in colds:
        _same(cold.search(q), rh, q)
