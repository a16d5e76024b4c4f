"""Host-tier vector fields (VectorParams.storage="host") in the torch port
against the JAX package, on the CPU.

The cases of tests/test_host_tier.py that need neither deletes and
compaction (tests/test_torch_lifecycle.py and test_torch_checkpoint.py
hold those) nor the wire server (tests/test_torch_server.py holds its
FT.CREATE case): the column stays in
host memory with its HostIVF, pure KNN at nprobe = nlist equals the
exact neighbours, a partial probe, TEXT- and NUMERIC-filtered KNN, a
stemmed-union filter window, batched KNN equal to single calls, FT.
AGGREGATE over a KNN source, and the refusals (VECTOR_RANGE on the host
tier, multi-value documents).  Both packages index the same documents;
the port serves the JAX segment carried across by
`convert.segment_from_jax` and its own segment with the JAX package's
centroids, so both probe the same lists.  Every batch rides "knn-host".

Equal: totals, keys and their order; distances within rtol 1e-5 and
atol 1e-5 * dim.  Both packages take an L2 distance as ||x||^2 - 2x.q +
||q||^2 in f32, summing in different orders; with squared norms near
dim, a distance near 0 (these queries sit 0.01 from a document) keeps a
few ulp of dim from that cancellation.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.ops import ivf as TI
from redisearch_tpu_torch.query import engine as TE

RTOL = 1e-5
ATOL = 1e-5 * 16


def _mk_index(p, n=600, dim=16, metric="L2", nlist=16, seed=3,
              bulk=False):
    """tests/test_host_tier.py's index."""
    schema = p.Schema(name=f"ht_{metric}", fields=[
        p.Field("t", p.FieldType.TEXT),
        p.Field("price", p.FieldType.NUMERIC),
        p.Field("v", p.FieldType.VECTOR,
                vector=p.VectorParams(dim=dim, metric=metric,
                                      algo=p.VectorAlgo.IVF, nlist=nlist,
                                      nprobe=nlist, flat_buffer_limit=1,
                                      storage="host"))])
    ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(schema,
                                                             device="cpu")
    vecs = np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)
    docs = [(f"d{i}", {"t": "even" if i % 2 == 0 else "odd",
                       "price": float(i), "v": vecs[i]}) for i in range(n)]
    if bulk:
        ix.add_documents(docs)
    else:
        for k, f in docs:
            ix.add_document(k, f)
        ix.commit()
    return ix, vecs


def _on_jax_centroids(tix, jix, attr="v"):
    col = tix.segments[0].vectors[attr]
    jh = jix.segments[0].vectors[attr].host_ivf
    col.host_ivf = TI.HostIVF.build(col.vecs, col.present.numpy(),
                                    jh.metric,
                                    centroids=np.asarray(jh.centroids))


@pytest.fixture(scope="module", params=["L2", "COSINE"])
def idx(request):
    metric = request.param
    jix, vecs = _mk_index(rs, metric=metric)
    tix, _ = _mk_index(rt, metric=metric)
    bix, _ = _mk_index(rt, metric=metric, bulk=True)
    cix, _ = _mk_index(rt, metric=metric)
    cix.segments = [segment_from_jax(jix.segments[0], "cpu")]
    _on_jax_centroids(tix, jix)
    _on_jax_centroids(bix, jix)
    return jix, (tix, bix, cix), vecs


def _same(j, t, what):
    assert t.total == j.total, (what, j.total, t.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.vector_distance for h in t.hits],
                               [h.vector_distance for h in j.hits],
                               rtol=RTOL, atol=ATOL, err_msg=str(what))


def test_host_tier_builds_host_resident(idx):
    jix, ports, _v = idx
    for tix in ports:
        seg = tix.segments[0]
        col = seg.vectors["v"]
        assert col.host and isinstance(col.vecs, np.ndarray)
        assert isinstance(col.host_ivf.bucket_vecs, np.ndarray)
        assert col.host_ivf.centroids.device.type == "cpu"
        # the device holds `present` and the centroids only; the vectors
        # and slabs count as host bytes
        assert seg.host_bytes() == (col.vecs.nbytes + col.sq_norms.nbytes
                                    + col.host_ivf.host_bytes())
        with_col = seg.memory_bytes()
        seg.vectors = {}
        try:
            assert with_col - seg.memory_bytes() == (
                col.present.numel() + col.host_ivf.device_bytes())
        finally:
            seg.vectors = {"v": col}
    assert jix.segments[0].vectors["v"].host


QUERIES = [
    "*=>[KNN 10 @v $b]",
    "*=>[KNN 5 @v $b EF_RUNTIME 4]",
    "(even)=>[KNN 8 @v $b]",
    "@price:[100 199]=>[KNN 8 @v $b]",
    "(odd @price:[300 599])=>[KNN 6 @v $b EF_RUNTIME 6]",
]


@pytest.mark.parametrize("q", QUERIES)
def test_host_tier_knn_matches_jax(idx, q):
    jix, ports, vecs = idx
    params = [{"b": (vecs[i] + 0.01).tobytes()} for i in (7, 11, 20, 30)]
    k = int(q.split("KNN ")[1].split()[0])
    js = [jix.search(q, params=p) for p in params]
    for tix in ports:
        TE.QUERY_PATH_STATS.clear()
        many = tix.search_many([q] * 4, params=params, k=k)
        assert TE.QUERY_PATH_STATS == {"knn-host": 4}
        for i, (j, p) in enumerate(zip(js, params)):
            _same(j, tix.search(q, params=p), (q, i))
            assert [h.key for h in many[i].hits] == [h.key for h in j.hits]


def test_host_tier_pure_knn_matches_exact(idx):
    """At nprobe == nlist the probe covers every list: host-tier KNN
    returns the exact neighbours (tests/test_host_tier.py), and the
    partial probe's distances are true distances."""
    jix, ports, vecs = idx
    q = vecs[7] + 0.01
    if ports[0].schema.field("v").vector.metric.value == "L2":
        d = ((vecs - q[None, :]) ** 2).sum(1)
    else:
        d = 1.0 - (vecs @ q) / (np.linalg.norm(vecs, axis=1)
                                * np.linalg.norm(q))
    for tix in ports:
        res = tix.search("*=>[KNN 10 @v $b]", params={"b": q.tobytes()})
        assert [h.key for h in res.hits] == [
            f"d{i}" for i in np.argsort(d)[:10]]
        res = tix.search("*=>[KNN 5 @v $b EF_RUNTIME 4]",
                         params={"b": q.tobytes()})
        for h in res.hits:
            assert abs(h.vector_distance - d[int(h.key[1:])]) < 1e-2
        assert res.hits[0].key == f"d{np.argsort(d)[0]}"


def test_host_tier_batch_matches_single(idx):
    """tests/test_host_tier.py::test_host_tier_batch_matches_single: one
    `execute_batch` of 9 queries (one shared probe, gather and scan)
    equals the single calls, in both packages."""
    from redisearch_tpu.query import engine as JE
    jix, ports, _v = idx
    qs = np.random.default_rng(0).normal(size=(9, 16)).astype(np.float32)
    for tix, ix_p, eng in [(t, rt, TE) for t in ports] + [(jix, rs, JE)]:
        seg = tix.segments[0]
        cqs = [tix.prepare("*=>[KNN 6 @v $b]", {"b": qs[i].tobytes()},
                           eng.QueryOptions(k=6), 2) for i in range(9)]
        batch = eng.execute_batch(cqs, seg, 6)
        for i in range(9):
            single = tix.search("*=>[KNN 6 @v $b]",
                                params={"b": qs[i].tobytes()})
            got = [tix.doctable.get(int(seg.gids_host[j])).key
                   for j in batch[i].local_idx[:len(single.hits)]]
            assert got == [h.key for h in single.hits]


def test_host_tier_rejects_vector_range_and_window(idx):
    """VECTOR_RANGE needs the whole matrix on the device, and a window
    program cannot page slabs: both packages refuse."""
    from redisearch_tpu.utils.errors import RSError as JErr
    from redisearch_tpu_torch.utils.errors import RSError as TErr
    jix, ports, vecs = idx
    with pytest.raises(JErr):
        jix.search("@v:[VECTOR_RANGE 0.5 $b]",
                   params={"b": vecs[0].tobytes()})
    for tix in ports:
        with pytest.raises(TErr):
            tix.search("@v:[VECTOR_RANGE 0.5 $b]",
                       params={"b": vecs[0].tobytes()})
        cq = tix.prepare("*=>[KNN 3 @v $b]", {"b": vecs[0].tobytes()},
                         TE.QueryOptions(k=3), 2)
        with pytest.raises(TErr):
            TE.execute(cq, tix.segments[0], 3, mode="window")


def test_host_tier_rejects_multivalue():
    for p in (rs, rt):
        schema = p.Schema(name="ht_mv", fields=[
            p.Field("v", p.FieldType.VECTOR,
                    vector=p.VectorParams(dim=4, multi=True,
                                          storage="host"))])
        ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(
            schema, device="cpu")
        ix.add_document("a", {"v": [np.ones(4, np.float32),
                                    np.zeros(4, np.float32)]})
        with pytest.raises(ValueError):
            ix.commit()


def test_host_tier_filtered_knn_stemmed_union_window():
    """tests/test_host_tier.py: a stem-expanded filter's union window
    carries duplicate docs; the candidate compaction dedups them."""
    out = []
    for p in (rs, rt):
        schema = p.Schema(name="ht_stem", fields=[
            p.Field("t", p.FieldType.TEXT),
            p.Field("v", p.FieldType.VECTOR,
                    vector=p.VectorParams(dim=8, metric="L2",
                                          algo=p.VectorAlgo.IVF, nlist=4,
                                          nprobe=4, storage="host"))])
        ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(
            schema, device="cpu")
        rng = np.random.default_rng(7)
        vecs = rng.normal(size=(200, 8)).astype(np.float32)
        for i in range(200):
            ix.add_document(f"d{i}", {"t": "apples taste great" if i % 3
                                      else "bananas rule", "v": vecs[i]})
        ix.commit()
        q = vecs[10] + 0.01
        res = ix.search("(apple)=>[KNN 6 @v $b]",
                        params={"b": q.astype(np.float32).tobytes()})
        d = ((vecs - q[None, :]) ** 2).sum(1)
        expect = [f"d{i}" for i in np.argsort(d) if i % 3][:6]
        assert [h.key for h in res.hits] == expect
        out.append(res)
    _same(out[0], out[1], "stemmed union")


def test_host_tier_aggregation_over_knn(idx):
    """FT.AGGREGATE over a host-tier KNN source (mode "topk"): equal rows
    in both packages, single and batched (path "knn")."""
    jix, ports, vecs = idx
    q = vecs[3].tobytes()

    def req(p):
        return (p.AggregateRequest("*=>[KNN 20 @v $b]", params={"b": q})
                .group_by("@t", ("COUNT", [], "cnt"))
                .sort_by("@t"))

    j = jix.aggregate(req(rs))
    assert sum(int(r["cnt"]) for r in j.rows) == 20
    for tix in ports:
        TP.AGG_PATH_STATS.clear()
        t = tix.aggregate(req(rt))
        many = tix.aggregate_many([req(rt)])
        assert TP.AGG_PATH_STATS == {"knn": 2}
        for r in (t, many[0]):
            assert r.rows == j.rows and r.total == j.total


def test_bulk_path_keeps_host_storage():
    """The port's bulk path seals a `storage="host"` field into the host
    tier, as both packages' incremental builders do; the JAX package's
    bulk seal puts it on the device as a FLAT column (its
    `make_vector_column` call there passes no `host`)."""
    jix, _ = _mk_index(rs, n=200, bulk=True)
    tix, _ = _mk_index(rt, n=200, bulk=True)
    jcol = jix.segments[0].vectors["v"]
    tcol = tix.segments[0].vectors["v"]
    assert not jcol.host and jcol.host_ivf is None
    assert tcol.host and tcol.host_ivf is not None
