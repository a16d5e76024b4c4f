"""IVF vector search in the torch port against the JAX package, on the CPU.

`ops/ivf.py` function by function: `kmeans_step` and `train_kmeans`
(on clusters set well apart: equal assignments, centroids within 1e-4
relative — the two sum in f32 in different orders), the bucket layout
(`IVFIndex.build`, `HostIVF.build` with the JAX package's centroids
carried across: every array equal byte for byte), `ivf_probe_arrays`
with and without a candidate window, `ivf_probe_batch` (one chunk and
many), then IVF fields through `SearchIndex.search` / `search_many`
(pure, filtered by text, TAG and NUMERIC, HYBRID_POLICY BATCHES and
ADHOC_BF, EF_RUNTIME) on the JAX segment carried across by
`convert.segment_from_jax` and on the port's own segment with the JAX
centroids: every batch of IVF queries rides "window".

Equal: ids and their order (ties by the lowest lane), totals; distances
within 1e-5 (rtol and atol), scores within rtol 1e-5.

The JAX package's `search_many` serves a batch of pure KNN queries on an
IVF field with its exact FLAT scan (`_pure_knn_eligible` does not check
for IVF) while its `search` probes the lists, so the two disagree below
nprobe = nlist; the port's batch probes, as `search` does.  The batched
cases compare the port's batch with the JAX package's `search`.
"""

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.ops import ivf as JI
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.ops import ivf as TI
from redisearch_tpu_torch.query import engine as TE

RTOL = ATOL = 1e-5
METRICS = ["L2", "IP", "COSINE"]


def _clusters(n_per=150, c=6, d=12, seed=0, spread=20.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d)) * spread
    x = np.concatenate([ctr + rng.normal(size=(n_per, d))
                        for ctr in centers]).astype(np.float32)
    return x, centers


def test_kmeans_step_matches_jax():
    x, centers = _clusters()
    init = (centers + 3.0).astype(np.float32)
    jn, ja, js = JI.kmeans_step(x, init)
    tn, ta, ts = TI.kmeans_step(torch.from_numpy(x), torch.from_numpy(init))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)


@pytest.mark.parametrize("sample", [262144, 500])
def test_train_kmeans_matches_jax(sample):
    """The same sample and initial rows (the numpy generator's), then
    Lloyd steps: the same assignment of every row."""
    x, _ = _clusters(seed=1)
    jc = JI.train_kmeans(x, 6, iters=20, sample=sample)
    tc = TI.train_kmeans(x, 6, iters=20, sample=sample)
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)

    def assign(c):
        return np.argmax(2 * x @ c.T - (c * c).sum(1), axis=1)
    np.testing.assert_array_equal(assign(tc), assign(jc))


def test_kmeans_converges():
    """tests/test_ivf.py::test_kmeans_converges on the port."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 8)) * 10
    x = np.concatenate([c + rng.normal(size=(100, 8)) for c in centers])
    cents = TI.train_kmeans(x.astype(np.float32), 4, iters=20)
    for c in centers:
        assert np.min(((cents - c) ** 2).sum(1)) < 4.0


def _data(n=3000, d=24, seed=2):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    present = rng.random(n) > 0.05
    return v, present


@pytest.mark.parametrize("metric", METRICS)
def test_bucket_layout_matches_jax(metric):
    v, present = _data()
    j = JI.IVFIndex.build(v, present, metric, nlist=20)
    cents = np.asarray(j.centroids)
    t = TI.IVFIndex.build(v, present, metric, centroids=cents)
    for name in ("centroids", "cent_sq", "bucket_vecs", "bucket_sq",
                 "bucket_ids"):
        a = np.asarray(getattr(j, name))
        b = getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (t.nlist, t.list_pad, t.dim) == (j.nlist, j.list_pad, j.dim)
    jh = JI.HostIVF.build(v, present, metric, centroids=cents)
    th = TI.HostIVF.build(v, present, metric, centroids=cents)
    for name in ("bucket_vecs", "bucket_sq", "bucket_ids"):
        assert getattr(th, name).tobytes() == getattr(jh, name).tobytes()
    assert th.host_bytes() == jh.host_bytes()
    assert t.memory_bytes() == j.memory_bytes()


def _pair(metric, nlist=16):
    v, present = _data()
    j = JI.IVFIndex.build(v, present, metric, nlist=nlist)
    t = TI.IVFIndex.build(v, present, metric,
                          centroids=np.asarray(j.centroids))
    return v, j, t


def _same_knn(jd, ji, td, ti, what):
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    live = jd < 3.3e38
    np.testing.assert_array_equal(ti[live], ji[live], err_msg=what)
    np.testing.assert_array_equal(td >= 3.3e38, ~live, err_msg=what)
    np.testing.assert_allclose(td[live], jd[live], rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_probe_arrays_matches_jax(metric):
    v, j, t = _pair(metric)
    rng = np.random.default_rng(3)
    cand = np.sort(rng.choice(v.shape[0], 700, replace=False)).astype(
        np.int32)
    cand = np.concatenate([cand, np.full(324, 2**31 - 1, np.int32)])
    cval = np.zeros(cand.shape, bool)
    cval[:600] = True                      # the last 100 docs are invalid
    for i in range(4):
        q = rng.normal(size=v.shape[1]).astype(np.float32)
        for nprobe in (1, 5, 16):
            jd, ji = JI.ivf_probe_arrays(
                j.centroids, j.cent_sq, j.bucket_vecs, j.bucket_sq,
                j.bucket_ids, metric, q, 10, nprobe)
            td, ti = TI.ivf_probe_arrays(
                t.centroids, t.cent_sq, t.bucket_vecs, t.bucket_sq,
                t.bucket_ids, metric, torch.from_numpy(q), 10, nprobe)
            _same_knn(jd, ji, td, ti, (metric, i, nprobe))
            jd, ji = JI.ivf_probe(j, q, 10, nprobe, cand=(cand, cval))
            td, ti = TI.ivf_probe(t, torch.from_numpy(q), 10, nprobe,
                                  cand=(torch.from_numpy(cand),
                                        torch.from_numpy(cval)))
            _same_knn(jd, ji, td, ti, (metric, i, nprobe, "cand"))
            kept = set(cand[:600].tolist())
            assert all(int(x) in kept for x, d in zip(ti, td) if d < 3e38)


@pytest.mark.parametrize("budget", [1 << 28, 1 << 18],
                         ids=["one-chunk", "chunked"])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_probe_batch_matches_jax(metric, budget, monkeypatch):
    v, j, t = _pair(metric)
    monkeypatch.setattr(TI, "_TILE_BUDGET", budget)
    Q = np.random.default_rng(4).normal(size=(37, v.shape[1])).astype(
        np.float32)
    jd, ji = JI.ivf_probe_batch(j, Q, 8, 4)
    td, ti = TI.ivf_probe_batch(t, torch.from_numpy(Q), 8, 4)
    assert td.shape == (37, 8)
    _same_knn(jd, ji, td, ti, (metric, budget))


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_recall(metric):
    """tests/test_ivf.py::test_ivf_recall on the port (its own k-means)."""
    rng = np.random.default_rng(1)
    n, d, k = 4000, 32, 10
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ivf = TI.IVFIndex.build(vecs, np.ones(n, bool), metric, nlist=64)
    rec = []
    for _ in range(20):
        q = rng.normal(size=d).astype(np.float32)
        _, ids = TI.ivf_probe(ivf, torch.from_numpy(q), k, nprobe=32)
        if metric == "L2":
            dist = ((vecs - q) ** 2).sum(1)
        elif metric == "IP":
            dist = 1.0 - vecs @ q
        else:
            vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
            dist = 1.0 - vn @ (q / np.linalg.norm(q))
        truth = set(np.argsort(dist, kind="stable")[:k].tolist())
        rec.append(len(set(ids.tolist()) & truth) / k)
    assert np.mean(rec) >= 0.9


N, D = 2500, 16


def _fields(p, algo="IVF", nprobe=4):
    F, T = p.Field, p.FieldType
    return [F("t", T.TEXT), F("c", T.TAG), F("p", T.NUMERIC),
            F("v", T.VECTOR, vector=p.VectorParams(
                dim=D, metric="L2", algo=algo, nlist=24, nprobe=nprobe,
                flat_buffer_limit=100))]


@pytest.fixture(scope="module")
def idx():
    """The JAX index; the port over its segment (`segment_from_jax`);
    the port's own segment (bulk path, `_build_ann`) with its IVF
    rebuilt on the JAX centroids."""
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    words = ["alpha", "beta", "gamma", "delta"]
    docs = [(f"d{i}", {"t": " ".join(rng.choice(words, 2)),
                       "c": f"c{i % 5}", "p": float(i % 60), "v": vecs[i]})
            for i in range(N)]
    jix = rs.SearchIndex(rs.Schema(name="iv", fields=_fields(rs)))
    jix.add_documents(docs)
    cix = rt.SearchIndex(rt.Schema(name="iv", fields=_fields(rt)),
                         device="cpu")
    cix.add_documents(docs)
    cix.segments = [segment_from_jax(jix.segments[0], "cpu")]
    tix = rt.SearchIndex(rt.Schema(name="iv", fields=_fields(rt)),
                         device="cpu")
    tix.add_documents(docs)
    col = tix.segments[0].vectors["v"]
    assert col.ivf is not None and col.ivf.nlist == 24
    jcol = jix.segments[0].vectors["v"]
    col.ivf = TI.IVFIndex.build(
        col.vecs.numpy(), col.present.numpy(), "L2",
        centroids=np.asarray(jcol.ivf.centroids))
    return jix, cix, tix, vecs


def _same(j, t, what):
    assert t.total == j.total, (what, j.total, t.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=RTOL,
                               atol=1e-7, err_msg=str(what))
    np.testing.assert_allclose([h.vector_distance for h in t.hits],
                               [h.vector_distance for h in j.hits],
                               rtol=RTOL, atol=ATOL, err_msg=str(what))


IVF_QUERIES = [
    "*=>[KNN 10 @v $b]",
    "*=>[KNN 10 @v $b EF_RUNTIME 12]",
    "(alpha)=>[KNN 10 @v $b]",
    "(@c:{c1})=>[KNN 10 @v $b]",
    "(@p:[10 20])=>[KNN 10 @v $b]",
    "(@c:{c2} -beta)=>[KNN 10 @v $b HYBRID_POLICY BATCHES]",
    "(gamma)=>[KNN 10 @v $b HYBRID_POLICY ADHOC_BF]",
]


@pytest.mark.parametrize("q", IVF_QUERIES)
def test_ivf_search_matches_jax(idx, q):
    jix, cix, tix, vecs = idx
    qv = np.random.default_rng(7).normal(size=(3, D)).astype(np.float32)
    params = [{"b": qv[i]} for i in range(3)]
    js = [jix.search(q, params=p) for p in params]
    for ix in (cix, tix):
        TE.QUERY_PATH_STATS.clear()
        batch = ix.search_many([q] * 3, params=params, k=10)
        assert TE.QUERY_PATH_STATS == {"window": 3}, TE.QUERY_PATH_STATS
        for i, (j, p) in enumerate(zip(js, params)):
            _same(j, ix.search(q, params=p), (q, i))
            assert [h.key for h in batch[i].hits] == [
                h.key for h in j.hits], (q, i)


def test_jax_pure_ivf_batch_is_exact_flat(idx):
    """The JAX package's difference between its entry points: pure KNN
    batches on an IVF field take its exact scan, so at nprobe 4 of 24 its
    `search_many` finds neighbours its `search` (and the port's batch)
    does not probe."""
    jix, cix, _tix, vecs = idx
    qv = np.random.default_rng(8).normal(size=(16, D)).astype(np.float32)
    params = [{"b": qv[i]} for i in range(16)]
    q = "*=>[KNN 10 @v $b]"
    jm = [[h.key for h in r.hits] for r in
          jix.search_many([q] * 16, params=params, k=10)]
    js = [[h.key for h in jix.search(q, params=p).hits] for p in params]
    tm = [[h.key for h in r.hits] for r in
          cix.search_many([q] * 16, params=params, k=10)]
    exact = []
    for p in params:
        d = ((vecs - p["b"]) ** 2).sum(1)
        exact.append([f"d{i}" for i in np.argsort(d, kind="stable")[:10]])
    assert jm == exact
    assert tm == js and tm != jm


def test_flat_buffer_limit_and_memory():
    """tests/test_ivf.py::test_tiered_small_segment_stays_flat: a segment
    under flat_buffer_limit keeps the exact scan; over it, the IVF
    arrays count in the segment's device bytes."""
    rng = np.random.default_rng(4)
    small = rt.SearchIndex(rt.Schema(name="tier", fields=[
        rt.Field("v", rt.FieldType.VECTOR, vector=rt.VectorParams(
            dim=8, algo="TIERED", metric="L2", flat_buffer_limit=1000))]),
        device="cpu")
    for i in range(50):
        small.add_document(f"d{i}", {"v": rng.normal(size=8)
                                     .astype(np.float32)})
    small.commit()
    assert small.segments[0].vectors["v"].ivf is None
    res = small.search("*=>[KNN 3 @v $q]", params={"q": np.zeros(8,
                                                                 np.float32)})
    assert len(res.hits) == 3
    big = rt.SearchIndex(rt.Schema(name="big", fields=_fields(rt)),
                         device="cpu")
    big.add_documents([(f"d{i}", {"v": rng.normal(size=D)
                                  .astype(np.float32)})
                       for i in range(300)])
    seg = big.segments[0]
    ivf = seg.vectors["v"].ivf
    assert ivf is not None and ivf.nlist == 24
    assert seg.memory_bytes() >= ivf.memory_bytes()
