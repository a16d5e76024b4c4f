"""LVQ8 compressed host-tier vectors in the torch port against the JAX
package, on the CPU.

`ops/lvq.py`: `lvq_encode`, `lvq_decode` and `lvq_sq_norms` equal to the
JAX functions byte for byte; `scan_tiles_lvq` and `scan_slab_lvq`
(filtered and unfiltered, with a liveness mask) against the JAX
functions on the same gathered slab; `HostIVF.build_lvq` with the JAX
centroids laid out byte for byte as the JAX one; `host_ivf_knn` over
LVQ8 slabs; then the cases of tests/test_lvq.py: the quantization error
bound, recall parity with the uncompressed tier, distances exact against
the reconstruction, the host-memory ratio, and LVQ8 KNN through the
port's entry points against the JAX package (path "knn-host").

Equal: ids and their order; distances within 1e-5 (rtol and atol).
"""

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.ops import ivf as JI
from redisearch_tpu.ops import lvq as JL
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.ops import ivf as TI
from redisearch_tpu_torch.ops import lvq as TL
from redisearch_tpu_torch.query import engine as TE

RTOL = ATOL = 1e-5
METRICS = ["L2", "IP", "COSINE"]


def test_encode_decode_norms_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(300, 40)).astype(np.float32)
    v[7] = 2.5                                       # a constant row
    slab = rng.normal(size=(4, 16, 12)).astype(np.float32)
    for x in (v, slab):
        jc = JL.lvq_encode(x)
        tc = TL.lvq_encode(x)
        for a, b in zip(jc, tc):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (TL.lvq_decode(*tc).tobytes()
                == np.asarray(JL.lvq_decode(*jc)).tobytes())
        assert (TL.lvq_sq_norms(*tc).tobytes()
                == JL.lvq_sq_norms(*jc).tobytes())


def test_encode_decode_error_bound():
    """tests/test_lvq.py::test_encode_decode_error_bound on the port."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(256, 64)).astype(np.float32)
    codes, off, scl = TL.lvq_encode(v)
    assert codes.dtype == np.uint8
    recon = TL.lvq_decode(codes, off, scl)
    assert np.all(np.abs(recon - v) <= scl[:, None] / 2 + 1e-6)
    const = np.full((3, 16), 2.5, np.float32)
    assert np.allclose(TL.lvq_decode(*TL.lvq_encode(const)), const)


def _slab(seed, U=6, L=128, d=16, B=9, nprobe=3, n_docs=1000):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(U, L, d)).astype(np.float32)
    c, o, s = TL.lvq_encode(v)
    sq = TL.lvq_sq_norms(c, o, s)
    ids = rng.permutation(n_docs)[:U * L].reshape(U, L).astype(np.int32)
    ids[:, -20:] = -1                                # padded lanes
    rowmap = np.stack([rng.choice(U, nprobe, replace=False)
                       for _ in range(B)]).astype(np.int32)
    Q = rng.normal(size=(B, d)).astype(np.float32)
    cand = np.stack([np.sort(rng.choice(n_docs, 200, replace=False))
                     for _ in range(B)]).astype(np.int32)
    cval = rng.random(cand.shape) > 0.2
    ok = rng.random(n_docs) > 0.1
    return c, o, s, sq, ids, rowmap, Q, cand, cval, ok


def _same_knn(jd, ji, td, ti, what):
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = np.asarray(td), np.asarray(ti)
    live = jd < 3.3e38
    np.testing.assert_array_equal(ti[live], ji[live], err_msg=str(what))
    np.testing.assert_array_equal(td >= 3.3e38, ~live, err_msg=str(what))
    np.testing.assert_allclose(td[live], jd[live], rtol=RTOL, atol=ATOL,
                               err_msg=str(what))


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["pure", "cand+ok"])
@pytest.mark.parametrize("metric", METRICS)
def test_scan_slab_lvq_matches_jax(metric, filtered):
    c, o, s, sq, ids, rowmap, Q, cand, cval, ok = _slab(1)
    B = Q.shape[0]
    jcd = cand if filtered else np.zeros((B, 1), np.int32)
    jcv = cval if filtered else np.zeros((B, 1), bool)
    jok = ok if filtered else np.ones(1, bool)
    jd, ji = JL.scan_slab_lvq(c, o, s, sq, ids, rowmap, Q, 10, metric,
                              jcd, jcv, jok, filtered, filtered)
    t = torch.from_numpy
    td, ti = TL.scan_slab_lvq(
        t(c), t(o), t(s), t(sq), t(ids), t(rowmap), t(Q), 10, metric,
        t(cand) if filtered else None, t(cval) if filtered else None,
        t(ok) if filtered else None, filtered, filtered)
    _same_knn(jd, ji, td, ti, (metric, filtered))
    # scan_tiles_lvq: the same scan, one query's gathered tiles
    rm = rowmap[2]
    qf = Q[2] / (np.linalg.norm(Q[2]) if metric == "COSINE" else 1.0)
    jd1, ji1 = JL.scan_tiles_lvq(c[rm], o[rm], s[rm], sq[rm], ids[rm], qf,
                                 10, metric)
    td1, ti1 = TL.scan_tiles_lvq(t(c[rm]), t(o[rm]), t(s[rm]), t(sq[rm]),
                                 t(ids[rm]), t(qf), 10, metric)
    _same_knn(jd1, ji1, td1, ti1, (metric, "tiles"))


def _host_ivf_pair(metric, n=4000, d=32, seed=2):
    """tests/test_lvq.py's uncompressed and LVQ8 HostIVF over the same
    data and centroids, in both packages (the port on the JAX
    centroids)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    pres = np.ones(n, bool)
    jbase = JI.HostIVF.build(v, pres, metric, nlist=32)
    cents = np.asarray(jbase.centroids)
    codes, off, scl = TL.lvq_encode(v)
    jcomp = JI.HostIVF.build_lvq(codes, off, scl, pres, metric,
                                 centroids=cents)
    tbase = TI.HostIVF.build(v, pres, metric, centroids=cents)
    tcomp = TI.HostIVF.build_lvq(codes, off, scl, pres, metric,
                                 centroids=cents)
    return v, jbase, jcomp, tbase, tcomp


@pytest.mark.parametrize("metric", METRICS)
def test_host_ivf_lvq_matches_jax(metric):
    v, jbase, jcomp, tbase, tcomp = _host_ivf_pair(metric)
    assert tcomp.compression == "LVQ8"
    for name in ("bucket_vecs", "bucket_sq", "bucket_ids", "bucket_off",
                 "bucket_scl"):
        assert getattr(tcomp, name).tobytes() == \
            getattr(jcomp, name).tobytes(), name
    Q = np.random.default_rng(3).normal(size=(16, v.shape[1])).astype(
        np.float32)
    for hj, ht in ((jbase, tbase), (jcomp, tcomp)):
        jd, ji = JI.host_ivf_knn(hj, Q, 10, nprobe=8)
        td, ti = TI.host_ivf_knn(ht, Q, 10, nprobe=8)
        _same_knn(jd, ji, td, ti, (metric, ht.compression))
    # recall parity with the uncompressed tier (tests/test_lvq.py:72)
    _, ib = TI.host_ivf_knn(tbase, Q, 10, nprobe=8)
    _, ic = TI.host_ivf_knn(tcomp, Q, 10, nprobe=8)
    rec = np.mean([len(set(ib[i]) & set(ic[i])) / 10 for i in range(16)])
    assert rec >= 0.97, rec


def test_host_ivf_lvq_distances_exact_vs_recon():
    """tests/test_lvq.py: compressed scan distances equal brute-force
    distances against the reconstructed vectors."""
    v, _jb, _jc, _tb, comp = _host_ivf_pair("L2", n=1000, d=16, seed=4)
    recon = TL.lvq_decode(*TL.lvq_encode(v))
    Q = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)
    d_c, _ids = TI.host_ivf_knn(comp, Q, 5, nprobe=comp.nlist)
    for i in range(len(Q)):
        brute = ((recon - Q[i]) ** 2).sum(1)
        np.testing.assert_allclose(np.sort(d_c[i]),
                                   np.sort(brute)[:5], rtol=2e-4,
                                   atol=2e-4)


def test_memory_ratio():
    _, _jb, _jc, base, comp = _host_ivf_pair("L2", n=2000, d=128)
    assert base.host_bytes() / comp.host_bytes() >= 2.0
    assert comp.device_bytes() == base.device_bytes()


def _mk_index(p, compression="LVQ8"):
    """tests/test_lvq.py's 600-doc index."""
    rng = np.random.default_rng(6)
    d = 24
    vecs = rng.normal(size=(600, d)).astype(np.float32)
    schema = p.Schema(name="lvq", fields=[
        p.Field("tag", p.FieldType.TAG),
        p.Field("emb", p.FieldType.VECTOR,
                vector=p.VectorParams(dim=d, metric=p.VectorMetric.L2,
                                      storage="host", nlist=8,
                                      compression=compression))])
    ix = (p.SearchIndex(schema) if p is rs
          else p.SearchIndex(schema, device="cpu"))
    for i in range(600):
        ix.add_document(f"d{i}", {"tag": f"t{i % 3}", "emb": vecs[i]})
    ix.commit()
    return ix, vecs


@pytest.fixture(scope="module")
def lvq_idx():
    jix, vecs = _mk_index(rs)
    tix, _ = _mk_index(rt)
    cix, _ = _mk_index(rt)
    cix.segments = [segment_from_jax(jix.segments[0], "cpu")]
    # the port's own segment on the JAX centroids
    col = tix.segments[0].vectors["emb"]
    jcol = jix.segments[0].vectors["emb"]
    assert col.compression == "LVQ8" and col.vecs.dtype == np.uint8
    assert col.host_ivf is not None and col.host_ivf.nlist == 8
    col.host_ivf = TI.HostIVF.build_lvq(
        col.vecs, col.vq_off, col.vq_scl, col.present.numpy(), "L2",
        centroids=np.asarray(jcol.host_ivf.centroids))
    return jix, tix, cix, vecs


@pytest.mark.parametrize("q", [
    "*=>[KNN 5 @emb $b EF_RUNTIME 8]",
    "*=>[KNN 5 @emb $b EF_RUNTIME 3]",
    "(@tag:{t2})=>[KNN 5 @emb $b EF_RUNTIME 8]"])
def test_end_to_end_knn_compressed(lvq_idx, q):
    """tests/test_lvq.py::test_end_to_end_knn_compressed through both
    packages' `search` and `search_many`."""
    jix, tix, cix, vecs = lvq_idx
    params = [{"b": vecs[i] + 0.01} for i in (17, 40, 41)]
    for ix in (tix, cix):
        TE.QUERY_PATH_STATS.clear()
        many = ix.search_many([q] * 3, params=params, k=5)
        assert TE.QUERY_PATH_STATS == {"knn-host": 3}
        jm = jix.search_many([q] * 3, params=params, k=5)
        for p, t, j in zip(params, many, jm):
            js = jix.search(q, params=p)
            ts = ix.search(q, params=p)
            for a in (ts, t):
                assert [h.key for h in a.hits] == [h.key for h in js.hits]
                np.testing.assert_allclose(
                    [h.vector_distance for h in a.hits],
                    [h.vector_distance for h in js.hits], rtol=RTOL,
                    atol=ATOL)
            assert [h.key for h in j.hits] == [h.key for h in js.hits]
    r = tix.search("(@tag:{t2})=>[KNN 5 @emb $b EF_RUNTIME 8]",
                   params={"b": vecs[17] + 0.01})
    assert all(int(h.key[1:]) % 3 == 2 for h in r.hits)
    assert len(r.hits) == 5
