"""The port's `ops/vector.py` against `redisearch_tpu/ops/vector.py`, on
the CPU.

The same arrays, made from seeded numpy generators, go through both
modules (the JAX one runs eagerly, as its own tests run it): N = 3,000
rows at d = 64, 1,000 at d = 384 and 5,000 at d = 64 (rows past 4,096
lanes rank their candidates on a bf16 copy); metrics L2, IP and COSINE;
storage f32 with and without the bf16 scan copy (two-phase and
one-phase), bf16, f16, int8 and uint8; k = 1, 10 and 25; masks with
fewer valid rows than k; duplicated rows; `knn_scan_batches` over three
chunks; `range_query`; the query-blob decoder; `fast_top_k` ties.

Tolerances: f32 distances rtol 1e-5, atol 1e-6 (both sides sum in f32,
in different orders; L2 rows are unit-scale normals, IP and COSINE rows
unit vectors).  int8/uint8 dot products are exactly equal (the JAX
function sums in int32, the port in float64).  Result lanes: the live
lanes (distance below 3.3e38) are equal lane for lane wherever
neighbouring exact distances differ by more than the tolerance; within a
near-tie the lanes hold the same rows.  Exact ties (duplicated rows)
order by the lowest row first, as `lax.top_k` orders them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redisearch_tpu.ops import text as JT
from redisearch_tpu.ops import vector as JV
from redisearch_tpu_torch.ops import text as TT
from redisearch_tpu_torch.ops import vector as TV

RTOL, ATOL = 1e-5, 1e-6

JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
       "int8": jnp.int8, "uint8": jnp.uint8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16,
         "f16": torch.float16, "int8": torch.int8, "uint8": torch.uint8}


def _rows(rng, n, d, dtype, metric):
    """Rows and queries in a storage type: integers for int8/uint8,
    unit vectors for IP and COSINE, normals for L2."""
    if dtype == "int8":
        return rng.integers(-128, 128, size=(n, d)).astype(np.float32)
    if dtype == "uint8":
        return rng.integers(0, 256, size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if metric != "L2":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _columns(mat, dtype, scan=False):
    """(JAX column, port column): vecs in the storage type, sq_norms of
    the f32 values in float64 (the builders' rule), the bf16 scan copy."""
    sq = (mat.astype(np.float64) ** 2).sum(1).astype(np.float32)
    jv = jnp.asarray(mat, dtype=JNP[dtype])
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
        TORCH[dtype])
    jc = dict(vecs=jv, sq=jnp.asarray(sq),
              scan=jv.astype(jnp.bfloat16) if scan else None)
    tc = dict(vecs=tv, sq=torch.from_numpy(sq),
              scan=tv.to(torch.bfloat16) if scan else None)
    return jc, tc


def _queries(rng, B, d, dtype, metric):
    q = _rows(rng, B, d, dtype, metric)
    jq = jnp.asarray(q, dtype=JNP[dtype]) if dtype in ("int8", "uint8") \
        else jnp.asarray(q)
    tq = torch.from_numpy(np.asarray(jq).astype(np.float32)).to(
        TORCH[dtype]) if dtype in ("int8", "uint8") else torch.from_numpy(q)
    if dtype == "bf16":
        # decode_blob keeps bf16 queries as bf16 values
        jq = jq.astype(jnp.bfloat16)
        tq = tq.to(torch.bfloat16).float()
    return jq, tq


def _exact(mat, q, metric):
    """float64 distances [B, n] of the rows to the queries."""
    m, qq = mat.astype(np.float64), np.asarray(q, np.float64)
    if metric == "L2":
        return ((m[None] - qq[:, None]) ** 2).sum(-1)
    dots = qq @ m.T
    if metric == "IP":
        return 1.0 - dots
    return 1.0 - dots / (np.linalg.norm(m, axis=1)[None]
                         * np.linalg.norm(qq, axis=1)[:, None])


def _same_lanes(jd, ji, td, ti, exact, tol=1e-5):
    """Live lanes equal (see the module docstring); exact [B, n] float64
    distances decide which neighbours are near-ties."""
    jd, ji = np.asarray(jd, np.float64), np.asarray(ji)
    td, ti = np.asarray(td, np.float64), np.asarray(ti)
    assert jd.shape == td.shape
    live = jd < 3.3e38
    np.testing.assert_array_equal(td < 3.3e38, live)
    np.testing.assert_allclose(td[live], jd[live], rtol=RTOL, atol=ATOL)
    for b in range(jd.shape[0]):
        n_live = int(live[b].sum())
        e = exact[b, ji[b, :n_live]]
        scale = tol * (1.0 + np.abs(e))
        for j in range(n_live):
            near = ((j > 0 and abs(e[j] - e[j - 1]) <= scale[j])
                    or (j + 1 < n_live and abs(e[j + 1] - e[j]) <= scale[j]))
            if not near:
                assert ti[b, j] == ji[b, j], (b, j, ti[b], ji[b])
            else:      # a near-tie: the port's row is as close
                assert abs(exact[b, ti[b, j]] - e[j]) <= 2 * scale[j], (b, j)


@pytest.mark.parametrize("dtype,metric", [
    (dt, m) for dt in ("f32", "bf16", "f16", "int8", "uint8")
    for m in ("L2", "IP", "COSINE")])
def test_distances_to_matches_jax(dtype, metric):
    rng = np.random.default_rng(1)
    mat = _rows(rng, 3000, 64, dtype, metric)
    jc, tc = _columns(mat, dtype)
    jq, tq = _queries(rng, 6, 64, dtype, metric)
    jd = np.asarray(JV.distances_to(jc["vecs"], jc["sq"], jq, metric))
    td = TV.distances_to(tc["vecs"], tc["sq"], tq, metric).numpy()
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    j1 = np.asarray(JV.distances_to(jc["vecs"], jc["sq"], jq[2], metric))
    t1 = TV.distances_to(tc["vecs"], tc["sq"], tq[2], metric).numpy()
    np.testing.assert_allclose(t1, j1, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,fill", [
    ("int8", "max"), ("int8", "min"), ("int8", "random"),
    ("uint8", "max"), ("uint8", "random")])
def test_integer_dot_products_are_exact(dtype, fill):
    """At d = 512 and the extreme values the sums reach 2**23-2**25: the
    port's float64 products equal the JAX int32 sums exactly."""
    rng = np.random.default_rng(2)
    lo, hi = (-128, 127) if dtype == "int8" else (0, 255)
    if fill == "random":
        mat = rng.integers(lo, hi + 1, size=(300, 512)).astype(np.float32)
        q = rng.integers(lo, hi + 1, size=(4, 512)).astype(np.float32)
    else:
        v = hi if fill == "max" else lo
        mat = np.full((300, 512), v, np.float32)
        mat[1::2] = hi if v == lo else lo
        q = np.full((4, 512), v, np.float32)
    jc, tc = _columns(mat, dtype)
    jq = jnp.asarray(q, dtype=JNP[dtype])
    tq = torch.from_numpy(q).to(TORCH[dtype])
    js = np.asarray(JV._scores(jc["vecs"], jq))
    ts = TV._scores(tc["vecs"], tq).numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(TV._scores(tc["vecs"], tq[1]).numpy(),
                                  np.asarray(JV._scores(jc["vecs"], jq[1])))
    want = (q.astype(np.int64) @ mat.astype(np.int64).T).astype(np.float32)
    np.testing.assert_array_equal(ts, want)


# (storage, scan copy, metric, N, d): f32 two-phase with and without the
# scan copy, and every other storage one-phase
KNN_CASES = [("f32", True, "L2", 3000, 64),
             ("f32", False, "COSINE", 3000, 64),
             ("f32", True, "IP", 1000, 384), ("f32", True, "L2", 5000, 64),
             ("bf16", False, "COSINE", 3000, 64),
             ("f16", False, "L2", 1000, 384),
             ("int8", False, "L2", 3000, 64), ("uint8", False, "IP", 3000, 64)]


@pytest.mark.parametrize("k", [1, 10, 25])
@pytest.mark.parametrize("case", KNN_CASES,
                         ids=[f"{c[0]}{'-scan' if c[1] else ''}-{c[2]}-{c[3]}"
                              for c in KNN_CASES])
def test_knn_matches_jax(case, k):
    """knn (one query), knn_batch and knn_batch_masked (a random mask)."""
    dtype, scan, metric, N, d = case
    rng = np.random.default_rng(3 + k)
    mat = _rows(rng, N, d, dtype, metric)
    jc, tc = _columns(mat, dtype, scan)
    jq, tq = _queries(rng, 5, d, dtype, metric)
    exact = _exact(np.asarray(jc["vecs"].astype(jnp.float32)),
                   np.asarray(jnp.asarray(jq, jnp.float32)), metric)
    present = rng.random(N) > 0.05
    jp, tp = jnp.asarray(present), torch.from_numpy(present)
    jd, ji = JV.knn_batch(jc["vecs"], jc["sq"], jp, jq, k, metric,
                          scan_vecs=jc["scan"])
    td, ti = TV.knn_batch(tc["vecs"], tc["sq"], tp, tq, k, metric,
                          scan_vecs=tc["scan"])
    _same_lanes(jd, ji, td, ti, exact)
    mask = rng.random((5, N)) > 0.5
    jd, ji = JV.knn_batch_masked(jc["vecs"], jc["sq"], jnp.asarray(mask),
                                 jq, k, metric, scan_vecs=jc["scan"])
    td, ti = TV.knn_batch_masked(tc["vecs"], tc["sq"],
                                 torch.from_numpy(mask), tq, k, metric,
                                 scan_vecs=tc["scan"])
    _same_lanes(jd, ji, td, ti, exact)
    jd, ji = JV.knn(jc["vecs"], jc["sq"], jp, jq[0], k, metric,
                    scan_vecs=jc["scan"])
    td, ti = TV.knn(tc["vecs"], tc["sq"], tp, tq[0], k, metric,
                    scan_vecs=tc["scan"])
    _same_lanes(np.asarray(jd)[None], np.asarray(ji)[None],
                td.numpy()[None], ti.numpy()[None], exact[:1])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_fewer_valid_rows_than_k(dtype):
    """Only 7 valid rows for k = 25: the 18 dead lanes carry 3.4e38 in
    both packages; the live ones agree lane for lane."""
    rng = np.random.default_rng(4)
    mat = _rows(rng, 3000, 64, dtype, "L2")
    jc, tc = _columns(mat, dtype, scan=True)
    jq, tq = _queries(rng, 3, 64, dtype, "L2")
    present = np.zeros(3000, bool)
    present[rng.choice(3000, 7, replace=False)] = True
    exact = _exact(mat, np.asarray(jnp.asarray(jq, jnp.float32)), "L2")
    jd, ji = JV.knn_batch(jc["vecs"], jc["sq"], jnp.asarray(present), jq,
                          25, "L2", scan_vecs=jc["scan"])
    td, ti = TV.knn_batch(tc["vecs"], tc["sq"], torch.from_numpy(present),
                          tq, 25, "L2", scan_vecs=tc["scan"])
    assert (np.asarray(jd) < 3.3e38).sum(1).tolist() == [7, 7, 7]
    _same_lanes(jd, ji, td, ti, exact)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_duplicated_rows_order_by_lowest_row(dtype):
    """Every row appears four times: exact ties, which both packages
    order lowest row first."""
    rng = np.random.default_rng(5)
    base = _rows(rng, 750, 64, dtype, "COSINE" if dtype != "int8" else "L2")
    mat = np.concatenate([base] * 4)
    metric = "COSINE" if dtype != "int8" else "L2"
    jc, tc = _columns(mat, dtype, scan=dtype == "f32")
    jq, tq = _queries(rng, 4, 64, dtype, metric)
    present = np.ones(3000, bool)
    for k in (10, 25):
        jd, ji = JV.knn_batch(jc["vecs"], jc["sq"], jnp.asarray(present),
                              jq, k, metric, scan_vecs=jc["scan"])
        td, ti = TV.knn_batch(tc["vecs"], tc["sq"],
                              torch.from_numpy(present), tq, k, metric,
                              scan_vecs=tc["scan"])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                                   atol=ATOL)
        # each tie group of 4 copies comes lowest row first
        rows = ti.numpy()
        assert np.all(rows[:, 0] < 750)


def test_knn_scan_batches_three_chunks():
    rng = np.random.default_rng(6)
    mat = _rows(rng, 3000, 64, "f32", "L2")
    jc, tc = _columns(mat, "f32", scan=True)
    Q = rng.normal(size=(3, 4, 64)).astype(np.float32)
    present = np.ones(3000, bool)
    jd, ji = JV.knn_scan_batches(jc["vecs"], jc["sq"], jnp.asarray(present),
                                 jnp.asarray(Q), 10, "L2",
                                 scan_vecs=jc["scan"])
    td, ti = TV.knn_scan_batches(tc["vecs"], tc["sq"],
                                 torch.from_numpy(present),
                                 torch.from_numpy(Q), 10, "L2",
                                 scan_vecs=tc["scan"])
    assert tuple(td.shape) == (3, 4, 10)
    for c in range(3):
        _same_lanes(np.asarray(jd[c]), np.asarray(ji[c]), td[c].numpy(),
                    ti[c].numpy(), _exact(mat, Q[c], "L2"))


@pytest.mark.parametrize("metric,radius", [("L2", 100.0), ("IP", 0.8),
                                           ("COSINE", 0.85)])
def test_range_query_matches_jax(metric, radius):
    rng = np.random.default_rng(7)
    mat = _rows(rng, 3000, 64, "f32", metric)
    jc, tc = _columns(mat, "f32")
    q = _rows(rng, 1, 64, "f32", metric)[0]
    present = rng.random(3000) > 0.1
    jm, jd = JV.range_query(jc["vecs"], jc["sq"], jnp.asarray(present),
                            jnp.asarray(q), radius, metric)
    tm, td = TV.range_query(tc["vecs"], tc["sq"], torch.from_numpy(present),
                            torch.from_numpy(q), radius, metric)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    jm, tm = np.asarray(jm), tm.numpy()
    near = np.abs(np.asarray(jd) - radius) <= 1e-5 * (1 + radius)
    np.testing.assert_array_equal(tm[~near], jm[~near])
    assert 0 < jm.sum() < 3000


@pytest.mark.parametrize("n,k", [(300, 10), (5000, 40), (70000, 25)])
def test_fast_top_k_ties_match_lax(n, k):
    """Rows full of equal values: the lanes tying with the k-th value
    are the lowest ones (up to 65,536 lanes, `lax.top_k`'s order), and
    the k lanes order by (value, lane) at every width."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 6, size=(4, n)).astype(np.float32)
    x[1, :] = 1.0
    x[2, : n // 2] = -3.4e38
    tv, ti = TT.fast_top_k(torch.from_numpy(x), k)
    jv, ji = JT.fast_top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if n <= TT.EXACT_TOPK_LIMIT:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ti = ti.numpy()
    for b in range(4):
        v = x[b, ti[b]]
        np.testing.assert_array_equal(v, tv.numpy()[b])
        same = v[1:] == v[:-1]
        assert np.all(ti[b, 1:][same] > ti[b, :-1][same])


@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT64", "FLOAT16",
                                   "BFLOAT16", "INT8", "UINT8"])
def test_decode_blob_matches_jax(dtype):
    """Bytes and arrays decode to the same values (bf16: f32 arrays of
    the bf16 values the JAX package holds as `ml_dtypes.bfloat16`)."""
    import redisearch_tpu as rs
    import redisearch_tpu_torch as rt
    from redisearch_tpu.query.engine import decode_blob as jdec
    from redisearch_tpu_torch.query.engine import decode_blob as tdec

    rng = np.random.default_rng(9)
    jf = rs.Field("v", rs.FieldType.VECTOR,
                  vector=rs.VectorParams(dim=16, dtype=dtype))
    tf = rt.Field("v", rt.FieldType.VECTOR,
                  vector=rt.VectorParams(dim=16, dtype=dtype))
    vals = (rng.integers(0, 100, 16) if dtype.endswith("INT8")
            else rng.normal(size=16) * 3.0)
    store = {"FLOAT32": np.float32, "FLOAT64": np.float64,
             "FLOAT16": np.float16, "INT8": np.int8, "UINT8": np.uint8}
    raws = [vals.astype(np.float32), list(map(float, vals))]
    if dtype == "BFLOAT16":
        bits = torch.from_numpy(vals.astype(np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy()
        raws.append(bits.tobytes())
    else:
        raws.append(vals.astype(store[dtype]).tobytes())
    for raw in raws:
        j = np.asarray(jdec(raw, jf))
        t = tdec(raw, tf)
        np.testing.assert_array_equal(t, j.astype(t.dtype))
        assert t.dtype == (np.float32 if j.dtype.name in (
            "bfloat16", "float32") else j.dtype)


def _clustered(rng, n, d, Bq):
    center = rng.normal(size=(d,)).astype(np.float32)
    vecs = (center[None, :]
            + 1e-3 * rng.normal(size=(n, d))).astype(np.float32)
    Q = (center[None, :]
         + 1e-3 * rng.normal(size=(Bq, d))).astype(np.float32)
    return center, vecs, Q


def _port_knn(batched, vecs, sq, present, Q, k):
    tv, tsq, tp = map(torch.from_numpy, (vecs, sq, present))
    if batched:
        td, ti = TV.knn_batch(tv, tsq, tp, torch.from_numpy(Q), k, "L2")
    else:
        outs = [TV.knn(tv, tsq, tp, torch.from_numpy(q), k, "L2")
                for q in Q]
        td = torch.stack([o[0] for o in outs])
        ti = torch.stack([o[1] for o in outs])
    return td.numpy(), ti.numpy().astype(np.int64)


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
def test_two_phase_rescore_clustered(batched):
    """tests/test_units.py::test_two_phase_knn_clustered's input: 4,096 x
    64 f32 rows and 16 queries at center + 1e-3 * normal, k 10, where
    the L2 form sq - 2 dot + qsq cancels.  With the rescore's dot
    products in float64 the returned distances are within 3e-5 (that
    test's own contract) of the float64 truth at the returned rows,
    batched (`knn_batch`) and single (`knn`), and every returned row's
    true distance is within 3e-5 of the oracle's k-th.  Near-tie
    membership is not compared with the JAX function: its candidate scan
    sums the f32 product in another order, which moves scan distances of
    about 6e-5 by up to 5e-5, so the two candidate sets differ (the JAX
    test makes no membership claim there either).  At the same candidate
    rows the two rescores agree within 3e-5; on separated clusters (the
    JAX test's second input) each query returns the JAX function's rows."""
    rng = np.random.default_rng(11)
    n, d, k, Bq = 4096, 64, 10, 16
    center, vecs, Q = _clustered(rng, n, d, Bq)
    sq = np.sum(vecs.astype(np.float64) ** 2, 1).astype(np.float32)
    present = np.ones(n, bool)
    d64 = ((vecs.astype(np.float64)[None, :, :]
            - Q.astype(np.float64)[:, None, :]) ** 2).sum(2)
    td, ti = _port_knn(batched, vecs, sq, present, Q, k)
    truth = np.take_along_axis(d64, ti, axis=1)
    assert np.abs(td - truth).max() <= 3e-5, np.abs(td - truth).max()
    kth = np.sort(d64, axis=1)[:, k - 1]
    assert np.all(truth <= kth[:, None] + 3e-5)
    # the same candidate rows through both rescores
    _jd, ji = map(np.asarray, JV.knn_batch(
        jnp.asarray(vecs), jnp.asarray(sq), jnp.asarray(present),
        jnp.asarray(Q), k, "L2"))
    jr = np.asarray(JV._rescore(jnp.asarray(vecs), jnp.asarray(sq),
                                jnp.asarray(Q), jnp.asarray(ji), "L2"))
    tr = TV._rescore(torch.from_numpy(vecs), torch.from_numpy(sq),
                     torch.from_numpy(Q), torch.from_numpy(ji),
                     "L2").numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=3e-5)
    assert np.abs(tr - np.take_along_axis(d64, ji, 1)).max() <= 3e-5
    # separated clusters: membership is exact, the same rows as the JAX
    # function's a query (their order may swap within 3e-5)
    far = vecs + rng.normal(size=(n, d)).astype(np.float32) * 2.0
    far[:64] = center[None, :] + 1e-2 * rng.normal(
        size=(64, d)).astype(np.float32)
    sqf = np.sum(far.astype(np.float64) ** 2, 1).astype(np.float32)
    jd2, ji2 = map(np.asarray, JV.knn_batch(
        jnp.asarray(far), jnp.asarray(sqf), jnp.asarray(present),
        jnp.asarray(Q), k, "L2"))
    td2, ti2 = _port_knn(batched, far, sqf, present, Q, k)
    assert [sorted(r) for r in ti2] == [sorted(r) for r in ji2]
    np.testing.assert_allclose(td2, jd2, rtol=0, atol=3e-5)
