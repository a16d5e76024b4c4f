"""GEO fields in the torch port against the JAX package, on the CPU.

`ops.text.geo_radius_mask` is held against the JAX function on seeded
points, then GEO filters through the port's entry points against the
JAX package on the same documents: FT.SEARCH with a GEO filter alone,
AND a term, AND a TAG and under NOT (single `search` and batched
`search_many`, whose GEO groups ride the window program), the radius
units (m, km, mi, ft), FT.AGGREGATE over a GEO filter, and GEO-
prefiltered KNN.  The port also serves the JAX segment carried across
by `convert.segment_from_jax`.

Tolerance.  Both sides compute the haversine in f32 (asin(sqrt(a))
form), but `sin`, `cos` and `arcsin` may differ in the last ulp between
libms, so a point at the radius's edge can fall either side.  Wherever
the two masks (or hit sets) differ, the point's float64 haversine
distance, taken from the f32 radians both indexes hold, must lie within
1e-6 relative of the radius; such points are counted.  Everything else is equal: totals, keys, their order, scores
within rtol 1e-5, vector distances within 1e-5 (absolute: a squared L2
distance near 0 comes out of ||a||^2 - 2ab + ||b||^2, whose f32
cancellation leaves a few ulp of ||a||^2 in both packages).  The data
is not chosen to avoid edges.
"""

import math

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.ops.text import geo_radius_mask as jax_geo_mask
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.ops import text as TT
from redisearch_tpu_torch.query import engine as TE

EARTH = 6372797.560856
EDGE_RTOL = 1e-6
N = 1500
LON0, LAT0 = 2.35, 48.85          # Paris; points in a ~40 km box


def _f32_rad(deg):
    """Degrees as the builder and the parser store them: radians in f32."""
    return np.radians(np.asarray(deg, np.float64)).astype(np.float32)


def _hav64(lon, lat, qlon, qlat):
    """float64 haversine metres between points given in f32 radians."""
    lon, lat, qlon, qlat = (np.asarray(x, np.float64)
                            for x in (lon, lat, qlon, qlat))
    a = (np.sin((lat - qlat) / 2) ** 2
         + np.cos(lat) * np.cos(qlat) * np.sin((lon - qlon) / 2) ** 2)
    return 2 * EARTH * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return (LON0 + rng.uniform(-0.3, 0.3, n),
            LAT0 + rng.uniform(-0.2, 0.2, n))


def _edge_only(diff_idx, lon, lat, qlon, qlat, radius_m):
    """Every differing point lies at the radius's edge (float64 over the
    f32 radians)."""
    d = _hav64(lon[diff_idx], lat[diff_idx], qlon, qlat)
    assert np.all(np.abs(d - radius_m) <= EDGE_RTOL * radius_m), (
        diff_idx, d, radius_m)
    return len(diff_idx)


@pytest.mark.parametrize("radius_m", [50.0, 1000.0, 7500.0, 20000.0,
                                      60000.0])
def test_geo_radius_mask_matches_jax(radius_m):
    lon, lat = _points(20000, seed=int(radius_m))
    present = np.random.default_rng(1).random(lon.size) > 0.1
    rlon = np.radians(lon).astype(np.float32)
    rlat = np.radians(lat).astype(np.float32)
    q = (np.float32(math.radians(LON0 + 0.01)),
         np.float32(math.radians(LAT0 - 0.02)), np.float32(radius_m))
    want = np.asarray(jax_geo_mask(rlon, rlat, present, *q))
    got = TT.geo_radius_mask(torch.from_numpy(rlon), torch.from_numpy(rlat),
                             torch.from_numpy(present),
                             *(torch.tensor(x) for x in q)).numpy()
    diff = np.nonzero(want != got)[0]
    n_edge = _edge_only(diff, rlon, rlat, q[0], q[1], radius_m)
    assert n_edge <= 2, n_edge
    assert (got & ~present).sum() == 0


def _fields(p):
    F, T = p.Field, p.FieldType
    return [F("t", T.TEXT), F("c", T.TAG), F("g", T.GEO),
            F("p", T.NUMERIC, sortable=True),
            F("v", T.VECTOR, vector=p.VectorParams(dim=8, metric="L2"))]


def _docs():
    rng = np.random.default_rng(5)
    lon, lat = _points(N, seed=7)
    vecs = rng.normal(size=(N, 8)).astype(np.float32)
    words = ["cafe", "museum", "park", "river", "bridge"]
    docs = []
    for i in range(N):
        f = {"t": " ".join(rng.choice(words, 2)), "c": f"c{i % 4}",
             "p": float(i % 40), "v": vecs[i]}
        if i % 11:                      # every 11th doc has no point
            f["g"] = f"{lon[i]:.6f},{lat[i]:.6f}"
        docs.append((f"d{i}", f))
    return docs, lon, lat, vecs


@pytest.fixture(scope="module")
def idx():
    docs, lon, lat, vecs = _docs()
    jix = rs.SearchIndex(rs.Schema(name="geo", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="geo", fields=_fields(rt)),
                         device="cpu")
    bix = rt.SearchIndex(rt.Schema(name="geo", fields=_fields(rt)),
                         device="cpu")
    cix = rt.SearchIndex(rt.Schema(name="geo", fields=_fields(rt)),
                         device="cpu")
    for k, f in docs:
        jix.add_document(k, f)
        tix.add_document(k, f)
    jix.commit()
    tix.commit()
    bix.add_documents(docs)                 # the bulk path
    cix.add_documents(docs)
    cix.segments = [segment_from_jax(jix.segments[0], "cpu")]
    # the docs' points as the index holds them (f32 radians)
    plon = _f32_rad([float(f["g"].split(",")[0]) if "g" in f else np.nan
                     for _k, f in docs])
    plat = _f32_rad([float(f["g"].split(",")[1]) if "g" in f else np.nan
                     for _k, f in docs])
    return jix, tix, bix, cix, plon, plat, vecs


def _geo_of(q):
    """(lon, lat in f32 radians, radius in metres) of the query's GEO
    filter."""
    body = q[q.index("@g:[") + 4:]
    lon, lat, r, unit = body[:body.index("]")].split()
    scale = {"m": 1.0, "km": 1000.0, "mi": 1609.34, "ft": 0.3048}[unit]
    return _f32_rad(float(lon)), _f32_rad(float(lat)), float(r) * scale


def _same(j, t, q, plon, plat):
    """Equal results, except docs whose point sits on the radius's edge
    (see the module docstring)."""
    jk = [h.key for h in j.hits]
    tk = [h.key for h in t.hits]
    if jk != tk or j.total != t.total:
        glon, glat, rad = _geo_of(q)
        diff = sorted({int(k[1:]) for k in set(jk) ^ set(tk)})
        _edge_only(np.array(diff, int), plon, plat, glon, glat, rad)
        assert abs(j.total - t.total) <= len(diff), q
        return
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=1e-5,
                               atol=1e-7, err_msg=q)
    jd = [h.vector_distance for h in j.hits]
    if any(x is not None for x in jd):
        np.testing.assert_allclose([h.vector_distance for h in t.hits], jd,
                                   rtol=1e-5, atol=1e-5, err_msg=q)


QUERIES = [
    "@g:[2.35 48.85 10 km]",
    "@g:[2.30 48.90 3500 m]",
    "@g:[2.40 48.80 4 mi]",
    "@g:[2.35 48.85 20000 ft]",
    "museum @g:[2.35 48.85 12 km]",
    "@c:{c1} @g:[2.28 48.84 9 km]",
    "cafe -@g:[2.35 48.85 15 km]",
    "@c:{c2|c3} -@g:[2.42 48.87 6 km] @p:[5 30]",
    "(park | river) @g:[2.35 48.85 25 km]",
]


@pytest.mark.parametrize("q", QUERIES)
def test_geo_search_matches_jax(idx, q):
    jix, tix, bix, cix, plon, plat, _v = idx
    j = jix.search(q, num=20)
    for ix in (tix, bix, cix):
        _same(j, ix.search(q, num=20), q, plon, plat)
    js = jix.search(q, num=20, sort_by="p", sort_asc=False)
    _same(js, tix.search(q, num=20, sort_by="p", sort_asc=False), q,
          plon, plat)


def test_geo_search_many_rides_window(idx):
    """A batch of GEO queries stays off the kernels (the JAX planner's
    rule) and rides the window program, one group per structure."""
    jix, tix, _b, _c, plon, plat, _v = idx
    qs = QUERIES[:3] + ["museum @g:[2.32 48.86 8 km]",
                        "bridge @g:[2.37 48.83 5 km]"]
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many(qs, k=10)
    assert TE.QUERY_PATH_STATS == {"window": len(qs)}
    for q, j, t in zip(qs, jix.search_many(qs, k=10), tres):
        _same(j, t, q, plon, plat)


def test_geo_radius_units_client():
    """tests/test_reference_semantics.py::test_geo_radius_units on both
    packages' Client: 2 km == 2000 m, 2 mi reaches further."""
    out = []
    for p in (rs, rt):
        c = p.Client() if p is rs else p.Client(device="cpu")
        c.ft_create("ge", [p.Field("t", p.FieldType.TEXT),
                           p.Field("g", p.FieldType.GEO)])
        for i in range(10):
            c.hset(f"d{i}", {"t": "x", "g": f"{2.0 + i * 0.01},48.0"})
        out.append([sorted(int(h.key[1:]) for h in c.ft_search(
            "ge", f"@g:[2.0 48.0 {r}]", num=20).hits)
            for r in ("2 km", "2000 m", "2 mi")])
    assert out[0] == out[1] == [[0, 1, 2], [0, 1, 2], [0, 1, 2, 3, 4]]


def test_geo_aggregate_matches_jax(idx):
    jix, tix, bix, _c, _lo, _la, _v = idx

    def req(p):
        return (p.AggregateRequest("@g:[2.35 48.85 14 km]")
                .group_by("@c", ("COUNT", [], "n"), ("SUM", ["@p"], "s"))
                .sort_by(("@n", p.DESC)).limit(0, 4))

    j = jix.aggregate(req(rs))
    TP.AGG_PATH_STATS.clear()
    for t in (tix.aggregate(req(rt)), bix.aggregate_many([req(rt)])[0]):
        assert t.total == j.total
        assert t.rows == j.rows


@pytest.mark.parametrize("q", [
    "(@g:[2.35 48.85 10 km])=>[KNN 6 @v $b]",
    "(museum @g:[2.30 48.88 15 km])=>[KNN 6 @v $b]",
    "(-@g:[2.35 48.85 20 km])=>[KNN 6 @v $b]"])
def test_geo_prefiltered_knn_matches_jax(idx, q):
    jix, tix, _b, cix, plon, plat, vecs = idx
    params = [{"b": vecs[i] + 0.05} for i in range(3)]
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many([q] * 3, params=params, k=6)
    # host-evaluated GEO predicates keep KNN off the dense executor
    assert set(TE.QUERY_PATH_STATS) <= {"knn-row", "window"}
    for j, t, p in zip(jix.search_many([q] * 3, params=params, k=6), tres,
                       params):
        _same(j, t, q, plon, plat)
        _same(jix.search(q, params=p), cix.search(q, params=p), q, plon,
              plat)


def test_geo_columns_equal(idx):
    """Builder, bulk path and the JAX segment hold the same columns."""
    jix, tix, bix, cix, _lo, _la, _v = idx
    jg = jix.segments[0].geos["g"]
    for ix in (tix, bix, cix):
        g = ix.segments[0].geos["g"]
        np.testing.assert_array_equal(g.lon.numpy(), np.asarray(jg.lon))
        np.testing.assert_array_equal(g.lat.numpy(), np.asarray(jg.lat))
        np.testing.assert_array_equal(g.present.numpy(),
                                      np.asarray(jg.present))
    seg = tix.segments[0]
    assert seg.memory_bytes() >= sum(
        t.numel() * t.element_size()
        for t in (seg.geos["g"].lon, seg.geos["g"].lat))
