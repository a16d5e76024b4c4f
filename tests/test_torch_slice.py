"""Segment slicing (`index/slice.py`) in the torch port against the JAX
package, on the CPU.

tests/test_slice.py's 300-doc index (TEXT, sortable TAG, sortable
NUMERIC, GEO, an L2 vector) and five variants of it: a cold segment
(its CSR arrays stay host numpy), multi-value TAG / NUMERIC / bf16
vector columns, the host tier in f32 and in LVQ8, and TTL and
field-expiration columns.  For each:

* the port's `slice_segment` of every third doc of the JAX segment
  carried across (`convert.segment_from_jax`) equals the JAX slice
  carried across, array for array: values, dtypes, pads and layouts,
  `nnz`, `max_postings` and the flags;
* what the port derives beside the JAX arrays (the host mirrors, the
  offsets mirrors, the value-sorted numeric permutation, the bf16 scan
  copy and the squared norms) equals a fresh recomputation from the
  sliced arrays;
* test_slice.py's queries on the port's slice of its own segment equal
  the same queries on the JAX slice (keys, totals, scores within rtol
  1e-6, KNN distances within 1e-5) and, in key sets and totals (and KNN
  order), on a port index rebuilt from the same docs.

Every comparison of arrays is exact.
"""

import time

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.index.slice import slice_segment as jax_slice
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.index import slice as TS
from redisearch_tpu_torch.index.segment import (_sq_norms, bf16_scan_copy,
                                                make_numeric_column)
from redisearch_tpu_torch.ops import ivf as TI

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
SEL = np.arange(0, 300, 3)


def _fields(p, variant):
    F, T = p.Field, p.FieldType
    if variant == "multi":
        return [F("t", T.TEXT), F("cat", T.TAG), F("x", T.NUMERIC),
                F("v", T.VECTOR, vector=p.VectorParams(
                    dim=8, metric=p.VectorMetric.L2, dtype="BFLOAT16"))]
    if variant in ("host", "lvq"):
        return [F("t", T.TEXT), F("x", T.NUMERIC),
                F("v", T.VECTOR, vector=p.VectorParams(
                    dim=8, metric="L2", algo=p.VectorAlgo.IVF, nlist=8,
                    nprobe=8, storage="host",
                    compression="LVQ8" if variant == "lvq" else ""))]
    if variant == "ttl":
        return [F("t", T.TEXT), F("cat", T.TAG, sortable=True),
                F("x", T.NUMERIC, sortable=True)]
    return [F("t", T.TEXT), F("cat", T.TAG, sortable=True),
            F("x", T.NUMERIC, sortable=True), F("g", T.GEO),
            F("v", T.VECTOR, vector=p.VectorParams(
                dim=8, metric=p.VectorMetric.L2))]


def _docs(variant):
    """test_slice.py's documents (seed 5), shaped for the variant."""
    rng = np.random.default_rng(5)
    docs = []
    for i in range(300):
        f = {"t": " ".join(rng.choice(WORDS, 6)), "cat": f"c{i % 7}",
             "x": float(i % 50),
             "g": f"{rng.uniform(-10, 10):.4f},{rng.uniform(-10, 10):.4f}",
             "v": rng.normal(size=8).astype(np.float32)}
        if variant == "multi":
            if i % 4 == 0:
                f["cat"] = [f"c{i % 7}", f"m{i % 3}"]
                f["x"] = [float(i % 50), float(i % 11) + 0.5]
                f["v"] = [f["v"], rng.normal(size=8).astype(np.float32)]
            if i % 9 == 0:
                del f["v"]
        docs.append((f"d{i}", f))
    return docs


def _build(p, variant, docs=None):
    schema = p.Schema(name=f"sl_{variant}", fields=_fields(p, variant),
                      storage="host" if variant == "cold" else "hbm")
    ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(schema,
                                                             device="cpu")
    now = time.time()
    for i, (k, f) in enumerate(_docs(variant) if docs is None else docs):
        kw = {}
        if variant == "ttl" and int(k[1:]) % 5 == 0:
            kw["ttl"] = -60.0 if int(k[1:]) % 10 == 0 else 3600.0
        if variant == "ttl" and int(k[1:]) % 6 == 0:
            kw["field_expiration"] = {"cat": now - 60.0, "t": now + 3600}
        ix.add_document(k, dict(f), **kw)
    ix.commit()
    return ix


def _on_jax_centroids(tix, jix):
    """The JAX package's k-means centroids under the port's host tier
    (the two sum in different orders)."""
    col = tix.segments[0].vectors["v"]
    jh = jix.segments[0].vectors["v"].host_ivf
    cents = np.asarray(jh.centroids)
    col.host_ivf = (
        TI.HostIVF.build_lvq(col.vecs, col.vq_off, col.vq_scl,
                             col.present.numpy(), jh.metric,
                             centroids=cents)
        if col.compression else
        TI.HostIVF.build(col.vecs, col.present.numpy(), jh.metric,
                         centroids=cents))


VARIANTS = ["base", "cold", "multi", "host", "lvq", "ttl"]


@pytest.fixture(scope="module", params=VARIANTS)
def built(request):
    variant = request.param
    jix = _build(rs, variant)
    tix = _build(rt, variant)
    if variant in ("host", "lvq"):
        _on_jax_centroids(tix, jix)
    return variant, jix, tix


# ---------------------------------------------------------------- arrays
def _arr(x):
    """A comparable host array: tensors to numpy, bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = _arr(a), _arr(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_ivf(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    for name in ("nlist", "list_pad", "dim", "metric"):
        assert getattr(a, name) == getattr(b, name), (what, name)
    for name in ("centroids", "cent_sq", "bucket_vecs", "bucket_sq",
                 "bucket_ids", "bucket_off", "bucket_scl"):
        if hasattr(a, name):
            _eq(getattr(a, name), getattr(b, name), f"{what}.{name}")


def assert_same_segment(a, b):
    """Every array and flag of two port segments equal (not `uid`)."""
    for name in ("n_docs", "n_pad", "n_deleted", "has_ttl",
                 "uniform_docscore", "cold"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("gids", "alive", "doclen", "max_freq", "docscore",
                 "expire_at", "gids_np", "alive_np", "doclen_np",
                 "text_fexp"):
        _eq(getattr(a, name), getattr(b, name), name)
    assert a.gid_to_local == b.gid_to_local
    assert a.geometries == b.geometries
    assert a.terms.ids == b.terms.ids and a.terms.terms == b.terms.terms
    _eq(a.terms.doc_freq, b.terms.doc_freq, "doc_freq")
    for name in ("pos_stride", "pos_clamped", "nnz", "max_postings"):
        assert getattr(a.text, name) == getattr(b.text, name), name
    for name in ("term_offsets", "doc_ids", "freqs", "field_masks",
                 "doclens", "pos_offsets", "poskeys", "term_offsets_np",
                 "pos_offsets_np"):
        _eq(getattr(a.text, name), getattr(b.text, name), f"text.{name}")
    assert a.tags.keys() == b.tags.keys()
    for attr, x in a.tags.items():
        y = b.tags[attr]
        assert (x.ids, x.values, x.nnz, x.max_postings) == (
            y.ids, y.values, y.nnz, y.max_postings), attr
        for name in ("offsets", "doc_ids", "offsets_np", "codes"):
            _eq(getattr(x, name), getattr(y, name), f"tag {attr}.{name}")
    assert a.numerics.keys() == b.numerics.keys()
    for attr, x in a.numerics.items():
        y = b.numerics[attr]
        assert x.multi == y.multi, attr
        for name in ("values", "present", "sorted_vals", "sorted_docs",
                     "sorted_vals_np", "multi_values", "multi_present"):
            _eq(getattr(x, name), getattr(y, name), f"num {attr}.{name}")
    assert a.strcols.keys() == b.strcols.keys()
    for attr, x in a.strcols.items():
        y = b.strcols[attr]
        assert x.table == y.table, attr
        _eq(x.value_ids, y.value_ids, f"str {attr}")
        _eq(x.order, y.order, f"str {attr} order")
    assert a.geos.keys() == b.geos.keys()
    for attr, x in a.geos.items():
        for name in ("lon", "lat", "present"):
            _eq(getattr(x, name), getattr(b.geos[attr], name),
                f"geo {attr}.{name}")
    assert a.missing.keys() == b.missing.keys()
    for attr in a.missing:
        _eq(a.missing[attr], b.missing[attr], f"missing {attr}")
    assert a.field_fexp.keys() == b.field_fexp.keys()
    for attr in a.field_fexp:
        _eq(a.field_fexp[attr], b.field_fexp[attr], f"fexp {attr}")
    assert a.vectors.keys() == b.vectors.keys()
    for attr, x in a.vectors.items():
        y = b.vectors[attr]
        for name in ("dim", "multi", "host", "compression"):
            assert getattr(x, name) == getattr(y, name), (attr, name)
        for name in ("vecs", "present", "sq_norms", "scan_vecs",
                     "doc_rows", "vq_off", "vq_scl"):
            _eq(getattr(x, name), getattr(y, name), f"vec {attr}.{name}")
        _same_ivf(x.ivf, y.ivf, f"vec {attr}.ivf")
        _same_ivf(x.host_ivf, y.host_ivf, f"vec {attr}.host_ivf")


def assert_derived_fresh(seg):
    """The port-only state of a segment equals a recomputation from its
    arrays: what a slice or a load that missed it would serve stale."""
    n = seg.n_docs
    _eq(seg.gids_np, seg.gids, "gids mirror")
    _eq(seg.alive_np, seg.alive, "alive mirror")
    _eq(seg.doclen_np, seg.doclen, "doclen mirror")
    assert seg.gid_to_local == {int(g): i for i, g in
                                enumerate(seg.gids_np[:n])}
    tx = seg.text
    _eq(tx.term_offsets_np, tx.term_offsets, "term_offsets mirror")
    _eq(tx.pos_offsets_np, _arr(tx.pos_offsets).astype(np.int64),
        "pos_offsets mirror")
    for attr, tp in seg.tags.items():
        _eq(tp.offsets_np, tp.offsets, f"tag {attr} offsets mirror")
    for attr, c in seg.numerics.items():
        col = np.where(_arr(c.present), _arr(c.values), np.nan)
        lists = None
        if c.multi:
            mv, mp = _arr(c.multi_values), _arr(c.multi_present)
            lists = [list(mv[r][mp[r]]) for r in range(n)]
        f = make_numeric_column(col.astype(np.float32), n, "cpu",
                                value_lists=lists)
        for name in ("sorted_vals", "sorted_docs", "sorted_vals_np"):
            _eq(getattr(c, name), getattr(f, name), f"num {attr}.{name}")
    for attr, v in seg.vectors.items():
        if v.host:
            continue
        _eq(v.scan_vecs, None if v.multi else bf16_scan_copy(v.vecs),
            f"vec {attr} scan copy")
        if v.multi or v.vecs.dtype == torch.float32:
            _eq(v.sq_norms, _sq_norms(v.vecs.float().numpy()),
                f"vec {attr} sq_norms")


def test_slice_equals_jax_array_for_array(built):
    variant, jix, _t = built
    jseg = jix.segments[0]
    conv = segment_from_jax(jseg, "cpu")
    got = TS.slice_segment(conv, SEL)
    want = segment_from_jax(jax_slice(jseg, SEL), "cpu")
    assert_same_segment(got, want)
    assert got.uid not in (conv.uid, want.uid)
    assert got.cold == (variant == "cold")
    if variant == "cold":
        assert isinstance(got.text.doc_ids, np.ndarray)
        assert isinstance(got.tags["cat"].doc_ids, np.ndarray)
    assert_derived_fresh(got)


def test_port_built_slice_derived_state(built):
    """The port's own segment sliced: every derived array fresh, and
    the same arrays as the slice of the JAX segment carried across
    where the two builds agree (not the host tier's k-means lists, nor
    TTL deadlines, which each build reads off its own clock)."""
    variant, jix, tix = built
    got = TS.slice_segment(tix.segments[0], SEL)
    assert_derived_fresh(got)
    if variant not in ("host", "lvq", "ttl"):
        want = segment_from_jax(jax_slice(jix.segments[0], SEL), "cpu")
        assert_same_segment(got, want)


# --------------------------------------------------------------- queries
QUERIES = {
    "base": [("alpha beta", {}), ('"alpha beta"', {}),
             ("@t:gamma -delta", {}), ("@cat:{c1|c3} @x:[5 30]", {}),
             ("ze*", {}), ("@g:[0 0 2000 km]", {}),
             ("*=>[KNN 7 @v $b]", {"b": np.zeros(8, np.float32)})],
    "multi": [("alpha beta", {}), ('"alpha beta"', {}),
              ("@cat:{m1}", {}), ("@cat:{c1|m2} @x:[5 30]", {}),
              ("@x:[3.5 4.5]", {}),
              ("*=>[KNN 7 @v $b]", {"b": np.full(8, 0.25, np.float32)})],
    "host": [("alpha beta", {}), ("@x:[10 20]", {}),
             ("*=>[KNN 7 @v $b]", {"b": np.zeros(8, np.float32)}),
             ("(gamma)=>[KNN 5 @v $b]", {"b": np.ones(8, np.float32)})],
    "ttl": [("alpha beta", {}), ('"alpha beta"', {}), ("@cat:{c1|c3}", {}),
            ("@x:[5 30] -delta", {}), ("*", {})],
}
QUERIES["cold"] = QUERIES["base"]
QUERIES["lvq"] = QUERIES["host"]


def _sub(p, ix, seg):
    """An index over one sliced segment, sharing `ix`'s doc table."""
    sub = (p.SearchIndex(ix.schema) if p is rs
           else p.SearchIndex(ix.schema, device="cpu"))
    sub.doctable = ix.doctable
    sub.segments = [seg]
    return sub


def _run(ix, q, p):
    r = ix.search(q, params=p or None, num=50)
    return r.total, [h.key for h in r.hits], r


def test_sliced_queries_match_jax_and_rebuild(built):
    variant, jix, tix = built
    jsub = _sub(rs, jix, jax_slice(jix.segments[0], SEL))
    tsub = _sub(rt, tix, TS.slice_segment(tix.segments[0], SEL))
    docs = _docs(variant)
    ref = _build(rt, variant, [docs[j] for j in SEL])
    if variant in ("host", "lvq"):
        # the rebuild trains its own lists; probe every one of them
        ref.segments[0].vectors["v"].host_ivf = tsub.segments[0].vectors[
            "v"].host_ivf
    for q, p in QUERIES[variant]:
        jt, jkeys, jr = _run(jsub, q, p)
        tt, tkeys, tr = _run(tsub, q, p)
        assert (tt, tkeys) == (jt, jkeys), (variant, q)
        np.testing.assert_allclose([h.score for h in tr.hits],
                                   [h.score for h in jr.hits], rtol=1e-6,
                                   err_msg=q)
        if "KNN" in q:
            np.testing.assert_allclose(
                [h.vector_distance for h in tr.hits],
                [h.vector_distance for h in jr.hits], rtol=1e-5,
                atol=1e-5, err_msg=q)
        # a standalone rebuild has its own corpus stats (N, avgdl), so
        # only the match set (and KNN order) must agree
        rt_, rkeys, _ = _run(ref, q, p)
        assert (tt, sorted(tkeys)) == (rt_, sorted(rkeys)), (variant, q)
        if "KNN" in q and variant not in ("host", "lvq"):
            assert tkeys == rkeys, q


def test_live_locals_skips_deleted_docs():
    tix = _build(rt, "base")
    for i in (0, 5, 299):
        tix.delete_document(f"d{i}")
    seg = tix.segments[0]
    want = np.array([i for i in range(300) if i not in (0, 5, 299)])
    np.testing.assert_array_equal(TS.live_locals(seg, tix.doctable), want)


def test_ranges_concat():
    got = TS._ranges_concat(np.array([5, 0, 9]), np.array([2, 0, 3]))
    np.testing.assert_array_equal(got, [5, 6, 9, 10, 11])
    assert TS._ranges_concat(np.array([3]), np.array([0])).size == 0


def test_empty_selection_raises():
    tix = _build(rt, "ttl")
    with pytest.raises(ValueError, match="empty"):
        TS.slice_segment(tix.segments[0], np.zeros(0, np.int64))
