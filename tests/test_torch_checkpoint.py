"""Checkpoints (`aux/checkpoint.py`) across the two packages, on the CPU.

One on-disk format (`arrays.npz`, `host.pkl`, `meta.json`, version 1)
for both: a checkpoint the JAX package writes loads in the port, one the
port writes loads in the JAX package, and one the port writes loads in
the port.  Each loaded index gives the source index's results.  Cases:
every vector storage type (FLOAT32, FLOAT64, FLOAT16, BFLOAT16, INT8,
UINT8), multi-value TAG / NUMERIC / vector columns, an IVF field, the
host tier in f32 and LVQ8, a cold index, a dense TAG codes column
(tests/test_fields.py::test_tag_codes_checkpoint_roundtrip), TTL and
field-expiration columns, and deletes made before the save.

Where the JAX package wrote the checkpoint, the segment the port loads
equals the JAX segment carried across (`convert.segment_from_jax`)
array for array, and its derived state equals a fresh recomputation;
where the port wrote it, the segment the JAX package loads, carried
back, equals the port's source segment.  The JAX package loads the
port's host objects as its own classes (never the port's: the two
packages' enums never compare equal), and the port loads the JAX
package's as its copies; other `redisearch_tpu` names are refused.

Equal: keys, order and totals; BM25 scores within rtol 1e-6; vector
distances within 1e-5 (rtol and atol).
"""

import pickle
import time

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.aux import checkpoint as JC
from redisearch_tpu_torch.aux import checkpoint as TC
from redisearch_tpu_torch.convert import segment_from_jax
from redisearch_tpu_torch.index import doctable as TD
from redisearch_tpu_torch.ops import ivf as TI

from tests.test_torch_slice import assert_derived_fresh, assert_same_segment

N = 200
DTYPES = ["FLOAT32", "FLOAT64", "FLOAT16", "BFLOAT16", "INT8", "UINT8"]
CASES = ([f"vec-{d}" for d in DTYPES]
         + ["multi", "ivf", "host", "lvq", "cold", "tags", "ttl",
            "deletes"])


def _fields(p, case):
    F, T = p.Field, p.FieldType
    base = [F("t", T.TEXT), F("cat", T.TAG, sortable=True),
            F("x", T.NUMERIC, sortable=True)]
    if case.startswith("vec-"):
        return base + [F("v", T.VECTOR, vector=p.VectorParams(
            dim=8, metric="L2", dtype=case[4:]))]
    if case == "multi":
        return [F("t", T.TEXT), F("cat", T.TAG), F("x", T.NUMERIC),
                F("v", T.VECTOR, vector=p.VectorParams(dim=8, metric="IP"))]
    if case == "ivf":
        return base + [F("v", T.VECTOR, vector=p.VectorParams(
            dim=8, metric="L2", algo=p.VectorAlgo.IVF, nlist=8, nprobe=8,
            flat_buffer_limit=64))]
    if case in ("host", "lvq"):
        return base + [F("v", T.VECTOR, vector=p.VectorParams(
            dim=8, metric="L2", nlist=8, nprobe=8, storage="host",
            compression="LVQ8" if case == "lvq" else ""))]
    if case == "tags":
        return [F("t", T.TEXT), F("kind", T.TAG), F("g", T.GEO)]
    return base


def _docs(case):
    rng = np.random.default_rng(12)
    words = ["alpha", "beta", "gamma", "delta", "epsilon"]
    docs = []
    for i in range(N):
        f = {"t": " ".join(rng.choice(words, 5)), "cat": f"c{i % 5}",
             "x": float(i % 40)}
        if case == "vec-INT8":
            f["v"] = rng.integers(-100, 100, 8).astype(np.float32)
        elif case == "vec-UINT8":
            f["v"] = rng.integers(0, 200, 8).astype(np.float32)
        else:
            f["v"] = rng.normal(size=8).astype(np.float32)
        if case == "multi" and i % 3 == 0:
            f["cat"] = [f"c{i % 5}", f"m{i % 2}"]
            f["x"] = [float(i % 40), float(i % 7) + 0.5]
            f["v"] = [f["v"], rng.normal(size=8).astype(np.float32)]
        if case == "tags":
            f = {"t": f["t"], "kind": "ab"[i % 2],
                 "g": f"{2 + i * 1e-3:.4f},48.85"}
        docs.append((f"d{i}", f))
    return docs


def _build(p, case):
    schema = p.Schema(name=f"ck_{case}", fields=_fields(p, case),
                      storage="host" if case == "cold" else "hbm")
    ix = p.SearchIndex(schema) if p is rs else p.SearchIndex(schema,
                                                             device="cpu")
    now = time.time()
    for k, f in _docs(case):
        kw = {}
        i = int(k[1:])
        if case == "ttl" and i % 5 == 0:
            kw["ttl"] = -60.0 if i % 10 == 0 else 3600.0
        if case == "ttl" and i % 6 == 0:
            kw["field_expiration"] = {"cat": now - 60.0}
        ix.add_document(k, f, **kw)
    ix.commit()
    if case == "deletes":
        for i in range(0, N, 9):        # 12%: below the threshold
            ix.delete_document(f"d{i}")
    return ix


def _on_jax_centroids(tix, jix):
    """The JAX package's k-means centroids under the port's lists (the
    two sum in different orders)."""
    col = tix.segments[0].vectors["v"]
    jc = jix.segments[0].vectors["v"]
    if col.host:
        cents = np.asarray(jc.host_ivf.centroids)
        col.host_ivf = (
            TI.HostIVF.build_lvq(col.vecs, col.vq_off, col.vq_scl,
                                 col.present.numpy(), "L2",
                                 centroids=cents)
            if col.compression else
            TI.HostIVF.build(col.vecs, col.present.numpy(), "L2",
                             centroids=cents))
    else:
        col.ivf = TI.IVFIndex.build(col.vecs.numpy(), col.present.numpy(),
                                    "L2", centroids=np.asarray(
                                        jc.ivf.centroids))


def _queries(case):
    qv = np.full(8, 0.3, np.float32)
    if case == "tags":
        return [("@kind:{a}", {}), ("alpha @kind:{b}", {}),
                ("@g:[2.05 48.85 5 km]", {})]
    qs = [("alpha beta", {}), ('"alpha beta"', {}), ("gamma -delta", {}),
          ("@cat:{c1|c3} @x:[5 30]", {}), ("*", {})]
    if case not in ("cold", "ttl", "deletes"):
        qs.append(("*=>[KNN 7 @v $b]", {"b": qv}))
        qs.append(("(alpha)=>[KNN 5 @v $b]", {"b": qv}))
    if case == "multi":
        qs.append(("@cat:{m1} @x:[3.5 4.5]", {}))
    return qs


def _same(t, j, what):
    assert t.total == j.total, (what, t.total, j.total)
    assert [h.key for h in t.hits] == [h.key for h in j.hits], what
    np.testing.assert_allclose([h.score for h in t.hits],
                               [h.score for h in j.hits], rtol=1e-6,
                               err_msg=str(what))
    if any(h.vector_distance is not None for h in j.hits):
        np.testing.assert_allclose(
            [h.vector_distance for h in t.hits],
            [h.vector_distance for h in j.hits], rtol=1e-5, atol=1e-5,
            err_msg=str(what))


def _results(ix, case):
    return [ix.search(q, params=p or None, num=40, sort_by=None)
            for q, p in _queries(case)]


@pytest.fixture(scope="module", params=CASES)
def pair(request, tmp_path_factory):
    case = request.param
    jix = _build(rs, case)
    tix = _build(rt, case)
    if case in ("ivf", "host", "lvq"):
        _on_jax_centroids(tix, jix)
    return case, jix, tix, tmp_path_factory.mktemp(case.lower())


def test_jax_checkpoint_loads_in_the_port(pair):
    case, jix, _t, tmp = pair
    path = str(tmp / "from_jax")
    JC.save(jix, path)
    got = TC.load(path, device="cpu")
    assert type(got.schema) is rt.Schema
    assert type(got.schema.fields[0].type) is rt.FieldType
    assert type(got.doctable) is TD.DocTable
    assert len(got.segments) == len(jix.segments) == 1
    seg = got.segments[0]
    assert_same_segment(seg, segment_from_jax(jix.segments[0], "cpu"))
    assert_derived_fresh(seg)
    if case == "cold":
        assert seg.cold and isinstance(seg.text.doc_ids, np.ndarray)
    if case == "tags":
        assert seg.tags["kind"].codes is not None
    for (q, _p), a, b in zip(_queries(case), _results(got, case),
                             _results(jix, case)):
        _same(a, b, (case, q))


def test_port_checkpoint_loads_in_jax(pair):
    case, _j, tix, tmp = pair
    path = str(tmp / "from_port")
    TC.save(tix, path)
    got = JC.load(path)
    assert type(got.schema) is rs.Schema
    assert all(type(f.type) is rs.FieldType for f in got.schema.fields)
    assert type(got.doctable) is rs.index.index.DocTable
    if got.schema.fields[-1].vector is not None:
        assert type(got.schema.fields[-1].vector.metric) is rs.VectorMetric
    assert_same_segment(segment_from_jax(got.segments[0], "cpu"),
                        tix.segments[0])
    for (q, _p), a, b in zip(_queries(case), _results(got, case),
                             _results(tix, case)):
        _same(b, a, (case, q))


def test_port_checkpoint_loads_in_the_port(pair):
    case, _j, tix, tmp = pair
    path = str(tmp / "port_port")
    c = rt.Client(device="cpu")
    c._indexes["src"] = tix
    c.save_index("src", path)
    got = c.load_index("copy", path)
    assert c.ft_list() == ["copy", "src"]
    seg = got.segments[0]
    assert seg.uid != tix.segments[0].uid
    assert_same_segment(seg, tix.segments[0])
    assert_derived_fresh(seg)
    for (q, _p), a, b in zip(_queries(case), _results(got, case),
                             _results(tix, case)):
        _same(a, b, (case, q))
    if case == "deletes":
        # the loaded index goes on taking writes: a compaction and a new
        # segment
        got.delete_document("d1")
        got.compact()
        assert got.segments[0].n_deleted == 0
        got.add_document("new", {"t": "alpha omega", "cat": "c1",
                                 "x": 3.0})
        assert [h.key for h in got.search("omega").hits] == ["new"]


def test_checkpoint_names_jax_classes(tmp_path):
    """The port's host.pkl resolves to the JAX package's classes under
    plain `pickle.load` (as the JAX package reads it)."""
    ix = _build(rt, "tags")
    TC.save(ix, str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "host.pkl", "rb") as f:
        host = pickle.load(f)
    assert type(host["schema"]) is rs.Schema
    assert type(host["synonyms"]) is rs.analysis.synonyms.SynonymMap
    metas = list(host["doctable"]._metas.values())
    assert type(metas[0]) is rs.index.doctable.DocMeta
    assert host["vec_dtypes"] == [{}]


def test_vec_dtype_names_are_the_jax_packages(tmp_path):
    for case in ("vec-BFLOAT16", "vec-INT8", "lvq", "host"):
        ix = _build(rt, case)
        TC.save(ix, str(tmp_path / case))
        with open(tmp_path / case / "host.pkl", "rb") as f:
            dts = pickle.load(f)["vec_dtypes"][0]["v"]
        assert dts == {"vec-BFLOAT16": "bfloat16", "vec-INT8": "int8",
                       "lvq": "uint8", "host": "float32"}[case]


def test_other_jax_package_names_are_refused(tmp_path):
    ix = _build(rs, "ttl")
    path = str(tmp_path / "ck")
    JC.save(ix, path)
    with open(tmp_path / "ck" / "host.pkl", "wb") as f:
        pickle.dump({"schema": ix.segments[0].terms}, f)
    with pytest.raises(pickle.UnpicklingError,
                       match="redisearch_tpu.index.segment"):
        TC.load(path, device="cpu")


def test_bad_version_is_refused(tmp_path):
    ix = _build(rt, "ttl")
    path = tmp_path / "ck"
    TC.save(ix, str(path))
    (path / "meta.json").write_text('{"version": 2}')
    with pytest.raises(ValueError, match="version"):
        TC.load(str(path), device="cpu")
