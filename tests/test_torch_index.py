"""The port's write path against the JAX package's, on the CPU.

The same documents (made from a seeded numpy generator) go through the
JAX builder and the port's builder, incrementally (`add_document` +
`commit`) and in bulk (`add_documents`, the native tokenizer).  Every
array of the sealed segments must be equal — values, dtypes, pads and
layouts — and so must the host mirrors and the clean-segment flags.
`segment_from_jax` must carry a JAX segment across unchanged.
Tolerance: none; every comparison is exact.

The two packages' bulk paths each run a native tokenizer or, without
one, the pure-Python builder, and the two kinds number terms in
different orders.  `align_builders` makes both sides the same kind
before a comparison, so the comparison is always exact and always made.
"""

import numpy as np
import pytest
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu import native as JN
from redisearch_tpu_torch import native as TN
from redisearch_tpu_torch.convert import segment_from_jax

WORDS = ["running", "runs", "jumped", "jumping", "quickly", "quicker",
         "alpha", "beta", "the", "and", "gamma", "delta", "walker"]


def _docs(n, seed=5):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        f = {"a": " ".join(rng.choice(WORDS, 3)),
             "b": " ".join(rng.choice(WORDS, 6)),
             "cat": f"c{i % 7}",
             "labels": ",".join(sorted({f"l{i % 3}", f"l{(i * 5) % 4}"})),
             "grp": f"g{i % 11}",
             "price": float(rng.integers(1, 1000))}
        if i % 5:
            f["qty"] = ([float(i % 4), float(i % 9)] if i % 13 == 0
                        else float(i % 17))
        if i % 9 == 0:
            del f["b"]
        docs.append((f"d{i}", f))
    return docs


def _fields(pkg):
    F, T = pkg.Field, pkg.FieldType
    return [F("a", T.TEXT, weight=2.0), F("b", T.TEXT), F("cat", T.TAG),
            F("labels", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True), F("qty", T.NUMERIC)]


def align_builders(monkeypatch) -> bool:
    """Make both packages' bulk builders the same kind; returns whether
    both run native.

    The JAX package compiles its native library straight onto its final
    path, so a process that loads it while another process is still
    writing it gets an OSError and keeps the pure-Python builder for the
    rest of its life (`_tried` set, `_lib` None).  The library is whole
    by the time a test runs, so that state is loaded once more.  Where the
    JAX side still has no native library, the port's loader is pinned to
    None too (and the other way round): both sides then run pure Python.
    """
    if JN._tried and JN._lib is None:
        JN._tried = False
    if not JN.available():
        monkeypatch.setattr(TN, "_load", lambda: None)
    elif not TN.available():
        monkeypatch.setattr(JN, "_load", lambda: None)
    assert JN.available() == TN.available()
    return TN.available()


def _build(mode, n=400):
    docs = _docs(n)
    jix = rs.SearchIndex(rs.Schema(name="ix", fields=_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="ix", fields=_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        if mode == "add_document":
            for key, f in docs:
                ix.add_document(key, dict(f))
            ix.commit()
        else:
            ix.add_documents([(k, dict(f)) for k, f in docs])
    assert len(jix.segments) == len(tix.segments) == 1
    return jix, tix


def _eq(j, t, what):
    if j is None or t is None:
        assert j is None and t is None, what
        return
    a = np.asarray(j)
    b = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_segment(js, ts):
    for name in ("n_docs", "n_pad", "n_deleted", "has_ttl",
                 "uniform_docscore"):
        assert getattr(js, name) == getattr(ts, name), name
    for name in ("gids", "alive", "doclen", "max_freq", "docscore",
                 "expire_at"):
        _eq(getattr(js, name), getattr(ts, name), name)
    _eq(js.gids_host, ts.gids_host, "gids_host")
    _eq(js.alive, ts.alive_np, "alive mirror")
    _eq(js.doclen, ts.doclen_np, "doclen mirror")
    assert js.gid_to_local == ts.gid_to_local
    assert js.terms.ids == ts.terms.ids and js.terms.terms == ts.terms.terms
    _eq(js.terms.doc_freq, ts.terms.doc_freq, "doc_freq")
    for name in ("pos_stride", "pos_clamped", "nnz", "max_postings"):
        assert getattr(js.text, name) == getattr(ts.text, name), name
    for name in ("term_offsets", "doc_ids", "freqs", "field_masks",
                 "doclens", "pos_offsets", "poskeys", "term_offsets_np",
                 "pos_offsets_np"):
        _eq(getattr(js.text, name), getattr(ts.text, name), f"text.{name}")
    assert js.tags.keys() == ts.tags.keys()
    for attr, jt in js.tags.items():
        tt = ts.tags[attr]
        assert jt.ids == tt.ids and jt.values == tt.values, attr
        assert (jt.nnz, jt.max_postings) == (tt.nnz, tt.max_postings)
        for name in ("offsets", "doc_ids", "offsets_np", "codes"):
            _eq(getattr(jt, name), getattr(tt, name), f"tag {attr}.{name}")
        _eq(js.tag_pcodes(attr), ts.tag_pcodes(attr), f"pcodes {attr}")
    assert js.numerics.keys() == ts.numerics.keys()
    for attr, jc in js.numerics.items():
        tc = ts.numerics[attr]
        assert jc.multi == tc.multi, attr
        for name in ("values", "present", "sorted_vals", "sorted_docs",
                     "sorted_vals_np", "multi_values", "multi_present"):
            _eq(getattr(jc, name), getattr(tc, name), f"num {attr}.{name}")
    assert js.strcols.keys() == ts.strcols.keys()
    for attr, jc in js.strcols.items():
        tc = ts.strcols[attr]
        assert jc.table == tc.table, attr
        _eq(jc.value_ids, tc.value_ids, f"strcol {attr}")
        _eq(jc.order, tc.order, f"strcol {attr} order")
    assert js.missing.keys() == ts.missing.keys()
    for attr in js.missing:
        _eq(js.missing[attr], ts.missing[attr], f"missing {attr}")
    assert js.text_fexp is None and ts.text_fexp is None
    assert js.field_fexp == {} and ts.field_fexp == {}


@pytest.mark.parametrize("mode", ["add_document", "add_documents"])
def test_builder_matches_jax(mode, monkeypatch):
    align_builders(monkeypatch)
    jix, tix = _build(mode)
    assert_same_segment(jix.segments[0], tix.segments[0])
    # the doc tables agree too (BM25 reads N and avgdl from them)
    assert jix.doctable.num_docs == tix.doctable.num_docs
    assert jix.doctable.total_doclen == tix.doctable.total_doclen


def test_bulk_matches_incremental_in_the_port():
    _, inc = _build("add_document")
    _, bulk = _build("add_documents")
    a, b = inc.segments[0], bulk.segments[0]
    assert a.terms.ids.keys() == b.terms.ids.keys()
    assert a.text.nnz == b.text.nnz and a.n_docs == b.n_docs
    assert a.memory_bytes() > 0


def test_segment_from_jax_round_trip(monkeypatch):
    align_builders(monkeypatch)
    jix, tix = _build("add_documents")
    conv = segment_from_jax(jix.segments[0], "cpu")
    assert conv.device == torch.device("cpu")
    assert_same_segment(jix.segments[0], conv)
    assert_same_segment(jix.segments[0], tix.segments[0])


@pytest.mark.parametrize("jax_side", ["raced", "no-native"])
def test_builder_parity_when_jax_falls_back(jax_side, monkeypatch):
    """The JAX side's fallback forced: a raced load (`_tried` set, `_lib`
    None), which `align_builders` loads again, and a JAX side with no
    native library at all, which pins the port to pure Python.  Both
    parity tests still run and compare exactly."""
    if jax_side == "raced":
        monkeypatch.setattr(JN, "_tried", True)
        monkeypatch.setattr(JN, "_lib", None)
    else:
        monkeypatch.setattr(JN, "_load", lambda: None)
    native = align_builders(monkeypatch)
    assert native == (jax_side == "raced" and JN._lib is not None)
    test_builder_matches_jax("add_documents", monkeypatch)
    test_segment_from_jax_round_trip(monkeypatch)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a CUDA device, `Client()` and `SearchIndex(schema)` raise
    and name `device="cpu"`; with it they run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema = rt.Schema(name="ix", fields=_fields(rt))
    for make in (rt.Client, lambda: rt.SearchIndex(schema)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    c = rt.Client(device="cpu")
    ix = c.ft_create("ix", _fields(rt))
    assert ix.device == torch.device("cpu")
    ix.add_documents(_docs(20))
    assert ix.segments[0].device == torch.device("cpu")
    assert rt.SearchIndex(schema, device="cpu").device.type == "cpu"


def test_mark_deleted_writes_in_place():
    _, tix = _build("add_document", n=200)
    seg = tix.segments[0]
    alive = seg.alive
    assert seg.num_alive == 200
    tix.add_document("d7", {"a": "alpha"})     # re-index: old copy dies
    assert seg.alive is alive and not bool(alive[7])
    assert seg.n_deleted == 1 and seg.num_alive == 199
    assert not seg.alive_np[7]


@pytest.mark.parametrize("field,item", [
    ("vector", "A7"), ("geo", "A6"), ("host", "A6")])
def test_unported_schemas_raise(field, item):
    """The schemas the port once refused, naming their ROADMAP item, are
    served since their items landed (A8: the IVF family, here HNSW;
    A6-geo: GEO fields; A6-cold: `storage="host"`): the port seals them
    as the JAX package does and answers a query on them as it does."""
    del item
    docs = [(f"d{i}", {"t": "alpha" if i % 2 else "alpha beta",
                       "g": f"{2 + i * 0.001:.4f},48.0",
                       "v": np.full(4, float(i % 7), np.float32)})
            for i in range(300)]
    out = []
    for p in (rs, rt):
        F, T = p.Field, p.FieldType
        fields = [F("t", T.TEXT)]
        kw = {}
        if field == "vector":
            fields.append(F("v", T.VECTOR, vector=p.VectorParams(
                dim=4, algo="HNSW", nlist=4, nprobe=4, flat_buffer_limit=64)))
            q, params = "*=>[KNN 5 @v $b]", {"b": np.full(4, 3.2,
                                                        np.float32)}
        elif field == "geo":
            fields.append(F("g", T.GEO))
            q, params = "beta @g:[2.1 48.0 5 km]", None
        else:
            kw["storage"] = "host"
            q, params = "beta -alpha", None
        schema = p.Schema(name="x", fields=fields, **kw)
        ix = (p.SearchIndex(schema) if p is rs
              else p.SearchIndex(schema, device="cpu"))
        for k, f in docs:
            ix.add_document(k, f)
        ix.commit()
        res = ix.search(q, params=params, num=10)
        out.append((res.total, [h.key for h in res.hits]))
    assert out[0] == out[1]
    seg = ix.segments[0]
    assert {"vector": seg.vectors.get("v") is not None
            and seg.vectors["v"].ivf is not None,
            "geo": "g" in seg.geos, "host": seg.cold}[field]
