"""Carry a sealed JAX segment across to the port.

`segment_from_jax(seg, device)` reads every array of a
`redisearch_tpu.index.segment.Segment` with `np.asarray` (which needs no
jax import) and returns the port's `Segment` holding the same values as
torch tensors on `device`.  The parity tests use it to run both packages
on one index.  bf16 vector matrices cross as their 16-bit patterns
(`_t`), so the port needs no bf16 numpy type.  What the JAX segment keeps
on the host stays on the host: a cold segment's CSR arrays, the host
tier's vectors and bucket slabs (with the LVQ8 pair); IVF arrays and the
host tier's centroids go to `device`, so both packages probe the same
centroids and lists.
"""

from __future__ import annotations

import numpy as np
import torch

from .index.segment import (GeoColumn, NumericColumn, Segment, StrColumn,
                            TagPostings, TermDict, TextPostings,
                            VectorColumn)
from .ops.ivf import HostIVF, IVFIndex


def _t(a, device):
    """Host copy of a JAX (or numpy) array as a tensor on `device`; a
    bf16 array (the JAX package's `ml_dtypes.bfloat16`) crosses as its
    bit patterns, reinterpreted as `torch.bfloat16`."""
    if a is None:
        return None
    # a writable copy: np.asarray of a JAX array is a read-only view
    h = np.array(a)
    if h.dtype.name == "bfloat16":
        return torch.as_tensor(h.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.as_tensor(h, device=device)


def _h(a):
    """A writable host numpy copy (None stays None)."""
    return None if a is None else np.array(a)


def _ivf(v, device):
    return IVFIndex(
        centroids=_t(v.centroids, device), cent_sq=_t(v.cent_sq, device),
        bucket_vecs=_t(v.bucket_vecs, device),
        bucket_sq=_t(v.bucket_sq, device),
        bucket_ids=_t(v.bucket_ids, device), nlist=int(v.nlist),
        list_pad=int(v.list_pad), dim=int(v.dim), metric=v.metric)


def _host_ivf(h, device):
    return HostIVF(
        centroids=_t(h.centroids, device), cent_sq=_t(h.cent_sq, device),
        bucket_vecs=_h(h.bucket_vecs), bucket_sq=_h(h.bucket_sq),
        bucket_ids=_h(h.bucket_ids), nlist=int(h.nlist),
        list_pad=int(h.list_pad), dim=int(h.dim), metric=h.metric,
        compression=h.compression, bucket_off=_h(h.bucket_off),
        bucket_scl=_h(h.bucket_scl))


def _vector_column(c, device) -> VectorColumn:
    """The port's VectorColumn of a JAX column: device arrays to
    `device`, a host-tier column's arrays kept on the host."""
    if c.host:
        return VectorColumn(
            vecs=_h(c.vecs), present=_t(c.present, device), dim=int(c.dim),
            sq_norms=_h(c.sq_norms), host=True,
            host_ivf=(None if c.host_ivf is None
                      else _host_ivf(c.host_ivf, device)),
            compression=c.compression, vq_off=_h(c.vq_off),
            vq_scl=_h(c.vq_scl))
    return VectorColumn(
        vecs=_t(c.vecs, device), present=_t(c.present, device),
        dim=int(c.dim), sq_norms=_t(c.sq_norms, device),
        scan_vecs=_t(c.scan_vecs, device), doc_rows=_t(c.doc_rows, device),
        multi=bool(c.multi),
        ivf=None if c.ivf is None else _ivf(c.ivf, device))


def segment_from_jax(seg, device) -> Segment:
    device = torch.device(device)
    cold = bool(seg.cold)

    def csr(a):
        # a cold segment's CSR arrays stay host numpy
        return _h(a) if cold else _t(a, device)
    tx = seg.text
    text = TextPostings(
        term_offsets=csr(tx.term_offsets),
        doc_ids=csr(tx.doc_ids),
        freqs=csr(tx.freqs),
        field_masks=csr(tx.field_masks),
        doclens=csr(tx.doclens),
        pos_offsets=csr(tx.pos_offsets),
        poskeys=csr(tx.poskeys),
        pos_stride=int(tx.pos_stride),
        nnz=int(tx.nnz),
        max_postings=int(tx.max_postings),
        pos_clamped=bool(tx.pos_clamped),
        term_offsets_np=np.asarray(tx.term_offsets_np),
        pos_offsets_np=np.asarray(tx.pos_offsets_np),
    )
    tags = {
        attr: TagPostings(
            ids=dict(tp.ids), values=list(tp.values),
            offsets=csr(tp.offsets), doc_ids=csr(tp.doc_ids),
            nnz=int(tp.nnz), max_postings=int(tp.max_postings),
            offsets_np=np.asarray(tp.offsets_np),
            codes=_t(tp.codes, device))
        for attr, tp in seg.tags.items()}
    numerics = {
        attr: NumericColumn(
            values=_t(c.values, device), present=_t(c.present, device),
            sorted_vals=_t(c.sorted_vals, device),
            sorted_docs=_t(c.sorted_docs, device),
            sorted_vals_np=(None if c.sorted_vals_np is None
                            else np.asarray(c.sorted_vals_np)),
            multi_values=_t(c.multi_values, device),
            multi_present=_t(c.multi_present, device),
            multi=bool(c.multi))
        for attr, c in seg.numerics.items()}
    strcols = {
        attr: StrColumn(value_ids=_t(s.value_ids, device),
                        table=list(s.table), order=_t(s.order, device))
        for attr, s in seg.strcols.items()}
    gids_np = np.array(seg.gids)
    alive_np = np.array(seg.alive)
    doclen_np = np.array(seg.doclen)
    return Segment(
        n_docs=int(seg.n_docs), n_pad=int(seg.n_pad), device=device,
        gids=_t(gids_np, device), alive=_t(alive_np, device),
        doclen=_t(doclen_np, device),
        max_freq=_t(seg.max_freq, device),
        docscore=_t(seg.docscore, device),
        expire_at=_t(seg.expire_at, device),
        terms=TermDict(ids=dict(seg.terms.ids), terms=list(seg.terms.terms),
                       doc_freq=np.asarray(seg.terms.doc_freq)),
        text=text, tags=tags, numerics=numerics, strcols=strcols,
        missing={a: _t(m, device) for a, m in seg.missing.items()},
        vectors={a: _vector_column(c, device)
                 for a, c in seg.vectors.items()},
        geos={a: GeoColumn(lon=_t(g.lon, device), lat=_t(g.lat, device),
                           present=_t(g.present, device))
              for a, g in seg.geos.items()},
        gid_to_local=dict(seg.gid_to_local),
        gids_np=gids_np, alive_np=alive_np, doclen_np=doclen_np,
        geometries={a: list(v) for a, v in seg.geometries.items()},
        n_deleted=int(seg.n_deleted), has_ttl=bool(seg.has_ttl),
        uniform_docscore=bool(seg.uniform_docscore), cold=cold,
        text_fexp=_t(seg.text_fexp, device),
        field_fexp={a: _t(v, device) for a, v in seg.field_fexp.items()},
    )
