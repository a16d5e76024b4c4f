"""Carry a sealed JAX segment across to the port.

`segment_from_jax(seg, device)` reads every array of a
`redisearch_tpu.index.segment.Segment` with `np.asarray` (which needs no
jax import) and returns the port's `Segment` holding the same values as
torch tensors on `device`.  The parity tests use it to run both packages
on one index.  bf16 vector matrices cross as their 16-bit patterns
(`_t`), so the port needs no bf16 numpy type.
"""

from __future__ import annotations

import numpy as np
import torch

from .index.segment import (NumericColumn, Segment, StrColumn, TagPostings,
                            TermDict, TextPostings, VectorColumn)


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


def _vector_column(c, device) -> VectorColumn:
    """The port's VectorColumn of a JAX FLAT `storage="hbm"` column."""
    if c.host or c.ivf is not None or c.compression:
        raise NotImplementedError(
            "IVF, host-tier and LVQ vector columns are not ported yet "
            "(ROADMAP A8)")
    return VectorColumn(
        vecs=_t(c.vecs, device), present=_t(c.present, device),
        dim=int(c.dim), sq_norms=_t(c.sq_norms, device),
        scan_vecs=_t(c.scan_vecs, device), doc_rows=_t(c.doc_rows, device),
        multi=bool(c.multi))


def segment_from_jax(seg, device) -> Segment:
    device = torch.device(device)
    if seg.cold:
        raise NotImplementedError(
            "cold (storage='host') segments are not ported yet "
            "(ROADMAP A6-cold)")
    if seg.geos:   # the port has no GEO columns yet
        raise NotImplementedError(
            "GEO columns are not ported yet (ROADMAP A6-geo)")
    tx = seg.text
    text = TextPostings(
        term_offsets=_t(tx.term_offsets, device),
        doc_ids=_t(tx.doc_ids, device),
        freqs=_t(tx.freqs, device),
        field_masks=_t(tx.field_masks, device),
        doclens=_t(tx.doclens, device),
        pos_offsets=_t(tx.pos_offsets, device),
        poskeys=_t(tx.poskeys, device),
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
            offsets=_t(tp.offsets, device), doc_ids=_t(tp.doc_ids, device),
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
        gid_to_local=dict(seg.gid_to_local),
        gids_np=gids_np, alive_np=alive_np, doclen_np=doclen_np,
        geometries={a: list(v) for a, v in seg.geometries.items()},
        n_deleted=int(seg.n_deleted), has_ttl=bool(seg.has_ttl),
        uniform_docscore=bool(seg.uniform_docscore),
        text_fexp=_t(seg.text_fexp, device),
        field_fexp={a: _t(v, device) for a, v in seg.field_fexp.items()},
    )
