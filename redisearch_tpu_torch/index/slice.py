"""Segment slicing: a sub-segment of a doc subset, cut from the CSR
arrays with no re-tokenizing.

Counterpart of `redisearch_tpu/index/slice.py`, which compaction and the
sharded build use.  The postings are filtered and remapped in host numpy
exactly as there (row masks, bincount, cumsum), then placed on the
segment's device (a cold segment's CSR arrays stay host numpy); the
dense columns are gathered where they live.  The result has the JAX
slice's layout array for array (`posting_pad` / `tail_pad` to the new
`cap`, LANE-rounded `nnz_pad` and `npos_pad`, position keys rebased to
the new local ids and padded to POS_SLICE_PAD with 2**31-1), and the
derived state the port's segment keeps beside it (the host mirrors, the
value-sorted numeric permutations, the bf16 scan copies) is built by the
same constructors as at seal (`index/segment.py`).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .segment import (LANE, GeoColumn, Segment, StrColumn, TermDict,
                      VectorColumn, bf16_scan_copy, make_numeric_column,
                      make_segment, next_pow2, round_up, tag_postings,
                      text_postings, _sq_norms)


def _ranges_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [start_i, start_i + len_i) ranges into one index
    array (the ragged-gather trick: arange + per-range base offsets)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.arange(total, dtype=np.int64)
            + np.repeat(starts.astype(np.int64) - cum, lens))


def _host(a) -> np.ndarray:
    """A host numpy view of a tensor (or numpy array)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _take(a, sel, n_pad: int, fill):
    """Rows `sel` of a per-doc array, padded to `n_pad` rows with
    `fill`, where the array lives (a tensor on its device, numpy on the
    host)."""
    if isinstance(a, torch.Tensor):
        out = torch.full((n_pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        out[:len(sel)] = a[torch.as_tensor(sel, device=a.device)]
        return out
    a = np.asarray(a)
    out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
    out[:len(sel)] = a[sel]
    return out


def slice_segment(seg: Segment, sel: np.ndarray,
                  timings: Optional[dict] = None) -> Segment:
    """New sealed Segment holding exactly the docs `sel` (ascending OLD
    local ids).  All postings/columns are filtered and remapped; the term
    dictionary is shared (doc_freq recomputed).  `timings`, when given,
    receives the seconds spent placing the CSR arrays and the doc
    columns on the device ("upload_s") and the rest ("slice_s")."""
    t0 = time.perf_counter()
    up = [0.0]
    device = seg.device

    def dev(a):
        ts = time.perf_counter()
        out = torch.as_tensor(np.ascontiguousarray(a), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        up[0] += time.perf_counter() - ts
        return out

    sel = np.asarray(sel, np.int64)
    n_new = int(sel.size)
    if n_new == 0:
        raise ValueError("empty doc selection")
    n_pad_new = round_up(n_new, LANE)
    cap = next_pow2(n_pad_new)

    remap = np.full(seg.n_pad, -1, np.int64)
    remap[sel] = np.arange(n_new, dtype=np.int64)

    def host_col(a, fill, dtype):
        out = np.full(n_pad_new, fill, dtype)
        out[:n_new] = _host(a)[sel]
        return out

    gids = host_col(seg.gids_np, 0, np.int32)
    alive = np.zeros(n_pad_new, bool)
    alive[:n_new] = True
    doclen = host_col(seg.doclen_np, 0, np.float32)
    max_freq = host_col(seg.max_freq, 1, np.float32)
    docscore = host_col(seg.docscore, 0, np.float32)
    expire_at = host_col(seg.expire_at, 0, np.int32)

    # ---- text postings CSR filter
    tx = seg.text
    to = np.asarray(tx.term_offsets_np, np.int64)
    n_terms = len(seg.terms)
    nnz_old = tx.nnz
    po = np.asarray(tx.pos_offsets_np, np.int64)
    doc_ids = _host(tx.doc_ids[:nnz_old])
    freqs = _host(tx.freqs[:nnz_old])
    masks = _host(tx.field_masks[:nnz_old])
    poskeys = _host(tx.poskeys[:int(po[nnz_old])])
    stride = tx.pos_stride

    keep = remap[doc_ids] >= 0
    term_of = np.repeat(np.arange(n_terms, dtype=np.int64), np.diff(to))
    kept = np.flatnonzero(keep)
    new_doc = remap[doc_ids[kept]].astype(np.int32)
    new_counts = np.bincount(term_of[kept], minlength=n_terms)
    new_to = np.zeros(n_terms + 1, np.int64)
    np.cumsum(new_counts, out=new_to[1:])
    nnz_new = int(new_to[-1])
    nnz_pad = round_up(max(nnz_new, 1), LANE)

    # positions of kept postings, doc-part rebased to the new local ids
    p_starts = po[kept]
    p_lens = po[kept + 1] - p_starts
    pk = poskeys[_ranges_concat(p_starts, p_lens)].astype(np.int64)
    pk = pk % stride + np.repeat(new_doc.astype(np.int64) * stride, p_lens)
    npos_new = int(pk.size)
    npos_pad = round_up(max(npos_new, 1), LANE)
    new_po = np.zeros(nnz_new + 1, np.int64)
    np.cumsum(p_lens, out=new_po[1:])

    di = np.zeros(nnz_pad, np.int32)
    di[:nnz_new] = new_doc
    fr = np.zeros(nnz_pad, np.float32)
    fr[:nnz_new] = freqs[kept]
    ms = np.zeros((nnz_pad,) + masks.shape[1:], np.int32)
    ms[:nnz_new] = masks[kept]
    po_pad = np.zeros(nnz_pad + 1, np.int64)
    po_pad[:nnz_new + 1] = new_po
    po_pad[nnz_new + 1:] = new_po[-1]
    pkp = np.zeros(npos_pad, np.int32)
    pkp[:npos_new] = pk

    # cold segments keep their CSR arrays host-resident through compaction
    csr = np.ascontiguousarray if seg.cold else dev
    text = text_postings(
        new_to.astype(np.int32), di, fr, ms, doclen[di], po_pad, pkp, csr,
        cap=cap, pos_stride=stride, pos_clamped=tx.pos_clamped, nnz=nnz_new,
        max_postings=int(new_counts.max()) if n_terms else 0)
    terms = TermDict(ids=seg.terms.ids, terms=seg.terms.terms,
                     doc_freq=new_counts.astype(np.int32))

    # ---- tag postings
    tags = {}
    for attr, tp in seg.tags.items():
        t_off = np.asarray(tp.offsets_np, np.int64)
        t_docs = _host(tp.doc_ids[:tp.nnz])
        n_vals = len(tp.values)
        row_of = np.repeat(np.arange(n_vals, dtype=np.int64),
                           np.diff(t_off))
        tkeep = np.flatnonzero(remap[t_docs] >= 0)
        t_counts = np.bincount(row_of[tkeep], minlength=n_vals)
        t_new_off = np.zeros(n_vals + 1, np.int64)
        np.cumsum(t_counts, out=t_new_off[1:])
        t_nnz = int(t_new_off[-1])
        t_ids = np.zeros(round_up(max(t_nnz, 1), LANE), np.int32)
        t_ids[:t_nnz] = remap[t_docs[tkeep]]
        # single-valuedness is preserved by slicing: carry the dense
        # value-id column through the doc remap
        codes = (None if tp.codes is None
                 else _take(tp.codes, sel, n_pad_new, -1))
        tags[attr] = tag_postings(
            tp.ids, tp.values, t_new_off.astype(np.int32), t_ids, csr,
            cap=cap, nnz=t_nnz,
            max_postings=int(t_counts.max()) if n_vals else 0, codes=codes)

    # ---- dense columns
    numerics = {}
    for attr, col in seg.numerics.items():
        pres = _host(col.present)[sel]
        colv = np.full(n_pad_new, np.nan, np.float32)
        if col.multi:
            mv = _host(col.multi_values)[sel]
            mp = _host(col.multi_present)[sel]
            value_lists = [list(mv[i][mp[i]]) for i in range(n_new)]
            colv[:n_new] = [v[0] if v else np.nan for v in value_lists]
            numerics[attr] = make_numeric_column(colv, n_new, device,
                                                 value_lists=value_lists)
        else:
            colv[:n_new] = np.where(pres, _host(col.values)[sel], np.nan)
            numerics[attr] = make_numeric_column(colv, n_new, device)
    geos = {attr: GeoColumn(lon=_take(g.lon, sel, n_pad_new, 0),
                            lat=_take(g.lat, sel, n_pad_new, 0),
                            present=_take(g.present, sel, n_pad_new, False))
            for attr, g in seg.geos.items()}
    strcols = {}
    for attr, sc in seg.strcols.items():
        ids = _take(sc.value_ids, sel, n_pad_new, -1)
        # the seal's columns hold ids in sorted order, so order is ids
        order = (ids if sc.order is sc.value_ids
                 else _take(sc.order, sel, n_pad_new, -1))
        strcols[attr] = StrColumn(value_ids=ids, table=sc.table, order=order)
    vectors = {attr: _slice_vectors(vc, sel, n_new, n_pad_new, device)
               for attr, vc in seg.vectors.items()}
    missing = {attr: _take(m, sel, n_pad_new, False)
               for attr, m in seg.missing.items()}
    text_fexp = (None if seg.text_fexp is None
                 else _take(seg.text_fexp, sel, n_pad_new, 0))
    field_fexp = {attr: _take(c, sel, n_pad_new, 0)
                  for attr, c in seg.field_fexp.items()}
    geometries = {attr: [lst[j] if j < len(lst) else None for j in sel]
                  for attr, lst in seg.geometries.items()}

    ts = time.perf_counter()
    out = make_segment(
        device, n_new, gids, alive, doclen, max_freq, docscore, expire_at,
        terms=terms, text=text, tags=tags, numerics=numerics, geos=geos,
        strcols=strcols, vectors=vectors, missing=missing,
        geometries=geometries, text_fexp=text_fexp, field_fexp=field_fexp,
        cold=seg.cold)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    up[0] += time.perf_counter() - ts
    if timings is not None:
        timings["upload_s"] = up[0]
        timings["slice_s"] = time.perf_counter() - t0 - up[0]
    return out


def _slice_vectors(vc: VectorColumn, sel: np.ndarray, n_new: int,
                   n_pad_new: int, device) -> VectorColumn:
    """One vector column cut to the docs `sel`.  A multi-value column
    compacts its rows (squared norms taken anew from the kept rows); the
    host tier rebuilds its bucket slabs around the KEPT centroids
    (assignment only, no k-means retrain), LVQ8 codes and their
    dequantization pair slice exactly (no re-encode); a device column
    keeps its stored values bit for bit."""
    if vc.multi:
        dr = _host(vc.doc_rows)[sel]                    # [n_new, M]
        used = dr[dr >= 0]
        row_remap = np.full(int(vc.vecs.shape[0]), -1, np.int64)
        row_remap[used] = np.arange(used.size)
        R_pad = max(round_up(int(used.size), 8), 8)
        rows = _take(vc.vecs, used, R_pad, 0)
        new_dr = np.full((n_pad_new, dr.shape[1]), -1, np.int32)
        new_dr[:n_new] = np.where(dr >= 0, row_remap[dr], -1)
        pres = np.zeros(n_pad_new, bool)
        pres[:n_new] = _host(vc.present)[sel]
        sq = _sq_norms(rows.float().cpu().numpy())
        return VectorColumn(
            vecs=rows, present=torch.as_tensor(pres, device=device),
            dim=vc.dim, sq_norms=torch.as_tensor(sq, device=device),
            doc_rows=torch.as_tensor(new_dr, device=device), multi=True)
    if vc.host:
        from ..ops.ivf import HostIVF
        mat = _take(vc.vecs, sel, n_pad_new, 0)
        pres = _host(_take(vc.present, sel, n_pad_new, False))
        sq = _take(vc.sq_norms, sel, n_pad_new, 0)
        off = scl = None
        if vc.compression:
            off = _take(vc.vq_off, sel, n_pad_new, 0)
            scl = _take(vc.vq_scl, sel, n_pad_new, 0)
        hivf = None
        if vc.host_ivf is not None:
            cents = _host(vc.host_ivf.centroids)
            metric = vc.host_ivf.metric
            if vc.compression:
                hivf = HostIVF.build_lvq(mat, off, scl, pres, metric,
                                         centroids=cents, device=device)
            else:
                hivf = HostIVF.build(mat, pres, metric, centroids=cents,
                                     device=device)
        return VectorColumn(
            vecs=mat, present=torch.as_tensor(pres, device=device),
            dim=vc.dim, sq_norms=sq, host=True, host_ivf=hivf,
            compression=vc.compression, vq_off=off, vq_scl=scl)
    vecs = _take(vc.vecs, sel, n_pad_new, 0)
    return VectorColumn(
        vecs=vecs, present=_take(vc.present, sel, n_pad_new, False),
        dim=vc.dim, sq_norms=_take(vc.sq_norms, sel, n_pad_new, 0),
        scan_vecs=bf16_scan_copy(vecs))


def live_locals(seg: Segment, doctable) -> np.ndarray:
    """Ascending old local ids of live (non-deleted) docs."""
    gids = seg.gids_np[:seg.n_docs]
    out = []
    for j in np.flatnonzero(seg.alive_np[:seg.n_docs]):
        meta = doctable.get(int(gids[j]))
        if meta is not None and not meta.deleted:
            out.append(j)
    return np.asarray(out, np.int64)
