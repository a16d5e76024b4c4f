"""Bulk ingestion: the native tokenizer path producing a Segment directly.

Port of `redisearch_tpu/index/bulk.py::bulk_add`.  TEXT fields stream
through the C++ tokenizer (`native/bulk_indexer.cpp`, bound by the
port's `native.py` and built into `redisearch_tpu_torch/_build/` on first
use); stems are merged afterwards by `_merge_stems`; structured columns
are vectorized numpy.  `can_use_native`, `_merge_stems` and `_stage_tag`
are copies of the JAX module's.  The arrays, pads and layouts are the JAX path's own;
only the last step differs: they land as torch tensors on the index's
device.  Schemas the native path does not cover fall back to the
incremental builder, as in the JAX package.

Two differences from the JAX module.  A cold schema (`storage="host"`)
seals here too, its text and tag CSR arrays kept as host numpy as the
incremental builder keeps them (the JAX module falls back to its slower
incremental builder; results are the same).  A `storage="host"` vector
field goes to the host tier here, as both packages' incremental
builders put it (the JAX module's bulk seal leaves it on the device).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .. import native
from ..schema import FieldType
from ..utils.jsonpath import get_field_value
from .builder import (MAX_POS_STRIDE, SegmentBuilder, make_geo_column,
                      seal_vector_column)
from .segment import (LANE, StrColumn, TermDict, build_tag_codes,
                      make_numeric_column, make_segment, next_pow2,
                      round_up, tag_postings, text_postings)


def can_use_native(index) -> bool:
    if not native.available():
        return False
    if len(index.synonyms) > 0:
        return False
    if any(f.phonetic for f in index.schema.text_fields()):
        return False
    if any(f.nostem for f in index.schema.text_fields()):
        # the stem post-pass merges whole postings; it cannot split a
        # posting's freq between stemmed and NOSTEM fields
        return False
    if index.schema.language_field is not None:
        return False
    if index.schema.num_text_fields > 31:
        # the native tokenizer packs field bits into a single int32;
        # multi-word masks (up to 128 TEXT fields) use the Python builder
        return False
    return True


def bulk_add(index, docs: Iterable[tuple[str, dict]],
             commit: bool = True) -> int:
    """Add many documents at once.  Returns the number indexed."""
    if not can_use_native(index):
        n = 0
        for key, fields in docs:
            index.add_document(key, fields)
            n += 1
        if commit:
            index.commit()
        return n

    index.commit()  # seal any pending incremental docs first
    schema = index.schema
    device = index.device

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    # a cold schema keeps the text and tag CSR arrays on the host
    csr = np.ascontiguousarray if schema.storage == "host" else dev

    # the native tokenizer does NOT stem: stems are synthesized from the
    # raw-term CSR afterwards (_merge_stems) with the index language's
    # Snowball stemmer
    nb = native.NativeTextBuilder(list(index.stopwords), stem=False)
    text_fields = schema.text_fields()
    tf_ids = [f.field_id for f in text_fields]
    tf_w = [f.weight for f in text_fields]

    metas = []
    tag_stage = {f.attribute: {} for f in schema.fields
                 if f.type == FieldType.TAG}
    num_stage = {f.attribute: [] for f in schema.fields
                 if f.type == FieldType.NUMERIC}
    str_stage = {f.attribute: [] for f in schema.fields
                 if f.sortable and f.type in (FieldType.TEXT, FieldType.TAG)}
    vec_stage = {f.attribute: [] for f in schema.fields
                 if f.type == FieldType.VECTOR}
    present_stage = {f.attribute: [] for f in schema.fields}
    geom_stage = {f.attribute: [] for f in schema.fields
                  if f.type == FieldType.GEOMETRY}
    geo_stage = {f.attribute: [] for f in schema.fields
                 if f.type == FieldType.GEO}

    helper = SegmentBuilder(schema, index.stopwords, None,
                            device)  # field parsers
    local = 0
    for key, fields in docs:
        meta, old = index.doctable.put(key, fields)
        if old is not None:
            index._mark_deleted(old.gid)
        metas.append(meta)
        texts = []
        for f in text_fields:
            v = get_field_value(fields, f.name)
            if isinstance(v, (list, tuple)):
                v = " ".join(str(x) for x in v)
            texts.append(str(v).encode("utf-8") if v is not None else b"")
        doclen = nb.add_doc(texts, tf_ids, tf_w)
        meta.doclen = int(doclen)
        for f in schema.fields:
            raw = get_field_value(fields, f.name)
            if isinstance(raw, (str, bytes)) or raw is None:
                present_stage[f.attribute].append(
                    raw is not None and (raw != "" or f.indexempty))
            else:
                present_stage[f.attribute].append(True)
            if f.type == FieldType.NUMERIC:
                num_stage[f.attribute].append(helper._parse_numeric(f, raw))
            elif f.type == FieldType.TAG:
                joined = _stage_tag(f, raw, local, tag_stage[f.attribute])
                if f.sortable:
                    str_stage[f.attribute].append(joined)
            elif f.type == FieldType.GEO:
                geo_stage[f.attribute].append(helper._parse_geo(f, raw))
            elif f.type == FieldType.VECTOR:
                vec_stage[f.attribute].append(helper._parse_vector(f, raw))
            elif f.type == FieldType.GEOMETRY:
                from ..utils import wkt
                geom_stage[f.attribute].append(
                    wkt.parse(str(raw)) if raw is not None else None)
            elif f.type == FieldType.TEXT and f.sortable:
                val = str(raw) if raw is not None else None
                if val is not None and not f.unf:
                    val = val.casefold()
                str_stage[f.attribute].append(val)
        local += 1

    n = local
    if n == 0:
        return 0
    (terms, term_offsets, doc_ids, freqs, masks, pos_offsets, positions,
     doc_lens, max_freqs_arr, max_pos, max_postings) = nb.finish()
    (terms, term_offsets, doc_ids, freqs, masks, pos_offsets, positions,
     max_postings) = _merge_stems(
        schema.language, terms, term_offsets, doc_ids, freqs, masks,
        pos_offsets, positions, max_postings, max_freqs_arr)

    for meta, dl_i, mf in zip(metas, doc_lens, max_freqs_arr):
        index.doctable.set_doclen(meta.gid, int(dl_i), int(mf))

    n_pad = round_up(n, LANE)
    pos_stride = min(next_pow2(int(max_pos) + 2), MAX_POS_STRIDE)
    while pos_stride > 2 and n_pad * pos_stride >= 2**31:
        pos_stride //= 2

    nnz = doc_ids.shape[0]
    nnz_pad = round_up(max(nnz, 1), LANE)
    npos = positions.shape[0]
    npos_pad = round_up(max(npos, 1), LANE)

    di = np.zeros(nnz_pad, np.int32)
    di[:nnz] = doc_ids
    fr = np.zeros(nnz_pad, np.float32)
    fr[:nnz] = freqs
    ms = np.zeros(nnz_pad, np.int32)
    ms[:nnz] = masks
    po = np.zeros(nnz_pad + 1, np.int64)
    po[:nnz + 1] = pos_offsets
    po[nnz + 1:] = pos_offsets[nnz]
    # poskeys = doc * stride + min(pos, stride-1), vectorized
    counts = np.diff(pos_offsets)
    docrep = np.repeat(doc_ids, counts)
    pk = np.zeros(npos_pad, np.int32)
    pk[:npos] = docrep.astype(np.int64) * pos_stride + np.minimum(
        positions, pos_stride - 1)

    doc_freq = np.diff(term_offsets).astype(np.int32)
    td = TermDict(ids={t: i for i, t in enumerate(terms)}, terms=terms,
                  doc_freq=doc_freq)
    cap = next_pow2(n_pad)
    dl = np.zeros(n_pad, np.float32)
    dl[:n] = doc_lens
    posting_dl = dl[di]  # per-posting doc length
    text = text_postings(
        term_offsets, di, fr, ms, posting_dl, po, pk, csr, cap=cap,
        pos_offsets_np=pos_offsets, pos_stride=pos_stride,
        pos_clamped=bool(npos and positions.max() > pos_stride - 1),
        nnz=int(nnz), max_postings=int(max_postings))

    gids = np.zeros(n_pad, np.int32)
    gids[:n] = [m.gid for m in metas]
    alive = np.zeros(n_pad, bool)
    alive[:n] = True
    mf = np.ones(n_pad, np.float32)
    mf[:n] = max_freqs_arr
    ds = np.zeros(n_pad, np.float32)
    ds[:n] = [m.score for m in metas]
    exp = np.zeros(n_pad, np.int32)
    exp[:n] = [int(m.expires_at) if m.expires_at else 0 for m in metas]

    tags = {}
    for attr, stage in tag_stage.items():
        values = sorted(stage)
        t_off = np.zeros(len(values) + 1, np.int64)
        t_nnz = 0
        t_max = 0
        for i, v in enumerate(values):
            t_off[i] = t_nnz
            t_nnz += len(stage[v])
            t_max = max(t_max, len(stage[v]))
        t_off[len(values)] = t_nnz
        t_ids = np.zeros(round_up(max(t_nnz, 1), LANE), np.int32)
        at = 0
        for v in values:
            lst = stage[v]
            t_ids[at:at + len(lst)] = lst
            at += len(lst)
        tags[attr] = tag_postings(
            {v: i for i, v in enumerate(values)}, values,
            t_off.astype(np.int32), t_ids, csr, cap=cap, nnz=int(t_nnz),
            max_postings=int(t_max),
            codes=build_tag_codes(stage, values, n_pad, device))

    numerics = {}
    for attr, vals in num_stage.items():
        col = np.full(n_pad, np.nan, np.float32)
        col[:n] = [v[0] if v else np.nan for v in vals]
        numerics[attr] = make_numeric_column(col, n, device,
                                             value_lists=vals)
    strcols = {}
    for attr, vals in str_stage.items():
        uniq = sorted({v for v in vals if v is not None})
        idmap = {v: i for i, v in enumerate(uniq)}
        ids = np.full(n_pad, -1, np.int32)
        ids[:n] = [idmap.get(v, -1) if v is not None else -1 for v in vals]
        ids_t = dev(ids)
        strcols[attr] = StrColumn(value_ids=ids_t, table=uniq, order=ids_t)
    missing = {}
    for attr, pres in present_stage.items():
        m = np.zeros(n_pad, bool)
        m[:n] = pres
        missing[attr] = dev(m)
    vectors = {attr: seal_vector_column(schema, attr, rows, n_pad, device)
               for attr, rows in vec_stage.items()}
    geos = {attr: make_geo_column(vals, n, n_pad, device)
            for attr, vals in geo_stage.items()}

    seg = make_segment(
        device, n, gids, alive, dl, mf, ds, exp, terms=td, text=text,
        tags=tags, numerics=numerics, strcols=strcols, missing=missing,
        vectors=vectors, geos=geos,
        geometries={a: list(v) for a, v in geom_stage.items()},
        cold=schema.storage == "host")
    index.segments.append(seg)
    return n


def _merge_stems(language, terms, term_offsets, doc_ids, freqs, masks,
                 pos_offsets, positions, max_postings, max_freqs_arr):
    """Synthesize '+stem' postings by merging raw-term postings.

    Equivalent to per-token stem forward-indexing (builder.py _add_text:
    every stemmable token also writes STEM_PREFIX+stem into the forward
    index — reference: StemmerExpander-compatible '+term' entries): a
    stem's posting at doc d has freq = sum of member-term freqs, field
    mask = OR, positions = sorted union.  `max_freqs_arr` is updated in
    place so per-doc maxTermFreq covers stem entries like the reference's
    forward index does.

    All folds are vectorized (lexsort + reduceat) — no per-posting Python.
    """
    from ..analysis.stemmer import Stemmer

    st = Stemmer(language or "english")
    groups: dict[str, list[int]] = {}
    for tid, t in enumerate(terms):
        # tokenizer MIN_STEM_CANDIDATE_LEN: only terms of >= 4 chars stem
        if len(t) < 4 or t[0] in ("+", "\x01", "~"):
            continue
        s = st.stem(t)
        if s:
            groups.setdefault("+" + s, []).append(tid)
    if not groups:
        return (terms, term_offsets, doc_ids, freqs, masks, pos_offsets,
                positions, max_postings)

    stem_terms = sorted(groups)
    to = np.asarray(term_offsets, np.int64)
    po_all = np.asarray(pos_offsets, np.int64)
    member_tids = np.concatenate(
        [np.asarray(groups[s], np.int64) for s in stem_terms])
    member_gid = np.concatenate(
        [np.full(len(groups[s]), gi, np.int64)
         for gi, s in enumerate(stem_terms)])
    starts = to[member_tids]
    lens_ = to[member_tids + 1] - starts
    total = int(lens_.sum())
    cum = np.concatenate([[0], np.cumsum(lens_)[:-1]])
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - cum, lens_)
    g_rep = np.repeat(member_gid, lens_)

    order = np.lexsort((doc_ids[idx], g_rep))
    oi = idx[order]
    g_s = g_rep[order]
    d_s = doc_ids[oi]
    new_group = np.concatenate(
        [[True], (g_s[1:] != g_s[:-1]) | (d_s[1:] != d_s[:-1])])
    bounds = np.flatnonzero(new_group)
    out_gid = g_s[new_group]
    out_doc = d_s[new_group]
    out_freq = np.add.reduceat(freqs[oi], bounds).astype(np.float32)
    out_mask = np.bitwise_or.reduceat(masks[oi], bounds)

    # positions: concatenate member position runs in (stem, doc) order,
    # then sort within each fold group
    p_starts = po_all[oi]
    p_lens = po_all[oi + 1] - p_starts
    ptotal = int(p_lens.sum())
    pcum = np.concatenate([[0], np.cumsum(p_lens)[:-1]])
    pidx = (np.arange(ptotal, dtype=np.int64)
            + np.repeat(p_starts - pcum, p_lens))
    fold_id = np.cumsum(new_group) - 1
    fold_per_pos = np.repeat(fold_id, p_lens)
    s_pos = positions[pidx]
    po_order = np.lexsort((s_pos, fold_per_pos))
    s_pos = s_pos[po_order]
    out_pos_lens = np.add.reduceat(
        p_lens, bounds) if len(bounds) else np.zeros(0, np.int64)

    # per-doc maxTermFreq including stem entries
    d_order = np.argsort(out_doc, kind="stable")
    df = out_doc[d_order]
    db = np.concatenate([[True], df[1:] != df[:-1]])
    dmx = np.maximum.reduceat(out_freq[d_order], np.flatnonzero(db))
    du = df[db]
    max_freqs_arr[du] = np.maximum(max_freqs_arr[du], dmx)

    stem_counts = np.bincount(out_gid, minlength=len(stem_terms))
    new_terms = list(terms) + stem_terms
    new_to = np.concatenate(
        [to, to[-1] + np.cumsum(stem_counts)]).astype(term_offsets.dtype)
    new_doc_ids = np.concatenate([doc_ids, out_doc]).astype(doc_ids.dtype)
    new_freqs = np.concatenate([freqs, out_freq]).astype(freqs.dtype)
    new_masks = np.concatenate([masks, out_mask]).astype(masks.dtype)
    new_po = np.concatenate(
        [po_all, po_all[-1] + np.cumsum(out_pos_lens)])
    new_positions = np.concatenate([positions, s_pos]).astype(
        positions.dtype)
    max_postings = max(int(max_postings), int(stem_counts.max())
                       if len(stem_counts) else 0)
    return (new_terms, new_to, new_doc_ids, new_freqs, new_masks,
            new_po, new_positions, max_postings)


def _stage_tag(field, raw, local: int, stage: dict):
    if raw is None:
        return None
    if isinstance(raw, (list, tuple)):
        values = [str(v) for v in raw]
        joined = field.separator.join(values)
    else:
        joined = str(raw)
        values = [v.strip() for v in joined.split(field.separator)]
    for v in values:
        if v == "" and not field.indexempty:
            continue
        if not field.casesensitive:
            v = v.lower()
        lst = stage.get(v)
        if lst is None:
            stage[v] = [local]
        elif lst[-1] != local:
            lst.append(local)
    return joined
