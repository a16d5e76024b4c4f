"""Host-side segment builder: the write path.

The staging half (tokenize, stem, per-term postings, tag and numeric
staging) is the JAX package's own `SegmentBuilder`, reached through
`_host`.  This subclass ports `seal`: the same numpy arrays, with the
same pads and layouts, land as torch tensors on the index's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._host.index.builder import MAX_POS_STRIDE
from .._host.index.builder import SegmentBuilder as _HostBuilder
from .._host.schema import FieldType, Schema
from .segment import (LANE, POS_SLICE_PAD, Segment, StrColumn, TagPostings,
                      TermDict, TextPostings, build_tag_codes,
                      make_numeric_column, mask_words, next_pow2,
                      pack_mask_words, posting_pad, round_up, tail_pad)


def check_schema_ported(schema: Schema) -> None:
    """Refuse what the port cannot seal yet, naming the ROADMAP item."""
    if schema.storage == "host":
        raise NotImplementedError(
            "cold (storage='host') segments are not ported yet "
            "(ROADMAP A6)")
    for f in schema.fields:
        if f.type == FieldType.VECTOR:
            raise NotImplementedError(
                f"VECTOR field {f.name!r} is not ported yet (ROADMAP A7)")
        if f.type == FieldType.GEO:
            raise NotImplementedError(
                f"GEO field {f.name!r} is not ported yet (ROADMAP A6)")


class SegmentBuilder(_HostBuilder):
    """Accumulates documents on the host, then seals them into a torch
    Segment on `device`."""

    def __init__(self, schema: Schema, stopwords, synonyms, device):
        check_schema_ported(schema)
        super().__init__(schema, stopwords, synonyms)
        self.device = torch.device(device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def seal(self) -> Optional[Segment]:
        """Build the immutable device segment from staged docs (port of
        the JAX `SegmentBuilder.seal`: `jnp.asarray` becomes
        `torch.as_tensor(..., device=...)`)."""
        n = len(self._gids)
        if n == 0:
            return None
        dev = self._dev
        n_pad = round_up(n, LANE)

        # EXPIRE can land on a doc while it is still staged: re-read doc
        # TTLs from the live metas so the sealed columns carry them
        for i, m in enumerate(self._metas):
            self._expire[i] = (int(-(-m.expires_at // 1))
                               if m.expires_at else 0)

        gids = np.zeros(n_pad, np.int32)
        gids[:n] = self._gids
        alive = np.zeros(n_pad, bool)
        alive[:n] = True
        doclen = np.zeros(n_pad, np.float32)
        doclen[:n] = self._doclen
        max_freq = np.ones(n_pad, np.float32)
        max_freq[:n] = self._maxfreq
        docscore = np.zeros(n_pad, np.float32)
        docscore[:n] = self._docscore
        expire = np.zeros(n_pad, np.int32)
        expire[:n] = self._expire

        # ---- text postings CSR
        n_terms = len(self._term_order)
        pos_stride = min(next_pow2(self.max_positions + 2), MAX_POS_STRIDE)
        while pos_stride > 2 and n_pad * pos_stride >= 2**31:
            pos_stride //= 2
        term_offsets = np.zeros(n_terms + 1, np.int64)
        doc_freq = np.zeros(max(n_terms, 1), np.int32)
        nnz = 0
        npos = 0
        max_postings = 0
        for i, term in enumerate(self._term_order):
            st = self._terms[term]
            term_offsets[i] = nnz
            nnz += len(st.docs)
            max_postings = max(max_postings, len(st.docs))
            doc_freq[i] = st.doc_freq
            for plist in st.positions:
                npos += len(plist)
        term_offsets[n_terms] = nnz

        nnz_pad = round_up(nnz, LANE)
        npos_pad = round_up(npos, LANE)
        doc_ids = np.zeros(nnz_pad, np.int32)
        freqs = np.zeros(nnz_pad, np.float32)
        K_words = mask_words(self.schema.num_text_fields)
        field_masks = (np.zeros(nnz_pad, np.int32) if K_words == 1
                       else np.zeros((nnz_pad, K_words), np.int32))
        pos_offsets = np.zeros(nnz_pad + 1, np.int64)
        poskeys = np.zeros(npos_pad, np.int32)
        at = 0
        pat = 0
        for term in self._term_order:
            st = self._terms[term]
            m = len(st.docs)
            doc_ids[at:at + m] = st.docs
            freqs[at:at + m] = st.freqs
            field_masks[at:at + m] = pack_mask_words(st.masks, K_words)
            for j in range(m):
                pos_offsets[at + j] = pat
                d = st.docs[j]
                for p in st.positions[j]:
                    poskeys[pat] = d * pos_stride + min(p, pos_stride - 1)
                    pat += 1
            at += m
        pos_offsets[at:] = pat

        terms = TermDict(
            ids={t: i for i, t in enumerate(self._term_order)},
            terms=list(self._term_order),
            doc_freq=doc_freq,
        )
        cap = next_pow2(n_pad)
        posting_dl = doclen[doc_ids]  # replicate doc length per posting
        text = TextPostings(
            term_offsets=dev(term_offsets.astype(np.int32)),
            doc_ids=dev(tail_pad(doc_ids, posting_pad(len(doc_ids), cap))),
            freqs=dev(tail_pad(freqs, posting_pad(len(freqs), cap))),
            field_masks=dev(tail_pad(field_masks,
                                     posting_pad(len(field_masks), cap))),
            doclens=dev(tail_pad(posting_dl,
                                 posting_pad(len(posting_dl), cap))),
            pos_offsets=dev(pos_offsets.astype(np.int32)),
            poskeys=dev(tail_pad(poskeys,
                                 posting_pad(len(poskeys), POS_SLICE_PAD),
                                 2**31 - 1)),
            pos_stride=pos_stride,
            pos_clamped=self.max_positions + 1 > pos_stride - 1,
            nnz=nnz,
            max_postings=max_postings,
            term_offsets_np=term_offsets.astype(np.int32),
            pos_offsets_np=pos_offsets.astype(np.int64),
        )

        # ---- tag postings
        tags: dict[str, TagPostings] = {}
        for attr, stage in self._tags.items():
            values = sorted(stage)  # sorted for prefix expansion
            t_off = np.zeros(len(values) + 1, np.int64)
            t_nnz = 0
            t_max = 0
            for i, v in enumerate(values):
                t_off[i] = t_nnz
                t_nnz += len(stage[v])
                t_max = max(t_max, len(stage[v]))
            t_off[len(values)] = t_nnz
            t_ids = np.zeros(round_up(t_nnz, LANE), np.int32)
            at = 0
            for v in values:
                lst = stage[v]
                t_ids[at:at + len(lst)] = lst
                at += len(lst)
            tags[attr] = TagPostings(
                ids={v: i for i, v in enumerate(values)},
                values=values,
                offsets=dev(t_off.astype(np.int32)),
                doc_ids=dev(tail_pad(t_ids, posting_pad(len(t_ids), cap))),
                nnz=t_nnz,
                max_postings=t_max,
                offsets_np=t_off.astype(np.int32),
                codes=build_tag_codes(stage, values, n_pad, self.device),
            )

        # ---- dense columns
        numerics = {}
        for attr, vals in self._numerics.items():
            col = np.full(n_pad, np.nan, np.float32)
            col[:n] = [v[0] if v else np.nan for v in vals]
            numerics[attr] = make_numeric_column(col, n, self.device,
                                                 value_lists=vals)
        strcols = {}
        for attr, vals in self._strcols.items():
            uniq = sorted({v for v in vals if v is not None})
            idmap = {v: i for i, v in enumerate(uniq)}
            ids = np.full(n_pad, -1, np.int32)
            ids[:n] = [idmap.get(v, -1) if v is not None else -1
                       for v in vals]
            # value ids are assigned in sorted order, so order == id
            ids_t = dev(ids)
            strcols[attr] = StrColumn(value_ids=ids_t, table=uniq,
                                      order=ids_t)
        missing = {}
        for attr, pres in self._present.items():
            m = np.zeros(n_pad, bool)
            m[:n] = pres
            missing[attr] = dev(m)

        return Segment(
            n_docs=n, n_pad=n_pad, device=self.device,
            gids=dev(gids), alive=dev(alive), doclen=dev(doclen),
            max_freq=dev(max_freq), docscore=dev(docscore),
            expire_at=dev(expire),
            terms=terms, text=text, tags=tags, numerics=numerics,
            strcols=strcols, missing=missing,
            gid_to_local={g: i for i, g in enumerate(self._gids)},
            gids_np=gids, alive_np=alive, doclen_np=doclen,
            geometries={a: list(v) for a, v in self._geoms.items()},
            has_ttl=any(e != 0 for e in self._expire),
            uniform_docscore=all(s_ == 1.0 for s_ in self._docscore),
            **self._seal_field_ttls(n, n_pad),
        )

    def _seal_field_ttls(self, n: int, n_pad: int) -> dict:
        """Device columns for field-level TTLs: TEXT fields pack into
        [n_pad, F]; other fields get one column per attribute."""
        if not self._any_fexp:
            return {}
        out: dict = {"field_fexp": {}}
        tfields = self.schema.text_fields()
        if any(any(self._fexpire[f.attribute]) for f in tfields):
            tf = np.zeros((n_pad, max(len(tfields), 1)), np.int32)
            for f in tfields:
                tf[:n, f.field_id] = self._fexpire[f.attribute]
            out["text_fexp"] = self._dev(tf)
        for f in self.schema.fields:
            if f.type == FieldType.TEXT:
                continue
            vals = self._fexpire[f.attribute]
            if any(vals):
                col = np.zeros(n_pad, np.int32)
                col[:n] = vals
                out["field_fexp"][f.attribute] = self._dev(col)
        return out
