"""Host-side segment builder: the write path.

Counterpart of `redisearch_tpu/index/builder.py`.  The staging half
(tokenize, stem, per-term postings, tag and numeric staging) is a copy of
the JAX package's `SegmentBuilder`; `seal` is the port's: the same numpy
arrays, with the same pads and layouts, land as torch tensors on the
index's device.
"""

from __future__ import annotations

import math
import time
from typing import Any, Optional

import numpy as np
import torch

from ..analysis.phonetics import dm_code
from ..analysis.stemmer import Stemmer
from ..analysis.stopwords import StopWordList
from ..analysis.tokenizer import Tokenizer, normalize_token
from ..schema import Field, FieldType, Schema
from ..utils import wkt
from ..utils.errors import IndexError_, WrongFieldType
from ..utils.jsonpath import get_field_value
from .doctable import DocMeta
from .segment import (LANE, GeoColumn, Segment, StrColumn, TagPostings,
                      TermDict, build_tag_codes, make_numeric_column,
                      make_segment, make_vector_column, mask_words,
                      next_pow2, pack_mask_words, round_up, tag_postings,
                      text_postings)

def make_geo_column(points: list, n: int, n_pad: int, device) -> GeoColumn:
    """The GEO half of the JAX seal: (lon, lat) radian pairs, NaN for a
    doc without a point, as dense f32 columns (0 where missing)."""
    lon = np.full(n_pad, np.nan, np.float32)
    lat = np.full(n_pad, np.nan, np.float32)
    if points:
        arr = np.asarray(points, np.float32).reshape(n, 2)
        lon[:n] = arr[:, 0]
        lat[:n] = arr[:, 1]

    def dev(a):
        return torch.as_tensor(a, device=device)
    return GeoColumn(lon=dev(np.nan_to_num(lon, nan=0.0)),
                     lat=dev(np.nan_to_num(lat, nan=0.0)),
                     present=dev(~np.isnan(lon)))


def seal_vector_column(schema: Schema, attr: str, rows: list, n_pad: int,
                       device):
    """The field's VectorColumn: on the device, or in host memory for
    `storage="host"` (f32, or LVQ8 codes)."""
    vp = schema.field(attr).vector
    return make_vector_column(rows, n_pad, vp.dim, vp.dtype, device,
                              host=vp.storage == "host",
                              compression=vp.compression)


STEM_PREFIX = "+"        # reference: STEM_PREFIX in forward index terms
PHONETIC_PREFIX = "\x01"  # reference: PHONETIC_PREFIX
# Device field masks are int32 words; schemas with more than 32 TEXT
# fields pack into [nnz, K] multi-word masks (K = ceil(F/32)), matching
# the reference's 128-bit t_fieldMask (src/redisearch.h) at K=4.
DEVICE_MAX_TEXT_FIELDS = 128
# Positions per doc tracked for phrase matching are capped so that
# local_doc * pos_stride + pos fits in int32 (see segment.py poskeys).
MAX_POS_STRIDE = 4096

_VEC_NP_DTYPES = {
    "FLOAT32": np.float32,
    "FLOAT64": np.float64,
    "FLOAT16": np.float16,
    "INT8": np.int8,
    "UINT8": np.uint8,
    "BFLOAT16": np.uint16,     # raw bf16 bits; see decode_vector_bytes
}


def decode_vector_bytes(raw: bytes, dtype_name: str) -> np.ndarray:
    """A binary vector blob of the field's type as f32 values.  bf16
    reads as uint16 bit patterns widened to f32 bits (exact), so that no
    bf16 numpy type (`ml_dtypes`, which comes with jax) is needed."""
    arr = np.frombuffer(raw, dtype=_VEC_NP_DTYPES[dtype_name])
    if dtype_name == "BFLOAT16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32)


class _TermStage:
    __slots__ = ("docs", "freqs", "masks", "positions", "doc_freq")

    def __init__(self):
        self.docs: list[int] = []
        self.freqs: list[float] = []
        self.masks: list[int] = []
        self.positions: list[list[int]] = []
        self.doc_freq = 0


class SegmentBuilder:
    """Accumulates documents on the host, then seals them into a torch
    Segment on `device`."""

    def __init__(self, schema: Schema,
                 stopwords: Optional[StopWordList], synonyms, device):
        self.device = torch.device(device)
        self.schema = schema
        self.synonyms = synonyms
        if schema.num_text_fields > DEVICE_MAX_TEXT_FIELDS:
            raise IndexError_(
                f"device field mask supports up to {DEVICE_MAX_TEXT_FIELDS} "
                f"TEXT fields for now")
        self.stopwords = stopwords or StopWordList(schema.stopwords)
        self._stemmers: dict[str, Stemmer] = {}
        # staging
        self._gids: list[int] = []
        self._metas: list = []       # DocMeta refs: TTLs re-read at seal
        self._doclen: list[float] = []
        self._maxfreq: list[float] = []
        self._docscore: list[float] = []
        self._expire: list[int] = []
        self._terms: dict[str, _TermStage] = {}
        self._term_order: list[str] = []
        self._tags: dict[str, dict[str, list[int]]] = {
            f.attribute: {} for f in schema.fields if f.type == FieldType.TAG}
        self._numerics: dict[str, list[float]] = {
            f.attribute: [] for f in schema.fields
            if f.type == FieldType.NUMERIC}
        self._geos: dict[str, list[tuple[float, float]]] = {
            f.attribute: [] for f in schema.fields if f.type == FieldType.GEO}
        self._strcols: dict[str, list[Optional[str]]] = {
            f.attribute: [] for f in schema.fields
            if f.sortable and f.type in (FieldType.TEXT, FieldType.TAG)}
        self._vectors: dict[str, list[Optional[np.ndarray]]] = {
            f.attribute: [] for f in schema.fields
            if f.type == FieldType.VECTOR}
        self._geoms: dict[str, list] = {
            f.attribute: [] for f in schema.fields
            if f.type == FieldType.GEOMETRY}
        self._present: dict[str, list[bool]] = {
            f.attribute: [] for f in schema.fields}
        # field-level TTLs (reference: ttl_table — docId -> [(field, ts)])
        self._fexpire: dict[str, list[int]] = {
            f.attribute: [] for f in schema.fields}
        self._any_fexp = False
        self.max_positions = 0

    def __len__(self) -> int:
        return len(self._gids)

    def _stemmer_for(self, language: str) -> Stemmer:
        st = self._stemmers.get(language)
        if st is None:
            st = Stemmer(language)
            self._stemmers[language] = st
        return st

    # -- add one document -------------------------------------------------
    def add(self, meta: DocMeta) -> None:
        """Stage one document.  Mirrors Document_AddToIndexes."""
        local = len(self._gids)
        self._gids.append(meta.gid)
        self._metas.append(meta)
        self._docscore.append(meta.score)
        self._expire.append(int(-(-meta.expires_at // 1))
                            if meta.expires_at else 0)

        language = getattr(meta, "language", None) or str(
            meta.fields.get(self.schema.language_field, self.schema.language)
            if self.schema.language_field else self.schema.language)
        stemmer = self._stemmer_for(language)

        fe = meta.field_expiration or {}
        for f in self.schema.fields:
            v = fe.get(f.attribute) or fe.get(f.name) or 0
            self._fexpire[f.attribute].append(int(v))
            if v:
                self._any_fexp = True

        # per-doc forward index: term -> [freq, mask, positions].
        # Positions are global across TEXT fields (base advances per field,
        # +1 gap so phrases never falsely match across a field boundary).
        fwd: dict[str, list] = {}
        doclen = 0.0
        max_pos = 0
        pos_base = 0

        for field in self.schema.fields:
            raw = get_field_value(meta.fields, field.name)
            if raw is None and field.alias:
                raw = meta.fields.get(field.alias)
            if isinstance(raw, (str, bytes)) or raw is None:
                present = raw is not None and (raw != ""
                                               or field.indexempty)
            else:
                present = True
            self._present[field.attribute].append(bool(present))
            if field.type == FieldType.TEXT:
                n_tok, mp = self._add_text(field, raw, fwd, stemmer,
                                           pos_base)
                doclen += n_tok
                pos_base += n_tok + 1
                max_pos = max(max_pos, mp)
                if field.sortable:
                    val = str(raw) if raw is not None else None
                    if val is not None and not field.unf:
                        val = normalize_token(val)
                    self._strcols[field.attribute].append(val)
            elif field.type == FieldType.NUMERIC:
                self._numerics[field.attribute].append(
                    self._parse_numeric(field, raw))
            elif field.type == FieldType.TAG:
                joined = self._add_tag(field, raw, local)
                if field.sortable:
                    self._strcols[field.attribute].append(joined)
            elif field.type == FieldType.GEO:
                self._geos[field.attribute].append(
                    self._parse_geo(field, raw))
            elif field.type == FieldType.VECTOR:
                self._vectors[field.attribute].append(
                    self._parse_vector(field, raw))
            elif field.type == FieldType.GEOMETRY:
                self._geoms[field.attribute].append(
                    wkt.parse(str(raw)) if raw is not None else None)

        # merge forward index into term staging (reference: indexer.c:58
        # writeIndexEntry per term)
        max_freq = 0.0
        for term, (freq, mask, positions) in fwd.items():
            stage = self._terms.get(term)
            if stage is None:
                stage = _TermStage()
                self._terms[term] = stage
                self._term_order.append(term)
            stage.docs.append(local)
            stage.freqs.append(freq)
            stage.masks.append(mask)
            stage.positions.append(positions)
            stage.doc_freq += 1
            max_freq = max(max_freq, freq)

        self._doclen.append(doclen)
        self._maxfreq.append(max(max_freq, 1.0))
        self.max_positions = max(self.max_positions, max_pos)
        meta.doclen = int(doclen)
        meta.max_freq = int(max_freq)

    # -- field preprocessors ----------------------------------------------
    def _add_text(self, field: Field, raw: Any, fwd: dict,
                  stemmer: Stemmer, pos_base: int) -> tuple[int, int]:
        if raw is None:
            return 0, 0
        if isinstance(raw, (list, tuple)):  # JSON multi-value text
            text = " ".join(str(v) for v in raw)
        else:
            text = str(raw)
        tk = Tokenizer(self.stopwords,
                       None if field.nostem else stemmer)
        n_tok = 0
        max_pos = 0
        fbit = 1 << field.field_id
        # Stored freqs are field-WEIGHT-scaled, and the intersection
        # kernel derives membership from (tf sum > 0) (_member_pass's
        # want_tf fast path).  Clamp non-positive weights to a tiny
        # epsilon so a WEIGHT 0 field still registers hits (and NOT
        # exclusions) while contributing ~0 BM25 score — matching the
        # XLA twin's membership-based hit.
        w = field.weight if field.weight > 0 else 1e-6
        for tok in tk.tokenize(text):
            n_tok += 1
            if tok.is_stopword or field.noindex:
                continue
            pos = pos_base + tok.pos
            max_pos = max(max_pos, pos)
            self._fwd_add(fwd, tok.tok, w, fbit, pos)
            if tok.stem:
                self._fwd_add(fwd, STEM_PREFIX + tok.stem, w, fbit, pos)
            if field.phonetic:
                code = dm_code(tok.tok)
                if code:
                    self._fwd_add(fwd, PHONETIC_PREFIX + code, w, fbit, pos)
            if self.synonyms is not None:
                for syn in self.synonyms.group_terms(tok.tok):
                    self._fwd_add(fwd, syn, w, fbit, pos)
        return n_tok, max_pos

    @staticmethod
    def _fwd_add(fwd: dict, term: str, weight: float, fbit: int,
                 pos: int) -> None:
        ent = fwd.get(term)
        if ent is None:
            fwd[term] = [weight, fbit, [pos]]
        else:
            ent[0] += weight
            ent[1] |= fbit
            ent[2].append(pos)

    def _parse_numeric(self, field: Field, raw: Any) -> list:
        """Returns the list of values for the doc ([] = missing).  JSON
        multi-value numerics index every element (reference: multi-value
        fields feed each value into the numeric range tree)."""
        if raw is None or raw == "":
            return []
        vals = raw if isinstance(raw, (list, tuple)) else [raw]
        out = []
        for v in vals:
            if v is None or v == "":
                continue
            try:
                out.append(float(v))
            except (TypeError, ValueError):
                raise WrongFieldType(
                    f"Could not index numeric value for field {field.name}")
        return out

    def _add_tag(self, field: Field, raw: Any,
                 local: int) -> Optional[str]:
        if raw is None:
            return None
        if isinstance(raw, (list, tuple)):
            values = [str(v) for v in raw]
            joined = field.separator.join(values)
        else:
            joined = str(raw)
            values = [v.strip() for v in joined.split(field.separator)]
        stage = self._tags[field.attribute]
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
        return joined if not field.casesensitive else joined

    def _parse_geo(self, field: Field, raw: Any) -> tuple[float, float]:
        if raw is None or raw == "":
            return (math.nan, math.nan)
        if isinstance(raw, (list, tuple)) and len(raw) == 2:
            lon, lat = float(raw[0]), float(raw[1])
        else:
            parts = str(raw).split(",")
            if len(parts) != 2:
                raise WrongFieldType(f"bad geo value for {field.name}: {raw}")
            lon, lat = float(parts[0]), float(parts[1])
        if not (-180 <= lon <= 180 and -85.05112878 <= lat <= 85.05112878):
            raise WrongFieldType(f"geo out of range for {field.name}")
        return (math.radians(lon), math.radians(lat))

    def _parse_vector(self, field: Field, raw: Any) -> Optional[list]:
        """Returns the doc's vector list (None = missing).  JSON
        multi-value vector fields ($..path arrays-of-arrays) index every
        vector (reference: VecSim multi-value)."""
        if raw is None:
            return None
        vp = field.vector
        if isinstance(raw, str):
            # RESP clients send vector blobs as binary-safe strings
            raw = raw.encode("latin-1", "surrogateescape")
        if isinstance(raw, bytes):
            arr = decode_vector_bytes(raw, vp.dtype)
            if arr.shape[0] != vp.dim and arr.shape[0] % vp.dim == 0:
                return list(arr.reshape(-1, vp.dim))  # concatenated blobs
            if arr.shape[0] != vp.dim:
                raise WrongFieldType(
                    f"vector dim mismatch for {field.name}: got "
                    f"{arr.shape[0]}, want {vp.dim}")
            return [arr]
        if (isinstance(raw, (list, tuple)) and raw
                and isinstance(raw[0], (list, tuple, np.ndarray))):
            vecs = [np.asarray(v, np.float32).reshape(-1) for v in raw]
        else:
            vecs = [np.asarray(raw, dtype=np.float32).reshape(-1)]
        for arr in vecs:
            if arr.shape[0] != vp.dim:
                raise WrongFieldType(
                    f"vector dim mismatch for {field.name}: got "
                    f"{arr.shape[0]}, want {vp.dim}")
        return vecs

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def seal(self) -> Optional[Segment]:
        """Build the immutable device segment from staged docs (port of
        the JAX `SegmentBuilder.seal`: `jnp.asarray` becomes
        `torch.as_tensor(..., device=...)`).  A cold schema
        (`storage="host"`) keeps the text and tag CSR arrays as host
        numpy; everything dense goes to the device."""
        n = len(self._gids)
        if n == 0:
            return None
        dev = self._dev
        cold = self.schema.storage == "host"
        csr = np.ascontiguousarray if cold else dev
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
        text = text_postings(
            term_offsets.astype(np.int32), doc_ids, freqs, field_masks,
            doclen[doc_ids], pos_offsets, poskeys, csr, cap=cap,
            pos_stride=pos_stride,
            pos_clamped=self.max_positions + 1 > pos_stride - 1,
            nnz=nnz, max_postings=max_postings)

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
            tags[attr] = tag_postings(
                {v: i for i, v in enumerate(values)}, values,
                t_off.astype(np.int32), t_ids, csr, cap=cap, nnz=t_nnz,
                max_postings=t_max,
                codes=build_tag_codes(stage, values, n_pad, self.device))

        # ---- dense columns
        numerics = {}
        for attr, vals in self._numerics.items():
            col = np.full(n_pad, np.nan, np.float32)
            col[:n] = [v[0] if v else np.nan for v in vals]
            numerics[attr] = make_numeric_column(col, n, self.device,
                                                 value_lists=vals)
        geos = {attr: make_geo_column(vals, n, n_pad, self.device)
                for attr, vals in self._geos.items()}
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
        vectors = {attr: seal_vector_column(self.schema, attr, rows, n_pad,
                                            self.device)
                   for attr, rows in self._vectors.items()}

        return make_segment(
            self.device, n, gids, alive, doclen, max_freq, docscore, expire,
            terms=terms, text=text, tags=tags, numerics=numerics,
            strcols=strcols, missing=missing, vectors=vectors, geos=geos,
            geometries={a: list(v) for a, v in self._geoms.items()},
            cold=cold, **self._seal_field_ttls(n, n_pad))

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
