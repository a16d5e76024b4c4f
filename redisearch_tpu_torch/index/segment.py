"""Immutable index segments holding torch tensors on the index's device.

Counterpart of `redisearch_tpu/index/segment.py`.  The host dataclasses
(`TermDict`, `TextPostings`, `TagPostings`, `NumericColumn`,
`StrColumn`) and the pad helpers are copies of the JAX package's (that
module tries `import jax.numpy`; this one does not); their array fields
hold torch tensors here.  Every pad and array layout is identical to the
JAX segment, so a window bucket or a posting offset means the same thing
in both packages.

The planner reads only host state: the term dictionary, the `*_np`
mirrors of the CSR offsets, and the numpy mirrors this segment keeps of
`gids`, `alive` and `doclen` (reading a CUDA tensor from the host costs a
device round trip per call).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import numpy as np
import torch

# Lane width of the TPU VPU; all ragged arrays are padded to a multiple.
LANE = 128


def round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


# SLICE guarantee: device posting arrays carry a tail pad so that the
# engine's `dynamic_slice(arr, start, W)` window reads never clamp
# (start <= real length, W <= the pad).  ops/window.py relies on this.
# Position keys cap their pad (and the engine caps the P bucket) at
# POS_SLICE_PAD.  Terms with more positions than this stay EXACT in
# phrase windows via slow paths (engine.py _phrase_chain_pivot): member
# terms probe the CSR by dynamic binary search; an oversized pivot scans
# its run in POS_SLICE_PAD chunks into a dense doc accumulator.  A
# warning surfaces on SearchResult.warnings when either path engages.
POS_SLICE_PAD = 262144


def tail_pad(arr: np.ndarray, extra: int, fill=0) -> np.ndarray:
    out = np.full((arr.shape[0] + extra,) + arr.shape[1:], fill, arr.dtype)
    out[:arr.shape[0]] = arr
    return out


# The Pallas kernels (ops/intersect.py) DMA whole 128-lane ROWS: a
# window starting at `start` reads rows [start//128, start//128 +
# W//128 + R_EXTRA).  Beyond the XLA SLICE guarantee (start + W <= len)
# that reaches up to (R_EXTRA + 1) * 128 elements further — without
# this extra pad a window near the array tail makes the row copy clamp
# (dynamic-slice semantics), silently SHIFTING the window data against
# the kernel's start%128 offset and dropping/corrupting matches.
KERNEL_ROW_PAD = 9 * LANE


def posting_pad(n: int, cap: int) -> int:
    """Tail-pad size for kernel-readable posting arrays: the SLICE
    guarantee (`cap` >= any window bucket) plus the kernel row-DMA
    overhang, rounded so the padded length is whole 128-lane rows."""
    extra = cap + KERNEL_ROW_PAD
    return extra + (-(n + extra)) % LANE


def mask_words(n_text_fields: int) -> int:
    """int32 words per field mask (reference t_fieldMask is 128-bit:
    up to 4 words; single-word masks keep the flat fast path)."""
    return max(1, -(-n_text_fields // 32))


def pack_mask_words(masks, K: int) -> np.ndarray:
    """Pack python-int field masks into K int32 words.

    Returns int32[n] when K == 1 (bit 31 wraps through uint32 so a
    32-field mask still fits one word), else int32[n, K]."""
    a = np.asarray(
        [[(int(m) >> (32 * j)) & 0xFFFFFFFF for j in range(K)]
         for m in masks], dtype=np.uint64).reshape(-1, K)
    out = a.astype(np.uint32).view(np.int32)
    return out[:, 0] if K == 1 else out


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


@dataclasses.dataclass
class TermDict:
    """Host-side term dictionary (reference: terms Trie, src/trie/).

    On TPU the dictionary stays host-side (SURVEY.md §7.3): lookups are hash
    probes, and prefix/suffix/fuzzy expansion scans the sorted term list.
    """

    ids: dict[str, int]
    terms: list[str]                    # id -> term
    doc_freq: np.ndarray                # int32[n_terms]
    _sorted: Optional[list[str]] = None

    def lookup(self, term: str) -> int:
        return self.ids.get(term, -1)

    @property
    def sorted_terms(self) -> list[str]:
        if self._sorted is None:
            self._sorted = sorted(self.ids)
        return self._sorted

    def __len__(self) -> int:
        return len(self.terms)


@dataclasses.dataclass
class TextPostings:
    """CSR postings over all TEXT terms of a segment.

    Reference: InvertedIndex<E> blocks (inverted_index/src/index/core.rs:31)
    — here one flat strided layout for the whole segment.
    """

    term_offsets: Any   # int32[n_terms+1] into the nnz axis
    doc_ids: Any        # int32[nnz_pad] local doc ids (ascending per term)
    freqs: Any          # float32[nnz_pad] field-weighted term frequency
    field_masks: Any    # int32[nnz_pad] bitmask of TEXT fields (<=32 round1)
    # per-posting doc length (the BM25/DOCNORM norm operand) — replicated
    # into posting order so scoring windows slice it contiguously instead
    # of paying an arbitrary-index doclen gather (~30M elem/s on TPU)
    doclens: Any        # float32[nnz_pad]
    pos_offsets: Any    # int32[nnz_pad+1] into poskeys
    poskeys: Any        # int32[npos_pad] = local_doc * pos_stride + position
    pos_stride: int     # power of two >= max positions tracked per doc
    nnz: int
    max_postings: int   # longest posting list (gather bucket upper bound)
    # True when any position was clamped at pos_stride - 1 (docs longer
    # than the stride cap): the phrase equality-join formulation and the
    # anchor chain judge clamped keys differently, so the engine keeps
    # the chain kernel on such segments (ops/intersect.py phrase_batch)
    pos_clamped: bool = False
    term_offsets_np: Optional[np.ndarray] = None  # host mirror for planning
    pos_offsets_np: Optional[np.ndarray] = None   # host mirror for planning


@dataclasses.dataclass
class TagPostings:
    """CSR doc-id postings per TAG value (reference: src/tag_index.c)."""

    ids: dict[str, int]          # tag value -> tag id (host-side dict)
    values: list[str]            # tag id -> value
    offsets: Any                 # int32[n_tags+1]
    doc_ids: Any                 # int32[nnz_pad]
    nnz: int
    max_postings: int
    offsets_np: Optional[np.ndarray] = None       # host mirror for planning
    # Dense doc-aligned value-id column (int32[n_pad], -1 = no value),
    # built only when every doc carries <= 1 value for this field: tag
    # *predicates* then check `codes[doc] == qcode` per candidate instead
    # of block-gathering the value's posting window (the [Q,128] row-DMA
    # membership costs ~7 ns/element; the code compare is one gather per
    # candidate).  Multi-valued fields keep the posting-window member path.
    codes: Any = None
    _sorted: Optional[list[str]] = None

    @property
    def sorted_values(self) -> list[str]:
        if self._sorted is None:
            self._sorted = sorted(self.ids)
        return self._sorted


@dataclasses.dataclass
class NumericColumn:
    """Dense numeric column (replaces the numeric range tree).

    `sorted_*` is the value-sorted permutation: the numeric *generator*
    path — a range [lo, hi] is a contiguous run in sorted order found by
    searchsorted, the batch-at-a-time analog of a range-tree leaf scan
    (reference: numeric_range_tree).  Missing docs sort last with doc id
    INT32_MAX so a window gather yields valid sorted candidates.
    """

    values: Any    # float32[n_pad] (first value — SORTBY key)
    present: Any   # bool[n_pad]
    sorted_vals: Any = None   # float32 ascending over ALL (value,doc) pairs
    sorted_docs: Any = None   # int32 doc ids in value order (dups if multi)
    sorted_vals_np: Any = None  # host mirror for bind-time searchsorted
    # JSON multi-value support (reference: multi-value numeric fields index
    # every array element into the range tree): dense [n_pad, V] matrix for
    # the predicate path; the sorted permutation above holds every pair so
    # range *generator* windows see all values (deduped on device).
    multi_values: Any = None   # float32[n_pad, V]
    multi_present: Any = None  # bool[n_pad, V]
    multi: bool = False


@dataclasses.dataclass
class StrColumn:
    """Dictionary-encoded string column for SORTBY/GROUPBY on TAG/TEXT."""

    value_ids: Any        # int32[n_pad]; -1 = missing
    table: list[str]      # value id -> string
    order: Any            # int32[n_pad]: rank of value in lexicographic order


def make_numeric_column(col_with_nan: np.ndarray, n: int, device,
                        value_lists=None) -> NumericColumn:
    """Torch port of the JAX `make_numeric_column`: a NumericColumn
    (incl. the value-sorted permutation) from a float array where NaN
    marks missing; entries beyond `n` are padding.  A doc with more than
    one value in `value_lists` makes the column multi-valued."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    present = ~np.isnan(col_with_nan)
    present[n:] = False
    n_pad = col_with_nan.shape[0]
    values = np.nan_to_num(col_with_nan, nan=0.0, posinf=0.0, neginf=0.0)
    multi = (value_lists is not None
             and any(len(v) > 1 for v in value_lists))
    if multi:
        V = next_pow2(max(len(v) for v in value_lists))
        mv = np.zeros((n_pad, V), np.float32)
        mp = np.zeros((n_pad, V), np.bool_)
        pair_docs: list[int] = []
        pair_vals: list[float] = []
        for i, vals in enumerate(value_lists):
            for j, val in enumerate(vals):
                mv[i, j] = val
                mp[i, j] = True
                pair_docs.append(i)
                pair_vals.append(val)
        pv = np.asarray(pair_vals, np.float32)
        pd = np.asarray(pair_docs, np.int32)
        order = np.argsort(pv, kind="stable")
        sv = pv[order]
        sd = pd[order]
        cap = next_pow2(max(len(sv), n_pad))
        return NumericColumn(
            values=dev(values), present=dev(present),
            sorted_vals=dev(tail_pad(sv, cap, np.inf)),
            sorted_docs=dev(tail_pad(sd, cap, 2**31 - 1)),
            sorted_vals_np=sv,
            multi_values=dev(mv), multi_present=dev(mp), multi=True)
    key = np.where(present, col_with_nan, np.inf)
    order = np.argsort(key, kind="stable").astype(np.int32)
    sv = key[order].astype(np.float32)
    sd = np.where(np.isfinite(sv), order, np.int32(2**31 - 1))
    cap = next_pow2(n_pad)
    return NumericColumn(
        values=dev(values), present=dev(present),
        sorted_vals=dev(tail_pad(sv, cap, np.inf)),
        sorted_docs=dev(tail_pad(sd.astype(np.int32), cap, 2**31 - 1)),
        sorted_vals_np=sv[:n_pad],
    )


#: torch storage of each VECTOR dtype (FLOAT64 is stored as f32, as in
#: the JAX segment)
VEC_TORCH_DTYPES = {
    "BFLOAT16": torch.bfloat16, "INT8": torch.int8, "UINT8": torch.uint8,
    "FLOAT16": torch.float16, "FLOAT32": torch.float32,
    "FLOAT64": torch.float32,
}


@dataclasses.dataclass
class GeoColumn:
    """A GEO field's points as dense radian columns on the segment's
    device."""

    lon: Any       # float32[n_pad] radians
    lat: Any       # float32[n_pad] radians
    present: Any   # bool[n_pad]


@dataclasses.dataclass
class VectorColumn:
    """Per-field vector data (reference: VecSim FLAT storage), on the
    segment's device, or on the host for the host tier."""

    vecs: Any      # dtype[n_pad, dim]  (multi: dtype[R_pad, dim] rows)
    present: Any   # bool[n_pad]  (always per-doc)
    dim: int
    # squared L2 norms of the f32 values (taken in float64 before the
    # storage cast), f32[n_pad] (multi: [R_pad])
    sq_norms: Any = None
    # bf16 copy of `vecs` for the two-phase candidate scan (f32 storage
    # only; ops/vector.py)
    scan_vecs: Any = None
    # multi-value columns: every vector a row, doc_rows[n_pad, M] maps
    # each doc to its rows (-1 pad); a doc's distance is its best row's
    doc_rows: Any = None
    multi: bool = False
    # IVF structure (ops/ivf.py IVFIndex) of an IVF/HNSW/SVS/TIERED
    # field, built at commit once the segment holds at least
    # `flat_buffer_limit` vectors; None = the exact FLAT scan
    ivf: Any = None
    # host tier (VectorParams.storage == "host"): `vecs` and `sq_norms`
    # are host numpy, `host_ivf` (ops/ivf.py HostIVF) holds the bucket
    # slabs in host memory and the centroids on the device; KNN pages
    # the probed lists up per batch
    host: bool = False
    host_ivf: Any = None
    # LVQ8 (host tier only; ops/lvq.py): `vecs` holds uint8 codes,
    # vq_off/vq_scl the per-vector dequantization pair, sq_norms the
    # squared norms of the reconstructions
    compression: str = ""
    vq_off: Any = None     # host f32[n_pad]
    vq_scl: Any = None     # host f32[n_pad]


def bf16_scan_copy(mat):
    """bf16 copy of an f32 vector matrix for the two-phase KNN candidate
    scan (`VectorColumn.scan_vecs`): half the scan's memory reads, at
    +50% vector memory; the f32 matrix stays the source of truth for the
    rescore.  None for other storage types."""
    if mat.dtype != torch.float32:
        return None
    return mat.to(torch.bfloat16)


def _sq_norms(mat: np.ndarray) -> np.ndarray:
    """Row sums of squares in float64, stored as f32 (the JAX package's
    `(mat.astype(np.float64) ** 2).sum(1)`, taken a block of rows at a
    time: each row's sum is the same)."""
    out = np.empty(mat.shape[0], np.float32)
    for a in range(0, mat.shape[0], 65536):
        out[a:a + 65536] = (mat[a:a + 65536].astype(np.float64) ** 2).sum(1)
    return out


def _store(mat: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """The f32 matrix in the field's storage type on `device`: integer
    and f16 types through numpy's casts (the JAX package's), bf16
    through torch's round-to-nearest-even (ml_dtypes' and XLA's)."""
    tdt = VEC_TORCH_DTYPES.get(dtype_name, torch.float32)
    if tdt == torch.bfloat16:
        return torch.from_numpy(mat).to(torch.bfloat16).to(device)
    npdt = {torch.int8: np.int8, torch.uint8: np.uint8,
            torch.float16: np.float16}.get(tdt, np.float32)
    return torch.as_tensor(np.ascontiguousarray(mat.astype(npdt)),
                           device=device)


def make_vector_column(rows_per_doc: list, n_pad: int, dim: int,
                       dtype_name: str, device, host: bool = False,
                       compression: str = "") -> VectorColumn:
    """Build a VectorColumn from per-doc vector lists (the JAX
    `make_vector_column`).  rows_per_doc[i]: None | ndarray[dim] |
    list[ndarray[dim]].  A doc with more than one vector switches the
    column to the row layout (VecSim multi-value).  host=True keeps the
    matrix in host memory (only `present` goes to `device`), as f32 or,
    with compression="LVQ8", as uint8 codes (ops/lvq.py); the host tier
    refuses multi-value documents, as in the JAX package."""
    norm = []
    for r in rows_per_doc:
        if r is None:
            norm.append([])
        elif isinstance(r, (list, tuple)):
            norm.append(list(r))
        else:
            norm.append([r])
    norm += [[]] * (n_pad - len(norm))
    multi = any(len(v) > 1 for v in norm)
    present = np.array([len(v) > 0 for v in norm], bool)
    if host and multi:
        raise ValueError(
            "host-tier (storage='host') vector fields do not support "
            "multi-value documents")
    if not multi:
        mat = np.zeros((n_pad, dim), np.float32)
        for i, v in enumerate(norm):
            if v:
                mat[i] = v[0]
        if host:
            pres = torch.as_tensor(present, device=device)
            if compression:
                from ..ops.lvq import lvq_encode, lvq_sq_norms
                codes, off, scl = lvq_encode(mat)
                return VectorColumn(
                    vecs=codes, present=pres, dim=dim,
                    sq_norms=lvq_sq_norms(codes, off, scl), host=True,
                    compression=compression, vq_off=off, vq_scl=scl)
            return VectorColumn(vecs=mat, present=pres, dim=dim,
                                sq_norms=_sq_norms(mat), host=True)
        return vector_column(mat, present, dtype_name, device)
    M = next_pow2(max(len(v) for v in norm))
    R = sum(len(v) for v in norm)
    R_pad = max(round_up(R, 8), 8)
    rows = np.zeros((R_pad, dim), np.float32)
    doc_rows = np.full((n_pad, M), -1, np.int32)
    r = 0
    for i, v in enumerate(norm):
        for j, vec in enumerate(v):
            rows[r] = vec
            doc_rows[i, j] = r
            r += 1
    return vector_column(rows, present, dtype_name, device,
                         doc_rows=doc_rows)


def vector_column(mat: np.ndarray, present: np.ndarray, dtype_name: str,
                  device, sq_norms: Optional[np.ndarray] = None,
                  doc_rows: Optional[np.ndarray] = None) -> VectorColumn:
    """A device VectorColumn from its f32 host matrix (one row a doc, or
    with `doc_rows` the multi-value rows), stored in the field's type:
    seal and checkpoint load build theirs here (compaction keeps the
    stored rows as they are).  The squared norms are taken from `mat`
    unless given; a single-valued column gets its bf16 scan copy."""
    vecs = _store(mat, dtype_name, device)
    sq = _sq_norms(mat) if sq_norms is None else sq_norms
    col = VectorColumn(
        vecs=vecs, present=torch.as_tensor(present, device=device),
        dim=int(mat.shape[1]), sq_norms=torch.as_tensor(sq, device=device))
    if doc_rows is None:
        col.scan_vecs = bf16_scan_copy(vecs)
    else:
        col.doc_rows = torch.as_tensor(doc_rows, device=device)
        col.multi = True
    return col


def text_postings(term_offsets: np.ndarray, doc_ids: np.ndarray,
                  freqs: np.ndarray, field_masks: np.ndarray,
                  doclens: np.ndarray, pos_offsets: np.ndarray,
                  poskeys: np.ndarray, put, cap: Optional[int] = None,
                  pos_offsets_np: Optional[np.ndarray] = None,
                  **meta) -> TextPostings:
    """A TextPostings from its host CSR arrays (`doclens` per posting),
    placed by `put` (the device, or host numpy for a cold segment).  With
    `cap` the posting arrays first get the seal's tail pads
    (`posting_pad`; the position keys to POS_SLICE_PAD, filled with
    2**31-1); a checkpoint's arrays carry them already.  The planner's
    host mirrors come from the same arrays: the term offsets as given,
    the position offsets as int64 (`pos_offsets_np` overrides: the bulk
    path's mirror stops at nnz + 1, as the JAX package's does)."""
    if cap is not None:
        doc_ids, freqs, field_masks, doclens = (
            tail_pad(a, posting_pad(len(a), cap))
            for a in (doc_ids, freqs, field_masks, doclens))
        poskeys = tail_pad(poskeys, posting_pad(len(poskeys), POS_SLICE_PAD),
                           2**31 - 1)
    return TextPostings(
        term_offsets=put(term_offsets), doc_ids=put(doc_ids),
        freqs=put(freqs), field_masks=put(field_masks), doclens=put(doclens),
        pos_offsets=put(pos_offsets.astype(np.int32)), poskeys=put(poskeys),
        term_offsets_np=term_offsets,
        pos_offsets_np=(pos_offsets if pos_offsets_np is None
                        else pos_offsets_np).astype(np.int64),
        **meta)


def tag_postings(ids: dict, values: list, offsets: np.ndarray,
                 doc_ids: np.ndarray, put, cap: Optional[int] = None,
                 **meta) -> TagPostings:
    """A TagPostings from its host CSR arrays, placed by `put`; `cap`
    adds the seal's tail pad to the doc ids.  The planner's offsets
    mirror is the host offsets array."""
    if cap is not None:
        doc_ids = tail_pad(doc_ids, posting_pad(len(doc_ids), cap))
    return TagPostings(ids=ids, values=values, offsets=put(offsets),
                       doc_ids=put(doc_ids), offsets_np=offsets, **meta)


def build_tag_codes(stage: dict, values: list, n_pad: int, device):
    """Dense value-id column of a single-valued TAG field (see
    `TagPostings.codes`); None when any doc carries more than one value.
    `stage` maps value -> list of local doc ids."""
    codes = np.full(n_pad, -1, np.int32)
    for i, v in enumerate(values):
        lst = np.asarray(stage[v], np.int64)
        if lst.size and codes[lst].max() >= 0:
            return None
        codes[lst] = i
    return torch.as_tensor(codes, device=device)


_SEG_UIDS = itertools.count()


@dataclasses.dataclass
class Segment:
    """One sealed, immutable index segment on one torch device."""

    n_docs: int                     # live+deleted real docs (<= n_pad)
    n_pad: int
    device: torch.device
    gids: Any                       # int32[n_pad]: local id -> global doc id
    alive: Any                      # bool[n_pad]: not deleted, not padding
    doclen: Any                     # float32[n_pad] total text tokens
    max_freq: Any                   # float32[n_pad] max term freq (TFIDF)
    docscore: Any                   # float32[n_pad] user score
    expire_at: Any                  # int32[n_pad] epoch-seconds (0 = never)
    terms: TermDict
    text: TextPostings
    tags: dict                      # field attr -> TagPostings
    numerics: dict                  # field attr -> NumericColumn
    strcols: dict                   # sortable TAG/TEXT columns
    missing: dict                   # field attr -> bool[n_pad] "has field"
    gid_to_local: dict
    # host mirrors of gids / alive / doclen (the planner and the result
    # path read these; a CUDA tensor cannot be read without a sync)
    gids_np: np.ndarray = None
    alive_np: np.ndarray = None
    doclen_np: np.ndarray = None
    geometries: dict = dataclasses.field(default_factory=dict)
    vectors: dict = dataclasses.field(default_factory=dict)  # VectorColumn
    geos: dict = dataclasses.field(default_factory=dict)     # GeoColumn
    # clean-segment flags: the intersection kernel serves only segments
    # with no deletions, no TTLs and uniform doc scores
    n_deleted: int = 0
    has_ttl: bool = False
    uniform_docscore: bool = True
    # cold segment (Schema.storage == "host"): the text and tag CSR
    # arrays are host numpy; a query pages up only its term windows
    # (query/engine.py `_execute_cold`); the dense columns stay on the
    # device
    cold: bool = False
    text_fexp: Any = None
    field_fexp: dict = dataclasses.field(default_factory=dict)
    _pcode_cache: dict = dataclasses.field(default_factory=dict)
    uid: int = dataclasses.field(default_factory=lambda: next(_SEG_UIDS))

    def tag_pcodes(self, attr: str):
        """Posting-aligned code column of a single-valued TAG field:
        pcodes[i] = codes[text.doc_ids[i]].  None when the field is
        multi-valued or the segment has no text postings.  One gather on
        first use, then cached (the segment is immutable)."""
        tp = self.tags.get(attr)
        if tp is None or tp.codes is None or self.cold:
            return None
        cached = self._pcode_cache.get(attr)
        if cached is None:
            if int(self.text.doc_ids.shape[0]) == 0:
                return None
            idx = self.text.doc_ids.clamp(0, self.n_pad - 1).long()
            cached = tp.codes[idx].to(torch.int32)
            self._pcode_cache[attr] = cached
        return cached

    def sort_columns(self, attr: str):
        """(f32 rank key, present) of a sortable TAG/TEXT column, the
        window program's SORTBY operands; built once, then cached."""
        key = ("sort", attr)
        cached = self._pcode_cache.get(key)
        if cached is None:
            sc = self.strcols[attr]
            cached = (sc.order.to(torch.float32), sc.value_ids >= 0)
            self._pcode_cache[key] = cached
        return cached

    @property
    def gids_host(self) -> np.ndarray:
        return self.gids_np

    def mark_deleted(self, gid: int) -> bool:
        """Flip the doc's alive bit.  Unlike the JAX segment's functional
        `.at[].set`, this writes the tensor in place: no reader holds an
        older view it must keep."""
        loc = self.gid_to_local.get(gid)
        if loc is None:
            return False
        self.alive[loc] = False
        self.alive_np[loc] = False
        self.n_deleted += 1
        return True

    @property
    def num_alive(self) -> int:
        return int(self.alive_np.sum())

    def memory_bytes(self) -> int:
        """Bytes of every device tensor the segment holds (a cold
        segment's CSR arrays and the host tier's slabs are host numpy,
        counted by `host_bytes`)."""
        seen: dict[int, int] = {}

        def acc(x):
            if isinstance(x, torch.Tensor):
                seen[id(x)] = x.numel() * x.element_size()

        for arr in (self.gids, self.alive, self.doclen, self.max_freq,
                    self.docscore, self.expire_at, self.text.term_offsets,
                    self.text.doc_ids, self.text.freqs,
                    self.text.field_masks, self.text.doclens,
                    self.text.pos_offsets, self.text.poskeys):
            acc(arr)
        for t in self.tags.values():
            acc(t.offsets), acc(t.doc_ids), acc(t.codes)
        for c in self.numerics.values():
            for a in (c.values, c.present, c.sorted_vals, c.sorted_docs,
                      c.multi_values, c.multi_present):
                acc(a)
        for g in self.geos.values():
            acc(g.lon), acc(g.lat), acc(g.present)
        for s in self.strcols.values():
            acc(s.value_ids), acc(s.order)
        for m in self.missing.values():
            acc(m)
        for v in self.vectors.values():
            for a in (v.vecs, v.present, v.sq_norms, v.scan_vecs,
                      v.doc_rows):
                acc(a)
            if v.ivf is not None:
                for a in (v.ivf.centroids, v.ivf.cent_sq,
                          v.ivf.bucket_vecs, v.ivf.bucket_sq,
                          v.ivf.bucket_ids):
                    acc(a)
            if v.host_ivf is not None:
                acc(v.host_ivf.centroids), acc(v.host_ivf.cent_sq)
        for p in self._pcode_cache.values():
            for t in (p if isinstance(p, tuple) else (p,)):
                acc(t)
        return sum(seen.values())

    def host_bytes(self) -> int:
        """Bytes of the host-resident index arrays: a cold segment's CSR
        arrays and the host tier's vectors and bucket slabs."""
        total = 0
        if self.cold:
            tx = self.text
            for a in (tx.term_offsets, tx.doc_ids, tx.freqs,
                      tx.field_masks, tx.doclens, tx.pos_offsets,
                      tx.poskeys):
                total += a.nbytes
            for t in self.tags.values():
                total += t.offsets.nbytes + t.doc_ids.nbytes
        for v in self.vectors.values():
            if v.host:
                total += v.vecs.nbytes + v.sq_norms.nbytes
                if v.compression:
                    total += v.vq_off.nbytes + v.vq_scl.nbytes
                if v.host_ivf is not None:
                    total += v.host_ivf.host_bytes()
        return total


def make_segment(device, n_docs: int, gids: np.ndarray, alive: np.ndarray,
                 doclen: np.ndarray, max_freq: np.ndarray,
                 docscore: np.ndarray, expire_at: np.ndarray,
                 **fields) -> Segment:
    """A Segment from its host doc columns (each [n_pad]) and its built
    fields: the columns go to `device`, and `gids`, `alive` and `doclen`
    stay as the host mirrors the planner reads.  Seal, the bulk path,
    compaction and checkpoint load all build their segments here, each
    with a fresh `uid`, so no query's bind or row template of an older
    segment applies.  `gid_to_local`, `has_ttl` and `uniform_docscore`
    are derived from the columns unless given."""
    device = torch.device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    fields.setdefault("gid_to_local",
                      dict(zip(gids[:n_docs].tolist(), range(n_docs))))
    fields.setdefault("has_ttl", bool((expire_at != 0).any()))
    fields.setdefault("uniform_docscore",
                      bool((docscore[:n_docs] == 1.0).all()))
    return Segment(
        n_docs=n_docs, n_pad=int(gids.shape[0]), device=device,
        gids=dev(gids), alive=dev(alive), doclen=dev(doclen),
        max_freq=dev(max_freq), docscore=dev(docscore),
        expire_at=dev(expire_at), gids_np=gids, alive_np=alive,
        doclen_np=doclen, **fields)
