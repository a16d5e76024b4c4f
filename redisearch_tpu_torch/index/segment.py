"""Immutable index segments holding torch tensors on the index's device.

Counterpart of `redisearch_tpu/index/segment.py`.  The host dataclasses
(`TermDict`, `TextPostings`, `TagPostings`, `NumericColumn`,
`StrColumn`) and the pad helpers are the JAX package's own, reached
through `_host`; their array fields hold torch tensors here.  Every pad
and array layout is identical to the JAX segment, so a window bucket or a
posting offset means the same thing in both packages.

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

from .._host.index.segment import (  # noqa: F401  (re-exported)
    KERNEL_ROW_PAD,
    LANE,
    POS_SLICE_PAD,
    NumericColumn,
    StrColumn,
    TagPostings,
    TermDict,
    TextPostings,
    mask_words,
    next_pow2,
    pack_mask_words,
    posting_pad,
    round_up,
    tail_pad,
)


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
    # no VECTOR columns yet (the builder refuses such schemas); the
    # planner looks vector fields up here
    vectors: dict = dataclasses.field(default_factory=dict)
    # clean-segment flags: the intersection kernel serves only segments
    # with no deletions, no TTLs and uniform doc scores
    n_deleted: int = 0
    has_ttl: bool = False
    uniform_docscore: bool = True
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
        """Bytes of every device tensor the segment holds."""
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
        for s in self.strcols.values():
            acc(s.value_ids), acc(s.order)
        for m in self.missing.values():
            acc(m)
        for p in self._pcode_cache.values():
            acc(p)
        return sum(seen.values())
