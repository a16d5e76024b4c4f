"""Windowed sorted-set algebra: the query evaluation core, in torch.

Counterpart of `redisearch_tpu/ops/window.py`.  A *window* is a posting
run read at a static length W: (docs int32[W], score f32[W], valid
bool[W]), with INT32_MAX in the lanes past the run.  Posting windows are
doc-ascending (the CSR order); generator outputs (unions, intersections)
need no order, except that the lanes a `member` probe searches hold their
valid docs ascending.

What changes from the JAX module, and why:

* `member` is a binary search (`torch.searchsorted`) over the window.
  The JAX module avoids binary search with 128-wide block compares
  because arbitrary gathers are slow on a TPU (`docs/DESIGN.md` §2); on
  a GPU the search is the natural membership test.  Invalid lanes (field
  mask misses, dead phrase candidates) may sit anywhere; the search runs
  over the running maximum of the valid docs, which is ascending, and
  lands on the valid entry of a doc when there is one.
* Window reads are gathers at clamped offsets (`_slice`), with the
  clamp `lax.dynamic_slice` applies, so that a start past the array's
  end moves the window exactly as it does in the JAX package (segments
  pad their arrays, so engine windows never clamp).

Every function takes and returns tensors on one device; scalar arguments
(starts, lengths, masks) may be 0-dim tensors there, so that a query
costs no host round trip.
"""

from __future__ import annotations

from typing import Optional

import torch

from .intersect import _window

INVALID = 2**31 - 1


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _slice(arr: torch.Tensor, start, W: int) -> torch.Tensor:
    """arr[start : start + W] along axis 0, the start clamped into
    [0, len - W] as `lax.dynamic_slice` clamps it (the one-row case of
    the intersection op's `_window`)."""
    return _window(arr, torch.as_tensor(start, device=arr.device)
                   .reshape(1), W)[0]


# ---------------------------------------------------------------------------
# Window constructors
# ---------------------------------------------------------------------------

def slot_window(doc_ids, freqs, field_masks, start, length, qmask, W: int,
                emask=None):
    """One term slot's postings as a window (docs ascending): (docs, tf,
    valid).  Entries the query field mask filters out stay in place but
    are invalid; `emask` (int32[n_pad] or [n_pad, K]) drops postings that
    survive only in expired TEXT fields.  `field_masks` is int32[nnz] or
    int32[nnz, K] multi-word masks, `qmask` a scalar or a [K] row."""
    dev = doc_ids.device
    in_range = _iota(W, dev) < length
    docs = torch.where(in_range, _slice(doc_ids, start, W), INVALID)
    wide = field_masks.dim() == 2
    fm = _slice(field_masks, start, W)
    live_mask = torch.as_tensor(qmask, device=dev)
    if emask is not None:
        n = emask.shape[0]
        live_mask = live_mask & ~emask[docs.clamp(max=n - 1).long()]
    hit = fm & live_mask
    valid = in_range & ((hit != 0).any(dim=-1) if wide else (hit != 0))
    tf = torch.where(valid, _slice(freqs, start, W), 0.0)
    return docs, tf, valid


def expired_field_mask(fexp, now):
    """Per-doc expired-TEXT-field bitmask from [n_pad, F] expiry times:
    int32[n_pad] for F <= 32, else int32[n_pad, K] words."""
    F = fexp.shape[1]
    expired = (fexp > 0) & (fexp <= now)
    dev = fexp.device

    def word(f0, f1):
        bits = torch.bitwise_left_shift(
            torch.ones((), dtype=torch.int32, device=dev),
            _iota(f1 - f0, dev))
        return torch.where(expired[:, f0:f1], bits[None, :], 0).sum(
            dim=1, dtype=torch.int32)

    if F <= 32:
        return word(0, F)
    K = (F + 31) // 32
    return torch.stack([word(32 * k, min(32 * (k + 1), F))
                        for k in range(K)], dim=-1)


def tag_window(doc_ids, start, length, W: int):
    """One tag value's doc postings as a window (no tf; docs ascending)."""
    in_range = _iota(W, doc_ids.device) < length
    docs = torch.where(in_range, _slice(doc_ids, start, W), INVALID)
    return docs, in_range


def numeric_window(sorted_docs, start, length, W: int):
    """A numeric range as a window: the value-sorted run (docs in value
    order, not doc order)."""
    in_range = _iota(W, sorted_docs.device) < length
    docs = torch.where(in_range, _slice(sorted_docs, start, W), INVALID)
    return docs, in_range & (docs != INVALID)


def dedup_window(docs, valid):
    """Drop duplicate doc ids from a window (multi-value numeric ranges
    yield one entry per in-range value): sort, then a neighbour compare."""
    d, _ = torch.sort(torch.where(valid, docs, INVALID))
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=d.device),
                     d[1:] == d[:-1]])
    v = (d != INVALID) & ~dup
    return torch.where(v, d, INVALID), v


def iota_window(n_pad: int, device):
    """All-docs generator (reference: wildcard iterator)."""
    return (_iota(n_pad, device),
            torch.ones(n_pad, dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Membership (the SkipTo analog)
# ---------------------------------------------------------------------------

def member(docs_w, valid_w, score_w, q_docs):
    """For each candidate doc (any order): is it a valid entry of the
    window, and with what score (None when `score_w` is None).  The
    window's valid docs ascend; its invalid lanes may sit anywhere."""
    key = torch.where(valid_w, docs_w, -1)
    key = torch.cummax(key, dim=0).values.contiguous()
    q = q_docs.contiguous()
    idx = torch.searchsorted(key, q).clamp(max=key.shape[0] - 1)
    hit = (key[idx] == q) & valid_w[idx] & (q != INVALID)
    if score_w is None:
        return hit, None
    return hit, torch.where(hit, score_w[idx], 0.0)


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

def union_windows(windows: list, dismax: bool = False,
                  extra: Optional[list] = None):
    """Merge windows into one window of unique docs, ascending.

    windows: list of (docs, score or None, valid), in any order.  The
    concatenation is STABLE-sorted by doc, and each duplicate run's
    scores fold onto its first entry (the earliest window's): a sum, or
    a max for DISMAX, in the JAX module's order (shifted adds, one per
    distance), so that the folded floats are the same bits.

    extra: optional per-window arrays (the aligned norm operands) carried
    through the same permutation, returned merged as a 4th result."""
    docs = torch.cat([torch.where(v, d, INVALID) for d, _, v in windows])
    score = torch.cat([
        torch.where(v, s, 0.0) if s is not None
        else torch.zeros(d.shape, dtype=torch.float32, device=d.device)
        for d, s, v in windows])
    d, perm = torch.sort(docs, stable=True)
    s = score[perm]
    ext = None
    if extra is not None and not any(e is None for e in extra):
        ext = torch.cat(list(extra))[perm]
    dev = d.device
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       d[1:] != d[:-1]])
    folded = s
    for j in range(1, len(windows)):
        d_sh = torch.cat([d[j:], torch.full((j,), -1, dtype=d.dtype,
                                            device=dev)])
        s_sh = torch.cat([s[j:], torch.zeros(j, dtype=s.dtype, device=dev)])
        same = d_sh == d
        folded = (torch.maximum(folded, torch.where(same, s_sh, folded))
                  if dismax else folded + torch.where(same, s_sh, 0.0))
    v = first & (d != INVALID)
    out = (torch.where(v, d, INVALID), torch.where(v, folded, 0.0), v)
    if extra is None:
        return out
    return out + (ext,)


def dedup_adjacent(docs, valid):
    """Deduplicate an ASCENDING doc array in place: keeps the first VALID
    entry of each doc, invalidates the rest, also when invalid entries
    sit between two valid ones (the running max of the previous valid
    docs, exact because valid docs ascend)."""
    d = torch.where(valid, docs, INVALID)
    run = torch.cummax(torch.where(valid, docs, -1), dim=0).values
    prev = torch.cat([torch.full((1,), -1, dtype=run.dtype,
                                 device=run.device), run[:-1]])
    v = valid & (d != prev) & (d != INVALID)
    return torch.where(v, d, INVALID), v
