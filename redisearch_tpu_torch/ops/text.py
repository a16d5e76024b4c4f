"""Scorer constants, position-key windows, numeric filters and top-k.

Counterpart of `redisearch_tpu/ops/text.py`, the companion of
`ops/window.py` in the general window path.  Left out: `tags_match_dense`,
which no engine path calls; `tfidf_transform` serves both TFIDF and
TFIDF.DOCNORM (the JAX module's two functions differ only in the norm
they are given).

`fast_top_k` returns the exact top-k values at every width.  The JAX
module switches to `approx_max_k` above 65,536 lanes, a TPU cost trade;
its CPU reference is exact, and so is this one.  Ties keep the lowest
lane first, as `lax.top_k` does (`torch.topk` leaves the order of ties
undefined): a 1-D input takes a stable descending sort; rows of a 2-D
input take `torch.topk`, then their k lanes are reordered by (value,
lane), and up to 65,536 lanes (where the JAX module runs `lax.top_k`)
the lanes that tie with the k-th value are the lowest ones.
"""

from __future__ import annotations

import math

import torch

from . import window as W

# BM25 constants (reference: src/ext/default.c BM25STD k1=1.2, b=0.75).
BM25_K1 = 1.2
BM25_B = 0.75

INF = 2**31 - 1


def bm25_transform(tf, idf, doclen, avgdl, k1: float = BM25_K1,
                   b: float = BM25_B):
    """BM25STD per-term contribution (reference: ext/default.c:241-296),
    in the JAX function's operation order."""
    norm = k1 * (1.0 - b + b * doclen / torch.clamp(
        torch.as_tensor(avgdl), min=1e-9))
    return idf * tf * (k1 + 1.0) / (tf + norm)


def tfidf_transform(tf, idf, norm):
    """TFIDF (tf / maxFreq) and TFIDF.DOCNORM (tf / doc length) times the
    idf (ext/default.c:142, :214)."""
    return idf * tf / torch.clamp(norm, min=1.0)


def gather_poskeys(poskeys, pos_offsets, start, length, P: int):
    """Window of one term's sorted position keys: the contiguous run
    poskeys[pos_offsets[start] : pos_offsets[start + length]] read at
    width P, INT32_MAX past its end.  Returns (keys [P], run length)."""
    st = torch.as_tensor(start, device=pos_offsets.device).long()
    kstart = pos_offsets[st]
    klen = pos_offsets[st + torch.as_tensor(length, device=st.device)] - kstart
    keys = W._slice(poskeys, kstart, P)
    lane = torch.arange(P, dtype=torch.int32, device=poskeys.device)
    return torch.where(lane < klen, keys, INF), klen


def searchsorted_dynamic(arr, q, lo, hi, side: str = "left",
                         rounds: int | None = None):
    """First index in the range [lo, hi) where ascending `arr` crosses
    `q` (side "left": arr[idx] >= q; "right": arr[idx] > q): the JAX
    module's branchless binary search with per-query bounds, `rounds`
    steps (default ceil(log2(len(arr))))."""
    n = arr.shape[0]
    if rounds is None:
        rounds = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    dev = q.device
    lo_v = torch.as_tensor(lo, device=dev).to(torch.int32).expand(q.shape)
    hi_v = torch.as_tensor(hi, device=dev).to(torch.int32).expand(q.shape)
    for _ in range(rounds):
        mid = (lo_v + hi_v) >> 1
        v = arr[mid.clamp(max=n - 1).long()]
        go = (v < q) if side == "left" else (v <= q)
        smaller = lo_v < hi_v
        lo_v = torch.where(smaller & go, mid + 1, lo_v)
        hi_v = torch.where(smaller & ~go, mid, hi_v)
    return lo_v


def _gather(arr, idx):
    return arr[idx.clamp(0, arr.shape[0] - 1).long()]


def min_offset_delta(keys_a, keys_b, pos_stride: int, docs):
    """Per-candidate-doc minimum |position_a - position_b| between two
    ascending position-key windows (INT32_MAX pads), the GetSlop building
    block (reference: IndexResult_MinOffsetDelta).  Returns (delta int32
    [C], INT32_MAX where either side has no positions at the doc, and
    present_a bool [C]).  The JAX module's vectorized form: nearest
    same-doc neighbour in keys_b for every key of keys_a, a segmented
    backward min over keys_a's doc runs, then one run-head probe per
    candidate doc."""
    dev = keys_a.device
    Pa = keys_a.shape[0]
    doc_a = torch.div(keys_a, pos_stride, rounding_mode="floor")
    idx = torch.searchsorted(keys_b.contiguous(), keys_a.contiguous(),
                             out_int32=True)
    up = _gather(keys_b, idx)
    dn = _gather(keys_b, idx - 1)
    valid_a = keys_a != INF
    d_up = torch.where(valid_a & (up != INF)
                       & (torch.div(up, pos_stride, rounding_mode="floor")
                          == doc_a), up - keys_a, INF)
    d_dn = torch.where(valid_a & (idx > 0)
                       & (torch.div(dn, pos_stride, rounding_mode="floor")
                          == doc_a), keys_a - dn, INF)
    d = torch.minimum(d_up, d_dn)
    shift = 1
    while shift < Pa:
        d_sh = torch.cat([d[shift:], torch.full((shift,), INF,
                                                dtype=d.dtype, device=dev)])
        doc_sh = torch.cat([doc_a[shift:], torch.full(
            (shift,), -1, dtype=doc_a.dtype, device=dev)])
        d = torch.where(doc_sh == doc_a, torch.minimum(d, d_sh), d)
        shift <<= 1
    lim = INF // max(pos_stride, 1)
    q = (docs.clamp(max=lim) * pos_stride).to(torch.int32)
    head = torch.searchsorted(keys_a.contiguous(), q.contiguous(),
                              out_int32=True)
    hk = _gather(keys_a, head)
    hd = _gather(d, head)
    present = ((docs != INF) & (hk != INF)
               & (torch.div(hk, pos_stride, rounding_mode="floor") == docs))
    return torch.where(present, hd, INF), present


def numeric_range_mask(values, present, lo, hi, lo_excl: bool,
                       hi_excl: bool):
    """NUMERIC [lo hi] filter over a dense column."""
    ge = values > lo if lo_excl else values >= lo
    le = values < hi if hi_excl else values <= hi
    return present & ge & le


#: widths up to which the JAX module's top-k is `lax.top_k` (its
#: EXACT_TOPK_LIMIT): here the lanes tying with the k-th value are the
#: lowest ones, as there
EXACT_TOPK_LIMIT = 65536


EARTH_RADIUS_M = 6372797.560856  # matches redis geo.c constant


def geo_radius_mask(lon, lat, present, qlon, qlat, radius_m):
    """GEO radius filter: exact f32 haversine over the columns (radians),
    in the JAX function's asin(sqrt(a)) form, accurate for small
    distances (reference: src/geo_index.c:28 approximates with geohash
    cells, then filters exactly)."""
    dlat = lat - qlat
    dlon = lon - qlon
    a = (torch.sin(dlat * 0.5) ** 2
         + torch.cos(lat) * torch.cos(qlat) * torch.sin(dlon * 0.5) ** 2)
    dist = 2.0 * EARTH_RADIUS_M * torch.arcsin(
        torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    return present & (dist <= radius_m)


def fast_top_k(x, k: int):
    """Top-k along the last axis of a 1-D or 2-D tensor: (values [..., k],
    lanes [..., k]), descending, ties by lowest lane (`lax.top_k`'s
    order; see the module docstring for rows past 65,536 lanes)."""
    if x.dim() == 1:
        vals, idx = torch.sort(x, descending=True, stable=True)
        # copies: a view would keep the whole sorted row alive
        return vals[:k].clone(), idx[:k].clone()
    n = x.shape[-1]
    vals, idx = torch.topk(x, k, dim=-1, largest=True, sorted=True)
    if n <= EXACT_TOPK_LIMIT:
        # lanes equal to the k-th value: the lowest ones, in lane order,
        # fill the positions after the strictly greater values
        kth = vals[:, -1:]
        n_gt = (vals > kth).sum(dim=1, keepdim=True)
        lane = torch.arange(n, dtype=torch.int32, device=x.device)
        tie_key = torch.where(x == kth, -lane, -n - 1)
        ties = torch.topk(tie_key, k, dim=-1, sorted=True)[1]
        pos = torch.arange(k, device=x.device)[None, :]
        from_ties = torch.gather(ties, 1, (pos - n_gt).clamp(min=0))
        idx = torch.where(pos >= n_gt, from_ties, idx)
    # (value desc, lane asc): order by lane, then a stable sort by value
    order = torch.argsort(idx, dim=1)
    idx = torch.gather(idx, 1, order)
    vals, order = torch.sort(torch.gather(vals, 1, order), dim=1,
                             descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


def topk_by_key(keys, valid, k: int, ascending: bool):
    """Top-k lanes ordered by an f32 sort key (SORTBY).  Returns the
    masked keys at those lanes (invalid lanes surface as +-3.4e38, which
    the merger drops) and the lanes."""
    big = 3.4e38
    k_ = torch.where(valid, keys, big if ascending else -big)
    _vals, idx = fast_top_k(-k_ if ascending else k_, k)
    return k_[idx], idx
