"""Batched term-query intersection: the BM25 serving hot path.

Counterpart of `redisearch_tpu/ops/intersect.py` (`intersect_batch`,
`_xla_impl`, `iter_topk`).  Per query of a batch, per pivot phase: BM25STD
at the pivot window's postings, the field-mask test, dense TAG code
predicates, REQ/NOT/OPT membership of the other slots, first-owner dedup
across OR phases; then the phase's top-k (score desc, lowest doc on ties)
and the match count.  Raw mode (`raw=True`, the FT.AGGREGATE GROUPBY
path) skips the top-k and returns each phase's masked (doc, score) lanes,
row-aligned with the postings as the Pallas kernel writes them.

Two implementations of one contract:

* `intersect_plain`: plain torch, a port of `_xla_impl` with the batch
  axis written out.  It serves CPU tensors (the tests) and is what the
  CUDA kernel is held against on the card.
* the CUDA kernel `csrc/intersect.cu`, launched by `intersect_batch` for
  CUDA tensors.  There is no fallback: a CUDA tensor launches the kernel
  or raises.

Exhausted output lanes hold (INT32_MAX, NEG_INF), as the Pallas kernel's
`_extract_pass` gives.  (`_xla_impl` leaves a real doc id with a NEG_INF
score there; every consumer drops lanes by score.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

BLK = 128
R_EXTRA = 8             # raw sections carry W // 128 + R_EXTRA rows
#: the JAX kernel's pivot bound (its VMEM), kept for the raw mode and the
#: planner's narrow route; the CUDA top-k mode takes pivots up to
#: MAX_W_MEMBER
MAX_W_PIVOT = 32768
MAX_W_MEMBER = 131072
NEG_INF = -3.4e38
K1 = 1.2
B_ = 0.75
INT32_MAX = 2**31 - 1

# slot flags (mode="and")
REQ, NOT, OPT = 0, 1, 2

#: kernel launches made by `intersect_batch` (plain int; callers reset it)
LAUNCHES = 0
#: of those, the launches whose pivot is wider than MAX_W_PIVOT (the wide
#: route's shapes)
WIDE_LAUNCHES = 0


def _slot_srcs(T: int, groups) -> list:
    """Per-slot source index from the (flag, slots, src) groups:
    -1 = text postings, >= 0 = aux doc-window array (tag postings)."""
    src = [-1] * T
    for g in groups:
        s = g[2] if len(g) > 2 else -1
        for t in g[1]:
            src[t] = s
    return src


def _out_lanes(groups, pivot_g: int, k: int) -> int:
    """Output lanes per query: the phases' P*k lanes rounded up to whole
    128-lane rows, as the JAX package returns them."""
    P_n = len(groups[pivot_g][1])
    return max(-(-(P_n * k) // BLK), 1) * BLK


def _raw_lanes(Ws, groups, pivot_g: int) -> int:
    """Output lanes per query in raw mode: per pivot slot, in phase
    order, a section of Ws[p] // 128 + R_EXTRA rows of 128 lanes."""
    return sum(Ws[p] // BLK + R_EXTRA for p in groups[pivot_g][1]) * BLK


def _phase_plan(T, groups, pivot_g):
    """[(pivot slot, others)] in phase order; others as in `_xla_impl`:
    earlier pivot siblings dedup+fold, later ones fold, then every other
    group in order."""
    pivots = list(groups[pivot_g][1])
    plan = []
    for pi, p in enumerate(pivots):
        others = [("slot", u, "dedup+fold") for u in pivots[:pi]]
        others += [("slot", u, "fold") for u in pivots[pi + 1:]]
        for gi, g in enumerate(groups):
            if gi == pivot_g:
                continue
            others.append(("group", g[0], g[1], g[2] if len(g) > 2 else -1))
        plan.append((p, others))
    return plan


def _window(arr, starts, W):
    """[b, W] gather of arr[start : start + W] per row, with the start
    clamped into [0, len - W] as `lax.dynamic_slice` clamps it."""
    n = arr.shape[0]
    st = starts.long().clamp(0, max(n - W, 0))
    idx = st[:, None] + torch.arange(W, device=arr.device)[None, :]
    return arr[idx]


def intersect_plain(meta, fmeta, doc_ids, freqs, masks, posting_dl, *aux,
                    T: int, Ws: tuple, groups: tuple, pivot_g: int = 0,
                    k: int = 16, dense: tuple = (), raw: bool = False):
    """Plain torch port of `_xla_impl` (and, with raw=True, of the Pallas
    kernel's raw mode): same arguments and outputs as `intersect_batch`.
    Runs the batch in chunks so the [b, W] member windows stay small (a
    [8192, 131072] gather alone would be 4 GB)."""
    B = meta.shape[0]
    dev = meta.device
    L = (_raw_lanes(Ws, groups, pivot_g) if raw
         else _out_lanes(groups, pivot_g, k))
    chunk = max(1, (1 << 22) // max(max(Ws), L))
    docs_o, scores_o, counts_o = [], [], []
    for c0 in range(0, B, chunk):
        d, s, c = _plain_chunk(
            meta[c0:c0 + chunk], fmeta[c0:c0 + chunk], doc_ids, freqs,
            masks, posting_dl, aux, T=T, Ws=Ws, groups=groups,
            pivot_g=pivot_g, k=k, dense=dense, L=L, raw=raw)
        docs_o.append(d)
        scores_o.append(s)
        counts_o.append(c)
    if not docs_o:
        return (torch.empty((0, L), dtype=torch.int32, device=dev),
                torch.empty((0, L), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    return torch.cat(docs_o), torch.cat(scores_o), torch.cat(counts_o)


def _plain_chunk(meta, fmeta, doc_ids, freqs, masks, posting_dl, aux, *,
                 T, Ws, groups, pivot_g, k, dense, L, raw):
    b = meta.shape[0]
    dev = meta.device
    srcs = _slot_srcs(T, groups)
    dense_off = []
    off = 3 * T
    for (_fl, _src, nv) in dense:
        dense_off.append(off)
        off += nv
    starts = meta[:, :T]
    lens = meta[:, T:2 * T]
    qm = meta[:, 2 * T:3 * T]
    tws = fmeta[:, :T]
    avgdl = fmeta[:, T:T + 1]
    INF = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    NEG = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def win(t):
        W = Ws[t]
        inr = torch.arange(W, device=dev)[None, :] < lens[:, t:t + 1]
        if srcs[t] >= 0:
            d = _window(aux[srcs[t]], starts[:, t], W)
            return torch.where(inr, d, INF), None, inr, None
        d = _window(doc_ids, starts[:, t], W)
        f = _window(freqs, starts[:, t], W)
        mk = _window(masks, starts[:, t], W)
        dlw = _window(posting_dl, starts[:, t], W)
        v = inr & ((mk & qm[:, t:t + 1]) != 0)
        return torch.where(inr, d, INF), f, v, dlw

    def pivot_win(p):
        """Slot p's candidate lanes: (docs, freqs, valid, doclens, the
        codes of dense predicate d).  Top-k mode: the window at its
        start, clamped as `win` clamps it.  Raw mode: Ws[p] // 128 +
        R_EXTRA whole 128-lane rows from the start's row, live in
        [start % 128, start % 128 + len) — the Pallas kernel's DMA."""
        if not raw:
            def codes(d):
                return _window(aux[dense[d][1]], starts[:, p], Ws[p])
            return (*win(p), codes)
        lanes = torch.arange((Ws[p] // BLK + R_EXTRA) * BLK, device=dev)
        st = starts[:, p].long()
        base = torch.div(st, BLK, rounding_mode="floor") * BLK
        r = (st - base)[:, None]
        inr = (lanes[None, :] >= r) & (lanes[None, :] < r + lens[:, p:p + 1])
        pos = base[:, None] + lanes[None, :]

        def at(arr):
            return arr[pos.clamp(0, arr.shape[0] - 1)]
        v = inr & ((at(masks) & qm[:, p:p + 1]) != 0)
        return (torch.where(inr, at(doc_ids), INF), at(freqs), v,
                at(posting_dl), lambda d: at(aux[dense[d][1]]))

    def member(t, pd):
        md, mf_, mv, _ = win(t)
        idx = torch.searchsorted(md, pd).clamp(0, Ws[t] - 1)
        hit = ((torch.gather(md, 1, idx) == pd) & torch.gather(mv, 1, idx)
               & (pd != INF))
        if mf_ is None:
            return hit, None
        return hit, torch.where(hit, torch.gather(mf_, 1, idx), zero)

    def phase(p, others):
        pd, pf, pvalid, pdl, codes = pivot_win(p)

        def bm25(tf, w):
            # the JAX op order: K1 * (0.25 + (B_*dl)/max(avgdl, 1e-9)),
            # then ((w*tf)*(K1+1)) / (tf+norm) — f32 throughout
            norm = K1 * (1.0 - B_ + B_ * pdl
                         / torch.clamp(avgdl, min=1e-9))
            return w * tf * (K1 + 1.0) / (tf + norm)

        score = torch.where(pvalid, bm25(pf, tws[:, p:p + 1]), zero)
        valid = pvalid
        for di, (fl, _dsrc, nv) in enumerate(dense):
            cw = codes(di)
            o = dense_off[di]
            hitd = cw == meta[:, o:o + 1]
            for v in range(1, nv):
                hitd = hitd | (cw == meta[:, o + v:o + v + 1])
            dconst = fmeta[:, T + 1 + di:T + 2 + di]
            if fl == REQ:
                valid = valid & hitd
                score = score + torch.where(hitd, dconst, zero)
            elif fl == NOT:
                valid = valid & ~hitd
            else:
                score = score + torch.where(hitd, dconst, zero)
        for item in others:
            if item[0] == "slot":
                _tag, u, kind = item
                hit, tf_m = member(u, pd)
                score = score + torch.where(hit, bm25(tf_m, tws[:, u:u + 1]),
                                            zero)
                if kind == "dedup+fold":
                    valid = valid & ~hit
            else:
                _tag, fl, slots_g, gsrc = item
                ghit = torch.zeros_like(pvalid)
                gadd = torch.zeros_like(score)
                for u in slots_g:
                    hit, tf_m = member(u, pd)
                    ghit = ghit | hit
                    if gsrc < 0:
                        gadd = gadd + torch.where(
                            hit, bm25(tf_m, tws[:, u:u + 1]), zero)
                if gsrc >= 0:
                    gadd = torch.where(ghit, tws[:, slots_g[0]:slots_g[0] + 1],
                                       zero)
                if fl == REQ:
                    valid = valid & ghit
                    score = score + gadd
                elif fl == NOT:
                    valid = valid & ~ghit
                else:
                    score = score + gadd
        return torch.where(valid, pd, INF), torch.where(valid, score, NEG)

    plan = _phase_plan(T, groups, pivot_g)
    if raw:
        secs = [phase(p, others) for p, others in plan]
        d = torch.cat([s_[0] for s_ in secs], dim=1)
        return (d, torch.cat([s_[1] for s_ in secs], dim=1),
                (d != INF).sum(1, dtype=torch.int32))
    topd = torch.full((b, L), INT32_MAX, dtype=torch.int32, device=dev)
    tops = torch.full((b, L), NEG_INF, dtype=torch.float32, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    for pi, (p, others) in enumerate(plan):
        d, sc = phase(p, others)
        count = count + (d != INF).sum(1, dtype=torch.int32)
        # k max-extractions == the first k of a stable descending sort:
        # ties keep window order, i.e. the lowest doc
        kk = min(k, sc.shape[1])
        vals, sel = torch.sort(sc, dim=1, descending=True, stable=True)
        vals, sel = vals[:, :kk], sel[:, :kk]
        dv = torch.where(vals > NEG, torch.gather(d, 1, sel), INF)
        topd[:, pi * k:pi * k + kk] = dv
        tops[:, pi * k:pi * k + kk] = vals
    return topd, tops, count


def iter_topk(scores, docs, k: int):
    """Exact batched top-k over [B, N] per-phase lanes: (vals [B, k],
    sel [B, k]), score descending, ties by lowest flat index (multi-phase
    merges rely on it).  A stable descending sort keeps equal scores in
    lane order; `torch.topk` leaves their order undefined."""
    vals, sel = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], sel[:, :k]


def _phrase_lanes(Ws, k: int, raw: bool) -> int:
    """Output lanes per query of the phrase op: k rounded up to whole
    128-lane rows, or in raw mode term 0's section of Ws[0] // 128 +
    R_EXTRA rows."""
    if raw:
        return (Ws[0] // BLK + R_EXTRA) * BLK
    return max(-(-k // BLK), 1) * BLK


def phrase_plain(meta, fmeta, doc_ids, freqs, masks, posting_dl, poskeys, *,
                 T: int, Ws: tuple, PWs: tuple, stride: int, slop: int = 0,
                 k: int = 16, raw: bool = False, eq_join=None):
    """Plain torch port of `_xla_phrase_impl` (and, with raw=True, of the
    Pallas phrase kernel's raw mode): same arguments and outputs as
    `phrase_batch`.  `eq_join` changes nothing: the result is the anchor
    chain's, as in the twin.  Runs the batch in chunks so the [b, PW]
    key windows stay small."""
    B = meta.shape[0]
    dev = meta.device
    L = _phrase_lanes(Ws, k, raw)
    chunk = max(1, (1 << 22) // max(max(Ws), max(PWs), L))
    outs = [_phrase_chunk(meta[c0:c0 + chunk], fmeta[c0:c0 + chunk],
                          doc_ids, freqs, masks, posting_dl, poskeys, T=T,
                          Ws=Ws, PWs=PWs, stride=stride, slop=slop, k=k,
                          L=L, raw=raw)
            for c0 in range(0, B, chunk)]
    if not outs:
        return (torch.empty((0, L), dtype=torch.int32, device=dev),
                torch.empty((0, L), dtype=torch.float32, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev))
    return tuple(torch.cat(o) for o in zip(*outs))


def _phrase_chunk(meta, fmeta, doc_ids, freqs, masks, posting_dl, poskeys, *,
                  T, Ws, PWs, stride, slop, k, L, raw):
    b = meta.shape[0]
    dev = meta.device
    tstarts, tlens, qm = meta[:, :T], meta[:, T:2 * T], meta[:, 2 * T:3 * T]
    pstarts, plens = meta[:, 3 * T:4 * T], meta[:, 4 * T:5 * T]
    tws = fmeta[:, :T]
    avgdl = fmeta[:, T:T + 1]
    INF = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    NEG = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def pwin(t):
        ks = _window(poskeys, pstarts[:, t], PWs[t])
        live = torch.arange(PWs[t], device=dev)[None, :] < plens[:, t:t + 1]
        return torch.where(live, ks, INF)

    # the in-order anchor chain over term 0's keys; spans in 64 bits so
    # dead lanes (INF keys) cannot overflow
    cand = pwin(0)
    alive = cand != INF
    doc0 = torch.where(alive, torch.div(cand, stride, rounding_mode="floor"),
                       INF)
    anchor = cand
    ok = alive
    span = torch.zeros(cand.shape, dtype=torch.int64, device=dev)
    for j in range(1, T):
        kj = pwin(j)
        at = torch.searchsorted(kj, anchor)
        found = torch.where(at < PWs[j],
                            torch.gather(kj, 1, at.clamp(max=PWs[j] - 1)),
                            INF)
        ok = (ok & (found >= anchor) & (found != INF)
              & (torch.div(found, stride, rounding_mode="floor") == doc0))
        span = torch.where(ok, span + (found.long() - anchor.long() - 1),
                           span)
        ok = ok & (span <= max(slop, 0))
        anchor = torch.where(ok, found, anchor)

    def win(t):
        W = Ws[t]
        inr = torch.arange(W, device=dev)[None, :] < tlens[:, t:t + 1]
        d = _window(doc_ids, tstarts[:, t], W)
        mv = inr & ((_window(masks, tstarts[:, t], W) & qm[:, t:t + 1]) != 0)
        return (torch.where(inr, d, INF), _window(freqs, tstarts[:, t], W),
                mv, inr, _window(posting_dl, tstarts[:, t], W))

    if raw:
        # term 0's whole 128-lane rows from its start's row, live in
        # [start % 128, start % 128 + len) — the Pallas kernel's DMA
        lanes = torch.arange(L, device=dev)
        st = tstarts[:, 0].long()
        base = torch.div(st, BLK, rounding_mode="floor") * BLK
        r = (st - base)[:, None]
        pinr = (lanes[None, :] >= r) & (lanes[None, :] < r + tlens[:, :1])
        pos = base[:, None] + lanes[None, :]

        def at0(arr):
            return arr[pos.clamp(0, arr.shape[0] - 1)]
        pd = torch.where(pinr, at0(doc_ids), INF)
        pf, pdl = at0(freqs), at0(posting_dl)
        pmv = pinr & ((at0(masks) & qm[:, :1]) != 0)
    else:
        pd, pf, pmv, pinr, pdl = win(0)

    # fold: a term-0 doc hits when one of its keys survived the chain
    okc = torch.cumsum(ok.to(torch.int32), dim=1)
    cand64 = cand.long()
    lo = torch.searchsorted(cand64, pd.long() * stride)
    hi = torch.searchsorted(cand64, (pd.long() + 1) * stride)

    def c_at(i):
        return torch.where(i > 0, torch.gather(okc, 1, (i - 1).clamp(min=0)),
                           0)
    anylen = (tlens > 0).all(dim=1, keepdim=True)
    dochit = pinr & (c_at(hi) - c_at(lo) > 0) & anylen

    def bm25(tf, w):
        # the twin's op order, f32 throughout (see intersect_plain)
        norm = K1 * (1.0 - B_ + B_ * pdl / torch.clamp(avgdl, min=1e-9))
        return w * tf * (K1 + 1.0) / (tf + norm)

    # phrase validity reads positions only; each slot scores where its
    # own posting is mask-valid
    score = torch.where(dochit & pmv, bm25(pf, tws[:, :1]), zero)
    for u in range(1, T):
        md, mf, mmv, _inr, _dl = win(u)
        idx = torch.searchsorted(md, pd).clamp(max=Ws[u] - 1)
        hit = ((torch.gather(md, 1, idx) == pd) & torch.gather(mmv, 1, idx)
               & dochit)
        score = score + torch.where(
            hit, bm25(torch.gather(mf, 1, idx), tws[:, u:u + 1]), zero)
    d_o = torch.where(dochit, pd, INF)
    s_o = torch.where(dochit, score, NEG)
    count = dochit.sum(1, dtype=torch.int32)
    if raw:
        return d_o, s_o, count
    topd = torch.full((b, L), INT32_MAX, dtype=torch.int32, device=dev)
    tops = torch.full((b, L), NEG_INF, dtype=torch.float32, device=dev)
    # k max-extractions == the first k of a stable descending sort
    kk = min(k, s_o.shape[1])
    vals, sel = iter_topk(s_o, d_o, kk)
    topd[:, :kk] = torch.where(vals > NEG, torch.gather(d_o, 1, sel), INF)
    tops[:, :kk] = vals
    return topd, tops, count


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

# descriptor layout shared with csrc/intersect.cu (PLAN_* there)
_PLAN_LEN = 128
_P_WS, _P_PIV, _P_GRP, _P_DNS, _P_RAW = 6, 14, 22, 110, 120
_GRP_REC, _DNS_REC = 11, 4
_MAX_AUX = 4
#: blocks in flight: each walks queries blockIdx, blockIdx + grid, ...
_MAX_GRID = 4096


def _plan_array(T, Ws, groups, pivot_g, k, dense,
                raw: bool = False) -> np.ndarray:
    """The static plan as the kernel's int32 descriptor."""
    pivots = list(groups[pivot_g][1])
    if not 1 <= T <= 8 or len(groups) > 8 or len(pivots) > 8:
        raise ValueError(f"plan too large for the kernel: T={T}, "
                         f"{len(groups)} groups, {len(pivots)} pivots")
    if len(dense) > 2:
        raise ValueError("at most 2 dense predicates")
    plan = np.zeros(_PLAN_LEN, np.int32)
    plan[0:6] = (T, k, pivot_g, len(groups), len(dense), len(pivots))
    plan[_P_WS:_P_WS + T] = Ws
    plan[_P_PIV:_P_PIV + len(pivots)] = pivots
    for gi, g in enumerate(groups):
        o = _P_GRP + gi * _GRP_REC
        slots = list(g[1])
        plan[o:o + 3] = (g[0], g[2] if len(g) > 2 else -1, len(slots))
        plan[o + 3:o + 3 + len(slots)] = slots
    moff = 3 * T
    for di, (fl, src, nv) in enumerate(dense):
        o = _P_DNS + di * _DNS_REC
        plan[o:o + 4] = (fl, src, nv, moff)
        moff += nv
    plan[_P_RAW] = int(raw)
    return plan


def _check(t, name, dtype, device, ndim=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")


def _launch(meta, fmeta, doc_ids, freqs, masks, posting_dl, aux, *,
            T, Ws, groups, pivot_g, k, dense, raw):
    from . import _build
    lib = _build.load("intersect")
    dev = meta.device
    B = meta.shape[0]
    srcs = _slot_srcs(T, groups)
    n_meta = 3 * T + sum(d[2] for d in dense)
    n_fmeta = T + 1 + len(dense)
    _check(meta, "meta", torch.int32, dev, 2)
    _check(fmeta, "fmeta", torch.float32, dev, 2)
    if meta.shape[1] != n_meta or fmeta.shape != (B, n_fmeta):
        raise ValueError(f"meta {tuple(meta.shape)} / fmeta "
                         f"{tuple(fmeta.shape)} do not match the plan "
                         f"({n_meta}, {n_fmeta} columns)")
    _check(doc_ids, "doc_ids", torch.int32, dev, 1)
    N = doc_ids.shape[0]
    for name, t, dt in (("freqs", freqs, torch.float32),
                        ("masks", masks, torch.int32),
                        ("posting_dl", posting_dl, torch.float32)):
        _check(t, name, dt, dev, 1)
        if t.shape[0] != N:
            raise ValueError(f"{name}: length {t.shape[0]} != {N}")
    if len(aux) > _MAX_AUX:
        raise ValueError(f"at most {_MAX_AUX} aux arrays")
    for i, a in enumerate(aux):
        _check(a, f"aux[{i}]", torch.int32, dev, 1)
    for t in range(T):
        n_src = N if srcs[t] < 0 else aux[srcs[t]].shape[0]
        if Ws[t] > n_src:
            raise ValueError(f"slot {t}: window {Ws[t]} exceeds its "
                             f"array ({n_src})")
    for (_fl, src, _nv) in dense:
        if src >= len(aux) or aux[src].shape[0] < N:
            raise ValueError("dense code column shorter than the postings")
    w_piv = MAX_W_PIVOT if raw else MAX_W_MEMBER
    if max(Ws[p] for p in groups[pivot_g][1]) > w_piv:
        raise ValueError(f"pivot window exceeds {w_piv} "
                         f"({'raw' if raw else 'top-k'} mode)")
    if not 1 <= k <= 64:
        raise ValueError(f"k={k} outside [1, 64]")
    plan = _plan_array(T, Ws, groups, pivot_g, k, dense, raw)
    L = (_raw_lanes(Ws, groups, pivot_g) if raw
         else _out_lanes(groups, pivot_g, k))
    out_docs = torch.empty((B, L), dtype=torch.int32, device=dev)
    out_scores = torch.empty((B, L), dtype=torch.float32, device=dev)
    out_counts = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out_docs, out_scores, out_counts
    grid = min(B, _MAX_GRID)
    aux_p = [a.data_ptr() for a in aux] + [0] * (_MAX_AUX - len(aux))
    aux_n = [a.shape[0] for a in aux] + [0] * (_MAX_AUX - len(aux))
    rc = lib.rs_intersect_launch(
        meta.data_ptr(), n_meta, fmeta.data_ptr(), n_fmeta,
        doc_ids.data_ptr(), freqs.data_ptr(), masks.data_ptr(),
        posting_dl.data_ptr(), N,
        (ctypes.c_void_p * _MAX_AUX)(*aux_p),
        (ctypes.c_longlong * _MAX_AUX)(*aux_n),
        plan.ctypes.data_as(ctypes.c_void_p),
        out_docs.data_ptr(), out_scores.data_ptr(), out_counts.data_ptr(),
        L, B, grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{rc} ({_build.error_string('intersect', rc)})")
    global LAUNCHES, WIDE_LAUNCHES
    LAUNCHES += 1
    WIDE_LAUNCHES += int(max(Ws[p] for p in groups[pivot_g][1])
                         > MAX_W_PIVOT)
    return out_docs, out_scores, out_counts


def intersect_batch(meta, fmeta, doc_ids, freqs, masks, posting_dl, *aux,
                    T: int, Ws: tuple, groups: tuple, pivot_g: int = 0,
                    k: int = 16, dense: tuple = (), raw: bool = False):
    """Run the term-query intersection over a batch.

    meta: int32 [B, 3T + sum(nv)] — per slot starts, lens, qmasks, then
    the dense predicates' query value ids (nv each).
    fmeta: f32 [B, T+1+D] — per slot tweights (idf*weight), avgdl, then
    one leaf constant per dense predicate.
    groups: ((flag, (slot_idx, ...)[, src]), ...) — REQ/NOT/OPT groups
    over the T slots; src >= 0 reads the slot's docs from `aux[src]`
    (tag postings: hit-only members scoring their leaf constant once per
    doc).  dense: ((flag, aux_src, n_vals), ...) — predicates over
    posting-aligned int32 code columns in `aux`.  `pivot_g` names the
    TEXT REQ group whose slots generate the candidate phases.

    Returns (docs int32 [B, L], scores f32 [B, L], counts int32 [B]),
    L = P*k rounded up to 128: per phase the top-k (score desc, lowest
    doc on ties) with INT32_MAX / NEG_INF filler — merge phases with
    iter_topk — plus the total match count.

    Pivot windows up to MAX_W_MEMBER in top-k mode, MAX_W_PIVOT in raw
    mode.  CPU tensors run `intersect_plain`; CUDA tensors launch the
    kernel (`LAUNCHES` counts each launch, `WIDE_LAUNCHES` those with a
    pivot past MAX_W_PIVOT) or raise.
    """
    if meta.device.type == "cpu":
        return intersect_plain(meta, fmeta, doc_ids, freqs, masks,
                               posting_dl, *aux, T=T, Ws=Ws, groups=groups,
                               pivot_g=pivot_g, k=k, dense=dense, raw=raw)
    if meta.device.type != "cuda":
        raise RuntimeError(f"no intersect kernel for device {meta.device}")
    return _launch(meta, fmeta, doc_ids, freqs, masks, posting_dl, aux,
                   T=T, Ws=Ws, groups=groups, pivot_g=pivot_g, k=k,
                   dense=dense, raw=raw)


# ---------------------------------------------------------------------------
# Phrase kernel launch
# ---------------------------------------------------------------------------

#: kernel launches made by `phrase_batch` (plain int; callers reset it)
PHRASE_LAUNCHES = 0
#: bytes of top-k scratch the phrase kernel's grid may hold: each block
#: owns one [Ws[0]] f32 score row, so at the 131,072 bucket the grid is
#: 512 blocks, not _MAX_GRID (whose rows would take 2 GB)
_PHRASE_SCRATCH_BYTES = 256 << 20


def _phrase_params(T, Ws, PWs, stride, slop, k, raw, out_cols, scr_cols,
                   B) -> np.ndarray:
    """The int32 parameter block csrc/phrase.cu reads (P_* there)."""
    prm = np.zeros(16, np.int32)
    prm[0:8] = (T, stride, slop, k, int(raw), out_cols, scr_cols, B)
    prm[8:8 + T] = Ws
    prm[12:12 + T] = PWs
    return prm


def _phrase_launch(meta, fmeta, doc_ids, freqs, masks, posting_dl, poskeys,
                   *, T, Ws, PWs, stride, slop, k, raw):
    from . import _build
    lib = _build.load("phrase")
    dev = meta.device
    B = meta.shape[0]
    if not 2 <= T <= 4 or len(Ws) != T or len(PWs) != T:
        raise ValueError(f"phrase kernel takes 2..4 terms with a window "
                         f"each: T={T}, Ws={Ws}, PWs={PWs}")
    _check(meta, "meta", torch.int32, dev, 2)
    _check(fmeta, "fmeta", torch.float32, dev, 2)
    if meta.shape[1] != 5 * T or fmeta.shape != (B, T + 1):
        raise ValueError(f"meta {tuple(meta.shape)} / fmeta "
                         f"{tuple(fmeta.shape)}: expected {5 * T} and "
                         f"{T + 1} columns")
    _check(doc_ids, "doc_ids", torch.int32, dev, 1)
    N = doc_ids.shape[0]
    for name, t, dt in (("freqs", freqs, torch.float32),
                        ("masks", masks, torch.int32),
                        ("posting_dl", posting_dl, torch.float32)):
        _check(t, name, dt, dev, 1)
        if t.shape[0] != N:
            raise ValueError(f"{name}: length {t.shape[0]} != {N}")
    _check(poskeys, "poskeys", torch.int32, dev, 1)
    if max(Ws) > N or max(PWs) > poskeys.shape[0]:
        raise ValueError(f"windows Ws={Ws} / PWs={PWs} exceed their arrays "
                         f"({N} postings, {poskeys.shape[0]} keys)")
    if PWs[0] > MAX_W_MEMBER or Ws[0] > MAX_W_MEMBER:
        raise ValueError("term 0's windows exceed MAX_W_MEMBER")
    if stride < 1:
        raise ValueError(f"stride={stride}")
    if not 1 <= k <= 64:
        raise ValueError(f"k={k} outside [1, 64]")
    L = _phrase_lanes(Ws, k, raw)
    out_docs = torch.empty((B, L), dtype=torch.int32, device=dev)
    out_scores = torch.empty((B, L), dtype=torch.float32, device=dev)
    out_counts = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out_docs, out_scores, out_counts
    # raw mode writes its lanes straight to the output: no scratch
    scr_cols = 0 if raw else Ws[0]
    grid = min(B, _MAX_GRID)
    if scr_cols:
        grid = min(grid, max(1, _PHRASE_SCRATCH_BYTES // (4 * scr_cols)))
    scr = torch.empty((grid, scr_cols), dtype=torch.float32, device=dev)
    prm = _phrase_params(T, Ws, PWs, stride, slop, k, raw, L, scr_cols, B)
    rc = lib.rs_phrase_launch(
        meta.data_ptr(), fmeta.data_ptr(), doc_ids.data_ptr(),
        freqs.data_ptr(), masks.data_ptr(), posting_dl.data_ptr(), N,
        poskeys.data_ptr(), poskeys.shape[0],
        prm.ctypes.data_as(ctypes.c_void_p), out_docs.data_ptr(),
        out_scores.data_ptr(), out_counts.data_ptr(), scr.data_ptr(), grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"phrase kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('phrase', rc)})")
    global PHRASE_LAUNCHES
    PHRASE_LAUNCHES += 1
    return out_docs, out_scores, out_counts


def phrase_batch(meta, fmeta, doc_ids, freqs, masks, posting_dl, poskeys,
                 *, T: int, Ws: tuple, PWs: tuple, stride: int,
                 slop: int = 0, k: int = 16, raw: bool = False,
                 eq_join: bool | None = None):
    """Exact / in-order phrase search over a batch.

    meta: int32 [B, 5T] — per slot posting starts, lens, qmasks, then
    poskey-window starts and lens (flat offsets into `poskeys`).
    fmeta: f32 [B, T+1] — slot tweights then avgdl.  Returns
    (docs [B, L], scores [B, L], counts [B]): with L = k rounded up to
    128, the top-k (score desc, lowest doc on ties) with INT32_MAX /
    NEG_INF filler, plus the hit count.

    raw=True: the masked (doc, score) lanes of term 0's section instead
    (Ws[0] // 128 + R_EXTRA rows of 128 lanes from its start's row);
    callers finish with `iter_topk`.  `eq_join` is accepted for the JAX
    signature and changes nothing: the result is the anchor chain's.

    CPU tensors run `phrase_plain`; CUDA tensors launch the kernel
    (`PHRASE_LAUNCHES` counts each launch) or raise.
    """
    if meta.device.type == "cpu":
        return phrase_plain(meta, fmeta, doc_ids, freqs, masks, posting_dl,
                            poskeys, T=T, Ws=Ws, PWs=PWs, stride=stride,
                            slop=slop, k=k, raw=raw)
    if meta.device.type != "cuda":
        raise RuntimeError(f"no phrase kernel for device {meta.device}")
    return _phrase_launch(meta, fmeta, doc_ids, freqs, masks, posting_dl,
                          poskeys, T=T, Ws=Ws, PWs=PWs, stride=stride,
                          slop=slop, k=k, raw=raw)
