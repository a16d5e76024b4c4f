# Copy of redisearch_tpu/aux/hybrid.py, with run_hybrid_rounds on the port's execute_batch_rounds.
"""FT.HYBRID: combined text + vector retrieval with score fusion.

Reference: src/hybrid/ (HybridRequest, hybrid_request.h:30-60) — two
subqueries (SEARCH and VSIM), drained in parallel and merged by
RPHybridMerger with RRF (1/(rank+c), c=60) or LINEAR (alpha*text +
beta*vector) scoring (hybrid_scoring.h:13-19), followed by a tail pipeline
(APPLY/FILTER/GROUPBY/SORTBY/LIMIT).

Both branches of every query in a batch ride one `execute_batch` per
segment (same-structure branches share an executor call; all groups
launch before any is collected).  Fusion is vectorized numpy over the
[B, w] branch outputs (rank matrices + a [B, w, w] id match for dedup),
and only the surviving rows materialize as dicts.  LINEAR normalizes the
text branch with BM25STD.TANH and the vector branch with 1/(1+dist),
matching the reference's normalized-score requirement.

Ties in the fused score break by ascending doc id — the reference
sorter's docid tiebreak (result_processor.c cmpByScore), consistent with
search_many's merge.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..agg.pipeline import AggregateRequest, _run_steps
from ..query.engine import (Deferred, QueryOptions, execute_batch,
                            execute_batch_rounds)
from ..utils.errors import QuerySyntaxError

RRF_DEFAULT_CONSTANT = 60
DEFAULT_WINDOW = 20

_INF32 = 3.3e38


@dataclasses.dataclass
class HybridQuery:
    """FT.HYBRID <idx> SEARCH <query> VSIM @<field> <vec> [COMBINE ...]"""

    search: str = "*"
    vsim_field: str = ""
    vsim_vector: Any = None
    search_params: Optional[dict] = None
    search_scorer: str = "BM25STD.TANH"
    combine: str = "RRF"                 # RRF | LINEAR
    rrf_constant: float = RRF_DEFAULT_CONSTANT
    window: int = DEFAULT_WINDOW
    alpha: float = 0.5                   # LINEAR text weight
    beta: float = 0.5                    # LINEAR vector weight
    knn_ef_runtime: Optional[int] = None
    limit: int = 10
    yield_score_as: Optional[str] = None


def run_hybrid(index, hq: HybridQuery,
               tail: Optional[AggregateRequest] = None) -> list[dict]:
    """Execute both branches + fusion + optional tail pipeline."""
    return run_hybrid_many(index, [hq], [tail])[0]


def _row_lexsort(primary: np.ndarray, tie: np.ndarray) -> np.ndarray:
    """Per-row order indices: descending `primary`, ascending `tie`.
    One flat np.lexsort for the whole batch (row id as outermost key)."""
    B, K = primary.shape
    rows = np.repeat(np.arange(B, dtype=np.int64), K)
    order = np.lexsort((tie.ravel(), -primary.ravel(), rows))
    return order.reshape(B, K) - (np.arange(B, dtype=np.int64) * K)[:, None]


def _knn_query(hq: HybridQuery) -> str:
    return f"*=>[KNN {hq.window} @{hq.vsim_field} $__hybrid_vec]"


def _run_hybrid_hits(index, hqs: list, tails: Optional[list]):
    """Hit-list fusion (the JAX package's path for indexes that expose
    `search_many` but no segments): both branches share one search_many
    round; fusion merges the two (already merged) per-query Hit lists
    with the same RRF/LINEAR math and gid tiebreak as the vectorized
    path, which the tests hold against it."""
    queries, params, opts = [], [], []
    for hq in hqs:
        vec = np.asarray(hq.vsim_vector, np.float32)
        queries.append(hq.search)
        params.append(hq.search_params)
        opts.append(QueryOptions(scorer=hq.search_scorer, k=hq.window))
        queries.append(_knn_query(hq))
        params.append({"__hybrid_vec": vec})
        opts.append(QueryOptions(k=hq.window))
    k_max = max(hq.window for hq in hqs)
    results = index.search_many(queries, params=params, k=k_max,
                                opts_list=opts)
    out = []
    for i, hq in enumerate(hqs):
        tail = tails[i] if tails else None
        out.append(_fuse(index, hq,
                         results[2 * i].hits[:hq.window],
                         results[2 * i + 1].hits[:hq.window], tail))
    return out


def _fuse(index, hq: HybridQuery, text_hits, knn_hits,
          tail: Optional[AggregateRequest] = None) -> list[dict]:
    fused: dict[int, dict] = {}
    if hq.combine.upper() == "RRF":
        for rank, h in enumerate(text_hits):
            e = fused.setdefault(h.gid, {"__key": h.key, "__gid": h.gid,
                                         "__score": 0.0})
            e["__score"] += 1.0 / (rank + 1 + hq.rrf_constant)
            e["__text_score"] = h.score
        for rank, h in enumerate(knn_hits):
            e = fused.setdefault(h.gid, {"__key": h.key, "__gid": h.gid,
                                         "__score": 0.0})
            e["__score"] += 1.0 / (rank + 1 + hq.rrf_constant)
            e["__vector_distance"] = h.vector_distance
    elif hq.combine.upper() == "LINEAR":
        for h in text_hits:
            e = fused.setdefault(h.gid, {"__key": h.key, "__gid": h.gid,
                                         "__score": 0.0})
            e["__score"] += hq.alpha * h.score  # BM25STD.TANH in [0,1)
            e["__text_score"] = h.score
        for h in knn_hits:
            sim = 1.0 / (1.0 + max(h.vector_distance, 0.0))
            e = fused.setdefault(h.gid, {"__key": h.key, "__gid": h.gid,
                                         "__score": 0.0})
            e["__score"] += hq.beta * sim
            e["__vector_distance"] = h.vector_distance
    else:
        raise QuerySyntaxError(f"bad COMBINE {hq.combine!r}")

    rows = sorted(fused.values(),
                  key=lambda r: (-r["__score"], r["__gid"]))
    for r in rows:
        r["__meta"] = index.doctable.get(r["__gid"])
    if hq.yield_score_as:
        for r in rows:
            r[hq.yield_score_as] = r["__score"]
    if tail is not None and tail.steps:
        tail.add_scores = True
        rows = _run_steps(index, tail, rows)
    else:
        rows = rows[:hq.limit]
        for r in rows:
            r.pop("__meta", None)
            r.pop("__gid", None)
    return rows


def _branch_top(scores: np.ndarray, gids: np.ndarray, valid: np.ndarray,
                w: int):
    """Merge per-segment branch outputs into rank order: higher score
    first, doc id tiebreak, invalid rows last.  Returns ([B, w] gid,
    [B, w] score, [B, w] valid) in rank order."""
    s = np.where(valid, scores, -np.inf)
    g = np.where(valid, gids, np.int64(2**62))
    idx = _row_lexsort(s, g)[:, :w]
    tk = np.take_along_axis
    return (tk(gids, idx, 1), tk(scores, idx, 1), tk(valid, idx, 1))


def _require_vsim(hqs: list) -> None:
    for hq in hqs:
        if not hq.vsim_field:
            raise QuerySyntaxError("FT.HYBRID requires a VSIM field")


def _branch_queries(index, hqs: list) -> list:
    """The compiled SEARCH and VSIM branches of each query, interleaved
    (2i: text, 2i+1: KNN)."""
    _require_vsim(hqs)
    cqs = []
    for hq in hqs:
        vec = np.asarray(hq.vsim_vector, np.float32)
        cqs.append(index.prepare(
            hq.search, hq.search_params,
            QueryOptions(scorer=hq.search_scorer, k=hq.window), 2))
        cqs.append(index.prepare(_knn_query(hq), {"__hybrid_vec": vec},
                                 QueryOptions(k=hq.window), 2))
    return cqs


def run_hybrid_many(index, hqs: list, tails: Optional[list] = None,
                    async_: bool = False):
    """Batched FT.HYBRID: every query's SEARCH and VSIM branches ride
    ONE execute_batch per segment, fusion runs vectorized over the
    [B, w] branch outputs, and only the surviving rows materialize as
    dicts.  With async_=True returns a handle whose result() fuses.
    An index without segments (a `parallel.dist.ShardedIndex`) exposes
    `search_many` instead: both branches come back as merged Hit lists
    and fuse per query (`_run_hybrid_hits`; the distributed coordinator
    path, reference coord/hybrid/dist_hybrid.c)."""
    if not hasattr(index, "segments"):
        _require_vsim(hqs)
        res = _run_hybrid_hits(index, hqs, tails)
        return Deferred(lambda: res) if async_ else res
    index.commit()
    w_max = max(hq.window for hq in hqs)
    cqs = _branch_queries(index, hqs)
    handles = [execute_batch(cqs, seg, w_max, async_=True)
               for seg in index.segments]

    def fin():
        return _hybrid_finish(index, hqs, tails,
                              [h.result() for h in handles], w_max)

    return Deferred(fin) if async_ else fin()


def run_hybrid_rounds(index, rounds: list, tails_rounds=None,
                      async_: bool = False):
    """R rounds of batched FT.HYBRID: both branches of every query of
    every round through `execute_batch_rounds` per segment (all rounds
    launch before any is collected), then each round fuses as
    `run_hybrid_many` fuses it.  Returns per-round row lists (async_: a
    handle whose result() does)."""
    index.commit()
    w_max = max((hq.window for hqs in rounds for hq in hqs), default=1)
    cqs_rounds = [_branch_queries(index, hqs) for hqs in rounds]
    seg_handles = [execute_batch_rounds(cqs_rounds, seg, w_max, async_=True)
                   for seg in index.segments]

    def fin():
        per_seg = [h.result() for h in seg_handles]
        return [_hybrid_finish(index, hqs,
                               tails_rounds[r] if tails_rounds else None,
                               [ps[r] for ps in per_seg], w_max)
                for r, hqs in enumerate(rounds)]

    return Deferred(fin) if async_ else fin()


def _hybrid_finish(index, hqs, tails, seg_results, w_max):
    """Fuse a batch: `seg_results` holds each segment's SegmentResults
    (2i: query i's text branch, 2i+1: its KNN branch)."""
    B = len(hqs)
    # branch outputs stacked across segments: [B, nseg * k_pad]
    t_sc, t_g, t_ok = [], [], []
    k_sc, k_g, k_ok = [], [], []
    for seg, results in zip(index.segments, seg_results):
        gids = np.asarray(seg.gids_host, np.int64)
        ts = np.stack([np.asarray(results[2 * i].scores) for i in
                       range(B)])
        ti = np.stack([np.asarray(results[2 * i].local_idx) for i in
                       range(B)]).astype(np.int64)
        ks = np.stack([np.asarray(results[2 * i + 1].knn_dists)
                       for i in range(B)])
        ki = np.stack([np.asarray(results[2 * i + 1].local_idx) for i in
                       range(B)]).astype(np.int64)
        t_sc.append(ts)
        t_ok.append(ts > -_INF32)
        t_g.append(gids[np.clip(ti, 0, len(gids) - 1)])
        k_sc.append(ks)
        k_ok.append(ks < _INF32)
        k_g.append(gids[np.clip(ki, 0, len(gids) - 1)])
    t_sc, t_g, t_ok = (np.concatenate(a, 1) for a in (t_sc, t_g, t_ok))
    k_sc, k_g, k_ok = (np.concatenate(a, 1) for a in (k_sc, k_g, k_ok))

    # per-branch rank order (text: score desc; knn: distance asc)
    tg, tsc, tva = _branch_top(t_sc, t_g, t_ok, w_max)
    kg, kds, kva = _branch_top(-k_sc, k_g, k_ok, w_max)
    kds = -kds
    # per-query window mask (w_i <= w_max)
    wins = np.fromiter((hq.window for hq in hqs), np.int64, B)[:, None]
    pos = np.arange(w_max, dtype=np.int64)[None, :]
    tva = tva & (pos < wins)
    kva = kva & (pos < wins)

    rrf_c = np.fromiter((hq.rrf_constant for hq in hqs), np.float64,
                        B)[:, None]
    alpha = np.fromiter((hq.alpha for hq in hqs), np.float64, B)[:, None]
    beta = np.fromiter((hq.beta for hq in hqs), np.float64, B)[:, None]
    is_rrf = np.fromiter(
        (hq.combine.upper() == "RRF" for hq in hqs), bool, B)
    for hq in hqs:
        if hq.combine.upper() not in ("RRF", "LINEAR"):
            raise QuerySyntaxError(f"bad COMBINE {hq.combine!r}")

    rrf = 1.0 / (pos + 1.0 + rrf_c)
    sim = 1.0 / (1.0 + np.maximum(kds, 0.0))
    t_contrib = np.where(is_rrf[:, None], rrf,
                         alpha * tsc.astype(np.float64))
    k_contrib = np.where(is_rrf[:, None], rrf, beta * sim)
    t_contrib = np.where(tva, t_contrib, 0.0)
    k_contrib = np.where(kva, k_contrib, 0.0)

    # dedup: id match between the two rank lists ([B, w, w])
    eq = ((tg[:, :, None] == kg[:, None, :])
          & tva[:, :, None] & kva[:, None, :])
    t_total = t_contrib + np.einsum("bij,bj->bi", eq, k_contrib)
    t_match = eq.any(2)
    # vector distance attribution for text-side rows that also matched
    vd_t = np.einsum("bij,bj->bi", eq, kds.astype(np.float64))
    k_dup = eq.any(1)

    ids = np.concatenate([tg, kg], 1)                     # [B, 2w]
    fused = np.concatenate([t_total, np.where(k_dup, -np.inf,
                                              k_contrib)], 1)
    valid = np.concatenate([tva, kva & ~k_dup], 1)
    fused = np.where(valid, fused, -np.inf)
    has_t = np.concatenate([tva, np.zeros_like(kva)], 1)
    has_v = np.concatenate([t_match, kva], 1)
    tsc_c = np.concatenate([tsc, np.zeros_like(kds)], 1)
    vd_c = np.concatenate([vd_t, kds], 1)

    order = _row_lexsort(fused, np.where(valid, ids, np.int64(2**62)))
    tk = np.take_along_axis
    ids = tk(ids, order, 1)
    fused = tk(fused, order, 1)
    valid = tk(valid, order, 1)
    has_t, has_v = tk(has_t, order, 1), tk(has_v, order, 1)
    tsc_c, vd_c = tk(tsc_c, order, 1), tk(vd_c, order, 1)

    out = []
    doct = index.doctable
    for i, hq in enumerate(hqs):
        tail = tails[i] if tails else None
        with_tail = tail is not None and tail.steps
        n = int(valid[i].sum())
        if not with_tail:
            n = min(n, hq.limit)
        rows = []
        for j in range(n):
            gid = int(ids[i, j])
            row = {"__key": None, "__gid": gid,
                   "__score": float(fused[i, j])}
            if has_t[i, j]:
                row["__text_score"] = float(tsc_c[i, j])
            if has_v[i, j]:
                row["__vector_distance"] = float(vd_c[i, j])
            meta = doct.get(gid)
            if meta is None or meta.deleted:
                continue
            row["__key"] = meta.key
            row["__meta"] = meta
            if hq.yield_score_as:
                row[hq.yield_score_as] = row["__score"]
            rows.append(row)
        if with_tail:
            tail.add_scores = True
            rows = _run_steps(index, tail, rows)
        else:
            rows = rows[:hq.limit]
            for r in rows:
                r.pop("__meta", None)
                r.pop("__gid", None)
        out.append(rows)
    return out
