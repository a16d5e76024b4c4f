"""The port's bench: bench.py's four sections on one CUDA card, one JSON
scoreboard.

    python3 -m redisearch_tpu_torch.bench.run [--section text|fknn|knn|ann]...
        [--reps N] [--text-batch B] [--text-iters N]
    BENCH_SMOKE=1 python3 -m redisearch_tpu_torch.bench.run   # tiny shapes

Sections, in bench.py's order (`SECTIONS`), all four by default, run one
after another in this process:
* text: bench.py's 1M-doc FTSB enwiki-abstract corpus (`bench_bm25`),
  built once for the section: the build rate, the eight FT.SEARCH
  families at batch 8,192 and k 10 through `execute_batch` (warmed,
  then bench.py's pipelined loop at depth 2), `kernel_hit_pct` from
  `QUERY_PATH_STATS`; FT.AGGREGATE (`bench_agg`) at batch 4,096 (under
  bench.py's key) and 1,024; the match-all GROUPBY (`bench_agg_star`)
  at batch 64.
* fknn: the 500k x 384 arxiv-shaped corpus, filtered KNN 25
  (`bench_filtered_knn`) through `execute_batch_rounds` at batch 512
  (bench.py's) and 2,048, then FT.HYBRID RRF and LINEAR at batch 1,024
  (`bench_hybrid`).
* knn: 1M x 128 f32, L2, k 10, 48 chunks of 2,048 queries through
  `ops/vector.py` `knn_scan_batches` with the bf16 scan copy
  (`bench_knn`).
* ann: 1M x 100 clustered COSINE, the FLAT scan and IVF (nlist 1,024)
  at nprobe 8 / 32 / 128 (`bench_ann`).

Every number is measured `--reps` times (default 3): its value is the
median, `extra.spread` holds its median, min, max and count.  No number
is recorded before its parity check passed (`extra.parity`): served
FT.SEARCH, FT.AGGREGATE and FT.HYBRID results equal their plain
recomputation on a sample of the timed batch (the kernels swapped for
their plain torch versions; FT.HYBRID against the hit-list fusion);
filtered KNN hits pass their filter, distances are within 1e-5 of
float64 and recall@25 is at least 0.99; FLAT recall@10 is at least 0.99
against float64 distances computed on the card, with every distance
within 1e-5 (relative) of its float64 value; IVF recall@10 is at least
0.95 at nprobe 128.

The last line of stdout is one JSON object with bench.py's `_assemble`
keys (`assemble`), so each number stands beside `BENCH_r0*.json`'s key
for key.  `extra` adds `device` (the card, nvidia-smi's name and power
limit), `spread`, `parity` (both keyed by bench.py's progress keys),
`batch`, `routes`, `section_s`, `switches` (the route switches set) and
`reps`, and the keys of the second batches (`agg_groupby_qps_b1024`,
`filtered_knn_qps_b2048`).  A section that raises is recorded as
`<section>_error` and the run exits 1 after the scoreboard.  Progress
lines go to stderr.

It runs on `cuda:0` and raises where there is no card; `run(...,
device="cpu")` runs the same code on the CPU at the caller's `Shapes`
(the tests' way), and times nothing that a card's number could be
mistaken for: `extra.device` says "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time
import traceback
import types

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as AP
from redisearch_tpu_torch.aux import hybrid as H
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.bench.probes import card_line, resolve_device
from redisearch_tpu_torch.index.segment import bf16_scan_copy
from redisearch_tpu_torch.ops import ivf as IVF
from redisearch_tpu_torch.ops import vector as V
from redisearch_tpu_torch.query import engine as E

# bench.py's documented CPU-host estimates of the reference (bench.py:45-67)
BM25_BASELINE_QPS = 10_000.0
KNN_BASELINE_QPS = 195.0
AGG_BASELINE_QPS = 1_000.0
AGG_STAR_BASELINE_QPS = 20.0
FKNN_BASELINE_QPS = 4_000.0
HYBRID_BASELINE_QPS = 2_000.0

#: bench.py's section order
SECTIONS = ("text", "fknn", "knn", "ann")
#: route switches the engine reads (they are reported, never set here)
SWITCHES = ("RS_TPU_NO_INTERSECT_KERNEL", "RS_TPU_NO_DENSE_KNN",
            "RS_TPU_NO_BF16_SCAN")
#: queries (requests) of a timed batch held against their plain
#: recomputation, spread evenly over the batch
PARITY_SAMPLE = 256
AGG_SAMPLE = 64
HYBRID_SAMPLE = 64
#: the gates of PERF.md §2
FLAT_RECALL, IVF_RECALL, FKNN_RECALL = 0.99, 0.95, 0.99
DIST_RTOL = 1e-5
KNN_D, KNN_K = 128, 10


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Sizes of each section: bench.py's `_child` arguments.  The first
    of `agg_batches` and `fknn_batches` goes under bench.py's keys."""
    n_docs: int = 1_000_000
    text_batch: int = 8192
    text_iters: int = 8
    agg_batches: tuple = (4096, 1024)
    agg_iters: int = 6
    star_batch: int = 64
    star_iters: int = 4
    fknn_n: int = 500_000
    fknn_batches: tuple = (512, 2048)
    fknn_iters: int = 6
    hybrid_batch: int = 1024
    hybrid_iters: int = 4
    knn_n: int = 1_000_000
    knn_batch: int = 2048
    knn_iters: int = 48
    ann_n: int = 1_000_000
    ann_nlist: int = W.ANN_NLIST
    ann_queries: int = W.ANN_Q


#: bench.py's BENCH_SMOKE shapes (bench.py:73-78 and `_child`)
SMOKE = Shapes(n_docs=20_000, text_batch=512, text_iters=2,
               agg_batches=(64,), star_batch=8, fknn_n=20_000,
               fknn_batches=(64,), fknn_iters=2, hybrid_batch=64,
               hybrid_iters=2, knn_n=100_000, knn_batch=256, knn_iters=4,
               ann_n=100_000)


def log(*a):
    print("bench:", *a, file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spread(samples) -> dict:
    return {"median": statistics.median(samples), "min": min(samples),
            "max": max(samples), "n": len(samples)}


def sample_rows(n: int, want: int) -> list:
    """About `want` indices spread evenly over range(n)."""
    return list(range(0, n, max(1, n // want)))


class Board:
    """What the sections record: bench.py's progress keys with their
    medians (`progress`), and beside each its spread, parity result and
    batch; the routes each family rode; each section's wall seconds."""

    def __init__(self):
        self.progress, self.spread, self.parity = {}, {}, {}
        self.batch, self.routes, self.section_s = {}, {}, {}

    def emit(self, key, samples, parity, batch=None):
        """Record a measured number: called only after its parity check
        passed."""
        s = spread(samples)
        self.progress[key] = s["median"]
        self.spread[key] = s
        self.parity[key] = parity
        if batch is not None:
            self.batch[key] = batch


class uncounted:
    """Within the block the engine's and the pipeline's path counts are
    left as they were (the parity recomputations do not count)."""

    def __enter__(self):
        self.saved = (dict(E.QUERY_PATH_STATS), dict(AP.AGG_PATH_STATS))

    def __exit__(self, *exc):
        for live, saved in zip((E.QUERY_PATH_STATS, AP.AGG_PATH_STATS),
                               self.saved):
            live.clear()
            live.update(saved)


def pipelined(submit, make, n: int, dev):
    """bench.py's serving loop at depth 2: submit batch `it`, build batch
    it + 1 while the card runs it, collect two behind.  Returns (seconds,
    the results of batch 0)."""
    t0 = time.perf_counter()
    pending, first = [], []
    nxt = make(0)
    for it in range(n):
        pending.append(submit(nxt))
        if it + 1 < n:
            nxt = make(it + 1)
        if len(pending) > 2:
            r = pending.pop(0).result()
            first = first or [r]
    for h in pending:
        r = h.result()
        first = first or [r]
    sync(dev)
    return time.perf_counter() - t0, first[0]


def timed_reps(run, reps: int) -> tuple:
    """run() -> (seconds, queries, results) `reps` times: (the QPS of
    each, the last results)."""
    qps, res = [], None
    for _ in range(reps):
        dt, n, res = run()
        qps.append(n / dt)
    return qps, res


def knn_hits(ix, seg, r, k: int):
    """A KNN SegmentResult as `search_many` makes its hits: the first k
    live lanes, each with its doc's key, distance and gid, ordered by
    (distance, gid)."""
    hits = []
    for d, x in zip(r.local_idx, r.knn_dists):
        if len(hits) >= k:
            break
        if x < 3.3e38:
            gid = int(seg.gids_host[int(d)])
            hits.append(types.SimpleNamespace(
                key=ix.doctable.get(gid).key, vector_distance=float(x),
                gid=gid))
    return types.SimpleNamespace(hits=sorted(
        hits, key=lambda h: (h.vector_distance, h.gid)))


def route_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


# ------------------------------------------------------------------ text
def bench_bm25(board, ix, qt, B, iters, reps, dev):
    """bench.py's bench_bm25 on the built index: per family, `ci` warm
    batches, then the pipelined loop over `ci` batches, `reps` times;
    batch 0 of the last pass held against plain on PARITY_SAMPLE
    queries."""
    seg = ix.segments[0]
    opts = E.QueryOptions(k=W.K)
    E.QUERY_PATH_STATS.clear()
    for name, qfn in W.FAMILIES.items():
        ci = iters if name in W.HEADLINE else max(iters // 2, 2)

        def make(it, qfn=qfn):
            return [ix.prepare(qfn(qt, i, it), None, opts, 2)
                    for i in range(B)]
        before = dict(E.QUERY_PATH_STATS)
        for it in range(ci):
            E.execute_batch(make(it), seg, W.K)

        def one():
            dt, res = pipelined(
                lambda cqs: E.execute_batch(cqs, seg, W.K, async_=True),
                make, ci, dev)
            return dt, ci * B, res
        qps, served = timed_reps(one, reps)
        board.routes["bm25__" + name] = route_delta(before,
                                                     E.QUERY_PATH_STATS)
        rows = sample_rows(B, PARITY_SAMPLE)
        qs = [qfn(qt, i, 0) for i in rows]
        with uncounted():
            plain, _ = W.plain_results(ix, seg, qs)
        err = W.check_against_plain([served[i] for i in rows], plain,
                                    "bm25 " + name)
        board.emit("bm25__" + name, qps, {
            "checked": len(rows), "of": B, "max_abs_score_err": err,
            "against": "plain versions"}, B)
        log(f"bm25 {name}: {spread(qps)} qps, routes "
            f"{board.routes['bm25__' + name]}")
    stats = dict(E.QUERY_PATH_STATS)
    hit = sum(stats.get(r, 0) for r in ("kernel", "kernel-wide",
                                        "phrase-kernel"))
    board.progress["kernel_hit_pct"] = round(
        100.0 * hit / max(sum(stats.values()), 1), 1)
    board.routes["kernel_hit_pct"] = stats
    board.parity["kernel_hit_pct"] = {
        "counted": "every family's warm and timed batches",
        "kernel_routes": ["kernel", "kernel-wide", "phrase-kernel"]}


def agg_parity(ix, reqs, served, n_sample) -> dict:
    rows = sample_rows(len(reqs), n_sample)
    with uncounted(), W.plain_versions():
        plain = AP.run_aggregate_many(ix, [reqs[i] for i in rows])
    for i, p in zip(rows, plain):
        k = served[i]
        if k.total != p.total or k.rows != p.rows:
            raise AssertionError(f"aggregate {reqs[i].query!r}: served "
                                 f"{k.total} {k.rows} vs plain {p.total} "
                                 f"{p.rows}")
    return {"checked": len(rows), "of": len(reqs),
            "against": "plain versions", "equal": "rows and totals"}


def bench_agg(board, key, ix, B, iters, reps, dev):
    """bench.py's bench_agg: two warm batches, then `max(iters // 2, 2)`
    rounds of B requests in the pipelined loop."""
    mk = W.agg_request_fn()[0]
    for w in range(2):
        AP.run_aggregate_many(ix, [mk(w * B + i) for i in range(B)])
    rounds = max(iters // 2, 2)

    def make(r):
        return [mk(r * B + i) for i in range(B)]
    before = dict(AP.AGG_PATH_STATS)

    def one():
        dt, res = pipelined(
            lambda reqs: AP.run_aggregate_many(ix, reqs, async_=True),
            make, rounds, dev)
        return dt, rounds * B, res
    qps, served = timed_reps(one, reps)
    board.routes[key] = route_delta(before, AP.AGG_PATH_STATS)
    board.emit(key, qps, agg_parity(ix, make(0), served, AGG_SAMPLE), B)
    log(f"{key} (batch {B}): {spread(qps)} qps, paths {board.routes[key]}")


def bench_agg_star(board, ix, B, iters, reps, dev):
    """bench.py's bench_agg_star: one warm batch, then `max(iters // 2,
    2)` rounds of B match-all requests, the TTL clock varied per
    request."""
    base_now = int(time.time())

    def make(r):
        return [W.star_request(base_now + r * B + i) for i in range(B)]
    AP.run_aggregate_many(ix, make(0))
    rounds = max(iters // 2, 2)
    before = dict(AP.AGG_PATH_STATS)

    def one():
        dt, res = pipelined(
            lambda reqs: AP.run_aggregate_many(ix, reqs, async_=True),
            make, rounds, dev)
        return dt, rounds * B, res
    qps, served = timed_reps(one, reps)
    board.routes["agg_star_qps"] = route_delta(before, AP.AGG_PATH_STATS)
    board.emit("agg_star_qps", qps, agg_parity(ix, make(0), served, B), B)
    log(f"agg_star (batch {B}): {spread(qps)} qps")


def section_text(board, shapes, reps, dev):
    t0 = time.perf_counter()
    docs, qt, _toks = W.make_corpus(shapes.n_docs)
    log(f"text: corpus of {shapes.n_docs} docs in "
        f"{time.perf_counter() - t0:.1f}s")
    ix = rt.SearchIndex(rt.Schema(name="bm25", fields=W.bm25_fields()),
                        device=dev)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    sync(dev)
    build_s = time.perf_counter() - t0
    del docs
    log(f"text: build {build_s:.1f}s")
    bench_bm25(board, ix, qt, shapes.text_batch, shapes.text_iters, reps,
               dev)
    # recorded once the index it built served every family's sample
    # equal to plain
    board.progress["bm25_build_docs_per_s"] = round(
        shapes.n_docs / build_s, 0)
    board.spread["bm25_build_docs_per_s"] = spread(
        [shapes.n_docs / build_s])
    board.parity["bm25_build_docs_per_s"] = {
        "checked": "the index served every FT.SEARCH family's sample "
                   "equal to plain"}
    for i, B in enumerate(shapes.agg_batches):
        key = "agg_groupby_qps" if i == 0 else f"agg_groupby_qps_b{B}"
        bench_agg(board, key, ix, B, shapes.agg_iters, reps, dev)
    bench_agg_star(board, ix, shapes.star_batch, shapes.star_iters, reps,
                   dev)


# ------------------------------------------------------------------ fknn
FKNN_FAMILIES = ("fulltext", "numeric", "tag")


def bench_filtered_knn(board, ctx, B, rounds, reps, dev, suffix=""):
    """bench.py's bench_filtered_knn at batch B: per family two warm
    batches and one call of `rounds` rounds, then 4 dispatches of
    `rounds` rounds in the pipelined loop; round 0 of the last pass
    checked on PARITY_SAMPLE queries (`check_fknn`)."""
    ix, vecs_dev, tidx, qvecs = ctx
    seg = ix.segments[0]
    year = 1990 + np.arange(len(tidx)) % 35
    cat = np.arange(len(tidx)) % 20
    fams = W.fknn_families()
    opts = E.QueryOptions(k=W.FKNN_K)
    dispatches = 4
    for name in FKNN_FAMILIES:
        qfn, _route, ffn = fams[name]

        def make_round(it, qfn=qfn):
            return [ix.prepare(qfn(it * B + i),
                               {"b": qvecs[(it * B + i) % 512]}, opts, 2)
                    for i in range(B)]

        def make(rep):
            return [make_round(rep * rounds + it) for it in range(rounds)]
        before = dict(E.QUERY_PATH_STATS)
        for it in range(2):
            E.execute_batch(make_round(it), seg, W.FKNN_K)
        E.execute_batch_rounds(make(0), seg, W.FKNN_K)

        def one():
            dt, res = pipelined(
                lambda rr: E.execute_batch_rounds(rr, seg, W.FKNN_K,
                                                  async_=True),
                make, dispatches, dev)
            return dt, dispatches * rounds * B, res
        qps, served = timed_reps(one, reps)
        key = "fknn__" + name + suffix
        board.routes[key] = route_delta(before, E.QUERY_PATH_STATS)
        rows = sample_rows(B, PARITY_SAMPLE)
        res = {i: knn_hits(ix, seg, served[0][i], W.FKNN_K) for i in rows}
        qs = [qfn(i) for i in range(B)]
        rec = W.check_fknn(res, qs, qvecs, vecs_dev,
                           lambda r: ffn(r, tidx, year, cat),
                           f"fknn {name}", rows=rows)
        if rec < FKNN_RECALL:
            raise AssertionError(f"fknn {name}: recall@25 {rec}")
        board.emit(key, qps, {
            "checked": len(rows), "of": B, "recall_at_25": rec,
            "dist_atol": 1e-5, "against": "float64 on the device"}, B)
        log(f"fknn {name} (batch {B}): {spread(qps)} qps, recall@25 "
            f"{rec:.4f}, routes {board.routes[key]}")


def bench_hybrid(board, ix, B, iters, reps, dev):
    """bench.py's bench_hybrid: per combine a warm batch and a warm call
    of `iters` rounds, then 4 dispatches of `iters` rounds in the
    pipelined loop; round 0 of the last pass checked against the
    hit-list fusion on HYBRID_SAMPLE queries."""
    dispatches = 4
    for name, cmb in (("rrf", "RRF"), ("linear", "LINEAR")):
        def make(rep, cmb=cmb):
            return [W.hybrid_queries(rep * iters + it, cmb, B)
                    for it in range(iters)]
        before = dict(E.QUERY_PATH_STATS)
        H.run_hybrid_many(ix, W.hybrid_queries(0, cmb, B))
        H.run_hybrid_rounds(ix, make(0))

        def one():
            dt, res = pipelined(
                lambda rr: H.run_hybrid_rounds(ix, rr, async_=True),
                make, dispatches, dev)
            return dt, dispatches * iters * B, res
        qps, served = timed_reps(one, reps)
        key = "hybrid__" + name
        board.routes[key] = route_delta(before, E.QUERY_PATH_STATS)
        hqs = W.hybrid_queries(0, cmb, B)
        rows = sample_rows(B, HYBRID_SAMPLE)
        with uncounted():
            slow = H._run_hybrid_hits(ix, [hqs[i] for i in rows], None)
        for i, b in zip(rows, slow):
            W.same_fusion(served[0][i], b, f"hybrid {name} query {i}")
        board.emit(key, qps, {"checked": len(rows), "of": B,
                              "against": "hit-list fusion",
                              "float_atol": 1e-6}, B)
        log(f"hybrid {name} (batch {B}): {spread(qps)} qps")


def section_fknn(board, shapes, reps, dev):
    t0 = time.perf_counter()
    docs, vecs, tidx, qvecs = W.fknn_corpus(shapes.fknn_n, W.FKNN_D)
    ix = rt.SearchIndex(rt.Schema(name="arxivb",
                                  fields=W.fknn_fields(W.FKNN_D)),
                        device=dev)
    ix.add_documents(docs)
    sync(dev)
    del docs
    log(f"fknn: corpus and build {time.perf_counter() - t0:.1f}s")
    ctx = (ix, torch.from_numpy(vecs).to(dev).double(), tidx, qvecs)
    del vecs
    B0 = shapes.fknn_batches[0]
    for B in shapes.fknn_batches:
        # the same queries a pass at every batch: bench.py's rounds at
        # its own batch
        rounds = max(1, shapes.fknn_iters * B0 // B)
        bench_filtered_knn(board, ctx, B, rounds, reps, dev,
                           "" if B == B0 else f"_b{B}")
    del ctx
    bench_hybrid(board, ix, shapes.hybrid_batch, shapes.hybrid_iters,
                 reps, dev)


# ------------------------------------------------------------------- knn
def section_knn(board, shapes, reps, dev):
    """bench.py's bench_knn: its data (numpy seed 0), the exact-argmin
    spot check on a 10,000-row slab, a warm call on two chunks, then
    `reps` timed calls over every chunk; the FLAT gate on the last."""
    n, B, iters = shapes.knn_n, shapes.knn_batch, shapes.knn_iters
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(n, KNN_D)).astype(np.float32)
    queries = rng.normal(size=(iters, B, KNN_D)).astype(np.float32)
    vd = torch.from_numpy(vecs).to(dev)
    sq = (vd.double() ** 2).sum(1).float()
    scan = bf16_scan_copy(vd)
    present = torch.ones(n, dtype=torch.bool, device=dev)
    slab = min(10_000, n)
    ref = int(np.argmin(((vecs[:slab] - queries[0, 0][None, :]) ** 2)
                        .sum(1)))
    del vecs
    got = int(V.knn_batch(vd[:slab], sq[:slab], present[:slab],
                          torch.from_numpy(queries[0, :1]).to(dev), 1,
                          "L2")[1][0, 0])
    if got != ref:
        raise AssertionError(f"knn: exact argmin {got} != {ref}")
    dq = torch.from_numpy(queries).to(dev)
    del queries
    V.knn_scan_batches(vd, sq, present, dq[:2], KNN_K, "L2",
                       scan_vecs=scan)
    sync(dev)

    def one():
        t0 = time.perf_counter()
        d, i = V.knn_scan_batches(vd, sq, present, dq, KNN_K, "L2",
                                  scan_vecs=scan)
        i = i.cpu()
        return time.perf_counter() - t0, iters * B, (d, i)
    qps, (dists, idx) = timed_reps(one, reps)
    # the FLAT gate: recall@10 of chunk 0's first 256 queries against a
    # float64 top-10 on the card, every distance of every chunk within
    # DIST_RTOL of its float64 value
    v64 = vd.double()
    q64 = dq[0, :256].double()
    d64 = ((v64 * v64).sum(1)[None, :] - 2.0 * (q64 @ v64.t())
           + (q64 * q64).sum(1)[:, None])
    truth = torch.topk(d64, KNN_K, dim=1, largest=False).indices.cpu()
    del d64
    nq = truth.shape[0]
    recall = float((idx[0, :nq, :, None] == truth[:, None, :]).any(-1)
                   .double().mean())
    rel = 0.0
    for c in range(iters):
        ic = idx[c].to(dev).long()
        g64 = ((v64[ic] - dq[c][:, None, :].double()) ** 2).sum(-1)
        rel = max(rel, float(((dists[c].double() - g64).abs()
                              / g64.abs().clamp(min=1e-30)).max()))
    del v64
    if recall < FLAT_RECALL or not rel <= DIST_RTOL:
        raise AssertionError(f"knn: recall@10 {recall}, max relative "
                             f"distance error {rel}")
    board.emit("flat_knn_qps", qps, {
        "argmin_slab": slab, "recall_at_10": recall, "checked": nq,
        "max_rel_dist_err": rel, "dists_checked": iters * B * KNN_K,
        "against": "float64 on the device"}, B)
    board.progress["flat_knn_recall"] = round(recall, 4)
    board.parity["flat_knn_recall"] = board.parity["flat_knn_qps"]
    log(f"knn: {spread(qps)} qps, recall@10 {recall:.4f}, max rel err "
        f"{rel:.3e}")


# ------------------------------------------------------------------- ann
def section_ann(board, shapes, reps, dev):
    """bench.py's bench_ann: the FLAT scan and IVF at nprobe 8 / 32 /
    128, each warmed on rep 0 (whose ids give its recall@10 against a
    float64 top-10 on the card), then timed over reps 1..3, `reps`
    times."""
    vecs, Qs = W.ann_corpus(shapes.ann_n, shapes.ann_queries)
    n, nq = shapes.ann_n, shapes.ann_queries
    vd = torch.from_numpy(vecs).to(dev)
    sq = (vd.double() ** 2).sum(1).float()
    present = torch.ones(n, dtype=torch.bool, device=dev)
    Qd = torch.from_numpy(Qs).to(dev)
    truth = W.ann_truth(vd, Qs[0])
    t0 = time.perf_counter()
    ivf = IVF.IVFIndex.build(vecs, np.ones(n, bool), "COSINE",
                             nlist=shapes.ann_nlist, device=dev)
    sync(dev)
    log(f"ann: IVF build (nlist {shapes.ann_nlist}) "
        f"{time.perf_counter() - t0:.1f}s")
    del vecs
    ops = [("flat", lambda r: V.knn_scan_batches(
        vd, sq, present, Qd[r:r + 1], W.ANN_K, "COSINE")[1][0])]
    for nprobe in W.ANN_NPROBES:
        ops.append((f"ivf{nprobe}", lambda r, p=nprobe: IVF.ivf_probe_batch(
            ivf, Qd[r], W.ANN_K, p)[1]))
    points, recalls = [], {}
    for op, fn in ops:
        recalls[op] = W.recall_of(fn(0).cpu(), truth)

        def one(fn=fn):
            t0 = time.perf_counter()
            outs = [fn(r) for r in range(1, W.ANN_REPS)]
            for o in outs:
                o.cpu()
            return time.perf_counter() - t0, (W.ANN_REPS - 1) * nq, None
        qps, _ = timed_reps(one, reps)
        board.spread["ann__" + op] = spread(qps)
        points.append({"op": op, "recall": round(recalls[op], 4),
                       "qps": round(spread(qps)["median"], 1)})
        log(f"ann {op}: recall@10 {recalls[op]:.4f}, {spread(qps)} qps")
    if recalls["flat"] < FLAT_RECALL or recalls["ivf128"] < IVF_RECALL:
        raise AssertionError(f"ann: recall@10 {recalls}")
    parity = {"recall_at_10": recalls, "checked": nq,
              "against": "float64 on the device",
              "gates": {"flat": FLAT_RECALL, "ivf128": IVF_RECALL}}
    board.progress["ann_sweep"] = points
    board.parity["ann_sweep"] = parity
    ok = [pt for pt in points if pt["recall"] >= 0.95]
    best = max(ok, key=lambda pt: pt["qps"]) if ok else None
    board.progress["ann_qps_at_r95"] = best["qps"] if best else 0.0
    if best:
        board.spread["ann_qps_at_r95"] = board.spread["ann__" + best["op"]]
    board.parity["ann_qps_at_r95"] = parity
    board.batch["ann_sweep"] = nq


SECTION_FNS = {"text": section_text, "fknn": section_fknn,
               "knn": section_knn, "ann": section_ann}


# -------------------------------------------------------------- assemble
def assemble(p, section_rc, added=None) -> dict:
    """bench.py's `_assemble` (bench.py:738-805) as a function that
    returns the scoreboard: the same keys from the same progress dict,
    plus the entries in `added` under `extra`."""
    extra = {}

    def put(dst, src):
        if src in p:
            extra[dst] = p[src]
        elif src + "_error" in p:
            extra[dst + "_error"] = p[src + "_error"]

    put("bm25_phrase_qps", "bm25__phrase")
    put("bm25_and2_tag_qps", "bm25__and2_tag")
    extra["bm25_mix_qps"] = {k: p["bm25__" + k] for k in
                             ("and3", "or2", "not2", "opt2", "fields2")
                             if "bm25__" + k in p}
    put("bm25_build_docs_per_s", "bm25_build_docs_per_s")
    put("kernel_hit_pct", "kernel_hit_pct")
    if "agg_groupby_qps" in p:
        extra["agg_groupby_qps"] = p["agg_groupby_qps"]
        extra["agg_vs_baseline"] = round(
            p["agg_groupby_qps"] / AGG_BASELINE_QPS, 2)
    elif "agg_error" in p:
        extra["agg_error"] = p["agg_error"]
    if "agg_star_qps" in p:
        extra["agg_star_qps"] = p["agg_star_qps"]
        extra["agg_star_vs_baseline"] = round(
            p["agg_star_qps"] / AGG_STAR_BASELINE_QPS, 2)
    elif "agg_star_error" in p:
        extra["agg_star_error"] = p["agg_star_error"]
    if "flat_knn_qps" in p:
        extra["flat_knn_qps"] = p["flat_knn_qps"]
        extra["flat_knn_vs_baseline"] = round(
            p["flat_knn_qps"] / KNN_BASELINE_QPS, 2)
        if "flat_knn_recall" in p:
            extra["flat_knn_recall"] = p["flat_knn_recall"]
    elif "knn_error" in p:
        extra["knn_error"] = p["knn_error"]
    fk = {k: p["fknn__" + k] for k in ("fulltext", "numeric", "tag")
          if "fknn__" + k in p}
    if fk:
        extra["filtered_knn_qps"] = fk
        extra["filtered_knn_vs_baseline"] = {
            k: round(v / FKNN_BASELINE_QPS, 2) for k, v in fk.items()}
    put("ann_qps_at_r95", "ann_qps_at_r95")
    put("ann_sweep", "ann_sweep")
    put("ann_error", "ann_error")
    hy = {k: p["hybrid__" + k] for k in ("rrf", "linear")
          if "hybrid__" + k in p}
    if hy:
        extra["hybrid_qps"] = hy
        extra["hybrid_vs_baseline"] = {
            k: round(v / HYBRID_BASELINE_QPS, 2) for k, v in hy.items()}
    for k, v in p.items():   # surface any leftover sub-bench errors
        if k.endswith("_error") and k not in extra \
                and not k.startswith(("bm25__", "fknn__", "hybrid__")):
            extra[k] = v
    bad = {k: v for k, v in section_rc.items() if v != 0}
    if bad:
        extra["section_rc"] = bad
    extra.update(added or {})

    and2 = p.get("bm25__and2")
    return {
        "metric": "BM25 AND-2 top-10 QPS (1M zipf docs, batch 8192)",
        "value": and2 if and2 is not None else 0.0,
        "unit": "qps",
        "vs_baseline": round((and2 or 0.0) / BM25_BASELINE_QPS, 2),
        "extra": extra,
    }


def device_entry(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def run(sections=SECTIONS, device=None, shapes: Shapes = Shapes(),
        reps: int = 3) -> tuple:
    """Run `sections` in order on `device` (the card unless the caller
    names one).  Returns (the scoreboard, 0 if every section passed else
    1)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    board = Board()
    section_rc = {}
    for name in sections:
        t0 = time.perf_counter()
        log(f"--- section {name}")
        try:
            SECTION_FNS[name](board, shapes, reps, dev)
            section_rc[name] = 0
        except Exception as e:  # a section's failure is reported, not fatal
            traceback.print_exc()
            board.progress[name + "_error"] = repr(e)[:300]
            section_rc[name] = 1
        board.section_s[name] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"--- section {name}: rc {section_rc[name]} in "
            f"{board.section_s[name]:.1f}s")
    p = board.progress
    added = {
        "device": device_entry(dev), "reps": reps,
        "spread": board.spread, "parity": board.parity,
        "batch": board.batch, "routes": board.routes,
        "section_s": board.section_s,
        "switches": {s: os.environ[s] for s in SWITCHES if s in os.environ},
    }
    if "agg_groupby_qps" in p:
        added["agg_batch"] = shapes.agg_batches[0]
    for B in shapes.agg_batches[1:]:
        if f"agg_groupby_qps_b{B}" in p:
            added[f"agg_groupby_qps_b{B}"] = p[f"agg_groupby_qps_b{B}"]
    for B in shapes.fknn_batches[1:]:
        fk = {k: p[f"fknn__{k}_b{B}"] for k in FKNN_FAMILIES
              if f"fknn__{k}_b{B}" in p}
        if fk:
            added[f"filtered_knn_qps_b{B}"] = fk
    rc = int(any(section_rc.values()))
    return assemble(p, section_rc, added), rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--section", action="append", choices=SECTIONS,
                    help="a section to run (repeatable; default: all four "
                         "in bench.py's order)")
    ap.add_argument("--reps", type=int, default=3,
                    help="measurements of each number (default 3)")
    ap.add_argument("--text-batch", type=int,
                    help="the FT.SEARCH families' batch (default 8192)")
    ap.add_argument("--text-iters", type=int,
                    help="bench.py's `iters` of the families (default 8)")
    ap.add_argument("--device", help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    shapes = SMOKE if os.environ.get("BENCH_SMOKE") else Shapes()
    for arg, field in ((a.text_batch, "text_batch"),
                       (a.text_iters, "text_iters")):
        if arg is not None:
            shapes = dataclasses.replace(shapes, **{field: arg})
    sections = [s for s in SECTIONS if s in (a.section or SECTIONS)]
    board, rc = run(sections, a.device, shapes, a.reps)
    print(json.dumps(board), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
