"""Port of benchmarks/cold_bench.py: BM25 QPS on a hot index against the
same corpus as a cold one (`storage="host"`), and the paging tax, on one
CUDA card.

    python3 -m redisearch_tpu_torch.bench.cold_bench [--docs N] [--reps R]
        [--min-seconds S]

The script's shape (`workloads.cold_corpus`, `workloads.cold_queries`):
500,000 docs of one TEXT field `t`, 16 zipf(1.25) tokens each over a
100k vocabulary (seed 0), built twice through `add_documents`: with
`storage="hbm"` (the CSR on the card) and with `storage="host"` (the CSR
in host memory, each query's window slabs paged up); 128 and2 queries
and 128 exact phrases (seed 7) through `search_many(k=10)`, after 32
single `search` warm-ups and one untimed `search_many` pass, then
`--reps` (default 3) timed samples a family, each `search_many` passes
repeated until `--min-seconds` (default 1) have gone by.

Parity, checked before any number is recorded: the script's assertion
(cold totals equal hot totals), and every cold hit list equal to the
hot one for its query (ids and order, scores within rtol 1e-6).  The
hot side's routes are counted and reported (and2 is expected on
"kernel", the phrases on "phrase-kernel"); a query the router sends
elsewhere shows under its route.

Prints nvidia-smi's name and power limit, progress on stderr, and as its
last line the script's JSON object: per storage `and2_qps`, `phrase_qps`
(each the median of `--reps` samples: queries over host seconds, each
pass ending in a synchronize), `csr_mb` (the five CSR arrays' bytes, as
the script counts them) and `build_s`, and `paging_tax_and2` (hot and2
QPS over cold), beside `spread`, `passes` (each sample's passes),
`min_s`, `routes`, `parity` and `device`.  It runs on `cuda:0` and
raises without a card; `--device cpu` (the tests' way) runs it on the
CPU, where `device` says "cpu" and no number is a card's.
"""

from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.query import engine as E

STORAGES = ("hbm", "host")
SCORE_RTOL = 1e-6
#: a timed sample's least seconds: a hot pass of 128 queries takes a few
#: ms, too short a window for a stable number
MIN_S = 1.0


def build(storage: str, n_docs: int, dev):
    """cold_bench.py's `build`: (the index, its build seconds)."""
    ix = rt.SearchIndex(rt.Schema(name=f"cb_{storage}", fields=[
        rt.Field("t", rt.FieldType.TEXT)], storage=storage), device=dev)
    docs = W.cold_corpus(n_docs)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    W.sync(dev)
    return ix, time.perf_counter() - t0


def csr_bytes(seg) -> int:
    tx = seg.text
    return sum(a.nbytes for a in (tx.doc_ids, tx.freqs, tx.field_masks,
                                  tx.doclens, tx.poskeys))


def measure(ix, queries, reps: int, dev, min_s: float = MIN_S) -> tuple:
    """(QPS of each timed sample, the last pass's results, the routes of
    the timed passes, the passes of each sample).  A sample repeats the
    `search_many` pass until `min_s` seconds have gone by (one pass at
    least) and counts every query of its passes."""
    for q in queries[:W.COLD_WARM]:
        ix.search(q)
    ix.search_many(queries, k=W.COLD_K)
    before = dict(E.QUERY_PATH_STATS)
    qps, passes = [], []
    for _ in range(reps):
        n = 0
        t0 = time.perf_counter()
        while True:
            res = ix.search_many(queries, k=W.COLD_K)
            W.sync(dev)
            n += 1
            dt = time.perf_counter() - t0
            if dt >= min_s:
                break
        qps.append(n * len(queries) / dt)
        passes.append(n)
    return qps, res, W.route_delta(before, E.QUERY_PATH_STATS), passes


def same_results(cold, hot, what) -> None:
    """Cold against hot: totals, ids and order equal, scores within
    SCORE_RTOL."""
    for i, (c, h) in enumerate(zip(cold, hot)):
        if c.total != h.total or [x.key for x in c.hits] != [
                x.key for x in h.hits]:
            raise AssertionError(f"cold {what} query {i}: {c.total} "
                                 f"{[x.key for x in c.hits]} vs hot "
                                 f"{h.total} {[x.key for x in h.hits]}")
        np.testing.assert_allclose([x.score for x in c.hits],
                                   [x.score for x in h.hits],
                                   rtol=SCORE_RTOL, atol=0,
                                   err_msg=f"cold {what} query {i}")


def measure_all(dev, n_docs: int = W.COLD_N, reps: int = 3,
                min_s: float = MIN_S) -> dict:
    """cold_bench.py's run on `dev`.  Returns the record (`main`'s JSON
    but `device`) with each storage's results under `served`."""
    fams = W.cold_queries()
    out, spreads, routes, served, passes = {}, {}, {}, {}, {}
    for storage in STORAGES:
        ix, build_s = build(storage, n_docs, dev)
        seg = ix.segments[0]
        rec = {}
        served[storage] = {}
        for fam, qs in fams.items():
            qps, res, rts, n = measure(ix, qs, reps, dev, min_s)
            passes[f"{storage}__{fam}"] = n
            spreads[f"{storage}__{fam}_qps"] = W.spread(qps)
            rec[f"{fam}_qps"] = W.spread(qps)["median"]
            routes.setdefault(storage, {})[fam] = rts
            served[storage][fam] = res
        rec["csr_mb"] = csr_bytes(seg) / 1e6
        rec["build_s"] = build_s
        out[storage] = rec
        del ix, seg
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    totals = {s: [[r.total for r in served[s][f]] for f in fams]
              for s in STORAGES}
    if totals["hbm"] != totals["host"]:
        raise AssertionError("cold != hot results!")
    for fam in fams:
        same_results(served["host"][fam], served["hbm"][fam], fam)
    off = {f: r for f, r in routes["hbm"].items()
           if set(r) - {"kernel" if f == "and2" else "phrase-kernel"}}
    out["paging_tax_and2"] = (out["hbm"]["and2_qps"]
                              / max(out["host"]["and2_qps"], 1e-9))
    out.update(spread=spreads, routes=routes, docs=n_docs,
               passes=passes, min_s=min_s, parity={
        "checked": sum(len(q) for q in fams.values()),
        "against": "the hot index", "equal": "totals, ids and order",
        "score_rtol": SCORE_RTOL, "hot_off_route": off}, served=served)
    for storage in STORAGES:
        W.log(f"cold: {storage}: {n_docs} docs built in "
              f"{out[storage]['build_s']:.1f}s, CSR "
              f"{out[storage]['csr_mb']:.1f} MB, routes {routes[storage]}")
    W.log(f"cold: every cold result == the hot one; and2 "
          f"{out['hbm']['and2_qps']:.1f} / {out['host']['and2_qps']:.1f} "
          f"qps hot / cold (paging tax {out['paging_tax_and2']:.2f}), "
          f"phrase {out['hbm']['phrase_qps']:.1f} / "
          f"{out['host']['phrase_qps']:.1f}; hot queries off their "
          f"expected route: {off or 'none'}")
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.cold_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=W.COLD_N)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-seconds", type=float, default=MIN_S,
                    help="a timed sample's least seconds (default 1)")
    ap.add_argument("--device", default=device,
                    help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    return W.emit(measure_all(dev, a.docs, a.reps, a.min_seconds), dev)


if __name__ == "__main__":
    main()
