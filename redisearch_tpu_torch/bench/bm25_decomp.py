"""Port of benchmarks/bm25_decomp.py: the 1M-doc BM25 serving pipeline
split into the host's part, the device's part and the pipelined loop,
on one CUDA card.

    python3 -m redisearch_tpu_torch.bench.bm25_decomp [--docs N]
        [--batch B] [--iters I] [--reps R]

The script's shape: 1M docs of `title` (TEXT, weight 2; 4 tokens),
`body` (TEXT; 20 tokens) and `cat` (TAG, 16 values), 24 zipf(1.25)
tokens over a 200k vocabulary (seed 0); and2 queries of two terms drawn
from ranks 20..5,000; batches of B = 4,096 queries, k 10, `iters` = 8
batches a loop, every loop warmed once.  Its four numbers, in us a
query (and QPS), each the median of `--reps` (default 3) loops:
* `make_us_q`: host only, `ix.prepare` of every query of the 8 batches;
* `submit_collect_us_q`: premade batches, `execute_batch` one after the
  other (submit, then collect);
* `premade_pipelined_us_q`: premade batches, batch i collected after
  batch i + 1 is submitted (`execute_batch(async_=True)`);
* `full_pipelined_us_q`: `make` of batch i + 1 while batch i runs, the
  same collect order (bench.py's loop at depth 1).
For information, the card's busy share of one traced full pipelined
loop (`torch.profiler`: the union of the device's kernel and copy
intervals over the loop's host seconds), as `chip_smoke.py` phase 5
takes it.

Parity, checked before any number is recorded: batch 0 of the last full
pipelined loop, every query against its plain recomputation on the card
(`workloads.plain_results`: the kernels swapped for their plain torch
versions; counts and docs equal, scores within rtol 1e-6).

Prints nvidia-smi's name and power limit, progress on stderr, and as its
last line one JSON object with the four numbers, their QPS, `spread`,
`busy_share`, `routes`, `build_docs_per_s`, `parity` and `device`.  It
runs on `cuda:0` and raises without a card; `--device cpu` (the tests'
way) runs it on the CPU, where `device` says "cpu", nothing is traced,
and no number is a card's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.query import engine as E

PHASES = ("make", "submit_collect", "premade_pipelined", "full_pipelined")


def corpus(n_docs: int):
    """bm25_decomp.py's docs and its 512 query terms (seed 0)."""
    rng = np.random.default_rng(0)
    vocab = 200_000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(n_docs, 24)) - 1, 0, vocab - 1)
    cats = np.array(["cat%02d" % i for i in range(16)])
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "cat": cats[i % 16]}) for i in range(n_docs)]
    qt = ["w%06d" % i for i in rng.integers(20, 5000, size=512)]
    return docs, qt


def fields():
    F, T = rt.Field, rt.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG)]


def query(qt, i: int, it: int) -> str:
    return f"{qt[(2 * i + it) % 500]} {qt[(2 * i + it + 1) % 500]}"


def loops(seg, make, pre, iters: int, dev) -> tuple:
    """One loop of each phase: ({phase: seconds}, the full loop's batch 0
    results)."""
    def submit(cqs):
        return E.execute_batch(cqs, seg, W.K, async_=True)

    t = {}
    t0 = time.perf_counter()
    for it in range(iters):
        make(it)
    t["make"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for it in range(iters):
        E.execute_batch(pre[it], seg, W.K)
    t["submit_collect"] = time.perf_counter() - t0
    t["premade_pipelined"], _ = W.pipelined(submit, pre.__getitem__, iters,
                                            dev, depth=1)
    t["full_pipelined"], first = W.pipelined(submit, make, iters, dev,
                                             depth=1)
    return t, first


def busy_share(seg, make, iters: int, dev) -> tuple:
    """The card's busy share of one traced full pipelined loop, the
    loop's seconds, and each kernel's busy us in it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, _ = W.pipelined(
            lambda cqs: E.execute_batch(cqs, seg, W.K, async_=True), make,
            iters, dev, depth=1)
    busy, kerns = W.device_busy_us(prof)
    return busy / (traced * 1e6), traced, kerns


def run(dev, n_docs=1_000_000, B=4096, iters=8, reps=3) -> dict:
    """bm25_decomp.py's run on `dev`.  Returns the record (`main`'s
    JSON but `device`) with batch 0's queries and results under
    `served`."""
    docs, qt = corpus(n_docs)
    ix = rt.SearchIndex(rt.Schema(name="bm25", fields=fields()), device=dev)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    W.sync(dev)
    build_s = time.perf_counter() - t0
    del docs
    seg = ix.segments[0]
    opts = E.QueryOptions(k=W.K)

    def make(it):
        return [ix.prepare(query(qt, i, it), None, opts, 2)
                for i in range(B)]

    for it in range(iters):
        E.execute_batch(make(it), seg, W.K)
    pre = [make(it) for it in range(iters)]
    before = dict(E.QUERY_PATH_STATS)
    secs = {p: [] for p in PHASES}
    for _ in range(reps):
        t, first = loops(seg, make, pre, iters, dev)
        for p in PHASES:
            secs[p].append(t[p])
    routes = W.route_delta(before, E.QUERY_PATH_STATS)
    qs = [query(qt, i, 0) for i in range(B)]
    rows = list(range(0, B, max(1, B // 256)))
    plain, _ = W.plain_results(ix, seg, [qs[i] for i in rows])
    err = W.check_against_plain([first[i] for i in rows], plain,
                                "bm25_decomp")
    out = {"docs": n_docs, "batch": B, "iters": iters,
           "build_docs_per_s": n_docs / build_s}
    spread = {}
    for p in PHASES:
        us = [s / iters / B * 1e6 for s in secs[p]]
        spread[p + "_us_q"] = W.spread(us)
        out[p + "_us_q"] = spread[p + "_us_q"]["median"]
        if p != "make":
            out[p + "_qps"] = W.spread([iters * B / s for s in secs[p]]
                                       )["median"]
    out["spread"] = spread
    out["busy_share"] = None
    if dev.type == "cuda":
        share, traced, kerns = busy_share(seg, make, iters, dev)
        out["busy_share"] = share
        out["traced_loop_s"] = traced
        out["traced_kernels_us"] = kerns
    out["routes"] = routes
    out["parity"] = {"checked": len(rows), "of": B,
                     "max_abs_score_err": err, "against": "plain versions"}
    out["served"] = {"queries": qs, "results": first}
    W.log(f"bm25_decomp: build {n_docs / build_s:.0f} docs/s; "
          + ", ".join(f"{p} {out[p + '_us_q']:.3f} us/q" for p in PHASES)
          + f"; busy share {out['busy_share']}; routes {routes}")
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.bm25_decomp",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=device,
                    help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    return W.emit(run(dev, a.docs, a.batch, a.iters, a.reps), dev)


if __name__ == "__main__":
    main()
