"""Port of benchmarks/fknn_profile.py: batched filtered KNN split into
prepare, bind+submit and device+collect per filter family, then the
pipelined loop, on one CUDA card.

    python3 -m redisearch_tpu_torch.bench.fknn_profile [--docs N]
        [--batch B] [--iters I] [--reps R]

The script's shape: 500,000 docs x 384-dim unit vectors, COSINE, a title
of 3 of 10 words, year NUMERIC sortable, cat TAG (`workloads.fknn_corpus`,
seed 0, drawn in bulk), 512 query vectors; B = 2,048 queries a batch,
KNN 25, `iters` = 4 batches; the script's four families and the route
each takes (`workloads.fknn_families`): fulltext (`@title:w`,
"knn-batches"), numeric (`@year:[y y+5]`, "knn-dense"), tag (`@cat:{c}`,
"knn-dense") and pure (`*`, "knn-pure").  Per family: two warm batches
(their routes counted and reported), then
* sequential, `iters` batches: `prepare_ms` (every query's
  `ix.prepare`), `bind_submit_ms` (`execute_batch(async_=True)`: the
  binding, grouping and launches), `device_collect_ms` (`result()`: the
  card's wait and the copy to the host), each the mean a batch, and
  their QPS (`seq_qps`);
* `pipelined_qps`: `make` of batch i + 1 while batch i runs, batch i
  collected after batch i + 1 is submitted, over `iters` batches.
Each is the median of `--reps` (default 3) runs.

Parity, checked before any number is recorded: on 256 queries of the
first sequential batch, every hit passes its filter, every distance is
within 1e-5 of its float64 value, and recall@25 against an exact float64
top-25 over the filter's docs, computed on the card, is at least 0.99
(`workloads.check_fknn`, as `bench/run.py` checks it).

Prints nvidia-smi's name and power limit, progress on stderr, and as its
last line one JSON object: per family the phases, `seq_qps`,
`pipelined_qps`, `routes` and `recall_at_25`, with `spread`, `parity`
and `device`.  It runs on `cuda:0` and raises without a card; `--device
cpu` (the tests' way) runs it on the CPU, where `device` says "cpu" and
no number is a card's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.bench.run import knn_hits
from redisearch_tpu_torch.query import engine as E

#: the script's families, in its order (its query strings)
FAMILIES = ("fulltext", "numeric", "tag", "pure")
PURE = "*=>[KNN 25 @emb $b EF_RUNTIME 64]"
RECALL = 0.99
SAMPLE = 256


def family(ix, seg, name, qfn, ffn, ctx, B, iters, reps, dev) -> tuple:
    """One family's record, and its first sequential batch's results."""
    qvecs, v64, tidx, year, cat = ctx
    opts = E.QueryOptions(k=W.FKNN_K)

    def make(it):
        return [ix.prepare(qfn(it * B + i), {"b": qvecs[(it * B + i) % 512]},
                           opts, 2) for i in range(B)]

    before = dict(E.QUERY_PATH_STATS)
    for it in range(2):
        E.execute_batch(make(it), seg, W.FKNN_K)
    routes = W.route_delta(before, E.QUERY_PATH_STATS)
    seq = {"prepare_ms": [], "bind_submit_ms": [], "device_collect_ms": [],
           "seq_qps": [], "pipelined_qps": []}
    first = None
    for _rep in range(reps):
        tp = tb = td = 0.0
        for it in range(iters):
            t0 = time.perf_counter()
            cqs = make(it + 2)
            t1 = time.perf_counter()
            h = E.execute_batch(cqs, seg, W.FKNN_K, async_=True)
            t2 = time.perf_counter()
            res = h.result()
            W.sync(dev)
            t3 = time.perf_counter()
            tp, tb, td = tp + t1 - t0, tb + t2 - t1, td + t3 - t2
            if first is None:
                first = res
        seq["prepare_ms"].append(tp / iters * 1e3)
        seq["bind_submit_ms"].append(tb / iters * 1e3)
        seq["device_collect_ms"].append(td / iters * 1e3)
        seq["seq_qps"].append(iters * B / (tp + tb + td))
        dt, _ = W.pipelined(
            lambda cqs: E.execute_batch(cqs, seg, W.FKNN_K, async_=True),
            make, iters, dev, depth=1)
        seq["pipelined_qps"].append(iters * B / dt)
    rows = list(range(0, B, max(1, B // SAMPLE)))
    qs = [qfn(2 * B + i) for i in range(B)]
    hits = {i: knn_hits(ix, seg, first[i], W.FKNN_K) for i in rows}
    # query i of the first sequential batch has vector (2B + i) % 512
    qv = np.roll(qvecs, -(2 * B) % 512, axis=0)
    rec = W.check_fknn(hits, qs, qv, v64,
                       lambda r: ffn(2 * B + r, tidx, year, cat),
                       f"fknn_profile {name}", rows=rows)
    if rec < RECALL:
        raise AssertionError(f"fknn_profile {name}: recall@25 {rec}")
    out = {k: W.spread(v)["median"] for k, v in seq.items()}
    out.update(routes=routes, recall_at_25=rec)
    return out, {k: W.spread(v) for k, v in seq.items()}, first, qs


def run(dev, n_docs=W.FKNN_N, B=2048, iters=4, reps=3) -> dict:
    """fknn_profile.py's run on `dev`.  Returns the record (`main`'s
    JSON but `device`) with each family's first sequential batch (queries,
    results) under `served`."""
    docs, vecs, tidx, qvecs = W.fknn_corpus(n_docs, W.FKNN_D)
    ix = rt.SearchIndex(rt.Schema(name="arxivb",
                                  fields=W.fknn_fields(W.FKNN_D)),
                        device=dev)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    W.sync(dev)
    build_s = time.perf_counter() - t0
    del docs
    seg = ix.segments[0]
    v64 = torch.from_numpy(vecs).to(dev).double()
    del vecs
    ctx = (qvecs, v64, tidx, 1990 + np.arange(n_docs) % 35,
           np.arange(n_docs) % 20)
    fams = W.fknn_families()
    out, spread, served = {}, {}, {}
    for name in FAMILIES:
        qfn, _route, ffn = fams[name]
        if name == "pure":
            qfn = (lambda i: PURE)
        out[name], spread[name], res, qs = family(
            ix, seg, name, qfn, ffn, ctx, B, iters, reps, dev)
        served[name] = {"queries": qs, "results": res,
                        "vectors": [qvecs[(2 * B + i) % 512]
                                    for i in range(B)]}
        W.log(f"fknn_profile: {name}: B={B} " + " ".join(
            f"{k}={v:.3f}" for k, v in out[name].items()
            if isinstance(v, float)) + f" routes={out[name]['routes']}")
    W.log(f"fknn_profile: built {n_docs} in {build_s:.1f}s")
    return {"docs": n_docs, "batch": B, "iters": iters, "build_s": build_s,
            "families": out, "spread": spread,
            "parity": {"checked": len(range(0, B, max(1, B // SAMPLE))),
                       "of": B, "recall_gate": RECALL, "dist_atol": 1e-5,
                       "against": "float64 on the device"},
            "served": served}


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.fknn_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=W.FKNN_N)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=device,
                    help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    return W.emit(run(dev, a.docs, a.batch, a.iters, a.reps), dev)


if __name__ == "__main__":
    main()
