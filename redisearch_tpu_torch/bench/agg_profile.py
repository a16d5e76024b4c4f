"""Port of benchmarks/agg_profile.py: the phases of a batched
FT.AGGREGATE (`run_aggregate_many`) on bench.py's request, on one CUDA
card.

    python3 -m redisearch_tpu_torch.bench.agg_profile [--docs N]
        [--batch B] [--reps R]

The script's shape: 200,000 docs of `title` (TEXT, weight 2), `body`
(TEXT), `grp` (TAG sortable, 1,000 values) and `price` (NUMERIC
sortable), 24 zipf(1.25) tokens over a 200k vocabulary (seed 0); B =
256 requests a batch, each a 2-term match (terms from ranks 20..2,000)
-> GROUPBY @grp COUNT / SUM(@price) / AVG(@price) -> SORTBY @s DESC ->
LIMIT 0 10; two warm batches, then `--reps` (default 3) timed batches,
each of new requests.

The timed body is the port's own `agg/pipeline.py` `run_aggregate_many`
(the script copies the JAX one, whose phases differ), with a clock at
each of its phase boundaries:
* `prepare_plan_ms`: `commit`, `prepare`, the device plan and the
  grouping by (plan, per-segment row structure) of every request (the
  script's prepare+plan);
* `submit_ms`: `_device_group_submit_batch` of every group: the rows'
  upload and every launch, enqueued (the script's submit);
* `wait_ms`: a synchronize, the card finishing what submit queued, and
  `d2h_ms`: each group's output tensors copied to the host; their sum
  is `device_get_ms` (the script's device_get, one `jax.device_get`);
* `finish_ms`: each request's finish on the host (`_device_tail_finish`
  or `_device_group_finish`), and `run_aggregate` of each request
  without a device plan (`fallback`), whose own launch, wait and copy
  are inside it: there the port merges the script's submit, device_get
  and finish into one call.
Where a launch path synchronizes inside submit, that device time is in
`submit_ms`; `wait_ms` holds what was still queued.

Parity, checked before any number is recorded: every timed batch's rows
and totals equal `run_aggregate_many`'s for the same requests, and the
last batch's equal their plain recomputation (the kernels swapped for
their plain torch versions).

Prints nvidia-smi's name and power limit, progress on stderr, and as its
last line one JSON object with each phase's ms (the median of the
batches), `total_ms`, `qps`, `groups`, `fallback`, `spread`, `routes`
(`AGG_PATH_STATS`), `parity` and `device`.  It runs on `cuda:0` and
raises without a card; `--device cpu` (the tests' way) runs it on the
CPU, where `device` says "cpu" and no number is a card's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import pipeline as AP
from redisearch_tpu_torch.bench import workloads as W

PHASES = ("prepare_plan", "submit", "wait", "d2h", "device_get", "finish",
          "total")


def corpus(n_docs: int):
    """agg_profile.py's docs and its 256 query terms (seed 0)."""
    rng = np.random.default_rng(0)
    vocab = 200_000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(n_docs, 24)) - 1, 0, vocab - 1)
    cat2 = np.array(["g%04d" % i for i in range(1000)])
    price = rng.integers(1, 10_000, n_docs)
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "grp": cat2[i % 1000],
                       "price": float(price[i])})
            for i in range(n_docs)]
    qt = ["w%06d" % i for i in rng.integers(20, 2000, size=256)]
    return docs, qt


def fields():
    F, T = rt.Field, rt.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True)]


def request(qt, i: int):
    q = f"{qt[(2 * i) % 256]} {qt[(2 * i + 1) % 256]}"
    return (rt.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("AVG", ["@price"], "a"))
            .sort_by(("@s", rt.DESC)).limit(0, 10))


def profiled(ix, reqs, dev) -> tuple:
    """`run_aggregate_many(ix, reqs)` with a clock at each phase
    boundary: (its results, {phase: ms}, groups, fallback requests)."""
    t = [time.perf_counter()]
    ix.commit()
    prepared, groups = [], {}
    for req in reqs:
        cq = ix.prepare(req.query, req.params, AP._options(req),
                        req.dialect)
        plan = AP._plan_device_group_cached(ix, req, cq)
        prepared.append((req, cq, plan))
        if plan is None:
            continue
        segsig = tuple((e[6], e[7]) for e in
                       (cq.bind_row(seg)[1] for seg in ix.segments))
        groups.setdefault((id(plan), segsig), []).append(len(prepared) - 1)
    t.append(time.perf_counter())
    submitted = []
    for idxs in groups.values():
        sub = AP._device_group_submit_batch(ix, [prepared[i] for i in idxs])
        if sub is not None:
            submitted.append((idxs, sub))
    t.append(time.perf_counter())
    W.sync(dev)
    t.append(time.perf_counter())
    hosts = [[{kk: vv.cpu().numpy() for kk, vv in so.items()}
              for so in seg_outs] for _idxs, (_h, seg_outs) in submitted]
    t.append(time.perf_counter())
    out = [None] * len(prepared)
    for (idxs, (handles, _so)), host in zip(submitted, hosts):
        for j, (i, h) in enumerate(zip(idxs, handles)):
            group, tail, op_list, mm, rspec, key_parts = h
            parts = [(kp, {kk: vv[j] for kk, vv in hs.items()})
                     for kp, hs in zip(key_parts, host)]
            AP._count_path("device-tail" if rspec is not None
                           else "device")
            fin = (AP._device_tail_finish if rspec is not None
                   else AP._device_group_finish)
            out[i] = fin(ix, (group, tail, op_list, mm, rspec, parts))
    fallback = 0
    for i, (req, _cq, _plan) in enumerate(prepared):
        if out[i] is None:
            fallback += 1
            out[i] = AP.run_aggregate(ix, req)
    t.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    phases = {"prepare_plan": ms[0], "submit": ms[1], "wait": ms[2],
              "d2h": ms[3], "device_get": ms[2] + ms[3], "finish": ms[4],
              "total": sum(ms)}
    return out, phases, len(groups), fallback


def same_rows(got, want, reqs, what) -> None:
    for g, w, r in zip(got, want, reqs):
        if g.total != w.total or g.rows != w.rows:
            raise AssertionError(f"{what} {r.query!r}: {g.total} {g.rows} "
                                 f"vs {w.total} {w.rows}")


def run(dev, n_docs=200_000, B=256, reps=3) -> dict:
    """agg_profile.py's run on `dev`.  Returns the record (`main`'s JSON
    but `device`) with the last batch's requests and results under
    `served`."""
    docs, qt = corpus(n_docs)
    ix = rt.SearchIndex(rt.Schema(name="bm25", fields=fields()), device=dev)
    t0 = time.perf_counter()
    ix.add_documents(docs)
    W.sync(dev)
    build_s = time.perf_counter() - t0
    del docs
    for w in range(2):
        AP.run_aggregate_many(ix, [request(qt, w * B + i) for i in range(B)])
    before = dict(AP.AGG_PATH_STATS)
    samples = {p: [] for p in PHASES}
    qps, n_groups, n_fallback = [], set(), set()
    batches = []
    for rep in range(reps):
        reqs = [request(qt, (rep + 2) * B + i) for i in range(B)]
        res, ph, g, fb = profiled(ix, reqs, dev)
        for p in PHASES:
            samples[p].append(ph[p])
        qps.append(B / ph["total"] * 1e3)
        n_groups.add(g)
        n_fallback.add(fb)
        batches.append((reqs, res))
    routes = W.route_delta(before, AP.AGG_PATH_STATS)
    with W.plain_versions():
        plain = AP.run_aggregate_many(ix, batches[-1][0])
    for reqs, res in batches:
        same_rows(res, AP.run_aggregate_many(ix, reqs), reqs,
                  "agg_profile against run_aggregate_many")
    same_rows(batches[-1][1], plain, batches[-1][0],
              "agg_profile against plain")
    W.log(f"agg_profile: built {n_docs} in {build_s:.1f}s")
    for rep in range(reps):
        W.log(f"agg_profile: rep {rep}: " + " ".join(
            f"{p}={samples[p][rep]:.3f}ms" for p in PHASES)
            + f" qps={qps[rep]:.1f}")
    out = {"docs": n_docs, "batch": B, "build_s": build_s}
    spread = {}
    for p in PHASES:
        spread[p + "_ms"] = W.spread(samples[p])
        out[p + "_ms"] = spread[p + "_ms"]["median"]
    spread["qps"] = W.spread(qps)
    out.update(qps=spread["qps"]["median"], groups=sorted(n_groups),
               fallback=sorted(n_fallback), spread=spread, routes=routes,
               parity={"checked": B * reps, "against":
                       "run_aggregate_many; the last batch also plain "
                       "versions", "equal": "rows and totals"},
               served={"requests": batches[-1][0],
                       "results": batches[-1][1]})
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.agg_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=device,
                    help="cpu: run on the CPU (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    return W.emit(run(dev, a.docs, a.batch, a.reps), dev)


if __name__ == "__main__":
    main()
