"""Port of benchmarks/tpu_smoke.py: one query mix's canonical digest, on
the card and on the CPU, diffed.

    python3 -m redisearch_tpu_torch.bench.device_smoke [--compare]

The script's 64-doc index (`build`: six fields, seed 7) and its digests
(`digest`): 14 FT.SEARCH results (and2, or2, not, phrase, field, prefix,
tag, num, mixed_union, geo, sort, knn, batchesknn, hybridknn), each its
total and its hits as (key, score rounded to 4 digits), and one
FT.AGGREGATE (GROUPBY @tag COUNT, AVG(@price), SORTBY @tag), each row's
numbers rounded to 4 digits.  The class of fault it catches: the card
and the CPU disagree on the whole engine (a layout or numerics fault of
the card) while every kernel still matches its plain version.

Without `--compare` it prints the digest taken on the card.  With
`--compare` it takes the digest with two clients in this process, one
on `cuda:0` and one on the CPU (where every kernel runs its plain
version), and exits 1 on any difference: keys, hit order and totals
must be equal, scores and aggregate values within 1e-4 (the digest's
4-digit rounding).  Prints nvidia-smi's name and power limit, then as its
last line one JSON object: `digest` (the card's), with `--compare`
`compare` (`checked`: the values compared, `differences`), and
`device`.  It runs on the card and raises without one; `--device cpu`
(the tests' way) takes the digest on the CPU alone.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench import workloads as W

#: the digest's rounding: values compared within this
TOL = 1e-4


def build(device):
    """tpu_smoke.py's client and 64-doc index `smoke` on `device`, and
    its vectors."""
    F, T = rt.Field, rt.FieldType
    c = rt.Client(device=device)
    c.ft_create("smoke", [
        F("title", T.TEXT, weight=2.0),
        F("body", T.TEXT),
        F("tag", T.TAG),
        F("price", T.NUMERIC, sortable=True),
        F("loc", T.GEO),
        F("v", T.VECTOR, vector=rt.VectorParams(dim=8, metric="L2")),
    ])
    rng = np.random.default_rng(7)
    words = ["alpha", "beta", "gamma", "delta", "omega", "search",
             "engine", "vector", "query", "shard"]
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    for i in range(64):
        c.hset(f"d{i}", {
            "title": " ".join(rng.choice(words, 3)),
            "body": " ".join(rng.choice(words, 8)),
            "tag": ["red", "green", "blue"][i % 3],
            "price": float(i % 20),
            "loc": f"{-122.4 + (i % 10) * 0.01},{37.7 + (i // 10) * 0.01}",
            "v": vecs[i],
        })
    return c, vecs


def digest(device) -> dict:
    """tpu_smoke.py's digest of its query mix, taken on `device`."""
    c, vecs = build(device)
    out = {}

    def dig(name, res):
        out[name] = {"total": res.total,
                     "hits": [(h.key, round(float(h.score), 4))
                              for h in res.hits]}

    def s(q, **kw):
        return c.ft_search("smoke", q, no_content=True, **kw)

    dig("and2", s("alpha beta"))
    dig("or2", s("alpha|omega"))
    dig("not", s("search -vector"))
    dig("phrase", s('"vector query"'))
    dig("field", s("@title:engine"))
    dig("prefix", s("gam*"))
    dig("tag", s("@tag:{red}"))
    dig("num", s("@price:[5 9]"))
    # mixed-order union: numeric windows are value-sorted, tag and term
    # windows doc-sorted (the union's sort-based dedup)
    dig("mixed_union", s("(alpha | @price:[3 7] | @tag:{red})", num=50))
    dig("geo", s("@loc:[-122.38 37.72 3 km]"))
    dig("sort", s("*", sort_by="price"))
    dig("knn", s("*=>[KNN 5 @v $q]", params={"q": vecs[17]}))
    dig("batchesknn", s(
        "(@tag:{blue})=>[KNN 5 @v $q HYBRID_POLICY BATCHES]",
        params={"q": vecs[17]}))
    dig("hybridknn", s("(@tag:{blue})=>[KNN 5 @v $q]",
                       params={"q": vecs[17]}))
    req = (rt.AggregateRequest("*")
           .group_by(["@tag"], ("COUNT", [], "n"),
                     ("AVG", ["@price"], "avg"))
           .sort_by("@tag"))
    out["agg"] = [{k: (round(float(v), 4)
                       if isinstance(v, (int, float)) else v)
                   for k, v in r.items()} for r in
                  c.ft_aggregate("smoke", req).rows]
    # JSON's form (tuples become lists), as the script prints it
    return json.loads(json.dumps(out))


def compare(a: dict, b: dict) -> tuple:
    """(values compared, differences) of two digests: equal names,
    totals, keys and hit order, agg rows' fields and strings; scores and
    numbers within TOL."""
    diffs, n = [], 0

    def num(x, y, where):
        nonlocal n
        n += 1
        if not abs(float(x) - float(y)) <= TOL:
            diffs.append(f"{where}: {x} vs {y}")

    if set(a) != set(b):
        return n, [f"digests {sorted(a)} vs {sorted(b)}"]
    for name in sorted(a):
        x, y = a[name], b[name]
        if name == "agg":
            if [sorted(r) for r in x] != [sorted(r) for r in y]:
                diffs.append(f"agg rows {x} vs {y}")
                continue
            for i, (rx, ry) in enumerate(zip(x, y)):
                for k, vx in rx.items():
                    if isinstance(vx, str) or isinstance(ry[k], str):
                        n += 1
                        if vx != ry[k]:
                            diffs.append(f"agg {i} {k}: {vx} vs {ry[k]}")
                    else:
                        num(vx, ry[k], f"agg {i} {k}")
            continue
        n += 1
        if x["total"] != y["total"]:
            diffs.append(f"{name} total {x['total']} vs {y['total']}")
        n += 1
        if [h[0] for h in x["hits"]] != [h[0] for h in y["hits"]]:
            diffs.append(f"{name} keys {x['hits']} vs {y['hits']}")
            continue
        for (k, sx), (_k, sy) in zip(x["hits"], y["hits"]):
            num(sx, sy, f"{name} {k} score")
    return n, diffs


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.device_smoke",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="store_true",
                    help="take the digest on the card and on the CPU, "
                         "exit 1 on any difference")
    ap.add_argument("--device", default=device,
                    help="cpu: the digest on the CPU alone (tests only)")
    a = ap.parse_args(argv)
    dev = W.open_device(a.device)
    if a.compare and dev.type != "cuda":
        raise SystemExit("--compare takes the card's digest: run it on "
                         "the card")
    out = {"digest": digest(dev)}
    if a.compare:
        checked, diffs = compare(out["digest"], digest("cpu"))
        out["compare"] = {"checked": checked, "differences": diffs,
                          "tolerance": TOL, "against": "the CPU"}
        W.log(f"device_smoke: card against CPU: {checked} values, "
              f"{len(diffs)} differences {diffs[:8]}")
    out["device"] = W.device_entry(dev)
    if out.get("compare", {}).get("differences"):
        # no number is printed when the digests differ
        raise SystemExit(f"device_smoke: the card's digest differs from "
                         f"the CPU's: {out['compare']['differences']}")
    print(json.dumps(out, sort_keys=True), flush=True)
    return out


if __name__ == "__main__":
    main()
