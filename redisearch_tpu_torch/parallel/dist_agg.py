# Copy of redisearch_tpu/parallel/dist_agg.py: the port imports nothing of the JAX package.
"""Distributed aggregations: the DISTRIBUTE-step plan split.

Reference: AGGPLN_Distribute (src/coord/dist_plan.cpp:511) splits an
aggregation plan at the DISTRIBUTE step into a remote part (runs on each
shard) and a local part (runs on the coordinator), rewriting reducers so
partial results merge correctly (dist_plan.cpp:480-497):

    COUNT            -> shard COUNT            / merge SUM
    SUM / MIN / MAX  -> shard same             / merge SUM / MIN / MAX
    AVG              -> shard SUM + COUNT      / merge SUM/SUM division
    COUNT_DISTINCT   -> shard TOLIST           / merge COUNT_DISTINCT
    COUNT_DISTINCTISH-> shard HLL              / merge HLL_SUM
    STDDEV           -> shard SUM+COUNT+SUMSQ  / merge Welford combine
    QUANTILE         -> shard TOLIST           / merge QUANTILE (exact)
    TOLIST / COLLECT -> shard TOLIST           / merge union
    FIRST_VALUE      -> shard FIRST_VALUE      / merge FIRST_VALUE
    RANDOM_SAMPLE    -> shard RANDOM_SAMPLE    / merge re-sample

Here "shards" are the doc-partitioned sub-indexes of a ShardedIndex; the
per-shard pass runs the same engine on each shard's rows, and the merge is
a host-side group combine (group counts are small after reduction).

Each shard's pass is its own `SearchIndex` view on the shard's device
(`parallel.dist._shard_index_view`), so where the rewritten plan is
eligible it takes the device GROUPBY there (`agg.pipeline`).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..agg import expr as E
from ..agg.pipeline import (AggregateRequest, AggregateResult, ApplyStep,
                            FilterStep, GroupStep, LimitStep, LoadStep,
                            SortStep, _run_steps, _sort)
from ..agg.reducers import make_reducer
from ..utils.hll import HLL


def _split_plan(req: AggregateRequest):
    """Split steps at the first GROUPBY (the implicit DISTRIBUTE point).

    Steps before + the groupby run per shard (with rewritten reducers);
    the merge groupby + remaining steps run on the coordinator.
    """
    for i, step in enumerate(req.steps):
        if isinstance(step, GroupStep):
            return req.steps[:i], step, req.steps[i + 1:]
    return req.steps, None, []


# per-reducer rewrite: name -> (shard reducer specs, merge fn)
def _rewrites(name: str, args: list[str], alias: str):
    """Returns (shard_specs, merge) where shard_specs is a list of
    (name, args, alias) to run per shard and merge(rows)->value combines
    the shard partials for one group."""
    prop = args[0] if args else None
    a = alias

    if name == "COUNT":
        return [("COUNT", [], a)], lambda vs: sum(v[a] or 0 for v in vs)
    if name == "SUM":
        return [("SUM", args, a)], lambda vs: sum(v[a] or 0 for v in vs)
    if name == "MIN":
        return [("MIN", args, a)], lambda vs: _optional_red(
            [v[a] for v in vs], min)
    if name == "MAX":
        return [("MAX", args, a)], lambda vs: _optional_red(
            [v[a] for v in vs], max)
    if name == "AVG":
        return ([("SUM", args, f"__{a}_sum"), ("COUNT", [], f"__{a}_cnt")],
                lambda vs: _div(sum(v[f"__{a}_sum"] or 0 for v in vs),
                                sum(v[f"__{a}_cnt"] or 0 for v in vs)))
    if name == "COUNT_DISTINCT":
        return ([("TOLIST", args, f"__{a}_vals")],
                lambda vs: float(len(set(
                    _hashable_all(x for v in vs
                                  for x in (v[f"__{a}_vals"] or []))))))
    if name in ("COUNT_DISTINCTISH",):
        return ([("HLL", args, f"__{a}_hll")],
                lambda vs: float(_hll_merge(
                    [v[f"__{a}_hll"] for v in vs]).count()))
    if name == "HLL":
        return ([("HLL", args, a)],
                lambda vs: _hll_merge([v[a] for v in vs]).to_bytes())
    if name == "HLL_SUM":
        return ([("HLL_SUM", args, a)], lambda vs: float(_hll_merge(
            [v[a] for v in vs if isinstance(v[a], bytes)]).count()))
    if name == "STDDEV":
        return ([("SUM", args, f"__{a}_s"), ("COUNT", [], f"__{a}_n"),
                 ("SUMSQ", args, f"__{a}_s2")],
                lambda vs: _stddev_combine(vs, a))
    if name == "QUANTILE":
        q = args[1] if len(args) > 1 else "0.5"
        return ([("TOLIST", [args[0]], f"__{a}_vals")],
                lambda vs: _quantile([x for v in vs
                                      for x in (v[f"__{a}_vals"] or [])],
                                     float(q)))
    if name in ("TOLIST", "COLLECT"):
        return ([("TOLIST", args, a)],
                lambda vs: _dedupe([x for v in vs for x in (v[a] or [])]))
    if name == "FIRST_VALUE":
        return ([("FIRST_VALUE", args, a),
                 *([("MIN" if (len(args) < 4 or args[3].upper() != "DESC")
                     else "MAX", [args[2]], f"__{a}_key")]
                   if len(args) >= 3 and args[1].upper() == "BY" else [])],
                lambda vs: _first_value_merge(vs, a, args))
    if name == "RANDOM_SAMPLE":
        n = int(args[1]) if len(args) > 1 else 1
        return ([("RANDOM_SAMPLE", args, a)],
                lambda vs: [x for v in vs for x in (v[a] or [])][:n])
    raise ValueError(f"no distribution for reducer {name}")


def _optional_red(vals, fn):
    vals = [v for v in vals if v is not None]
    return fn(vals) if vals else None


def _div(a, b):
    return a / b if b else None


def _hashable_all(it):
    return {tuple(x) if isinstance(x, list) else x for x in it}


def _hll_merge(blobs) -> HLL:
    h = HLL()
    for b in blobs:
        if isinstance(b, bytes):
            h.merge(HLL.from_bytes(b))
    return h


def _stddev_combine(vs, a):
    n = sum(v[f"__{a}_n"] or 0 for v in vs)
    s = sum(v[f"__{a}_s"] or 0 for v in vs)
    s2 = sum(v[f"__{a}_s2"] or 0 for v in vs)
    if n < 2:
        return 0.0 if n else None
    var = (s2 - s * s / n) / (n - 1)
    return max(var, 0.0) ** 0.5


def _quantile(vals, q):
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def _dedupe(vals):
    seen = set()
    out = []
    for v in vals:
        h = tuple(v) if isinstance(v, list) else v
        if h not in seen:
            seen.add(h)
            out.append(v)
    return out


def _first_value_merge(vs, a, args):
    if len(args) >= 3 and args[1].upper() == "BY":
        asc = len(args) < 4 or args[3].upper() != "DESC"
        best = None
        best_key = None
        for v in vs:
            k = v.get(f"__{a}_key")
            if k is None:
                continue
            if best_key is None or (k < best_key if asc else k > best_key):
                best_key = k
                best = v[a]
        return best
    for v in vs:
        if v.get(a) is not None:
            return v[a]
    return None


def dist_aggregate(sharded, req: AggregateRequest) -> AggregateResult:
    """Run an aggregation across a ShardedIndex with plan splitting."""
    pre, group, post = _split_plan(req)

    if group is None:
        # no groupby: concatenate shard rows, then run tail locally
        # (reference: plain scatter/gather with LIMIT pushdown)
        rows: list[dict] = []
        total = 0
        for shard_ix in _shard_indexes(sharded):
            res = shard_ix.aggregate(_clone_req(req, req.steps))
            total += res.total
            rows.extend(res.rows)
        # re-apply SORT/LIMIT across the merged rows
        for step in req.steps:
            if isinstance(step, SortStep):
                rows = _sort(rows, step)
            elif isinstance(step, LimitStep):
                rows = rows[step.offset:step.offset + step.num]
        return AggregateResult(total=total, rows=rows)

    # rewrite reducers for the shard pass
    shard_specs: list[tuple] = []
    merges: list[tuple[str, Any]] = []
    for name, args, alias in group.reducers:
        alias = alias or make_reducer(name, args).default_alias()
        specs, merge = _rewrites(name.upper(), args, alias)
        shard_specs.extend(specs)
        merges.append((alias, merge))

    shard_group = GroupStep(by=group.by, reducers=shard_specs)
    total = 0
    partials: dict[tuple, list[dict]] = {}
    for shard_ix in _shard_indexes(sharded):
        res = shard_ix.aggregate(_clone_req(req, pre + [shard_group]))
        total += res.total
        for row in res.rows:
            key = tuple(_hkey(row.get(b)) for b in group.by)
            partials.setdefault(key, []).append(row)

    rows = []
    for key, vs in partials.items():
        out = {b: vs[0].get(b) for b in group.by}
        for alias, merge in merges:
            out[alias] = merge(vs)
        rows.append(out)

    # local tail (APPLY/FILTER/SORT/LIMIT after the groupby)
    tail_req = _clone_req(req, post)
    rows = _run_steps_no_load(sharded.index, tail_req, rows)
    return AggregateResult(total=total, rows=rows)


def _run_steps_no_load(index, req, rows):
    return _run_steps(index, req, rows)


def _clone_req(req: AggregateRequest, steps) -> AggregateRequest:
    r = AggregateRequest(req.query, req.params, req.dialect, req.verbatim,
                         req.scorer)
    r.steps = list(steps)
    return r


def _hkey(v):
    return tuple(v) if isinstance(v, list) else v


def _shard_indexes(sharded):
    """Per-shard SearchIndex views built from the sharded sub-segments,
    each on its shard's device."""
    from .dist import _shard_index_view
    for seg in sharded.shards:
        yield _shard_index_view(sharded, seg)
