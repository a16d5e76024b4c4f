"""FT.AGGREGATE for the torch port.

Counterpart of `redisearch_tpu/agg/pipeline.py`:

* batched, `run_aggregate_many` -> `_device_group_submit_batch`, per
  segment and batch group either
  - the kernel-raw branch: the intersection kernel in raw mode
    (`ops.intersect.intersect_batch(raw=True)`) emits each query's
    masked pivot-window lanes, the posting-aligned (group id, value,
    present) columns are sliced at the same rows, the compiled
    APPLY/FILTER steps run on those lanes and the batched group-by
    kernel (B3, `ops.groupby.groupby_aggregate_batch`) sums every
    query's groups; or
  - the window branch, for what that kernel does not serve (match-all,
    pivots over 32,768, MIN/MAX, ...): the general window program per
    query (`query.engine._build_fn`, mode "window") and either B3 over
    the staged (gid, value) windows (`_make_fused_cols`) or one call a
    query of the fused single-query kernel (B4/B5; `_make_fused`,
    `groupby_aggregate_multi`);
  then an on-device SORT/LIMIT head (`_make_device_tail`) or the host
  merge (`_device_group_finish`);
* single, `run_aggregate` -> `_device_group_submit` -> `_make_fused` per
  segment -> `_device_group_finish`;
* a KNN source (`(filter)=>[KNN k @v $b]`), single or batched: each
  segment's k nearest through `query.engine.execute` (the window
  program's KNN branches), then the steps on the host rows;
* the host pipeline, for what the device GROUPBY does not serve (LOAD,
  non-algebraic reducers, keys it cannot encode, more than 65,536
  groups, no GROUPBY at all): the window program per segment
  (`execute(..., mode="window")`), host rows in window order, then
  `_run_steps`; batched, such a request runs when the batch is
  collected, in its own place in the output;
* streaming (`run_aggregate_streaming`, FT.AGGREGATE WITHCURSOR): the
  device GROUPBY and KNN plans run materialized, every other plan pulls
  its host rows and steps chunk by chunk.

Left out as TPU-attach machinery: the packed executors and their compile
cache, async host copies, pow2 batch padding and the 1024-query
scalar-memory chunking.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..agg import expr as E
from ..agg.reducers import make_reducer
from ..schema import FieldType
from ..utils.errors import QuerySyntaxError
from ..ops import groupby as GB
from ..ops import intersect as IK
from ..query.engine import (Deferred, LAll, QueryOptions, _cold_slab_args,
                            _device_unpack, _device_unpack_rows,
                            _kernel_batched_inputs,
                            _kernel_plan, _layout_of, _pack_into, _pack_out,
                            _program, _segment_args, _unpack_out,
                            _window_width, execute, next_pow2)
from .device_expr import compile_device_expr

ASC = True
DESC = False


# -- plan steps (reference: PLN_*Step, aggregate_plan.h) --------------------

@dataclasses.dataclass
class LoadStep:
    fields: Optional[list[str]]  # None = LOAD *


@dataclasses.dataclass
class ApplyStep:
    expression: str
    alias: str
    parsed: E.Expr = None

    def __post_init__(self):
        self.parsed = E.parse(self.expression)


@dataclasses.dataclass
class FilterStep:
    expression: str
    parsed: E.Expr = None

    def __post_init__(self):
        self.parsed = E.parse(self.expression)


@dataclasses.dataclass
class GroupStep:
    by: list[str]
    reducers: list[tuple[str, list[str], Optional[str]]]  # (name, args, alias)


@dataclasses.dataclass
class SortStep:
    keys: list[tuple[str, bool]]  # (prop, ascending)
    max: int = 0


@dataclasses.dataclass
class LimitStep:
    offset: int
    num: int


class AggregateRequest:
    """Builder for an aggregation plan (FT.AGGREGATE argv analog)."""

    def __init__(self, query: str = "*", params: Optional[dict] = None,
                 dialect: int = 2, verbatim: bool = False,
                 scorer: str = "BM25STD", add_scores: bool = False,
                 now: Optional[int] = None):
        self.query = query
        self.params = params
        self.dialect = dialect
        self.verbatim = verbatim
        self.scorer = scorer
        self.add_scores = add_scores
        # TTL-clock override (epoch seconds); None = wall clock
        self.now = now
        self.steps: list[Any] = []
        self._cursor_count = 0
        self.with_cursor = False

    def load(self, *fields: str) -> "AggregateRequest":
        self.steps.append(LoadStep([f.lstrip("@") for f in fields] or None))
        return self

    def load_all(self) -> "AggregateRequest":
        self.steps.append(LoadStep(None))
        return self

    def apply(self, expression: str, alias: str) -> "AggregateRequest":
        self.steps.append(ApplyStep(expression, alias))
        return self

    def filter(self, expression: str) -> "AggregateRequest":
        self.steps.append(FilterStep(expression))
        return self

    def group_by(self, by, *reducers) -> "AggregateRequest":
        """group_by("@field" | ["@f1", "@f2"], ("COUNT", [], "cnt"), ...)"""
        by = [by] if isinstance(by, str) else list(by)
        rs = []
        for r in reducers:
            if isinstance(r, tuple) and len(r) == 3:
                rs.append((r[0], list(r[1]), r[2]))
            elif isinstance(r, tuple) and len(r) == 2:
                rs.append((r[0], list(r[1]), None))
            else:
                raise QuerySyntaxError(f"bad reducer spec {r!r}")
        self.steps.append(GroupStep([b.lstrip("@") for b in by], rs))
        return self

    def sort_by(self, *keys, max: int = 0) -> "AggregateRequest":
        """sort_by("@price", ("@name", DESC), max=10)"""
        parsed = []
        for k in keys:
            if isinstance(k, tuple):
                parsed.append((k[0].lstrip("@"), bool(k[1])))
            else:
                parsed.append((k.lstrip("@"), ASC))
        self.steps.append(SortStep(parsed, max))
        return self

    def limit(self, offset: int, num: int) -> "AggregateRequest":
        self.steps.append(LimitStep(offset, num))
        return self

    def cursor(self, count: int = 1000) -> "AggregateRequest":
        self.with_cursor = True
        self._cursor_count = count
        return self


@dataclasses.dataclass
class AggregateResult:
    total: int
    rows: list[dict]
    cursor_id: int = 0
    warnings: list = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

#: host rows a streamed chunk holds
_STREAM_CHUNK = 4096

#: served-path counters: "device-tail" = GROUPBY with the on-device
#: SORT/LIMIT head, "device" = GROUPBY with the host finish, "knn" = a
#: KNN source with the steps on the host, "host" = the window source with
#: the steps on the host
AGG_PATH_STATS: dict = {}


def _count_path(path: str, n: int = 1) -> None:
    AGG_PATH_STATS[path] = AGG_PATH_STATS.get(path, 0) + n


def _options(req: "AggregateRequest") -> QueryOptions:
    if req.now is None:
        return QueryOptions(scorer=req.scorer, verbatim=req.verbatim)
    return QueryOptions(scorer=req.scorer, verbatim=req.verbatim,
                        now=req.now)


def run_aggregate(index, req: "AggregateRequest",
                  profile: Optional[dict] = None) -> "AggregateResult":
    """Execute one aggregation (FT.AGGREGATE): the device GROUPBY over
    the general window program on every segment when the plan is device-
    eligible, else the host pipeline over the source's rows.  When
    `profile` is given, per-stage timings land in
    profile["result_processors"] (reference: per-RP profile sections,
    result_processor.h)."""
    index.commit()
    cq = index.prepare(req.query, req.params, _options(req), req.dialect)
    t_start = time.perf_counter()
    fast = _try_device_group(index, req, cq)
    if fast is not None:
        _count_path("device")
        if profile is not None:
            profile["result_processors"] = [
                {"name": "RP_INDEX+DeviceGroupBy(fused)",
                 "time_ms": round((time.perf_counter() - t_start) * 1e3, 3),
                 "rows": len(fast.rows)}]
        return fast
    t_index0 = time.perf_counter()
    seg_results = _source_results(index, cq)
    total = sum(int(res.count) for _seg, res, _keep in seg_results)
    rows = [r for chunk in _row_chunks(index, seg_results) for r in chunk]
    _count_path("knn" if cq.knn is not None else "host")
    timings = None
    if profile is not None:
        timings = [{"name": "RP_INDEX", "rows": len(rows),
                    "time_ms": round(
                        (time.perf_counter() - t_index0) * 1e3, 3)}]
    rows = _run_steps(index, req, rows, timings=timings)
    if profile is not None:
        profile["result_processors"] = timings
    return AggregateResult(total=total, rows=rows)


def _source_results(index, cq) -> list:
    """Each segment's (segment, SegmentResult, lanes kept) for the host
    rows of a query: a KNN source's `knn.k` nearest (mode "topk"; lanes
    past the live distances dropped), else the window program's valid
    slots (mode "window").  The results are host arrays."""
    out = []
    for seg in index.segments:
        if cq.knn is not None:
            res = execute(cq, seg, cq.knn.k, mode="topk")
            out.append((seg, res, res.knn_dists < 3.3e38))
        else:
            res = execute(cq, seg, 1, mode="window")
            out.append((seg, res, res.valid))
    return out


def _row_chunks(index, seg_results):
    """Host rows of the kept lanes, segment by segment in lane (window)
    order, at most `_STREAM_CHUNK` a chunk; deleted docs are skipped."""
    for seg, res, keep in seg_results:
        sel = res.local_idx[keep]
        scores = res.scores[keep]
        gids = seg.gids_host
        for start in range(0, len(sel), _STREAM_CHUNK):
            rows = []
            for j in range(start, min(start + _STREAM_CHUNK, len(sel))):
                gid = int(gids[int(sel[j])])
                meta = index.doctable.get(gid)
                if meta is None or meta.deleted:
                    continue
                rows.append({"__key": meta.key, "__score": float(scores[j]),
                             "__gid": gid, "__meta": meta})
            if rows:
                yield rows


def run_aggregate_many(index, reqs: list, async_: bool = False):
    """Execute a batch of aggregations: requests with the same plan
    shape and the same per-segment transport-row structure run as one
    group (per segment: the kernel-raw branch, or the window branch), and
    every group's outputs are collected together.  A request without a
    device plan (a KNN source, or steps the device GROUPBY does not
    serve), or in a group `_device_group_submit_batch` turns down, runs
    `run_aggregate` when the batch is collected, after every group has
    launched, in its own place in the output.  With async_=True returns
    a Deferred at once; .result() collects."""
    index.commit()
    prepared = []
    groups: dict = {}
    for req in reqs:
        cq = index.prepare(req.query, req.params, _options(req), req.dialect)
        plan = _plan_device_group_cached(index, req, cq)
        prepared.append((req, cq, plan))
        if plan is None:
            continue
        # batchable = equal plan (the memoized plan object pins step
        # shape, reducers and the tail) AND equal per-segment row
        # structure (group signature + layout fingerprint)
        segsig = []
        for seg in index.segments:
            ent = cq.bind_row(seg)[1]
            segsig.append((ent[6], ent[7]))
        groups.setdefault((id(plan), tuple(segsig)), []).append(
            len(prepared) - 1)

    submitted = []
    for idxs in groups.values():
        sub = _device_group_submit_batch(index, [prepared[i] for i in idxs])
        if sub is not None:
            submitted.append((idxs, sub))

    def fin():
        out: list = [None] * len(prepared)
        for idxs, (handles, seg_outs) in submitted:
            host = [{kk: vv.cpu().numpy() for kk, vv in so.items()}
                    for so in seg_outs]
            for j, (i, h) in enumerate(zip(idxs, handles)):
                group, tail, op_list, mm, rspec, key_parts = h
                parts = [(kp, {kk: vv[j] for kk, vv in hs.items()})
                         for kp, hs in zip(key_parts, host)]
                _count_path("device-tail" if rspec is not None
                            else "device")
                fin_ = (_device_tail_finish if rspec is not None
                        else _device_group_finish)
                out[i] = fin_(index, (group, tail, op_list, mm, rspec,
                                      parts))
        for i, (req, _cq, _plan) in enumerate(prepared):
            if out[i] is None:
                out[i] = run_aggregate(index, req)
        return out

    return Deferred(fin) if async_ else fin()


def _run_steps(index, req: AggregateRequest, rows: list[dict],
               timings: Optional[list] = None) -> list[dict]:
    """The steps of a request over host rows, each stage of
    `_step_stages` drained before the next.  With `timings`, each step
    appends its name, time and output rows."""
    for name, stage in _step_stages(index, req):
        t_step = time.perf_counter()
        rows = [r for chunk in stage(iter([rows])) for r in chunk]
        if timings is not None:
            timings.append({
                "name": name,
                "time_ms": round((time.perf_counter() - t_step) * 1e3, 3),
                "rows": len(rows)})
    _scrub(rows, req)
    return rows


def _step_stages(index, req: AggregateRequest) -> list:
    """Each step of a request as (name, chunk-generator transform).
    Fields a step reads load from the stored docs unless an earlier
    APPLY/GROUPBY produced them (the reference resolves via RLookup:
    sorting vector, loaded doc, or computed key)."""
    stages = []
    produced: set[str] = set()
    for step in req.steps:
        needed = _step_props(step) - produced
        if isinstance(step, LoadStep):
            stage = functools.partial(_gen_materialize, index,
                                      fields=step.fields)
            if step.fields:
                produced |= set(step.fields)
        elif isinstance(step, ApplyStep):
            stage = functools.partial(_gen_apply, step=step)
            produced.add(step.alias)
        elif isinstance(step, FilterStep):
            stage = functools.partial(_gen_filter, step=step)
        elif isinstance(step, GroupStep):
            stage = functools.partial(_gen_group, step=step)
            produced = set(step.by)
            for name, args, alias in step.reducers:
                produced.add(alias or make_reducer(name, args)
                             .default_alias())
        elif isinstance(step, SortStep):
            stage = functools.partial(_gen_sort, step=step)
        elif isinstance(step, LimitStep):
            stage = functools.partial(_gen_limit, step=step)
        else:
            stage = iter
        if needed:
            stage = (lambda chunks, st=stage, f=needed:
                     st(_gen_materialize(index, chunks, f)))
        stages.append((type(step).__name__.replace("Step", "").upper(),
                       stage))
    return stages


def _scrub(rows: list[dict], req: AggregateRequest) -> None:
    """Drop the internal keys of output rows."""
    for row in rows:
        row.pop("__meta", None)
        row.pop("__gid", None)
        if not req.add_scores:
            row.pop("__score", None)


def _step_props(step) -> set[str]:
    if isinstance(step, (ApplyStep, FilterStep)):
        return E.properties(step.parsed)
    if isinstance(step, GroupStep):
        out = set(step.by)
        for _name, args, _ in step.reducers:
            out |= {a.lstrip("@") for a in args
                    if isinstance(a, str) and a.startswith("@")}
            if args and not args[0].startswith("@"):
                out.add(args[0].lstrip("@"))
        return out
    if isinstance(step, SortStep):
        return {k for k, _ in step.keys}
    return set()


def _materialize(index, rows: list[dict],
                 fields: Optional[Sequence[str]]) -> None:
    """Pull stored field values into rows (reference: RP_LOADER)."""
    for row in rows:
        meta = row.get("__meta")
        if meta is None:
            continue
        if fields is None:
            for k, v in meta.fields.items():
                row.setdefault(k, v)
            continue
        for f in fields:
            if f in ("__key", "__score") or f in row:
                continue
            if f == "key" and f not in meta.fields:
                row[f] = meta.key
                continue
            if f in meta.fields:
                row[f] = _coerce(index, f, meta.fields[f])


def _coerce(index, field: str, value):
    f = index.schema.try_field(field)
    if f is not None and f.type == FieldType.NUMERIC:
        try:
            return float(value)
        except (TypeError, ValueError):
            return E.NULL
    return value


def _sort(rows: list[dict], step: SortStep) -> list[dict]:
    """Stable multi-pass sort; a missing value ranks last either way
    (reference: value/src/comparison.rs cmp_fields)."""
    out = rows
    for prop, asc in reversed(step.keys):
        def single(row, p=prop, a=asc):
            v = row.get(p, E.NULL)
            if v is E.NULL:
                return (2, 0.0, "") if a else (-1, 0.0, "")
            n = E._num(v)
            if n is not None:
                return (0, n, "")
            return (1, 0.0, str(v))
        out = sorted(out, key=single, reverse=not asc)
    if step.max:
        out = out[:step.max]
    return out


def _try_device_group(index, req: AggregateRequest, cq):
    """The device GROUPBY of one request: its result, or None when the
    plan is not device-eligible."""
    h = _device_group_submit(index, req, cq)
    if h is None:
        return None
    return _device_group_finish(index, h)


def _key_encoding(index, seg, keyname):
    """Dictionary encoding of a group key column for one segment:
    (value_ids int32[n_pad] with -1 missing, table list).  TAG/TEXT
    sortable columns are already dict-encoded; NUMERIC columns encode
    their unique present values (cached per segment — segments are
    immutable after seal)."""
    f = index.schema.try_field(keyname)
    if f is None:
        return None
    if f.sortable and f.type in (FieldType.TAG, FieldType.TEXT):
        sc = seg.strcols.get(f.attribute)
        if sc is None:
            return None
        return (sc.value_ids, list(sc.table))
    if f.type == FieldType.NUMERIC:
        col = seg.numerics.get(f.attribute)
        if col is None or col.multi:
            return None
        cache = getattr(seg, "_numdict_cache", None)
        if cache is None:
            cache = {}
            seg._numdict_cache = cache
        ent = cache.get(f.attribute)
        if ent is None:
            vals_np = col.values.cpu().numpy()
            pres_np = col.present.cpu().numpy()
            ent = _dict_encode(vals_np, pres_np, seg.device)
            cache[f.attribute] = ent
        return ent
    return None


def _dict_encode(vals_np, pres_np, device):
    """(ids tensor, table) of a numeric column: each present value's
    index among the sorted unique present values, -1 where absent."""
    uniq = np.unique(vals_np[pres_np])
    ids = np.searchsorted(uniq, vals_np).astype(np.int32)
    ids = np.where(pres_np, np.minimum(ids, max(len(uniq) - 1, 0)),
                   -1).astype(np.int32)
    return (torch.as_tensor(ids, device=device), [float(u) for u in uniq])


_MAX_DEVICE_GROUPS = 65536

_PLAN_CACHE: dict = {}


def _plan_sig(req: AggregateRequest):
    """Query-independent signature of the step list (the device plan
    depends only on step structure + schema, not on the query
    string)."""
    parts = []
    for s in req.steps:
        if isinstance(s, GroupStep):
            parts.append(("g", tuple(s.by),
                          tuple((n, tuple(a), al)
                                for n, a, al in s.reducers)))
        elif isinstance(s, SortStep):
            parts.append(("s", tuple(s.keys), s.max))
        elif isinstance(s, LimitStep):
            parts.append(("l", s.offset, s.num))
        elif isinstance(s, ApplyStep):
            parts.append(("a", s.expression, s.alias))
        elif isinstance(s, FilterStep):
            parts.append(("f", s.expression))
        else:
            return None                 # LOAD etc: not device-eligible
    return tuple(parts)


def _plan_device_group_cached(index, req: AggregateRequest, cq):
    """Memoized _plan_device_group (see _plan_sig).  KNN plans bail
    before the cache — eligibility also depends on cq.knn."""
    if cq.knn is not None or not req.steps:
        return None
    sig = _plan_sig(req)
    if sig is None:
        return None
    # field count catches in-place field additions
    key = (id(index.schema), len(index.schema.fields), sig)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit[0]
    plan = _plan_device_group(index, req, cq)
    if len(_PLAN_CACHE) > 4096:
        _PLAN_CACHE.clear()
    _PLAN_CACHE[key] = (plan,)
    return plan


def _plan_device_group(index, req: AggregateRequest, cq):
    """Segment-independent half of the device-GROUPBY eligibility:
    validates the step shape and compiles the pre-expressions.  Returns
    (group, tail, operands, want_minmax, compiled_pre, in_fields,
    pre_sig, key_aliases) or None.

    Eligible plans: [numeric APPLY/FILTER]* -> GROUPBY(1..3 dict-
    encodable keys) with algebraic reducers -> [SORTBY/LIMIT]*."""
    if cq.knn is not None or not req.steps:
        return None
    steps = req.steps
    i = 0
    pre: list = []
    while i < len(steps) and isinstance(steps[i],
                                        (ApplyStep, FilterStep)):
        pre.append(steps[i])
        i += 1
    if i >= len(steps) or not isinstance(steps[i], GroupStep):
        return None
    group = steps[i]
    tail = steps[i + 1:]
    if not all(isinstance(s, (SortStep, LimitStep)) for s in tail):
        return None
    if not 1 <= len(group.by) <= 3:
        return None

    num_fields = {f.attribute for f in index.schema.fields
                  if f.type == FieldType.NUMERIC}
    avail = set(num_fields)
    compiled_pre: list = []      # ("apply", alias, fn) | ("filter", None, fn)
    apply_aliases: set[str] = set()
    for s in pre:
        fn = compile_device_expr(s.parsed, avail)
        if fn is None:
            return None
        if isinstance(s, ApplyStep):
            compiled_pre.append(("apply", s.alias, fn))
            avail.add(s.alias)
            apply_aliases.add(s.alias)
        else:
            compiled_pre.append(("filter", None, fn))

    # computed (APPLY-alias) group keys are evaluated once per (segment,
    # plan) and dictionary-encoded like a numeric key
    key_aliases = frozenset(b for b in group.by if b in apply_aliases)

    operands: list[str] = []     # reducer operand columns, order-stable
    for name, args, _alias in group.reducers:
        nm = name.upper()
        if nm not in GB.DEVICE_REDUCERS:
            return None
        if nm != "COUNT":
            if len(args) != 1:
                return None
            op = args[0].lstrip("@")
            if op not in apply_aliases and op not in num_fields:
                return None
            if op not in operands:
                operands.append(op)
    want_minmax = any(n.upper() in ("MIN", "MAX")
                      for n, _a, _al in group.reducers)

    # numeric field columns the program needs: expr inputs + operands
    in_fields: list[str] = []
    for s in pre:
        for prop in E.properties(s.parsed):
            if prop in num_fields and prop not in in_fields:
                in_fields.append(prop)
    for op in operands:
        if op in num_fields and op not in in_fields:
            in_fields.append(op)

    pre_sig = ";".join(
        f"{k}:{getattr(s, 'alias', '')}:{s.expression}"
        for (k, _a, _f), s in zip(compiled_pre, pre))
    return (group, tail, operands, want_minmax, compiled_pre,
            in_fields, pre_sig, key_aliases)


def _gather_cols(seg_args_, in_fields, cd):
    """Each input numeric field's (values, present) at the window docs;
    the columns themselves when `cd` is None (an iota window)."""
    cols = {}
    for j, nm_ in enumerate(in_fields):
        v = seg_args_["gb_num_vals"][j]
        p = seg_args_["gb_num_pres"][j]
        cols[nm_] = (v, p) if cd is None else (v[cd], p[cd])
    return cols


def _run_pre(compiled_pre, cols, valid, like):
    """The compiled APPLY/FILTER steps over the window's columns."""
    for kind, alias, fn_ in compiled_pre:
        if kind == "apply":
            cols[alias] = fn_(cols)
        else:
            fv, fp = fn_(cols)
            valid = valid & _lanes(fp, like) & _lanes(fv != 0.0, like)
    return valid


def _composite_gid(seg_args_, sizes, cd, like):
    """The composite group id of each window lane (a missing key is the
    key's last value id)."""
    gid = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    for k_, sz_ in enumerate(sizes):
        idk = seg_args_["gb_keys"][k_]
        if cd is not None:
            idk = idk[cd]
        idk = torch.where(idk < 0, sz_ - 1, idk)
        gid = gid * sz_ + idk
    return gid


def _make_fused(cq, raw, G, sizes, in_fields, compiled_pre, operands,
                want_minmax):
    """The per-query fused program: window program -> compiled pre steps
    -> key/operand gathers -> ONE `groupby_aggregate_multi` call (the
    fused B4/B5 kernel) for the base count and every operand.  Shared by
    the single request path and the window branch of the batch path."""
    # match-all roots emit the iota window: every column is already
    # doc-aligned, so no gathers
    iota_root = cq.tree[0] == "leaf" and isinstance(cq.tree[1], LAll)

    def fused(seg_args_, dyn):
        out = raw(seg_args_, dyn)
        docs, valid = out["docs"], out["valid"]
        n_pad_ = seg_args_["gb_keys"].shape[1]
        cd = None if iota_root else docs.clamp(max=n_pad_ - 1).long()
        cols = _gather_cols(seg_args_, in_fields, cd)
        valid = _run_pre(compiled_pre, cols, valid, docs)
        gid = _composite_gid(seg_args_, sizes, cd, docs)
        # an APPLY constant stays a stride-0 view: the kernel reads its
        # one element
        ops = [(_lanes(cols[op_][0], docs), _lanes(cols[op_][1], docs))
               for op_ in operands]
        res = {"count": out["count"]}
        res.update(GB.groupby_aggregate_multi(gid, valid, ops, G,
                                              want_minmax=want_minmax))
        return res

    return fused


def _make_fused_cols(raw, sizes, in_fields, compiled_pre, operands):
    """Window half of the batched program: per query, the pre-masked gid
    slots [1 + n_ops, Wc] and op values [n_ops, Wc] over the query's
    window; the caller stacks a chunk of them for ONE batched group-by
    launch (B3)."""

    def fused(seg_args_, dyn):
        out = raw(seg_args_, dyn)
        docs, valid = out["docs"], out["valid"]
        n_pad_ = seg_args_["gb_keys"].shape[1]
        cd = docs.clamp(max=n_pad_ - 1).long()
        cols = _gather_cols(seg_args_, in_fields, cd)
        valid = _run_pre(compiled_pre, cols, valid, docs)
        gid = _composite_gid(seg_args_, sizes, cd, docs)
        slots = [torch.where(valid, gid, -1)]
        vlist = []
        for op_ in operands:
            v, p = cols[op_]
            slots.append(torch.where(valid & _lanes(p, docs), gid, -1))
            vlist.append(_lanes(v, docs).to(torch.float32))
        return {"count": out["count"], "gslots": torch.stack(slots),
                "vals": (torch.stack(vlist) if vlist
                         else torch.zeros((0,) + tuple(docs.shape),
                                          dtype=torch.float32,
                                          device=docs.device))}

    return fused


#: cap on the elements a batch chunk stages between the two kernels
#: (raw lanes, gid slots, values and the columns of the pre-steps)
_MAX_BATCH_STAGE = 64_000_000


def _seg_posting_cols(index, seg, cq, group, in_fields, sizes,
                      compiled_pre=(), pre_sig="",
                      key_aliases=frozenset()):
    """Posting-ALIGNED device columns for the kernel-raw GROUPBY path:
    the composite group id, and each input numeric field's (value,
    present), gathered once to align with seg.text's posting arrays and
    viewed as [rows, 128].  The raw intersection lanes are pivot-
    posting-row-aligned, so per query these columns are sliced at the
    same rows instead of gathered at [W] random doc ids.  Cached per
    (by-keys, in_fields): segments are immutable after seal.  About 4
    bytes per posting per column of device memory."""
    cache = getattr(seg, "_gbpcols_cache", None)
    if cache is None:
        cache = seg._gbpcols_cache = {}
    ckey = (tuple(group.by), tuple(in_fields),
            pre_sig if key_aliases else "")
    ent = cache.get(ckey)
    if ent is not None:
        return ent
    _key_infos, _sizes, _G, seg_args = _seg_group_args(
        index, seg, cq, group, in_fields, compiled_pre, pre_sig,
        key_aliases)
    n_pad = seg.n_pad
    cd = seg.text.doc_ids.clamp(max=n_pad - 1).long()
    gid = torch.zeros((n_pad,), dtype=torch.int32, device=seg.device)
    for k_, sz_ in enumerate(sizes):
        idk = seg_args["gb_keys"][k_]
        idk = torch.where(idk < 0, sz_ - 1, idk)
        gid = gid * sz_ + idk
    n2 = seg.text.doc_ids.shape[0] // IK.BLK
    cols = {"pgb_gid": gid[cd].reshape(n2, IK.BLK)}
    for j, _nm in enumerate(in_fields):
        cols[f"pgb_v{j}"] = seg_args["gb_num_vals"][j][cd].reshape(
            n2, IK.BLK)
        cols[f"pgb_p{j}"] = seg_args["gb_num_pres"][j][cd].reshape(
            n2, IK.BLK)
    if len(cache) > 4:
        cache.clear()
    cache[ckey] = cols
    return cols


def _lanes(x, like):
    """An expression result (possibly a 0-dim constant on another
    device) broadcast to the lanes `like` covers."""
    return x.to(like.device).expand(like.shape)


def _make_kernel_groupby(kplan, layout, sizes, in_fields, compiled_pre,
                         operands, G, want_sumsq):
    """Batched GROUPBY over the intersection kernel's raw mode: masked
    pivot-window lanes + the posting-aligned (gid, value, present)
    columns at the same rows + ONE batched group-by launch.  Returns the
    fused fn(seg_args, rows [B, total] int32 on the device) and the raw
    lane width."""
    (slot_descs, Ws, kgroups, pivot_g, aux_keys, kdense, dmeta) = kplan
    pivots = list(kgroups[pivot_g][1])
    rowsk = [Ws[t] // IK.BLK + IK.R_EXTRA for t in range(len(slot_descs))]
    W_raw = sum(rowsk[p] for p in pivots) * IK.BLK
    names = (["pgb_gid"]
             + [x for j in range(len(in_fields))
                for x in (f"pgb_v{j}", f"pgb_p{j}")])

    def fused(seg_args_, rows):
        stacked = _device_unpack_rows(layout, rows)
        meta, fmeta, aux_arrs = _kernel_batched_inputs(
            stacked, seg_args_, slot_descs, aux_keys, dmeta)
        docs, _scores, count = IK.intersect_batch(
            meta, fmeta, seg_args_["doc_ids"], seg_args_["freqs"],
            seg_args_["field_masks"], seg_args_["posting_dl"],
            *aux_arrs, T=len(slot_descs), Ws=Ws, groups=kgroups,
            pivot_g=pivot_g, k=16, dense=kdense, raw=True)  # [B, W_raw]
        B = docs.shape[0]
        dev = docs.device
        # the posting-aligned columns at the pivot slots' window rows
        # (the rows the raw lanes cover): one gather of [B, rows, 128]
        # row blocks per pivot, starts clamped as lax.dynamic_slice
        # clamps them
        lane = {}
        for nm in names:
            arr = seg_args_[nm]
            parts = []
            for p in pivots:
                st = torch.div(stacked["tstarts"][:, slot_descs[p][1]],
                               IK.BLK, rounding_mode="floor").long()
                st = st.clamp(0, max(arr.shape[0] - rowsk[p], 0))
                idx = st[:, None] + torch.arange(rowsk[p], device=dev)
                parts.append(arr[idx])
            lane[nm] = torch.cat(parts, dim=1).reshape(B, W_raw)
        valid = docs != IK.INT32_MAX
        cols = {}
        for j, nm in enumerate(in_fields):
            cols[nm] = (lane[f"pgb_v{j}"], lane[f"pgb_p{j}"])
        for kind, alias, fn_ in compiled_pre:
            if kind == "apply":
                cols[alias] = fn_(cols)
            else:
                fv, fp = fn_(cols)
                valid = valid & _lanes(fp, docs) & _lanes(fv != 0.0, docs)
        gid = lane["pgb_gid"]
        slots = [torch.where(valid, gid, -1)]
        vlist = []
        for op_ in operands:
            v, p = cols[op_]
            slots.append(torch.where(valid & _lanes(p, docs), gid, -1))
            vlist.append(_lanes(v, docs).to(torch.float32))
        gs = torch.stack(slots, dim=1)
        vs = (torch.stack(vlist, dim=1) if vlist
              else torch.zeros((B, 0, W_raw), dtype=torch.float32,
                               device=dev))
        res = {"count": count}
        res.update(GB.groupby_aggregate_batch(gs, vs, G,
                                              want_sumsq=want_sumsq))
        return res

    return fused, W_raw


#: device-tail head size cap: SORT/LIMIT tails needing more rows than
#: this take the full [G] stat arrays to the host instead
_TAIL_CAP = 256


def _plan_device_tail(group, tail):
    """Whether the SORTBY/LIMIT tail runs on the device so only the
    surviving rows are copied to the host.  Eligible tails: an optional
    single-key SORTBY over a reducer alias, followed by LIMITs, with a
    bounded head (max/offset+num <= cap).  Returns (K_needed,
    sort_alias | None, ascending) or None.  The host replays the LIMIT
    arithmetic over the sorted head (reference semantics: ARRANGE steps
    apply in plan order, src/aggregate/aggregate_plan.h:28-38)."""
    if not tail:
        return None              # unbounded output: need every group
    steps = list(tail)
    sort = None
    if isinstance(steps[0], SortStep):
        sort = steps[0]
        if len(sort.keys) != 1:
            return None          # multi-key lexsort stays host-side
        steps = steps[1:]
    if not all(isinstance(s, LimitStep) for s in steps):
        return None              # LIMIT-then-SORT picks by id order
    need = []
    if sort is not None and sort.max:
        need.append(int(sort.max))
    need.extend(int(s.offset + s.num) for s in steps)
    if not need:
        return None
    K = min(need)
    if K <= 0 or K > _TAIL_CAP:
        return None
    sort_alias, asc = None, True
    if sort is not None:
        prop, asc = sort.keys[0]
        aliases = {al or make_reducer(nm, list(args)).default_alias()
                   for nm, args, al in group.reducers}
        if prop not in aliases:
            return None          # group-key / unknown sorts stay host
        sort_alias = prop
    return (K, sort_alias, asc)


def _device_red_specs(group, operands):
    """Reducer output columns in row order: [(alias, NAME, op_index)],
    op_index = position in `operands` (None for COUNT).  Mirrors the
    host column builder in _device_group_finish."""
    specs = []
    for name, args, alias in group.reducers:
        nm = name.upper()
        alias = alias or make_reducer(name, list(args)).default_alias()
        opj = (None if nm == "COUNT"
               else operands.index(str(args[0]).lstrip("@")))
        specs.append((alias, nm, opj))
    return specs


def _make_device_tail(G, dtail, red_specs):
    """On-device SORT/LIMIT head: [B, G] stats -> top-K rows.  Returns a
    fn mapping the stat dict to the compact output dict:
    {"count": [B], "t.sel": [B, K] group ids, "t.ok": [B, K] live flags,
    "t.{i}.val"/"t.{i}.null": [B, K] per reducer row i}.

    Ordering contract matches the host finish exactly: absent groups
    (count 0) drop, NULL reducer values rank last regardless of
    direction, ties keep ascending group id (a stable descending sort;
    torch.topk leaves the order of ties undefined)."""
    K, sort_alias, asc = dtail
    Ke = int(min(K, G))
    f32 = torch.float32

    def tailfn(res):
        base_cnt = res["g.None.count"]              # [B, G]
        present = base_cnt > 0

        cols = {}
        for alias, nm, opj in red_specs:
            if alias in cols:
                continue
            tag = "None" if opj is None else str(opj)
            c = res[f"g.{tag}.count"]
            if nm == "COUNT":
                vals, nulls = base_cnt, ~present
            elif nm == "SUM":
                vals, nulls = res[f"g.{tag}.sum"], ~present
            elif nm == "AVG":
                vals = torch.where(
                    c > 0, res[f"g.{tag}.sum"] / torch.clamp(c, min=1.0),
                    0.0)
                nulls = c == 0
            elif nm == "MIN":
                vals, nulls = res.get(f"g.{tag}.min", c), c == 0
            elif nm == "MAX":
                vals, nulls = res.get(f"g.{tag}.max", c), c == 0
            else:  # STDDEV
                s = res[f"g.{tag}.sum"]
                var = ((res[f"g.{tag}.sumsq"]
                        - s * s / torch.clamp(c, min=1.0))
                       / torch.clamp(c - 1.0, min=1.0))
                vals = torch.where(
                    c >= 2.0, torch.sqrt(torch.clamp(var, min=0.0)), 0.0)
                nulls = c == 0
            cols[alias] = (vals, nulls)

        if sort_alias is None:
            # LIMIT only: first present groups in ascending id order
            score = -torch.arange(G, dtype=f32, device=base_cnt.device
                                  ).expand(base_cnt.shape)
        else:
            v, nl = cols[sort_alias]
            score = torch.where(nl, -1e37, v if not asc else -v)
        score = torch.where(present, score, -3.4e38).to(f32)
        _sv, sel = torch.sort(score, dim=1, descending=True, stable=True)
        sel = sel[:, :Ke]
        out = {"count": res["count"], "t.sel": sel,
               "t.ok": torch.gather(present, 1, sel)}
        for i, (alias, _nm, _opj) in enumerate(red_specs):
            v, nl = cols[alias]
            out[f"t.{i}.val"] = torch.gather(v, 1, sel)
            out[f"t.{i}.null"] = torch.gather(nl, 1, sel)
        return out

    return tailfn


_TARR_CACHE: dict = {}


def _tail_decode_arrays(key_infos):
    """Cached per-key object decode arrays + composite-id geometry for
    the compact tail finish.  The cache is keyed by the tables' ids, so
    each entry holds its tables: a table of a dropped or compacted index
    stays alive while cached and no new table can take its id."""
    ck = tuple(id(t) for _ids, t in key_infos)
    ent = _TARR_CACHE.get(ck)
    if ent is None:
        tables = [list(t) for _ids, t in key_infos]
        gsizes = [len(t) + 1 for t in tables]
        tarrs = [np.array(t + [None], dtype=object) for t in tables]
        divs = []
        for d in range(len(gsizes)):
            div = 1
            for dd in range(d + 1, len(gsizes)):
                div *= gsizes[dd]
            divs.append(div)
        if len(_TARR_CACHE) > 64:
            _TARR_CACHE.clear()
        ent = (gsizes, tarrs, divs, [t for _ids, t in key_infos])
        _TARR_CACHE[ck] = ent
    return ent[:3]


def _device_tail_finish(index, h) -> "AggregateResult":
    """Materialize an AggregateResult from the compact device-tail
    output: decode the K surviving group ids' key values, replay the
    LIMIT arithmetic over the already-sorted head."""
    group, tail, _op_list, _mm, red_specs, parts = h
    (key_infos, _sizes), out = parts[0]
    total = int(out["count"])
    gsizes, tarrs, divs = _tail_decode_arrays(key_infos)
    ok = np.asarray(out["t.ok"], bool)
    n_ok = int(ok.sum())                        # ok rows form a prefix
    sel = np.asarray(out["t.sel"], np.int64)[:n_ok]

    key_vals = [tarrs[d][(sel // divs[d]) % gsizes[d]]
                for d in range(len(gsizes))]
    by_names = list(group.by)
    rows = []
    for i in range(len(sel)):
        row = {b: key_vals[d][i] for d, b in enumerate(by_names)}
        for j, (alias, _nm, _opj) in enumerate(red_specs):
            row[alias] = (E.NULL if out[f"t.{j}.null"][i]
                          else float(out[f"t.{j}.val"][i]))
        rows.append(row)
    for step in tail:
        if isinstance(step, SortStep):
            if step.max:
                rows = rows[:step.max]
        else:
            rows = rows[step.offset:step.offset + step.num]
    return AggregateResult(total=total, rows=rows)


def _alias_key_encoding(seg, compiled_pre, in_fields, aliases):
    """Dictionary encoding of computed (APPLY-alias) group-key columns
    for one segment: evaluate the compiled pre-chain over the segment's
    numeric columns once, then dict-encode each needed alias column
    exactly like a numeric key (_key_encoding).  One-time per (segment,
    plan) — cached by the _gbcols_cache around it."""
    env = {f: (seg.numerics[f].values, seg.numerics[f].present)
           for f in in_fields if f in seg.numerics}
    like = torch.zeros((seg.n_pad,), dtype=torch.float32, device=seg.device)
    encs = {}
    for kind, alias, fn in compiled_pre:
        if kind != "apply":
            continue
        va, pa = fn(env)
        va = _lanes(va, like).to(torch.float32)
        pa = _lanes(pa, like)
        env[alias] = (va, pa)
        if alias in aliases:
            encs[alias] = _dict_encode(va.cpu().numpy(), pa.cpu().numpy(),
                                       seg.device)
    return encs


def _seg_group_args(index, seg, cq, group, in_fields,
                    compiled_pre=(), pre_sig="",
                    key_aliases=frozenset()):
    """Per-segment GROUPBY eligibility + device args: returns
    (key_infos, sizes, G, seg_args) or None (unencodable key / too many
    groups).  The stacked device columns are cached per (segment,
    by-keys, in_fields, pre-chain) — segments are immutable after
    seal."""
    cache = getattr(seg, "_gbcols_cache", None)
    if cache is None:
        cache = seg._gbcols_cache = {}
    ckey = (tuple(group.by), tuple(in_fields),
            pre_sig if key_aliases else "")
    ent = cache.get(ckey)
    if ent is None:
        alias_encs = (_alias_key_encoding(seg, compiled_pre, in_fields,
                                          key_aliases)
                      if key_aliases else {})
        key_infos = []
        for b in group.by:
            enc = (alias_encs.get(b) if b in key_aliases
                   else _key_encoding(index, seg, b))
            if enc is None:
                return None
            key_infos.append(enc)
        sizes = tuple(len(t) + 1 for _ids, t in key_infos)  # +1 missing
        G = 1
        for s_ in sizes:
            G *= s_
        if G > _MAX_DEVICE_GROUPS:
            return None
        dev = seg.device
        num_vals = (torch.stack([seg.numerics[o].values for o in in_fields])
                    if in_fields
                    else torch.zeros((0, seg.n_pad), dtype=torch.float32,
                                     device=dev))
        num_pres = (torch.stack([seg.numerics[o].present
                                 for o in in_fields])
                    if in_fields
                    else torch.zeros((0, seg.n_pad), dtype=torch.bool,
                                     device=dev))
        gb_keys = torch.stack([ids for ids, _t in key_infos])
        ent = (key_infos, sizes, G, gb_keys, num_vals, num_pres)
        if len(cache) > 32:
            cache.clear()
        cache[ckey] = ent
    key_infos, sizes, G, gb_keys, num_vals, num_pres = ent
    seg_args = dict(_segment_args(cq, seg))
    seg_args["gb_keys"] = gb_keys
    seg_args["gb_num_vals"] = num_vals
    seg_args["gb_num_pres"] = num_pres
    return key_infos, sizes, G, seg_args


def _chunk_size(W_raw: int, n_ops: int, n_in: int) -> int:
    """Queries per chunk: the largest power of two <= 1024 whose staged
    elements (raw lanes, gid slots, values, pre-step columns) stay under
    _MAX_BATCH_STAGE.  The JAX package turns the kernel-raw branch off
    above that cap at 1024 queries (its scalar-memory chunk); the port
    runs smaller chunks instead — an executor detail, the results are
    the same."""
    Cp = 1024
    while Cp > 1 and Cp * W_raw * (2 + 3 * n_ops + 2 * n_in) \
            > _MAX_BATCH_STAGE:
        Cp //= 2
    return Cp


def _device_group_submit_batch(index, items):
    """Launch a group of same-shape GROUPBYs (equal plan, equal
    transport-row structure) on every segment: one upload of the group's
    rows, then per chunk either the kernel-raw branch (raw intersection,
    column slices, one group-by launch) or the window branch (the window
    program per query, then one batched group-by launch when the chunk's
    staged windows fit `_MAX_BATCH_STAGE`, else the single-query kernels
    per query), and the device tail when the plan has one.  Returns (one
    handle per query, per-segment output dicts of [B, ...] device
    tensors), or None when a segment cannot encode the group keys or
    has more than `_MAX_DEVICE_GROUPS` groups, or when a segment is cold
    (its windows are paged a request at a time, `_device_group_submit`)."""
    if any(seg.cold for seg in index.segments):
        return None
    _req0, cq0, plan0 = items[0]
    (group0, tail0, operands, want_minmax, compiled_pre, in_fields,
     pre_sig, key_aliases) = plan0
    want_sumsq = any(n.upper() == "STDDEV"
                     for n, _a, _al in group0.reducers)
    # on-device SORT/LIMIT head (single segment only — the tail must see
    # the cross-segment merge)
    dtail = (_plan_device_tail(group0, tail0)
             if len(index.segments) == 1 else None)
    red_specs = (_device_red_specs(group0, list(operands))
                 if dtail is not None else None)
    B = len(items)
    key_parts, seg_outs = [], []
    for seg in index.segments:
        ga = _seg_group_args(index, seg, cq0, group0, in_fields,
                             compiled_pre, pre_sig, key_aliases)
        if ga is None:
            return None
        key_infos, sizes, G, seg_args = ga
        rows = np.stack([cq.bind_row(seg)[0] for _r, cq, _p in items])
        ent = cq0.bind_row(seg)[1]
        layout, buckets, P2 = ent[2], ent[4], ent[5]
        # the kernel-raw branch: no MIN/MAX, and an intersection-kernel
        # plan whose pivots are text slots
        kplan = None if want_minmax else _kernel_plan(cq0, seg, buckets, 16)
        if kplan is not None and not all(
                kplan[0][p][0] == "t" for p in kplan[2][kplan[3]][1]):
            kplan = None
        tailfn = (None if dtail is None
                  else _make_device_tail(G, dtail, red_specs))
        rows_d = torch.from_numpy(rows).to(seg.device)
        outs = []
        if kplan is not None:
            seg_args.update(_seg_posting_cols(
                index, seg, cq0, group0, in_fields, sizes, compiled_pre,
                pre_sig, key_aliases))
            fused, W_raw = _make_kernel_groupby(
                kplan, layout, sizes, in_fields, compiled_pre, operands, G,
                want_sumsq)
            Cp = _chunk_size(W_raw, len(operands), len(in_fields))
            for c0 in range(0, B, Cp):
                res = fused(seg_args, rows_d[c0:c0 + Cp])
                outs.append(res if tailfn is None else tailfn(res))
        else:
            raw = _program(cq0, seg, buckets, P2, 1, False, "window")
            # the JAX package's power-of-two batch cut at its 1024-query
            # chunk: the staging test below is the JAX one
            Cp = min(int(next_pow2(B)), 1024)
            Wc = _window_width(cq0.tree, buckets, seg.n_pad)
            S = 1 + len(operands)
            use_batch_kernel = (not want_minmax
                                and Cp * Wc * (S + max(S - 1, 1))
                                <= _MAX_BATCH_STAGE)
            if use_batch_kernel:
                fused = _make_fused_cols(raw, sizes, in_fields,
                                         compiled_pre, operands)
            else:
                fused = _make_fused(cq0, raw, G, sizes, in_fields,
                                    compiled_pre, operands, want_minmax)
            for c0 in range(0, B, Cp):
                stacked = _device_unpack_rows(layout, rows_d[c0:c0 + Cp])
                per_q = [fused(seg_args, {kk: vv[i]
                                          for kk, vv in stacked.items()})
                         for i in range(min(Cp, B - c0))]
                res = {kk: torch.stack([r[kk] for r in per_q])
                       for kk in per_q[0]}
                if use_batch_kernel:
                    gs, vs = res.pop("gslots"), res.pop("vals")
                    res.update(GB.groupby_aggregate_batch(
                        gs, vs, G, want_sumsq=want_sumsq))
                outs.append(res if tailfn is None else tailfn(res))
        seg_outs.append({kk: torch.cat([o[kk] for o in outs])
                         for kk in outs[0]})
        key_parts.append((key_infos, sizes))
    handles = [(group0, tail0, operands, want_minmax,
                red_specs if dtail is not None else None, key_parts)
               for _item in items]
    return handles, seg_outs


def _device_group_submit(index, req: AggregateRequest, cq):
    """One request's device GROUPBY on every segment: the window program
    and `_make_fused` (the fused B4/B5 kernel), its outputs copied to the
    host in one tensor per segment.  Returns the finish handle, or None
    when the plan is not device-eligible."""
    plan = _plan_device_group_cached(index, req, cq)
    if plan is None:
        return None
    (group, tail, operands, want_minmax, compiled_pre, in_fields,
     pre_sig, key_aliases) = plan
    parts = []
    for seg in index.segments:
        ga = _seg_group_args(index, seg, cq, group, in_fields,
                             compiled_pre, pre_sig, key_aliases)
        if ga is None:
            return None
        key_infos, sizes, G, seg_args = ga
        binding, P = cq.bind(seg)
        dyn = binding.dyn
        dyn.pop("_tagL", None)
        buckets = dyn.pop("_buckets")
        if seg.cold:
            slabs, dyn, _sig = _cold_slab_args(cq, seg, dyn, buckets)
            seg_args.update(slabs)
        raw = _program(cq, seg, buckets, P, 1, False, "window")
        fused = _make_fused(cq, raw, G, sizes, in_fields, compiled_pre,
                            operands, want_minmax)
        layout, total = _layout_of(dyn)
        buf = _pack_into(layout, dyn, np.zeros(total, np.int32))
        flat, out_layout = _pack_out(fused(
            seg_args, _device_unpack(layout,
                                     torch.from_numpy(buf).to(seg.device))))
        parts.append(((key_infos, sizes),
                      _unpack_out(flat.cpu().numpy(), out_layout)))
    return (group, tail, operands, want_minmax, None, parts)


def _device_group_finish(index, h) -> "AggregateResult":
    """Collect phase: merge every segment's per-group [G] stat arrays
    with numpy scatter-reductions, run the SORT/LIMIT tail over arrays
    (np.lexsort), and decode group keys only for the rows that survive
    the tail."""
    group, tail, op_list, want_minmax, _unused, parts = h
    total = 0
    outs = []
    for (key_infos, sizes), out in parts:
        total += int(out["count"])
        outs.append((key_infos, sizes, out))

    stat_names = ("count", "sum", "sumsq") + (
        ("min", "max") if want_minmax else ())
    ops: list = [None] + list(op_list)

    def _seg_stats(out):
        st = {}
        for j, op in enumerate(ops):
            tag = "None" if op is None else str(j - 1)
            st[op] = {s: np.asarray(out[f"g.{tag}.{s}"], np.float64)
                      for s in stat_names if f"g.{tag}.{s}" in out}
        return st

    if len(outs) == 1:
        key_infos0, _sizes0, out0 = outs[0]
        tables = [list(t) for _ids, t in key_infos0]
        stats = _seg_stats(out0)
    else:
        # cross-segment merge: per-key global tables = union of the
        # per-segment dictionaries; remap each segment's composite group
        # ids into the global id space, then scatter-reduce its arrays.
        K = len(outs[0][1])
        tables = [np.unique(np.concatenate(
            [np.asarray(ki[d][1]) for ki, _s, _o in outs])).tolist()
            for d in range(K)]
        gsizes = [len(t) + 1 for t in tables]
        G = int(np.prod(gsizes))
        stats = {op: {} for op in ops}
        for op in ops:
            for s in stat_names:
                if op is None and s in ("min", "max"):
                    continue       # the base COUNT op carries no min/max
                stats[op][s] = (np.full(G, 3.4e38) if s == "min" else
                                np.full(G, -3.4e38) if s == "max" else
                                np.zeros(G))
        for key_infos, sizes, out in outs:
            sst = _seg_stats(out)
            nz = np.nonzero(sst[None]["count"] > 0)[0]
            if nz.size == 0:
                continue
            g = nz.copy()
            dims = []
            for d in range(K - 1, -1, -1):
                g, r = np.divmod(g, sizes[d])
                loc = list(key_infos[d][1])
                if loc:
                    remap = np.searchsorted(np.asarray(tables[d]),
                                            np.asarray(loc))
                    gr = np.where(r < len(loc),
                                  remap[np.minimum(r, len(loc) - 1)],
                                  len(tables[d]))
                else:
                    gr = np.full(nz.shape, len(tables[d]), np.int64)
                dims.append(gr)
            dims.reverse()
            ggid = np.zeros(nz.shape, np.int64)
            for d in range(K):
                ggid = ggid * gsizes[d] + dims[d]
            for op in ops:
                for s, arr in sst[op].items():
                    if s not in stats[op]:
                        continue
                    v = arr[nz]
                    if s == "min":
                        np.minimum.at(stats[op][s], ggid, v)
                    elif s == "max":
                        np.maximum.at(stats[op][s], ggid, v)
                    else:
                        np.add.at(stats[op][s], ggid, v)

    gsizes = [len(t) + 1 for t in tables]
    base_cnt = stats[None]["count"]
    present = base_cnt > 0

    # reducer output columns over the full [G] group space
    red_cols: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    red_order: list[str] = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, args, alias in group.reducers:
            nm = name.upper()
            alias = alias or make_reducer(name, list(args)).default_alias()
            op = None if nm == "COUNT" else str(args[0].lstrip("@"))
            st = stats.get(op) or stats[None]
            c = st["count"]
            if nm == "COUNT":
                vals, nulls = c, ~present
            elif nm == "SUM":
                vals, nulls = st["sum"], ~present
            elif nm == "AVG":
                vals = np.where(c > 0, st["sum"] / np.maximum(c, 1.0), 0.0)
                nulls = c == 0
            elif nm == "MIN":
                vals, nulls = st.get("min", c), c == 0
            elif nm == "MAX":
                vals, nulls = st.get("max", c), c == 0
            else:  # STDDEV
                var = ((st["sumsq"] - st["sum"] ** 2 / np.maximum(c, 1.0))
                       / np.maximum(c - 1.0, 1.0))
                vals = np.where(c >= 2, np.sqrt(np.maximum(var, 0.0)), 0.0)
                nulls = c == 0
            red_cols[alias] = (vals, nulls)
            if alias not in red_order:
                red_order.append(alias)

    def key_col(d: int, idxs: np.ndarray):
        """Decoded group-key column d at `idxs` as an object array
        (None = missing, matching E.NULL)."""
        div = 1
        for dd in range(d + 1, len(gsizes)):
            div *= gsizes[dd]
        r = (idxs // div) % gsizes[d]
        tarr = np.array(list(tables[d]) + [None], dtype=object)
        return tarr[r], r == len(tables[d])

    def key_rank(d: int):
        """Per-local-id sort rank for key column d (tables aren't
        necessarily sorted; rank via argsort once per column)."""
        tbl = tables[d]
        rank = np.zeros(len(tbl) + 1, np.float64)
        if tbl:
            order = np.argsort(np.asarray(tbl), kind="stable")
            rank[order] = np.arange(len(tbl), dtype=np.float64)
        return rank

    sel = np.nonzero(present)[0]
    by_names = list(group.by)
    for step in tail:
        if isinstance(step, LimitStep):
            sel = sel[step.offset:step.offset + step.num]
            continue
        # SortStep: np.lexsort uses the LAST column as primary — emit
        # (value, null-tier) pairs from the least-significant key up.
        # NULLs rank last regardless of direction (reference:
        # value/src/comparison.rs cmp_fields), hence the un-negated tier.
        lex = []
        for prop, asc in reversed(step.keys):
            if prop in red_cols:
                vals, nulls = red_cols[prop]
                v, nl = vals[sel].astype(np.float64), nulls[sel]
            elif prop in by_names:
                d = by_names.index(prop)
                div = 1
                for dd in range(d + 1, len(gsizes)):
                    div *= gsizes[dd]
                r = (sel // div) % gsizes[d]
                v, nl = key_rank(d)[r], r == len(tables[d])
            else:   # unknown property: NULL everywhere, stable order
                v = np.zeros(sel.shape, np.float64)
                nl = np.ones(sel.shape, bool)
            lex.append(np.where(nl, 0.0, v if asc else -v))
            lex.append(nl)
        if lex:
            sel = sel[np.lexsort(lex)]
        if step.max:
            sel = sel[:step.max]

    key_vals = [key_col(d, sel)[0] for d in range(len(by_names))]
    red_sel = [(alias, red_cols[alias][0][sel], red_cols[alias][1][sel])
               for alias in red_order]
    rows = []
    for i in range(len(sel)):
        row = {b: key_vals[d][i] for d, b in enumerate(by_names)}
        for alias, va, nu in red_sel:
            row[alias] = E.NULL if nu[i] else float(va[i])
        rows.append(row)
    return AggregateResult(total=total, rows=rows)


# ---------------------------------------------------------------------------
# Streaming execution (WITHCURSOR): the input side yields row-dict chunks
# lazily and APPLY/FILTER/GROUP consume them incrementally — the analog of
# the reference coordinator's RPNet pulling shard cursor chunks into the
# local pipeline (src/coord/rpnet.c:268-420).  SORT (and group
# finalization) are the only barriers.
# ---------------------------------------------------------------------------


def run_aggregate_streaming(index, req: AggregateRequest):
    """Returns (chunk_iterator, total) for cursor-driven plans.

    Device-eligible GROUPBYs and KNN plans produce small outputs and run
    materialized; everything else streams: the window program runs per
    segment up front (the total comes from its counts, and its outputs
    are host arrays), but row-dict construction and the host steps pull
    chunk by chunk — a LIMIT that fills early never touches the remaining
    rows."""
    index.commit()
    cq = index.prepare(req.query, req.params, _options(req), req.dialect)

    fast = _try_device_group(index, req, cq)
    if fast is not None:
        return iter([fast.rows]), fast.total
    if cq.knn is not None:
        res = run_aggregate(index, req)
        return iter([res.rows]), res.total

    seg_results = _source_results(index, cq)
    total = sum(int(res.count) for _seg, res, _keep in seg_results)
    return _steps_streaming(index, req, _row_chunks(index, seg_results)), \
        total


def _steps_streaming(index, req: AggregateRequest, chunks):
    """Compose the step chain as chunk generators (`_step_stages`)."""
    for _name, stage in _step_stages(index, req):
        chunks = stage(chunks)
    return _gen_scrub(chunks, req)


def _gen_materialize(index, chunks, fields):
    for rows in chunks:
        _materialize(index, rows, fields)
        yield rows


def _gen_apply(chunks, step):
    for rows in chunks:
        for row in rows:
            row[step.alias] = E.evaluate(step.parsed, row)
        yield rows


def _gen_filter(chunks, step):
    for rows in chunks:
        out = [r for r in rows
               if E._truthy(E.evaluate(step.parsed, r))]
        if out:
            yield out


def _gen_group(chunks, step):
    """Incremental grouping in first-seen order: accumulators update per
    chunk; finalized group rows stream out once the input drains (the
    reference Grouper, group_by.c:63-158, also yields groups only at
    upstream EOF)."""
    groups: dict[tuple, tuple] = {}
    for rows in chunks:
        for row in rows:
            key = tuple(tuple(v) if isinstance(v, list) else v
                        for v in (row.get(b, E.NULL) for b in step.by))
            ent = groups.get(key)
            if ent is None:
                ent = ({b: row.get(b, E.NULL) for b in step.by},
                       [make_reducer(n, a) for n, a, _ in step.reducers])
                groups[key] = ent
            for red in ent[1]:
                red.add(row)
    out = []
    for grow, reds in groups.values():
        for (_name, _args, alias), red in zip(step.reducers, reds):
            grow[alias or red.default_alias()] = red.finalize()
        out.append(grow)
        if len(out) >= _STREAM_CHUNK:
            yield out
            out = []
    if out:
        yield out


def _gen_sort(chunks, step):
    rows: list[dict] = []
    for c in chunks:
        rows.extend(c)
    rows = _sort(rows, step)
    for start in range(0, len(rows), _STREAM_CHUNK):
        yield rows[start:start + _STREAM_CHUNK]


def _gen_limit(chunks, step):
    """Early-terminating LIMIT: once offset+num rows have streamed out,
    the upstream generators are never pulled again."""
    skip = step.offset
    want = step.num
    for rows in chunks:
        if want <= 0:
            return
        if skip >= len(rows):
            skip -= len(rows)
            continue
        rows = rows[skip:]
        skip = 0
        if len(rows) > want:
            rows = rows[:want]
        want -= len(rows)
        yield rows
        if want <= 0:
            return


def _gen_scrub(chunks, req):
    for rows in chunks:
        _scrub(rows, req)
        yield rows
