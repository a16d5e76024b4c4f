"""Distributed query execution over a mesh of device slots.

Counterpart of `redisearch_tpu/parallel/dist.py`, the replacement for
the reference's cluster coordinator and RMR MapReduce engine (SURVEY.md
§2.5/§2.6: src/coord/rmr/, dist_aggregate.c, module.c
searchResultReducer).  As there, one process drives every shard (a
single controller); the mapping:

    hash-slot document partitioning  -> round-robin doc sharding over the
                                        mesh's slots (each slot's device
                                        holds one sub-segment)
    MR_Fanout + reducer callbacks    -> the same window program
                                        (`query.engine._program`, mode
                                        "topk") run on every shard's
                                        segment, on its device
    sorted-merge of shard replies    -> each shard's top k_local lanes
                                        moved to the coordinator (slot
                                        0's device), then one two-key
                                        merge there
    KNN shard-window ratio           -> per-shard top-ceil(k*ratio)
                                        before the gather (shard_k_ratio)

Where the port differs, and why no result does:

* A mesh is a list of device slots, not an XLA mesh: one device may
  fill several slots.  On a machine with several cards the slots take
  them round-robin; on one card every shard lives on it and nothing is
  copied between devices; on the CPU (`make_mesh(device="cpu")`) every
  slot is the CPU.
* The JAX function stacks the shards' arguments padded to the largest
  shape and runs one program, built from shard 0, under `shard_map`.
  Here each shard runs the program of its own segment state (the
  program cache shares one between shards of equal state), and its
  output lanes are padded to the widest shard's with the filler every
  result builder drops.  Padded docs are dead in the JAX function, so
  the lanes that survive are the same.
* The merge orders by (primary key, gid) as `lax.sort(num_keys=2)`
  does, in one sort of an int64 key: the primary key's order-preserving
  int32 code above the gid.  lax.sort canonicalizes before it compares
  (-0.0 ties with +0.0, so such ties fall to the gid; NaN sorts last),
  and so does the code.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..index.builder import SegmentBuilder
from ..index.segment import _SEG_UIDS, Segment, next_pow2
from ..query.engine import (CompiledQuery, _device_unpack,
                            _device_unpack_rows, _layout_of, _pack_into,
                            _program, _segment_args)

AXIS = "shards"
DCN_AXIS = "dcn"
#: slots of `make_mesh(device="cpu")` when no count is given: the JAX
#: package's CPU mesh, the eight virtual devices its test configuration
#: makes XLA expose, so that `ShardedIndex.build(ix)` splits a CPU index
#: into as many shards in both packages
CPU_SLOTS = 8
#: lane fillers of the gathered outputs (the result builders drop them)
_FILL = 3.4e38


class _BatchFallback(Exception):
    """Internal: batch shape unsupported — run queries one by one."""


@dataclasses.dataclass(eq=False)
class Mesh:
    """Device slots for doc-axis sharding: `devices` is an object array
    of torch.device of shape (S,) or (n_dcn, S // n_dcn), its axes named
    by `axis_names` (("shards",) or ("dcn", "shards"))."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def slots(self) -> list:
        """The slots' devices in shard order; slot 0 is the coordinator."""
        return list(self.devices.reshape(-1))


def make_mesh(n_shards: Optional[int] = None, n_dcn: int = 1,
              device=None) -> Mesh:
    """Device slots for doc-axis sharding.

    The slots take the cards round-robin (`device` None or "cuda"), one
    card (`device="cuda:i"`), or the CPU (`device="cpu"`); without a card
    and without `device` this raises, as `index.index.default_device`
    does.  `n_shards` defaults to the number of cards, or CPU_SLOTS on
    the CPU.  n_dcn > 1 builds a 2D ("dcn", "shards") mesh modeling a
    multi-slice deployment: the query merge then runs hierarchically,
    first within each slice of the outer axis, then across them (SURVEY
    §5.8 / §2.6 mapping)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        devs = [torch.device("cpu")]
        n = n_shards or CPU_SLOTS
    else:
        if not torch.cuda.is_available():
            from ..index.index import default_device
            default_device()                    # raises: no card
        if dev is not None and dev.index is not None:
            devs = [dev]
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        n = n_shards or len(devs)
    if n_dcn > 1 and n % n_dcn:
        raise ValueError(f"n_dcn={n_dcn} does not divide n_shards={n}")
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = devs[i % len(devs)]
    if n_dcn > 1:
        return Mesh(arr.reshape(n_dcn, n // n_dcn), (DCN_AXIS, AXIS))
    return Mesh(arr, (AXIS,))


def _moved(obj, device: torch.device):
    """`obj` with every tensor it holds (through dataclasses and dicts)
    copied to `device`; private caches start empty."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: ({} if f.name.startswith("_")
                     else _moved(getattr(obj, f.name), device))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def segment_to(seg: Segment, device) -> Segment:
    """The segment on `device` (itself when it is there already), as a
    new segment with a fresh uid."""
    device = torch.device(device)
    if seg.device == device:
        return seg
    out = _moved(seg, device)
    out.device = device
    out.uid = next(_SEG_UIDS)
    return out


def _stack_pad(tensors: list, fill, device) -> torch.Tensor:
    """Stack per-shard tensors on `device` along a new axis 0, the last
    axis padded with `fill` to the longest (the JAX function pads the
    shards' inputs to the largest shape; here their lane outputs)."""
    n = max(t.shape[-1] for t in tensors)
    out = []
    for t in tensors:
        t = t.to(device)
        if t.shape[-1] < n:
            t = torch.cat([t, torch.full(t.shape[:-1] + (n - t.shape[-1],),
                                         fill, dtype=t.dtype, device=device)],
                          dim=-1)
        out.append(t)
    return torch.stack(out)


def _tree_stack(dicts: list[dict], fills: dict, device) -> dict:
    """Per-shard output dicts stacked key by key on `device`: lane keys
    padded with their filler, the counts stacked."""
    return {k: (_stack_pad([d[k] for d in dicts], fills[k], device)
                if k in fills else
                torch.stack([d[k].to(device) for d in dicts]))
            for k in dicts[0]}


def _f2code(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 code of f32 values, in `lax.sort`'s order:
    it canonicalizes zeros and NaNs before comparing, so -0.0 ties with
    +0.0 and every NaN sorts last.  On the canonical values the code is
    csrc/groupby.cu's f2code."""
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x)
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _merge2(cols: tuple, k_out: int) -> tuple:
    """k-merge with the single-index tie-break along the last axis:
    ascending primary key (cols[0]), then ascending gid (cols[1]); the
    other columns ride along.  `lax.top_k` alone would break ties by
    shard order and diverge from the local path."""
    key = ((_f2code(cols[0]).to(torch.int64) << 32)
           | (cols[1].to(torch.int64) + 2 ** 31))
    order = torch.argsort(key, dim=-1, stable=True)[..., :k_out]
    return tuple(torch.gather(c, -1, order) for c in cols)


def _widen(buckets: dict, bk: dict) -> None:
    """Window buckets widened in place to the element-wise maximum with
    one binding's `bk` (the JAX function's stacked arguments pad every
    shard to the widest)."""
    for idx, t in bk.items():
        cur = buckets.get(idx)
        buckets[idx] = (t if cur is None else
                        tuple(max(a, c) for a, c in zip(t, cur)))


def _with_gids(seg: Segment, out: dict) -> dict:
    """Local idx -> global doc id on the shard's device (clamped, as
    XLA clamps a gather's out-of-range index)."""
    out = dict(out)
    idx = out.pop("idx").clamp(0, seg.n_pad - 1).long()
    out["gids"] = seg.gids[idx]
    return out


@dataclasses.dataclass
class ShardedIndex:
    """Doc-partitioned index: one sub-segment per mesh slot."""

    mesh: Mesh
    shards: list          # per-shard Segment, each on its slot's device
    index: Any            # the owning SearchIndex (doc table, schema)

    @classmethod
    def build(cls, index, mesh: Optional[Mesh] = None) -> "ShardedIndex":
        """Partition an index's live docs round-robin across the mesh.

        Round-robin by insertion order is the analog of hash-slot
        partitioning (reference: src/slot_ranges.c) — uniform load without
        a hash ring, since we control placement.  Without a mesh, one on
        the index's device type: CPU_SLOTS CPU slots for an index on the
        CPU, the cards otherwise.
        """
        index.commit()
        mesh = mesh or make_mesh(
            device="cpu" if index.device.type == "cpu" else None)
        slots = mesh.slots
        n = len(slots)
        if len(index.segments) == 1:
            # fast reshard: slice the sealed segment's CSR arrays per
            # shard — no re-tokenization (index/slice.py)
            from ..index.slice import live_locals, slice_segment
            src = index.segments[0]
            live = live_locals(src, index.doctable)
            if live.size < n:
                raise ValueError("empty shard; need >= n_shards docs")
            shards = [segment_to(slice_segment(src, live[i::n]), slots[i])
                      for i in range(n)]
            return cls(mesh=mesh, shards=shards, index=index)
        builders = [SegmentBuilder(index.schema, index.stopwords,
                                   index.synonyms, device=d) for d in slots]
        i = 0
        for seg in index.segments:
            alive = seg.alive_np
            gids = seg.gids_np
            for j in range(seg.n_docs):
                if not alive[j]:
                    continue
                meta = index.doctable.get(int(gids[j]))
                if meta is None or meta.deleted:
                    continue
                builders[i % n].add(meta)
                i += 1
        shards = []
        for b in builders:
            seg = b.seal()
            if seg is None:
                raise ValueError("empty shard; need >= n_shards docs")
            shards.append(seg)
        return cls(mesh=mesh, shards=shards, index=index)

    # -- distributed execution --------------------------------------------
    def _k_local(self, k: int, shard_k_ratio: float) -> int:
        """Per-shard k (KNN shard window ratio, shard_window_ratio.h:25-40)."""
        return int(min(next_pow2(max(int(np.ceil(k * shard_k_ratio)), 1)),
                       max(s.n_pad for s in self.shards)))

    def _gather(self, cq: CompiledQuery, outs: list) -> dict:
        """Per-shard outputs ([B, lanes] each, counts [B]) moved to the
        coordinator and stacked to [S, B, kl] (counts [S, B])."""
        fills = {"gids": 0, "scores": -_FILL, "knn": _FILL,
                 "sortkeys": _FILL if cq.opts.sort_asc else -_FILL}
        return _tree_stack(outs, fills, self.mesh.slots[0])

    def _merged(self, cq: CompiledQuery, out: dict, k_local: int) -> dict:
        """The coordinator's per-query merge of the gathered lanes
        ([S, B, kl]): top k_local by (primary key, gid), where the
        primary key is the KNN distance, the +-sort key, or -score.  On a
        2D mesh, first within each slice of the outer axis, then the k
        of each slice across them."""
        S, B, kl = out["gids"].shape
        kk = min(k_local, S * kl)
        if "knn" in out:
            cols = (out["knn"], out["gids"], out["scores"])
        elif "sortkeys" in out:
            sk = out["sortkeys"]
            cols = (sk if cq.opts.sort_asc else -sk, out["gids"],
                    out["scores"], sk)
        else:
            cols = (-out["scores"], out["gids"])

        def to_b(x, lead):
            # [S, B, kl] -> [lead, B, (S/lead)*kl]
            return (x.reshape(lead, S // lead, B, kl).permute(0, 2, 1, 3)
                    .reshape(lead, B, -1))
        n_dcn = self.mesh.shape.get(DCN_AXIS, 1)
        if n_dcn > 1:
            k1 = min(kk, (S // n_dcn) * kl)
            cols = _merge2(tuple(to_b(c, n_dcn) for c in cols), k1)
            cols = tuple(c.permute(1, 0, 2).reshape(B, -1) for c in cols)
        else:
            cols = tuple(to_b(c, 1)[0] for c in cols)
        cols = _merge2(cols, kk)
        merged = {"count": out["count"].sum(0), "shard_counts": out["count"],
                  "gids": cols[1]}
        if "knn" in out:
            merged["knn"], merged["scores"] = cols[0], cols[2]
        elif "sortkeys" in out:
            merged["scores"], merged["sortkeys"] = cols[2], cols[3]
        else:
            merged["scores"] = -cols[0]
        return merged

    def _shard_outputs(self, cq: CompiledQuery, k: int,
                       shard_k_ratio: float = 1.0) -> tuple:
        """Launch the query's window program on every shard, on its
        device: ([per-shard {gids, scores, count (, knn, sortkeys)}
        with a leading query axis of 1], k_local)."""
        bindings = []
        P_ = 1
        buckets: dict[int, tuple] = {}
        for seg in self.shards:
            b, p = cq.bind(seg)
            b.dyn.pop("_tagL", None)
            _widen(buckets, b.dyn.pop("_buckets"))
            bindings.append(b)
            P_ = max(P_, p)
        P_ = next_pow2(P_)
        k_local = self._k_local(k, shard_k_ratio)
        outs = []
        for seg, b in zip(self.shards, bindings):
            fn = _program(cq, seg, buckets, P_, k_local, False, "topk")
            layout, total = _layout_of(b.dyn)
            buf = _pack_into(layout, b.dyn, np.zeros(total, np.int32))
            dyn = _device_unpack(layout, torch.from_numpy(buf).to(seg.device))
            out = _with_gids(seg, fn(_segment_args(cq, seg), dyn))
            outs.append({kk: v[None] for kk, v in out.items()})
        return outs, k_local

    def execute(self, cq: CompiledQuery, k: int,
                shard_k_ratio: float = 1.0, merge: bool = True):
        """Run a compiled query on every shard; returns merged
        (gids, scores, knn, sortkeys, count, shard_counts) host arrays.
        With merge=False the per-shard top-k arrays come back unmerged
        ([S, k_local]) — used for string sort keys, whose per-shard
        dictionary ranks are merged host-side after string resolution
        (the reference coordinator merges WITHSORTKEYS string values
        host-side too, module.c:2453)."""
        outs, k_local = self._shard_outputs(cq, k, shard_k_ratio)
        out = self._gather(cq, outs)
        if merge:
            res = {kk: v[0] for kk, v in
                   self._merged(cq, out, k_local).items()
                   if kk != "shard_counts"}
            res["shard_counts"] = out["count"][:, 0]
        else:
            res = {kk: v[:, 0] for kk, v in out.items()}
            res["shard_counts"] = res["count"]
            res["count"] = res["count"].sum()
        return {kk: v.cpu().numpy() for kk, v in res.items()}

    # -- batched execution (deep-queue serving on meshes) ------------------
    def execute_batch(self, cqs: list, k: int,
                      shard_k_ratio: float = 1.0) -> dict:
        """Run a batch of SAME-STRUCTURE queries on every shard: transport
        rows stack to [S, B, total] (`bind_row` per shard and query), each
        shard unpacks its [B, total] rows on its device in one upload and
        runs the window program once per query (`_WindowExecutor`'s
        loop), and the per-query merges run batched over B on the
        coordinator.  The JAX function pads B to a power of two so that
        XLA keeps one executable per size; the program here runs per
        query, so padding would only add work (the port's micro-batcher
        does not pad either).

        Returns stacked host arrays: gids/scores [B, k'], count [B],
        shard_counts [S, B] (+ knn/sortkeys when present)."""
        n = len(self.shards)
        B = len(cqs)
        rows = None
        common_bk: dict = {}
        P2 = 1
        lfp = layout = None
        for qi, cq in enumerate(cqs):
            for si, seg in enumerate(self.shards):
                row, ent = cq.bind_row(seg)
                if rows is None:
                    layout, lfp = ent[2], ent[7]
                    rows = np.zeros((n, B, ent[3]), np.int32)
                elif ent[7] != lfp:
                    raise ValueError("mixed query structures in batch")
                rows[si, qi] = row
                _widen(common_bk, ent[4])
                P2 = max(P2, ent[5])
        k_local = self._k_local(k, shard_k_ratio)
        cq0 = cqs[0]
        outs = []
        for si, seg in enumerate(self.shards):
            fn = _program(cq0, seg, common_bk, int(next_pow2(P2)), k_local,
                          False, "topk")
            seg_args = _segment_args(cq0, seg)
            stacked = _device_unpack_rows(
                layout, torch.from_numpy(rows[si]).to(seg.device))
            res = [fn(seg_args, {kk: vv[i] for kk, vv in stacked.items()})
                   for i in range(B)]
            outs.append(_with_gids(seg, {kk: torch.stack([r[kk] for r in res])
                                         for kk in res[0]}))
        merged = self._merged(cq0, self._gather(cq0, outs), k_local)
        return {kk: v.cpu().numpy() for kk, v in merged.items()}

    def _search_string_sort(self, query, params, offset, num, scorer,
                            sort_by, sort_asc, shard_k_ratio):
        """Search sorted by a string column: per-shard top-k by dictionary
        rank on each shard (merge=False), string resolution + S-way merge
        host-side."""
        from ..index.index import Hit, SearchResult
        from ..query.engine import QueryOptions
        k = offset + num
        root = self.index.parse_query(query, params)
        opts = QueryOptions(scorer=scorer, k=k, sort_field=sort_by,
                            sort_asc=sort_asc)
        cq = self.index.compile(root, opts)
        out = self.execute(cq, k, shard_k_ratio, merge=False)
        f = self.index.schema.field(sort_by)
        entries = []
        S, kl = out["gids"].shape
        for si in range(S):
            seg = self.shards[si]
            sc_col = seg.strcols.get(f.attribute)
            for j in range(kl):
                skey = float(out["sortkeys"][si, j])
                if abs(skey) >= 3.3e38:
                    continue     # invalid filler
                gid = int(out["gids"][si, j])
                score = float(out["scores"][si, j])
                if abs(skey) >= 2.9e38:
                    # missing sort value ranks last in either direction
                    rank = (1, "")
                    resolved = None
                else:
                    resolved = (sc_col.table[int(skey)]
                                if sc_col is not None
                                and 0 <= int(skey) < len(sc_col.table)
                                else str(skey))
                    rank = (0, resolved if sort_asc
                            else tuple(-ord(c) for c in resolved))
                entries.append((rank, gid, score, resolved))
        entries.sort(key=lambda e: (e[0], e[1]))
        hits = []
        for rank, gid, score, resolved in entries[offset:offset + num]:
            meta = self.index.doctable.get(gid)
            if meta is None or meta.deleted:
                continue
            hits.append(Hit(meta.key, score, fields=dict(meta.fields),
                            sortkey=resolved, gid=gid))
        res = SearchResult(total=int(out["count"]), hits=hits)
        res.shard_counts = [int(c) for c in out["shard_counts"]]
        return res

    def _search_host_merge(self, query, params, offset, num, scorer,
                           sort_by, sort_asc):
        """Host-merged sharded search (string sort keys, odd shapes): a
        temporary multi-segment index view over the shard segments reuses
        SearchIndex.search's merge semantics exactly."""
        from ..index.index import SearchIndex
        view = SearchIndex(self.index.schema, device=self.mesh.slots[0])
        view.doctable = self.index.doctable
        view.synonyms = self.index.synonyms
        view.segments = list(self.shards)
        return view.search(query, params=params, offset=offset, num=num,
                           scorer=scorer, sort_by=sort_by,
                           sort_asc=sort_asc)

    # -- adapter surface so aux pipelines (hybrid, agg tails) can treat a
    # ShardedIndex like a SearchIndex -------------------------------------
    def commit(self) -> None:
        self.index.commit()

    @property
    def doctable(self):
        return self.index.doctable

    @property
    def schema(self):
        return self.index.schema

    def search_many(self, queries, params=None, k: int = 10,
                    opts_list=None, **_kw):
        """Run several queries across the shards.  Same-structure batches
        share one `execute_batch` (the deep-queue serving shape); mixed
        structures fall back to per-query execution.  Used directly and
        by FT.HYBRID's branches (the reference drains branch cursor sets
        per shard, coord/hybrid/dist_hybrid.c)."""
        from ..query.engine import QueryOptions
        params = params or [None] * len(queries)
        opts_list = opts_list or [None] * len(queries)
        try:
            cqs = []
            ks = []
            for q, prm, opts in zip(queries, params, opts_list):
                scorer = opts.scorer if opts is not None else "BM25STD"
                kk = max(k, opts.k if opts is not None else k)
                root = self.index.parse_query(q, prm)
                cq = self.index.compile(
                    root, QueryOptions(scorer=scorer, k=kk))
                if cq.opts.sort_field or cq.host_nodes:
                    raise _BatchFallback
                cqs.append(cq)
                ks.append(kk)
            kmax = max(ks)
            try:
                out = self.execute_batch(cqs, kmax)
            except ValueError:
                raise _BatchFallback            # mixed structures
            res = []
            for i, (cq, kk) in enumerate(zip(cqs, ks)):
                row = {key: v[i] for key, v in out.items()
                       if key != "shard_counts"}
                r = self._assemble(cq, row, num=kk)
                r.shard_counts = [int(c)
                                  for c in out["shard_counts"][:, i]]
                res.append(r)
            return res
        except _BatchFallback:
            pass
        out = []
        for q, prm, opts in zip(queries, params, opts_list):
            scorer = opts.scorer if opts is not None else "BM25STD"
            kk = max(k, opts.k if opts is not None else k)
            out.append(self.search(q, params=prm, num=kk, scorer=scorer))
        return out

    def _assemble(self, cq, out: dict, offset: int = 0, num: int = 10):
        """Merged outputs -> SearchResult (shared by search and the
        batched path; mirrors the single-index reply layout)."""
        from ..index.index import Hit, SearchResult
        hits = []
        for j in range(len(out["gids"])):
            gid = int(out["gids"][j])
            sc = float(out["scores"][j])
            dist = float(out["knn"][j]) if "knn" in out else None
            skey = (float(out["sortkeys"][j])
                    if "sortkeys" in out else None)
            if dist is not None and dist >= 3.3e38:
                continue
            if skey is not None and abs(skey) >= 3.3e38:
                continue
            if dist is None and skey is None and sc <= -3.3e38:
                continue
            meta = self.index.doctable.get(gid)
            if meta is None or meta.deleted:
                continue
            hits.append(Hit(meta.key, sc, fields=dict(meta.fields),
                            sortkey=skey, vector_distance=dist, gid=gid))
        total = int(out["count"])
        if cq.knn is not None:
            hits = hits[:cq.knn.k]
            total = min(total, cq.knn.k)
        return SearchResult(total=total, hits=hits[offset:offset + num])

    def hybrid(self, hq, tail=None):
        """Distributed FT.HYBRID: both branches fan out over the shards
        through the distributed execute path (reference:
        coord/hybrid/dist_hybrid.c runs branch cursor sets); fusion
        happens on the merged per-branch rankings."""
        from ..aux.hybrid import run_hybrid
        return run_hybrid(self, hq, tail)

    def aggregate(self, req):
        """Distributed FT.AGGREGATE with DISTRIBUTE-step plan splitting
        (see parallel/dist_agg.py)."""
        from .dist_agg import dist_aggregate
        return dist_aggregate(self, req)

    # -- user-facing search (mirrors SearchIndex.search semantics) --------
    def profile(self, query: str, params=None, num: int = 10,
                iterators: bool = True, **kw) -> tuple:
        """Distributed FT.PROFILE analog (reference: coord/dist_profile.c
        — a Shards section per shard plus a Coordinator section).  Each
        shard section carries measured per-node iterator counters/timings
        from executing the query tree against that shard's segment
        (reference: Profile_AddIters per shard)."""
        t0 = time.perf_counter()
        root = self.index.parse_query(query, params)
        parse_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        res = self.search(query, params=params, num=num, **kw)
        total_ms = (time.perf_counter() - t0) * 1e3
        from ..query import ast as A
        counts = list(getattr(res, "shard_counts", []) or [])
        shard_iters: list = [None] * max(len(counts), len(self.shards))
        if iterators:
            from ..aux.explain import profile_query
            for i, seg in enumerate(self.shards):
                view = _shard_index_view(self, seg)
                try:
                    shard_iters[i] = profile_query(view, query, params)
                except Exception:
                    shard_iters[i] = None
        prof = {
            "shards": [
                {"shard": i, "results_count": int(c),
                 "query_tree": A.dump(root),
                 "iterators": shard_iters[i] if i < len(shard_iters)
                 else None}
                for i, c in enumerate(counts)
            ],
            "coordinator": {
                "merge": ("knn" if "KNN" in query.upper()
                          else "score-top-k"),
                "parsing_time_ms": parse_ms,
                "total_time_ms": total_ms,
                "execution_time_ms": (time.perf_counter() - t1) * 1e3,
                "results_count": res.total,
                "n_shards": len(self.shards),
            },
        }
        return res, prof

    def search(self, query: str, params=None, offset: int = 0, num: int = 10,
               scorer: str = "BM25STD", sort_by=None, sort_asc=True,
               shard_k_ratio: float = 1.0, **kw):
        from ..query.engine import QueryOptions
        from ..schema import FieldType
        if sort_by is not None:
            f = self.index.schema.field(sort_by)
            if f.type != FieldType.NUMERIC:
                # string sort keys are per-shard dictionary ranks — the
                # merge can't compare them.  Run the SAME per-shard
                # program but skip the cross-shard merge: each shard's
                # top-k BY LOCAL RANK is its top-k by string (the rank
                # map is monotone), then resolve strings host-side and
                # merge (reference: the coordinator merges WITHSORTKEYS
                # string values host-side too, module.c:2453)
                return self._search_string_sort(
                    query, params, offset, num, scorer, sort_by,
                    sort_asc, shard_k_ratio)
        root = self.index.parse_query(query, params)
        opts = QueryOptions(scorer=scorer, k=offset + num,
                            sort_field=sort_by, sort_asc=sort_asc)
        cq = self.index.compile(root, opts)
        out = self.execute(cq, offset + num, shard_k_ratio)
        res = self._assemble(cq, out, offset=offset, num=num)
        if "shard_counts" in out:
            res.shard_counts = [int(c) for c in out["shard_counts"]]
        return res


def _shard_index_view(sharded, seg):
    """A SearchIndex over one shard's segment, on its device, sharing the
    owning index's doc table and synonyms."""
    from ..index.index import SearchIndex
    ix = SearchIndex(sharded.index.schema, device=seg.device)
    ix.doctable = sharded.index.doctable
    ix.synonyms = sharded.index.synonyms
    ix.segments = [seg]
    return ix
