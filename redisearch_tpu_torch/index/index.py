"""SearchIndex: schema, doc table, builder, sealed segments and the batched
query path, for the torch port.

Counterpart of `redisearch_tpu/index/index.py`, for the port:
documents stage on the host and seal on `commit()` into an immutable
segment on the index's device; deletes clear a doc's `alive` bit, and
`compact()` (called by `commit` once a quarter of the docs are dead)
rebuilds the segments without them, by a CSR slice (`index/slice.py`)
where one sealed segment holds them all; `search_many` serves a batch
of queries through the intersection and phrase kernels, the KNN
executors, or the general window program for groups none of those
takes, `aggregate_many` a batch of FT.AGGREGATE GROUPBYs; single-query
`search()` and `aggregate()` ride the general window program; the
HAMMING scorer and registered custom scorers score the window program's
candidates on the host.  `info`, `explain` and the one-shot debug hooks
serve FT.INFO, FT.EXPLAIN and FT.DEBUG.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..analysis.stopwords import StopWordList
from ..analysis.synonyms import SynonymMap
from ..index.doctable import DocTable
from ..query import ast
from ..query.parser import QueryParser
from ..ops.ivf import HostIVF, IVFIndex
from ..schema import FieldType, Schema, VectorAlgo
from ..utils import log as _log
from ..utils.errors import IndexError_, TimeoutError_
from ..query.engine import (CompiledQuery, QueryOptions, execute,
                            execute_batch)
from .builder import SegmentBuilder
from .segment import Segment


def default_device() -> torch.device:
    """The card: the port's entry points run on CUDA unless the caller
    passes `device="cpu"`.  Raises when no CUDA device is present rather
    than falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present (torch.cuda.is_available() is "
            "false); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


class Hit:
    """One search result row."""

    __slots__ = ("key", "score", "fields", "sortkey", "vector_distance",
                 "gid", "payload")

    def __init__(self, key, score, fields=None, sortkey=None,
                 vector_distance=None, gid=0, payload=None):
        self.key = key
        self.score = score
        self.fields = fields
        self.sortkey = sortkey
        self.vector_distance = vector_distance
        self.gid = gid
        self.payload = payload

    def __repr__(self):
        return (f"Hit({self.key!r}, score={self.score:.4f}"
                + (f", dist={self.vector_distance:.4f}"
                   if self.vector_distance is not None else "") + ")")


class SearchResult:
    def __init__(self, total: int, hits: list[Hit], query_ast=None):
        self.total = total
        self.hits = hits
        self.query_ast = query_ast
        self.warnings: list[str] = []

    def __iter__(self):
        return iter(self.hits)

    def __len__(self):
        return len(self.hits)


class SearchIndex:
    def __init__(self, schema: Schema, device=None):
        self.schema = schema
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.doctable = DocTable()
        self.stopwords = StopWordList(schema.stopwords)
        self.synonyms = SynonymMap()
        self.segments: list[Segment] = []
        self._builder = self._new_builder()
        self.created_at = time.time()
        self.stats = {"indexing_errors": 0, "queries": 0}
        # dialect usage bitset (reference: global_stats.h:30-34 and the
        # per-index dialect_stats of FT.INFO)
        self.dialect_stats = {1: 0, 2: 0, 3: 0, 4: 0}
        # query timeout (ms, 0 = none) and its policy: return | fail |
        # return_strict (reference: TIMEOUT / ON_TIMEOUT)
        self.timeout_ms = 0
        self.on_timeout = "return"
        self.index_errors = {"count": 0, "last_error": None,
                             "last_error_key": None, "by_field": {}}
        self.on_oom = "ignore"       # ignore | return | fail
        self._prepared: dict = {}    # prepared-query cache (see prepare())
        # one-shot fault injection for the next query (reference:
        # _FT.DEBUG TIMEOUT_AFTER_N / CRASH / PAUSE, aggregate_debug.c)
        self._debug_hooks: Optional[dict] = None
        self._commit_lock = threading.RLock()
        # background initial scan progress (Client.ft_create)
        self.scan_state: Optional[dict] = None

    def wait_scan(self, timeout: float = 30.0) -> bool:
        """Block until a background initial scan finishes (True) or the
        timeout lapses (False).  No-op when the scan was synchronous."""
        deadline = time.perf_counter() + timeout
        while self.scan_state and self.scan_state.get("running"):
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.005)
        return True

    def _new_builder(self) -> SegmentBuilder:
        return SegmentBuilder(self.schema, self.stopwords, self.synonyms,
                              device=self.device)

    # -- write path ---------------------------------------------------------
    def add_document(self, key: str, fields: dict[str, Any],
                     score: float = 1.0, payload: Optional[bytes] = None,
                     ttl: Optional[float] = None,
                     field_expiration: Optional[dict] = None,
                     language: Optional[str] = None) -> None:
        """HSET-equivalent: (re)index a document."""
        if self.schema.score_field and self.schema.score_field in fields:
            try:
                score = float(fields[self.schema.score_field])
            except (TypeError, ValueError):
                pass
        meta, old = self.doctable.put(key, fields, score=score,
                                      payload=payload)
        if language is not None:
            meta.language = language
        if ttl is not None:
            meta.expires_at = time.time() + ttl
        if field_expiration is not None:
            meta.field_expiration = dict(field_expiration)
        elif old is not None and old.field_expiration:
            meta.field_expiration = dict(old.field_expiration)
        if old is not None:
            self._mark_deleted(old.gid)
        try:
            self._builder.add(meta)
        except Exception as e:
            # the document is dropped, the error recorded per field, and
            # indexing continues (reference: index_error.c)
            self.doctable.delete(key)
            self.stats["indexing_errors"] += 1
            self.index_errors["count"] += 1
            self.index_errors["last_error"] = str(e)
            self.index_errors["last_error_key"] = key
            self.index_errors["last_error_key_obfuscated"] = (
                _log.obfuscate_document(meta.gid))
            _log.logger.warning(
                "indexing failed for %s in %s: %s",
                _log.fmt_doc(key, meta.gid),
                _log.fmt_index(self.schema.name), _log.fmt_text(str(e)))
            field = getattr(e, "field", None) or "_"
            self.index_errors["by_field"][field] = (
                self.index_errors["by_field"].get(field, 0) + 1)
            # the builder may hold partial state for this doc; rebuild it
            self._rebuild_builder()
            return
        self.doctable.set_doclen(meta.gid, meta.doclen, meta.max_freq)

    def set_debug_hooks(self, timeout_after_n: Optional[int] = None,
                        crash: bool = False, pause_ms: float = 0) -> None:
        """Arm one-shot fault injection for the next query (reference:
        _FT.DEBUG FT.SEARCH ... DEBUG_PARAMS_COUNT n TIMEOUT_AFTER_N k /
        CRASH / PAUSE, aggregate_debug.c)."""
        self._debug_hooks = {"timeout_after_n": timeout_after_n,
                             "crash": crash, "pause_ms": pause_ms}

    def take_debug_hooks(self) -> Optional[dict]:
        """Disarm and return the armed hooks (None when none are): a
        CRASH raises here, a PAUSE sleeps here."""
        dbg = self._debug_hooks
        self._debug_hooks = None
        if dbg is None:
            return None
        if dbg.get("crash"):
            raise RuntimeError("Debug crash injected (RP_CRASH analog)")
        if dbg.get("pause_ms"):
            time.sleep(float(dbg["pause_ms"]) / 1e3)
        return dbg

    def _rebuild_builder(self, drop_gid: Optional[int] = None):
        keep = [g for g in self._builder._gids
                if g != drop_gid and (m := self.doctable.get(g)) is not None
                and not m.deleted]
        b = self._new_builder()
        for g in keep:
            b.add(self.doctable.get(g))
        self._builder = b

    def add_documents(self, docs, commit: bool = True) -> int:
        """Bulk ingest via the native tokenizer (index/bulk.py); falls
        back to the incremental path when native features don't cover
        the schema.  docs: iterable of (key, fields)."""
        from .bulk import bulk_add
        n = bulk_add(self, docs, commit=commit)
        if self.segments:
            self._build_ann(self.segments[-1])
        return n

    def delete_document(self, key: str) -> bool:
        """Drop a document: its doc-table entry goes, and its segment's
        `alive` bit is cleared in place (one small write on the device
        per delete), so every later query skips it."""
        meta = self.doctable.delete(key)
        if meta is None:
            return False
        self._mark_deleted(meta.gid)
        return True

    def _mark_deleted(self, gid: int) -> None:
        for seg in self.segments:
            if seg.mark_deleted(gid):
                return
        # doc still in the builder: re-stage without it
        if gid in self._builder._gids:
            self._rebuild_builder(drop_gid=gid)

    def commit(self) -> None:
        """Seal pending docs into a new immutable segment, build its IVF
        structures, then compact if the deleted share has reached the
        threshold (`maybe_compact`).  With nothing staged it returns at
        once, as the JAX package's does, without the compaction check."""
        with self._commit_lock:
            if len(self._builder) == 0:
                return
            seg = self._builder.seal()
            if seg is not None:
                self.segments.append(seg)
                self._build_ann(seg)
            self._builder = self._new_builder()
            self.maybe_compact()

    def maybe_compact(self, dead_ratio: float = 0.25) -> None:
        """GC-policy analog (reference: fork-GC cycles): rebuild once the
        deleted fraction crosses `dead_ratio`, which restores the
        clean-segment kernel paths (a segment with deletions serves on
        the window program) and frees the dead docs' memory."""
        if not self.segments:
            return
        dead = sum(s.n_deleted for s in self.segments)
        live = max(self.doctable.num_docs, 1)
        if dead / (dead + live) >= dead_ratio:
            self.compact()

    def compact(self, reanalyze: bool = False) -> None:
        """Rebuild all segments dropping deleted docs (replaces fork-GC).

        reanalyze=True forces the full tokenize path (needed when the
        analysis chain changed, e.g. after FT.SYNUPDATE); otherwise a
        single sealed segment compacts by slicing its CSR arrays
        (index/slice.py) with no re-tokenizing.  The seconds of each
        step land in `stats["last_compaction"]`."""
        self.commit()
        t0 = time.perf_counter()
        if not reanalyze and len(self.segments) == 1:
            from .slice import live_locals, slice_segment
            src = self.segments[0]
            live = live_locals(src, self.doctable)
            t1 = time.perf_counter()
            if live.size == 0:
                self.segments = []
                return
            if live.size == src.num_alive == src.n_docs:
                return   # nothing to drop
            times = {"path": "slice", "live_locals_s": t1 - t0}
            self.segments = [slice_segment(src, live, timings=times)]
            # the slice carries the host tier's structures itself; a
            # device IVF is rebuilt (it indexes pre-slice local ids)
            t2 = time.perf_counter()
            self._build_ann(self.segments[0])
            times["build_ann_s"] = time.perf_counter() - t2
            times["total_s"] = time.perf_counter() - t0
            self.stats["last_compaction"] = times
            return
        builder = self._new_builder()
        for seg in self.segments:
            gids = seg.gids_np
            for i in np.flatnonzero(seg.alive_np[:seg.n_docs]):
                meta = self.doctable.get(int(gids[i]))
                if meta is not None and not meta.deleted:
                    builder.add(meta)
        self.segments = []
        seg = builder.seal()
        if seg is not None:
            self.segments.append(seg)
            self._build_ann(seg)
        self.stats["last_compaction"] = {
            "path": "builder", "total_s": time.perf_counter() - t0}

    def _build_ann(self, seg: Segment) -> None:
        """IVF structures of the segment's vector fields (the JAX
        package's `_build_ann`).  A host-tier field always gets its
        `HostIVF` (its bucket slabs are its only query structure); an
        IVF-family field (IVF, HNSW, SVS, TIERED) gets an `IVFIndex` once
        the segment holds at least `flat_buffer_limit` (and 64) vectors,
        smaller segments staying on the exact FLAT scan (the reference's
        tiered front buffer, src/vector_index.c:89); multi-value columns
        stay on the exact scan."""
        for f in self.schema.fields_of(FieldType.VECTOR):
            vp = f.vector
            col = seg.vectors.get(f.attribute)
            if col is None:
                continue
            if col.host:
                present = col.present.cpu().numpy()
                if col.host_ivf is None:
                    if col.compression:
                        col.host_ivf = HostIVF.build_lvq(
                            col.vecs, col.vq_off, col.vq_scl, present,
                            vp.metric.value, nlist=vp.nlist,
                            device=self.device)
                    else:
                        col.host_ivf = HostIVF.build(
                            col.vecs, present, vp.metric.value,
                            nlist=vp.nlist, device=self.device)
                continue
            if (vp.algo == VectorAlgo.FLAT or col.ivf is not None
                    or col.multi):
                continue
            present = col.present.cpu().numpy()
            if int(present.sum()) < max(vp.flat_buffer_limit, 64):
                continue
            col.ivf = IVFIndex.build(
                col.vecs.float().cpu().numpy(), present, vp.metric.value,
                nlist=vp.nlist, device=self.device)

    # -- read path ----------------------------------------------------------
    def parse_query(self, query: str, params=None,
                    dialect: int = 2, nostopwords: bool = False) -> ast.Node:
        root = QueryParser(
            params=params,
            stopwords=StopWordList([]) if nostopwords else self.stopwords,
            dialect=dialect).parse(query)
        if dialect == 1:
            root = self._d1_resolve_fields(root)
        return root

    def _d1_resolve_fields(self, node: ast.Node) -> ast.Node:
        """Dialect-1 legacy: unknown fields match nothing instead of
        erroring (reference v1 grammar)."""
        direct = getattr(node, "field", None)
        if direct is not None and isinstance(direct, str):
            if self.schema.try_field(direct) is None:
                return ast.EmptyNode()
        if node.fieldmask_attrs:
            known = [a for a in node.fieldmask_attrs
                     if (f := self.schema.try_field(a)) is not None
                     and f.type == FieldType.TEXT]
            if not known:
                return ast.EmptyNode()
            node.fieldmask_attrs = known
        for c in list(node.children()):
            resolved = self._d1_resolve_fields(c)
            if resolved is not c:
                from ..query.parser import _replace_child
                _replace_child(node, c, resolved)
        return node

    def compile(self, root: ast.Node, opts: QueryOptions) -> CompiledQuery:
        cq = CompiledQuery(self.schema, root, opts, synonyms=self.synonyms)
        cq.root = root
        cq.global_N = max(self.doctable.num_docs, 1)
        cq.global_avgdl = self.doctable.avg_doclen or 1.0
        return cq

    def prepare(self, query: str, params: Optional[dict], opts: QueryOptions,
                dialect: int = 2) -> CompiledQuery:
        """Prepared-query cache: parse+lower once per (query string,
        scalar params, options).  Vector $params (bytes, arrays) rebind on
        every call: a hit with vector params or a KNN node, or with other
        per-call options (k, clock), returns a view owning its options,
        KNN node and vector blobs over the shared compiled structure and
        its row/bind caches, so that a batch of one KNN query string with
        a different blob per row never collapses to one blob."""
        scalar_items = []
        vec_params = {}
        for k, v in (params or {}).items():
            if isinstance(v, (bytes, np.ndarray)):
                vec_params[k] = v
            elif isinstance(v, (list, tuple)):
                # list params (vectors as lists, id lists) are baked into
                # the AST at parse time: their values key the cache
                vec_params[k] = v
                scalar_items.append((k, repr(v)))
            else:
                scalar_items.append((k, str(v)))
        key = (query, tuple(sorted(scalar_items)),
               tuple(sorted(vec_params)), dialect,
               opts.scorer, opts.sort_field, opts.sort_asc, opts.slop,
               opts.inorder, opts.verbatim, opts.language,
               opts.max_expansions, opts.expander, opts.in_fields,
               opts.tanh_factor, opts.nostopwords,
               self.doctable.num_docs)  # stats change -> new idf
        cq = self._prepared.get(key)
        if cq is None:
            root = self.parse_query(query, params, dialect,
                                    nostopwords=opts.nostopwords)
            cq = self.compile(root, opts)
            if len(self._prepared) >= 32768:
                self._prepared.clear()
            self._prepared[key] = cq
        if not vec_params and cq.knn is None and cq.opts == opts:
            return cq
        view = CompiledQuery.__new__(CompiledQuery)
        view.__dict__.update(cq.__dict__)
        vo = QueryOptions.__new__(QueryOptions)
        vo.__dict__.update(cq.opts.__dict__)
        view.opts = vo
        view.vec_blobs = list(cq.vec_blobs)
        if cq.knn is not None:
            kn = cq.knn.__class__.__new__(cq.knn.__class__)
            kn.__dict__.update(cq.knn.__dict__)
            view.knn = kn
        if vec_params:
            from ..query.engine import decode_blob
            from ..query.parser import _coerce_vector
            if view.knn is not None and view.knn.blob_param in vec_params:
                view.knn.blob = _coerce_vector(
                    vec_params[view.knn.blob_param])
            for i, pname in enumerate(view.vec_blob_params):
                if pname in vec_params:
                    view.vec_blobs[i] = decode_blob(
                        _coerce_vector(vec_params[pname]),
                        view.vec_blob_fields[i])
        vo.k = opts.k
        vo.now = opts.now
        return view

    def search(
        self,
        query: str,
        params: Optional[dict] = None,
        offset: int = 0,
        num: int = 10,
        scorer: str = "BM25STD",
        sort_by: Optional[str] = None,
        sort_asc: bool = True,
        slop: int = -1,
        inorder: bool = False,
        verbatim: bool = False,
        language: Optional[str] = None,
        no_content: bool = False,
        return_fields: Optional[Iterable[str]] = None,
        dialect: int = 2,
        max_expansions: Optional[int] = None,
        payload: Optional[bytes] = None,
        in_keys: Optional[Iterable[str]] = None,
        in_fields: Optional[Iterable[str]] = None,
        tanh_factor: float = 4.0,
        expander: str = "",
        nostopwords: bool = False,
    ) -> SearchResult:
        """FT.SEARCH: one query through the general window program
        (`query.engine.execute`) on every segment, then the merge by
        score, sort key or (KNN) vector distance, then doc id; a KNN
        query returns at most its k results and a total of at most k.
        in_keys/in_fields mirror INKEYS/INFIELDS.  The HAMMING scorer
        (with the query's `payload`) and registered custom scorers
        (`ext.py`) score the window program's candidates on the host.
        Armed debug hooks (`set_debug_hooks`) cut the merge after
        `timeout_after_n` hits under the ON_TIMEOUT policy."""
        self.commit()
        self.stats["queries"] += 1
        oom = self._check_oom()
        if oom is not None:
            return oom
        if scorer == "HAMMING":
            root = self.parse_query(query, params, dialect)
            return self._search_hamming(root, payload, offset, num,
                                        no_content, return_fields)
        from .. import ext as _ext
        if _ext.is_custom_scorer(scorer):
            root = self.parse_query(query, params, dialect)
            return self._search_custom_scorer(
                root, _ext.get_scorer(scorer), offset, num, no_content,
                return_fields)
        opts = QueryOptions(
            scorer=scorer, k=offset + num, sort_field=sort_by,
            sort_asc=sort_asc, slop=slop, inorder=inorder,
            verbatim=verbatim, now=int(time.time()),
            language=language or self.schema.language,
            in_fields=tuple(in_fields) if in_fields else None,
            tanh_factor=tanh_factor, expander=expander,
            nostopwords=nostopwords)
        if max_expansions:
            opts.max_expansions = max_expansions
        cq = self.prepare(query, params, opts, dialect)
        k = max(offset + num, 1)
        deadline = (time.perf_counter() + self.timeout_ms / 1e3
                    if self.timeout_ms else None)
        dbg = self.take_debug_hooks()
        dbg_n = dbg.get("timeout_after_n") if dbg else None
        warnings: list[str] = []
        merged: list[tuple] = []   # (rank, gid, score, dist, sortkey, seg)
        total = 0
        inkey_gids = None
        if in_keys is not None:
            # INKEYS: restrict to the given keys, as an extra doc mask
            metas = (self.doctable.get_by_key(k2) for k2 in in_keys)
            inkey_gids = np.array(sorted(m.gid for m in metas
                                         if m is not None and not m.deleted),
                                  np.int64)
        for seg in self.segments:
            if deadline is not None and time.perf_counter() > deadline:
                # the reference's ON_TIMEOUT policies
                if self.on_timeout == "fail":
                    raise TimeoutError_("Timeout limit was reached")
                if self.on_timeout == "return_strict" and not merged:
                    raise TimeoutError_("Timeout limit was reached")
                warnings.append("Timeout limit was reached")
                break
            emask = (np.isin(seg.gids_host, inkey_gids)
                     if inkey_gids is not None else None)
            res = execute(cq, seg, k, extra_mask=emask)
            for w in res.warnings:
                if w not in warnings:
                    warnings.append(w)
            total += res.count
            gids = seg.gids_host
            for j in range(min(k, res.local_idx.shape[0])):
                li = int(res.local_idx[j])
                sc = float(res.scores[j])
                if cq.knn is not None:
                    dist = float(res.knn_dists[j])
                    if dist >= 3.3e38:
                        continue
                    rank = dist
                elif sort_by is not None:
                    kv = float(res.sortkeys[j])
                    if abs(kv) >= 3.3e38:
                        continue
                    if abs(kv) >= 2.9e38:
                        # missing-sort-value sentinel: the doc matches but
                        # ranks last in either direction
                        rank = (1, 0.0)
                    else:
                        # string sort keys are per-segment dictionary
                        # ranks: rank on the resolved string instead
                        resolved = self._resolve_sortkey(seg, sort_by, kv)
                        if isinstance(resolved, str):
                            rank = (0, resolved if sort_asc
                                    else tuple(-ord(c) for c in resolved))
                        else:
                            rank = (0, kv if sort_asc else -kv)
                else:
                    if sc <= -3.3e38:
                        continue
                    rank = -sc
                merged.append((rank, int(gids[li]), sc,
                               float(res.knn_dists[j])
                               if res.knn_dists is not None else None,
                               float(res.sortkeys[j])
                               if res.sortkeys is not None else None, seg))
            if dbg_n is not None and len(merged) >= dbg_n:
                # injected timeout (TIMEOUT_AFTER_N): apply ON_TIMEOUT
                merged = merged[:dbg_n]
                if self.on_timeout == "fail":
                    raise TimeoutError_("Timeout limit was reached")
                warnings.append("Timeout limit was reached")
                break
        merged.sort(key=lambda x: (x[0], x[1]))
        if cq.knn is not None:
            merged = merged[:cq.knn.k]  # KNN returns at most k results
        hits = []
        for _rank, gid, sc, dist, skey, seg in merged[offset:offset + num]:
            meta = self.doctable.get(gid)
            if meta is None or meta.deleted:
                continue
            fields = None
            if not no_content:
                if return_fields:
                    fields = {f: meta.fields.get(f) for f in return_fields
                              if f in meta.fields}
                else:
                    fields = dict(meta.fields)
            sortkey = None
            if (skey is not None and sort_by is not None
                    and abs(skey) < 2.9e38):   # missing-value sentinel
                sortkey = self._resolve_sortkey(seg, sort_by, skey)
            hits.append(Hit(meta.key, sc, fields=fields, sortkey=sortkey,
                            vector_distance=dist, gid=gid,
                            payload=meta.payload))
        if cq.knn is not None:
            total = min(total, cq.knn.k)
        out = SearchResult(total=total, hits=hits, query_ast=cq.root)
        out.warnings = warnings
        return out

    def _resolve_sortkey(self, seg: Segment, field: str, keyval: float):
        f = self.schema.field(field)
        if f.type == FieldType.NUMERIC:
            return keyval
        sc = seg.strcols.get(f.attribute)
        if sc is not None and 0 <= int(keyval) < len(sc.table):
            return sc.table[int(keyval)]
        return keyval

    def aggregate(self, req):
        """FT.AGGREGATE (agg.pipeline.run_aggregate): `req` is an
        agg.pipeline.AggregateRequest."""
        from ..agg.pipeline import run_aggregate
        return run_aggregate(self, req)

    def aggregate_many(self, reqs: list) -> list:
        """Batched FT.AGGREGATE (agg.pipeline.run_aggregate_many): `reqs`
        are agg.pipeline.AggregateRequest; returns AggregateResults."""
        from ..agg.pipeline import run_aggregate_many
        return run_aggregate_many(self, reqs)

    def _check_oom(self) -> Optional[SearchResult]:
        """Query OOM guardrail (reference: QueryMemoryGuard): under
        device-memory pressure the query is let through (ignore),
        answered empty (return), or failed (fail)."""
        if self.on_oom == "ignore" or self.device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        if not total or (total - free) / total < 0.9:
            return None
        if self.on_oom == "fail":
            raise IndexError_("Not enough memory available to execute the "
                              "query")
        res = SearchResult(total=0, hits=[])
        res.warnings = ["OOM: query returned empty result"]
        return res

    def _hits_of(self, scored: list, offset: int, num: int, no_content,
                  return_fields) -> list:
        """Hits of host-scored (score, meta) pairs, ranked by score, then
        key."""
        scored.sort(key=lambda x: (-x[0], x[1].key))
        hits = []
        for score, meta in scored[offset:offset + num]:
            fields = None
            if not no_content:
                fields = ({f: meta.fields.get(f) for f in return_fields
                           if f in meta.fields} if return_fields
                          else dict(meta.fields))
            hits.append(Hit(meta.key, float(score), fields=fields,
                            gid=meta.gid, payload=meta.payload))
        return hits

    def _search_custom_scorer(self, root, fn, offset, num, no_content,
                              return_fields) -> SearchResult:
        """EXTLOAD-analog custom scorer: over-fetch by BM25STD on the
        window program, re-rank on the host by the registered callable
        (ext.py)."""
        from .. import ext as _ext
        cq = self.compile(root, QueryOptions(
            scorer="BM25STD", k=max((offset + num) * _ext.RESCORE_FACTOR,
                                    64)))
        scored = []
        total = 0
        for seg in self.segments:
            res = execute(cq, seg, cq.opts.k)
            total += res.count
            gids = seg.gids_host
            for j in range(res.local_idx.shape[0]):
                base = float(res.scores[j])
                if base <= -3.3e38:
                    continue
                meta = self.doctable.get(int(gids[int(res.local_idx[j])]))
                if meta is None or meta.deleted:
                    continue
                scored.append((fn(meta.key, meta.fields, base), meta))
        return SearchResult(total=total, hits=self._hits_of(
            scored, offset, num, no_content, return_fields), query_ast=root)

    def _search_hamming(self, root, payload: Optional[bytes], offset, num,
                        no_content, return_fields) -> SearchResult:
        """HAMMING scorer (reference: ext/default.c:457): score =
        1/(1+hamming_distance(query payload, doc payload)); docs without an
        equal-length payload score 0.  The window program gives the
        matching docs; payloads are opaque bytes on the host doc table."""
        cq = self.compile(root, QueryOptions())
        scored = []
        total = 0
        for seg in self.segments:
            res = execute(cq, seg, 1, mode="window")
            total += res.count
            gids = seg.gids_host
            for li in res.local_idx[res.valid]:
                meta = self.doctable.get(int(gids[int(li)]))
                if meta is None or meta.deleted:
                    continue
                score = 0.0
                if (payload is not None and meta.payload is not None
                        and len(meta.payload) == len(payload)):
                    dist = sum(bin(a ^ b).count("1")
                               for a, b in zip(payload, meta.payload))
                    score = 1.0 / (1.0 + dist)
                scored.append((score, meta))
        return SearchResult(total=total, hits=self._hits_of(
            scored, offset, num, no_content, return_fields), query_ast=root)

    def search_many(self, queries: list, params: Optional[list] = None,
                    k: int = 10, scorer: str = "BM25STD",
                    dialect: int = 2,
                    opts_list: Optional[list] = None) -> list:
        """Batched FT.SEARCH: every group of same-shaped queries is one
        executor call; all groups are collected together.  opts_list
        overrides QueryOptions per query.  KNN hits carry their vector
        distance and merge across segments by (distance, doc id)."""
        self.commit()
        oom = self._check_oom()
        if oom is not None:
            return [oom for _ in queries]
        cqs = []
        for i, q in enumerate(queries):
            p = params[i] if params else None
            o = (opts_list[i] if opts_list
                 else QueryOptions(scorer=scorer, k=k))
            # a per-call view owns its vector payloads (see prepare)
            cqs.append(self.prepare(q, p, o, dialect))
        all_hits: list = [[] for _ in cqs]
        totals = [0] * len(cqs)
        knn_q = [False] * len(cqs)
        for seg in self.segments:
            results = execute_batch(cqs, seg, k)
            gids = seg.gids_host
            for i, res in enumerate(results):
                is_knn = res.knn_dists is not None
                knn_q[i] = is_knn
                totals[i] += res.count
                n_hit = 0
                for j in range(res.local_idx.shape[0]):
                    if n_hit >= k:
                        break
                    sc = float(res.scores[j])
                    dist = float(res.knn_dists[j]) if is_knn else None
                    if is_knn:
                        if dist >= 3.3e38:
                            continue
                    elif sc <= -3.3e38:
                        continue
                    meta = self.doctable.get(
                        int(gids[int(res.local_idx[j])]))
                    if meta is None or meta.deleted:
                        continue
                    all_hits[i].append(Hit(meta.key, sc, fields=meta.fields,
                                           vector_distance=dist,
                                           gid=meta.gid))
                    n_hit += 1
        # deterministic merge: score (or distance) first, then doc id
        # (the reference sorter's docid tiebreak)
        out = []
        for i in range(len(cqs)):
            key = ((lambda h: (h.vector_distance, h.gid)) if knn_q[i]
                   else (lambda h: (-h.score, h.gid)))
            out.append(SearchResult(total=totals[i],
                                    hits=sorted(all_hits[i], key=key)[:k]))
        return out

    def explain(self, query: str, params=None, dialect: int = 2) -> str:
        """FT.EXPLAIN: the parsed query tree as text."""
        return ast.dump(self.parse_query(query, params, dialect))

    # -- introspection -------------------------------------------------------
    def info(self) -> dict:
        """FT.INFO.  Its byte counts are the port's own: the device
        tensors of each segment (`Segment.memory_bytes`) and its vector
        structures."""
        self_mem = sum(seg.memory_bytes() for seg in self.segments)
        n_terms = sum(len(seg.terms) for seg in self.segments)
        n_records = sum(seg.text.nnz for seg in self.segments)
        vec_mem = sum(
            (v.vecs.nbytes if hasattr(v.vecs, "nbytes") else 0)
            + (v.ivf.memory_bytes() if v.ivf is not None else 0)
            + (v.host_ivf.device_bytes() + v.host_ivf.host_bytes()
               if v.host_ivf is not None else 0)
            for seg in self.segments for v in seg.vectors.values())
        return {
            "index_name": self.schema.name,
            "index_options": {"prefixes": list(self.schema.prefixes),
                              "filter": self.schema.filter_expr,
                              "language": self.schema.language},
            "num_docs": self.doctable.num_docs,
            "max_doc_id": self.doctable.max_gid,
            "indexing": int(bool(self.scan_state
                                 and self.scan_state.get("running"))),
            "percent_indexed": (
                1.0 if not self.scan_state
                else (self.scan_state["scanned"]
                      / max(self.scan_state["total"], 1))),
            "background_indexing_status": (
                "OK" if not self.scan_state
                else ("PAUSED_ON_OOM" if self.scan_state.get("oom_abort")
                      else ("RUNNING" if self.scan_state.get("running")
                            else "OK"))),
            "num_terms": n_terms,
            "num_records": n_records,
            "num_segments": len(self.segments),
            "pending_docs": len(self._builder),
            "avg_doc_length": self.doctable.avg_doclen,
            "inverted_sz_mb": self_mem / 1e6,
            "vector_index_sz_mb": vec_mem / 1e6,
            "attributes": [
                {"identifier": f.name, "attribute": f.attribute,
                 "type": f.type.value, "sortable": f.sortable,
                 "weight": f.weight,
                 **({"algorithm": f.vector.algo.value,
                     "dim": f.vector.dim,
                     "metric": f.vector.metric.value}
                    if f.vector else {})}
                for f in self.schema.fields
            ],
            "index_errors": self._render_index_errors(),
            "queries": self.stats["queries"],
            "dialect_stats": {f"dialect_{d}": int(self.dialect_stats[d])
                              for d in (1, 2, 3, 4)},
        }

    def _render_index_errors(self) -> dict:
        """Index Errors section; the failing document key is obfuscated
        when hide-user-data-from-log is on (reference: index_error.c +
        obfuscation_api.h)."""
        out = dict(self.index_errors)
        obf = out.pop("last_error_key_obfuscated", None)
        if _log.hide_user_data and out.get("last_error_key") is not None:
            out["last_error_key"] = obf or "Document@?"
        return out
