"""Client: the command surface of the torch port.

Counterpart of `redisearch_tpu/api.py`, with every one of its
commands.  Its indexes follow the client's own document store: `hset` /
`hdel` write it and route to every index whose rule (prefixes + FILTER)
matches.  Commands:

  CREATE/ALTER/DROPINDEX/_LIST  -> ft_create / ft_alter / ft_dropindex /
                                   ft_list
  INFO / EXPLAIN / PROFILE      -> ft_info / ft_explain / ft_profile
  EXPLAINSCORE                  -> ft_explainscore
  SEARCH                        -> ft_search, batched ft_search_many (KNN
                                   and VECTOR_RANGE take their vectors
                                   as PARAMS blobs: params={"b": vec},
                                   one dict a query in the batched call)
  AGGREGATE                     -> ft_aggregate, batched
                                   ft_aggregate_many
  CURSOR READ / DEL             -> ft_cursor_read / ft_cursor_del
  HYBRID                        -> ft_hybrid
  ADD / DEL / GET / MGET        -> ft_add / ft_del / ft_get / ft_mget
  ALIAS{ADD,DEL,UPDATE,LIST}    -> ft_aliasadd / ft_aliasdel /
                                   ft_aliasupdate / ft_aliaslist
  SYN{UPDATE,DUMP}              -> ft_synupdate / ft_syndump
  DICT{ADD,DEL,DUMP}            -> ft_dictadd / ft_dictdel / ft_dictdump
  SPELLCHECK                    -> ft_spellcheck
  SUG{ADD,GET,DEL,LEN}          -> ft_sugadd / ft_sugget / ft_sugdel /
                                   ft_suglen
  TAGVALS                       -> ft_tagvals
  DEBUG                         -> ft_debug
  CONFIG GET/SET                -> ft_config_get / ft_config_set
  HSET/HGET/HDEL/EXPIRE/HEXPIRE -> hset / hget / hdel / expire / hexpire
  checkpoints (both packages')  -> save_index / load_index

The RESP wire server over these commands is `server.Server`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from .agg.cursor import CursorList
from .agg.pipeline import (AggregateRequest, AggregateResult,
                           run_aggregate, run_aggregate_streaming)
from .aux.highlight import (HighlightOptions, SummarizeOptions,
                            highlight_field, summarize_field)
from .aux.hybrid import HybridQuery, run_hybrid
from .aux.spellcheck import Dictionary, spellcheck
from .aux.suggest import SuggestionDictionary
from .schema import Field, Schema
from .utils.config import Config
from .utils import log as _log
from .utils.errors import (IndexError_, IndexExists, IndexNotFound,
                           RSError)
from .index.index import SearchIndex, SearchResult, default_device


def _fold_legacy_filters(query: str, filters: list) -> str:
    """Fold legacy FT.SEARCH FILTER/GEOFILTER argv clauses into the query
    (reference: legacy numeric/geo filters attach to the query iterator
    tree — aggregate_request.c FILTER/GEOFILTER args).  An unknown field
    then follows each dialect's semantics: empty results under dialect 1,
    error under dialect 2 (tests/pytests/test_dialect.py
    test_dialect1_filter_on_nonexistent_field)."""
    parts = []
    for f in filters:
        kind = f[0]
        if kind == "numeric":
            _, field, lo, hi = f
            parts.append(f"@{field}:[{lo} {hi}]")
        elif kind == "geo":
            _, field, lon, lat, radius, unit = f
            parts.append(f"@{field}:[{lon} {lat} {radius} {unit}]")
        else:
            raise RSError(f"unknown legacy filter kind {kind!r}")
    q = query.strip()
    if q in ("*", ""):
        return " ".join(parts)
    return f"({q}) " + " ".join(parts)


def _sync(ix: SearchIndex) -> None:
    """Wait for the index's card, so a clock read after it counts the
    device work and not only its launches."""
    if ix.device.type == "cuda":
        torch.cuda.synchronize(ix.device)


class Client:
    """An embedded search service instance; its indexes keep their
    segments on `device` (default: the card; `device="cpu"` asks for the
    CPU, and without a card the default raises)."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._indexes: dict[str, SearchIndex] = {}
        self._aliases: dict[str, str] = {}
        self._keyspace: dict[str, dict] = {}
        self._suggestions: dict[str, SuggestionDictionary] = {}
        self.dicts = Dictionary()
        self.cursors = CursorList()
        self.config = Config()

    # -- index lifecycle -----------------------------------------------------
    def ft_create(self, name: str, fields: Sequence[Field],
                  prefixes: Sequence[str] = ("",),
                  filter_expr: Optional[str] = None,
                  language: str = "english",
                  stopwords: Optional[Sequence[str]] = None,
                  score_field: Optional[str] = None,
                  on_json: bool = False,
                  skip_initial_scan: bool = False,
                  background_scan: bool = False,
                  **schema_kw) -> SearchIndex:
        """FT.CREATE — also scans existing keys matching the rule,
        synchronously by default; background_scan indexes on a thread,
        with progress in `scan_state` and an abort under device-memory
        pressure (reference: indexes_scanner.c)."""
        if name in self._indexes:
            raise IndexExists(f"Index {name} already exists")
        schema = Schema(name=name, fields=list(fields), prefixes=prefixes,
                        filter_expr=filter_expr, language=language,
                        stopwords=stopwords, score_field=score_field,
                        on_json=on_json, **schema_kw)
        ix = SearchIndex(schema, device=self.device)
        self._indexes[name] = ix
        _log.logger.info("created index %s (%d fields)",
                         _log.fmt_index(name), len(fields))
        if skip_initial_scan:
            return ix
        snapshot = list(self._keyspace.items())
        if not background_scan:
            for key, fieldsv in snapshot:
                if self._rule_matches(schema, key, fieldsv):
                    ix.add_document(key, fieldsv)
            return ix

        ix.scan_state = {"running": True, "scanned": 0,
                         "total": len(snapshot), "oom_abort": False}

        def _scan():
            try:
                for j, (key, fieldsv) in enumerate(snapshot):
                    if _scan_oom():
                        ix.scan_state["oom_abort"] = True
                        _log.logger.warning(
                            "background scan of %s aborted on OOM at "
                            "%d/%d", _log.fmt_index(name), j,
                            len(snapshot))
                        return
                    if self._rule_matches(schema, key, fieldsv):
                        ix.add_document(key, fieldsv)
                    ix.scan_state["scanned"] = j + 1
                ix.commit()
            finally:
                ix.scan_state["running"] = False

        def _scan_oom() -> bool:
            if self.device.type != "cuda":
                return False
            free, total = torch.cuda.mem_get_info(self.device)
            return bool(total) and (total - free) / total > 0.95

        threading.Thread(target=_scan, daemon=True,
                         name=f"rs-scan-{name}").start()
        return ix

    def ft_alter(self, name: str, field: Field,
                 reindex: bool = True) -> None:
        """FT.ALTER SCHEMA ADD — adds a field and reindexes (the immutable
        segment model rebuilds; the reference only indexes new docs)."""
        ix = self._index(name)
        new_schema = Schema(
            name=ix.schema.name, fields=list(ix.schema.fields) + [field],
            prefixes=ix.schema.prefixes, filter_expr=ix.schema.filter_expr,
            language=ix.schema.language, stopwords=ix.schema.stopwords,
            score_field=ix.schema.score_field, on_json=ix.schema.on_json)
        old = ix
        ix2 = SearchIndex(new_schema, device=self.device)
        ix2.synonyms = old.synonyms
        # the builder indexes with the synonyms it was made with (the
        # JAX package keeps ix2's empty map there: ROADMAP §C)
        ix2._builder = ix2._new_builder()
        if reindex:
            old.commit()
            for seg in old.segments:
                gids = seg.gids_np
                for j in np.flatnonzero(seg.alive_np[:seg.n_docs]):
                    meta = old.doctable.get(int(gids[j]))
                    if meta and not meta.deleted:
                        ix2.add_document(meta.key, meta.fields,
                                         score=meta.score,
                                         payload=meta.payload)
        self._indexes[name] = ix2

    def ft_dropindex(self, name: str, delete_docs: bool = False) -> None:
        """FT.DROPINDEX [DD]: the index goes, with its segments' device
        memory once nothing else holds them."""
        ix = self._index(name)
        if delete_docs:
            for key in list(self._keyspace):
                if self._rule_matches(ix.schema, key, self._keyspace[key]):
                    del self._keyspace[key]
        del self._indexes[self._resolve(name)]
        _log.logger.info("dropped index %s", _log.fmt_index(name))
        for a, target in list(self._aliases.items()):
            if target == name:
                del self._aliases[a]

    def ft_list(self) -> list[str]:
        """FT._LIST"""
        return sorted(self._indexes)

    def ft_info(self, name: str) -> dict:
        """FT.INFO (SearchIndex.info)."""
        return self._index(name).info()

    # -- keyspace ------------------------------------------------------------
    def hset(self, key: str, fields: dict[str, Any],
             ttl: Optional[float] = None) -> None:
        """Write a document; routes to all matching indexes."""
        self._keyspace[key] = dict(fields)
        for ix in self._indexes.values():
            if self._rule_matches(ix.schema, key, fields):
                ix.add_document(key, dict(fields), ttl=ttl)
            elif key in ix.doctable:
                ix.delete_document(key)  # no longer matches the rule

    def hget(self, key: str) -> Optional[dict]:
        return self._keyspace.get(key)

    def hdel(self, key: str) -> bool:
        existed = self._keyspace.pop(key, None) is not None
        for ix in self._indexes.values():
            ix.delete_document(key)
        return existed

    def expire(self, key: str, seconds: float) -> None:
        """EXPIRE: the doc's deadline, written into its sealed segment's
        `expire_at` column in place; the segment then carries TTLs (off
        the kernel paths, as in the JAX package)."""
        for ix in self._indexes.values():
            meta = ix.doctable.get_by_key(key)
            if meta is not None:
                meta.expires_at = time.time() + seconds
                for seg in ix.segments:
                    loc = seg.gid_to_local.get(meta.gid)
                    if loc is not None:
                        # ceil: do not expire earlier than the deadline
                        seg.expire_at[loc] = int(-(-meta.expires_at // 1))
                        seg.has_ttl = True
                        break

    def hexpire(self, key: str, seconds: float,
                fields: Sequence[str]) -> list[int]:
        """HEXPIRE analog: field-level TTLs (reference: ttl_table).
        Re-stages the document so sealed segments carry the TTL columns."""
        now = time.time()
        out = []
        doc = self._keyspace.get(key)
        for f in fields:
            out.append(1 if doc is not None and f in doc else -2)
        for ix in self._indexes.values():
            meta = ix.doctable.get_by_key(key)
            if meta is None:
                continue
            fe = dict(meta.field_expiration or {})
            for f in fields:
                fe[f] = now + seconds
            ix.add_document(key, dict(meta.fields), score=meta.score,
                            payload=meta.payload, field_expiration=fe)
        return out

    def _rule_matches(self, schema: Schema, key: str, fields: dict) -> bool:
        if not schema.matches_key(key):
            return False
        if schema.filter_expr:
            from .agg import expr as _expr
            try:
                e = _expr.parse(schema.filter_expr)
                return _expr._truthy(_expr.evaluate(e, fields))
            except Exception:
                return False
        return True

    # -- queries --------------------------------------------------------------
    def ft_search_many(self, name: str, queries: list[str],
                       params: Optional[list] = None,
                       k: int = 10, scorer: str = "BM25STD",
                       dialect: int = 2) -> list[SearchResult]:
        """Batched search: each group of same-shaped queries is one
        kernel launch (see query.engine.execute_batch)."""
        ix = self._index(name)
        return ix.search_many(queries, params=params, k=k, scorer=scorer,
                              dialect=dialect)

    def ft_aggregate_many(self, name: str, reqs: list) -> list:
        """Batched FT.AGGREGATE: same-shaped GROUPBYs launch together and
        are collected together (see agg.pipeline.run_aggregate_many)."""
        return self._index(name).aggregate_many(reqs)

    def ft_search(self, name: str, query: str,
                  highlight: Optional[dict] = None,
                  summarize: Optional[dict] = None,
                  filters: Optional[list] = None,
                  **opts) -> SearchResult:
        """FT.SEARCH: one query through the general window program
        (SearchIndex.search), with the client's config as its defaults
        (MAXPREFIXEXPANSIONS, DEFAULT_DIALECT, DEFAULT_SCORER,
        BM25STD_TANH_FACTOR; TIMEOUT, ON_TIMEOUT and ON_OOM onto the
        index); legacy FILTER/GEOFILTER clauses fold into the query;
        expired fields are dropped from the returned documents, and
        HIGHLIGHT / SUMMARIZE rewrite the text fields of the hits."""
        ix = self._index(name)
        opts.setdefault("max_expansions",
                        self.config.get("MAXPREFIXEXPANSIONS"))
        opts.setdefault("dialect", int(self.config.get("DEFAULT_DIALECT")))
        if not 1 <= int(opts["dialect"]) <= 4:
            raise RSError("DIALECT requires a non negative integer "
                          ">=1 and <= 4")
        if filters:
            query = _fold_legacy_filters(query, filters)
        if "scorer" not in opts:
            opts["scorer"] = self.config.get("DEFAULT_SCORER")
        if str(opts["scorer"]).upper() == "BM25STD.TANH":
            opts.setdefault("tanh_factor",
                            float(self.config.get("BM25STD_TANH_FACTOR")))
        ix.timeout_ms = self.config.get("TIMEOUT")
        ix.on_timeout = str(self.config.get("ON_TIMEOUT")).lower()
        ix.on_oom = str(self.config.get("ON_OOM")).lower()
        res = ix.search(query, **opts)
        ix.dialect_stats[int(opts["dialect"])] = 1
        self._drop_expired_fields(ix, res)
        if highlight is not None or summarize is not None:
            root = res.query_ast
            h_fields = (highlight or {}).get("fields")
            s_fields = (summarize or {}).get("fields")
            h_opts = HighlightOptions(
                open_tag=(highlight or {}).get("open_tag", "<b>"),
                close_tag=(highlight or {}).get("close_tag", "</b>"))
            s_opts = SummarizeOptions(
                frag_len=(summarize or {}).get("frag_len", 20),
                num_frags=(summarize or {}).get("num_frags", 3),
                separator=(summarize or {}).get("separator", "... "))
            for hit in res.hits:
                if hit.fields is None:
                    continue
                for fname, val in list(hit.fields.items()):
                    if not isinstance(val, str):
                        continue
                    if summarize is not None and (s_fields is None
                                                  or fname in s_fields):
                        val = summarize_field(
                            ix, val, root, s_opts,
                            h_opts if highlight is not None else None)
                    elif highlight is not None and (h_fields is None
                                                    or fname in h_fields):
                        val = highlight_field(ix, val, root, h_opts)
                    hit.fields[fname] = val
        return res

    def _drop_expired_fields(self, ix, res) -> None:
        """Field-level TTL (HEXPIRE analog): expired fields are dropped
        from returned documents (reference: ttl_table + expiration_checker
        iterator; match-time filtering is doc-level here)."""
        for hit in res.hits:
            if hit.fields is None:
                continue
            meta = ix.doctable.get(hit.gid)
            if meta is None or not meta.field_expiration:
                continue
            for f in list(hit.fields):
                if meta.field_expired(f):
                    del hit.fields[f]

    def ft_hybrid(self, name: str, hq: HybridQuery,
                  tail: Optional[AggregateRequest] = None) -> list[dict]:
        """FT.HYBRID: the text and vector branches fused by RRF or LINEAR,
        then the optional tail pipeline (aux.hybrid.run_hybrid)."""
        return run_hybrid(self._index(name), hq, tail)

    def ft_aggregate(self, name: str, req: AggregateRequest
                     ) -> AggregateResult:
        """FT.AGGREGATE of one request (agg.pipeline.run_aggregate).  With
        WITHCURSOR the rows stream (reference: RPNet shard-cursor pulls):
        they materialize lazily as FT.CURSOR READ drains them, and the
        result holds the first read and the cursor id (0 when done).
        Armed debug hooks cut the rows after `timeout_after_n` under the
        ON_TIMEOUT policy; a cursor then pages the materialized rows."""
        ix = self._index(name)
        dbg = ix.take_debug_hooks()
        if req.with_cursor and not dbg:
            chunks, total = run_aggregate_streaming(ix, req)
            if getattr(req, "dialect", None) in (1, 2, 3, 4):
                ix.dialect_stats[req.dialect] = 1
            c = self.cursors.create(name, [],
                                    count=req._cursor_count or 1000,
                                    source=chunks)
            chunk, cid = self.cursors.read(c.cid)
            return AggregateResult(total=total, rows=chunk, cursor_id=cid)
        res = run_aggregate(ix, req)
        if getattr(req, "dialect", None) in (1, 2, 3, 4):
            ix.dialect_stats[req.dialect] = 1
        if dbg and dbg.get("timeout_after_n") is not None:
            n = int(dbg["timeout_after_n"])
            if len(res.rows) > n:
                if ix.on_timeout == "fail":
                    from .utils.errors import TimeoutError_
                    raise TimeoutError_("Timeout limit was reached")
                res.rows = res.rows[:n]
                res.warnings = ["Timeout limit was reached"]
        if req.with_cursor:
            c = self.cursors.create(name, res.rows,
                                    count=req._cursor_count or 1000)
            chunk, cid = self.cursors.read(c.cid)
            return AggregateResult(total=res.total, rows=chunk,
                                   cursor_id=cid)
        return res

    def ft_cursor_read(self, name: str, cursor_id: int,
                       count: Optional[int] = None):
        """FT.CURSOR READ — returns (rows, cursor_id or 0)."""
        return self.cursors.read(cursor_id, count)

    def ft_cursor_del(self, name: str, cursor_id: int) -> bool:
        """FT.CURSOR DEL — whether the cursor existed."""
        return self.cursors.delete(cursor_id)

    def ft_explain(self, name: str, query: str, params=None,
                   dialect: int = 2) -> str:
        """FT.EXPLAIN: the parsed query tree as text."""
        return self._index(name).explain(query, params, dialect)

    def ft_profile(self, name: str, query_type: str, query,
                   **opts) -> tuple[Any, dict]:
        """FT.PROFILE <idx> SEARCH|AGGREGATE QUERY <q> — returns
        (result, profile) with the reference's clock structure
        (parse/pipeline-build/execution times, per-shard sections).
        Every clock is read after a synchronize of the index's card."""
        ix = self._index(name)
        prof: dict[str, Any] = {}
        t0 = time.perf_counter()
        from .query import ast as A
        if query_type.upper() == "SEARCH":
            root = ix.parse_query(query, opts.get("params"))
            prof["parsing_time_ms"] = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            res = ix.search(query, **opts)
            _sync(ix)
            prof["total_time_ms"] = (time.perf_counter() - t0) * 1e3
            prof["execution_time_ms"] = (time.perf_counter() - t1) * 1e3
            prof["query_tree"] = A.dump(root)
            prof["results_count"] = res.total
            # warm re-execution: the clock the per-node timings should
            # reconcile against (the first execution may build kernels)
            t2 = time.perf_counter()
            ix.search(query, **opts)
            _sync(ix)
            prof["warm_execution_time_ms"] = \
                (time.perf_counter() - t2) * 1e3
            # per-node counters + measured warm timings (reference:
            # Profile_AddIters sections)
            from .aux.explain import profile_query
            prof["iterators"] = profile_query(ix, query,
                                              opts.get("params"))
            return res, prof
        elif query_type.upper() == "AGGREGATE":
            root = ix.parse_query(query.query, query.params,
                                  getattr(query, "dialect", 2))
            prof["parsing_time_ms"] = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            # measured per-stage timings land in prof["result_processors"]
            # (reference: per-RP profile sections, result_processor.h)
            res = run_aggregate(ix, query, profile=prof)
            _sync(ix)
            prof["total_time_ms"] = (time.perf_counter() - t0) * 1e3
            prof["execution_time_ms"] = (time.perf_counter() - t1) * 1e3
            prof["query_tree"] = A.dump(root)
            prof["results_count"] = res.total
            return res, prof
        raise IndexError_(f"bad profile type {query_type}")

    def ft_explainscore(self, name: str, query: str, key: str,
                        params: Optional[dict] = None,
                        scorer: str = "BM25STD") -> dict:
        """EXPLAINSCORE: score-explanation tree for one result document."""
        from .aux.explain import explain_score
        return explain_score(self._index(name), query, key, params, scorer)

    def ft_tagvals(self, name: str, field: str) -> list[str]:
        """FT.TAGVALS: the distinct values of a TAG field, sorted."""
        ix = self._index(name)
        ix.commit()
        f = ix.schema.field(field)
        vals: set[str] = set()
        for seg in ix.segments:
            tp = seg.tags.get(f.attribute)
            if tp is not None:
                vals.update(tp.values)
        return sorted(vals)

    # -- aliases ---------------------------------------------------------------
    def ft_aliasadd(self, alias: str, name: str) -> None:
        if alias in self._aliases:
            raise IndexError_("Alias already exists")
        self._index(name)
        self._aliases[alias] = name

    def ft_aliasupdate(self, alias: str, name: str) -> None:
        self._index(name)
        self._aliases[alias] = name

    def ft_aliasdel(self, alias: str) -> None:
        if alias not in self._aliases:
            raise IndexError_("Alias does not exist")
        del self._aliases[alias]

    def ft_aliaslist(self, name: Optional[str] = None) -> dict:
        """alias -> index map (reference: FT.ALIASLIST, src/alias.c —
        the coordinator lists every alias; with `name` only the aliases
        of that index)."""
        if name is None:
            return dict(self._aliases)
        self._index(name)
        return {a: n for a, n in self._aliases.items() if n == name}

    # -- dictionaries / spellcheck ------------------------------------------------
    def ft_dictadd(self, dict_name: str, *terms: str) -> int:
        return self.dicts.add(dict_name, *terms)

    def ft_dictdel(self, dict_name: str, *terms: str) -> int:
        return self.dicts.delete(dict_name, *terms)

    def ft_dictdump(self, dict_name: str) -> list[str]:
        return self.dicts.dump(dict_name)

    def ft_spellcheck(self, name: str, query: str, distance: int = 1,
                      include: Optional[list[str]] = None,
                      exclude: Optional[list[str]] = None) -> list[dict]:
        return spellcheck(self._index(name), query, distance,
                          include, exclude, self.dicts)

    # -- suggestions ----------------------------------------------------------------
    def ft_sugadd(self, key: str, term: str, score: float,
                  increment: bool = False,
                  payload: Optional[str] = None) -> int:
        d = self._suggestions.setdefault(key, SuggestionDictionary())
        return d.add(term, score, increment, payload)

    def ft_sugget(self, key: str, prefix: str, fuzzy: bool = False,
                  max_results: int = 5, with_scores: bool = False,
                  with_payloads: bool = False):
        d = self._suggestions.get(key)
        if d is None:
            return []
        return d.get(prefix, fuzzy, max_results, with_scores, with_payloads)

    def ft_sugdel(self, key: str, term: str) -> bool:
        d = self._suggestions.get(key)
        return d.delete(term) if d is not None else False

    def ft_suglen(self, key: str) -> int:
        d = self._suggestions.get(key)
        return len(d) if d is not None else 0

    # -- debug (reference: FT.DEBUG family, src/debug_commands.c) ----------------
    def ft_debug(self, sub: str, name: str, *args):
        """Debug/introspection commands:
        GC_FORCEINVOKE   — compact now (SearchIndex.compact, the fork-GC
                           force analog)
        DUMP_INVIDX      — postings of a term: [(doc key, tf), ...]
        DUMP_NUMIDX      — numeric column (value-sorted) for a field
        DUMP_TAGIDX      — tag value -> doc keys
        DUMP_TERMS       — the term dictionary
        SEGMENTS         — per-segment stats
        DUMP_PHONETIC_HASH — [primary, secondary] double-metaphone codes
                           of a term (reference: debug_commands.c:996)
        The dumps find each window through the segments' host mirrors
        (term_offsets_np, sorted_vals_np, offsets_np, gids_host) and copy
        it from the device in one piece."""
        sub = sub.upper()
        if sub == "DUMP_PHONETIC_HASH":
            # `name` is the term here (this subcommand takes no index)
            from .analysis.phonetics import dm_codes
            p, q = dm_codes(str(name))
            return [p, q]
        ix = self._index(name)
        ix.commit()
        if sub == "GC_FORCEINVOKE":
            ix.compact()
            return "DONE"
        if sub == "DUMP_TERMS":
            out = []
            for seg in ix.segments:
                out.extend(t for t in seg.terms.terms
                           if not t.startswith(("+", "\x01", "~")))
            return sorted(set(out))
        if sub == "SEGMENTS":
            return [{"n_docs": s.n_docs, "n_deleted": s.n_deleted,
                     "n_terms": len(s.terms), "nnz": s.text.nnz,
                     "memory_mb": round(s.memory_bytes() / 1e6, 2)}
                    for s in ix.segments]
        from .aux.explain import _host
        if sub == "DUMP_INVIDX":
            term = args[0].lower()
            out = []
            for seg in ix.segments:
                tid = seg.terms.lookup(term)
                if tid < 0:
                    continue
                toff = seg.text.term_offsets_np
                a, b = int(toff[tid]), int(toff[tid + 1])
                docs = _host(seg.text.doc_ids[a:b])
                tfs = _host(seg.text.freqs[a:b])
                gids = seg.gids_host
                for d, tf in zip(docs, tfs):
                    meta = ix.doctable.get(int(gids[int(d)]))
                    if meta is not None:
                        out.append((meta.key, float(tf)))
            return out
        if sub == "DUMP_NUMIDX":
            field = ix.schema.field(args[0]).attribute
            out = []
            for seg in ix.segments:
                col = seg.numerics.get(field)
                if col is None:
                    continue
                sv = col.sorted_vals_np
                sd = _host(col.sorted_docs[:len(sv)])
                gids = seg.gids_host
                for v, d in zip(sv, sd):
                    if d != 2**31 - 1 and np.isfinite(v):
                        meta = ix.doctable.get(int(gids[int(d)]))
                        if meta is not None:
                            out.append((meta.key, float(v)))
            return out
        if sub == "DUMP_TAGIDX":
            field = ix.schema.field(args[0]).attribute
            out = {}
            for seg in ix.segments:
                tp = seg.tags.get(field)
                if tp is None:
                    continue
                gids = seg.gids_host
                for v in tp.values:
                    vid = tp.ids[v]
                    a = int(tp.offsets_np[vid])
                    b = int(tp.offsets_np[vid + 1])
                    docs = _host(tp.doc_ids[a:b])
                    keys = [ix.doctable.get(int(gids[int(d)])).key
                            for d in docs
                            if ix.doctable.get(int(gids[int(d)]))]
                    out.setdefault(v, []).extend(keys)
            return out
        raise IndexError_(f"unknown FT.DEBUG subcommand {sub}")

    # -- config ------------------------------------------------------------------------
    def ft_config_get(self, name: str = "*"):
        return self.config.get(name)

    def ft_config_set(self, name: str, value) -> None:
        self.config.set(name, value)

    # -- legacy document commands (FT.ADD/DEL/GET/MGET) -----------------------
    def ft_add(self, name: str, key: str, score: float, fields: dict,
               payload: Optional[bytes] = None, ttl: Optional[float] = None,
               replace: bool = False, partial: bool = False,
               nocreate: bool = False, nosave: bool = False,
               if_expr: Optional[str] = None,
               language: Optional[str] = None) -> str:
        """Legacy FT.ADD with the reference's option set
        (src/document_add.c:32-226):

        * doc exists without REPLACE        -> DocumentExists error
        * NOCREATE on a missing doc         -> DocumentNotFound error
        * IF <expr> on an existing doc: evaluated against the CURRENT
          fields; falsy OR a dereference of a missing property -> "NOADD"
          (exists(@f) may probe missing properties)
        * REPLACE without PARTIAL wipes the old fields; PARTIAL merges
        * NOSAVE indexes without writing the keyspace hash
        * LANGUAGE overrides the per-doc analysis language

        Returns "OK" or "NOADD"."""
        from .utils.errors import DocumentExists, DocumentNotFound
        old = self._keyspace.get(key)
        exists = old is not None
        if not exists and nocreate:
            raise DocumentNotFound("Document does not exist")
        if exists and not replace:
            raise DocumentExists("Document already exists")
        if exists and if_expr is not None:
            from .agg import expr as E
            parsed = E.parse(if_expr)

            def deref_missing(e) -> bool:
                if e.kind == "prop":
                    return e.val not in old
                if e.kind == "call" and e.val == "exists":
                    return False
                return any(deref_missing(a) for a in e.args)

            if deref_missing(parsed) or not E._truthy(
                    E.evaluate(parsed, dict(old))):
                return "NOADD"
        new_fields = dict(fields)
        if partial and exists:
            new_fields = {**old, **new_fields}
        if not nosave:
            self._keyspace[key] = dict(new_fields)
        self._index(name).add_document(key, dict(new_fields), score=score,
                                       payload=payload, ttl=ttl,
                                       language=language)
        return "OK"

    def ft_del(self, name: str, key: str,
               delete_document: bool = False) -> bool:
        ok = self._index(name).delete_document(key)
        if delete_document:
            self._keyspace.pop(key, None)
        return ok

    def ft_get(self, name: str, key: str) -> Optional[dict]:
        """FT.GET: the doc's keyspace hash, nil when unknown to the index
        OR not saved (NOSAVE docs are indexed but have no hash)."""
        meta = self._index(name).doctable.get_by_key(key)
        if meta is None or meta.deleted:
            return None
        doc = self._keyspace.get(key)
        return dict(doc) if doc is not None else None

    def ft_mget(self, name: str, *keys: str) -> list[Optional[dict]]:
        return [self.ft_get(name, k) for k in keys]

    # -- synonyms --------------------------------------------------------------
    def ft_synupdate(self, name: str, group_id: str,
                     terms: Iterable[str],
                     skip_initial_scan: bool = False) -> None:
        """FT.SYNUPDATE; unless skip_initial_scan, existing docs pick up
        the group terms through a reanalyzing compaction (a CSR slice
        would keep the old analysis)."""
        ix = self._index(name)
        ix.synonyms.update(group_id, terms)
        if not skip_initial_scan:
            ix.compact(reanalyze=True)

    def ft_syndump(self, name: str) -> dict[str, list[str]]:
        return self._index(name).synonyms.dump()

    # -- checkpoint --------------------------------------------------------------
    def save_index(self, name: str, path: str) -> None:
        """Checkpoint an index to the directory `path`, in the format both
        packages load (aux.checkpoint)."""
        from .aux.checkpoint import save
        save(self._index(name), path)

    def load_index(self, name: str, path: str) -> SearchIndex:
        """Load a checkpoint written by either package onto this client's
        device, as index `name`."""
        from .aux.checkpoint import load
        ix = load(path, device=self.device)
        self._indexes[name] = ix
        return ix

    # -- internals -------------------------------------------------------------
    def _resolve(self, name: str) -> str:
        return self._aliases.get(name, name)

    def _index(self, name: str) -> SearchIndex:
        ix = self._indexes.get(self._resolve(name))
        if ix is None:
            raise IndexNotFound(name)
        return ix
