"""Client: the command surface of the torch port.

Counterpart of `redisearch_tpu/api.py` for the port's paths: FT.CREATE
(`ft_create`), HSET (`hset`: writes the document store and routes to
every index whose rule matches), FT.SEARCH (`ft_search`, and batched
`ft_search_many`; KNN and VECTOR_RANGE queries take their vectors as
PARAMS blobs: `params={"b": vec}`, one dict a query in the batched
call), FT.AGGREGATE (`ft_aggregate`, with WITHCURSOR streaming its rows
through `ft_cursor_read` / `ft_cursor_del`, and batched
`ft_aggregate_many`) and FT.HYBRID (`ft_hybrid`).  The other FT.*
commands are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

import torch

from .agg.cursor import CursorList
from .agg.pipeline import (AggregateRequest, AggregateResult,
                           run_aggregate_streaming)
from .aux.hybrid import HybridQuery, run_hybrid
from .schema import Field, Schema
from .utils import log as _log
from .utils.errors import IndexExists, IndexNotFound, RSError
from .index.index import SearchIndex, SearchResult, default_device


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
        self.cursors = CursorList()

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

    # -- keyspace ------------------------------------------------------------
    def hset(self, key: str, fields: dict[str, Any],
             ttl: Optional[float] = None) -> None:
        """Write a document; routes to all matching indexes."""
        self._keyspace[key] = dict(fields)
        for ix in self._indexes.values():
            if self._rule_matches(ix.schema, key, fields):
                ix.add_document(key, dict(fields), ttl=ttl)
            elif key in ix.doctable:
                meta = ix.doctable.delete(key)  # no longer matches the rule
                ix._mark_deleted(meta.gid)

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
        (SearchIndex.search); expired fields are dropped from the
        returned documents.  HIGHLIGHT, SUMMARIZE and legacy FILTER
        arguments are not ported yet."""
        if highlight is not None or summarize is not None or filters:
            raise NotImplementedError(
                "HIGHLIGHT / SUMMARIZE / FILTER are not ported yet "
                "(ROADMAP A13)")
        dialect = int(opts.get("dialect", 2))
        if not 1 <= dialect <= 4:
            raise RSError("DIALECT requires a non negative integer "
                          ">=1 and <= 4")
        ix = self._index(name)
        res = ix.search(query, **opts)
        for hit in res.hits:       # field-level TTL (HEXPIRE analog)
            if hit.fields is None:
                continue
            meta = ix.doctable.get(hit.gid)
            if meta is None or not meta.field_expiration:
                continue
            for f in list(hit.fields):
                if meta.field_expired(f):
                    del hit.fields[f]
        return res

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
        result holds the first read and the cursor id (0 when done)."""
        ix = self._index(name)
        if req.with_cursor:
            chunks, total = run_aggregate_streaming(ix, req)
            c = self.cursors.create(name, [],
                                    count=req._cursor_count or 1000,
                                    source=chunks)
            chunk, cid = self.cursors.read(c.cid)
            return AggregateResult(total=total, rows=chunk, cursor_id=cid)
        return ix.aggregate(req)

    def ft_cursor_read(self, name: str, cursor_id: int,
                       count: Optional[int] = None):
        """FT.CURSOR READ — returns (rows, cursor_id or 0)."""
        return self.cursors.read(cursor_id, count)

    def ft_cursor_del(self, name: str, cursor_id: int) -> bool:
        """FT.CURSOR DEL — whether the cursor existed."""
        return self.cursors.delete(cursor_id)

    # -- internals -------------------------------------------------------------
    def _resolve(self, name: str) -> str:
        return self._aliases.get(name, name)

    def _index(self, name: str) -> SearchIndex:
        ix = self._indexes.get(self._resolve(name))
        if ix is None:
            raise IndexNotFound(name)
        return ix
