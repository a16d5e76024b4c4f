"""Client: the command surface of the torch port.

Counterpart of `redisearch_tpu/api.py`.  Its indexes follow the
client's own document store: `hset` / `hdel` write it and route to
every index whose rule (prefixes + FILTER) matches.  Commands:

  CREATE/ALTER/DROPINDEX/_LIST  -> ft_create / ft_alter / ft_dropindex /
                                   ft_list
  SEARCH                        -> ft_search, batched ft_search_many (KNN
                                   and VECTOR_RANGE take their vectors
                                   as PARAMS blobs: params={"b": vec},
                                   one dict a query in the batched call)
  AGGREGATE                     -> ft_aggregate, batched
                                   ft_aggregate_many
  CURSOR READ / DEL             -> ft_cursor_read / ft_cursor_del
  HYBRID                        -> ft_hybrid
  ADD / DEL / GET / MGET        -> ft_add / ft_del / ft_get / ft_mget
  SYN{UPDATE,DUMP}              -> ft_synupdate / ft_syndump
  HSET/HGET/HDEL/EXPIRE/HEXPIRE -> hset / hget / hdel / expire / hexpire
  checkpoints (both packages')  -> save_index / load_index

FT.INFO, FT.DEBUG, config, aliases, explain, profile, spellcheck,
suggestions, highlighting and the wire server are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable, Optional, Sequence

import numpy as np
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
