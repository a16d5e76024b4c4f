# Copy of redisearch_tpu/server.py: the port imports nothing of the JAX package.
"""RESP wire-protocol server: real Redis clients can talk to the engine.

Reference: the module/API layer (src/module.c command handlers +
commands.json argv schemas + src/reply.c RESP2/RESP3 reply builder).  This
is the standalone equivalent: an asyncio TCP server speaking RESP2 and
RESP3 (negotiated per-connection via HELLO, like redis), parsing the FT.*
argv grammars into Client calls and rendering replies with the reference's
shapes (RESP2: FT.SEARCH -> [total, key, [field, value, ...], ...];
RESP3: map replies with total_results/results/extra_attributes, matching
src/reply.c + src/aggregate/aggregate_exec.c sendChunk_Resp3).

Concurrency model (reference analog: WORKERS thread pool running queries
off the main thread under the spec rwlock, src/util/workers.c +
docs/design/sound_iterator_revalidation.md): read commands (searches,
aggregations) run concurrently on a thread pool under a shared read lock;
mutating commands (HSET, FT.CREATE, ...) take the write lock exclusively.
Immutable device segments make concurrent reads snapshot-safe by
construction, so no Revalidate protocol is needed.

The port's copy serves the port's `Client`: `Server()` builds a
`Client()` on the card (and raises without one), `Server(client=
Client(device="cpu"))` serves on the CPU.  Its micro-batcher hands each
group of concurrent FT.SEARCHes to `ft_search_many` as it formed, with
no padding to a fixed width (that only kept one compiled XLA executable
a shape).

Usage:
    from redisearch_tpu_torch.server import Server
    Server(port=6380).run()          # or await .serve() in an event loop

Any RESP client works:  redis-cli -3 -p 6380 FT.SEARCH idx "hello world"
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import Any, Optional

import numpy as np

from .agg.pipeline import AggregateRequest
from .api import Client
from .aux.hybrid import HybridQuery
from .schema import Field, FieldType, VectorParams
from .utils.errors import RSError

CRLF = b"\r\n"


# ---------------------------------------------------------------------------
# RESP2 codec
# ---------------------------------------------------------------------------

async def read_command(reader: asyncio.StreamReader) -> Optional[list]:
    """Parse one RESP array-of-bulk-strings command (or inline)."""
    line = await reader.readline()
    if not line:
        return None
    line = line.rstrip()
    if not line:
        return []
    if line[0:1] != b"*":
        return [p.decode() for p in line.split()]  # inline command
    n = int(line[1:])
    argv = []
    for _ in range(n):
        hdr = (await reader.readline()).rstrip()
        if hdr[0:1] != b"$":
            raise ValueError("expected bulk string")
        ln = int(hdr[1:])
        data = await reader.readexactly(ln + 2)
        argv.append(data[:-2])
    return [a.decode("utf-8", "surrogateescape") for a in argv]


def encode(obj: Any, proto: int = 2) -> bytes:
    """Encode a python value as RESP2 (proto=2) or RESP3 (proto=3)."""
    if isinstance(obj, ProtoReply):
        return encode(obj.r2 if proto == 2 else obj.r3, proto)
    if obj is None:
        return (b"_" + CRLF) if proto == 3 else (b"$-1" + CRLF)
    if isinstance(obj, RSError):
        return b"-" + type(obj).__name__.encode() + b" " + str(
            obj).encode() + CRLF
    if isinstance(obj, Exception):
        return b"-ERR " + str(obj).encode()[:200] + CRLF
    if isinstance(obj, bool):
        if proto == 3:
            return b"#t" + CRLF if obj else b"#f" + CRLF
        return b":1" + CRLF if obj else b":0" + CRLF
    if isinstance(obj, (int, np.integer)):
        return b":" + str(int(obj)).encode() + CRLF
    if isinstance(obj, (float, np.floating)):
        if proto == 3:
            return b"," + repr(float(obj)).encode() + CRLF
        s = repr(float(obj)).encode()
        return b"$" + str(len(s)).encode() + CRLF + s + CRLF
    if isinstance(obj, _Status):
        return b"+" + obj.s.encode() + CRLF
    if isinstance(obj, bytes):
        return b"$" + str(len(obj)).encode() + CRLF + obj + CRLF
    if isinstance(obj, str):
        b = obj.encode("utf-8", "surrogateescape")
        return b"$" + str(len(b)).encode() + CRLF + b + CRLF
    if isinstance(obj, dict):
        if proto == 3:
            out = b"%" + str(len(obj)).encode() + CRLF
            return out + b"".join(encode(k, proto) + encode(v, proto)
                                  for k, v in obj.items())
        flat: list = []
        for k, v in obj.items():
            flat.extend([k, v])
        return encode(flat, proto)
    if isinstance(obj, (list, tuple)):
        out = b"*" + str(len(obj)).encode() + CRLF
        return out + b"".join(encode(x, proto) for x in obj)
    return encode(str(obj), proto)


class _Status:
    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s


class ProtoReply:
    """A reply with distinct RESP2 and RESP3 renderings (src/reply.c)."""
    __slots__ = ("r2", "r3")

    def __init__(self, r2, r3):
        self.r2 = r2
        self.r3 = r3


OK = _Status("OK")


# ---------------------------------------------------------------------------
# argv parsing helpers
# ---------------------------------------------------------------------------

class Argv:
    def __init__(self, args: list[str]):
        self.a = args
        self.i = 0

    def more(self) -> bool:
        return self.i < len(self.a)

    def peek(self) -> str:
        return self.a[self.i].upper() if self.more() else ""

    def next(self) -> str:
        v = self.a[self.i]
        self.i += 1
        return v

    def next_int(self) -> int:
        return int(float(self.next()))

    def next_float(self) -> float:
        return float(self.next())

    def take(self, n: int) -> list[str]:
        out = self.a[self.i:self.i + n]
        self.i += n
        return out


def _parse_schema(av: Argv) -> list[Field]:
    fields = []
    while av.more():
        name = av.next()
        alias = None
        if av.peek() == "AS":
            av.next()
            alias = av.next()
        ftype = av.next().upper()
        kw: dict = {}
        if ftype == "VECTOR":
            algo = av.next()
            nargs = av.next_int()
            params = av.take(nargs)
            vp: dict = {}
            for j in range(0, len(params), 2):
                vp[params[j].upper()] = params[j + 1]
            kw["vector"] = VectorParams(
                dim=int(vp.get("DIM", 0)), algo=algo,
                metric=vp.get("DISTANCE_METRIC", "COSINE"),
                dtype=vp.get("TYPE", "FLOAT32").upper(),
                m=int(vp.get("M", 16)),
                ef_construction=int(vp.get("EF_CONSTRUCTION", 200)),
                ef_runtime=int(vp.get("EF_RUNTIME", 10)),
                nlist=int(vp.get("NLIST", 0)),
                nprobe=int(vp.get("NPROBE", 8)),
                multi=vp.get("MULTI", "FALSE").upper() == "TRUE",
                flat_buffer_limit=int(vp.get("FLAT_BUFFER_LIMIT", 1024)),
                storage=vp.get("STORAGE", "hbm").lower())
        # field options
        while av.more():
            opt = av.peek()
            if opt == "WEIGHT":
                av.next()
                kw["weight"] = av.next_float()
            elif opt == "SEPARATOR":
                av.next()
                kw["separator"] = av.next()
            elif opt == "NOSTEM":
                av.next()
                kw["nostem"] = True
            elif opt == "SORTABLE":
                av.next()
                kw["sortable"] = True
                if av.peek() == "UNF":
                    av.next()
                    kw["unf"] = True
            elif opt == "NOINDEX":
                av.next()
                kw["noindex"] = True
            elif opt == "CASESENSITIVE":
                av.next()
                kw["casesensitive"] = True
            elif opt == "WITHSUFFIXTRIE":
                av.next()
                kw["withsuffixtrie"] = True
            elif opt == "INDEXMISSING":
                av.next()
                kw["indexmissing"] = True
            elif opt == "INDEXEMPTY":
                av.next()
                kw["indexempty"] = True
            elif opt == "PHONETIC":
                av.next()
                kw["phonetic"] = av.next()
            else:
                break
        fields.append(Field(name, FieldType(ftype), alias=alias, **kw))
    return fields


def _parse_params(av: Argv) -> dict:
    n = av.next_int()
    kv = av.take(n)
    return {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class _RWLock:
    """Async readers/writer lock (writer-preferring).

    Reference analog: per-spec pthread rwlock + WORKERS pool
    (src/util/workers.c); here reads are wait-free against each other and
    snapshot-safe against the immutable device segments.
    """

    def __init__(self):
        self._cond = asyncio.Condition()
        self._readers = 0
        self._writer = False
        self._waiting_writers = 0

    async def acquire_read(self):
        async with self._cond:
            await self._cond.wait_for(
                lambda: not self._writer and self._waiting_writers == 0)
            self._readers += 1

    async def release_read(self):
        async with self._cond:
            self._readers -= 1
            self._cond.notify_all()

    async def acquire_write(self):
        async with self._cond:
            self._waiting_writers += 1
            try:
                await self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0)
            finally:
                self._waiting_writers -= 1
            self._writer = True

    async def release_write(self):
        async with self._cond:
            self._writer = False
            self._cond.notify_all()


# Commands that never mutate engine state: run concurrently (read lock).
_READ_CMDS = {
    "PING", "COMMAND", "HGETALL", "FT.SEARCH", "FT.AGGREGATE", "FT.HYBRID",
    "FT.PROFILE", "FT.EXPLAIN", "FT.EXPLAINCLI", "FT.INFO", "FT._LIST",
    "FT.SUGGET", "FT.SUGLEN", "FT.TAGVALS", "FT.SYNDUMP", "FT.DICTDUMP",
    "FT.SPELLCHECK",
}


class Server:
    def __init__(self, client: Optional[Client] = None, host="127.0.0.1",
                 port: int = 6380, workers: int = 4,
                 micro_batch: bool = True, batch_max: int = 128):
        self.client = client or Client()
        self.host = host
        self.port = port
        self._lock = _RWLock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="rs-worker")
        # micro-batching: concurrent FT.SEARCHes coalesce into one device
        # batch (the TPU analog of the reference's WORKERS pool — device
        # batching is this hardware's concurrency axis)
        self._micro_batch = micro_batch
        self._batch_max = batch_max
        self._bq: Optional[asyncio.Queue] = None
        # micro-batch size -> count of groups of that size (a group of
        # one runs ft_search, a larger one ft_search_many)
        self.batch_sizes: dict[int, int] = {}
        # which RESP parser served the last connection ("native" or
        # "python")
        self.parser = None

    # -- micro-batching ------------------------------------------------------
    _SIMPLE_OPTS = {"offset", "num", "params", "dialect", "scorer"}

    def _batchable(self, spec: dict) -> bool:
        return (spec["highlight"] is None and spec["summarize"] is None
                and not spec["filters"]
                and spec["return_fields"] is None
                and set(spec["opts"]) <= self._SIMPLE_OPTS)

    async def _batcher(self):
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self._bq.get()]
            while len(batch) < self._batch_max:
                try:
                    batch.append(self._bq.get_nowait())
                except asyncio.QueueEmpty:
                    break
            await self._lock.acquire_read()
            try:
                replies = await loop.run_in_executor(
                    self._pool, self._exec_search_batch,
                    [spec for spec, _ in batch])
            except Exception as e:   # defensive: fail every waiter
                replies = [RSError(str(e))] * len(batch)
            finally:
                await self._lock.release_read()
            for (_spec, fut), rep in zip(batch, replies):
                if not fut.done():
                    fut.set_result(rep)

    def _exec_search_batch(self, specs: list[dict]) -> list:
        out: list = [None] * len(specs)
        groups: dict = {}
        cfg_scorer = str(self.client.config.get("DEFAULT_SCORER"))
        cfg_dialect = int(self.client.config.get("DEFAULT_DIALECT"))
        for i, s in enumerate(specs):
            o = s["opts"]
            key = (s["name"], o.get("scorer", cfg_scorer),
                   int(o.get("dialect", cfg_dialect)))
            groups.setdefault(key, []).append(i)
        for (name, scorer, dialect), idxs in groups.items():
            self.batch_sizes[len(idxs)] = (
                self.batch_sizes.get(len(idxs), 0) + 1)
            try:
                if len(idxs) == 1:
                    i = idxs[0]
                    out[i] = self.dispatch_spec(specs[i])
                    continue
                queries = [specs[i]["query"] for i in idxs]
                params = [specs[i]["opts"].get("params") for i in idxs]
                k = max(specs[i]["opts"].get("offset", 0)
                        + specs[i]["opts"].get("num", 10) for i in idxs)
                k = int(max(k, 10))
                resl = self.client.ft_search_many(
                    name, queries, params, k=k, scorer=scorer,
                    dialect=dialect)
                for i, res in zip(idxs, resl):
                    off = specs[i]["opts"].get("offset", 0)
                    num = specs[i]["opts"].get("num", 10)
                    res.hits = res.hits[off:off + num]
                    out[i] = self._format_search(res, specs[i])
            except RSError as e:
                for i in idxs:
                    if out[i] is None:
                        self._count_query_error("FT.SEARCH", e)
                        out[i] = e
            except Exception as e:
                for i in idxs:
                    if out[i] is None:
                        self._count_query_error("FT.SEARCH", None)
                        out[i] = RSError(f"{type(e).__name__}: {e}")
        return out

    def dispatch_spec(self, spec: dict):
        try:
            return self._run_search(spec)
        except RSError as e:
            self._count_query_error("FT.SEARCH", e)
            return e
        except Exception as e:
            self._count_query_error("FT.SEARCH", None)
            return RSError(f"{type(e).__name__}: {e}")

    # -- command dispatch ---------------------------------------------------
    # query-command error codes feed the global error stats (reference:
    # QueryErrorsGlobalStats_UpdateError, src/info/global_stats.c:184 —
    # syntax / arguments / timeout / oom)
    _QUERY_CMDS = frozenset({
        "FT.SEARCH", "FT.AGGREGATE", "FT.HYBRID", "FT.PROFILE",
        "FT.CURSOR"})
    _ERRSTAT_BY_CODE = {
        "ESYNTAX": "syntax", "EPARSEARGS": "arguments",
        "EBADVAL": "arguments", "ETIMEDOUT": "timeout", "EOOM": "oom"}

    def dispatch(self, argv: list[str]):
        if not argv:
            return RSError("empty command")
        cmd = argv[0].upper()
        av = Argv(argv[1:])
        try:
            handler = getattr(self, "_cmd_" + cmd.replace(".", "_")
                              .replace("-", "_"), None)
            if handler is None:
                return RSError(f"unknown command '{argv[0]}'")
            return handler(av)
        except RSError as e:
            self._count_query_error(cmd, e)
            return e
        except Exception as e:  # command errors become RESP errors
            self._count_query_error(cmd, None)
            return RSError(f"{type(e).__name__}: {e}")

    def _count_query_error(self, cmd: str, err) -> None:
        if cmd not in self._QUERY_CMDS:
            return
        bucket = self._ERRSTAT_BY_CODE.get(
            getattr(err, "code", None), None)
        stats = getattr(self, "_query_error_stats", None)
        if stats is None:
            stats = self._query_error_stats = {
                "syntax": 0, "arguments": 0, "timeout": 0, "oom": 0}
        if bucket is not None:
            stats[bucket] += 1

    # -- generic ----------------------------------------------------------
    def _cmd_PING(self, av):
        return _Status("PONG") if not av.more() else av.next()

    def _cmd_HELLO(self, av):
        # handled per-connection in handle(); this path answers HELLO with
        # no version change (dispatch fallback).
        return self._hello_reply(2)

    @staticmethod
    def _hello_reply(proto: int):
        info = {"server": "redisearch_tpu", "version": "0.1.0",
                "proto": proto, "id": 1, "mode": "standalone",
                "role": "master", "modules": []}
        flat: list = []
        for k, v in info.items():
            flat.extend([k, v])
        return ProtoReply(flat, info)

    def _cmd_COMMAND(self, av):
        return []

    def _cmd_INFO(self, av):
        """INFO [MODULES|SEARCH|EVERYTHING] — module stats section
        (reference: RS_moduleInfoFunc, src/info/info_redis/)."""
        idx = list(self.client._indexes.values())
        dialects = {d: max((ix.dialect_stats[d] for ix in idx), default=0)
                    for d in (1, 2, 3, 4)}
        total_docs = sum(len(ix.doctable) for ix in idx)
        mem = sum(sum(s.memory_bytes() for s in ix.segments) for ix in idx)
        lines = [
            "# search_version",
            "search_version:0.1.0",
            "search_redisearch_tpu:1",
            "# search_index",
            f"search_number_of_indexes:{len(idx)}",
            f"search_total_docs:{total_docs}",
            f"search_used_memory_indexes:{mem}",
            "# search_dialect_statistics",
        ]
        lines += [f"search_dialect_{d}:{v}" for d, v in dialects.items()]
        qerrs = sum(ix.index_errors["count"] for ix in idx)
        lines += ["# search_runtime_configurations",
                  f"search_errors_indexing_failures:{qerrs}"]
        es = getattr(self, "_query_error_stats",
                     {"syntax": 0, "arguments": 0, "timeout": 0,
                      "oom": 0})
        lines += ["# search_query_errors"] + [
            f"shard_total_query_errors_{k}:{v}" for k, v in es.items()]
        return "\r\n".join(lines) + "\r\n"

    def _cmd_HSET(self, av):
        key = av.next()
        fields = {}
        while av.more():
            f = av.next()
            fields[f] = av.next()
        existing = self.client.hget(key) or {}
        n_new = sum(1 for f in fields if f not in existing)
        existing.update(fields)
        self.client.hset(key, existing)
        return n_new

    def _cmd_HGETALL(self, av):
        d = self.client.hget(av.next())
        return {k: str(v) for k, v in (d or {}).items()}

    def _cmd_DEL(self, av):
        n = 0
        while av.more():
            n += 1 if self.client.hdel(av.next()) else 0
        return n

    def _cmd_EXPIRE(self, av):
        key = av.next()
        self.client.expire(key, av.next_float())
        return 1

    def _cmd_HEXPIRE(self, av):
        # HEXPIRE key seconds [NX|XX|GT|LT] FIELDS n field...
        key = av.next()
        seconds = av.next_float()
        while av.more() and av.peek() in ("NX", "XX", "GT", "LT"):
            av.next()
        if av.peek() == "FIELDS":
            av.next()
        n = av.next_int()
        fields = av.take(n)
        return self.client.hexpire(key, seconds, fields)

    def _cmd_JSON_SET(self, av):
        import json as _json
        key = av.next()
        path = av.next()
        doc = _json.loads(av.next())
        if path not in ("$", "."):
            return RSError("only root path supported")
        self.client.hset(key, doc)
        return OK

    # -- index lifecycle ----------------------------------------------------
    def _cmd_FT_CREATE(self, av):
        name = av.next()
        on_json = False
        prefixes: list[str] = [""]
        filter_expr = None
        language = "english"
        stopwords = None
        score_field = None
        storage = "hbm"
        while av.more():
            opt = av.peek()
            if opt == "ON":
                av.next()
                on_json = av.next().upper() == "JSON"
            elif opt == "PREFIX":
                av.next()
                n = av.next_int()
                prefixes = av.take(n)
            elif opt == "FILTER":
                av.next()
                filter_expr = av.next()
            elif opt == "LANGUAGE":
                av.next()
                language = av.next()
            elif opt == "LANGUAGE_FIELD":
                av.next()
                av.next()
            elif opt == "SCORE":
                av.next()
                av.next()
            elif opt == "SCORE_FIELD":
                av.next()
                score_field = av.next()
            elif opt == "STOPWORDS":
                av.next()
                n = av.next_int()
                stopwords = av.take(n)
            elif opt == "STORAGE":
                # beyond-HBM cold segments (Schema.storage="host")
                av.next()
                storage = av.next().lower()
            elif opt in ("NOOFFSETS", "NOHL", "NOFIELDS", "NOFREQS",
                         "SKIPINITIALSCAN", "MAXTEXTFIELDS", "TEMPORARY",
                         "NOTERMOFFSETS"):
                av.next()
                if opt == "TEMPORARY":
                    av.next()
            elif opt == "SCHEMA":
                av.next()
                fields = _parse_schema(av)
                self.client.ft_create(
                    name, fields, prefixes=prefixes,
                    filter_expr=filter_expr, language=language,
                    stopwords=stopwords, score_field=score_field,
                    on_json=on_json, storage=storage)
                return OK
            else:
                return RSError(f"Unknown argument `{av.next()}`")
        return RSError("missing SCHEMA")

    def _cmd_FT_DROPINDEX(self, av):
        name = av.next()
        dd = av.more() and av.peek() == "DD"
        self.client.ft_dropindex(name, delete_docs=dd)
        return OK

    def _cmd_FT_ALTER(self, av):
        name = av.next()
        while av.more() and av.peek() in ("SCHEMA", "ADD"):
            av.next()
        fields = _parse_schema(av)
        for f in fields:
            self.client.ft_alter(name, f)
        return OK

    def _cmd_FT__LIST(self, av):
        return self.client.ft_list()

    def _cmd_FT_INFO(self, av):
        info = self.client.ft_info(av.next())
        return ProtoReply(_deep_flatten(info), info)

    # -- search ----------------------------------------------------------
    def _cmd_FT_SEARCH(self, av):
        spec = self._parse_search(av)
        return self._run_search(spec)

    def _run_search(self, spec: dict):
        res = self.client.ft_search(
            spec["name"], spec["query"], highlight=spec["highlight"],
            summarize=spec["summarize"], no_content=spec["no_content"],
            filters=spec["filters"] or None,
            return_fields=spec["return_fields"], **spec["opts"])
        return self._format_search(res, spec)

    def _format_search(self, res, spec: dict):
        with_scores = spec["with_scores"]
        no_content = spec["no_content"]
        out: list = [res.total]
        results3: list = []
        for h in res.hits:
            out.append(h.key)
            row3: dict = {"id": h.key}
            if with_scores:
                out.append(h.score)
                row3["score"] = float(h.score)
            if spec.get("with_payloads"):
                pl = (h.payload.decode("utf-8", "replace")
                      if h.payload else None)
                out.append(pl)
                row3["payload"] = pl
            if spec.get("with_sortkeys"):
                # reference serialization (aggregate_exec.c reeval_key):
                # numbers as "#%.17g", strings prefixed "$", else Null
                sk = h.sortkey
                if isinstance(sk, (int, float)):
                    sk = "#%.17g" % float(sk)
                elif isinstance(sk, str):
                    sk = "$" + sk
                out.append(sk)
                row3["sortkey"] = sk
            if not no_content:
                row: list = []
                attrs: dict = {}
                for k, v in (h.fields or {}).items():
                    row.extend([k, _tostr(v)])
                    attrs[k] = _tostr(v)
                out.append(row)
                row3["extra_attributes"] = attrs
                row3["values"] = []
            results3.append(row3)
        r3 = {"attributes": [], "error": [],
              "total_results": res.total, "format": "STRING",
              "results": results3, "warning": list(res.warnings or [])}
        return ProtoReply(out, r3)

    def _parse_search(self, av) -> dict:
        name = av.next()
        query = av.next()
        opts: dict = {"offset": 0, "num": 10}
        no_content = False
        with_scores = False
        with_sortkeys = False
        with_payloads = False
        return_fields = None
        highlight = None
        summarize = None
        filters: list = []
        while av.more():
            opt = av.peek()
            if opt == "FILTER":
                av.next()
                filters.append(("numeric", av.next(), av.next(), av.next()))
            elif opt == "GEOFILTER":
                av.next()
                filters.append(("geo", av.next(), av.next(), av.next(),
                                av.next(), av.next()))
            elif opt == "LIMIT":
                av.next()
                opts["offset"] = av.next_int()
                opts["num"] = av.next_int()
                self._check_limit(opts["offset"], opts["num"],
                                  "MAXSEARCHRESULTS")
            elif opt == "NOCONTENT":
                av.next()
                no_content = True
            elif opt == "WITHSCORES":
                av.next()
                with_scores = True
            elif opt == "WITHSORTKEYS":
                av.next()
                with_sortkeys = True
            elif opt == "WITHPAYLOADS":
                av.next()
                with_payloads = True
            elif opt == "SORTBY":
                av.next()
                opts["sort_by"] = av.next()
                if av.peek() in ("ASC", "DESC"):
                    opts["sort_asc"] = av.next().upper() == "ASC"
            elif opt == "RETURN":
                av.next()
                n = av.next_int()
                return_fields = []
                j = 0
                while j < n:
                    f = av.next()
                    j += 1
                    if av.peek() == "AS":
                        av.next()
                        av.next()
                        j += 2
                    return_fields.append(f)
            elif opt == "PARAMS":
                av.next()
                opts["params"] = _parse_params(av)
            elif opt == "DIALECT":
                av.next()
                opts["dialect"] = av.next_int()
            elif opt == "SCORER":
                av.next()
                opts["scorer"] = av.next().upper()
            elif opt == "LANGUAGE":
                av.next()
                opts["language"] = av.next()
            elif opt == "SLOP":
                av.next()
                opts["slop"] = av.next_int()
            elif opt == "INORDER":
                av.next()
                opts["inorder"] = True
            elif opt == "VERBATIM":
                av.next()
                opts["verbatim"] = True
            elif opt == "NOSTOPWORDS":
                av.next()
                opts["nostopwords"] = True
            elif opt == "EXPANDER":
                av.next()
                opts["expander"] = av.next()
            elif opt == "TIMEOUT":
                av.next()
                av.next_int()
            elif opt == "HIGHLIGHT":
                av.next()
                highlight = self._parse_hl(av)
            elif opt == "SUMMARIZE":
                av.next()
                summarize = self._parse_sum(av)
            elif opt == "PAYLOAD":
                av.next()
                opts["payload"] = av.next().encode()
            elif opt == "INKEYS":
                av.next()
                opts["in_keys"] = av.take(av.next_int())
            elif opt == "INFIELDS":
                av.next()
                opts["in_fields"] = av.take(av.next_int())
            else:
                raise RSError(f"Unknown argument `{av.next()}`")
        return {"name": name, "query": query, "opts": opts,
                "no_content": no_content, "with_scores": with_scores,
                "with_sortkeys": with_sortkeys,
                "with_payloads": with_payloads,
                "return_fields": return_fields, "highlight": highlight,
                "summarize": summarize, "filters": filters}

    def _parse_hl(self, av) -> dict:
        hl: dict = {}
        while av.more():
            if av.peek() == "FIELDS":
                av.next()
                n = av.next_int()
                hl["fields"] = av.take(n)
            elif av.peek() == "TAGS":
                av.next()
                hl["open_tag"] = av.next()
                hl["close_tag"] = av.next()
            else:
                break
        return hl

    def _parse_sum(self, av) -> dict:
        sm: dict = {}
        while av.more():
            if av.peek() == "FIELDS":
                av.next()
                n = av.next_int()
                sm["fields"] = av.take(n)
            elif av.peek() == "FRAGS":
                av.next()
                sm["num_frags"] = av.next_int()
            elif av.peek() == "LEN":
                av.next()
                sm["frag_len"] = av.next_int()
            elif av.peek() == "SEPARATOR":
                av.next()
                sm["separator"] = av.next()
            else:
                break
        return sm

    # -- aggregate ----------------------------------------------------------
    def _cmd_FT_AGGREGATE(self, av):
        name = av.next()
        req = self._parse_agg_request(av)
        res = self.client.ft_aggregate(name, req)
        rows = [_row_flatten(r) for r in res.rows]
        r2: Any = [len(rows)] + rows
        r3: Any = _agg_map3(res.rows, len(rows))
        if req.with_cursor:
            r2 = [r2, res.cursor_id]
            r3 = [r3, res.cursor_id]
        return ProtoReply(r2, r3)

    def _parse_agg_request(self, av) -> AggregateRequest:
        query = av.next()
        req = AggregateRequest(query)
        while av.more():
            opt = av.peek()
            if opt == "LOAD":
                av.next()
                if av.peek() == "*":
                    av.next()
                    req.load_all()
                else:
                    n = av.next_int()
                    fields = []
                    j = 0
                    while j < n:
                        f = av.next()
                        j += 1
                        if av.peek() == "AS":
                            av.next()
                            av.next()
                            j += 2
                        fields.append(f.lstrip("@"))
                    req.load(*fields)
            elif opt == "GROUPBY":
                av.next()
                n = av.next_int()
                by = [b.lstrip("@") for b in av.take(n)]
                reducers = []
                while av.more() and av.peek() == "REDUCE":
                    av.next()
                    fname = av.next().upper()
                    na = av.next_int()
                    fargs = av.take(na)
                    alias = None
                    if av.peek() == "AS":
                        av.next()
                        alias = av.next()
                    reducers.append((fname, fargs, alias))
                req.group_by(by, *reducers)
            elif opt == "SORTBY":
                av.next()
                n = av.next_int()
                raw = av.take(n)
                keys = []
                j = 0
                while j < len(raw):
                    prop = raw[j]
                    asc = True
                    if j + 1 < len(raw) and raw[j + 1].upper() in ("ASC",
                                                                   "DESC"):
                        asc = raw[j + 1].upper() == "ASC"
                        j += 1
                    keys.append((prop, asc))
                    j += 1
                mx = 0
                if av.peek() == "MAX":
                    av.next()
                    mx = av.next_int()
                req.sort_by(*keys, max=mx)
            elif opt == "APPLY":
                av.next()
                expr = av.next()
                alias = expr
                if av.peek() == "AS":
                    av.next()
                    alias = av.next()
                req.apply(expr, alias)
            elif opt == "FILTER":
                av.next()
                req.filter(av.next())
            elif opt == "LIMIT":
                av.next()
                off = av.next_int()
                num = av.next_int()
                self._check_limit(off, num, "MAXAGGREGATERESULTS")
                req.limit(off, num)
            elif opt == "WITHCURSOR":
                av.next()
                count = 1000
                if av.peek() == "COUNT":
                    av.next()
                    count = av.next_int()
                req.cursor(count)
            elif opt == "PARAMS":
                av.next()
                req.params = _parse_params(av)
            elif opt == "DIALECT":
                av.next()
                req.dialect = av.next_int()
            elif opt == "TIMEOUT":
                av.next()
                av.next_int()
            elif opt == "VERBATIM":
                av.next()
                req.verbatim = True
            else:
                raise RSError(f"Unknown argument `{av.next()}`")
        return req

    def _cmd_FT_CURSOR(self, av):
        sub = av.next().upper()
        name = av.next()
        cid = av.next_int()
        if sub == "READ":
            count = None
            if av.more() and av.peek() == "COUNT":
                av.next()
                count = av.next_int()
            rows, next_cid = self.client.ft_cursor_read(name, cid, count)
            return ProtoReply(
                [[len(rows)] + [_row_flatten(r) for r in rows], next_cid],
                [_agg_map3(rows, len(rows)), next_cid])
        if sub == "DEL":
            return 1 if self.client.ft_cursor_del(name, cid) else 0
        return RSError("unknown FT.CURSOR subcommand")

    # -- the rest ----------------------------------------------------------
    def _cmd_FT_EXPLAIN(self, av):
        name = av.next()
        query = av.next()
        params = None
        while av.more():
            if av.peek() == "PARAMS":
                av.next()
                params = _parse_params(av)
            elif av.peek() == "DIALECT":
                av.next()
                av.next()
            else:
                av.next()
        return self.client.ft_explain(name, query, params)

    _cmd_FT_EXPLAINCLI = _cmd_FT_EXPLAIN

    def _cmd_FT_PROFILE(self, av):
        name = av.next()
        qtype = av.next().upper()
        if av.peek() == "LIMITED":
            av.next()
        if av.peek() == "QUERY":
            av.next()
        rest = av.a[av.i:]
        if qtype == "SEARCH":
            res = self.dispatch(["FT.SEARCH", name] + rest)
            _res2, prof = self.client.ft_profile(name, "SEARCH", rest[0])
            return ProtoReply([getattr(res, "r2", res),
                               _deep_flatten(prof)],
                              [getattr(res, "r3", res), prof])
        res = self.dispatch(["FT.AGGREGATE", name] + rest)
        req = self._parse_agg_request(Argv(rest))
        _res2, prof = self.client.ft_profile(name, "AGGREGATE", req)
        return ProtoReply([getattr(res, "r2", res), _deep_flatten(prof)],
                          [getattr(res, "r3", res), prof])

    def _cmd_FT_DEBUG(self, av):
        """FT.DEBUG <SUBCMD> ... (reference: src/debug_commands.c).
        Query wrapping: FT.DEBUG FT.SEARCH|FT.AGGREGATE <index> <args...>
        DEBUG_PARAMS_COUNT n <TIMEOUT_AFTER_N k|CRASH|PAUSE ms>..."""
        sub = av.next().upper()
        if sub in ("FT.SEARCH", "FT.AGGREGATE"):
            rest = av.a[av.i:]
            # split off DEBUG_PARAMS_COUNT suffix (aggregate_debug.c:93)
            hooks: dict = {}
            for j, tok in enumerate(rest):
                if str(tok).upper() == "DEBUG_PARAMS_COUNT":
                    n = int(rest[j + 1])
                    dp = rest[j + 2:j + 2 + n]
                    i2 = 0
                    while i2 < len(dp):
                        p = str(dp[i2]).upper()
                        if p == "TIMEOUT_AFTER_N":
                            hooks["timeout_after_n"] = int(dp[i2 + 1])
                            i2 += 2
                        elif p == "CRASH":
                            hooks["crash"] = True
                            i2 += 1
                        elif p == "PAUSE":
                            hooks["pause_ms"] = float(dp[i2 + 1])
                            i2 += 2
                        elif p == "INTERNAL_ONLY":
                            i2 += 1
                        else:
                            i2 += 1
                    rest = rest[:j]
                    break
            if not rest:
                return RSError("missing index for debug query")
            self.client._index(rest[0]).set_debug_hooks(**hooks)
            return self.dispatch([sub] + list(rest))
        return self.client.ft_debug(sub, av.next(), *av.a[av.i:])

    _cmd__FT_DEBUG = _cmd_FT_DEBUG

    def _cmd_FT_ALIASADD(self, av):
        self.client.ft_aliasadd(av.next(), av.next())
        return OK

    def _cmd_FT_ALIASUPDATE(self, av):
        self.client.ft_aliasupdate(av.next(), av.next())
        return OK

    def _cmd_FT_ALIASDEL(self, av):
        self.client.ft_aliasdel(av.next())
        return OK

    def _cmd_FT_ALIASLIST(self, av):
        name = av.next() if av.more() else None
        amap = self.client.ft_aliaslist(name)
        return [[a, amap[a]] for a in sorted(amap)]

    def _cmd_FT_SYNUPDATE(self, av):
        name = av.next()
        gid = av.next()
        skip = False
        if av.peek() == "SKIPINITIALSCAN":
            av.next()
            skip = True
        self.client.ft_synupdate(name, gid, av.a[av.i:],
                                 skip_initial_scan=skip)
        return OK

    def _cmd_FT_SYNDUMP(self, av):
        return _deep_flatten(self.client.ft_syndump(av.next()))

    def _cmd_FT_DICTADD(self, av):
        name = av.next()
        return self.client.ft_dictadd(name, *av.a[av.i:])

    def _cmd_FT_DICTDEL(self, av):
        name = av.next()
        return self.client.ft_dictdel(name, *av.a[av.i:])

    def _cmd_FT_DICTDUMP(self, av):
        return self.client.ft_dictdump(av.next())

    def _cmd_FT_SPELLCHECK(self, av):
        name = av.next()
        query = av.next()
        distance = 1
        include: list = []
        exclude: list = []
        while av.more():
            if av.peek() == "DISTANCE":
                av.next()
                distance = av.next_int()
            elif av.peek() == "TERMS":
                av.next()
                mode = av.next().upper()
                dname = av.next()
                (include if mode == "INCLUDE" else exclude).append(dname)
            else:
                av.next()
        out = self.client.ft_spellcheck(name, query, distance, include,
                                        exclude)
        r2 = [["TERM", o["term"],
               [[s, t] for s, t in o["suggestions"]]] for o in out]
        r3 = {"results": {o["term"]: [{t: float(s)}
                                      for s, t in o["suggestions"]]
                          for o in out}}
        return ProtoReply(r2, r3)

    def _cmd_FT_SUGADD(self, av):
        key = av.next()
        term = av.next()
        score = av.next_float()
        incr = False
        payload = None
        while av.more():
            if av.peek() == "INCR":
                av.next()
                incr = True
            elif av.peek() == "PAYLOAD":
                av.next()
                payload = av.next()
            else:
                av.next()
        return self.client.ft_sugadd(key, term, score, incr, payload)

    def _cmd_FT_SUGGET(self, av):
        key = av.next()
        prefix = av.next()
        fuzzy = False
        n = 5
        ws = False
        wp = False
        while av.more():
            opt = av.peek()
            if opt == "FUZZY":
                av.next()
                fuzzy = True
            elif opt == "MAX":
                av.next()
                n = av.next_int()
            elif opt == "WITHSCORES":
                av.next()
                ws = True
            elif opt == "WITHPAYLOADS":
                av.next()
                wp = True
            else:
                av.next()
        res = self.client.ft_sugget(key, prefix, fuzzy, n, ws, wp)
        out: list = []
        for r in res:
            if isinstance(r, tuple):
                out.extend(list(r))
            else:
                out.append(r)
        return out

    def _cmd_FT_SUGDEL(self, av):
        return 1 if self.client.ft_sugdel(av.next(), av.next()) else 0

    def _cmd_FT_SUGLEN(self, av):
        return self.client.ft_suglen(av.next())

    def _check_limit(self, offset: int, num: int, max_var: str) -> None:
        """LIMIT bound checks (reference: parseLimit,
        src/aggregate/aggregate_request.c:315-344)."""
        if num == 0 and offset != 0:
            raise RSError(
                "The `offset` of the LIMIT must be 0 when `num` is 0")
        mx = int(self.client.config.get(max_var))
        # a negative maximum is no maximum (MAXAGGREGATERESULTS defaults
        # to -1, unlimited, as in the reference's config)
        if 0 <= mx < num:
            raise RSError(f"LIMIT exceeds maximum of {mx}")
        msr = int(self.client.config.get("MAXSEARCHRESULTS"))
        if offset > msr:
            raise RSError(f"OFFSET exceeds maximum of {msr}")

    def _cmd_FT_TAGVALS(self, av):
        return self.client.ft_tagvals(av.next(), av.next())

    # -- legacy document commands (reference: src/document_add.c:32,
    # module.c FT.DEL/FT.GET/FT.MGET) ----------------------------------
    def _cmd_FT_ADD(self, av):
        name = av.next()
        key = av.next()
        score = av.next_float()
        opts = {"replace": False, "partial": False, "nocreate": False,
                "nosave": False}
        payload = language = if_expr = None
        fields: dict = {}
        while av.more():
            tok = av.next().upper()
            if tok in ("REPLACE", "PARTIAL", "NOCREATE", "NOSAVE"):
                opts[tok.lower()] = True
            elif tok == "LANGUAGE":
                language = av.next()
            elif tok == "PAYLOAD":
                payload = av.next().encode()
            elif tok == "IF":
                if_expr = av.next()
            elif tok == "FIELDS":
                while av.more():
                    f = av.next()
                    fields[f] = av.next()
            else:
                return RSError(f"Unknown keyword: `{tok}`")
        r = self.client.ft_add(name, key, score, fields, payload=payload,
                               if_expr=if_expr, language=language, **opts)
        return _Status(r)

    def _cmd_FT_DEL(self, av):
        name = av.next()
        key = av.next()
        dd = av.more() and av.next().upper() == "DD"
        return int(self.client.ft_del(name, key, delete_document=dd))

    def _cmd_FT_GET(self, av):
        doc = self.client.ft_get(av.next(), av.next())
        if doc is None:
            return None
        flat: list = []
        for f, v in doc.items():
            flat.extend([f, _tostr(v)])
        return flat

    def _cmd_FT_MGET(self, av):
        name = av.next()
        out = []
        while av.more():
            doc = self.client.ft_get(name, av.next())
            if doc is None:
                out.append(None)
            else:
                flat: list = []
                for f, v in doc.items():
                    flat.extend([f, _tostr(v)])
                out.append(flat)
        return out

    def _cmd_FT_CONFIG(self, av):
        sub = av.next().upper()
        if sub == "GET":
            name = av.next()
            val = self.client.ft_config_get(name)
            if isinstance(val, dict):
                return ProtoReply([[k, _tostr(v)] for k, v in val.items()],
                                  {k: _tostr(v) for k, v in val.items()})
            return ProtoReply([[name, _tostr(val)]], {name: _tostr(val)})
        if sub == "SET":
            self.client.ft_config_set(av.next(), av.next())
            return OK
        if sub == "HELP":
            return []
        return RSError("unknown FT.CONFIG subcommand")

    def _cmd_FT_HYBRID(self, av):
        name = av.next()
        hq = HybridQuery()
        params: dict = {}
        while av.more():
            opt = av.peek()
            if opt == "SEARCH":
                av.next()
                hq.search = av.next()
            elif opt == "VSIM":
                av.next()
                hq.vsim_field = av.next().lstrip("@")
                blob = av.next()
                if blob.startswith("$"):
                    hq.vsim_vector = None
                    hq._vec_param = blob[1:]
                else:
                    hq.vsim_vector = np.frombuffer(
                        blob.encode("latin-1"), dtype=np.float32)
            elif opt == "COMBINE":
                av.next()
                hq.combine = av.next().upper()
                n = av.next_int()
                kv = av.take(n)
                for j in range(0, len(kv), 2):
                    k = kv[j].upper()
                    if k == "K":
                        hq.rrf_constant = float(kv[j + 1])
                    elif k == "WINDOW":
                        hq.window = int(kv[j + 1])
                    elif k == "ALPHA":
                        hq.alpha = float(kv[j + 1])
                    elif k == "BETA":
                        hq.beta = float(kv[j + 1])
            elif opt == "LIMIT":
                av.next()
                av.next_int()
                hq.limit = av.next_int()
            elif opt == "PARAMS":
                av.next()
                params = _parse_params(av)
            else:
                av.next()
        if getattr(hq, "_vec_param", None):
            raw = params[hq._vec_param]
            hq.vsim_vector = (np.frombuffer(raw.encode("latin-1"),
                                            dtype=np.float32)
                              if isinstance(raw, str) else np.asarray(raw))
        hq.search_params = params
        rows = self.client.ft_hybrid(name, hq)
        return ProtoReply([len(rows)] + [_row_flatten(r) for r in rows],
                          _agg_map3(rows, len(rows)))

    # -- lifecycle ----------------------------------------------------------
    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        loop = asyncio.get_running_loop()
        proto = 2
        # protocol parsing runs in the native codec when available
        # (reference analog: the C command/reply layer, module.c/reply.c)
        native_parser = None
        try:
            from . import native_resp
            if native_resp.available():
                native_parser = native_resp.RespParser()
        except Exception:
            native_parser = None
        self.parser = "python" if native_parser is None else "native"

        async def next_command():
            if native_parser is None:
                return await read_command(reader)
            while True:
                argv = native_parser.next()
                if argv is not None:
                    return argv
                data = await reader.read(65536)
                if not data:
                    return None
                native_parser.feed(data)

        try:
            while True:
                argv = await next_command()
                if argv is None:
                    break
                if not argv:
                    continue
                cmd = argv[0].upper()
                if cmd == "QUIT":
                    writer.write(encode(OK, proto))
                    break
                if cmd == "HELLO":
                    if len(argv) > 1 and argv[1] in ("2", "3"):
                        proto = int(argv[1])
                        reply: Any = self._hello_reply(proto)
                    elif len(argv) > 1:
                        reply = RSError(
                            "NOPROTO unsupported protocol version")
                    else:
                        reply = self._hello_reply(proto)
                    writer.write(encode(reply, proto))
                    await writer.drain()
                    continue
                if cmd == "RESET":
                    writer.write(encode(_Status("RESET"), proto))
                    await writer.drain()
                    continue
                if (cmd == "FT.SEARCH" and self._micro_batch
                        and self._bq is not None):
                    # coalesce with other in-flight searches (micro-batch)
                    try:
                        spec = self._parse_search(Argv(argv[1:]))
                    except Exception:
                        spec = None
                    if spec is not None and self._batchable(spec):
                        fut = loop.create_future()
                        self._bq.put_nowait((spec, fut))
                        reply = await fut
                        writer.write(encode(reply, proto))
                        await writer.drain()
                        continue
                if cmd in _READ_CMDS:
                    await self._lock.acquire_read()
                    try:
                        reply = await loop.run_in_executor(
                            self._pool, self.dispatch, argv)
                    finally:
                        await self._lock.release_read()
                else:
                    await self._lock.acquire_write()
                    try:
                        reply = await loop.run_in_executor(
                            self._pool, self.dispatch, argv)
                    finally:
                        await self._lock.release_write()
                writer.write(encode(reply, proto))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    async def serve(self):
        if self._micro_batch and self._bq is None:
            self._bq = asyncio.Queue()
            self._batcher_task = asyncio.ensure_future(self._batcher())
        server = await asyncio.start_server(self.handle, self.host,
                                            self.port)
        return server

    async def aclose(self):
        """Cancel the micro-batcher so the event loop can shut down clean."""
        task = getattr(self, "_batcher_task", None)
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._batcher_task = None
        self._bq = None

    def run(self):
        async def main():
            server = await self.serve()
            async with server:
                await server.serve_forever()
        asyncio.run(main())


def _tostr(v) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    if isinstance(v, (dict, list)):
        import json as _json
        return _json.dumps(v)
    return str(v)


def _row_flatten(row: dict) -> list:
    out: list = []
    for k, v in row.items():
        out.extend([k, _tostr(v) if not isinstance(v, (int, float))
                    else v])
    return out


def _agg_map3(rows: list[dict], total: int) -> dict:
    """RESP3 aggregate/hybrid reply map (aggregate_exec.c sendChunk_Resp3)."""
    return {
        "attributes": [], "error": [], "total_results": total,
        "format": "STRING",
        "results": [{"extra_attributes":
                     {k: (v if isinstance(v, (int, float)) else _tostr(v))
                      for k, v in r.items()},
                     "values": []} for r in rows],
        "warning": [],
    }


def _deep_flatten(d: dict) -> list:
    out: list = []
    for k, v in d.items():
        out.append(k)
        if isinstance(v, dict):
            out.append(_deep_flatten(v))
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out.append([_deep_flatten(x) for x in v])
        else:
            out.append(v if isinstance(v, (int, float, list)) else _tostr(v))
    return out


if __name__ == "__main__":
    import sys
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 6380
    print(f"redisearch_tpu_torch server listening on :{port}")
    Server(port=port).run()
