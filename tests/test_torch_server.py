"""RESP wire-protocol server tests using a raw-socket Redis client
(reference analog: tests/pytests running against redis-server+module).

Parity file of tests/test_server.py (tests/torch_parity.py): each case
runs against the JAX package's `Server` and the port's
(`redisearch_tpu_torch/server.py`, on a `Client(device="cpu")`), passes
its own assertions on both, and every reply the raw client reads must be
equal between them (scores within rtol 1e-5; profile clocks and byte
counts not compared).  Then tests/test_units.py::test_native_resp_parser
on the port's codec (the JAX one's parses compared where it loaded),
tests/test_host_tier.py::test_host_tier_wire_create on both packages,
and the micro-batcher: the JAX server pads each batch to
min(batch_max, 64) queries by repeating the last, the port's does not,
and their replies are equal.
"""

from tests.torch_parity import parity, record_reply, resolve, rs, side
import asyncio

import numpy as np
import pytest

Server = rs.server.Server


class MiniRedis:
    """Tiny RESP2 client (redis-py isn't in this image)."""

    def __init__(self, reader, writer):
        self.r = reader
        self.w = writer
        self.record = True

    @classmethod
    async def connect(cls, host, port):
        r, w = await asyncio.open_connection(host, port)
        return cls(r, w)

    async def cmd(self, *argv):
        out = [f"*{len(argv)}\r\n".encode()]
        for a in argv:
            b = str(a).encode()
            out.append(b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n")
        self.w.write(b"".join(out))
        await self.w.drain()
        try:
            reply = await self._read()
        except RuntimeError as e:
            if self.record:
                record_reply(argv, ("error", str(e)))
            raise
        if self.record:
            record_reply(argv, reply)
        return reply

    async def _read(self):
        line = (await self.r.readline()).rstrip()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = await self.r.readexactly(n + 2)
            return data[:-2].decode()
        if t == b"*":
            n = int(rest)
            return [await self._read() for _ in range(n)]
        # RESP3 types
        if t == b"%":
            n = int(rest)
            return {await self._read(): await self._read()
                    for _ in range(n)}
        if t == b",":
            return float(rest)
        if t == b"_":
            return None
        if t == b"#":
            return rest == b"t"
        raise ValueError(f"bad RESP type {t}")


@pytest.fixture()
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def run_session(loop, coro_fn):
    async def main():
        srv = Server(port=0)
        server = await srv.serve()
        port = server.sockets[0].getsockname()[1]
        c = await MiniRedis.connect("127.0.0.1", port)
        try:
            return await coro_fn(c)
        finally:
            c.w.close()
            server.close()
            await server.wait_closed()
            await srv.aclose()
    return loop.run_until_complete(main())


@parity
def test_end_to_end_search(loop):
    async def flow(c):
        assert await c.cmd("PING") == "PONG"
        assert await c.cmd(
            "FT.CREATE", "idx", "PREFIX", 1, "doc:", "SCHEMA",
            "title", "TEXT", "WEIGHT", 2, "body", "TEXT",
            "price", "NUMERIC", "SORTABLE",
            "tags", "TAG", "SEPARATOR", ",") == "OK"
        assert await c.cmd("HSET", "doc:1", "title", "hello world",
                           "body", "lorem ipsum", "price", 10,
                           "tags", "a,b") == 4
        await c.cmd("HSET", "doc:2", "title", "goodbye world",
                    "body", "hello again", "price", 25, "tags", "b")
        res = await c.cmd("FT.SEARCH", "idx", "hello")
        assert res[0] == 2
        assert set(res[1::2]) == {"doc:1", "doc:2"}
        res = await c.cmd("FT.SEARCH", "idx", "@title:hello", "NOCONTENT")
        assert res == [1, "doc:1"]
        res = await c.cmd("FT.SEARCH", "idx", "@tags:{a}", "NOCONTENT")
        assert res == [1, "doc:1"]
        res = await c.cmd("FT.SEARCH", "idx", "*", "SORTBY", "price",
                          "DESC", "NOCONTENT")
        assert res == [2, "doc:2", "doc:1"]
        res = await c.cmd("FT.SEARCH", "idx", "@price:[20 30]", "NOCONTENT")
        assert res == [1, "doc:2"]
        # RETURN + WITHSCORES
        res = await c.cmd("FT.SEARCH", "idx", "hello", "WITHSCORES",
                          "RETURN", 1, "title")
        assert res[0] == 2 and float(res[2]) > 0
        # WITHSORTKEYS: reference serialization "#<num>" (reeval_key)
        res = await c.cmd("FT.SEARCH", "idx", "*", "SORTBY", "price",
                          "ASC", "WITHSORTKEYS", "NOCONTENT")
        assert res == [2, "doc:1", "#10", "doc:2", "#25"]
        return True
    assert run_session(loop, flow)


@parity
def test_aggregate_and_cursor(loop):
    async def flow(c):
        await c.cmd("FT.CREATE", "ag", "SCHEMA", "cat", "TAG", "SORTABLE",
                    "price", "NUMERIC", "SORTABLE")
        for i in range(10):
            await c.cmd("HSET", f"p{i}", "cat", ["x", "y"][i % 2],
                        "price", i * 10)
        res = await c.cmd("FT.AGGREGATE", "ag", "*",
                          "GROUPBY", 1, "@cat",
                          "REDUCE", "SUM", 1, "@price", "AS", "total",
                          "SORTBY", 2, "@total", "DESC")
        assert res[0] == 2
        first = dict(zip(res[1][::2], res[1][1::2]))
        assert first["cat"] == "y" and float(first["total"]) == 250
        # cursor
        res = await c.cmd("FT.AGGREGATE", "ag", "*", "LOAD", 1, "@price",
                          "SORTBY", 1, "@price", "WITHCURSOR", "COUNT", 4)
        body, cid = res
        assert body[0] == 4 and cid != 0
        res2 = await c.cmd("FT.CURSOR", "READ", "ag", cid)
        assert res2[0][0] == 4
        return True
    assert run_session(loop, flow)


@parity
def test_misc_commands(loop):
    async def flow(c):
        await c.cmd("FT.CREATE", "m", "SCHEMA", "t", "TEXT")
        await c.cmd("HSET", "k1", "t", "searching stuff")
        out = await c.cmd("FT.EXPLAIN", "m", "hello world")
        assert "INTERSECT" in out
        await c.cmd("FT.SUGADD", "sug", "hello world", 1)
        assert await c.cmd("FT.SUGLEN", "sug") == 1
        assert await c.cmd("FT.SUGGET", "sug", "he") == ["hello world"]
        assert await c.cmd("FT.DICTADD", "d1", "foo", "bar") == 2
        assert await c.cmd("FT.DICTDUMP", "d1") == ["bar", "foo"]
        sp = await c.cmd("FT.SPELLCHECK", "m", "serching")
        assert sp[0][1] == "serching"
        assert any(t == "searching" for _s, t in sp[0][2])
        cfg = await c.cmd("FT.CONFIG", "GET", "MAXPREFIXEXPANSIONS")
        assert cfg[0][0] == "MAXPREFIXEXPANSIONS"
        assert await c.cmd("FT._LIST") == ["m"]
        info = await c.cmd("FT.INFO", "m")
        d = {info[i]: info[i + 1] for i in range(0, len(info), 2)}
        assert d["index_name"] == "m"
        # vector via PARAMS blob (binary-safe through latin-1 string)
        await c.cmd("FT.CREATE", "v", "SCHEMA", "emb", "VECTOR", "FLAT",
                    6, "TYPE", "FLOAT32", "DIM", 2, "DISTANCE_METRIC", "L2")
        import numpy as np
        for i in range(4):
            vec = np.asarray([i, i], np.float32).tobytes().decode("latin-1")
            await c.cmd("HSET", f"e{i}", "emb", vec)
        q = np.asarray([2.1, 2.1], np.float32).tobytes().decode("latin-1")
        res = await c.cmd("FT.SEARCH", "v", "*=>[KNN 2 @emb $b]",
                          "PARAMS", 2, "b", q, "NOCONTENT", "DIALECT", 2)
        assert res[0] == 2 and res[1] == "e2"
        return True
    assert run_session(loop, flow)


@parity
def test_json_set(loop):
    async def flow(c):
        await c.cmd("FT.CREATE", "j", "ON", "JSON", "SCHEMA",
                    "$.name", "AS", "name", "TEXT")
        await c.cmd("JSON.SET", "jd1", "$",
                    '{"name": "deep learning", "extra": 1}')
        res = await c.cmd("FT.SEARCH", "j", "deep", "NOCONTENT")
        assert res == [1, "jd1"]
        return True
    assert run_session(loop, flow)


@parity
def test_resp3(loop):
    """HELLO 3 upgrades the connection; replies become RESP3 maps
    (reference: src/reply.c RESP3 paths + sendChunk_Resp3)."""
    async def flow(c):
        hello = await c.cmd("HELLO", 3)
        assert isinstance(hello, dict) and hello["proto"] == 3
        await c.cmd("FT.CREATE", "r3", "SCHEMA", "t", "TEXT",
                    "n", "NUMERIC", "SORTABLE")
        await c.cmd("HSET", "a", "t", "alpha beta", "n", 1)
        await c.cmd("HSET", "b", "t", "beta gamma", "n", 2)
        res = await c.cmd("FT.SEARCH", "r3", "beta", "WITHSCORES")
        assert isinstance(res, dict)
        assert res["total_results"] == 2
        ids = {r["id"] for r in res["results"]}
        assert ids == {"a", "b"}
        assert all(isinstance(r["score"], float) for r in res["results"])
        assert res["results"][0]["extra_attributes"]["t"] in (
            "alpha beta", "beta gamma")
        agg = await c.cmd("FT.AGGREGATE", "r3", "*", "GROUPBY", 0,
                          "REDUCE", "COUNT", 0, "AS", "cnt")
        assert isinstance(agg, dict)
        assert agg["results"][0]["extra_attributes"]["cnt"] == 2
        info = await c.cmd("FT.INFO", "r3")
        assert isinstance(info, dict) and info["index_name"] == "r3"
        # downgrade back to RESP2
        hello2 = await c.cmd("HELLO", 2)
        assert isinstance(hello2, list)
        res2 = await c.cmd("FT.SEARCH", "r3", "beta", "NOCONTENT")
        assert res2[0] == 2
        return True
    assert run_session(loop, flow)


@parity
def test_concurrent_reads(loop):
    """Multiple connections issue searches concurrently (reference analog:
    WORKERS>0 thread pool, src/util/workers.c)."""
    async def main():
        srv = Server(port=0)
        server = await srv.serve()
        port = server.sockets[0].getsockname()[1]
        c0 = await MiniRedis.connect("127.0.0.1", port)
        await c0.cmd("FT.CREATE", "cc", "SCHEMA", "t", "TEXT")
        for i in range(50):
            await c0.cmd("HSET", f"d{i}", "t", f"word{i % 7} common")
        conns = [await MiniRedis.connect("127.0.0.1", port)
                 for _ in range(8)]
        for c in conns:     # replies recorded below, in connection order
            c.record = False
        results = await asyncio.gather(
            *[c.cmd("FT.SEARCH", "cc", "common", "LIMIT", 0, 100,
                    "NOCONTENT") for c in conns])
        assert all(r[0] == 50 for r in results)
        for r in results:
            record_reply(["FT.SEARCH"], r)
        # interleave a write with reads
        mixed = await asyncio.gather(
            conns[0].cmd("HSET", "d100", "t", "common fresh"),
            conns[1].cmd("FT.SEARCH", "cc", "common", "NOCONTENT"),
            conns[2].cmd("FT.SEARCH", "cc", "word1", "NOCONTENT"))
        assert mixed[1][0] in (50, 51)
        for c in conns + [c0]:
            c.w.close()
        server.close()
        await server.wait_closed()
        await srv.aclose()
        return True
    assert loop.run_until_complete(main())


@parity
def test_info_command(loop):
    async def flow(c):
        await c.cmd("FT.CREATE", "mi", "SCHEMA", "t", "TEXT")
        await c.cmd("HSET", "k", "t", "hello")
        await c.cmd("FT.SEARCH", "mi", "hello", "DIALECT", 2)
        info = await c.cmd("INFO", "MODULES")
        assert "search_dialect_2:1" in info
        assert "search_number_of_indexes:1" in info
        return True
    assert run_session(loop, flow)


@parity
def test_profile_aggregate(loop):
    async def flow(c):
        await c.cmd("FT.CREATE", "pa", "SCHEMA", "cat", "TAG", "SORTABLE",
                    "n", "NUMERIC", "SORTABLE")
        for i in range(6):
            await c.cmd("HSET", f"x{i}", "cat", "ab"[i % 2], "n", i)
        out = await c.cmd("FT.PROFILE", "pa", "AGGREGATE", "QUERY", "*",
                          "GROUPBY", 1, "@cat",
                          "REDUCE", "COUNT", 0, "AS", "c")
        res, prof = out
        assert res[0] == 2
        d = {prof[i]: prof[i + 1] for i in range(0, len(prof), 2)}
        assert "query_tree" in d and "result_processors" in d
        # measured per-stage entries: [["name", <stage>, "time_ms", t,
        # "rows", r], ...]; this plan runs as the fused device GROUPBY
        rp_blob = str(d["result_processors"])
        assert "GROUP" in rp_blob.upper() or "DeviceGroupBy" in rp_blob
        assert "time_ms" in rp_blob
        return True
    assert run_session(loop, flow)


@parity
def test_legacy_add_get_del_wire(loop):
    """FT.ADD/FT.GET/FT.MGET/FT.DEL over RESP (reference: legacy
    document commands, src/document_add.c, module.c)."""
    async def flow(c):
        await c.cmd("FT.CREATE", "lg", "SCHEMA", "t", "TEXT",
                    "n", "NUMERIC")
        assert await c.cmd("FT.ADD", "lg", "d1", 1.0, "FIELDS",
                           "t", "hello there", "n", "5") == "OK"
        # exists without REPLACE -> error
        try:
            await c.cmd("FT.ADD", "lg", "d1", 1.0, "FIELDS", "t", "x")
            return False
        except Exception:
            pass
        # IF false -> NOADD (simple string)
        assert await c.cmd("FT.ADD", "lg", "d1", 1.0, "REPLACE", "PARTIAL",
                           "IF", "@n == 4", "FIELDS", "n", "9") == "NOADD"
        assert await c.cmd("FT.ADD", "lg", "d1", 1.0, "REPLACE", "PARTIAL",
                           "IF", "@n == 5", "FIELDS", "n", "9") == "OK"
        got = await c.cmd("FT.GET", "lg", "d1")
        d = dict(zip(got[::2], got[1::2]))
        assert d["n"] == "9" and d["t"] == "hello there"
        mg = await c.cmd("FT.MGET", "lg", "d1", "missing")
        assert mg[0] is not None and mg[1] is None
        assert await c.cmd("FT.DEL", "lg", "d1") == 1
        assert await c.cmd("FT.GET", "lg", "d1") is None
        return True
    assert run_session(loop, flow)


@parity
def test_limit_bounds(loop):
    """LIMIT bound errors (reference: parseLimit,
    src/aggregate/aggregate_request.c:315-344)."""
    async def flow(c):
        await c.cmd("FT.CREATE", "lb", "SCHEMA", "t", "TEXT")
        await c.cmd("HSET", "d1", "t", "x")
        # offset nonzero with num 0
        try:
            await c.cmd("FT.SEARCH", "lb", "x", "LIMIT", 5, 0)
            return False
        except Exception as e:
            assert "offset" in str(e)
        # num over MAXSEARCHRESULTS
        await c.cmd("FT.CONFIG", "SET", "MAXSEARCHRESULTS", "100")
        try:
            await c.cmd("FT.SEARCH", "lb", "x", "LIMIT", 0, 101)
            return False
        except Exception as e:
            assert "LIMIT exceeds maximum of 100" in str(e)
        # aggregate bound rides MAXAGGREGATERESULTS
        await c.cmd("FT.CONFIG", "SET", "MAXAGGREGATERESULTS", "50")
        try:
            await c.cmd("FT.AGGREGATE", "lb", "*", "LIMIT", 0, 51)
            return False
        except Exception as e:
            assert "LIMIT exceeds maximum of 50" in str(e)
        # within bounds still fine
        r = await c.cmd("FT.SEARCH", "lb", "x", "LIMIT", 0, 10)
        assert r[0] == 1
        await c.cmd("FT.CONFIG", "SET", "MAXSEARCHRESULTS", "1000000")
        await c.cmd("FT.CONFIG", "SET", "MAXAGGREGATERESULTS", "1000000")
        return True
    assert run_session(loop, flow)


@parity
def test_global_query_error_stats(loop):
    """Per-class query error counters in INFO (reference:
    QueryErrorsGlobalStats_UpdateError, src/info/global_stats.c:184;
    field names from src/info/info_redis/info_redis.c:333-335)."""
    async def flow(c):
        await c.cmd("FT.CREATE", "es", "SCHEMA", "t", "TEXT")
        for _ in range(2):
            try:
                await c.cmd("FT.SEARCH", "es", "((((")   # syntax
            except Exception:
                pass
        try:
            await c.cmd("FT.SEARCH", "es", "@t:$missing")  # bad param
        except Exception:
            pass
        info = await c.cmd("INFO", "SEARCH")
        text = info if isinstance(info, str) else str(info)
        assert "shard_total_query_errors_syntax:2" in text, text
        assert "shard_total_query_errors_arguments:1" in text
        return True
    assert run_session(loop, flow)


def _parse_all(parser, feeds) -> list:
    """Each feed's parsed commands (or "error" on a protocol error)."""
    out = []
    for data in feeds:
        for i in range(0, len(data), 7):    # partial feeds
            parser.feed(data[i:i + 7])
        got = []
        try:
            while (argv := parser.next()) is not None:
                got.append(argv)
        except ValueError:
            got.append("error")
        out.append(got)
    return out


def test_native_resp_parser():
    """tests/test_units.py::test_native_resp_parser on the port's codec:
    pipelined commands, partial feeds, an inline command, a binary-safe
    payload and a protocol error; the JAX package's codec, where it
    loaded (its build writes its library in place, so concurrent test
    workers can race it and leave it unloaded), parses each the same."""
    import redisearch_tpu.native_resp as jresp

    from redisearch_tpu_torch import native_resp as tresp
    blob = bytes(range(256))
    feeds = [b"*2\r\n$4\r\nPING\r\n$3\r\nfoo\r\n*1\r\n$4\r\nPING\r\n",
             b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$5\r\nhello\r\n",
             b"PING inline arg\r\n",
             b"*2\r\n$3\r\nGET\r\n$256\r\n" + blob + b"\r\n",
             b"*x\r\n"]
    assert tresp.available()
    got = _parse_all(tresp.RespParser(), feeds)
    assert got[:3] == [[["PING", "foo"], ["PING"]], [["SET", "k", "hello"]],
                       [["PING", "inline", "arg"]]]
    assert got[3][0][0] == "GET"
    assert got[3][0][1].encode("utf-8", "surrogateescape") == blob
    assert got[4] == ["error"]
    if jresp.available():
        assert _parse_all(jresp.RespParser(), feeds) == got


def test_native_resp_builds_into_the_port():
    """The port's codec builds into its git-ignored `_build/` (through a
    temporary file renamed into place), apart from the JAX package's
    `native/libresp_codec.so`."""
    import os

    from redisearch_tpu_torch import native_resp
    assert native_resp.available()
    assert native_resp._SO.endswith(
        os.path.join("redisearch_tpu_torch", "_build", "libresp_codec.so"))
    assert os.path.exists(native_resp._SO)
    assert native_resp._SRC.endswith(os.path.join("native",
                                                  "resp_codec.cpp"))


@parity
def test_host_tier_wire_create():
    """tests/test_host_tier.py::test_host_tier_wire_create: STORAGE HOST
    reaches the schema through FT.CREATE's VECTOR args."""
    async def flow():
        srv = Server(port=0)
        server = await srv.serve()
        try:
            srv.dispatch(["FT.CREATE", "hw", "SCHEMA", "v", "VECTOR",
                          "HNSW", "10", "TYPE", "FLOAT32", "DIM", "8",
                          "DISTANCE_METRIC", "L2", "NLIST", "4",
                          "STORAGE", "HOST"])
            ix = srv.client._indexes["hw"]
            assert ix.schema.field("v").vector.storage == "host"
            rng = np.random.default_rng(0)
            for i in range(100):
                srv.client.hset(f"d{i}",
                                {"v": rng.normal(size=8)
                                 .astype(np.float32)})
            ix.commit()
            assert ix.segments[0].vectors["v"].host
            assert ix.segments[0].vectors["v"].host_ivf is not None
            record_reply(["FT.INFO"], srv.dispatch(["FT.INFO", "hw"]).r3)
        finally:
            server.close()
            await server.wait_closed()
            await srv.aclose()
    asyncio.new_event_loop().run_until_complete(flow())


@parity
def test_micro_batches_unpadded_equal_padded(loop):
    """600 docs, 6 connections sending 22 FT.SEARCH WITHSCORES each at
    once (AND, OR, NOT, tag, phrase and prefix queries): the
    micro-batcher groups them.  The JAX server pads every group to 64
    queries; the port's hands each group to `ft_search_many` as it
    formed, so its group sizes sum to the 132 searches sent.  Every reply
    (total, ids, order, scores) is equal between the two servers."""
    words = [f"w{i}" for i in range(12)]
    queries = ([f"{a} {b}" for a in words[:6] for b in words[6:]]
               + [f"{a}|{b}" for a in words[:6] for b in words[6:]]
               + [f"{a} -{b}" for a in words[:6] for b in words[6:]]
               + [f"@c:{{{c}}} {w}" for c in "xyz" for w in words[:4]]
               + [f'"{words[i]} {words[i + 1]}"' for i in range(10)]
               + [f"{w}*" for w in ("w1", "w2")])
    assert len(queries) == 132

    async def main():
        srv = Server(port=0)
        rng = np.random.default_rng(5)
        srv.client.ft_create("mb", [rs.Field("t", rs.FieldType.TEXT),
                                    rs.Field("c", rs.FieldType.TAG)])
        srv.client._index("mb").add_documents(
            [(f"d{i}", {"t": " ".join(rng.choice(words, size=6)),
                        "c": "xyz"[i % 3]}) for i in range(600)])
        server = await srv.serve()
        port = server.sockets[0].getsockname()[1]
        conns = [await MiniRedis.connect("127.0.0.1", port)
                 for _ in range(6)]
        for c in conns:
            c.record = False

        async def send(j, c):
            return [await c.cmd("FT.SEARCH", "mb", q, "WITHSCORES",
                                "NOCONTENT")
                    for q in queries[j::6]]

        per_conn = await asyncio.gather(*[send(j, c)
                                          for j, c in enumerate(conns)])
        for j, replies in enumerate(per_conn):
            for q, r in zip(queries[j::6], replies):
                record_reply(["FT.SEARCH", q], r)
        if side() == "torch":
            sizes = srv.batch_sizes
            assert sum(n * c for n, c in sizes.items()) == len(queries)
            assert max(sizes) > 1
            assert srv.parser == "native"
        for c in conns:
            c.w.close()
        server.close()
        await server.wait_closed()
        await srv.aclose()

    loop.run_until_complete(main())


def test_aggregate_limit_at_the_default_config(loop):
    """MAXAGGREGATERESULTS defaults to -1, no maximum (as in the
    reference's config).  The JAX server's `_check_limit` reads -1 as a
    maximum, so FT.AGGREGATE ... LIMIT 0 2 fails at its default config
    (a fault on the JAX side, ROADMAP §C); the port's serves it, and a
    maximum that is set still bounds it."""
    from redisearch_tpu.server import Server as JServer

    import redisearch_tpu_torch as rt
    from redisearch_tpu_torch.server import Server as TServer

    async def session(srv):
        server = await srv.serve()
        port = server.sockets[0].getsockname()[1]
        c = await MiniRedis.connect("127.0.0.1", port)
        c.record = False
        try:
            await c.cmd("FT.CREATE", "al", "SCHEMA", "g", "TAG",
                        "SORTABLE")
            for i in range(6):
                await c.cmd("HSET", f"a{i}", "g", "xyz"[i % 3])
            argv = ("FT.AGGREGATE", "al", "*", "GROUPBY", 1, "@g",
                    "REDUCE", "COUNT", 0, "AS", "n", "SORTBY", 2, "@g",
                    "ASC", "LIMIT", 0, 2)
            out = []
            for mx in (None, "1"):
                if mx is not None:
                    await c.cmd("FT.CONFIG", "SET", "MAXAGGREGATERESULTS",
                                mx)
                try:
                    out.append(await c.cmd(*argv))
                except RuntimeError as e:
                    out.append(str(e))
            return out
        finally:
            c.w.close()
            server.close()
            await server.wait_closed()
            await srv.aclose()

    jax_out = loop.run_until_complete(session(JServer(port=0)))
    port_out = loop.run_until_complete(session(
        TServer(client=rt.Client(device="cpu"), port=0)))
    assert jax_out == ["RSError LIMIT exceeds maximum of -1",
                       "RSError LIMIT exceeds maximum of 1"]
    assert port_out == [[2, ["g", "x", "n", "2.0"], ["g", "y", "n", "2.0"]],
                        "RSError LIMIT exceeds maximum of 1"]


def test_server_needs_a_card_or_a_client(monkeypatch):
    """`Server()` builds `Client()`, which runs on the card: without a
    CUDA device it raises and names `device="cpu"`; a CPU client serves.
    Its `run` sets no XLA compilation cache (the JAX server's does)."""
    import inspect

    import torch

    import redisearch_tpu_torch as rt
    from redisearch_tpu_torch import server as TS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TS.Server(port=0)
    srv = TS.Server(client=rt.Client(device="cpu"), port=0)
    assert srv.client.device == torch.device("cpu")
    assert srv.dispatch(["PING"]).s == "PONG"
    assert "compilation_cache" not in inspect.getsource(TS.Server.run)
    srv._pool.shutdown()
