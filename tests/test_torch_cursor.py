"""FT.AGGREGATE WITHCURSOR, FT.CURSOR READ / DEL through the port, on the CPU.

Ports of tests/test_aggregate.py's streaming-cursor tests,
tests/test_client.py::test_cursor and
tests/test_reference_semantics.py::test_cursor_pages_every_row_exactly_once.
Each runs on both packages' `Client` over the same documents: every
page, the cursor id returned with it and the total are equal (stored
values and host reducer outputs exactly; the plans here drop `__score`).
Then the port alone: the buffer stays under a few `_STREAM_CHUNK`s after
the first read, a LIMIT that fills early stops pulling the source, the
idle sweep with a patched clock, FT.CURSOR DEL, and CursorNotFound.
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu_torch.agg import cursor as TC
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.utils.errors import CursorNotFound


def _clients():
    return (rs, rs.Client()), (rt, rt.Client(device="cpu"))


def _drain(c, name, res, count=None):
    """Every page of a cursor: [(rows, cursor id)], the first read's
    included."""
    pages = [(res.rows, res.cursor_id)]
    cid = res.cursor_id
    while cid:
        rows, cid = c.ft_cursor_read(name, cid, count)
        pages.append((rows, cid))
    return pages


def _both(build, req_fn, name, count=None):
    """Build the same index in both packages, run req_fn(pkg) WITHCURSOR
    and drain it: returns each package's (total, pages, client)."""
    out = []
    for pkg, c in _clients():
        build(pkg, c)
        res = c.ft_aggregate(name, req_fn(pkg))
        out.append((res.total, _drain(c, name, res, count), c))
    (jt, jp, _), (tt, tp, tc) = out
    assert tt == jt
    assert tp == jp
    return tt, tp, tc


def _strm(pkg, c):
    c.ft_create("strm", [pkg.Field("t", pkg.FieldType.TEXT),
                         pkg.Field("x", pkg.FieldType.NUMERIC)])
    for i in range(5000):
        c.hset(f"s{i}", {"t": "row data", "x": i})


def test_cursor_streams_lazily():
    """Row dicts materialize only as the cursor drains: after the first
    read, far fewer rows exist in the cursor buffer than match; pages and
    ids equal the JAX package's."""
    (_j, jc), (_t, tc) = _clients()
    for pkg, c in ((rs, jc), (rt, tc)):
        _strm(pkg, c)
    reqs = [p.AggregateRequest("*").load("@x").cursor(100) for p in (rs, rt)]
    jres, tres = jc.ft_aggregate("strm", reqs[0]), tc.ft_aggregate(
        "strm", reqs[1])
    assert tres.total == jres.total == 5000
    assert len(tres.rows) == 100 and tres.cursor_id == jres.cursor_id
    cur = tc.cursors._cursors[tres.cursor_id]
    assert len(cur.rows) <= TP._STREAM_CHUNK < 5000
    assert _drain(tc, "strm", tres) == _drain(jc, "strm", jres)
    assert len(tc.cursors) == 0
    whole = tc.ft_aggregate("strm", rt.AggregateRequest("*").load("@x"))
    rows = [r for page, _cid in _drain(
        tc, "strm", tc.ft_aggregate("strm", rt.AggregateRequest("*")
                                    .load("@x").cursor(100)))
            for r in page]
    assert rows == whole.rows
    assert sorted(r["x"] for r in rows) == [float(i) for i in range(5000)]


def test_cursor_streaming_group_sort_parity():
    """A host GROUPBY (unsortable TAG key) behind APPLY/FILTER, sorted:
    pages equal the JAX package's, rows equal the plain FT.AGGREGATE."""
    def build(pkg, c):
        c.ft_create("strg", [pkg.Field("cat", pkg.FieldType.TAG),
                             pkg.Field("x", pkg.FieldType.NUMERIC)])
        for i in range(2000):
            c.hset(f"g{i}", {"cat": f"c{i % 37}", "x": i})

    def mk(P):
        return (P.AggregateRequest("*")
                .apply("@x % 10", "m")
                .filter("@m != 3")
                .group_by("@cat", ("COUNT", [], "n"),
                          ("SUM", ["@x"], "sx"), ("TOLIST", ["@m"], "ms"))
                .sort_by(("@n", False)))

    total, pages, tc = _both(build, lambda p: mk(p).cursor(10), "strg")
    rows = [r for page, _cid in pages for r in page]
    assert len(pages) == 4 and total == 2000 and len(rows) == 37
    assert rows == tc.ft_aggregate("strg", mk(rt)).rows


def test_cursor_on_device_groupby():
    """WITHCURSOR on a device-eligible GROUPBY (sortable key, algebraic
    reducers) runs it materialized and pages its groups."""
    def build(pkg, c):
        c.ft_create("dg", [pkg.Field("t", pkg.FieldType.TEXT),
                           pkg.Field("g", pkg.FieldType.TAG, sortable=True),
                           pkg.Field("x", pkg.FieldType.NUMERIC)])
        for i in range(900):
            c.hset(f"k{i}", {"t": "alpha" if i % 3 else "alpha beta",
                             "g": f"g{i % 23}", "x": i % 17})

    def mk(P):
        return (P.AggregateRequest("alpha")
                .group_by("@g", ("COUNT", [], "n"), ("MAX", ["@x"], "hi"))
                .sort_by(("@g", P.ASC)).cursor(4))

    total, pages, _tc = _both(build, mk, "dg")
    assert total == 900 and len(pages) == 6
    assert [len(p) for p, _cid in pages] == [4] * 5 + [3]


def _books(pkg, c):
    """tests/test_client.py's client fixture."""
    c.ft_create("books", [
        pkg.Field("title", pkg.FieldType.TEXT, weight=2.0),
        pkg.Field("summary", pkg.FieldType.TEXT),
        pkg.Field("genre", pkg.FieldType.TAG, sortable=True),
        pkg.Field("year", pkg.FieldType.NUMERIC, sortable=True),
    ], prefixes=("book:",))
    c.hset("book:1", {"title": "dune", "summary":
                      "a desert planet with giant sandworms and spice",
                      "genre": "scifi", "year": 1965})
    c.hset("book:2", {"title": "neuromancer", "summary":
                      "a hacker navigates cyberspace and ai constructs",
                      "genre": "scifi,cyberpunk", "year": 1984})
    c.hset("book:3", {"title": "emma", "summary":
                      "a young woman meddles in the romances of her friends",
                      "genre": "romance", "year": 1815})
    c.hset("note:1", {"title": "not a book"})  # prefix mismatch


def test_cursor():
    _total, pages, _tc = _both(
        _books, lambda p: (p.AggregateRequest("*").load("title")
                           .sort_by("@year").cursor(count=2)), "books")
    assert len(pages[0][0]) == 2 and pages[0][1] != 0
    assert len(pages[1][0]) == 1 and pages[1][1] == 0
    assert [r["title"] for p, _c in pages for r in p] == [
        "emma", "dune", "neuromancer"]


def test_cursor_pages_every_row_exactly_once():
    def build(pkg, c):
        c.ft_create("cu", [pkg.Field("t", pkg.FieldType.TEXT),
                           pkg.Field("n", pkg.FieldType.NUMERIC)])
        for i in range(57):
            c.hset(f"d{i}", {"t": "x", "n": i})

    _total, pages, _tc = _both(
        build, lambda p: (p.AggregateRequest("x").load("@n")
                          .sort_by(("@n", p.ASC)).cursor(10)), "cu")
    assert len(pages) == 6
    vals = [int(float(r["n"])) for p, _c in pages for r in p]
    assert vals == sorted(vals) and len(set(vals)) == 57


def test_read_count_override_and_ids():
    """FT.CURSOR READ COUNT overrides the page size; ids come from a
    per-Client counter, as in the JAX package."""
    _total, pages, tc = _both(
        _strm, lambda p: p.AggregateRequest("*").load("@x").cursor(1000),
        "strm", count=700)
    assert [len(p) for p, _c in pages] == [1000] + [700] * 5 + [500]
    assert {c for _p, c in pages[:-1]} == {1} and pages[-1][1] == 0
    res = tc.ft_aggregate("strm", rt.AggregateRequest("*").cursor(10))
    assert res.cursor_id == 2


def test_limit_stops_pulling_the_source():
    """A LIMIT that fills within the first chunk never builds the rows
    of later chunks."""
    _j, (pkg, c) = _clients()
    _strm(rt, c)
    built = []
    real = TP._materialize

    def counting(index, rows, fields):
        built.append(len(rows))
        return real(index, rows, fields)

    TP._materialize = counting
    try:
        res = c.ft_aggregate("strm", rt.AggregateRequest("*").load("@x")
                             .limit(10, 5).cursor(3))
        pages = _drain(c, "strm", res)
    finally:
        TP._materialize = real
    assert [len(p) for p, _c in pages] == [3, 2]
    assert sum(built) == TP._STREAM_CHUNK


def test_cursor_idle_gc_del_and_not_found(monkeypatch):
    """Idle cursors are swept after their timeout (a patched clock);
    FT.CURSOR DEL drops a cursor; a dropped or unknown id raises
    CursorNotFound."""
    _j, (pkg, c) = _clients()
    _strm(rt, c)
    clock = [1_000.0]
    monkeypatch.setattr(TC.time, "time", lambda: clock[0])
    a = c.ft_aggregate("strm", rt.AggregateRequest("*").load("@x")
                       .cursor(10))
    b = c.ft_aggregate("strm", rt.AggregateRequest("*").load("@x")
                       .cursor(10))
    assert (a.cursor_id, b.cursor_id) == (1, 2) and len(c.cursors) == 2
    clock[0] += 200.0
    c.ft_cursor_read("strm", b.cursor_id)        # b touched at 1,200
    clock[0] += 200.0                            # a idle 400 s, b 200 s
    assert c.cursors.collect_idle() == 1
    with pytest.raises(CursorNotFound):
        c.ft_cursor_read("strm", a.cursor_id)
    rows, cid = c.ft_cursor_read("strm", b.cursor_id)
    assert cid == b.cursor_id and [r["x"] for r in rows] == [
        float(i) for i in range(20, 30)]
    assert c.ft_cursor_del("strm", b.cursor_id)
    assert not c.ft_cursor_del("strm", b.cursor_id)
    with pytest.raises(CursorNotFound):
        c.ft_cursor_read("strm", b.cursor_id)
    with pytest.raises(CursorNotFound):
        c.ft_cursor_read("strm", 99)
    assert len(c.cursors) == 0


def test_cursor_holds_host_state_only():
    """A parked cursor's source holds host arrays: the window program's
    outputs were copied to the host before the first read."""
    _j, (pkg, c) = _clients()
    _strm(rt, c)
    res = c.ft_aggregate("strm", rt.AggregateRequest("row").load("@x")
                         .cursor(10))
    src = c.cursors._cursors[res.cursor_id].source
    frames = src.gi_frame.f_locals          # down the generator chain
    while "seg_results" not in frames:
        frames = frames["chunks"].gi_frame.f_locals
    for _seg, sr, keep in frames["seg_results"]:
        for v in (sr.local_idx, sr.scores, sr.valid, keep):
            assert isinstance(v, np.ndarray)
