"""Batched FT.AGGREGATE through the port against the JAX package, on the CPU.

Both packages index the same documents (made from seeded numpy
generators).  The port's `run_aggregate_many` (the intersection kernel's
raw mode and the batched group-by, here their plain torch versions) is
compared with

(a) the JAX package's host pipeline (`run_aggregate` with the device
    fast path bypassed: row by row, in float64), and
(b) the JAX package's `run_aggregate_many` with both Pallas kernels in
    interpret mode (the kernel-raw branch the port mirrors),

on the 900-doc corpus of tests/test_device_groupby.py and on bench.py's
aggregate shape at 2k docs (one segment and two).  The window branch
(MIN/MAX, match-all `*`, pivots past the kernel's bound) and the single
request `run_aggregate` are compared with the JAX package's
`run_aggregate_many` / `run_aggregate` on its CPU device path.  Totals, group keys
and row order must be equal.  Floats agree within rtol 1e-5 against (a)
(f32 device sums against float64 host sums) and within 2e-3 against (b),
whose bf16 one-hot split the JAX package's own test allows.  A STDDEV
comes from an f32 sum of squares minus sum^2/n on the device (in both
packages), so against (a) it is held on the centred sum of squares
(n-1)*sd^2, within 1e-5 of the group's sum of squares n*(avg^2 + ...)
that the f32 rounding scales with.

The compiled APPLY/FILTER closures (`agg/device_expr.py`) are compared
operator by operator with the JAX closures on columns with NULLs, zeros
and negatives (values within rtol 1e-6, presence equal; results below
the smallest normal f32 may flush to zero on one side).

Requests the device GROUPBY does not serve (LOAD, APPLY/FILTER chains
over stored fields, every host reducer, an unsortable TAG key, more than
65,536 composite groups) run the host pipeline over the window program's
rows, single and batched (in their own place in a mixed batch), on one
segment and two: against the JAX package's `run_aggregate` the totals,
the row order and every stored-field value and host reducer output are
equal (TOLIST, FIRST_VALUE and RANDOM_SAMPLE see rows in window order in
both), and `__score` agrees within the window tolerance of
tests/test_torch_execute.py (rtol 1e-5, atol 1e-7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.agg import device_expr as JDX
from redisearch_tpu.agg import expr as JE
from redisearch_tpu.agg import pipeline as JP
from redisearch_tpu.ops import groupby as JGB
from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu_torch.agg import expr as TE
from redisearch_tpu_torch.agg import device_expr as TDX
from redisearch_tpu_torch.agg import pipeline as TP
from redisearch_tpu_torch.ops import groupby as TGB
from redisearch_tpu_torch.ops import intersect as TIK

RTOL_HOST = 1e-5
RTOL_KERNEL = 2e-3
RTOL_EXPR = 1e-6
ATOL_EXPR = float(np.finfo(np.float32).tiny)    # denormal flush

# ---------------------------------------------------------------------------
# device_expr
# ---------------------------------------------------------------------------

EXPRS = ["@a + @b", "@a - @b", "@a * @b", "@a / @b", "@a % @b", "@a ^ 2",
         "@b ^ @a", "-@a", "!@a", "@a == @b", "@a != @b", "@a < @b",
         "@a <= @b", "@a > @b", "@a >= @b", "@a && @b", "@a || @b",
         "abs(@a)", "ceil(@a)", "floor(@a)", "exp(@a / 100)", "log(@a)",
         "log2(@b)", "sqrt(@a)", "hour(@t)", "minute(@t)", "dayofweek(@t)",
         "exists(@a)", "case(@a > 0, @a, @b)", "to_number(@b)",
         "@a + NULL", "NULL || @b", "2 * 3 + 1", "!(@a > 1) && (@b % 3)",
         "floor(@a / 7) % -3"]


def _expr_cols():
    rng = np.random.default_rng(5)
    n = 96
    a = rng.normal(0, 50, n).round(1).astype(np.float32)
    a[rng.random(n) < 0.15] = 0.0
    b = rng.integers(-9, 10, n).astype(np.float32)
    t = rng.integers(-10 ** 6, 2 * 10 ** 6, n).astype(np.float32)
    pres = {c: rng.random(n) > 0.2 for c in "abt"}
    return {"a": a, "b": b, "t": t}, pres


@pytest.mark.parametrize("src", EXPRS)
def test_device_expr_matches_jax(src):
    vals, pres = _expr_cols()
    avail = {"a", "b", "t"}
    jf = JDX.compile_device_expr(JE.parse(src), avail)
    tf = TDX.compile_device_expr(TE.parse(src), avail)
    assert jf is not None and tf is not None
    jv, jp = jf({c: (jnp.asarray(vals[c]), jnp.asarray(pres[c]))
                 for c in vals})
    tv, tp = tf({c: (torch.from_numpy(vals[c]), torch.from_numpy(pres[c]))
                 for c in vals})
    n = len(vals["a"])
    jv, jp = (np.broadcast_to(np.asarray(x), (n,)) for x in (jv, jp))
    tv = np.broadcast_to(tv.numpy(), (n,))
    tp = np.broadcast_to(tp.numpy(), (n,))
    assert tv.dtype == np.float32 and tp.dtype == np.bool_
    np.testing.assert_array_equal(tp, jp, err_msg=src)
    np.testing.assert_allclose(tv[jp], jv[jp], rtol=RTOL_EXPR,
                               atol=ATOL_EXPR, equal_nan=True, err_msg=src)


def test_device_expr_refusals_match_jax():
    """Shapes the device cannot prove safe compile to None in both."""
    for src in ("@s + 1", "upper(@a)", "@missing * 2", "'x'"):
        assert JDX.compile_device_expr(JE.parse(src), {"a"}) is None
        assert TDX.compile_device_expr(TE.parse(src), {"a"}) is None


def test_floor_divide_and_mod_signs():
    """torch.floor_divide / torch.remainder round toward -inf like
    jnp.floor_divide / jnp.mod, on every sign combination."""
    x = np.array([-7.5, -7.0, -0.5, 0.0, 0.5, 7.0, 7.5], np.float32)
    for d in (3.0, -3.0, 0.75):
        np.testing.assert_array_equal(
            torch.floor_divide(torch.from_numpy(x), d).numpy(),
            np.asarray(jnp.floor_divide(jnp.asarray(x), d)))
        np.testing.assert_array_equal(
            torch.remainder(torch.from_numpy(x), d).numpy(),
            np.asarray(jnp.mod(jnp.asarray(x), d)))


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

def _kgb_fields(p):
    return [p.Field("t", p.FieldType.TEXT),
            p.Field("cat", p.FieldType.TAG, sortable=True),
            p.Field("x", p.FieldType.NUMERIC, sortable=True)]


@pytest.fixture(scope="module")
def kgb_idx():
    """tests/test_device_groupby.py's 900-doc kernel-GROUPBY corpus."""
    rng = np.random.default_rng(23)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    docs = [(f"d{i}", {"t": " ".join(rng.choice(words, 3)),
                       "cat": f"c{i % 7}", "x": float(rng.normal(50, 20))})
            for i in range(900)]
    jix = rs.SearchIndex(rs.Schema(name="kgb", fields=_kgb_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="kgb", fields=_kgb_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        for key, f in docs:
            ix.add_document(key, dict(f))
        ix.commit()
    return jix, tix


def _bench_fields(p):
    F, T = p.Field, p.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True)]


def _bench_docs():
    """bench.py's corpus shape (4 title + 20 body zipf(1.25) tokens, 16
    cats, 1000 groups, integer prices) at 2k docs, as
    tests/test_torch_search.py builds it; query terms among the 30 most
    frequent words keep the intersections non-empty at this size."""
    rng = np.random.default_rng(0)
    vocab = 2000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(2000, 24)) - 1, 0, vocab - 1)
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "cat": "cat%02d" % (i % 16),
                       "grp": "g%04d" % (i % 1000),
                       "price": float(rng.integers(1, 10_000))})
            for i in range(2000)]
    qt = ["w%06d" % i for i in rng.integers(0, 30, size=64)]
    return docs, qt


def _bench_pair(n_segments: int):
    docs, qt = _bench_docs()
    jix = rs.SearchIndex(rs.Schema(name="bm25", fields=_bench_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="bm25", fields=_bench_fields(rt)),
                         device="cpu")
    step = len(docs) // n_segments
    for ix in (jix, tix):
        for s in range(n_segments):
            ix.add_documents(docs[s * step:(s + 1) * step])
        assert len(ix.segments) == n_segments
    return jix, tix, qt


@pytest.fixture(scope="module")
def bench_idx():
    return _bench_pair(1)


@pytest.fixture(scope="module")
def bench_idx2():
    return _bench_pair(2)


# ---------------------------------------------------------------------------
# requests: builders take the package's pipeline module
# ---------------------------------------------------------------------------

def req_kgb_all(P, q):
    return (P.AggregateRequest(q)
            .group_by("@cat", ("COUNT", [], "n"), ("SUM", ["@x"], "sx"),
                      ("AVG", ["@x"], "ax"), ("STDDEV", ["@x"], "dx"))
            .sort_by(("@cat", P.DESC)))


def req_kgb_tail(P, q):
    return (P.AggregateRequest(q)
            .group_by("@cat", ("COUNT", [], "n"), ("SUM", ["@x"], "sx"))
            .sort_by(("@sx", P.DESC)).limit(0, 3))


def req_kgb_numkey(P, q):
    """Two keys, one NUMERIC (its values dictionary-encoded per
    segment), multi-key sort on the host finish."""
    return (P.AggregateRequest(q)
            .group_by(["@cat", "@x"], ("COUNT", [], "n"))
            .sort_by(("@cat", P.ASC), ("@x", P.DESC)).limit(0, 20))


def req_bench(P, q):
    """bench.py's aggregate request (BASELINE config 5)."""
    return (P.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("AVG", ["@price"], "a"))
            .sort_by(("@s", P.DESC)).limit(0, 10))


def req_stddev(P, q):
    return (P.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"),
                      ("STDDEV", ["@price"], "sd"), ("AVG", ["@price"], "a"))
            .sort_by("@grp"))


def req_multikey(P, q):
    """(@grp, a computed numeric key) through an APPLY alias."""
    return (P.AggregateRequest(q)
            .apply("floor(@price / 1000)", "pb")
            .group_by(["@grp", "@pb"], ("COUNT", [], "n"),
                      ("SUM", ["@price"], "s"))
            .sort_by(("@s", P.DESC)).limit(0, 10))


def req_apply_filter(P, q):
    return (P.AggregateRequest(q)
            .apply("@price * 2 - 1", "p2")
            .filter("@price > 2000 && @price % 7 != 3")
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@p2"], "s2"),
                      ("AVG", ["@price"], "a"))
            .sort_by(("@s2", P.ASC)).limit(2, 8))


KGB_QUERIES = ["alpha beta", "beta gamma", "alpha -beta", "alpha beta",
               "gamma delta", "alpha ~eps", "alpha|beta"]


def _bench_queries(qt, n=6):
    return [f"{qt[2 * i]} {qt[2 * i + 1]}" for i in range(n)]


def _host(jix, reqs, monkeypatch):
    """(a): the JAX host pipeline, device fast path bypassed."""
    with monkeypatch.context() as m:
        m.setattr(JP, "_try_device_group", lambda *a, **k: None)
        return [JP.run_aggregate(jix, r) for r in reqs]


def _interpret(jix, reqs):
    """(b): the JAX kernel-raw batch path, Pallas kernels interpreted."""
    JIK._INTERPRET = True
    JGB._INTERPRET = True
    jax.clear_caches()
    try:
        return JP.run_aggregate_many(jix, reqs)
    finally:
        JIK._INTERPRET = False
        JGB._INTERPRET = False
        jax.clear_caches()


#: STDDEV alias -> the AVG alias of the same operand, in the requests
STD_AVG = {"dx": "ax", "sd": "a"}


def _assert_same(tres, jres, rtol, queries, std_centred=False):
    assert len(tres) == len(jres)
    for q, t, j in zip(queries, tres, jres):
        assert t.total == j.total, q
        assert len(t.rows) == len(j.rows), q
        for rt_, rj in zip(t.rows, j.rows):
            assert list(rt_) == list(rj), q
            for key, vj in rj.items():
                vt = rt_[key]
                if std_centred and key in STD_AVG and vj is not None:
                    n, avg = rj["n"], rj[STD_AVG[key]]
                    sumsq = (n - 1) * vj * vj + n * avg * avg
                    assert abs((n - 1) * (vt * vt - vj * vj)) <= (
                        rtol * sumsq), (q, key, vt, vj)
                elif isinstance(vj, float) and not isinstance(vt, str):
                    assert vt is not None, (q, key)
                    assert abs(vt - vj) <= rtol * max(1.0, abs(vj)), (
                        q, key, vt, vj)
                else:
                    assert vt == vj, (q, key, vt, vj)


def _port(tix, P_reqs):
    TP.AGG_PATH_STATS.clear()
    out = tix.aggregate_many(P_reqs)
    return out, dict(TP.AGG_PATH_STATS)


# ---------------------------------------------------------------------------
# the 900-doc corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mk,path", [
    (req_kgb_all, "device"), (req_kgb_tail, "device-tail"),
    (req_kgb_numkey, "device")], ids=["all-reducers", "tail", "numkey"])
def test_kgb_matches_host(kgb_idx, mk, path, monkeypatch):
    jix, tix = kgb_idx
    jres = _host(jix, [mk(JP, q) for q in KGB_QUERIES], monkeypatch)
    tres, stats = _port(tix, [mk(TP, q) for q in KGB_QUERIES])
    assert stats == {path: len(KGB_QUERIES)}
    _assert_same(tres, jres, RTOL_HOST, KGB_QUERIES, std_centred=True)
    assert all(r.total > 0 and r.rows for r in tres)


def test_kgb_matches_jax_kernel_interpret(kgb_idx):
    jix, tix = kgb_idx
    jres = _interpret(jix, [req_kgb_all(JP, q) for q in KGB_QUERIES])
    tres, _ = _port(tix, [req_kgb_all(TP, q) for q in KGB_QUERIES])
    _assert_same(tres, jres, RTOL_KERNEL, KGB_QUERIES)


# ---------------------------------------------------------------------------
# bench.py's aggregate shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mk,path", [
    (req_bench, "device-tail"), (req_stddev, "device"),
    (req_multikey, "device-tail"), (req_apply_filter, "device-tail")],
    ids=["bench", "stddev", "multikey", "apply-filter"])
def test_bench_shape_matches_host(bench_idx, mk, path, monkeypatch):
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt)
    jres = _host(jix, [mk(JP, q) for q in qs], monkeypatch)
    tres, stats = _port(tix, [mk(TP, q) for q in qs])
    assert stats == {path: len(qs)}
    _assert_same(tres, jres, RTOL_HOST, qs, std_centred=True)
    assert sum(len(r.rows) for r in tres) > 0


@pytest.mark.parametrize("mk", [req_bench, req_stddev],
                         ids=["bench", "stddev"])
def test_bench_shape_matches_jax_kernel_interpret(bench_idx, mk):
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 4)
    jres = _interpret(jix, [mk(JP, q) for q in qs])
    tres, _ = _port(tix, [mk(TP, q) for q in qs])
    _assert_same(tres, jres, RTOL_KERNEL, qs)


@pytest.mark.parametrize("mk", [req_bench, req_multikey],
                         ids=["bench", "multikey"])
def test_two_segments_match_host(bench_idx2, mk, monkeypatch):
    """Two segments: no device tail; the host merges the per-segment
    group stats across the segments' dictionaries."""
    jix, tix, qt = bench_idx2
    qs = _bench_queries(qt)
    jres = _host(jix, [mk(JP, q) for q in qs], monkeypatch)
    tres, stats = _port(tix, [mk(TP, q) for q in qs])
    assert stats == {"device": len(qs)}
    _assert_same(tres, jres, RTOL_HOST, qs)


def test_chunked_batches_match(bench_idx, monkeypatch):
    """A staging cap that forces 1-2 query chunks gives the same results
    as one chunk (the chunk size is an executor detail)."""
    _jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 5)
    whole, _ = _port(tix, [req_bench(TP, q) for q in qs])
    assert TP._chunk_size(3072, 1, 1) == 1024
    monkeypatch.setattr(TP, "_MAX_BATCH_STAGE", 2 * 3072 * 7)
    assert TP._chunk_size(3072, 1, 1) == 2
    chunked, _ = _port(tix, [req_bench(TP, q) for q in qs])
    _assert_same(chunked, whole, 0.0, qs)


def test_chunk_size_at_bench_shapes():
    """The JAX package's cap at 1024 queries refuses the bench's 8192
    pivot bucket (W_raw 9216: 66M staged elements); the port halves the
    chunk instead."""
    assert 1024 * 9216 * 7 > TP._MAX_BATCH_STAGE
    assert TP._chunk_size(9216, 1, 1) == 512
    assert TP._chunk_size(33792, 1, 1) == 256
    assert TP._chunk_size(2048, 1, 1) == 1024


def test_async_handle_and_kernel_counts(bench_idx):
    """async_=True returns a handle; CPU tensors never count a kernel
    launch."""
    _jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 3)
    sync, _ = _port(tix, [req_bench(TP, q) for q in qs])
    TIK.LAUNCHES = TGB.LAUNCHES = 0
    h = TP.run_aggregate_many(tix, [req_bench(TP, q) for q in qs],
                              async_=True)
    assert isinstance(h, TP.Deferred)
    _assert_same(h.result(), sync, 0.0, qs)
    assert TIK.LAUNCHES == 0 and TGB.LAUNCHES == 0


def test_client_front_door(bench_idx):
    """Client.ft_create + hset + ft_aggregate_many and ft_aggregate serve
    what the JAX Client serves on the same documents."""
    jix, _tix, qt = bench_idx
    jc, tc = rs.Client(), rt.Client(device="cpu")
    docs = [(jix.doctable.get(g).key, jix.doctable.get(g).fields)
            for g in range(1, 1201)]
    for c, pkg in ((jc, rs), (tc, rt)):
        c.ft_create("bm25", _bench_fields(pkg))
        for key, f in docs:
            c.hset(key, f)
    qs = _bench_queries(qt, 4)
    jres = jc.ft_aggregate_many("bm25", [req_bench(JP, q) for q in qs])
    tres = tc.ft_aggregate_many("bm25", [req_bench(rt, q) for q in qs])
    _assert_same(tres, jres, RTOL_KERNEL, qs)
    assert all(r.total > 0 for r in tres)
    # single-request FT.AGGREGATE, through the Client and the index
    for q in qs[:2]:
        j = jc.ft_aggregate("bm25", req_minmax(JP, q))
        _assert_same([tc.ft_aggregate("bm25", req_minmax(rt, q)),
                      tc._index("bm25").aggregate(req_minmax(rt, q))],
                     [j, j], RTOL_HOST, [q, q])


@pytest.mark.parametrize("mk,item", [
    (lambda P, q: P.AggregateRequest(q).group_by(
        "@grp", ("MIN", ["@price"], "lo")), "device"),
    (lambda P, q: P.AggregateRequest(q).group_by(
        "@grp", ("MAX", ["@price"], "hi"), ("COUNT", [], "n")), "device"),
    (lambda P, q: P.AggregateRequest("*").group_by(
        "@grp", ("COUNT", [], "n")), "device"),
    (lambda P, q: P.AggregateRequest(q).load("@price").group_by(
        "@grp", ("COUNT", [], "n")), "host"),
    (lambda P, q: P.AggregateRequest(q).group_by(
        "@grp", ("TOLIST", ["@price"], "l")), "host"),
    (lambda P, q: P.AggregateRequest(q).group_by(
        "@cat", ("COUNT", [], "n")), "host"),
], ids=["min", "max", "match-all", "load", "tolist", "unsortable-key"])
def test_off_branch_requests_raise(bench_idx, mk, item):
    """Requests off the kernel-raw branch, batched behind a kernel-raw
    request: MIN/MAX and match-all run on the window branch and equal the
    JAX package's device path (groups in id order); LOAD, TOLIST and an
    unsortable key run the host pipeline when the batch is collected and
    equal the JAX host pipeline, in their own place in the output."""
    jix, tix, qt = bench_idx
    q = _bench_queries(qt, 1)[0]
    tres, stats = _port(tix, [req_bench(TP, q), mk(TP, q)])
    assert stats == {"device-tail": 1, item: 1}
    assert tres[1].total > 0
    if item == "device":
        _assert_same(tres[1:], JP.run_aggregate_many(jix, [mk(JP, q)]),
                     RTOL_HOST, [q])
    else:
        _assert_host_same(tres[1:], [JP.run_aggregate(jix, mk(JP, q))])


# ---------------------------------------------------------------------------
# the host pipeline (a window source, steps on host rows)
# ---------------------------------------------------------------------------

SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-7


def _assert_host_same(tres, jres):
    """Totals, row order, keys and every value equal; `__score` within
    the window program's tolerance."""
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert t.total == j.total
        assert len(t.rows) == len(j.rows)
        for rt_, rj in zip(t.rows, j.rows):
            assert list(rt_) == list(rj)
            for key, vj in rj.items():
                if key == "__score":
                    assert abs(rt_[key] - vj) <= (SCORE_ATOL
                                                  + SCORE_RTOL * abs(vj))
                else:
                    assert rt_[key] == vj, (key, rt_[key], vj)


def req_load(P, q):
    return (P.AggregateRequest(q).load("@price", "@cat", "@title")
            .sort_by(("@price", P.DESC), ("@cat", P.ASC)).limit(3, 40))


def req_apply_chain(P, q):
    """APPLY/FILTER over stored TAG and NUMERIC fields, string functions
    and a second APPLY over the first, then a host sort."""
    return (P.AggregateRequest(q, add_scores=True)
            .apply("upper(@cat)", "ucat")
            .apply("@price / 100 + strlen(@ucat)", "pp")
            .filter("@pp > 20 && !startswith(@ucat, 'CAT01')")
            .apply("floor(@pp) % 5", "b")
            .sort_by(("@b", P.ASC), ("@price", P.DESC)).limit(0, 50))


def req_all_reducers(P, q):
    """Every host reducer of agg/reducers.py but the coordinator ones."""
    return (P.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("SUMSQ", ["@price"], "sq"), ("MIN", ["@price"], "lo"),
                      ("MAX", ["@price"], "hi"), ("AVG", ["@price"], "a"),
                      ("STDDEV", ["@price"], "sd"),
                      ("COUNT_DISTINCT", ["@cat"], "dc"),
                      ("COUNT_DISTINCTISH", ["@cat"], "dci"),
                      ("TOLIST", ["@cat"], "cats"),
                      ("COLLECT", ["@price"], "ps"),
                      ("FIRST_VALUE", ["@price"], "f0"),
                      ("FIRST_VALUE", ["@cat", "BY", "@price", "DESC"],
                       "fb"),
                      ("RANDOM_SAMPLE", ["@price", "2"], "rs"),
                      ("QUANTILE", ["@price", "0.5"], "med"))
            .sort_by(("@n", P.DESC), ("@grp", P.ASC)))


def req_hll(P, q):
    """HLL per category, then HLL_SUM over every category (one group:
    the second key is missing in every row)."""
    return (P.AggregateRequest(q)
            .group_by("@cat", ("HLL", ["@grp"], "h"))
            .group_by("@none", ("HLL_SUM", ["@h"], "hs")))


def req_wide_key(P, q):
    """(@grp, @price): 1,001 x (distinct prices + 1) composite groups,
    more than the device's 65,536."""
    return (P.AggregateRequest(q)
            .group_by(["@grp", "@price"], ("COUNT", [], "n"),
                      ("TOLIST", ["@title"], "t"))
            .sort_by(("@grp", P.ASC), ("@price", P.DESC)).limit(0, 30))


def req_unsortable(P, q):
    return (P.AggregateRequest(q)
            .group_by("@cat", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("RANDOM_SAMPLE", ["@grp", "3"], "g3"))
            .sort_by(("@s", P.DESC)))


HOST_REQS = [req_load, req_apply_chain, req_all_reducers, req_hll,
             req_wide_key, req_unsortable]
HOST_IDS = ["load", "apply-chain", "all-reducers", "hll", "wide-key",
            "unsortable-key"]


@pytest.mark.parametrize("mk", HOST_REQS, ids=HOST_IDS)
def test_host_pipeline_matches_jax(bench_idx, mk):
    """run_aggregate on the host pipeline against the JAX package's."""
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 3)
    TP.AGG_PATH_STATS.clear()
    tres = [TP.run_aggregate(tix, mk(TP, q)) for q in qs]
    assert TP.AGG_PATH_STATS == {"host": len(qs)}
    _assert_host_same(tres, [JP.run_aggregate(jix, mk(JP, q)) for q in qs])
    assert all(r.rows for r in tres)


@pytest.mark.parametrize("mk", [req_all_reducers, req_wide_key],
                         ids=["all-reducers", "wide-key"])
def test_host_pipeline_two_segments_match_jax(bench_idx2, mk):
    """Rows are built segment by segment, window slot by window slot, in
    both packages: order-sensitive reducers agree across segments."""
    jix, tix, qt = bench_idx2
    qs = _bench_queries(qt, 2) + ["*"]
    tres = tix.aggregate_many([mk(TP, q) for q in qs])
    _assert_host_same(tres, [JP.run_aggregate(jix, mk(JP, q)) for q in qs])


def test_mixed_batch_keeps_request_order(bench_idx):
    """A batch mixing kernel-raw, window-branch and host requests returns
    each result in its request's place, equal to the JAX package's."""
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 4)
    mks = [req_bench, req_load, req_minmax, req_all_reducers, req_bench,
           req_unsortable, req_star, req_apply_chain]
    tres, stats = _port(tix, [mk(TP, q) for mk, q in
                              zip(mks, qs + qs)])
    assert stats == {"device-tail": 4, "host": 4}
    jres = JP.run_aggregate_many(jix, [mk(JP, q) for mk, q in
                                       zip(mks, qs + qs)])
    for i, mk in enumerate(mks):
        if mk in (req_bench, req_minmax, req_star):
            _assert_same(tres[i:i + 1], jres[i:i + 1], RTOL_KERNEL,
                         [qs[i % 4]])
        else:
            _assert_host_same(tres[i:i + 1], jres[i:i + 1])


def test_profile_timings(bench_idx):
    """run_aggregate(profile=...) records RP_INDEX and one entry per
    step on the host pipeline, one fused entry on the device path."""
    _jix, tix, qt = bench_idx
    q = _bench_queries(qt, 1)[0]
    prof = {}
    res = TP.run_aggregate(tix, req_all_reducers(TP, q), profile=prof)
    names = [e["name"] for e in prof["result_processors"]]
    assert names == ["RP_INDEX", "GROUP", "SORT"]
    assert prof["result_processors"][-1]["rows"] == len(res.rows)
    prof = {}
    TP.run_aggregate(tix, req_minmax(TP, q), profile=prof)
    assert [e["name"] for e in prof["result_processors"]] == [
        "RP_INDEX+DeviceGroupBy(fused)"]


# ---------------------------------------------------------------------------
# the window branch and the single-request path (kernels B4/B5)
# ---------------------------------------------------------------------------

def req_minmax(P, q):
    """bench.py's aggregate request with MIN and MAX of the price."""
    return (P.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("AVG", ["@price"], "a"), ("MIN", ["@price"], "lo"),
                      ("MAX", ["@price"], "hi"))
            .sort_by(("@s", P.DESC)).limit(0, 10))


def req_star(P, _q):
    """bench.py's bench_agg_star request: match-all over every row."""
    return (P.AggregateRequest("*")
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"))
            .sort_by(("@s", P.DESC)).limit(0, 10))


def req_kgb_minmax(P, q):
    return (P.AggregateRequest(q)
            .apply("@x * 2", "x2")
            .group_by("@cat", ("COUNT", [], "n"), ("MIN", ["@x"], "lo"),
                      ("MAX", ["@x2"], "hi"), ("STDDEV", ["@x"], "dx"),
                      ("AVG", ["@x"], "ax"))
            .sort_by(("@cat", P.ASC)))


@pytest.mark.parametrize("mk", [req_minmax, req_star, req_bench,
                                req_multikey],
                         ids=["minmax", "star", "bench", "multikey"])
def test_single_run_aggregate_matches_jax(bench_idx, mk):
    """run_aggregate: the window program per segment, then B4/B5 (their
    plain twins here), against the JAX package's run_aggregate on its
    device path (segment reductions on the CPU)."""
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 3)
    TP.AGG_PATH_STATS.clear()
    tres = [TP.run_aggregate(tix, mk(TP, q)) for q in qs]
    assert TP.AGG_PATH_STATS == {"device": len(qs)}
    jres = [JP.run_aggregate(jix, mk(JP, q)) for q in qs]
    _assert_same(tres, jres, RTOL_HOST, qs)
    assert all(r.rows for r in tres)


@pytest.mark.parametrize("mk,path", [(req_minmax, "device-tail"),
                                     (req_star, "device-tail"),
                                     (req_stddev, "device")],
                         ids=["minmax", "star", "stddev"])
def test_window_branch_batch_matches_jax(bench_idx, mk, path):
    """run_aggregate_many off the kernel-raw branch: MIN/MAX take the
    single-query kernels per query, `*` stages its windows for the
    batched group-by; against the JAX package's run_aggregate_many."""
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 4)
    tres, stats = _port(tix, [mk(TP, q) for q in qs])
    assert stats == {path: len(qs)}
    jres = JP.run_aggregate_many(jix, [mk(JP, q) for q in qs])
    _assert_same(tres, jres, RTOL_HOST, qs, std_centred=True)


def test_wide_pivots_take_the_window_branch(bench_idx, monkeypatch):
    """A pivot window past the kernel's pivot bound (32,768 on the card;
    lowered here so that the 2k-doc corpus reaches it) takes the window
    branch and serves what the kernel-raw branch serves."""
    jix, tix, qt = bench_idx
    qs = _bench_queries(qt, 4)
    want, _ = _port(tix, [req_bench(TP, q) for q in qs])
    monkeypatch.setattr(TIK, "MAX_W_PIVOT", 1024)
    TP._PLAN_CACHE.clear()
    calls = []
    real = TP._make_fused_cols
    monkeypatch.setattr(TP, "_make_fused_cols",
                        lambda *a: calls.append(1) or real(*a))
    got, stats = _port(tix, [req_bench(TP, q) for q in qs])
    assert stats == {"device-tail": len(qs)} and calls
    _assert_same(got, want, 0.0, qs)
    jres = JP.run_aggregate_many(jix, [req_bench(JP, q) for q in qs])
    _assert_same(got, jres, RTOL_HOST, qs)


@pytest.mark.parametrize("mk", [req_minmax, req_star],
                         ids=["minmax", "star"])
def test_two_segments_window_branch_match_jax(bench_idx2, mk):
    """Two segments: per-segment MIN/MAX merged with np.minimum.at /
    np.maximum.at on the host, single and batched."""
    jix, tix, qt = bench_idx2
    qs = _bench_queries(qt, 3)
    jres = [JP.run_aggregate(jix, mk(JP, q)) for q in qs]
    _assert_same([TP.run_aggregate(tix, mk(TP, q)) for q in qs], jres,
                 RTOL_HOST, qs)
    tres, stats = _port(tix, [mk(TP, q) for q in qs])
    assert stats == {"device": len(qs)}
    _assert_same(tres, jres, RTOL_HOST, qs)


def test_kgb_minmax_matches_jax(kgb_idx):
    """tests/test_device_groupby.py's corpus: MIN/MAX over a column and
    over an APPLY alias, with STDDEV, single and batched."""
    jix, tix = kgb_idx
    jres = [JP.run_aggregate(jix, req_kgb_minmax(JP, q))
            for q in KGB_QUERIES]
    single = [TP.run_aggregate(tix, req_kgb_minmax(TP, q))
              for q in KGB_QUERIES]
    _assert_same(single, jres, RTOL_HOST, KGB_QUERIES, std_centred=True)
    batch, stats = _port(tix, [req_kgb_minmax(TP, q) for q in KGB_QUERIES])
    assert stats == {"device": len(KGB_QUERIES)}
    _assert_same(batch, jres, RTOL_HOST, KGB_QUERIES, std_centred=True)
    assert all(r.total > 0 and r.rows for r in batch)


# ---------------------------------------------------------------------------
# two numeric operands (one multi-valued) through the fused kernel's entry
# ---------------------------------------------------------------------------

def _pq_fields(p):
    F, T = p.Field, p.FieldType
    return [F("t", T.TEXT), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True), F("qty", T.NUMERIC)]


@pytest.fixture(scope="module")
def pq_idx():
    """1,200 docs with a price on every doc and a qty on four in five,
    multi-valued on every 13th; 11 groups."""
    rng = np.random.default_rng(41)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    docs = []
    for i in range(1200):
        f = {"t": " ".join(rng.choice(words, 4)), "grp": f"g{i % 11}",
             "price": float(rng.integers(1, 1000)) / 4.0}
        if i % 5:
            f["qty"] = ([float(i % 4), float(i % 9)] if i % 13 == 0
                        else float(rng.normal(3.0, 7.0)))
        docs.append((f"d{i}", f))
    jix = rs.SearchIndex(rs.Schema(name="pq", fields=_pq_fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="pq", fields=_pq_fields(rt)),
                         device="cpu")
    for ix in (jix, tix):
        ix.add_documents(docs)
    return jix, tix


def req_pq(P, q):
    """COUNT, SUM, AVG, STDDEV, MIN and MAX over price and qty."""
    return (P.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("AVG", ["@price"], "a"), ("STDDEV", ["@price"], "sd"),
                      ("MIN", ["@price"], "plo"), ("MAX", ["@price"], "phi"),
                      ("SUM", ["@qty"], "sq"), ("AVG", ["@qty"], "ax"),
                      ("STDDEV", ["@qty"], "dx"), ("MIN", ["@qty"], "qlo"),
                      ("MAX", ["@qty"], "qhi"))
            .sort_by(("@grp", P.ASC)))


PQ_QUERIES = ["alpha beta", "gamma -delta", "*", "eps|zeta", "beta ~alpha"]


def test_two_operands_match_jax(pq_idx):
    """The window branch with two operands (price, and qty with NULLs and
    multi-valued docs) gives the JAX package's rows and totals, batched
    and single, through one fused call a request."""
    jix, tix = pq_idx
    jres = JP.run_aggregate_many(jix, [req_pq(JP, q) for q in PQ_QUERIES])
    tres, stats = _port(tix, [req_pq(TP, q) for q in PQ_QUERIES])
    assert stats == {"device": len(PQ_QUERIES)}
    _assert_same(tres, jres, RTOL_HOST, PQ_QUERIES, std_centred=True)
    single = [TP.run_aggregate(tix, req_pq(TP, q)) for q in PQ_QUERIES]
    _assert_same(single, jres, RTOL_HOST, PQ_QUERIES, std_centred=True)
    assert all(len(r.rows) == 11 for r in tres)
    assert any(r["qlo"] != r["qhi"] for res in tres for r in res.rows)


def test_fused_call_once_per_request(pq_idx, bench_idx2, monkeypatch):
    """`_make_fused` makes one `groupby_aggregate_multi` call a request
    and segment (base count and both operands together), and never the
    one-operand entry."""
    calls = []
    real = TGB.groupby_aggregate_multi

    def counted(gid, valid, ops, G, want_minmax=True):
        calls.append((len(ops), want_minmax))
        return real(gid, valid, ops, G, want_minmax=want_minmax)

    def refused(*a, **k):
        raise AssertionError("groupby_aggregate called")

    monkeypatch.setattr(TGB, "groupby_aggregate_multi", counted)
    monkeypatch.setattr(TGB, "groupby_aggregate", refused)
    _jix, tix = pq_idx
    tix.aggregate_many([req_pq(TP, q) for q in PQ_QUERIES])
    assert calls == [(2, True)] * len(PQ_QUERIES)
    calls.clear()
    TP.run_aggregate(tix, req_pq(TP, PQ_QUERIES[0]))
    assert calls == [(2, True)]
    calls.clear()
    _jix2, tix2, qt = bench_idx2          # two segments: one call each
    qs = _bench_queries(qt, 3)
    tix2.aggregate_many([req_minmax(TP, q) for q in qs])
    assert calls == [(1, True)] * (2 * len(qs))


def test_constant_operand_matches_jax(pq_idx):
    """An APPLY constant as a reducer operand (a 0-dim value the fused
    entry takes as a broadcast column) beside a column operand."""
    jix, tix = pq_idx

    def mk(P, q):
        return (P.AggregateRequest(q).apply("3", "three")
                .group_by("@grp", ("SUM", ["@three"], "s3"),
                          ("MIN", ["@three"], "m3"), ("MAX", ["@qty"], "hi"),
                          ("COUNT", [], "n"))
                .sort_by(("@grp", P.ASC)))

    qs = PQ_QUERIES[:3]
    jres = JP.run_aggregate_many(jix, [mk(JP, q) for q in qs])
    tres, stats = _port(tix, [mk(TP, q) for q in qs])
    assert stats == {"device": len(qs)}
    _assert_same(tres, jres, RTOL_HOST, qs)
    assert all(r["s3"] == 3.0 * r["n"] and r["m3"] == 3.0
               for res in tres for r in res.rows)
