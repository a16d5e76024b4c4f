"""The port's counterparts of the `benchmarks/` scripts (`bench/
wire_bench.py`, `cold_bench.py`, `agg_profile.py`, `intersect_micro.py`,
`phrase_ab.py`) on the CPU,
each through its `main` with `--device cpu` at a tiny shape, held
against the JAX side:

* wire: 2,000 docs, 4 connections x 8 queries; every reply equals the
  reply of the JAX package's `server.Server` to the same commands on the
  same docs (wire_bench.py runs `asyncio.run` at import, so the JAX
  server is driven here, not the script);
* cold: cold_bench.py's own `build` (loaded with importlib) at 2,000
  docs on both storages; totals, ids and order equal the port's, scores
  within rtol 1e-6;
* agg_profile's decomposition at 2,000 docs and B = 16: the last JSON
  line has every phase key, the served results equal the JAX package's
  `run_aggregate_many` (rows, totals);
* intersect_micro and phrase_ab: the scripts' nested window builders
  (taken from their source) at B = 8 give the port's builders' arrays,
  and feed the JAX `intersect_batch` / `phrase_batch` (their XLA
  versions on the CPU) and the port's plain versions: equal lane for
  lane, within test_torch_intersect.py's and test_torch_phrase.py's
  tolerances (docs and counts equal; intersect scores rtol 1e-6, phrase
  scores bit for bit; the raw lanes merged by `iter_topk`);
* the measurement rules: `same_keys` on made-up ties, each wire rep on
  queries of its own, a cold sample's least seconds, and
  `agg_profile.profiled` held to the `run_aggregate_many` it copies.

Nothing here is a device number: on the CPU the kernels run their plain
versions and `device` says "cpu"."""

import ast
import asyncio
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import redisearch_tpu as rs
from redisearch_tpu.agg import pipeline as JP
from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu.server import Server as JServer
from redisearch_tpu_torch.bench import (agg_profile, cold_bench,
                                        intersect_micro, phrase_ab,
                                        wire_bench)
from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.ops import intersect as TIK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _script(name):
    spec = importlib.util.spec_from_file_location(
        "ref_" + name, os.path.join(REPO, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nested(script: str, outer: str, name: str, **env):
    """The function `name` defined inside `outer` of benchmarks/<script>,
    compiled alone with `env` as its globals (its closure's names)."""
    path = os.path.join(REPO, "benchmarks", script + ".py")
    tree = ast.parse(open(path).read())
    top = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == outer)
    fn = next(n for n in ast.walk(top)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(env)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


# ------------------------------------------------------------------ wire
def _jax_wire(docs, cmds, n_conns, sanity):
    """The JAX server's replies to wire_bench.py's commands."""
    async def go():
        srv = JServer(client=rs.Client(), port=0)
        tcp = await srv.serve()
        port = tcp.sockets[0].getsockname()[1]
        c0 = await W.WireConn.open(port)
        pool = [await W.WireConn.open(port) for _ in range(n_conns)]
        try:
            await c0.cmd("FT.CREATE", "bench", "SCHEMA", "t", "TEXT", "b",
                         "TEXT")
            srv.client._index("bench").add_documents(docs)
            replies, _dt = await W.wire_pass(pool, cmds)
            return replies, await c0.cmd(*sanity)
        finally:
            await W.close_conns([c0] + pool)
            tcp.close()
            await tcp.wait_closed()
            await srv.aclose()
            srv._pool.shutdown(wait=True)
    return asyncio.run(go())


def test_wire_bench_against_the_jax_server(capsys):
    out = wire_bench.main(["--docs", "2000", "--conns", "4", "--warm", "2",
                           "--each", "8", "--reps", "2",
                           "--device", "cpu"])
    last = _last_json(capsys)
    assert last["device"] == {"platform": "cpu"}
    assert last["spread"]["n"] == 2 and last["queries_a_pass"] == 32
    assert last["parity"]["checked"] == 64
    assert sum(sum(h.values()) for h in last["batch_sizes"]) > 0
    docs, words = W.wire_corpus(2000)
    # the second rep's timed pass: wire_bench.py's query index i from 8
    cmds = W.wire_cmds(words, 4, 8, start=8)
    assert out["served"]["cmds"] == cmds
    assert cmds[0][2] == (f"{words[(0 * 37 + 8 * 11) % 4000]} "
                          f"{words[(0 * 53 + 8 * 7 + 1) % 4000]}")
    sanity = ("FT.SEARCH", "bench", words[100], "LIMIT", "0", "3",
              "NOCONTENT")
    replies, jsanity = _jax_wire(docs, cmds, 4, sanity)
    assert out["served"]["replies"] == replies
    assert out["served"]["sanity"] == jsanity and jsanity[0] > 0


def test_wire_corpus_is_the_scripts():
    """wire_bench.py's docs and query formulas, as its source draws
    them (the script runs at import, so its lines are compared here)."""
    src = open(os.path.join(REPO, "benchmarks", "wire_bench.py")).read()
    assert 'words = ["w%05d" % i for i in range(5000)]' in src
    assert ('q = f"{words[(idx*37+i*11)%4000]} '
            '{words[(idx*53+i*7+1)%4000]}"') in src
    rng = np.random.default_rng(0)
    words = ["w%05d" % i for i in range(5000)]
    want = [(f"d{i}", {"t": " ".join(words[j] for j in
                                     rng.integers(0, 5000, 4)),
                       "b": " ".join(words[j] for j in
                                     rng.integers(0, 5000, 8))})
            for i in range(300)]
    assert W.wire_corpus(300) == (want, words)


def _hits(*pairs):
    return [types.SimpleNamespace(key=k, score=v) for k, v in pairs]


#: a served result of 5 hits out of 7 matches: d1 alone, d2-d3 tied,
#: d4 alone, d5 tied with matches past the last lane (d6, then d9)
_SERVED = types.SimpleNamespace(total=7, hits=_hits(
    ("d1", 9.0), ("d2", 5.0), ("d3", 5.0 * (1 + 1e-7)), ("d4", 4.0),
    ("d5", 2.0)))
_WIDE = types.SimpleNamespace(total=7, hits=_SERVED.hits + _hits(
    ("d6", 2.0 * (1 - 1e-7)), ("d9", 1.5)))


@pytest.mark.parametrize("keys,wide,ok", [
    (["d1", "d2", "d3", "d4", "d5"], None, True),
    (["d1", "d3", "d2", "d4", "d5"], None, True),       # swapped in a tie
    (["d1", "d2", "d6", "d4", "d5"], _WIDE, False),     # outside the tie
    (["d1", "d2", "d2", "d4", "d5"], None, False),      # a key repeats
    (["d4", "d2", "d3", "d1", "d5"], None, False),      # untied lanes
    (["d1", "d2", "d3", "d4", "d6"], _WIDE, True),      # tie past the end
    (["d1", "d2", "d3", "d4", "d6"], None, False),      # ... unread
    (["d1", "d2", "d3", "d4", "d9"], _WIDE, False),     # ... not tied
    (["d1", "d2", "d3", "d4", "d7"], _WIDE, False),     # ... no match
], ids=["equal", "tie-swap", "outside-tie", "repeat", "untied",
        "tie-past-end", "no-wide", "past-end-untied", "past-end-unknown"])
def test_same_keys_holds_a_tie_to_its_keys(keys, wide, ok):
    """The wire section's parity check: a key may differ from the
    served one only within a tie of the served scores, and there the
    reply's keys must be the tie's; a tie that reaches the last lane of
    a result with more matches may go on to docs of the wider result
    with the same score, and to no other."""
    reply = [_SERVED.total] + keys
    if ok:
        assert W.same_keys(reply, _SERVED, "q", wide and (lambda: wide)
                           ) == (keys == [h.key for h in _SERVED.hits])
    else:
        with pytest.raises(AssertionError):
            W.same_keys(reply, _SERVED, "q", wide and (lambda: wide))
    with pytest.raises(AssertionError, match="total"):
        W.same_keys([6] + keys, _SERVED, "q")


def test_wire_reps_run_fresh_queries(capsys):
    """Each rep sends queries no earlier rep sent, after a warm pass of
    its own first queries, as the script's one run does."""
    sent = []
    real = W.wire_pass

    async def spy(conns, cmds):
        sent.append([c[2] for c in cmds])
        return await real(conns, cmds)

    mp = pytest.MonkeyPatch()
    mp.setattr(W, "wire_pass", spy)
    try:
        out = wire_bench.main(["--docs", "600", "--conns", "2", "--warm",
                               "1", "--each", "3", "--reps", "3",
                               "--device", "cpu"])
    finally:
        mp.undo()
    _last_json(capsys)
    _docs, words = W.wire_corpus(600)
    assert len(sent) == 6
    for rep in range(3):
        warm, timed = sent[2 * rep], sent[2 * rep + 1]
        assert timed == [c[2] for c in W.wire_cmds(words, 2, 3, 3 * rep)]
        assert warm == timed[:2]
        for other in sent[1:2 * rep:2]:
            assert not set(timed) & set(other)
    assert out["served"]["cmds"][0][2] == sent[-1][0]


# ------------------------------------------------------------------ cold
def test_cold_bench_against_cold_bench_py(capsys):
    ref = _script("cold_bench")
    out = cold_bench.main(["--docs", "2000", "--reps", "2",
                           "--min-seconds", "0", "--device", "cpu"])
    last = _last_json(capsys)
    assert set(last) >= {"hbm", "host", "paging_tax_and2", "spread",
                         "routes", "parity", "device"}
    for s in ("hbm", "host"):
        assert set(last[s]) == {"and2_qps", "phrase_qps", "csr_mb",
                                "build_s"}
    assert last["routes"]["hbm"] == {"and2": {"kernel": 256},
                                     "phrase": {"phrase-kernel": 256}}
    assert last["routes"]["host"] == {"and2": {"cold": 256},
                                      "phrase": {"cold": 256}}
    fams = W.cold_queries()
    # the script's two query lists (built inside its `main`)
    src = open(os.path.join(REPO, "benchmarks", "cold_bench.py")).read()
    assert ('qt = ["w%06d" % i for i in rng.integers(20, 3000, size=256)]'
            in src)
    assert ('and2 = [f"{qt[2*i % 250]} {qt[(2*i+1) % 250]}" for i in '
            'range(128)]') in src
    qt = ["w%06d" % i for i in
          np.random.default_rng(7).integers(20, 3000, size=256)]
    assert fams["and2"] == [f"{qt[2*i % 250]} {qt[(2*i+1) % 250]}"
                            for i in range(128)]
    assert fams["phrase"] == [f'"{q}"' for q in fams["and2"]]
    n_hits = 0
    jax = {s: ref.build(s, 2000, np.random.default_rng(0))[0]
           for s in ("hbm", "host")}
    for storage, jix in jax.items():
        seg = jix.segments[0]
        csr = (seg.text.doc_ids.nbytes + seg.text.freqs.nbytes
               + seg.text.field_masks.nbytes + seg.text.doclens.nbytes
               + seg.text.poskeys.nbytes)
        assert last[storage]["csr_mb"] == pytest.approx(csr / 1e6)
        for fam, qs in fams.items():
            want = []
            for q in qs:
                try:
                    want += jix.search_many([q], k=10)
                except TypeError:
                    # the JAX package's cold phrase path raises where a
                    # position window's bucket exceeds the paged slab
                    # (ROADMAP C2); its hot result stands in, which the
                    # script asserts the cold one equals
                    assert (storage, fam) == ("host", "phrase")
                    want += jax["hbm"].search_many([q], k=10)
            for j, t in zip(want, out["served"][storage][fam]):
                assert t.total == j.total, (storage, fam)
                assert [h.key for h in t.hits] == [h.key for h in j.hits]
                np.testing.assert_allclose([h.score for h in t.hits],
                                           [h.score for h in j.hits],
                                           rtol=1e-6, atol=0)
                n_hits += len(j.hits)
    assert n_hits > 0


def test_cold_sample_lasts_min_seconds():
    """A cold sample repeats its pass until its window is long enough,
    and counts every query of its passes."""
    ix, _s = cold_bench.build("hbm", 600, torch.device("cpu"))
    qs = W.cold_queries()["and2"][:16]
    qps, res, routes, passes = cold_bench.measure(ix, qs, 2,
                                                  torch.device("cpu"), 0.2)
    assert len(qps) == 2 and len(res) == 16 and min(passes) >= 1
    for q, n in zip(qps, passes):
        assert q <= n * len(qs) / 0.2
    assert sum(routes.values()) == sum(passes) * len(qs)
    _q, _r, _rt, one = cold_bench.measure(ix, qs, 2, torch.device("cpu"),
                                          0.0)
    assert one == [1, 1]


# -------------------------------------------------------- decompositions
def _jax_request(q):
    return (JP.AggregateRequest(q)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"),
                      ("AVG", ["@price"], "a"))
            .sort_by(("@s", JP.DESC)).limit(0, 10))


def test_agg_profile_against_jax_run_aggregate_many(capsys):
    out = agg_profile.main(["--docs", "2000", "--batch", "16", "--reps",
                            "2", "--device", "cpu"])
    last = _last_json(capsys)
    for p in agg_profile.PHASES:
        assert p + "_ms" in last and last["spread"][p + "_ms"]["n"] == 2
    assert last["groups"] and last["fallback"] == [0]
    assert last["routes"] == {"device-tail": 32}
    docs, _qt = agg_profile.corpus(2000)
    F, T = rs.Field, rs.FieldType
    jix = rs.SearchIndex(rs.Schema(name="bm25", fields=[
        F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
        F("grp", T.TAG, sortable=True), F("price", T.NUMERIC,
                                          sortable=True)]))
    jix.add_documents(docs)
    reqs = out["served"]["requests"]
    jres = JP.run_aggregate_many(jix, [_jax_request(r.query) for r in reqs])
    for t, j in zip(out["served"]["results"], jres):
        assert t.total == j.total and t.rows == j.rows


def _refs(fn) -> set:
    """The names `fn`'s source reads: bare names and `AP.<name>`."""
    import inspect
    import textwrap
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute) and isinstance(
                n.value, ast.Name) and n.value.id == "AP":
            out.add(n.attr)
    return out


def test_agg_profile_copies_run_aggregate_many():
    """`agg_profile.profiled` is a copy of the port's
    `run_aggregate_many` body with clocks: every engine function it
    reaches is one the engine's body reaches, and on the same batch both
    take the same paths, submit the same groups and serve the same
    rows."""
    from redisearch_tpu_torch.agg import pipeline as AP
    engine = _refs(AP.run_aggregate_many)
    copied = {n for n in _refs(agg_profile.profiled)
              if callable(getattr(AP, n, None))}
    assert copied and copied <= engine, copied - engine
    assert {"_plan_device_group_cached", "_device_group_submit_batch",
            "_count_path", "_device_tail_finish", "_device_group_finish",
            "run_aggregate"} <= copied
    dev = torch.device("cpu")
    docs, qt = agg_profile.corpus(1200)
    import redisearch_tpu_torch as rt
    ix = rt.SearchIndex(rt.Schema(name="bm25", fields=agg_profile.fields()),
                        device=dev)
    ix.add_documents(docs)
    reqs = [agg_profile.request(qt, i) for i in range(12)]
    # and one request the device plan does not serve (a fallback)
    reqs.append(rt.AggregateRequest(qt[0]).sort_by(("@price", rt.DESC))
                .limit(0, 5))
    seen = []
    real = AP._device_group_submit_batch

    def spy(index, items):
        seen.append(sorted(r.query for r, _cq, _p in items))
        return real(index, items)

    mp = pytest.MonkeyPatch()
    mp.setattr(AP, "_device_group_submit_batch", spy)
    try:
        runs = []
        for fn in (lambda: AP.run_aggregate_many(ix, reqs),
                   lambda: agg_profile.profiled(ix, reqs, dev)[0]):
            seen.clear()
            before = dict(AP.AGG_PATH_STATS)
            res = fn()
            runs.append((res, W.route_delta(before, AP.AGG_PATH_STATS),
                         sorted(seen)))
    finally:
        mp.undo()
    (want, w_paths, w_groups), (got, g_paths, g_groups) = runs
    assert g_paths == w_paths and g_groups == w_groups and w_groups
    _res, _ph, n_groups, fallback = agg_profile.profiled(ix, reqs, dev)
    assert n_groups == len(w_groups) and fallback == 1
    for g, w in zip(got, want):
        assert g.total == w.total and g.rows == w.rows


# ---------------------------------------------------------- micro-benches
def test_intersect_micro_windows_against_jax():
    """The script's `make_windows` at B = 8 (its smallest window pair)
    gives the port's arrays; the JAX `intersect_batch` and the port's
    plain version agree on them at k = 16 and 1, and the port's `main`
    holds B1's wrapper against `intersect_plain` there."""
    make = _nested("intersect_micro", "main", "make_windows",
                   np=np, jnp=jnp, rng=np.random.default_rng(0), BLK=128,
                   n_docs=1_000_000)
    Wp, Wm = 2048, 8192
    ref = [np.asarray(a) for a in make(8, Wp, Wm)]
    port = intersect_micro.make_windows(np.random.default_rng(0), 8, Wp, Wm)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(r, p)
    for k in (16, 1):
        kw = dict(T=2, Ws=(Wp, Wm), groups=intersect_micro.GROUPS,
                  pivot_g=0, k=k)
        xd, xs, xc = (np.asarray(a) for a in JIK.intersect_batch(
            *[jnp.asarray(a) for a in port], **kw))
        td, ts, tc = (o.numpy() for o in TIK.intersect_batch(
            *[torch.from_numpy(a) for a in port], **kw))
        np.testing.assert_array_equal(tc, xc)
        assert tc.sum() > 0
        live = xs[:, :k] > -3.3e38
        np.testing.assert_array_equal(ts[:, :k] > -3.3e38, live)
        np.testing.assert_array_equal(td[:, :k][live], xd[:, :k][live])
        np.testing.assert_allclose(ts[:, :k][live], xs[:, :k][live],
                                   rtol=1e-6, atol=0)
    res = intersect_micro.main(["--batch", "8", "--point", "2048,8192",
                                "--device", "cpu"])
    assert [(p["k"], p["bad"], p["device_us_q"]) for p in res["points"]] \
        == [(16, 0, None), (1, 0, None)]


@pytest.mark.parametrize("shape", [(2048, 2048, 0.5, 2),
                                   (2048, 2048, 0.5, 4)],
                         ids=["tf2", "tf4"])
def test_phrase_ab_windows_against_jax(shape):
    """The script's `build` at B = 8 gives the port's arrays; on them
    the JAX `phrase_batch` (its XLA version) and the port's
    `phrase_plain` agree (top-k lane for lane, scores bit for bit; raw
    lanes merged by `iter_topk`), and so do the matched and2's."""
    build = _nested("phrase_ab", "main", "build", np=np, jnp=jnp,
                    rng=np.random.default_rng(0), BLK=128, B=8,
                    n_docs=1_000_000, stride=64)
    *ref, Ws, PWs = build(*shape)
    port, pWs, pPWs = phrase_ab.build(np.random.default_rng(0), *shape, B=8)
    assert (Ws, PWs) == (pWs, pPWs)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p)
    kw = dict(T=2, Ws=Ws, PWs=PWs, stride=64, slop=0, k=16)
    xd, xs, xc = (np.asarray(a) for a in JIK.phrase_batch(
        *[jnp.asarray(a) for a in port], **kw))
    targs = [torch.from_numpy(a) for a in port]
    td, ts, tc = (o.numpy() for o in TIK.phrase_batch(*targs, **kw))
    np.testing.assert_array_equal(tc, xc)
    assert tc.sum() > 0
    live = xs > -3.3e38
    np.testing.assert_array_equal(ts > -3.3e38, live)
    np.testing.assert_array_equal(td[live], xd[live])
    np.testing.assert_array_equal(ts.view(np.int32), xs.view(np.int32))
    rd, rsc, rc = TIK.phrase_batch(*targs, raw=True, **kw)
    np.testing.assert_array_equal(rc.numpy(), xc)
    v, sel = TIK.iter_topk(rsc, rd, 16)
    live = live[:, :16]
    np.testing.assert_array_equal(torch.gather(rd, 1, sel).numpy()[live],
                                  xd[:, :16][live])
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  xs[:, :16].view(np.int32))
    meta, fmeta, d, f, m, dl, _pk = port
    ikw = dict(T=2, Ws=Ws, groups=phrase_ab.GROUPS, pivot_g=0, k=16)
    iargs = (np.ascontiguousarray(meta[:, :6]), fmeta, d, f, m, dl)
    xd, xs, xc = (np.asarray(a) for a in JIK.intersect_batch(
        *[jnp.asarray(a) for a in iargs], **ikw))
    td, ts, tc = (o.numpy() for o in TIK.intersect_batch(
        *[torch.from_numpy(a) for a in iargs], **ikw))
    np.testing.assert_array_equal(tc, xc)
    live = xs[:, :16] > -3.3e38
    np.testing.assert_array_equal(td[:, :16][live], xd[:, :16][live])
    np.testing.assert_allclose(ts[:, :16][live], xs[:, :16][live],
                               rtol=1e-6, atol=0)


def test_phrase_ab_main_on_the_cpu(capsys):
    res = phrase_ab.main(["--batch", "8", "--shape", "2048,8192,0.5,2",
                          "--device", "cpu"])
    assert _last_json(capsys) == json.loads(json.dumps(res))
    (r,) = res["shapes"]
    assert [r[a]["bad"] for a in ("phrase", "phrase_raw", "and2")] == [0] * 3
    assert r["phrase"]["device_us_q"] is None and "ratio" not in r


# -------------------------------------------------------------- refusals
MODULES = [wire_bench, cold_bench, agg_profile, intersect_micro, phrase_ab]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__.split(
    ".")[-1])
def test_no_card_raises(mod, monkeypatch, capsys):
    """Without `--device cpu` each script wants the card: where there is
    none it raises before it builds anything, and prints nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(W, "wire_corpus", None)
    monkeypatch.setattr(W, "cold_corpus", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    assert capsys.readouterr().out == ""


def test_a_failed_parity_check_prints_no_number(monkeypatch, capsys):
    """A point whose kernel output differs from its plain version raises
    before its record is printed."""
    monkeypatch.setattr(intersect_micro, "compare", lambda a, b: (3, 1.0))
    with pytest.raises(AssertionError, match="3 queries differ"):
        intersect_micro.main(["--batch", "8", "--point", "2048,8192",
                              "--device", "cpu"])
    monkeypatch.setattr(W, "same_keys", lambda *a: (_ for _ in ()).throw(
        AssertionError("wire: key differs")))
    with pytest.raises(AssertionError, match="key differs"):
        wire_bench.main(["--docs", "600", "--conns", "2", "--warm", "1",
                         "--each", "2", "--reps", "1", "--device", "cpu"])
    assert "{" not in capsys.readouterr().out
