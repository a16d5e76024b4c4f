"""The torch port runs where jax is absent, and never loads it.

A subprocess imports `redisearch_tpu_torch`, builds a 600-doc index on
the CPU (the smallest corpus whose posting windows reach the kernel's
1024 bucket) with a VECTOR field, serves a `search_many` batch, a batch
of exact and in-order slop phrases (the phrase op), an
`ft_aggregate_many` batch (GROUPBY through the raw intersection and the
group-by op), a single-query `ft_search` and a single `ft_aggregate`
with MIN/MAX (the general window program and the single-query
group-by), a batch of KNN queries with PARAMS blobs (pure and
TAG-filtered), a KNN batch under `torch.profiler` (the spans of
`utils/trace.py`), a single KNN `ft_search` with a bytes blob, an
`ft_hybrid` (text and KNN branches fused by RRF) and an FT.AGGREGATE
WITHCURSOR drained by `ft_cursor_read` (the host pipeline, streaming),
then starts the port's RESP server (`server.Server`) on that client and
sends FT.SEARCH, FT.AGGREGATE, FT.INFO, FT.PROFILE, FT.SUGADD/SUGGET
and FT.CONFIG GET over a socket, then a cold (`storage="host"`) index with a GEO field, an IVF field and
an LVQ8 host-tier field (`ops/ivf.py`, `ops/lvq.py`): a GEO filter, a
batch of IVF queries, a host-tier KNN batch and a cold text batch, then
the index lifecycle: it deletes a third of the first index's documents,
compacts it (`index/slice.py`) and serves a batch, loads a checkpoint
the JAX package wrote in the pytest process (`aux/checkpoint.py`) and
serves a batch from it on the kernels, then the port's distributed dry
run over four CPU slots (`parallel/dryrun.py`: a ShardedIndex's search,
batch, KNN, DISTRIBUTE-step aggregation and hybrid against the single
index, the sharded k-means step, the 2D mesh), and reports which modules
it loaded.  The host modules the port needs are its own
copies: no loaded module's file may lie under `redisearch_tpu/`.  Two
environments: jax, jaxlib and ml_dtypes blocked on `sys.meta_path` (the
card's machine may have none of them), and jax importable (the port must
still not load it).  Neither may load `jax` or any `redisearch_tpu.*`
module.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc, json, sys

if BLOCK:
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"):
                raise ImportError(f"{name} blocked")
            return None
    sys.meta_path.insert(0, Block())

import numpy as np
import redisearch_tpu_torch as rt

SURFACE = tuple("redisearch_tpu_torch." + m for m in (
    "utils.config", "aux.explain", "aux.highlight", "aux.spellcheck",
    "aux.suggest", "server", "native_resp"))

vecs = np.random.default_rng(0).normal(size=(600, 8)).astype(np.float32)
client = rt.Client(device="cpu")
ix = client.ft_create("idx", [rt.Field("t", rt.FieldType.TEXT),
                              rt.Field("c", rt.FieldType.TAG),
                              rt.Field("g", rt.FieldType.TAG, sortable=True),
                              rt.Field("p", rt.FieldType.NUMERIC),
                              rt.Field("v", rt.FieldType.VECTOR,
                                       vector=rt.VectorParams(
                                           dim=8, metric="L2"))])
ix.add_documents([(f"d{i}", {"t": "alpha beta" if i % 2 else "alpha gamma",
                             "c": "x" if i % 3 else "y",
                             "g": f"g{i % 5}", "p": float(i % 13),
                             "v": vecs[i]})
                  for i in range(600)])
res = client.ft_search_many("idx", ["alpha beta", "alpha @c:{y}",
                                    "beta|gamma", "gamma -beta"], k=5)
from redisearch_tpu_torch.query import engine
engine.QUERY_PATH_STATS.clear()
phr = client.ft_search_many("idx", ['"alpha beta"', '"beta alpha"'], k=5)
phr += ix.search_many(["alpha gamma"], k=5, opts_list=[
    rt.QueryOptions(k=5, slop=1, inorder=True)])
phr_paths = dict(engine.QUERY_PATH_STATS)
agg = client.ft_aggregate_many("idx", [
    rt.AggregateRequest(q).group_by("@g", ("COUNT", [], "n"),
                                    ("SUM", ["@p"], "s"))
    .sort_by(("@s", rt.DESC)).limit(0, 3)
    for q in ("alpha beta", "alpha gamma")])
engine.QUERY_PATH_STATS.clear()
win = client.ft_search("idx", "@p:[2 5] -beta", num=5)
win_paths = dict(engine.QUERY_PATH_STATS)
single = client.ft_aggregate("idx", rt.AggregateRequest("*").group_by(
    "@g", ("MIN", ["@p"], "lo"), ("MAX", ["@p"], "hi"),
    ("COUNT", [], "n")).sort_by("@g"))
engine.QUERY_PATH_STATS.clear()
knn = client.ft_search_many("idx", ["*=>[KNN 3 @v $b]",
                                    "(@c:{y})=>[KNN 3 @v $b]"],
                            params=[{"b": vecs[5]}, {"b": vecs[9]}], k=3)
knn_paths = dict(engine.QUERY_PATH_STATS)
import torch
from redisearch_tpu_torch.utils import trace
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    client.ft_search_many("idx", ["(@c:{x})=>[KNN 3 @v $b]"],
                          params=[{"b": vecs[3]}], k=3)
spans = sorted({r.name for r in trace.records()})
knn1 = client.ft_search("idx", "(@p:[0 3])=>[KNN 2 @v $b]",
                        params={"b": vecs[13].tobytes()})
hyb = client.ft_hybrid("idx", rt.HybridQuery(
    search="beta", vsim_field="v", vsim_vector=vecs[7], window=5, limit=3))
cold = rt.Client(device="cpu")
cold.ft_create("cold", [
    rt.Field("t", rt.FieldType.TEXT), rt.Field("loc", rt.FieldType.GEO),
    rt.Field("iv", rt.FieldType.VECTOR, vector=rt.VectorParams(
        dim=8, algo="IVF", nlist=8, nprobe=8, flat_buffer_limit=64)),
    rt.Field("hv", rt.FieldType.VECTOR, vector=rt.VectorParams(
        dim=8, storage="host", compression="LVQ8", nlist=8, nprobe=8))],
    storage="host")
for i in range(600):
    cold.hset(f"d{i}", {"t": "alpha beta" if i % 2 else "alpha gamma",
                        "loc": f"{2 + (i % 50) * 0.01:.2f},48.0",
                        "iv": vecs[i], "hv": vecs[i]})
engine.QUERY_PATH_STATS.clear()
geo = cold.ft_search("cold", "beta @loc:[2.0 48.0 3 km]", num=100)
ivf = cold.ft_search_many("cold", ["*=>[KNN 3 @iv $b]"] * 2,
                          params=[{"b": vecs[5]}, {"b": vecs[9]}], k=3)
host = cold.ft_search_many("cold", ["*=>[KNN 3 @hv $b]"] * 2,
                           params=[{"b": vecs[5]}, {"b": vecs[9]}], k=3)
ctext = cold.ft_search_many("cold", ["beta", "gamma -beta"], k=5)
cold_paths = dict(engine.QUERY_PATH_STATS)
cur = client.ft_aggregate("idx", rt.AggregateRequest("@p:[12 12]")
                          .load("@p").cursor(20))
pages, cid = [cur.rows], cur.cursor_id
while cid:
    rows, cid = client.ft_cursor_read("idx", cid)
    pages.append(rows)
import asyncio
from redisearch_tpu_torch.server import Server


async def wire_session():
    srv = Server(client=client, port=0)
    server = await srv.serve()
    port = server.sockets[0].getsockname()[1]
    r, w = await asyncio.open_connection("127.0.0.1", port)

    async def read():
        line = (await r.readline()).rstrip()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            return {"error": rest.decode()}
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n < 0 else (await r.readexactly(n + 2))[:-2].decode()
        if t == b"*":
            return [await read() for _ in range(int(rest))]
        raise ValueError(line)

    async def cmd(*argv):
        w.write(f"*{len(argv)}\r\n".encode() + b"".join(
            f"${len(str(a).encode())}\r\n{a}\r\n".encode() for a in argv))
        await w.drain()
        return await read()

    out = {
        "search": await cmd("FT.SEARCH", "idx", "alpha beta", "NOCONTENT",
                            "LIMIT", 0, 5),
        "aggregate": await cmd("FT.AGGREGATE", "idx", "alpha beta",
                               "GROUPBY", 1, "@g", "REDUCE", "COUNT", 0,
                               "AS", "n", "SORTBY", 2, "@g", "ASC"),
        "info": await cmd("FT.INFO", "idx"),
        "profile": await cmd("FT.PROFILE", "idx", "SEARCH", "QUERY",
                             "alpha beta", "NOCONTENT", "LIMIT", 0, 3),
        "sugadd": await cmd("FT.SUGADD", "sug", "alphabet", 2),
        "sugget": await cmd("FT.SUGGET", "sug", "alp"),
        "config": await cmd("FT.CONFIG", "GET", "TIMEOUT"),
    }
    out["parser"] = srv.parser
    w.close()
    server.close()
    await server.wait_closed()
    await srv.aclose()
    return out


wire = asyncio.run(wire_session())
engine.QUERY_PATH_STATS.clear()
for i in range(0, 600, 3):
    client.hdel(f"d{i}")
ix.maybe_compact()
life = client.ft_search_many("idx", ["alpha beta", '"alpha beta"'], k=5)
life_paths = dict(engine.QUERY_PATH_STATS)
client.load_index("ck", CKPT)
engine.QUERY_PATH_STATS.clear()
ck = client.ft_search_many("ck", ["alpha beta", "alpha @c:{y}",
                                  '"alpha beta"'], k=5)
ck_paths = dict(engine.QUERY_PATH_STATS)
from redisearch_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(4, device="cpu")
import os
jax_pkg = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(rt.__file__))), "redisearch_tpu") + os.sep
print(json.dumps({
    "totals": [r.total for r in res],
    "keys": [[h.key for h in r.hits] for r in res],
    "phrase": [[r.total, [h.key for h in r.hits]] for r in phr],
    "phrase_paths": phr_paths,
    "agg": [[r.total, r.rows] for r in agg],
    "window": [win.total, [h.key for h in win.hits], win_paths],
    "single": [single.total, single.rows],
    "knn": [[h.key for h in r.hits] for r in knn] + [
        [h.key for h in knn1.hits]],
    "knn_paths": knn_paths,
    "spans": spans,
    "hybrid": [r["__key"] for r in hyb],
    "cursor": [cur.total, [len(p) for p in pages],
               sorted({r["p"] for p in pages for r in p})],
    "cold": [geo.total, [[h.key for h in r.hits] for r in ivf + host],
             [r.total for r in ctext], cold_paths,
             sorted(m for m in sys.modules
                    if m in ("redisearch_tpu_torch.ops.ivf",
                             "redisearch_tpu_torch.ops.lvq"))],
    "lifecycle": [ix.segments[0].n_docs, ix.segments[0].n_deleted,
                  [[r.total, [h.key for h in r.hits]] for r in life],
                  life_paths],
    "checkpoint": [[[r.total, [h.key for h in r.hits]] for r in ck],
                   ck_paths],
    "modules": sorted(m for m in sys.modules
                      if m in ("redisearch_tpu_torch.aux.checkpoint",
                               "redisearch_tpu_torch.index.slice")),
    "surface": sorted(m for m in sys.modules
                      if m in SURFACE),
    "parallel": sorted(m for m in sys.modules
                       if m.startswith("redisearch_tpu_torch.parallel.")),
    "wire": wire,
    "files": sorted(m for m, v in list(sys.modules.items())
                    if (getattr(v, "__file__", None) or "").startswith(
                        jax_pkg)),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                            "redisearch_tpu")),
}))
"""


def _jax_checkpoint(path: str) -> None:
    """A 600-doc index written by the JAX package (in this process)."""
    import numpy as np
    import redisearch_tpu as rs
    from redisearch_tpu.aux import checkpoint
    vecs = np.random.default_rng(1).normal(size=(600, 8)).astype(np.float32)
    ix = rs.SearchIndex(rs.Schema(name="ck", fields=[
        rs.Field("t", rs.FieldType.TEXT), rs.Field("c", rs.FieldType.TAG),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=8, metric="L2"))]))
    ix.add_documents([(f"d{i}", {"t": "alpha beta" if i % 2 else "alpha",
                                 "c": "x" if i % 3 else "y", "v": vecs[i]})
                      for i in range(600)])
    checkpoint.save(ix, path)


@pytest.mark.parametrize("block", [True, False],
                         ids=["jax-blocked", "jax-installed"])
def test_port_serves_without_jax(block, tmp_path):
    ckpt = str(tmp_path / "jax_ck")
    _jax_checkpoint(ckpt)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         f"BLOCK = {block}\nCKPT = {ckpt!r}\n" + SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["totals"] == [300, 200, 600, 300]
    assert out["keys"][0] == ["d1", "d3", "d5", "d7", "d9"]
    assert out["keys"][1] == ["d0", "d3", "d6", "d9", "d12"]
    assert out["keys"][3] == ["d0", "d2", "d4", "d6", "d8"]
    assert out["phrase_paths"] == {"phrase-kernel": 3}
    assert out["phrase"] == [[300, ["d1", "d3", "d5", "d7", "d9"]], [0, []],
                             [300, ["d0", "d2", "d4", "d6", "d8"]]]
    assert out["files"] == [], out["files"]
    # the window program: p in [2, 5] and no "beta" (the even docs)
    want = [i for i in range(0, 600, 2) if 2 <= i % 13 <= 5]
    assert out["window"][0] == len(want)
    # equal scores: the first lanes of the value-sorted numeric window
    assert out["window"][1] == [f"d{i}" for i in want if i % 13 == 2][:5]
    assert out["window"][2] == {}       # single queries count no batch
    # each query vector is a doc's own: that doc comes first
    assert [r[0] for r in out["knn"]] == ["d5", "d9", "d13"]
    assert [len(r) for r in out["knn"]] == [3, 3, 2]
    # a mixed batch is not pure: both queries ride the dense executor
    assert out["knn_paths"] == {"knn-dense": 2}
    # utils/trace.py records a profiled batch's spans (a new string: a
    # compile and a bind)
    assert out["spans"] == sorted(
        ["search", "plan.prepare", "plan.compile", "engine.bind",
         "engine.launch", "engine.wait", "engine.collect", "front.merge"])
    # d7 is first in both branches (an odd doc matches "beta")
    assert out["hybrid"][0] == "d7" and len(out["hybrid"]) == 3
    # the cold index: GEO points 0.01 deg (0.74 km) apart from lon 2.0,
    # so 3 km holds i % 50 <= 4; the odd ones match "beta"
    geo_total, knn_keys, ctext, cold_paths, ops = out["cold"]
    assert geo_total == len([i for i in range(1, 600, 2) if i % 50 <= 4])
    assert [r[0] for r in knn_keys] == ["d5", "d9", "d5", "d9"]
    assert ctext == [300, 300]
    # on a cold segment every query but host-tier KNN is paged ("cold")
    assert cold_paths == {"cold": 4, "knn-host": 2}
    assert ops == ["redisearch_tpu_torch.ops.ivf",
                   "redisearch_tpu_torch.ops.lvq"]
    # deletes of a third of the docs, then the slice compaction: the
    # docs left are the two of every three not deleted
    n_docs, n_deleted, life, life_paths = out["lifecycle"]
    assert (n_docs, n_deleted) == (400, 0)
    assert life == [[200, ["d1", "d5", "d7", "d11", "d13"]],
                    [200, ["d1", "d5", "d7", "d11", "d13"]]]
    assert life_paths == {"window": 2}      # 400 docs: below the kernels
    # the JAX package's checkpoint, loaded and served by the kernels
    ck, ck_paths = out["checkpoint"]
    assert ck == [[300, ["d1", "d3", "d5", "d7", "d9"]],
                  [200, ["d0", "d6", "d12", "d18", "d24"]],
                  [300, ["d1", "d3", "d5", "d7", "d9"]]]
    assert ck_paths == {"kernel": 2, "phrase-kernel": 1}
    assert out["modules"] == ["redisearch_tpu_torch.aux.checkpoint",
                              "redisearch_tpu_torch.index.slice"]
    # the dry run ran to its end (each step asserts against the single
    # index) on the three distribution modules
    assert out["parallel"] == ["redisearch_tpu_torch.parallel." + m
                               for m in ("dist", "dist_agg", "dryrun")]
    assert "dryrun_multichip(4): ok" in proc.stdout
    # the command surface and the wire: the seven modules loaded, each
    # command's reply as the JAX package's server gives it
    assert out["surface"] == sorted(
        "redisearch_tpu_torch." + m for m in (
            "utils.config", "aux.explain", "aux.highlight",
            "aux.spellcheck", "aux.suggest", "server", "native_resp"))
    wire = out["wire"]
    assert wire["parser"] == "native"
    assert wire["search"] == [300, "d1", "d3", "d5", "d7", "d9"]
    assert wire["aggregate"] == [5] + [["g", f"g{j}", "n", "60.0"]
                                       for j in range(5)]
    info = dict(zip(wire["info"][::2], wire["info"][1::2]))
    assert info["index_name"] == "idx" and info["num_docs"] == 600
    res, prof = wire["profile"]
    assert res == [300, "d1", "d3", "d5"]
    prof = dict(zip(prof[::2], prof[1::2]))
    assert prof["results_count"] == 300
    assert {"parsing_time_ms", "iterators"} <= set(prof)
    assert wire["sugadd"] == 1 and wire["sugget"] == ["alphabet"]
    assert wire["config"] == [["TIMEOUT", "500"]]
    n12 = len([i for i in range(600) if i % 13 == 12])
    assert out["cursor"] == [n12, [20, 20, n12 - 40], [12.0]]
    total, rows = out["single"]
    assert total == 600
    assert rows == [{"g": f"g{j}",
                     "lo": float(min(i % 13 for i in range(j, 600, 5))),
                     "hi": float(max(i % 13 for i in range(j, 600, 5))),
                     "n": 120.0} for j in range(5)]
    for (total, rows), odd in zip(out["agg"], (1, 0)):
        docs = [i for i in range(600) if i % 2 == odd]
        want = {}
        for i in docs:
            n, s = want.get(f"g{i % 5}", (0.0, 0.0))
            want[f"g{i % 5}"] = (n + 1, s + i % 13)
        top = sorted(want.items(), key=lambda kv: -kv[1][1])[:3]
        assert total == len(docs)
        assert rows == [{"g": g, "n": n, "s": s} for g, (n, s) in top]


#: the counterparts of the other `benchmarks/` scripts
NEW_SCRIPTS = ["wire_bench", "cold_bench", "device_smoke", "agg_profile",
               "intersect_micro", "phrase_ab"]

PROBES_SCRIPT = r"""
import importlib.abc, json, os, sys

if BLOCK:
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"):
                raise ImportError(f"{name} blocked")
            return None
    sys.meta_path.insert(0, Block())

from redisearch_tpu_torch.bench import probes as P
mods = [importlib.import_module("redisearch_tpu_torch.bench." + m)
        for m in list(P.SCRIPTS.values()) + ["run", "workloads"] + NEW]
res = P.main(["gstep2"], device="cpu")
repo = os.path.dirname(os.path.dirname(os.path.abspath(P.__file__)))
repo = os.path.dirname(repo)
dirs = [os.path.join(repo, d) + os.sep for d in ("redisearch_tpu",
                                                  "benchmarks")]
print(json.dumps({
    "scripts": sorted(m.__name__ for m in mods),
    "bad": [r["bad"] for r in res],
    "files": sorted(m for m, v in list(sys.modules.items())
                    if (getattr(v, "__file__", None) or "").startswith(
                        tuple(dirs))),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                            "redisearch_tpu", "benchmarks",
                                            "bench")),
}))
"""


@pytest.mark.parametrize("block", [True, False],
                         ids=["jax-blocked", "jax-installed"])
def test_probes_load_without_jax(block):
    """`bench/probes.py`, the four probe scripts, the bench runner
    (`bench/run.py`, `bench/workloads.py`) and the counterparts of the
    other `benchmarks/` scripts (`NEW_SCRIPTS`) load (and gstep2's plain
    versions run) without jax, and load no module file under
    `redisearch_tpu/` or `benchmarks/` (nor bench.py): the port keeps its
    own copies of the TPU scripts' and bench.py's constants."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         f"BLOCK = {block}\nNEW = {NEW_SCRIPTS!r}\n" + PROBES_SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["scripts"] == sorted(
        "redisearch_tpu_torch.bench." + m for m in (
            "gstep_probe", "gstep_probe2", "kernel_probe",
            "grid_floor_probe", "run", "workloads", *NEW_SCRIPTS))
    assert out["bad"] == [0, 0]
    assert out["files"] == [], out["files"]
    assert out["loaded"] == [], out["loaded"]
