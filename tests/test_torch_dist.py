"""Distributed execution (parallel/dist.py) through the port against the JAX package, on the CPU.

Parity file of tests/test_dist.py (tests/torch_parity.py): each case
runs on the JAX package's ShardedIndex over its 8 virtual CPU devices,
then on the port's over 8 CPU slots (`make_mesh(8, device="cpu")`),
must pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly, scores
within rtol 1e-5, atol 1e-6, vector distances within atol 1e-5; profile
times are not compared.  BM25 over shards uses shard-local df and avgdl
in both packages, so the sharded results are held against the JAX
ShardedIndex on the same shards, and against the single index only
where test_dist.py does.

test_dist.py's test_entry_compiles jits the JAX package's `entry()` and
has no counterpart in the port; test_dryrun_entry runs the JAX dry run,
and here `parallel.dryrun.dryrun_multichip(8, device="cpu")` runs the
port's.  The cases after those of test_dist.py are the port's own: the
sharded k-means step against the JAX function, FT.HYBRID's adapter
branch on a ShardedIndex, the merge order of -0.0 and +0.0 sort keys,
`make_mesh` without a card, a shard narrower than the per-shard k, the
builder path of a two-segment index, and a segment moved between
devices.
"""

import numpy as np
import pytest

from tests.torch_parity import parity, per_side, resolve, rs, shard


@pytest.fixture(scope="module")
def sharded(eight_devices):
    return per_side(_sharded_make)


def _sharded_make():
    schema = rs.Schema(name="dist", fields=[
        rs.Field("title", rs.FieldType.TEXT),
        rs.Field("cat", rs.FieldType.TAG, sortable=True),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=8, metric=rs.VectorMetric.L2)),
    ])
    ix = rs.SearchIndex(schema)
    rng = np.random.default_rng(1)
    words = ["apple", "banana", "cherry", "mango", "kiwi"]
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    for i in range(64):
        ix.add_document(f"d{i}", {
            "title": f"{words[i % 5]} {words[(i + 1) % 5]} item",
            "cat": ["a", "b"][i % 2], "n": i, "v": vecs[i]})
    mesh = rs.parallel.dist.make_mesh(8)
    return shard(ix, mesh), ix, vecs


@parity
def test_shard_build(sharded):
    sh, ix, _ = sharded
    assert len(sh.shards) == 8
    assert sum(s.num_alive for s in sh.shards) == 64


@parity
def test_dist_matches_local_text(sharded):
    sh, ix, _ = sharded
    local = ix.search("apple banana", num=20)
    dist = sh.search("apple banana", num=20)
    assert dist.total == local.total
    assert {h.key for h in dist} == {h.key for h in local}


@parity
def test_dist_matches_local_filters(sharded):
    sh, ix, _ = sharded
    local = ix.search("@cat:{a} @n:[10 40]", num=30)
    dist = sh.search("@cat:{a} @n:[10 40]", num=30)
    assert dist.total == local.total
    assert {h.key for h in dist} == {h.key for h in local}


@parity
def test_dist_sortby_numeric(sharded):
    sh, ix, _ = sharded
    dist = sh.search("@cat:{b}", num=5, sort_by="n", sort_asc=True)
    keys = [h.key for h in dist]
    assert keys == ["d1", "d3", "d5", "d7", "d9"]


@parity
def test_dist_knn(sharded):
    sh, ix, vecs = sharded
    q = vecs[33] + 0.01
    local = ix.search("*=>[KNN 5 @v $q]", params={"q": q})
    dist = sh.search("*=>[KNN 5 @v $q]", params={"q": q})
    assert dist.hits[0].key == "d33"
    assert [h.key for h in dist] == [h.key for h in local]


@parity
def test_dist_knn_shard_window_ratio(sharded):
    sh, ix, vecs = sharded
    q = vecs[20] - 0.01
    # ratio 1.0 with 8 shards: each shard returns k candidates, exact
    res = sh.search("*=>[KNN 3 @v $q]", params={"q": q}, shard_k_ratio=1.0)
    assert res.hits[0].key == "d20"


def test_dryrun_multichip_cpu():
    """The port's dry run (test_dist.py's test_dryrun_entry runs the JAX
    package's) over 8 CPU slots: every step equal to the single index."""
    from redisearch_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu")


@parity
def test_dist_sortby_missing_rank_last(eight_devices):
    # missing sort values rank last ACROSS shards too (the 3.0e38
    # sentinel must survive the merge without being dropped)
    ix = rs.SearchIndex(rs.Schema(name="dm", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True)]))
    for i in range(40):
        f = {"t": "x", "n": float(i)} if i % 5 else {"t": "x"}
        ix.add_document(f"d{i}", f)
    ix.commit()
    sh = shard(ix)
    r = sh.search("x", sort_by="n", sort_asc=True, num=40)
    keys = [h.key for h in r.hits]
    assert len(keys) == 40
    assert set(keys[-8:]) == {f"d{i}" for i in range(0, 40, 5)}
    vals = [int(k[1:]) for k in keys[:32]]
    assert vals == sorted(vals)


@parity
def test_dist_string_sortby(sharded):
    sh, ix, _ = sharded
    # TAG field "cat" is sortable; string keys must merge correctly
    res = sh.search("*", num=6, sort_by="cat", sort_asc=True)
    keys = [h.sortkey for h in res]
    assert keys == sorted(keys)


@parity
def test_dist_hybrid(sharded):
    sh, ix, vecs = sharded
    hq = rs.HybridQuery(search="apple", vsim_field="v", vsim_vector=vecs[10],
                        combine="RRF", limit=5)
    rows = sh.hybrid(hq)
    assert rows and rows[0]["__key"] == "d10"


@parity
def test_dist_profile(sharded):
    """Distributed FT.PROFILE: per-shard sections + coordinator section
    (reference: src/coord/dist_profile.c)."""
    sh, ix, _ = sharded
    res, prof = sh.profile("apple", num=5)
    assert prof["coordinator"]["n_shards"] == len(sh.shards)
    assert prof["coordinator"]["results_count"] == res.total
    assert len(prof["shards"]) == len(sh.shards)
    assert sum(s["results_count"] for s in prof["shards"]) >= res.total
    assert "total_time_ms" in prof["coordinator"]


@parity
def test_dist_string_sortby_is_spmd(sharded, monkeypatch):
    """String SORTBY runs through the per-shard-rank path — the
    host-merged fallback must NOT engage."""
    sh, ix, _ = sharded

    def boom(*a, **k):
        raise AssertionError("host-merge fallback used")
    monkeypatch.setattr(resolve(rs.parallel.dist.ShardedIndex),
                        "_search_host_merge", boom)

    for asc in (True, False):
        local = ix.search("*", num=64, sort_by="cat", sort_asc=asc)
        dist = sh.search("*", num=64, sort_by="cat", sort_asc=asc)
        assert dist.total == local.total
        assert [h.sortkey for h in dist.hits] == \
            [h.sortkey for h in local.hits]
        # within equal sort keys order may differ only among ties
        assert sorted(h.key for h in dist.hits) == \
            sorted(h.key for h in local.hits)


@parity
def test_dist_hybrid_is_spmd(sharded, monkeypatch):
    """Distributed FT.HYBRID fans both branches out through the
    distributed execute path, not a single-device view."""
    sh, ix, vecs = sharded
    D = resolve(rs.parallel.dist)

    calls = {"n": 0}
    orig = D.ShardedIndex.execute

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)
    monkeypatch.setattr(D.ShardedIndex, "execute", counting)

    hq = rs.HybridQuery(search="apple", vsim_field="v", vsim_vector=vecs[10],
                        combine="LINEAR", alpha=0.5, beta=0.5, limit=5)
    rows = sh.hybrid(hq)
    assert calls["n"] >= 2          # one distributed execute per branch
    assert rows and rows[0]["__key"] == "d10"   # exact vector match wins


@parity
def test_dcn_mesh_hierarchical_merge(sharded):
    """2D ("dcn" x shards) mesh: per-slice merge first, only k per slice
    crosses the outer axis — results identical to the 1D mesh."""
    sh, ix, vecs = sharded
    mesh2 = rs.parallel.dist.make_mesh(8, n_dcn=2)
    assert mesh2.axis_names == (rs.parallel.dist.DCN_AXIS, "shards")
    sh2 = shard(ix, mesh2)
    for q, kw in [("apple banana", {}),
                  ("@cat:{a} @n:[5 40]", {}),
                  ("*", {"sort_by": "n", "sort_asc": False}),
                  ("*=>[KNN 6 @v $b]", {"params": {"b": vecs[3]}})]:
        r1 = sh.search(q, num=10, **kw)
        r2 = sh2.search(q, num=10, **kw)
        assert r2.total == r1.total, q
        assert [h.key for h in r2.hits] == [h.key for h in r1.hits], q


@parity
def test_dist_profile_per_shard_iterators(sharded):
    """Distributed FT.PROFILE carries measured per-shard iterator
    sections (reference: coord/dist_profile.c shards sections with
    Profile_AddIters counters)."""
    sh, ix, _ = sharded
    res, prof = sh.profile("apple banana", num=5)
    assert prof["coordinator"]["n_shards"] == 8
    assert len(prof["shards"]) == 8
    for i, s in enumerate(prof["shards"]):
        it = s["iterators"]
        assert it is not None
        assert it["counter"] == s["results_count"], i
        assert it["time_ms"] >= 0.0
        assert it.get("children"), i


@parity
def test_dist_batched_search_many_matches_single(sharded):
    """Same-structure batches run as one execute_batch: results must
    equal per-query distributed search and the local index."""
    sh, ix, vecs = sharded
    queries = ["apple banana", "banana cherry", "cherry mango",
               "mango kiwi"]
    batch = sh.search_many(queries, k=20)
    for q, b in zip(queries, batch):
        single = sh.search(q, num=20)
        local = ix.search(q, num=20)
        # batched == per-query distributed search exactly
        assert [h.key for h in b.hits] == [h.key for h in single.hits], q
        np.testing.assert_allclose(
            [h.score for h in b.hits], [h.score for h in single.hits],
            rtol=1e-6)
        # vs local: same match set/total; ordering may differ on ties
        # because shards score with SHARD-LOCAL idf — the reference
        # cluster's semantics
        assert b.total == single.total == local.total, q
        assert {h.key for h in b.hits} == {h.key for h in local.hits}, q
        assert sum(b.shard_counts) == b.total


@parity
def test_dist_batched_mixed_structures_fall_back(sharded):
    """Structurally different queries still return correct results (the
    batch path falls back to per-query execution)."""
    sh, ix, _ = sharded
    queries = ["apple", "apple banana -cherry", "@cat:{a} apple"]
    batch = sh.search_many(queries, k=20)
    for q, b in zip(queries, batch):
        local_all = ix.search(q, num=64)
        assert b.total == local_all.total, q
        assert {h.key for h in b.hits} <= {h.key
                                           for h in local_all.hits}, q
        single = sh.search(q, num=20)
        assert [h.key for h in b.hits] == [h.key for h in single.hits], q


@parity
def test_dist_batched_knn(sharded):
    """Batched KNN across shards: per-shard top-k + merge, batched over
    queries."""
    sh, ix, vecs = sharded
    qs = [f"*=>[KNN 5 @v $b{i}]" for i in range(3)]
    prms = [{f"b{i}": vecs[i * 7].tobytes()} for i in range(3)]
    batch = sh.search_many(qs, params=prms, k=5)
    for i, b in enumerate(batch):
        local = ix.search(qs[i], params=prms[i])
        assert [h.key for h in b.hits] == [h.key for h in local.hits]


@parity
def test_dist_batched_dcn_mesh(sharded):
    """The batched path's hierarchical merge on a 2D (dcn x shards)
    mesh matches the 1D mesh."""
    sh, ix, _ = sharded
    mesh2 = rs.parallel.dist.make_mesh(8, n_dcn=2)
    sh2 = shard(ix, mesh2)
    queries = ["apple banana", "banana cherry"]
    b1 = sh.search_many(queries, k=10)
    b2 = sh2.search_many(queries, k=10)
    for r1, r2 in zip(b1, b2):
        assert [h.key for h in r1.hits] == [h.key for h in r2.hits]
        assert r1.total == r2.total


# ---------------------------------------------------------------- the port's


def test_kmeans_step_sharded_matches_jax(eight_devices):
    """The data-parallel Lloyd step: 8 row shards on 8 CPU slots against
    the JAX function over its 8 virtual devices, centroids within 1e-5
    relative; and equal to the one-device step of the port."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P
    from redisearch_tpu.ops.ivf import kmeans_step_sharded as jstep
    from redisearch_tpu.parallel.dist import make_mesh as jmesh
    from redisearch_tpu_torch.ops.ivf import kmeans_step, \
        kmeans_step_sharded
    from redisearch_tpu_torch.parallel.dist import make_mesh

    rng = np.random.default_rng(5)
    x = rng.normal(size=(8 * 96, 12)).astype(np.float32)
    cents = x[rng.choice(x.shape[0], 16, replace=False)] + 0.01
    jm = jmesh(8)
    want = np.asarray(jstep(jm, jax.device_put(
        jnp.asarray(x), NamedSharding(jm, P("shards"))), jnp.asarray(cents)))
    mesh = make_mesh(8, device="cpu")
    xs = [torch.from_numpy(part) for part in np.split(x, 8)]
    got = kmeans_step_sharded(mesh, xs, torch.from_numpy(cents)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    whole = kmeans_step(torch.from_numpy(x), torch.from_numpy(cents))[0]
    np.testing.assert_allclose(got, whole.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        kmeans_step_sharded(mesh, xs[:4], torch.from_numpy(cents))


@parity
def test_dist_hybrid_adapter_branch(sharded):
    """`run_hybrid_many` on a ShardedIndex (no `segments`) takes the
    hit-list fusion over `search_many`, sync and async, and equals the
    JAX package's rows."""
    sh, ix, vecs = sharded
    hqs = [rs.HybridQuery(search="apple", vsim_field="v",
                          vsim_vector=vecs[10], combine="RRF", limit=5),
           rs.HybridQuery(search="banana cherry", vsim_field="v",
                          vsim_vector=vecs[3], combine="LINEAR", limit=8,
                          search_scorer="DISMAX"),
           rs.HybridQuery(search="kiwi", vsim_field="v",
                          vsim_vector=vecs[40], window=6, limit=4,
                          yield_score_as="fused")]
    rows = rs.aux.hybrid.run_hybrid_many(sh, hqs)
    assert [len(r) for r in rows] == [5, 8, 4]
    assert rows[0][0]["__key"] == "d10"
    assert all("fused" in r for r in rows[2])
    # the handle's class differs by package; its result is the rows
    handle = resolve(rs.aux.hybrid).run_hybrid_many(sh, hqs, async_=True)
    assert handle.result() == rows
    with pytest.raises(resolve(rs.errors.QuerySyntaxError)):
        rs.aux.hybrid.run_hybrid_many(sh, [rs.HybridQuery(search="apple")])


@parity
def test_dist_sortby_signed_zero_order(eight_devices):
    """SORTBY over values that hold both zeros: the merge compares sort
    keys as lax.sort does, which canonicalizes -0.0 to +0.0 first, so
    the zeros tie and fall to the doc id, in both directions (an order
    of the float bit patterns would put every -0.0 first)."""
    ix = rs.SearchIndex(rs.Schema(name="sz", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True)]))
    vals = [0.0, -0.0, 1.0, -1.0]
    for i in range(48):
        ix.add_document(f"d{i}", {"t": "x", "n": vals[i % 4]})
    ix.commit()
    sh = shard(ix)
    for asc in (True, False):
        r = sh.search("x", sort_by="n", sort_asc=asc, num=48)
        got = [(h.sortkey, int(h.key[1:])) for h in r.hits]
        assert got == sorted(got, key=lambda e: (e[0] if asc else -e[0],
                                                 e[1])), asc
        assert len(got) == 48
        zeros = [np.signbit(v) for v, _ in got if v == 0.0]
        assert any(zeros) and not all(zeros)


def test_make_mesh_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without `device`, `make_mesh` raises (no CPU
    fallback); `device="cpu"` gives CPU_SLOTS slots; n_dcn must divide
    the shard count; a CPU index shards over CPU slots by default."""
    import torch
    from redisearch_tpu_torch.parallel import dist as D
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.make_mesh(4, device="cuda")
    m = D.make_mesh(device="cpu")
    assert m.devices.shape == (D.CPU_SLOTS,) and m.axis_names == ("shards",)
    assert all(d == torch.device("cpu") for d in m.slots)
    m2 = D.make_mesh(6, n_dcn=3, device="cpu")
    assert m2.shape == {"dcn": 3, "shards": 2}
    with pytest.raises(ValueError):
        D.make_mesh(6, n_dcn=4, device="cpu")


@parity
def test_dist_shard_narrower_than_k_local(eight_devices):
    """1,031 docs over 8 shards: shard 0 holds 129 docs (256 padded
    lanes), shard 7 holds 128 (128 lanes), so k_local = 256 is wider
    than shard 7; its lanes are padded and every query still equals the
    JAX package's (which pads shard 7's docs, dead, to 256)."""
    ix = rs.SearchIndex(rs.Schema(name="nk", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=4, metric=rs.VectorMetric.L2))]))
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(1031, 4)).astype(np.float32)
    for i in range(1031):
        ix.add_document(f"d{i}", {"t": "x y" if i % 3 else "x",
                                  "n": float(i % 97), "v": vecs[i]})
    ix.commit()
    sh = shard(ix)
    assert [s.n_docs for s in sh.shards] == [129] * 7 + [128]
    r = sh.search("*", num=200)
    assert r.total == 1031 and len(r.hits) == 200
    r = sh.search("x", num=250, sort_by="n", sort_asc=False)
    assert len(r.hits) == 250
    r = sh.search("*=>[KNN 150 @v $b]", params={"b": vecs[7]}, num=150)
    assert r.hits[0].key == "d7" and len(r.hits) == 150
    many = sh.search_many(["x y", "y"], k=200)
    assert [len(m.hits) for m in many] == [200, 200]


@parity
def test_dist_multi_segment_build(eight_devices):
    """An index of two segments shards through the per-shard builders
    (one sealed on each slot's device) and serves as the JAX one does."""
    ix = rs.SearchIndex(rs.Schema(name="ms", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("g", rs.FieldType.TAG, sortable=True),
        rs.Field("n", rs.FieldType.NUMERIC, sortable=True)]))
    words = ["ant", "bee", "cat", "dog"]
    for i in range(40):
        ix.add_document(f"a{i}", {"t": f"{words[i % 4]} {words[i % 3]}",
                                  "g": "pq"[i % 2], "n": float(i)})
    ix.search("ant")                       # seals the first segment
    for i in range(40):
        ix.add_document(f"b{i}", {"t": f"{words[i % 3]} {words[i % 4]}",
                                  "g": "rs"[i % 2], "n": float(-i)})
    ix.delete_document("a3")
    ix.commit()
    assert len(ix.segments) == 2
    sh = shard(ix)
    assert sum(s.n_docs for s in sh.shards) == 79
    for q in ("ant", "bee cat", "@g:{p|s}", "-dog"):
        assert sh.search(q, num=80).total == ix.search(q, num=80).total, q
    sh.search("*", sort_by="n", num=20)
    sh.search("*", sort_by="g", sort_asc=False, num=20)
    sh.search_many(["ant", "cat"], k=10)


def test_segment_to_moves_every_tensor():
    """`segment_to` copies every tensor a segment holds to the target
    device, as a new segment with a fresh uid and empty caches; a
    segment on the target already is returned as it is."""
    import torch
    import redisearch_tpu_torch as rt
    from redisearch_tpu_torch.parallel.dist import segment_to
    ix = rt.SearchIndex(rt.Schema(name="mv", fields=[
        rt.Field("t", rt.FieldType.TEXT),
        rt.Field("g", rt.FieldType.TAG, sortable=True),
        rt.Field("n", rt.FieldType.NUMERIC, sortable=True),
        rt.Field("v", rt.FieldType.VECTOR, vector=rt.VectorParams(dim=4))]),
        device="cpu")
    for i in range(20):
        ix.add_document(f"d{i}", {"t": "x", "g": "ab"[i % 2], "n": i,
                                  "v": np.full(4, i, np.float32)})
    ix.commit()
    seg = ix.segments[0]
    seg.tag_pcodes("g")
    assert segment_to(seg, "cpu") is seg
    moved = segment_to(seg, "meta")
    assert moved.device == torch.device("meta") and moved.uid != seg.uid
    assert moved._pcode_cache == {} and seg._pcode_cache

    def tensors(obj, seen):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, dict):
            for v in obj.values():
                yield from tensors(v, seen)
        elif hasattr(obj, "__dataclass_fields__") and id(obj) not in seen:
            seen.add(id(obj))
            for name in obj.__dataclass_fields__:
                if not name.startswith("_"):         # caches
                    yield from tensors(getattr(obj, name), seen)
    found = list(tensors(moved, set()))
    assert len(found) > 10
    assert all(t.device.type == "meta" for t in found)
    assert len(found) == len(list(tensors(seg, set())))


SLICE_QUERIES = [
    ("alpha beta", {}),
    ('"alpha beta"', {}),
    ("@t:gamma -delta", {}),
    ("@cat:{c1|c3} @x:[5 30]", {}),
    ("ze*", {}),
    ("@g:[0 0 2000 km]", {}),
    ("*=>[KNN 7 @v $b]", {"b": np.zeros(8, np.float32)}),
]


@parity
def test_sharded_build_uses_slice(eight_devices):
    """tests/test_slice.py::test_sharded_build_uses_slice on both
    packages: a one-segment index with TEXT, sortable TAG and NUMERIC,
    GEO and VECTOR fields shards over 4 slots through the CSR slice;
    the shards hold every doc and each query's distributed result is
    the single index's, up to BM25's shard-local stats."""
    ix = rs.SearchIndex(rs.Schema(name="slsrc", fields=[
        rs.Field("t", rs.FieldType.TEXT),
        rs.Field("cat", rs.FieldType.TAG, sortable=True),
        rs.Field("x", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("g", rs.FieldType.GEO),
        rs.Field("v", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=8, metric=rs.VectorMetric.L2)),
    ]))
    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    for i in range(300):
        ix.add_document(f"d{i}", {
            "t": " ".join(rng.choice(words, 6)),
            "cat": f"c{i % 7}",
            "x": float(i % 50),
            "g": f"{rng.uniform(-10,10):.4f},{rng.uniform(-10,10):.4f}",
            "v": rng.normal(size=8).astype(np.float32)})
    ix.commit()
    sh = shard(ix, rs.parallel.dist.make_mesh(4))
    assert len(sh.shards) == 4
    assert sum(s.n_docs for s in sh.shards) == 300
    for q, p in SLICE_QUERIES:
        local = ix.search(q, params=p or None, num=50)
        dist = sh.search(q, params=p or None, num=50)
        assert dist.total == local.total, q
        lk = [h.key for h in local.hits]
        dk = [h.key for h in dist.hits]
        assert set(dk) <= set(lk) or len(dk) == len(lk), q
        if "KNN" in q:
            assert dk == lk, q


def test_ttl_on_a_later_shard_only(eight_devices):
    """A fault on the JAX side: its ShardedIndex runs every shard on the
    program built from shard 0's segment state, so where shard 0 holds
    no TTL doc and shard 1 holds two expired ones, a term query serves
    them (total 16).  The port runs each shard's own program and equals
    the single index and the shards' own views (total 14)."""
    import redisearch_tpu as jrs
    import redisearch_tpu_torch as trs
    from redisearch_tpu.parallel.dist import ShardedIndex as JS
    from redisearch_tpu_torch.parallel.dist import (ShardedIndex as TS,
                                                    _shard_index_view)
    got = {}
    for p, S, kw in ((jrs, JS, {}), (trs, TS, {"device": "cpu"})):
        ix = p.SearchIndex(p.Schema(name="ttl", fields=[
            p.Field("t", p.FieldType.TEXT)]), **kw)
        for i in range(16):
            # already expired: ttl in the past
            ix.add_document(f"d{i}", {"t": "x"},
                            ttl=-5 if i in (1, 9) else None)
        ix.commit()
        sh = S.build(ix)
        assert [s.has_ttl for s in sh.shards] == [False, True] + [False] * 6
        got[p.__name__] = (sh.search("x", num=20), ix.search("x", num=20),
                           sh)
    jd, jl, _ = got["redisearch_tpu"]
    td, tl, tsh = got["redisearch_tpu_torch"]
    assert (jd.total, jl.total) == (16, 14)
    assert {"d1", "d9"} <= {h.key for h in jd.hits}
    assert td.total == tl.total == 14
    assert [h.key for h in td.hits] == [h.key for h in tl.hits]
    assert sum(_shard_index_view(tsh, s).search("x").total
               for s in tsh.shards) == 14
