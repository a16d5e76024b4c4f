"""Distributed dry run of the port: doc-sharded search, batched serving,
KNN, the sharded k-means step, the DISTRIBUTE-step aggregation, hybrid
fusion and the 2D mesh, each held against the single index.

Counterpart of steps 1-4 of `__graft_entry__.dryrun_multichip`, with its
`_toy_index` copied here.  That function re-executes itself in a fresh
process pinned to a virtual CPU mesh, because XLA reads its flags once
a process; a mesh of device slots needs no flags, so this one runs in
the caller's process, on the cards or (`device="cpu"`) on the CPU:

    python -c "from redisearch_tpu_torch.parallel.dryrun import \\
               dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import numpy as np
import torch


def _toy_index(n_docs: int = 256, dim: int = 16, seed: int = 0,
               device=None):
    """Copy of `__graft_entry__._toy_index`, on `device`."""
    import redisearch_tpu_torch as rs

    schema = rs.Schema(name="graft", fields=[
        rs.Field("title", rs.FieldType.TEXT, weight=2.0),
        rs.Field("body", rs.FieldType.TEXT),
        rs.Field("tag", rs.FieldType.TAG, sortable=True),
        rs.Field("price", rs.FieldType.NUMERIC, sortable=True),
        rs.Field("vec", rs.FieldType.VECTOR,
                 vector=rs.VectorParams(dim=dim,
                                        metric=rs.VectorMetric.L2)),
    ])
    ix = rs.SearchIndex(schema, device=device)
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "omega",
             "search", "engine", "vector", "index", "query", "shard"]
    for i in range(n_docs):
        title = " ".join(rng.choice(words, 3))
        body = " ".join(rng.choice(words, 8))
        ix.add_document(f"d{i}", {
            "title": title, "body": body,
            "tag": ["red", "green", "blue"][i % 3],
            "price": float(i % 100),
            "vec": rng.normal(size=dim).astype(np.float32)})
    ix.commit()
    return ix


def dryrun_multichip(n_shards: int, device=None) -> None:
    """Doc-sharded query fan-out with the coordinator's top-k merge, plus
    a data-parallel k-means training step for the IVF vector index, over
    `n_shards` slots of `parallel.dist.make_mesh` (the cards, or the CPU
    with device="cpu").  Raises AssertionError where a distributed result
    differs from the single index's."""
    from ..agg.pipeline import DESC, AggregateRequest, run_aggregate
    from ..aux.hybrid import HybridQuery, run_hybrid
    from ..ops.ivf import kmeans_step_sharded
    from .dist import ShardedIndex, make_mesh

    mesh = make_mesh(n_shards, device=device)
    coord = mesh.slots[0]
    ix = _toy_index(n_docs=max(64 * n_shards, 256), device=coord)
    sharded = ShardedIndex.build(ix, mesh)

    # 1) distributed full-text search (BM25 + tag + numeric filters)
    res = sharded.search("alpha @tag:{red} @price:[0 90]", num=5)
    assert res.total >= 0 and isinstance(res.hits, list)

    # 1b) batched serving: a same-structure batch in one execute_batch
    # must equal per-query execution
    kqs = ["alpha beta", "beta gamma", "alpha beta @tag:{red}",
           "alpha | beta", '"alpha beta"', "alpha -beta"]
    many = sharded.search_many(kqs, k=5)
    for q, r in zip(kqs, many):
        single = sharded.search(q, num=5)
        assert [h.key for h in r.hits] == [h.key for h in single.hits], q

    # 2) distributed KNN
    q = np.zeros(16, np.float32)
    res = sharded.search("*=>[KNN 4 @vec $v]", params={"v": q})
    assert len(res.hits) <= 4

    # 3) sharded k-means training step: each slot's rows on its device,
    # sums and counts summed on the coordinator
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128 * n_shards, 16)).astype(np.float32)
    xs = [torch.as_tensor(part, device=d)
          for part, d in zip(np.split(x, n_shards), mesh.slots)]
    cents = torch.as_tensor(x[:8], device=coord)
    new = kmeans_step_sharded(mesh, xs, cents)
    assert tuple(new.shape) == (8, 16)

    # 3b) distributed aggregation: DISTRIBUTE-step plan splitting with
    # reducer rewrites (AVG -> per-shard SUM+COUNT, coordinator merge —
    # reference analog: src/coord/dist_plan.cpp:480-497), equal to the
    # single-index pipeline on the same docs
    def _agg_req():
        return (AggregateRequest("@tag:{red|green}")
                .group_by("@tag", ("COUNT", [], "n"),
                          ("AVG", ["@price"], "avg"),
                          ("SUM", ["@price"], "s"))
                .sort_by(("@s", DESC)).limit(0, 8))

    dres = sharded.aggregate(_agg_req())
    lres = run_aggregate(ix, _agg_req())

    def _rowkey(row):
        return tuple(sorted(
            (k, round(v, 6) if isinstance(v, float) else v)
            for k, v in row.items()))
    assert [_rowkey(r) for r in dres.rows] == \
        [_rowkey(r) for r in lres.rows], (dres.rows, lres.rows)

    # 3c) hybrid (text + KNN fusion) on the sharded index equals the
    # single index's.  DISMAX (pure term frequency) is the shard-invariant
    # scorer: BM25 uses shard-LOCAL df/avgdl here and on the reference
    # coordinator, so cross-shard text ranks legitimately differ from
    # single-node BM25.
    hq = HybridQuery(search="alpha", vsim_field="vec",
                     vsim_vector=np.zeros(16, np.float32),
                     search_scorer="DISMAX",
                     combine="RRF", window=10, limit=5)
    hd = run_hybrid(sharded, hq)
    hl = run_hybrid(ix, hq)
    assert [h["__key"] for h in hd] == [h["__key"] for h in hl], (hd, hl)

    # 4) multi-slice (dcn x shards) mesh: the hierarchical merge (per
    # slice first, then k per slice across slices) equals the 1D mesh's
    if n_shards >= 4 and n_shards % 2 == 0:
        mesh2 = make_mesh(n_shards, n_dcn=2, device=device)
        sharded2 = ShardedIndex.build(ix, mesh2)
        r2 = sharded2.search("alpha @tag:{red} @price:[0 90]", num=5)
        r1 = sharded.search("alpha @tag:{red} @price:[0 90]", num=5)
        assert [h.key for h in r2.hits] == [h.key for h in r1.hits]
    print(f"dryrun_multichip({n_shards}): ok — dist search total="
          f"{res.total}, dist-agg AVG->SUM+COUNT rewrite parity ok, "
          f"dist hybrid RRF parity ok, kmeans step done, dcn mesh ok")
