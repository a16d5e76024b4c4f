"""bench.py's data and query families, and the checks that hold served
results against their plain recomputation: shared by the port's bench
(`bench/run.py`) and `chip_smoke.py`, so both draw the same data from
the same seed.

Every corpus is synthetic and seeded:
* the FTSB enwiki-abstract shape (`make_corpus`, `bm25_fields`, the
  eight FT.SEARCH `FAMILIES`, the FT.AGGREGATE requests);
* the arxiv-shaped filtered-KNN corpus (`fknn_corpus`, `fknn_families`)
  and the FT.HYBRID queries over it (`hybrid_queries`);
* the glove-100-shaped clustered ANN corpus (`ann_corpus`, `ann_truth`,
  `recall_of`).

The checks: `plain_versions` swaps each kernel for its plain torch
version within a block, `plain_results` recomputes FT.SEARCH results so,
`check_against_plain` compares them, `check_fknn` holds filtered KNN
against exact float64 distances on the results' device,
`same_knn_hits` and `same_fusion` compare two KNN and two FT.HYBRID
results.

The wire and cold benches' data (`wire_corpus`, `wire_cmds`,
`cold_corpus`, `cold_queries`: benchmarks/wire_bench.py's and
cold_bench.py's draws), the RESP client that the wire section and
`chip_smoke.py` phase 13 share (`WireConn`, `wire_pass`, `wire_run`,
`start_server`), `same_keys` (a wire reply against a served result),
and what the kernel records count: `intersect_bytes` and
`phrase_bytes` (the bytes a batch needs B1 and B2 to move) and
`device_busy_us` (a torch.profiler trace's busy device time).  The
bench scripts' common steps: `open_device` (the card or, for tests, the
CPU), `pipelined` (bench.py's serving loop), `spread`, `route_delta`,
`log` (stderr) and `emit` (the record as the last stdout line).
"""

from __future__ import annotations

import asyncio
import json
import statistics
import sys
import time

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.bench.probes import card_line, resolve_device
from redisearch_tpu_torch.ops import groupby as GB
from redisearch_tpu_torch.ops import intersect as IK
from redisearch_tpu_torch.query import engine as E

def log(*a):
    """A progress line, on stderr (stdout ends with the JSON record)."""
    print("bench:", *a, file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spread(samples) -> dict:
    return {"median": statistics.median(samples), "min": min(samples),
            "max": max(samples), "n": len(samples)}


def device_entry(dev) -> dict:
    """The device a record was taken on: the card with nvidia-smi's name
    and power limit, or {"platform": "cpu"} (the tests' runs: no number
    taken there is a device number)."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def pipelined(submit, make, n: int, dev, depth: int = 2):
    """bench.py's serving loop: submit batch `it`, build batch it + 1
    while the card runs it, collect `depth` behind (bench.py: 2; the
    `benchmarks/` decompositions: 1).  Returns (seconds, the results of
    batch 0)."""
    t0 = time.perf_counter()
    pending, first = [], []
    nxt = make(0)
    for it in range(n):
        pending.append(submit(nxt))
        if it + 1 < n:
            nxt = make(it + 1)
        if len(pending) > depth:
            r = pending.pop(0).result()
            first = first or [r]
    for h in pending:
        r = h.result()
        first = first or [r]
    sync(dev)
    return time.perf_counter() - t0, first[0]


def emit(out: dict, dev) -> dict:
    """Print a bench script's record, with its `device` and without its
    `served` results, as the last stdout line; return it whole."""
    out["device"] = device_entry(dev)
    print(json.dumps({k: v for k, v in out.items() if k != "served"}),
          flush=True)
    return out


def route_delta(before: dict, after: dict) -> dict:
    """The path counts (`QUERY_PATH_STATS`, `AGG_PATH_STATS`) added since
    `before`."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def open_device(device=None) -> torch.device:
    """The bench scripts' device: `cuda:0` unless the caller names one
    (no card raises, `probes.resolve_device`); on the card, nvidia-smi's
    name and power limit are printed first."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        print(f"card: {card_line()}", flush=True)
    return dev


#: FT.SEARCH's k
K = 10
#: served BM25 scores against their plain recomputation, relative
SCORE_RTOL = 1e-6

# bench.py's eight families (bench_bm25): query i of round `it`; phrase
# rides the phrase kernel, the other seven the intersection kernel
FAMILIES = {
    "and2": lambda qt, i, it=0:
        f"{qt[(2*i+it) % 500]} {qt[(2*i+it+1) % 500]}",
    "phrase": lambda qt, i, it=0:
        f'"{qt[(2*i+it) % 500]} {qt[(2*i+it+1) % 500]}"',
    "and2_tag": lambda qt, i, it=0:
        (f"{qt[(2*i+it) % 500]} {qt[(2*i+it+1) % 500]} "
         f"@cat:{{cat{(i + it) % 16:02d}}}"),
    "and3": lambda qt, i, it=0:
        (f"{qt[(3*i+it) % 500]} {qt[(3*i+it+1) % 500]} "
         f"{qt[(3*i+it+2) % 500]}"),
    "or2": lambda qt, i, it=0:
        f"{qt[(2*i+it) % 500]}|{qt[(2*i+it+1) % 500]}",
    "not2": lambda qt, i, it=0:
        f"{qt[(2*i+it) % 500]} -{qt[(2*i+it+1) % 500]}",
    "opt2": lambda qt, i, it=0:
        f"{qt[(2*i+it) % 500]} ~{qt[(2*i+it+1) % 500]}",
    "fields2": lambda qt, i, it=0:
        f"@title:{qt[(2*i+it) % 500]} @body:{qt[(2*i+it+1) % 500]}",
}
#: bench.py's headline families (more rounds and repeats there)
HEADLINE = ("and2", "phrase", "and2_tag")


def make_corpus(n_docs: int, seed: int = 0):
    """bench.py's corpus: 4+20 zipf(1.25) tokens over a 200k vocab.
    Returns (docs, query terms, token ids int32 [n_docs, 24]: title
    then body)."""
    rng = np.random.default_rng(seed)
    vocab = 200_000
    words = np.array(["w%06d" % i for i in range(vocab)])
    zipf = np.clip(rng.zipf(1.25, size=(n_docs, 24)) - 1, 0, vocab - 1)
    cats = ["cat%02d" % i for i in range(16)]
    cat2 = ["g%04d" % i for i in range(1000)]
    price = rng.integers(1, 10_000, n_docs).tolist()
    # built from Python lists: a numpy index a doc costs twice the time
    wl = words.tolist()
    docs = [(f"d{i}", {"title": " ".join([wl[j] for j in row[:4]]),
                       "body": " ".join([wl[j] for j in row[4:]]),
                       "cat": cats[i % 16],
                       "grp": cat2[i % 1000],
                       "price": float(price[i])})
            for i, row in enumerate(zipf.tolist())]
    qt = ["w%06d" % i for i in rng.integers(20, 5000, size=512)]
    return docs, qt, zipf.astype(np.int32)


def bm25_fields():
    F, T = rt.Field, rt.FieldType
    return [F("title", T.TEXT, weight=2.0), F("body", T.TEXT),
            F("cat", T.TAG), F("grp", T.TAG, sortable=True),
            F("price", T.NUMERIC, sortable=True)]


def agg_request_fn():
    """bench.py's FT.AGGREGATE request (bench_agg): 2-term text match
    with terms drawn from ranks 20..2000 -> GROUPBY @grp (1,000 values)
    COUNT / SUM / AVG(@price) -> SORTBY @s DESC -> LIMIT 0 10."""
    rng = np.random.default_rng(3)
    qt = ["w%06d" % i for i in rng.integers(20, 2000, size=256)]

    def query(i):
        return f"{qt[(2 * i) % 256]} {qt[(2 * i + 1) % 256]}"

    def mk(i):
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("SUM", ["@price"], "s"),
                          ("AVG", ["@price"], "a"))
                .sort_by(("@s", rt.DESC)).limit(0, 10))

    def mk_sd(i):
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("STDDEV", ["@price"], "sd"),
                          ("AVG", ["@price"], "a"))
                .sort_by("@grp"))

    def mk_mm(i):
        """bench_agg with MIN and MAX of the price added."""
        return (rt.AggregateRequest(query(i))
                .group_by("@grp", ("COUNT", [], "n"),
                          ("SUM", ["@price"], "s"),
                          ("AVG", ["@price"], "a"),
                          ("MIN", ["@price"], "lo"),
                          ("MAX", ["@price"], "hi"))
                .sort_by(("@s", rt.DESC)).limit(0, 10))
    return mk, mk_sd, mk_mm


def star_request(now: int):
    """bench.py's bench_agg_star request: '*' -> GROUPBY @grp -> COUNT /
    SUM(@price) -> SORTBY @s DESC -> LIMIT 0 10 over all 1M rows; the TTL
    clock varies per request, as bench.py varies it."""
    return (rt.AggregateRequest("*", now=now)
            .group_by("@grp", ("COUNT", [], "n"), ("SUM", ["@price"], "s"))
            .sort_by(("@s", rt.DESC)).limit(0, 10))


class plain_versions:
    """Within the block the engine's and the pipeline's ops run their
    plain torch versions (for the recomputation the kernels are held
    against)."""

    def __enter__(self):
        self.saved = (IK.intersect_batch, IK.phrase_batch,
                      GB.groupby_aggregate_batch, GB.groupby_aggregate_multi)
        IK.intersect_batch = IK.intersect_plain
        IK.phrase_batch = IK.phrase_plain
        GB.groupby_aggregate_batch = GB.groupby_plain
        GB.groupby_aggregate_multi = GB.groupby_aggregate_multi_plain

    def __exit__(self, *exc):
        (IK.intersect_batch, IK.phrase_batch, GB.groupby_aggregate_batch,
         GB.groupby_aggregate_multi) = self.saved


def plain_results(ix, seg, queries, opts=None):
    """The engine's results for `queries` with each kernel's plain
    version in its place (`plain_versions`): ([SegmentResult], the size
    of the largest group)."""
    cqs = [ix.prepare(q, None, opts or E.QueryOptions(k=K), 2)
           for q in queries]
    largest = max(len(s[0]) for s in E._prep_subs(cqs, seg, K))
    with plain_versions():
        return E.execute_batch(cqs, seg, K), largest


def check_against_plain(kres, pres, what):
    """Served results against their plain recomputation: counts and the
    live lanes' docs equal, scores within SCORE_RTOL.  Returns the max
    abs score difference."""
    err = 0.0
    for i, (kr, pr) in enumerate(zip(kres, pres)):
        live = pr.scores > -3.3e38
        if kr.count != pr.count or not np.array_equal(
                kr.local_idx[live], pr.local_idx[live]) or not np.array_equal(
                kr.scores <= -3.3e38, ~live):
            raise AssertionError(f"{what} query {i}: kernel {kr.count} "
                                 f"{kr.local_idx} vs plain {pr.count} "
                                 f"{pr.local_idx}")
        np.testing.assert_allclose(kr.scores[live], pr.scores[live],
                                   rtol=SCORE_RTOL, atol=0,
                                   err_msg=f"{what} query {i}")
        if live.any():
            err = max(err, float(np.abs(kr.scores[live]
                                        - pr.scores[live]).max()))
    return err


#: bench.py's filtered-KNN section: 500k x 384 unit vectors, COSINE,
#: KNN 25
FKNN_N, FKNN_D, FKNN_K = 500_000, 384, 25
FKNN_WORDS = ["algebra", "graph", "neural", "quantum", "protein", "market",
              "vision", "speech", "logic", "random"]


def fknn_corpus(n: int, dim: int, seed: int = 0):
    """bench.py's arxiv-shaped filtered-KNN corpus (bench_filtered_knn):
    titles of 3 of 10 words, year 1990 + i % 35, cat c{i % 20}, unit
    normal vectors, from `seed`, drawn in bulk; and 512 query vectors."""
    rng = np.random.default_rng(seed)
    words = np.array(FKNN_WORDS)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    tidx = rng.integers(0, 10, size=(n, 3))
    titles = [" ".join(t) for t in words[tidx]]
    docs = [(f"p{i}", {"title": titles[i], "year": int(1990 + i % 35),
                       "cat": f"c{i % 20}", "emb": vecs[i]})
            for i in range(n)]
    qvecs = rng.normal(size=(512, dim)).astype(np.float32)
    return docs, vecs, tidx, qvecs


def fknn_fields(dim: int):
    F, T = rt.Field, rt.FieldType
    return [F("title", T.TEXT), F("year", T.NUMERIC, sortable=True),
            F("cat", T.TAG),
            F("emb", T.VECTOR, vector=rt.VectorParams(dim=dim,
                                                      metric="COSINE"))]


def fknn_families():
    """(query fn, route, host filter fn) per family: bench.py's fulltext,
    numeric and tag families, pure KNN, and a check-only narrow family.
    At 500k docs every leaf of the narrow family has a 32,768-lane
    window, which the planner sends to BATCHES; HYBRID_POLICY ADHOC_BF
    keeps it on the knn-row executor."""
    W = FKNN_WORDS
    return {
        "fulltext": (lambda i: f"(@title:{W[i % 10]})"
                     "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-batches",
                     lambda i, tidx, year, cat: (tidx == i % 10).any(1)),
        "numeric": (lambda i: f"(@year:[{1990 + i % 30} {1995 + i % 30}])"
                    "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-dense",
                    lambda i, tidx, year, cat: (year >= 1990 + i % 30)
                    & (year <= 1995 + i % 30)),
        "tag": (lambda i: f"(@cat:{{c{i % 20}}})"
                "=>[KNN 25 @emb $b EF_RUNTIME 64]", "knn-dense",
                lambda i, tidx, year, cat: cat == i % 20),
        "pure": (lambda i: "*=>[KNN 25 @emb $b]", "knn-pure",
                 lambda i, tidx, year, cat: np.ones(len(year), bool)),
        "narrow": (lambda i: f"(@title:{W[i % 10]} "
                   f"@year:[{1990 + i % 35} {1990 + i % 35}])"
                   "=>[KNN 25 @emb $b HYBRID_POLICY ADHOC_BF]", "knn-row",
                   lambda i, tidx, year, cat: (tidx == i % 10).any(1)
                   & (year == 1990 + i % 35)),
    }


def check_fknn(res, qs, qvecs, v64, ffn, what, rows=None) -> float:
    """Every hit passes its filter, each distance within 1e-5 of its
    float64 value, and recall@25 of the batch against an exact float64
    top-25 over the filter's docs, computed on v64's device.  Query r of
    the batch (or of `rows`, the ones to check) has the query vector
    qvecs[r % 512].  The filters are evaluated on the host from the
    corpus's own arrays, once per query string.  Returns the recall."""
    masks_by_q: dict = {}

    def fmask(r):
        m = masks_by_q.get(qs[r])
        if m is None:
            m = masks_by_q[qs[r]] = ffn(r)
        return m

    rows = list(range(len(res)) if rows is None else rows)
    hit_sum = live_sum = 0
    for c0 in range(0, len(rows), 256):
        chunk = rows[c0:c0 + 256]
        q = torch.from_numpy(qvecs[[r % 512 for r in chunk]]).to(
            v64.device).double()
        qn = q / q.norm(dim=1, keepdim=True)
        d64 = 1.0 - qn @ v64.t()                       # unit rows
        masks = torch.from_numpy(np.stack([fmask(r) for r in chunk])).to(
            v64.device)
        d64 = torch.where(masks, d64, float("inf"))
        n_valid = masks.sum(1)
        truth = torch.topk(d64, FKNN_K, dim=1, largest=False).indices.cpu()
        d64 = d64.cpu().numpy()
        for j, r in enumerate(chunk):
            keys = [int(h.key[1:]) for h in res[r].hits]
            m = fmask(r)
            if not all(m[i] for i in keys):
                raise AssertionError(f"{what}: query {r} returned a doc "
                                     "that fails its filter")
            got = np.array([h.vector_distance for h in res[r].hits])
            err = np.abs(got - d64[j, keys]).max() if keys else 0.0
            if not err <= 1e-5:
                raise AssertionError(f"{what}: query {r} distance error "
                                     f"{err}")
            want = set(truth[j, :min(FKNN_K, int(n_valid[j]))].tolist())
            hit_sum += len(set(keys) & want)
            live_sum += len(want)
    return hit_sum / max(live_sum, 1)


def same_knn_hits(a, b, what, tol=1e-5):
    """Two KNN results agree: as many hits, distances within tol lane
    for lane, and equal keys wherever neighbouring distances differ by
    more than tol.  (Totals differ by design: a pure KNN batch counts
    every live vector, a single search at most k, in both packages.)"""
    if len(a.hits) != len(b.hits):
        raise AssertionError(f"{what}: hits {len(a.hits)} / "
                             f"{len(b.hits)}")
    da = np.array([h.vector_distance for h in a.hits])
    db = np.array([h.vector_distance for h in b.hits])
    if len(da) and not np.abs(da - db).max() <= tol:
        raise AssertionError(f"{what}: distances differ")
    for j in range(len(da)):
        near = ((j > 0 and da[j] - da[j - 1] <= tol)
                or (j + 1 < len(da) and da[j + 1] - da[j] <= tol))
        if not near and a.hits[j].key != b.hits[j].key:
            raise AssertionError(f"{what}: lane {j} key differs")


#: bench.py's bench_hybrid: batch 1024, window 20, limit 10, 4 rounds
HYB_B, HYB_W, HYB_LIMIT, HYB_ROUNDS = 1024, 20, 10, 4


def hybrid_queries(it: int, combine: str, B: int = HYB_B) -> list:
    """bench.py's bench_hybrid round `it`: a single title word and one of
    512 query vectors (seed 5) per query."""
    qvecs = np.random.default_rng(5).normal(size=(512, FKNN_D)).astype(
        np.float32)
    return [rt.HybridQuery(
        search=FKNN_WORDS[(it * B + i) % 10], vsim_field="emb",
        vsim_vector=qvecs[(it * B + i) % 512], combine=combine,
        window=HYB_W, limit=HYB_LIMIT) for i in range(B)]


def same_fusion(a, b, what):
    """Two fused row lists: equal keys, order and fields, floats within
    1e-6 (the vectorized fusion takes 1/(1+dist) in f32, the hit-list
    fusion in Python floats)."""
    if [r["__key"] for r in a] != [r["__key"] for r in b]:
        raise AssertionError(f"{what}: keys differ")
    for ra, rb in zip(a, b):
        if list(ra) != list(rb):
            raise AssertionError(f"{what}: fields differ")
        for k, v in rb.items():
            if isinstance(v, float) and not abs(ra[k] - v) <= 1e-6:
                raise AssertionError(f"{what}: {k} {ra[k]} vs {v}")


#: bench.py's ann section (bench_ann): 1M x 100 clustered COSINE, nlist
#: 1024, 256 queries x 4 reps, k 10, nprobe 8 / 32 / 128
ANN_N, ANN_D, ANN_NLIST, ANN_K = 1_000_000, 100, 1024, 10
ANN_Q, ANN_REPS = 256, 4
ANN_NPROBES = (8, 32, 128)


def ann_corpus(n: int = ANN_N, n_queries: int = ANN_Q):
    """bench.py's bench_ann corpus and queries (seed 7): 256 centers,
    each vector a center plus 0.3 noise; queries [ANN_REPS, n_queries,
    d]."""
    rng = np.random.default_rng(7)
    d, nq = ANN_D, n_queries * ANN_REPS
    centers = rng.normal(size=(256, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 256, size=n)]
            + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, 256, size=nq)]
               + 0.3 * rng.normal(size=(nq, d))).astype(np.float32)
    return vecs, queries.reshape(ANN_REPS, n_queries, d)


def ann_truth(vecs_dev, q0):
    """Exact float64 cosine top-k of the first rep's queries, on the
    vectors' device."""
    v64 = vecs_dev.double()
    v64 = v64 / v64.norm(dim=1, keepdim=True).clamp(min=1e-30)
    q = torch.from_numpy(q0).to(vecs_dev.device).double()
    q = q / q.norm(dim=1, keepdim=True)
    truth = torch.topk(q @ v64.t(), ANN_K, dim=1).indices.cpu().numpy()
    del v64
    return [set(t.tolist()) for t in truth]


def recall_of(ids, truth) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i].tolist()) & truth[i]) / ANN_K
                          for i in range(len(truth))]))


# ------------------------------------------------------------------ wire
#: benchmarks/wire_bench.py's shape: 200,000 docs of a 4-word `t` and an
#: 8-word `b` over a 5,000-word vocabulary, 32 connections, a warm pass
#: of 20 queries a connection, then timed passes of 60
WIRE_N, WIRE_VOCAB, WIRE_CONNS, WIRE_WARM, WIRE_EACH = (200_000, 5000, 32,
                                                        20, 60)


def wire_corpus(n: int):
    """wire_bench.py's docs (seed 0, drawn doc by doc as the script draws
    them) and its vocabulary."""
    rng = np.random.default_rng(0)
    words = ["w%05d" % i for i in range(WIRE_VOCAB)]
    docs = [(f"d{i}", {"t": " ".join(words[j] for j in
                                     rng.integers(0, WIRE_VOCAB, 4)),
                       "b": " ".join(words[j] for j in
                                     rng.integers(0, WIRE_VOCAB, 8))})
            for i in range(n)]
    return docs, words


def wire_cmds(words, n_conns: int, n_each: int, start: int = 0) -> list:
    """wire_bench.py's FT.SEARCH of connection `idx`'s query i, for i in
    [start, start + n_each), in `wire_pass` order (command
    (i - start) * n_conns + idx on connection idx)."""
    return [("FT.SEARCH", "bench",
             f"{words[(idx * 37 + i * 11) % 4000]} "
             f"{words[(idx * 53 + i * 7 + 1) % 4000]}",
             "NOCONTENT", "DIALECT", "2")
            for i in range(start, start + n_each) for idx in range(n_conns)]


#: scores closer than this (relative) count as tied in `same_keys`
TIE_RTOL = 1e-5


def same_keys(reply, res, what, wide=None) -> bool:
    """A NOCONTENT FT.SEARCH reply ([total, key, ...]) against a served
    result of the same query: equal totals and hit counts, distinct
    keys, and equal keys lane by lane except within a group of lanes
    whose scores in the result tie within TIE_RTOL (a micro-batch of one
    runs the window program, whose tied scores may order differently
    at the last bit).  There the reply's keys must be the result's keys
    of that group, as a set.  Where the group reaches the result's last
    lane and more docs match than it holds, the tie may go on past it:
    a reply key outside the result must then be a doc of `wide()` (the
    same query served with a larger k) whose score ties the group's.
    Returns whether every key was equal."""
    keys, want = reply[1:], [h.key for h in res.hits]
    if reply[0] != res.total or len(keys) != len(want):
        raise AssertionError(f"{what}: total {reply[0]} with {len(keys)} "
                             f"keys, served {res.total} with {len(want)}")
    if len(set(keys)) != len(keys):
        raise AssertionError(f"{what}: a key repeats in {keys}")
    if keys == want:
        return True
    sc = np.array([h.score for h in res.hits])
    wide_sc = None
    for i in range(len(want)):
        if keys[i] == want[i]:
            continue
        tie = np.flatnonzero(np.abs(sc - sc[i]) <= TIE_RTOL * abs(sc[i]))
        got = {keys[j] for j in tie}
        extra = got - {want[j] for j in tie}
        if not extra:
            continue
        if tie[-1] == len(want) - 1 and res.total > len(want) and wide:
            if wide_sc is None:
                wide_sc = {h.key: h.score for h in wide().hits}
            if all(k in wide_sc and abs(wide_sc[k] - sc[i])
                   <= TIE_RTOL * abs(sc[i]) for k in extra):
                continue
        raise AssertionError(f"{what}: hit {i} {keys[i]} vs {want[i]}: "
                             f"{sorted(extra)} not in the served tie "
                             f"at score {sc[i]}")
    return False


# ------------------------------------------------------------------ cold
#: benchmarks/cold_bench.py's shape: 500,000 docs of one TEXT field of 16
#: zipf(1.25) tokens over a 100k vocabulary; 128 and2 queries and 128
#: exact phrases, k 10, after 32 single warm-up searches
COLD_N, COLD_VOCAB, COLD_K, COLD_WARM = 500_000, 100_000, 10, 32


def cold_corpus(n: int) -> list:
    """cold_bench.py's `build` docs (seed 0)."""
    rng = np.random.default_rng(0)
    words = np.array(["w%06d" % i for i in range(COLD_VOCAB)])
    zipf = np.clip(rng.zipf(1.25, size=(n, 16)) - 1, 0, COLD_VOCAB - 1)
    return [(f"d{i}", {"t": " ".join(words[zipf[i]])}) for i in range(n)]


def cold_queries() -> dict:
    """cold_bench.py's 128 and2 queries and 128 exact phrases (seed 7)."""
    rng = np.random.default_rng(7)
    qt = ["w%06d" % i for i in rng.integers(20, 3000, size=256)]
    pairs = [(qt[2 * i % 250], qt[(2 * i + 1) % 250]) for i in range(128)]
    return {"and2": [f"{a} {b}" for a, b in pairs],
            "phrase": [f'"{a} {b}"' for a, b in pairs]}


# ------------------------------------------------------- the RESP client
class WireConn:
    """A minimal RESP2 client over one asyncio connection."""

    def __init__(self, reader, writer):
        self.r, self.w = reader, writer

    @classmethod
    async def open(cls, port: int):
            return cls(*await asyncio.open_connection("127.0.0.1", port))

    async def cmd(self, *argv):
        out = [f"*{len(argv)}\r\n".encode()]
        for a in argv:
            b = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self.w.write(b"".join(out))
        await self.w.drain()
        return await self.read()

    async def read(self):
        line = (await self.r.readline()).rstrip(b"\r\n")
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise AssertionError(f"wire error reply: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n < 0 else (await self.r.readexactly(n + 2)
                                       )[:-2].decode()
        if t == b"*":
            return [await self.read() for _ in range(int(rest))]
        raise AssertionError(f"bad RESP line {line!r}")


def start_server(client):
    """The port's RESP server on `client`, in this process, with its own
    event loop on a thread.  Returns (server, port, stop)."""
    import threading
    from redisearch_tpu_torch.server import Server
    srv = Server(client=client, port=0)
    loop = asyncio.new_event_loop()
    box, ready = {}, threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box["tcp"] = loop.run_until_complete(srv.serve())
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True, name="wire-server")
    th.start()
    if not ready.wait(60):
        raise AssertionError("wire: the server did not start")

    def stop():
        async def close():
            box["tcp"].close()
            await box["tcp"].wait_closed()
            await srv.aclose()
        asyncio.run_coroutine_threadsafe(close(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
        loop.close()
        srv._pool.shutdown(wait=True)

    return srv, box["tcp"].sockets[0].getsockname()[1], stop


async def wire_pass(conns: list, cmds: list) -> tuple:
    """Send `cmds` over the open connections `conns`, each connection one
    command at a time (command i on connection i % len(conns)).  Returns
    (replies in command order, seconds from the first send to the last
    reply)."""
    replies = [None] * len(cmds)

    async def worker(j):
        for i in range(j, len(cmds), len(conns)):
            replies[i] = await conns[j].cmd(*cmds[i])

    t0 = time.perf_counter()
    await asyncio.gather(*[worker(j) for j in range(len(conns))])
    return replies, time.perf_counter() - t0


async def close_conns(conns: list) -> None:
    for c in conns:
        c.w.close()
        await c.w.wait_closed()


def wire_run(port: int, cmds: list, n_conns: int) -> tuple:
    """`wire_pass` over `n_conns` new connections to a server on another
    thread's event loop (`start_server`), in an event loop of its own."""

    async def go():
        conns = [await WireConn.open(port) for _ in range(n_conns)]
        try:
            return await wire_pass(conns, cmds)
        finally:
            await close_conns(conns)

    return asyncio.run(go())


# ------------------------------------------------- kernel records, traces
def device_busy_us(prof, names=("intersect_kernel", "phrase_kernel")
                   ) -> tuple:
    """(busy us, {name: us}) from a torch.profiler trace: the union of
    the device-side (kernel and memcpy) intervals, and per kernel name
    the sum of its intervals."""
    spans, kern = [], dict.fromkeys(names, 0.0)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            for nm in names:
                if nm in ev.name:
                    kern[nm] += ev.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, kern


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def intersect_bytes(meta, fmeta, T, groups, pivot_g, outs) -> int:
    """Bytes this batch needs the intersection kernel to move: every live
    posting of the pivot slots (doc, freq, mask and doc length), one
    probe of each other slot per pivot posting, at most its live length
    (doc, freq and mask for a text slot, the doc for an aux tag slot),
    the per-query meta and the outputs."""
    srcs = IK._slot_srcs(T, groups)
    lens = meta[:, T:2 * T].to(torch.int64)
    piv = list(groups[pivot_g][1])
    plen = lens[:, piv].sum(1)
    n = 16 * int(plen.sum())
    for t in range(T):
        if t not in piv:
            n += (12 if srcs[t] < 0 else 4) * int(
                torch.minimum(lens[:, t], plen).sum())
    return n + nbytes(meta, fmeta, *outs)


def phrase_bytes(meta, fmeta, T, outs) -> int:
    """Bytes this batch needs the phrase kernel to move: term 0's live
    position keys, one probe of each later term's keys per term-0 key
    (at most its live length), and for the queries that match, term 0's
    postings (16 bytes each) and one probe of each later slot's postings
    per term-0 posting (12 bytes); then the meta and the outputs."""
    pl = meta[:, 4 * T:5 * T].to(torch.int64)
    tl = meta[:, T:2 * T].to(torch.int64)[outs[2] > 0]
    n = 4 * int(pl[:, 0].sum()) + 16 * int(tl[:, 0].sum())
    for t in range(1, T):
        n += 4 * int(torch.minimum(pl[:, t], pl[:, 0]).sum())
        n += 12 * int(torch.minimum(tl[:, t], tl[:, 0]).sum())
    return n + nbytes(meta, fmeta, *outs)
