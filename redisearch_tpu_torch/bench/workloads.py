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
"""

from __future__ import annotations

import numpy as np
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.ops import groupby as GB
from redisearch_tpu_torch.ops import intersect as IK
from redisearch_tpu_torch.query import engine as E

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
    cats = np.array(["cat%02d" % i for i in range(16)])
    cat2 = np.array(["g%04d" % i for i in range(1000)])
    price = rng.integers(1, 10_000, n_docs)
    docs = [(f"d{i}", {"title": " ".join(words[zipf[i, :4]]),
                       "body": " ".join(words[zipf[i, 4:]]),
                       "cat": cats[i % 16],
                       "grp": cat2[i % 1000],
                       "price": float(price[i])})
            for i in range(n_docs)]
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
