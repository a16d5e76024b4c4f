"""The port's wide-pivot route against the JAX package, on the CPU.

Queries whose pivot window is wider than the JAX kernel's `MAX_W_PIVOT`
(32,768 postings, a bound of the TPU's VMEM) or whose windows exceed
its 12 MB budget: the JAX package serves them on its general window
program, the port on the intersection kernel's wide route
(`_kernel_route`, path "kernel-wide"), whose CPU twin is
`intersect_plain`.  Both packages index one corpus made from a seeded
numpy generator, in which four terms have more than 32,768 postings, and
serve the same batches through `search_many`.  Totals and hit keys must
be equal and in the same order; scores agree to rtol 1e-5 (both sum
f32 BM25 terms, the port pivot first).

One query ties across phases: `xenon|yarrow` over two terms of equal
document frequency whose best documents are short repeats of one term,
all of one score; the window program takes the lowest documents, and
the lowest of all holds the second term, whose phase comes second.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.ops import intersect as TIK
from redisearch_tpu_torch.query import engine as TE

RTOL = 1e-5
NOW = 1_700_000_000
K = 10
N_BOTH, N_ONE, N_TIE = 30_000, 3_000, 100

# the tie query first; the rest as bench.py's families use them
QUERIES = ["xenon|yarrow", "umber violet", "umber -xenon", "umber ~yarrow",
           "umber|violet", "xenon yarrow", "violet|xenon"]


def _corpus():
    """(docs, tie keys of xenon, tie keys of yarrow).  xenon and yarrow
    each sit in N_BOTH + N_ONE + N_TIE / 2 docs (33,050): together in the
    N_BOTH long docs, alone in N_ONE short ones each, and eight times
    alone in N_TIE / 2 "tie" docs each, which outscore the rest and tie
    with each other (the long docs of both score less).  umber and
    violet sit in about 95% and 93% of the non-tie docs, among 40 filler
    words."""
    rng = np.random.default_rng(29)
    fill = np.array(["f%03d" % i for i in range(40)])
    kinds = (["both"] * N_BOTH + ["xenon"] * N_ONE + ["yarrow"] * N_ONE
             + ["tie-xenon"] * (N_TIE // 2) + ["tie-yarrow"] * (N_TIE // 2))
    kinds = np.array(kinds)[rng.permutation(len(kinds))]
    # the lowest tie doc holds yarrow: phase order and doc order disagree
    first = int(np.flatnonzero(np.char.startswith(kinds, "tie"))[0])
    if kinds[first] == "tie-xenon":
        other = int(np.flatnonzero(kinds == "tie-yarrow")[0])
        kinds[first], kinds[other] = kinds[other], kinds[first]
    docs, ties = [], {"xenon": [], "yarrow": []}
    for i, kind in enumerate(kinds):
        key = f"d{i}"
        if kind.startswith("tie-"):
            word = kind[4:]
            ties[word].append(key)
            docs.append((key, {"t": " ".join([word] * 8)}))
            continue
        words = list(rng.choice(fill, int(rng.integers(1, 5))))
        if kind == "both":
            # long enough that their two terms score below a tie doc
            words += ["xenon", "yarrow"] + list(
                rng.choice(fill, int(rng.integers(24, 28))))
        else:
            words.append(str(kind))
        if rng.random() < 0.95:
            words += ["umber"] * int(rng.integers(1, 3))
        if rng.random() < 0.93:
            words.append("violet")
        rng.shuffle(words)
        docs.append((key, {"t": " ".join(words)}))
    return docs, ties


@pytest.fixture(scope="module")
def wide_idx():
    docs, ties = _corpus()
    jix = rs.SearchIndex(rs.Schema(name="w", fields=[
        rs.Field("t", rs.FieldType.TEXT)]))
    tix = rt.SearchIndex(rt.Schema(name="w", fields=[
        rt.Field("t", rt.FieldType.TEXT)]), device="cpu")
    jix.add_documents(docs)
    tix.add_documents(docs)
    return jix, tix, ties


def _opts(pkg, n):
    return [pkg.QueryOptions(k=K, now=NOW, verbatim=True) for _ in range(n)]


def test_corpus_has_wide_terms(wide_idx):
    """Every query term has more than MAX_W_PIVOT postings."""
    _jix, tix, _ties = wide_idx
    seg = tix.segments[0]
    for q in ("xenon", "yarrow", "umber", "violet"):
        cq = tix.prepare(q, None, _opts(rt, 1)[0], 2)
        binding, _P = cq.bind(seg)
        assert int(binding.dyn["tlens"][0]) > TIK.MAX_W_PIVOT, q


def test_jax_planner_refuses_them(wide_idx):
    """The JAX kernel planner refuses every query (its window program
    serves them); the port's narrow plan agrees and its wide plan takes
    them, its pivot at most MAX_W_MEMBER wide."""
    jix, tix, _ties = wide_idx
    jseg, tseg = jix.segments[0], tix.segments[0]
    for q in QUERIES:
        jcq = jix.prepare(q, None, _opts(rs, 1)[0], 2)
        tcq = tix.prepare(q, None, _opts(rt, 1)[0], 2)
        jent, tent = jcq.bind_row(jseg)[1], tcq.bind_row(tseg)[1]
        assert JE._kernel_plan(jcq, jseg, jent[4], 16) is None, q
        assert TE._kernel_plan(tcq, tseg, tent[4], 16) is None, q
        route, plan = TE._kernel_route(tcq, tseg, tent[4], 16)
        assert route == "kernel-wide", q
        Ws, groups, pivot_g = plan[1], plan[2], plan[3]
        assert TIK.MAX_W_PIVOT < max(Ws[j] for j in groups[pivot_g][1]) \
            <= TIK.MAX_W_MEMBER, q


def _served(jix, tix, queries):
    jres = jix.search_many(queries, k=K, opts_list=_opts(rs, len(queries)))
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many(queries, k=K, opts_list=_opts(rt, len(queries)))
    assert TE.QUERY_PATH_STATS == {"kernel-wide": len(queries)}
    return jres, tres


def test_wide_queries_match_the_window_program(wide_idx):
    """or2, and2 with both slots wide, -NOT, ~optional: totals, keys in
    order and scores equal to the JAX package's window program."""
    jix, tix, _ties = wide_idx
    jres, tres = _served(jix, tix, QUERIES)
    for q, j, t in zip(QUERIES, jres, tres):
        assert t.total == j.total > 0, q
        assert len(t.hits) == len(j.hits) == K, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL,
                                   err_msg=q)


def test_tie_across_phases_goes_to_the_lowest_doc(wide_idx):
    """`xenon|yarrow`: its top K all tie; the window program (and the
    wide route) takes the lowest docs, whatever their phase, where the
    narrow route's phase-major merge would put xenon's docs first."""
    jix, tix, ties = wide_idx
    jres, tres = _served(jix, tix, QUERIES[:1])
    j, t = jres[0], tres[0]
    keys = [h.key for h in t.hits]
    assert keys == [h.key for h in j.hits]
    assert len({h.score for h in t.hits}) == 1
    tie_keys = sorted(ties["xenon"] + ties["yarrow"],
                      key=lambda s: int(s[1:]))
    assert keys == tie_keys[:K]
    assert keys[0] in ties["yarrow"] and set(keys) & set(ties["xenon"])


def test_single_search_matches_the_batch(wide_idx):
    """Single `search()` (the port's window program) serves what the
    wide route serves."""
    _jix, tix, _ties = wide_idx
    tres = tix.search_many(QUERIES, k=K, opts_list=_opts(rt, len(QUERIES)))
    for q, t in zip(QUERIES, tres):
        one = tix.search(q, num=K, verbatim=True)
        assert one.total == t.total, q
        assert [h.key for h in one.hits] == [h.key for h in t.hits], q
        np.testing.assert_allclose([h.score for h in one.hits],
                                   [h.score for h in t.hits], rtol=RTOL)


R, N, O = TIK.REQ, TIK.NOT, TIK.OPT


def _windows(rng, B, Ws, n_docs=400_000):
    """Random doc-sorted posting windows (INT32_MAX past the live
    length) sharing a doc pool, at arbitrary offsets of flat arrays."""
    T = len(Ws)
    total = B * sum(w + 128 for w in Ws) + 4096
    doc_ids = np.full(total, 2**31 - 1, np.int32)
    freqs = np.zeros(total, np.float32)
    masks = np.zeros(total, np.int32)
    dl = np.floor(np.abs(rng.normal(24.0, 6.0, total)) + 1.0
                  ).astype(np.float32)
    meta = np.zeros((B, 3 * T), np.int32)
    fmeta = np.zeros((B, T + 1), np.float32)
    at = 0
    for b in range(B):
        pool = np.unique(rng.integers(0, n_docs, 2 * max(Ws)))
        for t, W in enumerate(Ws):
            live = int(rng.integers(max(1, W // 2), W + 1))
            shared = pool[rng.random(len(pool)) < 0.5][:live]
            docs = np.unique(np.concatenate(
                [shared, rng.integers(0, n_docs, live)]))[:live]
            live = len(docs)
            doc_ids[at:at + live] = docs
            freqs[at:at + live] = rng.integers(1, 4, live)
            masks[at:at + live] = np.where(rng.random(live) < 0.9, 3, 4)
            meta[b, t], meta[b, T + t], meta[b, 2 * T + t] = at, live, 3
            at += W + int(rng.integers(0, 128))
        fmeta[b, :T] = rng.uniform(0.5, 4.0, T)
        fmeta[b, T] = 24.0
    return [meta, fmeta, doc_ids, freqs, masks, dl]


@pytest.mark.parametrize("Ws,groups,k", [
    ((65536, 2048), ((R, (0, 1)),), 16),
    ((65536, 65536), ((R, (0,)), (R, (1,))), 64),
    ((65536, 8192), ((R, (0,)), (N, (1,))), 16),
], ids=["or2", "and2-both-wide", "not"])
def test_plain_wide_pivot_matches_xla_impl(Ws, groups, k):
    """intersect_plain with a 65,536-lane pivot against `_xla_impl` on
    the same numpy inputs: counts and live docs equal, scores within
    rtol 1e-6 (the same f32 operations in the same order), exhausted
    lanes INT32_MAX in the port."""
    rng = np.random.default_rng(sum(Ws) + k)
    args = _windows(rng, 3, Ws)
    kw = dict(T=len(Ws), Ws=Ws, groups=groups, pivot_g=0, k=k)
    td, ts, tc = (o.numpy() for o in TIK.intersect_batch(
        *[torch.from_numpy(a) for a in args], **kw))
    xd, xs, xc = (np.asarray(a) for a in JIK._xla_impl(
        *[jnp.asarray(a) for a in args], **kw))
    np.testing.assert_array_equal(tc, xc)
    assert tc.min() > k and td.shape == xd.shape
    live = xs > -3.3e38
    np.testing.assert_array_equal(ts > -3.3e38, live)
    np.testing.assert_array_equal(td[live], xd[live])
    assert (td[~live] == 2**31 - 1).all()
    np.testing.assert_allclose(ts[live], xs[live], rtol=1e-6, atol=0)
