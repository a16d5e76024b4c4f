"""execute_batch_rounds / run_hybrid_rounds through the port, on the CPU.

A port of tests/test_rounds.py on its 3,000-doc corpus (seed 7): R
rounds must return exactly what R sequential `execute_batch` /
`run_hybrid_many` calls return (idx, counts, scores and distances equal),
for KNN and text rounds, rounds of different sizes and shapes, and
hybrid rounds.  Each is held against the JAX package's
`execute_batch_rounds` / `run_hybrid_rounds` on the same corpus: idx of
the live lanes and counts equal, scores within the window tolerance of
tests/test_torch_execute.py (rtol 1e-5) and distances within the KNN
tolerance of tests/test_torch_knn.py (rtol 1e-5, atol 1e-6).  (The JAX
package leaves a real doc id in exhausted lanes, the port INT32_MAX:
ROADMAP §C.)
"""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.aux import hybrid as JH
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.aux import hybrid as TH
from redisearch_tpu_torch.query import engine as TE

RTOL, ATOL = 1e-5, 1e-6
N, DIM = 3000, 16
WORDS = ["alpha", "beta", "gamma", "delta"]


def _fields(p):
    return [p.Field("title", p.FieldType.TEXT),
            p.Field("cat", p.FieldType.TAG),
            p.Field("emb", p.FieldType.VECTOR,
                    vector=p.VectorParams(dim=DIM,
                                          metric=p.VectorMetric.COSINE))]


@pytest.fixture(scope="module")
def ix():
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    docs = [(f"d{i}", {"title": f"{WORDS[i % 4]} {WORDS[(i + 1) % 4]}",
                       "cat": f"c{i % 5}", "emb": vecs[i]})
            for i in range(N)]
    out = []
    for p in (rs, rt):
        kw = {} if p is rs else {"device": "cpu"}
        x = p.SearchIndex(p.Schema(name="rounds", fields=_fields(p)), **kw)
        x.add_documents(docs)
        x.commit()
        out.append(x)
    return out[0], out[1], vecs


def _knn(E, x, vecs, r, i, B):
    return x.prepare(f"(@cat:{{c{(r * B + i) % 5}}})=>[KNN 4 @emb $b]",
                     {"b": vecs[(r * B + i) % 100]}, E.QueryOptions(k=4), 2)


def _text(E, x, r, i):
    return x.prepare(["alpha", "beta gamma", "alpha | delta",
                      "-beta alpha"][(r + i) % 4], None,
                     E.QueryOptions(k=5), 2)


def _res_tuple(sr):
    return (tuple(np.asarray(sr.local_idx).tolist()),
            tuple(np.asarray(sr.scores).tolist()), sr.count,
            None if sr.knn_dists is None
            else tuple(np.asarray(sr.knn_dists).tolist()))


def _same_as_jax(t, j):
    """One SegmentResult of each package: live lanes, counts, scores and
    distances."""
    assert t.count == j.count
    live = np.asarray(t.scores) > -3.3e38
    if t.knn_dists is not None:
        live = np.asarray(t.knn_dists) < 3.3e38
        np.testing.assert_allclose(np.asarray(t.knn_dists)[live],
                                   np.asarray(j.knn_dists)[live],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(t.local_idx)[live],
                                  np.asarray(j.local_idx)[live])
    np.testing.assert_allclose(np.asarray(t.scores)[live],
                               np.asarray(j.scores)[live], rtol=RTOL,
                               atol=1e-7)


def _check_rounds(tseg, jseg, trounds, jrounds, k):
    got = TE.execute_batch_rounds(trounds, tseg, k)
    assert len(got) == len(trounds)
    for r, cqs in enumerate(trounds):
        want = TE.execute_batch(cqs, tseg, k)
        assert [_res_tuple(a) for a in got[r]] == \
            [_res_tuple(b) for b in want]
    jgot = JE.execute_batch_rounds(jrounds, jseg, k)
    for tr, jr in zip(got, jgot):
        for t, j in zip(tr, jr):
            _same_as_jax(t, j)


def test_rounds_match_sequential_knn(ix):
    jix, tix, vecs = ix
    B, R = 16, 3
    _check_rounds(
        tix.segments[0], jix.segments[0],
        [[_knn(TE, tix, vecs, r, i, B) for i in range(B)] for r in range(R)],
        [[_knn(JE, jix, vecs, r, i, B) for i in range(B)] for r in range(R)],
        4)


def test_rounds_match_sequential_text(ix):
    jix, tix, _vecs = ix
    B, R = 8, 2
    _check_rounds(
        tix.segments[0], jix.segments[0],
        [[_text(TE, tix, r, i) for i in range(B)] for r in range(R)],
        [[_text(JE, jix, r, i) for i in range(B)] for r in range(R)], 5)


def test_rounds_fallback_on_shape_mismatch(ix):
    """Rounds of different sizes and query shapes (the JAX package's
    fallback case): each round still equals its own batch."""
    jix, tix, _vecs = ix

    def rounds(E, x):
        return [[x.prepare("alpha", None, E.QueryOptions(k=5), 2)
                 for _ in range(4)],
                [x.prepare("beta gamma", None, E.QueryOptions(k=5), 2)
                 for _ in range(8)]]

    _check_rounds(tix.segments[0], jix.segments[0], rounds(TE, tix),
                  rounds(JE, jix), 5)


def test_rounds_async_handle(ix):
    _jix, tix, vecs = ix
    seg = tix.segments[0]
    rounds = [[_knn(TE, tix, vecs, r, i, 4) for i in range(4)]
              for r in range(2)]
    h = TE.execute_batch_rounds(rounds, seg, 4, async_=True)
    assert isinstance(h, TE.Deferred)
    assert [[_res_tuple(a) for a in rr] for rr in h.result()] == \
        [[_res_tuple(a) for a in TE.execute_batch(cqs, seg, 4)]
         for cqs in rounds]


def _hybrid_rounds(p, vecs, B=8, R=2):
    return [[p.HybridQuery(
        search=["alpha", "beta"][(r + i) % 2], vsim_field="emb",
        vsim_vector=vecs[(r * B + i) % 50],
        combine=["RRF", "LINEAR"][i % 2], window=6, limit=4)
        for i in range(B)] for r in range(R)]


def test_hybrid_rounds_match(ix):
    jix, tix, vecs = ix
    rounds = _hybrid_rounds(rt, vecs)
    got = TH.run_hybrid_rounds(tix, rounds)
    assert len(got) == len(rounds)
    for r in range(len(rounds)):
        assert got[r] == TH.run_hybrid_many(tix, rounds[r])
    jgot = JH.run_hybrid_rounds(jix, _hybrid_rounds(rs, vecs))
    for tr, jr in zip(got, jgot):
        for t, j in zip(tr, jr):
            assert [x["__key"] for x in t] == [x["__key"] for x in j]
            for xt, xj in zip(t, j):
                assert list(xt) == list(xj)
                for key, vj in xj.items():
                    if isinstance(vj, float):
                        assert abs(xt[key] - vj) <= ATOL + RTOL * abs(vj)


def test_hybrid_rounds_two_segments_and_async(ix):
    """Rounds over a two-segment index (each segment's rounds merged per
    round), through the async handle."""
    _jix, tix, vecs = ix
    x = rt.SearchIndex(rt.Schema(name="r2", fields=_fields(rt)),
                       device="cpu")
    for s in range(2):
        x.add_documents([(f"d{i}", {"title": f"{WORDS[i % 4]} common",
                                    "cat": f"c{i % 5}", "emb": vecs[i]})
                         for i in range(s * 400, (s + 1) * 400)])
    assert len(x.segments) == 2
    rounds = _hybrid_rounds(rt, vecs, B=4, R=3)
    h = TH.run_hybrid_rounds(x, rounds, async_=True)
    assert isinstance(h, TE.Deferred)
    assert h.result() == [TH.run_hybrid_many(x, hqs) for hqs in rounds]
