"""The port's window algebra and text ops against the JAX package, on the CPU.

`redisearch_tpu_torch.ops.window` / `ops.text` and the engine's
`_phrase_chain_pivot` run on the same seeded numpy arrays as
`redisearch_tpu.ops.window` / `ops.text` / `query.engine`.  Integer
outputs (docs, lanes, keys, masks) must be equal; float outputs equal
bit for bit where both sides do the same f32 operations in the same order
(the union folds), else within rtol 1e-6.

`member` is a binary search in the port where the JAX module compares
128-wide blocks; on ascending windows both are exact and agree.  On a
window whose valid docs ascend with invalid lanes between them (a phrase
generator's output), the JAX block search can miss (a block whose head
lane is invalid hides the block): the port is held there against numpy
set membership instead (ROADMAP §C).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from redisearch_tpu.ops import text as JT
from redisearch_tpu.ops import window as JW
from redisearch_tpu.query import engine as JEng
from redisearch_tpu_torch.ops import text as TT
from redisearch_tpu_torch.ops import window as TW
from redisearch_tpu_torch.query import engine as TEng

INF = 2**31 - 1


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _postings(rng, n_post=6000, n_docs=5000, K=None):
    """A flat posting array of ascending runs (the CSR layout)."""
    runs = []
    while sum(len(r) for r in runs) < n_post:
        runs.append(np.unique(rng.integers(0, n_docs,
                                           int(rng.integers(50, 900)))))
    docs = np.concatenate(runs)[:n_post].astype(np.int32)
    docs = np.concatenate([docs, np.zeros(4096, np.int32)])
    freqs = rng.integers(1, 6, docs.shape[0]).astype(np.float32)
    shape = (docs.shape[0],) if K is None else (docs.shape[0], K)
    masks = rng.integers(1, 8, shape).astype(np.int32)
    starts = np.cumsum([0] + [len(r) for r in runs[:-1]])
    return docs, freqs, masks, starts, [len(r) for r in runs]


@pytest.mark.parametrize("wide", [False, True], ids=["mask1", "mask2w"])
def test_slot_window_matches_jax(wide):
    rng = np.random.default_rng(1)
    docs, freqs, masks, starts, lens = _postings(rng, K=2 if wide else None)
    emask = rng.integers(0, 4, (5000,) + ((2,) if wide else ())).astype(
        np.int32)
    qmask = np.array([3, 1] if wide else 3, np.int32)
    (jd, jf, jm, je, jq), (td, tf, tm, te, tq) = _both(docs, freqs, masks,
                                                      emask, qmask)
    for i in range(5):
        for em in (False, True):
            j = JW.slot_window(jd, jf, jm, int(starts[i]), int(lens[i]), jq,
                               1024, emask=je if em else None)
            t = TW.slot_window(td, tf, tm, torch.tensor(int(starts[i])),
                               torch.tensor(int(lens[i])), tq, 1024,
                               emask=te if em else None)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("F", [5, 40])
def test_expired_field_mask_matches_jax(F):
    rng = np.random.default_rng(F)
    fexp = rng.integers(0, 100, (300, F)).astype(np.int32)
    fexp[rng.random((300, F)) < 0.5] = 0
    j = JW.expired_field_mask(jnp.asarray(fexp), jnp.int32(50))
    t = TW.expired_field_mask(torch.from_numpy(fexp), torch.tensor(50))
    np.testing.assert_array_equal(_np(j), _np(t))


def test_tag_numeric_dedup_iota_windows_match_jax():
    rng = np.random.default_rng(2)
    docs, _f, _m, starts, lens = _postings(rng)
    (jd,), (td,) = _both(docs)
    for i in range(4):
        for fn_j, fn_t in ((JW.tag_window, TW.tag_window),
                           (JW.numeric_window, TW.numeric_window)):
            j = fn_j(jd, int(starts[i]), int(lens[i]), 1024)
            t = fn_t(td, torch.tensor(int(starts[i])),
                     torch.tensor(int(lens[i])), 1024)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(_np(a), _np(b))
    dup = rng.integers(0, 40, 256).astype(np.int32)
    valid = rng.random(256) < 0.8
    (jdd, jv), (tdd, tv) = _both(dup, valid)
    for a, b in zip(JW.dedup_window(jdd, jv), TW.dedup_window(tdd, tv)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(JW.iota_window(384), TW.iota_window(384, "cpu")):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("W", [128, 256, 2048])
def test_member_on_ascending_windows_matches_jax(W):
    """Both the JAX all-pairs (W <= 256) and block (W > 256) paths."""
    rng = np.random.default_rng(W)
    live = int(W * 0.8)
    wd = np.full(W, INF, np.int32)
    wd[:live] = np.sort(rng.choice(4 * W, live, replace=False))
    wv = (wd != INF) & (rng.random(W) < 0.85)
    ws = rng.normal(0, 2, W).astype(np.float32)
    q = rng.integers(0, 4 * W, 700).astype(np.int32)
    q[::17] = INF
    (jd, jv, js, jq), (td, tv, ts, tq) = _both(wd, wv, ws, q)
    jh, jsc = JW.member(jd, jv, js, jq)
    th, tsc = TW.member(td, tv, ts, tq)
    np.testing.assert_array_equal(_np(jh), _np(th))
    np.testing.assert_array_equal(_np(jsc), _np(tsc))
    assert _np(th).sum() > 0
    assert TW.member(td, tv, None, tq)[1] is None


def test_member_with_invalid_lanes_between_valid_docs():
    """A phrase generator's output: valid docs ascend, dead candidates
    sit between them as INT32_MAX.  The port finds every valid doc (numpy
    set membership); the JAX block search misses some on this window."""
    rng = np.random.default_rng(9)
    W = 2048
    docs = np.sort(rng.choice(20000, W, replace=False)).astype(np.int32)
    valid = rng.random(W) < 0.3
    valid[::128] = False                  # invalid block heads
    wd = np.where(valid, docs, INF).astype(np.int32)
    q = np.concatenate([docs, rng.integers(0, 20000, 500)]).astype(np.int32)
    want = np.isin(q, docs[valid])
    (jd, jv, jq), (td, tv, tq) = _both(wd, valid, q)
    th, _ = TW.member(td, tv, None, tq)
    np.testing.assert_array_equal(_np(th), want)
    jh, _ = JW.member(jd, jv, None, jq)
    assert (_np(jh) != want).any()        # the JAX quirk this pins


@pytest.mark.parametrize("dismax", [False, True], ids=["sum", "dismax"])
def test_union_windows_match_jax(dismax):
    rng = np.random.default_rng(4 + dismax)
    wins_np = []
    for w in (256, 512, 256):
        d = np.full(w, INF, np.int32)
        live = int(w * 0.7)
        d[:live] = np.sort(rng.choice(600, live, replace=False))
        v = (d != INF) & (rng.random(w) < 0.9)
        s = rng.normal(1, 1, w).astype(np.float32)
        e = rng.random(w).astype(np.float32)
        wins_np.append((d, s, v, e))
    jw = [tuple(jnp.asarray(x) for x in w) for w in wins_np]
    tw = [tuple(torch.from_numpy(x) for x in w) for w in wins_np]
    j = JW.union_windows([w[:3] for w in jw], dismax=dismax,
                         extra=[w[3] for w in jw])
    t = TW.union_windows([w[:3] for w in tw], dismax=dismax,
                         extra=[w[3] for w in tw])
    for a, b in zip(j, t):       # docs, folded scores, valid, extra: bits
        np.testing.assert_array_equal(_np(a), _np(b))
    # tag-style windows (no score, no extra)
    j = JW.union_windows([(w[0], None, w[2]) for w in jw])
    t = TW.union_windows([(w[0], None, w[2]) for w in tw])
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_dedup_adjacent_matches_jax():
    rng = np.random.default_rng(6)
    d = np.sort(rng.integers(0, 300, 1024)).astype(np.int32)
    v = rng.random(1024) < 0.6
    (jd, jv), (td, tv) = _both(d, v)
    for a, b in zip(JW.dedup_adjacent(jd, jv), TW.dedup_adjacent(td, tv)):
        np.testing.assert_array_equal(_np(a), _np(b))


def _poskeys(rng, stride=64, n_docs=400, terms=5):
    """Per term a sorted position-key run (doc * stride + pos) in one flat
    array, its CSR offsets per posting, and (start, len) per term."""
    keys, po, starts, lens = [], [0], [], []
    at = 0
    for _t in range(terms):
        dd = np.unique(rng.integers(0, n_docs, int(rng.integers(40, 200))))
        starts.append(at)
        lens.append(len(dd))
        for d in dd:
            pos = np.unique(rng.integers(0, 12, int(rng.integers(1, 4))))
            keys.extend(int(d) * stride + int(p) for p in pos)
            po.append(len(keys))
        at += len(dd)
    keys = np.array(keys + [INF] * 8192, np.int32)
    return keys, np.array(po, np.int32), np.array(starts, np.int32), \
        np.array(lens, np.int32)


def test_poskeys_searchsorted_min_offset_delta_match_jax():
    rng = np.random.default_rng(8)
    keys, po, starts, lens = _poskeys(rng)
    (jk, jp), (tk, tp) = _both(keys, po)
    ka = [JT.gather_poskeys(jk, jp, int(starts[i]), int(lens[i]), 2048)
          for i in range(2)]
    kt = [TT.gather_poskeys(tk, tp, torch.tensor(int(starts[i])),
                            torch.tensor(int(lens[i])), 2048)
          for i in range(2)]
    for a, b in zip(ka, kt):
        np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
        assert int(a[1]) == int(b[1])
    q = rng.integers(0, 400 * 64, 300).astype(np.int32)
    lo, hi = int(po[starts[1]]), int(po[starts[1] + lens[1]])
    for side in ("left", "right"):
        j = JT.searchsorted_dynamic(jk, jnp.asarray(q), lo, hi, side=side)
        t = TT.searchsorted_dynamic(tk, torch.from_numpy(q),
                                    torch.tensor(lo), torch.tensor(hi),
                                    side=side)
        np.testing.assert_array_equal(_np(j), _np(t))
    docs = np.concatenate([np.arange(0, 400, 3), [INF] * 5]).astype(np.int32)
    j = JT.min_offset_delta(ka[0][0], ka[1][0], 64, jnp.asarray(docs))
    t = TT.min_offset_delta(kt[0][0], kt[1][0], 64, torch.from_numpy(docs))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert (_np(t[0]) != INF).sum() > 0


def test_scorer_transforms_match_jax():
    """BM25STD, TFIDF and TFIDF.DOCNORM per-term contributions, bit for
    bit (the same f32 operations in the same order)."""
    rng = np.random.default_rng(13)
    tf = rng.integers(0, 9, 512).astype(np.float32)
    dl = rng.integers(0, 40, 512).astype(np.float32)
    idf, avgdl = np.float32(1.7), np.float32(23.5)
    (jtf, jdl), (ttf, tdl) = _both(tf, dl)
    pairs = [(JT.bm25_transform(jtf, idf, jdl, avgdl),
              TT.bm25_transform(ttf, torch.tensor(idf), tdl,
                                torch.tensor(avgdl))),
             (JT.tfidf_transform(jtf, idf, jdl),
              TT.tfidf_transform(ttf, torch.tensor(idf), tdl)),
             (JT.tfidf_docnorm_transform(jtf, idf, jdl),
              TT.tfidf_transform(ttf, torch.tensor(idf), tdl))]
    for j, t in pairs:
        np.testing.assert_array_equal(_np(j), _np(t))


def test_numeric_range_mask_matches_jax():
    rng = np.random.default_rng(10)
    v = rng.normal(0, 10, 500).astype(np.float32)
    p = rng.random(500) < 0.9
    for lx in (False, True):
        for hx in (False, True):
            j = JT.numeric_range_mask(jnp.asarray(v), jnp.asarray(p), -3.0,
                                      4.5, lx, hx)
            t = TT.numeric_range_mask(torch.from_numpy(v),
                                      torch.from_numpy(p), -3.0, 4.5, lx, hx)
            np.testing.assert_array_equal(_np(j), _np(t))


def test_top_k_ties_match_jax():
    """Equal scores keep the lowest lane first (lax.top_k's order)."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 5, 3000).astype(np.float32)     # many ties
    for k in (1, 10, 64):
        jv, ji = JT.fast_top_k(jnp.asarray(x), k)
        tv, ti = TT.fast_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(_np(jv), _np(tv))
        np.testing.assert_array_equal(_np(ji), _np(ti))
    keys = rng.integers(0, 7, 3000).astype(np.float32)
    valid = rng.random(3000) < 0.7
    for asc in (True, False):
        j = JT.topk_by_key(jnp.asarray(keys), jnp.asarray(valid), 20, asc)
        t = TT.topk_by_key(torch.from_numpy(keys), torch.from_numpy(valid),
                           20, asc)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("case", [
    dict(slop=0, inorder=True, pivot_j=0),
    dict(slop=2, inorder=True, pivot_j=0),
    dict(slop=1, inorder=False, pivot_j=1),
    dict(slop=3, inorder=False, pivot_j=2),
    dict(slop=1, inorder=True, pivot_j=0, bigs=(False, True, False),
         big_rounds=(0, 12, 0)),
    dict(slop=1, inorder=False, pivot_j=0, n_chunks=3),
], ids=["exact", "inorder-slop2", "unordered-slop1", "unordered-slop3",
        "bigs", "n_chunks"])
def test_phrase_chain_pivot_matches_jax(case):
    rng = np.random.default_rng(12)
    # few docs, many positions: phrases do match
    keys, po, starts, lens = _poskeys(rng, n_docs=60, terms=3)
    (jk, jp), (tk, tp) = _both(keys, po)
    n_chunks = case.get("n_chunks", 1)
    Pc = 128 if n_chunks > 1 else 2048
    kw = dict(bigs=case.get("bigs"), big_rounds=case.get("big_rounds"),
              n_chunks=n_chunks, n_pad=128)
    j = JEng._phrase_chain_pivot(jk, jp, jnp.asarray(starts),
                                 jnp.asarray(lens), 64, case["slop"],
                                 case["inorder"], Pc, 2048, case["pivot_j"],
                                 **kw)
    t = TEng._phrase_chain_pivot(tk, tp, torch.from_numpy(starts),
                                 torch.from_numpy(lens), 64, case["slop"],
                                 case["inorder"], Pc, 2048, case["pivot_j"],
                                 **kw)
    for a, b in zip(j, t):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(_np(a), _np(b))
    assert _np(t[1]).sum() > 0
