"""The port's phrase search against the JAX package, on the CPU.

`redisearch_tpu_torch.ops.intersect.phrase_plain` (what a CPU tensor
runs, and what the CUDA phrase kernel is held against on the card) is
compared with `redisearch_tpu.ops.intersect._xla_phrase_impl` and with
the Pallas phrase kernel run in interpret mode, on random posting and
position-key windows made with a seeded numpy generator; then the port's
planner and `search_many` with the JAX package's on the same corpora,
and the port's in-order results with the reference proximity model
`within_range_in_order` (tests/test_fuzz_proximity.py).

Tolerances:
* against `_xla_phrase_impl`: docs and counts equal, scores bit-equal
  (both sides evaluate BM25 in float32 in the same operation order).
  `_xla_phrase_impl` may leave a real doc id in an exhausted top-k lane
  (its score is -3.4e38) where the port puts INT32_MAX: lanes whose
  score is <= -3.3e38 are compared by score only.
* against the Pallas kernel in interpret mode: docs and counts equal
  (top-k lanes and raw lanes lane for lane), scores within rtol/atol
  1e-3, the JAX package's own tolerance for this kernel
  (tests/test_pallas_interpret.py).
* `search_many` against the JAX package: totals and hit keys equal and
  in the same order, scores within rtol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.ops import intersect as TIK
from redisearch_tpu_torch.query import engine as TE
from tests.test_fuzz_proximity import within_range_in_order

BLK = 128
INF = 2**31 - 1
N_DOCS = 50_000
PALLAS_TOL = 1e-3
RTOL = 1e-5
NOW = 1_700_000_000


@pytest.fixture
def interpret_mode():
    """Run the JAX package's Pallas kernels in interpret mode; the jit
    caches hold the path decision, so drop them on both toggles."""
    JIK._INTERPRET = True
    jax.clear_caches()
    yield
    JIK._INTERPRET = False
    jax.clear_caches()


def _make_phrase(rng, B, Ws, PWs, stride=64, repeat=False, clamp=False):
    """Phrase inputs in flat arrays of whole 128-lane rows: per slot a
    doc-sorted posting window and a sorted position-key window (doc *
    stride + pos, 1-3 positions a doc), at arbitrary in-row offsets with
    INT32_MAX past the live length.  Half the docs common to every slot
    get an in-order run with gaps of 0-2 positions, so chains of every
    slop match.  repeat: slot 1 reads slot 0's windows (a repeated
    term).  clamp: positions past stride - 1 are clamped there, as the
    segment builder clamps long docs, so keys repeat within a term."""
    T = len(Ws)
    tail = (max(max(Ws), max(PWs)) // BLK + 16) * BLK
    n_post = B * sum(Ws) + 2 * BLK * B * T + tail
    n_keys = B * sum(PWs) + 2 * BLK * B * T + tail
    doc_ids = np.full(n_post, INF, np.int32)
    freqs = np.zeros(n_post, np.float32)
    masks = np.zeros(n_post, np.int32)
    dl = (np.abs(rng.normal(24.0, 6.0, n_post)) + 1.0).astype(np.float32)
    keys = np.full(n_keys, INF, np.int32)
    meta = np.zeros((B, 5 * T), np.int32)
    fmeta = np.zeros((B, T + 1), np.float32)
    at_p = at_k = 0
    for b in range(B):
        pool = np.sort(rng.choice(N_DOCS, size=max(Ws), replace=False))
        slot_docs = []
        for t, W in enumerate(Ws):
            live = int(rng.integers(max(1, W // 4), W + 1))
            shared = pool[rng.random(len(pool)) < 0.6]
            extra = rng.choice(N_DOCS, size=live, replace=False)
            slot_docs.append(np.unique(np.concatenate([shared, extra]))[:live])
        common = slot_docs[0]
        for t in range(1, T):
            common = np.intersect1d(common, slot_docs[t])
        seeded = common[rng.random(len(common)) < 0.5]
        runs = {int(d): (int(rng.integers(0, stride - 3 * T)),
                         rng.integers(0, 3, T)) for d in seeded}
        for t, W in enumerate(Ws):
            if repeat and t == 1:
                meta[b, 1::T] = meta[b, 0::T]
                continue
            docs = slot_docs[t]
            off = int(rng.integers(0, BLK))
            at_p += off
            live = len(docs)
            doc_ids[at_p:at_p + live] = docs
            freqs[at_p:at_p + live] = rng.integers(1, 8, live)
            masks[at_p:at_p + live] = np.where(rng.random(live) < 0.9, 3, 4)
            ks = []
            for d in docs:
                hi = stride + 40 if clamp else stride
                pos = list(rng.integers(0, hi, int(rng.integers(1, 4))))
                if int(d) in runs:
                    p0, gaps = runs[int(d)]
                    pos.append(p0 + t + int(gaps[:t + 1].sum()))
                pos = np.minimum(np.asarray(pos), stride - 1)
                ks.append(int(d) * stride + np.unique(pos) if not clamp
                          else int(d) * stride + np.sort(pos))
            ks = np.concatenate(ks).astype(np.int32)
            PW = PWs[t]
            koff = int(rng.integers(0, BLK))
            at_k += koff
            n_live = min(len(ks), PW)
            keys[at_k:at_k + n_live] = ks[:n_live]
            meta[b, t], meta[b, T + t], meta[b, 2 * T + t] = at_p, live, 3
            meta[b, 3 * T + t], meta[b, 4 * T + t] = at_k, n_live
            at_p += W + BLK
            at_k += PW + BLK
        fmeta[b, :T] = rng.uniform(0.5, 4.0, T)
        if repeat:
            fmeta[b, 1] = fmeta[b, 0]
        fmeta[b, T] = 24.0
    return [meta, fmeta, doc_ids, freqs, masks, dl, keys]


# (label, Ws, PWs, slop, k, layout)
CASES = [
    ("t2-exact", (1024, 1024), (2048, 2048), 0, 16, None),
    ("t2-slop1", (1024, 1024), (2048, 2048), 1, 16, None),
    ("t2-slop3-k64", (1024, 2048), (2048, 4096), 3, 64, None),
    ("t2-imbalanced-k1", (1024, 4096), (1024, 8192), 0, 1, None),
    ("t2-imbalanced-rev", (4096, 1024), (8192, 1024), 1, 16, None),
    ("t3-exact", (1024, 1024, 1024), (2048, 2048, 2048), 0, 16, None),
    ("t3-slop1-k64", (1024, 2048, 1024), (2048, 4096, 2048), 1, 64, None),
    ("t4-exact-k1", (1024,) * 4, (2048,) * 4, 0, 1, None),
    ("t4-slop3", (1024, 1024, 2048, 1024), (2048, 2048, 4096, 2048), 3, 16,
     None),
    ("t2-repeated", (1024, 1024), (2048, 2048), 0, 16, "repeat"),
    ("t3-repeated-slop1", (1024, 1024, 1024), (2048, 2048, 2048), 1, 16,
     "repeat"),
    ("t2-clamped", (1024, 1024), (2048, 2048), 0, 16, "clamp"),
    ("t3-clamped-slop1", (1024, 1024, 1024), (4096, 4096, 4096), 1, 16,
     "clamp"),
]


def _inputs(label, Ws, PWs, layout, B=6):
    rng = np.random.default_rng(sum(map(ord, label)))
    return _make_phrase(rng, B, Ws, PWs, repeat=layout == "repeat",
                        clamp=layout == "clamp")


def _port(args, **kw):
    out = TIK.phrase_batch(*[torch.from_numpy(a) for a in args], **kw)
    return tuple(o.numpy() for o in out)


def _case(label):
    return next(c for c in CASES if c[0] == label)


@pytest.mark.parametrize("label,Ws,PWs,slop,k,layout", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_xla_phrase_impl(label, Ws, PWs, slop, k, layout):
    args = _inputs(label, Ws, PWs, layout)
    kw = dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=64, slop=slop, k=k)
    td, ts, tc = _port(args, **kw)
    xd, xs, xc = (np.asarray(a) for a in JIK._xla_phrase_impl(
        *[jnp.asarray(a) for a in args], **kw))
    np.testing.assert_array_equal(tc, xc)
    assert td.shape == xd.shape == (6, BLK) and ts.shape == xs.shape
    live = xs > -3.3e38
    np.testing.assert_array_equal(ts > -3.3e38, live)
    np.testing.assert_array_equal(np.where(live, td, -1),
                                  np.where(live, xd, -1))
    assert (td[~live] == INF).all()
    np.testing.assert_array_equal(ts.view(np.int32), xs.view(np.int32))
    assert tc.sum() > 0, "no phrase matches generated"


@pytest.mark.parametrize("label", ["t2-exact", "t3-exact", "t2-clamped"])
def test_more_slop_matches_more(label):
    """A chain that holds at slop s holds at every larger slop: the
    counts never fall as the slop grows, and rise on these layouts."""
    _l, Ws, PWs, _s, k, layout = _case(label)
    args = _inputs(label, Ws, PWs, layout)
    counts = [_port(args, T=len(Ws), Ws=Ws, PWs=PWs, stride=64, slop=s,
                    k=k)[2] for s in (0, 1, 3, 64)]
    for lo, hi in zip(counts, counts[1:]):
        assert (lo <= hi).all()
    assert counts[-1].sum() > counts[0].sum()


def test_repeated_term_matches_every_doc_holding_it():
    """An equal key is accepted (span -1): '"a a"' matches every doc of
    a's postings that holds a key, at any slop."""
    _l, Ws, PWs, _s, k, layout = _case("t2-repeated")
    meta, fmeta, d, f, m, dl, keys = _inputs("t2-repeated", Ws, PWs, layout)
    want = []
    for b in range(meta.shape[0]):
        docs = d[meta[b, 0]:meta[b, 0] + meta[b, 2]]
        ks = keys[meta[b, 6]:meta[b, 6] + meta[b, 8]]
        want.append(np.isin(docs, ks // 64).sum())
    for slop in (0, 3):
        tc = _port([meta, fmeta, d, f, m, dl, keys], T=2, Ws=Ws, PWs=PWs,
                   stride=64, slop=slop, k=k)[2]
        np.testing.assert_array_equal(tc, want)


@pytest.mark.parametrize("label,eq_join", [
    ("t2-exact", None), ("t2-exact", False), ("t2-slop1", None),
    ("t2-imbalanced-k1", None), ("t3-slop1-k64", None),
    ("t2-clamped", False), ("t2-repeated", None)])
def test_plain_matches_pallas_interpret(interpret_mode, label, eq_join):
    """Top-k lanes against the Pallas kernel, with the 2-term equality
    join (eq_join None) and without (False, as on clamped segments)."""
    _l, Ws, PWs, slop, k, layout = _case(label)
    args = _inputs(label, Ws, PWs, layout)
    kw = dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=64, slop=slop, k=k)
    assert JIK._use_pallas(), "interpret hook not active"
    kd, ks, kc = (np.asarray(a) for a in JIK.phrase_batch(
        *[jnp.asarray(a) for a in args], eq_join=eq_join, **kw))
    td, ts, tc = _port(args, eq_join=eq_join, **kw)
    np.testing.assert_array_equal(tc, kc)
    np.testing.assert_array_equal(td[:, :k], kd[:, :k])
    np.testing.assert_allclose(ts[:, :k], ks[:, :k], rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    assert tc.sum() > 0


@pytest.mark.parametrize("label", ["t2-exact", "t2-slop3-k64",
                                   "t3-exact", "t2-clamped"])
def test_plain_raw_matches_pallas_interpret(interpret_mode, label):
    """Raw lanes lane for lane: term 0's section of Ws[0]/128 + 8 rows
    from its start's row, live lanes at [start % 128, + len)."""
    _l, Ws, PWs, slop, k, layout = _case(label)
    args = _inputs(label, Ws, PWs, layout)
    kw = dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=64, slop=slop, k=k,
              raw=True, eq_join=False if layout == "clamp" else None)
    kd, ks, kc = (np.asarray(a) for a in JIK.phrase_batch(
        *[jnp.asarray(a) for a in args], **kw))
    td, ts, tc = _port(args, **kw)
    L = (Ws[0] // BLK + 8) * BLK
    assert td.shape == kd.shape == (6, L) and ts.shape == ks.shape
    np.testing.assert_array_equal(td, kd)
    np.testing.assert_array_equal(tc, kc)
    np.testing.assert_allclose(ts, ks, rtol=PALLAS_TOL, atol=PALLAS_TOL)
    live = td != INF
    assert (ts[~live] <= -3.3e38).all() and live.any()
    np.testing.assert_array_equal(tc, live.sum(1))


@pytest.mark.parametrize("label", ["t2-exact", "t3-slop1-k64",
                                   "t4-slop3", "t2-repeated"])
def test_plain_raw_topk_matches_xla_phrase_impl(label):
    """The raw lanes merged with iter_topk give the twin's top-k."""
    _l, Ws, PWs, slop, k, layout = _case(label)
    args = _inputs(label, Ws, PWs, layout)
    kw = dict(T=len(Ws), Ws=Ws, PWs=PWs, stride=64, slop=slop, k=k)
    rd, rsc, rc = (torch.from_numpy(a) for a in _port(args, raw=True, **kw))
    xd, xs, xc = (np.asarray(a) for a in JIK._xla_phrase_impl(
        *[jnp.asarray(a) for a in args], **kw))
    np.testing.assert_array_equal(rc.numpy(), xc)
    tv, tsel = TIK.iter_topk(rsc, rd, k)
    tdocs = torch.gather(rd, 1, tsel).numpy()
    live = xs[:, :k] > -3.3e38
    np.testing.assert_array_equal(tv.numpy() > -3.3e38, live)
    np.testing.assert_array_equal(tdocs[live], xd[:, :k][live])
    np.testing.assert_array_equal(tv.numpy()[live], xs[:, :k][live])


def test_plain_rows_are_independent():
    """A batch gives the rows of its queries run one by one (the chunked
    loop and the [b, PW] windows keep rows apart)."""
    _l, Ws, PWs, slop, k, layout = _case("t3-slop1-k64")
    args = _inputs("t3-slop1-k64", Ws, PWs, layout)
    kw = dict(T=3, Ws=Ws, PWs=PWs, stride=64, slop=slop, k=k)
    for raw in (False, True):
        whole = _port(args, raw=raw, **kw)
        for b in (0, 3, 5):
            one = _port([args[0][b:b + 1], args[1][b:b + 1]] + args[2:],
                        raw=raw, **kw)
            for w, o in zip(whole, one):
                np.testing.assert_array_equal(w[b:b + 1], o)


def test_device_routing(monkeypatch):
    """phrase_batch routes by the tensors' device: CPU tensors run
    phrase_plain, CUDA tensors the kernel launcher (never the plain
    version), any other device raises."""
    import types
    calls = []
    monkeypatch.setattr(TIK, "phrase_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(TIK, "_phrase_launch",
                        lambda *a, **k: calls.append("kernel"))
    kw = dict(T=2, Ws=(1024, 1024), PWs=(2048, 2048), stride=64)
    cuda_meta = types.SimpleNamespace(device=torch.device("cuda", 0))
    TIK.phrase_batch(cuda_meta, *[None] * 6, **kw)
    TIK.phrase_batch(torch.zeros((1, 10), dtype=torch.int32), *[None] * 6,
                     **kw)
    assert calls == ["kernel", "plain"]
    with pytest.raises(RuntimeError, match="no phrase kernel"):
        TIK.phrase_batch(torch.zeros((1, 10), device="meta"), *[None] * 6,
                         **kw)


def test_phrase_params_layout():
    """The parameter block csrc/phrase.cu reads at its P_* offsets."""
    prm = TIK._phrase_params(3, (2048, 2048, 2048), (8192, 2048, 2048), 64,
                             1, 16, False, 128, 2048, 77)
    assert prm.dtype == np.int32 and prm.shape == (16,)
    assert prm[:8].tolist() == [3, 64, 1, 16, 0, 128, 2048, 77]
    assert prm[8:12].tolist() == [2048, 2048, 2048, 0]
    assert prm[12:16].tolist() == [8192, 2048, 2048, 0]
    assert TIK._phrase_lanes((8192, 8192), 16, True) == (64 + 8) * BLK
    assert TIK._phrase_lanes((8192, 8192), 64, False) == BLK


# ---------------------------------------------------------------------------
# planner and search_many against the JAX package
# ---------------------------------------------------------------------------

def _fields(p):
    return [p.Field("a", p.FieldType.TEXT), p.Field("b", p.FieldType.TEXT)]


def _pair(docs, fields=_fields):
    jix = rs.SearchIndex(rs.Schema(name="ph", fields=fields(rs)))
    tix = rt.SearchIndex(rt.Schema(name="ph", fields=fields(rt)),
                         device="cpu")
    jix.add_documents(docs)
    tix.add_documents(docs)
    return jix, tix


@pytest.fixture(scope="module")
def phrase_idx():
    """tests/test_phrase_kernel.py's corpus: 3,000 docs, a 10-word and a
    6-word TEXT field over a 60-word zipf(1.1) vocab."""
    rng = np.random.default_rng(11)
    vocab = [f"w{i:03d}" for i in range(60)]
    probs = (1.0 / np.arange(1, 61)) ** 1.1
    probs /= probs.sum()
    docs = [(f"d{i}", {"a": " ".join(rng.choice(vocab, size=10, p=probs)),
                       "b": " ".join(rng.choice(vocab, size=6, p=probs))})
            for i in range(3000)]
    return _pair(docs)


@pytest.fixture(scope="module")
def clamped_idx():
    """A segment whose positions were clamped at stride - 1: one doc of
    5,000 tokens (past the 4,096 stride cap) ends in repeated runs of
    the phrase terms, among 800 short docs."""
    rng = np.random.default_rng(5)
    vocab = [f"w{i:03d}" for i in range(20)]
    docs = [(f"d{i}", {"a": " ".join(rng.choice(vocab, size=8)),
                       "b": " ".join(rng.choice(vocab, size=4))})
            for i in range(800)]
    long_doc = list(rng.choice(vocab, size=4600)) + ["w001", "w000"] * 200
    docs.append(("long", {"a": " ".join(long_doc), "b": "w000 w001"}))
    jix, tix = _pair(docs)
    assert tix.segments[0].text.pos_clamped
    assert jix.segments[0].text.pos_clamped
    return jix, tix


EXACT = ['"w000 w001"', '"w001 w000"', '"w003 w004 w005"',
         '"w000 w001 w002 w003"', '@a:"w000 w002"', '@b:"w001 w003"',
         '"w000 w000"', '"w000 w059"', '"w058 w059"', '"w000 zzznope"']
SLOPPY = ["w000 w002", "w001 w004", "w000 w001 w003", "w002 w000 w001 w004"]


def _opts(pkg, n, **kw):
    return [pkg.QueryOptions(k=10, now=NOW, **kw) for _ in range(n)]


def _compare(jix, tix, queries, **kw):
    jres = jix.search_many(queries, k=10,
                           opts_list=_opts(rs, len(queries), **kw))
    TE.QUERY_PATH_STATS.clear()
    tres = tix.search_many(queries, k=10,
                           opts_list=_opts(rt, len(queries), **kw))
    assert TE.QUERY_PATH_STATS == {"phrase-kernel": len(queries)}
    for q, j, t in zip(queries, jres, tres):
        assert t.total == j.total, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL,
                                   err_msg=q)
    return tres


def _plans(ix, pkg, eng, queries, **kw):
    seg = ix.segments[0]
    out = []
    for q in queries:
        cq = ix.prepare(q, None, pkg.QueryOptions(k=10, now=NOW, **kw), 2)
        _row, ent = cq.bind_row(seg)
        out.append((_row.tobytes(), ent[4],
                    eng._kernel_plan_phrase(cq, seg, ent[4], 16)))
    return out


@pytest.mark.parametrize("kw", [{}, {"slop": 1, "inorder": True},
                                {"slop": 2, "inorder": False}],
                         ids=["exact", "slop1-inorder", "slop2-unordered"])
def test_kernel_plan_phrase_matches_jax(phrase_idx, kw):
    """Rows, buckets and phrase plans agree query for query, accepted
    (exact and in-order phrases of 2-4 terms) and refused (unordered
    slop, 5 terms, AND queries) alike."""
    jix, tix = phrase_idx
    queries = (EXACT + ['"w000 w001 w002 w003 w004"', "w000 w001"]
               if not kw else SLOPPY)
    jp = _plans(jix, rs, JE, queries, **kw)
    tp = _plans(tix, rt, TE, queries, **kw)
    assert jp == tp
    accepted = [q for q, (_r, _b, p) in zip(queries, tp) if p is not None]
    if kw.get("inorder") is False:
        assert accepted == []
    elif kw:
        assert accepted == queries
    else:
        assert accepted == EXACT


def test_exact_phrases_match_jax(phrase_idx):
    res = _compare(*phrase_idx, EXACT * 2)
    totals = dict(zip(EXACT, (r.total for r in res)))
    # two rare terms are never adjacent here; a missing term matches none
    assert totals.pop('"w058 w059"') == totals.pop('"w000 zzznope"') == 0
    assert all(t > 0 for t in totals.values())
    # a repeated term matches every doc that holds it
    assert totals['"w000 w000"'] > 2500


@pytest.mark.parametrize("slop", [0, 1, 3])
def test_inorder_slop_matches_jax(phrase_idx, slop):
    res = _compare(*phrase_idx, SLOPPY, slop=slop, inorder=True)
    assert all(r.total > 0 for r in res)


def test_clamped_segment_matches_jax(clamped_idx):
    """On a pos_clamped segment the JAX package turns its 2-term
    equality join off; the chain is what both packages compute."""
    queries = ['"w000 w001"', '"w001 w000"', '"w000 w001 w000"',
               '@b:"w000 w001"', '"w002 w003"']
    res = _compare(*clamped_idx, queries)
    assert any(h.key == "long" for h in res[0].hits)
    _compare(*clamped_idx, ["w001 w000", "w000 w002 w001"], slop=1,
             inorder=True)


def test_client_front_door_serves_phrases(phrase_idx):
    """Client.ft_create + hset + ft_search_many serve exact phrases as
    the JAX Client does."""
    jix, _tix = phrase_idx
    jc, tc = rs.Client(), rt.Client(device="cpu")
    docs = [(jix.doctable.get(g).key, jix.doctable.get(g).fields)
            for g in range(1, 1001)]
    for c, pkg in ((jc, rs), (tc, rt)):
        c.ft_create("ph", _fields(pkg))
        for key, f in docs:
            c.hset(key, f)
    queries = ['"w000 w001"', '"w002 w000"', '"w000 w001 w002"']
    jres = jc.ft_search_many("ph", queries, k=10)
    tres = tc.ft_search_many("ph", queries, k=10)
    for q, j, t in zip(queries, jres, tres):
        assert t.total == j.total and t.total > 0, q
        assert [h.key for h in t.hits] == [h.key for h in j.hits], q
        np.testing.assert_allclose([h.score for h in t.hits],
                                   [h.score for h in j.hits], rtol=RTOL)


# ---------------------------------------------------------------------------
# in-order results against the reference proximity model
# ---------------------------------------------------------------------------

VOCAB = ["aa", "bb", "cc", "dd", "ee"]


@pytest.mark.parametrize("seed", range(4))
def test_inorder_matches_proximity_model(seed):
    """test_fuzz_proximity.py's corpus shape at 1,200 docs (the kernel's
    smallest window bucket needs ~600): every total equals the number of
    docs `within_range_in_order` accepts, and every hit is one of them."""
    rng = np.random.default_rng(8100 + seed)
    toks = {f"d{i}": [VOCAB[j] for j in rng.integers(
        0, len(VOCAB), int(rng.integers(2, 10)))] for i in range(1200)}
    ix = rt.SearchIndex(rt.Schema(name="px", fields=[
        rt.Field("t", rt.FieldType.TEXT)]), device="cpu")
    ix.add_documents([(key, {"t": " ".join(t)}) for key, t in toks.items()])
    queries, opts, want = [], [], []
    for _ in range(6):
        terms = [VOCAB[int(j)] for j in
                 rng.integers(0, len(VOCAB), int(rng.integers(2, 5)))]
        slop = int(rng.integers(0, 4))
        queries.append(" ".join(terms))
        opts.append(rt.QueryOptions(k=10, now=NOW, slop=slop, inorder=True,
                                    verbatim=True))
        want.append({key for key, t in toks.items() if within_range_in_order(
            [[i + 1 for i, w in enumerate(t) if w == term]
             for term in terms], slop)
            and all(term in t for term in terms)})
    TE.QUERY_PATH_STATS.clear()
    res = ix.search_many(queries, k=10, opts_list=opts)
    assert TE.QUERY_PATH_STATS == {"phrase-kernel": len(queries)}
    for q, o, r, w in zip(queries, opts, res, want):
        assert r.total == len(w), (q, o.slop)
        assert {h.key for h in r.hits} <= w, (q, o.slop)
        assert len(r.hits) == min(10, len(w))


# ---------------------------------------------------------------------------
# phrases the kernel refuses
# ---------------------------------------------------------------------------

def test_refused_phrases_raise(phrase_idx, monkeypatch):
    """Unordered slop, more than 4 terms and phrases over ultra-common
    terms (position lists past POS_SLICE_PAD) are refused by the phrase
    kernel's plan and served by the general window program, equal to the
    JAX package's results."""
    jix, tix = phrase_idx
    cases = [
        (["w000 w001"], dict(slop=2, inorder=False)),
        (['"w000 w001 w002 w003 w004"'], {}),
    ]
    for queries, kw in cases:
        TE.QUERY_PATH_STATS.clear()
        t = tix.search_many(queries, k=10,
                            opts_list=_opts(rt, len(queries), **kw))
        assert TE.QUERY_PATH_STATS == {"window": len(queries)}
        j = jix.search_many(queries, k=10,
                            opts_list=_opts(rs, len(queries), **kw))
        for q, a, b in zip(queries, j, t):
            assert b.total == a.total, q
            assert [h.key for h in b.hits] == [h.key for h in a.hits], q
            np.testing.assert_allclose([h.score for h in b.hits],
                                       [h.score for h in a.hits], rtol=RTOL)
    import redisearch_tpu_torch.index.segment as tseg
    monkeypatch.setattr(tseg, "POS_SLICE_PAD", 1024)
    tix._prepared.clear()
    TE.QUERY_PATH_STATS.clear()
    t = tix.search_many(['"w000 w001"'], k=10,
                        opts_list=_opts(rt, 1, nostopwords=True))[0]
    assert TE.QUERY_PATH_STATS == {"window": 1}
    # the exact slow paths (chunked pivot, binary-search probes) serve
    # what the kernel serves with the full window
    monkeypatch.setattr(tseg, "POS_SLICE_PAD", 262144)
    tix._prepared.clear()
    want = tix.search_many(['"w000 w001"'], k=10,
                           opts_list=_opts(rt, 1, nostopwords=True))[0]
    assert t.total == want.total > 0
    assert [h.key for h in t.hits] == [h.key for h in want.hits]
