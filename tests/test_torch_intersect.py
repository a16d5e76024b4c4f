"""The port's intersection op against the JAX package, on the CPU.

`redisearch_tpu_torch.ops.intersect.intersect_plain` (what a CPU tensor
runs, and what the CUDA kernel is held against on the card) is compared
with `redisearch_tpu.ops.intersect._xla_impl` and with the Pallas kernel
run in interpret mode, on random doc-sorted posting windows made with a
seeded numpy generator.

Tolerance: docs and counts are equal; scores agree to rtol 1e-6 (both
sides evaluate BM25 in float32 with the same operation order).  The one
documented difference: `_xla_impl` leaves a real doc id in an exhausted
lane (its score is -3.4e38); the port and the Pallas kernel put
INT32_MAX there.  Lanes whose score is <= -3.3e38 are compared by score
only.

Raw mode (`raw=True`, the GROUPBY path) is compared lane for lane with
the Pallas kernel's raw mode in interpret mode: equal docs and counts,
scores within rtol 1e-6; and its merged top-k with `_xla_impl`'s.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu_torch.ops import intersect as TIK

BLK = 128
N_DOCS = 100_000
INF = 2**31 - 1
RTOL = 1e-6


@pytest.fixture
def interpret_mode():
    """Run the JAX package's Pallas kernels in interpret mode; the jit
    caches hold the path decision, so drop them on both toggles."""
    JIK._INTERPRET = True
    jax.clear_caches()
    yield
    JIK._INTERPRET = False
    jax.clear_caches()


def _make_windows(rng, B, Ws, overlap=0.5):
    """Random sorted posting windows sharing a doc pool (so slots
    genuinely intersect), at arbitrary in-row offsets of flat arrays of
    whole 128-lane rows, INT32_MAX past the live length."""
    T = len(Ws)
    rows_total = (B * sum(Ws)) // BLK + 4 * B * T
    doc_ids = np.full((rows_total, BLK), INF, np.int32)
    freqs = np.zeros((rows_total, BLK), np.float32)
    masks = np.zeros((rows_total, BLK), np.int32)
    dl = np.abs(rng.normal(24.0, 6.0, (rows_total, BLK))
                ).astype(np.float32) + 1.0
    meta = np.zeros((B, 3 * T), np.int32)
    fmeta = np.zeros((B, T + 1), np.float32)
    at = 0
    for b in range(B):
        pool = np.sort(rng.choice(N_DOCS, size=max(Ws) * 2, replace=False))
        for t, W in enumerate(Ws):
            live = int(rng.integers(max(1, W // 2), W + 1))
            shared = pool[rng.random(len(pool)) < overlap][:live]
            extra = rng.choice(N_DOCS, size=live - len(shared),
                               replace=False)
            docs = np.unique(np.concatenate([shared, extra]))[:live]
            live = len(docs)
            off = int(rng.integers(0, BLK))
            rows_w = (off + W + BLK - 1) // BLK
            fd = doc_ids[at:at + rows_w].reshape(-1)
            ff = freqs[at:at + rows_w].reshape(-1)
            fm = masks[at:at + rows_w].reshape(-1)
            fd[off:off + live] = docs
            ff[off:off + live] = rng.integers(1, 8, live)
            fm[off:off + live] = np.where(rng.random(live) < 0.9, 3, 4)
            doc_ids[at:at + rows_w] = fd.reshape(rows_w, BLK)
            freqs[at:at + rows_w] = ff.reshape(rows_w, BLK)
            masks[at:at + rows_w] = fm.reshape(rows_w, BLK)
            meta[b, t], meta[b, T + t], meta[b, 2 * T + t] = (
                at * BLK + off, live, 3)
            at += rows_w + 1
        fmeta[b, :T] = rng.uniform(0.5, 4.0, T)
        fmeta[b, T] = 24.0
    return [meta, fmeta, doc_ids.reshape(-1), freqs.reshape(-1),
            masks.reshape(-1), dl.reshape(-1)]


def _with_tag_aux(rng, args, Ws, B):
    """Slot 1 becomes a TAG member read from an aux doc-window array."""
    meta = args[0].copy()
    T = len(Ws)
    W = Ws[1]
    # + 16 rows: the Pallas kernel reads W // 128 + 8 whole rows
    aux = np.full(B * (W + 2 * BLK) + 16 * BLK, INF, np.int32)
    at = 0
    for b in range(B):
        live = int(rng.integers(W // 2, W + 1))
        docs = np.sort(rng.choice(N_DOCS, size=live, replace=False))
        off = int(rng.integers(0, BLK))
        aux[at + off:at + off + live] = docs
        meta[b, 1], meta[b, T + 1] = at + off, live
        at += W + 2 * BLK
    return [meta] + args[1:] + [aux]


def _with_dense(rng, args, B, n_vals):
    """Adds a posting-aligned code column and per-query value ids (some
    unbound, -2) with one leaf constant each."""
    codes = rng.integers(0, 8, size=args[2].shape[0]).astype(np.int32)
    q = rng.integers(-1, 10, size=(B, n_vals)).astype(np.int32)
    q[rng.random(B) < 0.3, -1] = -2
    meta = np.concatenate([args[0], q], axis=1)
    fmeta = np.concatenate(
        [args[1], rng.uniform(0.5, 4.0, (B, 1)).astype(np.float32)], 1)
    return [meta, fmeta] + args[2:] + [codes]


R, N, O = JIK.REQ, JIK.NOT, JIK.OPT

# (label, Ws, groups, k, extra)
CASES = [
    ("and2", (1024, 2048), ((R, (0,)), (R, (1,))), 16, None),
    ("not", (1024, 2048), ((R, (0,)), (N, (1,))), 16, None),
    ("opt", (1024, 2048), ((R, (0,)), (O, (1,))), 16, None),
    ("or2", (1024, 1024), ((R, (0, 1)),), 16, None),
    ("and2not", (1024, 2048, 2048),
     ((R, (0,)), (R, (1,)), (N, (2,))), 16, None),
    ("k1", (1024, 2048), ((R, (0,)), (R, (1,))), 1, None),
    ("k64", (1024, 2048), ((R, (0,)), (R, (1,))), 64, None),
    ("or3-3phase", (1024, 1024, 2048), ((R, (0, 1, 2)),), 16, None),
    ("or2-and-not-k64", (1024, 1024, 2048, 2048),
     ((R, (0, 1)), (R, (2,)), (N, (3,))), 64, None),
    ("tag-aux", (1024, 2048), ((R, (0,), -1), (R, (1,), 0)), 16, "aux"),
    ("dense-tag", (1024, 2048), ((R, (0,), -1), (R, (1,), -1)), 16,
     "dense"),
]


def _inputs(label, Ws, extra, B=8):
    rng = np.random.default_rng(sum(map(ord, label)))
    args = _make_windows(rng, B, Ws)
    if extra == "aux":
        args = _with_tag_aux(rng, args, Ws, B)
    elif extra == "dense":
        args = _with_dense(rng, args, B, 2)
    dense = ((R, 0, 2),) if extra == "dense" else ()
    return args, dense


def _plain(args, **kw):
    out = TIK.intersect_batch(*[torch.from_numpy(a) for a in args], **kw)
    return tuple(o.numpy() for o in out)


def _assert_same(td, ts, tc, xd, xs, xc, P_n, k):
    lanes = P_n * k
    np.testing.assert_array_equal(tc, xc)
    assert td.shape == xd.shape and ts.shape == xs.shape
    live = xs[:, :lanes] > -3.3e38
    np.testing.assert_array_equal(ts[:, :lanes] > -3.3e38, live)
    np.testing.assert_array_equal(np.where(live, td[:, :lanes], -1),
                                  np.where(live, xd[:, :lanes], -1))
    np.testing.assert_array_equal(td[:, :lanes][~live], INF)
    np.testing.assert_allclose(ts[:, :lanes][live], xs[:, :lanes][live],
                               rtol=RTOL, atol=0)
    # lanes past P*k are filler on both sides
    assert (ts[:, lanes:] <= -3.3e38).all() and (td[:, lanes:] == INF).all()


@pytest.mark.parametrize("label,Ws,groups,k,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_xla_impl(label, Ws, groups, k, extra):
    args, dense = _inputs(label, Ws, extra)
    kw = dict(T=len(Ws), Ws=Ws, groups=groups, pivot_g=0, k=k, dense=dense)
    td, ts, tc = _plain(args, **kw)
    xd, xs, xc = (np.asarray(a) for a in JIK._xla_impl(
        *[jnp.asarray(a) for a in args], **kw))
    _assert_same(td, ts, tc, xd, xs, xc, len(groups[0][1]), k)
    assert tc.sum() > 0, "no matches generated"


@pytest.mark.parametrize("label", ["and2", "or2", "and2not", "tag-aux",
                                   "dense-tag"])
def test_plain_matches_pallas_interpret(interpret_mode, label):
    _label, Ws, groups, k, extra = next(c for c in CASES if c[0] == label)
    args, dense = _inputs(label, Ws, extra)
    kw = dict(T=len(Ws), Ws=Ws, groups=groups, pivot_g=0, k=k, dense=dense)
    assert JIK._use_pallas(), "interpret hook not active"
    kd, ks, kc = (np.asarray(a) for a in JIK.intersect_batch(
        *[jnp.asarray(a) for a in args], **kw))
    td, ts, tc = _plain(args, **kw)
    # the Pallas kernel's exhausted lanes are INT32_MAX filler too
    lanes = len(groups[0][1]) * k
    np.testing.assert_array_equal(td[:, :lanes], kd[:, :lanes])
    np.testing.assert_array_equal(tc, kc)
    np.testing.assert_allclose(ts[:, :lanes], ks[:, :lanes], rtol=RTOL,
                               atol=0)


RAW_LABELS = ["and2", "not", "opt", "or2", "and2not", "tag-aux",
              "dense-tag"]


@pytest.mark.parametrize("label", RAW_LABELS)
def test_plain_raw_matches_pallas_interpret(interpret_mode, label):
    """Raw lanes lane for lane: per pivot slot a section of W/128 + 8
    rows from the start's row, live lanes at [start % 128, + len)."""
    _label, Ws, groups, k, extra = next(c for c in CASES if c[0] == label)
    args, dense = _inputs(label, Ws, extra)
    kw = dict(T=len(Ws), Ws=Ws, groups=groups, pivot_g=0, k=k, dense=dense,
              raw=True)
    kd, ks, kc = (np.asarray(a) for a in JIK.intersect_batch(
        *[jnp.asarray(a) for a in args], **kw))
    td, ts, tc = _plain(args, **kw)
    L = sum(Ws[p] // BLK + 8 for p in groups[0][1]) * BLK
    assert td.shape == kd.shape == (8, L) and ts.shape == ks.shape
    np.testing.assert_array_equal(td, kd)
    np.testing.assert_array_equal(tc, kc)
    np.testing.assert_allclose(ts, ks, rtol=RTOL, atol=0)
    live = td != INF
    assert (ts[~live] <= -3.3e38).all() and live.any()
    np.testing.assert_array_equal(tc, live.sum(1))


@pytest.mark.parametrize("label,Ws,groups,k,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_raw_topk_matches_xla_impl(label, Ws, groups, k, extra):
    """The raw lanes merged with iter_topk give `_xla_impl`'s merged
    top-k: same docs, scores within rtol 1e-6, same counts."""
    args, dense = _inputs(label, Ws, extra)
    kw = dict(T=len(Ws), Ws=Ws, groups=groups, pivot_g=0, k=k, dense=dense)
    td, ts, tc = (torch.from_numpy(a) for a in _plain(args, raw=True, **kw))
    xd, xs, xc = (np.asarray(a) for a in JIK._xla_impl(
        *[jnp.asarray(a) for a in args], **kw))
    np.testing.assert_array_equal(tc.numpy(), xc)
    tv, tsel = TIK.iter_topk(ts, td, k)
    tdocs = torch.gather(td, 1, tsel).numpy()
    xv, xsel = JIK.iter_topk(jnp.asarray(xs), jnp.asarray(xd), k)
    xv, xsel = np.asarray(xv), np.asarray(xsel)
    live = xv > -3.3e38
    np.testing.assert_array_equal(tv.numpy() > -3.3e38, live)
    np.testing.assert_array_equal(tdocs[live],
                                  np.take_along_axis(xd, xsel, 1)[live])
    np.testing.assert_allclose(tv.numpy()[live], xv[live], rtol=RTOL,
                               atol=0)


def test_plain_chunks_large_batches():
    """A batch larger than one chunk gives the same rows as the rows run
    one by one (the chunk bound keeps [b, W] gathers small)."""
    Ws = (1024, 2048)
    groups = ((R, (0,)), (R, (1,)))
    rng = np.random.default_rng(3)
    args = _make_windows(rng, 12, Ws)
    kw = dict(T=2, Ws=Ws, groups=groups, k=16)
    whole = _plain(args, **kw)
    for b in (0, 5, 11):
        one = _plain([args[0][b:b + 1], args[1][b:b + 1]] + args[2:], **kw)
        for w, o in zip(whole, one):
            np.testing.assert_array_equal(w[b:b + 1], o)


def test_iter_topk_tie_order():
    """Ties break by the lowest flat lane, as the JAX iter_topk does; the
    multi-phase merge depends on it."""
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -3.4e38, 2.0, 0.5],
                       [5.0, 5.0, 5.0, 5.0, 1.0, 1.0, -3.4e38, -3.4e38],
                       [0.0, -1.0, 0.0, 7.0, 7.0, 0.0, 7.0, 0.0]],
                      np.float32)
    docs = np.arange(scores.size, dtype=np.int32).reshape(scores.shape)
    for k in (1, 3, 5, 6):
        tv, tsel = TIK.iter_topk(torch.from_numpy(scores),
                                 torch.from_numpy(docs), k)
        jv, jsel = JIK.iter_topk(jnp.asarray(scores), jnp.asarray(docs), k)
        jv, jsel = np.asarray(jv), np.asarray(jsel)
        live = jv > -3.3e38
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tsel.numpy()[live], jsel[live])
    _v, sel = TIK.iter_topk(torch.from_numpy(scores), torch.from_numpy(docs),
                            3)
    assert sel.tolist() == [[1, 2, 4], [0, 1, 2], [3, 4, 6]]


def test_device_routing(monkeypatch):
    """intersect_batch routes by the tensors' device: CPU tensors run
    intersect_plain, CUDA tensors the kernel launcher (never the plain
    version), any other device raises."""
    calls = []
    monkeypatch.setattr(TIK, "intersect_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(TIK, "_launch",
                        lambda *a, **k: calls.append("kernel"))
    kw = dict(T=2, Ws=(1024, 1024), groups=((R, (0,)), (R, (1,))))
    cuda_meta = types.SimpleNamespace(device=torch.device("cuda", 0))
    TIK.intersect_batch(cuda_meta, None, None, None, None, None, **kw)
    TIK.intersect_batch(torch.zeros((1, 6), dtype=torch.int32),
                        None, None, None, None, None, **kw)
    assert calls == ["kernel", "plain"]
    with pytest.raises(RuntimeError, match="no intersect kernel"):
        TIK.intersect_batch(torch.zeros((1, 6), device="meta"),
                            None, None, None, None, None, **kw)


def test_kernel_plan_descriptor_layout():
    """The static plan the CUDA kernel reads: counts, windows, pivots,
    group records and dense records at the offsets intersect.cu uses."""
    plan = TIK._plan_array(4, (2048, 2048, 8192, 8192),
                           ((R, (0, 1), -1), (R, (2,), 0), (N, (3,), -1)),
                           0, 16, ((N, 1, 2),))
    assert plan.dtype == np.int32 and plan.shape == (128,)
    assert plan[:6].tolist() == [4, 16, 0, 3, 1, 2]
    assert plan[6:10].tolist() == [2048, 2048, 8192, 8192]
    assert plan[14:16].tolist() == [0, 1]
    assert plan[22:27].tolist() == [R, -1, 2, 0, 1]
    assert plan[33:37].tolist() == [R, 0, 1, 2]
    assert plan[44:48].tolist() == [N, -1, 1, 3]
    assert plan[110:114].tolist() == [N, 1, 2, 12]
    assert plan[120] == 0


def test_kernel_plan_raw_flag():
    """Raw mode rides the same descriptor, flagged at intersect.cu's
    P_RAW; the output width is the sum of the pivot sections."""
    Ws = (2048, 8192, 2048)
    groups = ((R, (0, 1)), (N, (2,)))
    plan = TIK._plan_array(3, Ws, groups, 0, 16, (), raw=True)
    assert plan[120] == 1 and plan[:6].tolist() == [3, 16, 0, 2, 0, 2]
    assert TIK._raw_lanes(Ws, groups, 0) == (16 + 8 + 64 + 8) * BLK
