"""The port's batched group-by op against the JAX package, on the CPU.

`redisearch_tpu_torch.ops.groupby.groupby_aggregate_batch` takes its
plain version (`groupby_plain`) on CPU tensors; it is compared with
`redisearch_tpu.ops.groupby.groupby_aggregate_batch` both on the JAX CPU
fallback (segment sums) and with the Pallas kernel in interpret mode, on
random gid slots and values made with a seeded numpy generator.

Tolerances: counts are equal.  A sum (or sum of squares) agrees within
1e-5 of the group's sum of |v| (of v*v) against the segment-sum fallback
(both sum in f32, possibly in other orders), and within 2e-5 against the
Pallas kernel, whose bf16 two-term split keeps about 16 mantissa bits of
each value.  Integer-valued inputs whose group sums stay below 2^24 are
exact in every order and are compared exactly.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from redisearch_tpu.ops import groupby as JGB
from redisearch_tpu_torch.ops import groupby as TGB


def _inputs(seed, B, S, n, G, integer=False, p_skip=0.2):
    rng = np.random.default_rng(seed)
    gs = rng.integers(0, G, (B, S, n)).astype(np.int32)
    gs[rng.random((B, S, n)) < p_skip] = -1
    if integer:
        vs = rng.integers(1, 100, (B, S - 1, n)).astype(np.float32)
    else:
        vs = rng.normal(0.0, 100.0, (B, S - 1, n)).astype(np.float32)
    return gs, vs


def _abs_sums(gs, vs, G):
    """Per (query, op) the group sums of |v| and v*v, for the scaled
    tolerances."""
    B, S, _n = gs.shape
    out = {}
    for j in range(S - 1):
        g = gs[:, j + 1]
        a = np.zeros((B, G + 1))
        q = np.zeros((B, G + 1))
        for b in range(B):
            gg = np.where(g[b] >= 0, g[b], G)
            v = np.abs(vs[b, j].astype(np.float64))
            np.add.at(a[b], gg, np.where(g[b] >= 0, v, 0.0))
            np.add.at(q[b], gg, np.where(g[b] >= 0, v * v, 0.0))
        out[f"g.{j}.sum"] = a[:, :G]
        out[f"g.{j}.sumsq"] = q[:, :G]
    return out


def _plain(gs, vs, G, want_sumsq):
    res = TGB.groupby_aggregate_batch(torch.from_numpy(gs),
                                      torch.from_numpy(vs), G,
                                      want_sumsq=want_sumsq)
    return {k: v.numpy() for k, v in res.items()}


def _jax(gs, vs, G, want_sumsq):
    res = JGB.groupby_aggregate_batch(jnp.asarray(gs), jnp.asarray(vs), G,
                                      want_sumsq=want_sumsq)
    return {k: np.asarray(v) for k, v in res.items()}


def _assert_close(t, x, scale, rtol, exact=False):
    assert sorted(t) == sorted(x)     # jax.jit returns dicts key-sorted
    for k in x:
        assert t[k].shape == x[k].shape, k
        if k.endswith(".count") or exact:
            np.testing.assert_array_equal(t[k], x[k], err_msg=k)
        else:
            assert (np.abs(t[k] - x[k]) <= rtol * scale[k] + 1e-6).all(), k


CASES = [(1, 0, True), (7, 1, False), (7, 3, True), (300, 1, True),
         (1001, 2, False)]


@pytest.mark.parametrize("G,n_ops,want_sumsq", CASES,
                         ids=[f"G{c[0]}-ops{c[1]}-sq{int(c[2])}"
                              for c in CASES])
def test_plain_matches_jax_fallback(G, n_ops, want_sumsq):
    gs, vs = _inputs(G + n_ops, 3, 1 + n_ops, 2000, G)
    t = _plain(gs, vs, G, want_sumsq)
    x = _jax(gs, vs, G, want_sumsq)
    _assert_close(t, x, _abs_sums(gs, vs, G), 1e-5)
    assert t["g.None.count"].sum() > 0


@pytest.mark.parametrize("G,n_ops,want_sumsq", CASES[1:4],
                         ids=[f"G{c[0]}-ops{c[1]}-sq{int(c[2])}"
                              for c in CASES[1:4]])
def test_plain_matches_pallas_interpret(G, n_ops, want_sumsq):
    gs, vs = _inputs(3 * G + n_ops, 2, 1 + n_ops, 1500, G)
    JGB._INTERPRET = True
    jax.clear_caches()
    try:
        x = _jax(gs, vs, G, want_sumsq)
    finally:
        JGB._INTERPRET = False
        jax.clear_caches()
    t = _plain(gs, vs, G, want_sumsq)
    _assert_close(t, x, _abs_sums(gs, vs, G), 2e-5)


def test_integer_sums_exact():
    """Integer values whose group sums stay below 2^24 sum exactly."""
    gs, vs = _inputs(5, 4, 3, 3000, 50, integer=True)
    t = _plain(gs, vs, 50, True)
    x = _jax(gs, vs, 50, True)
    assert max(v.max() for v in t.values()) < 2 ** 24
    _assert_close(t, x, None, 0.0, exact=True)


def test_out_of_range_gids_are_dropped():
    """gids < 0 and >= G_pad count nowhere; gids in [G, G_pad) count in
    the padding (sliced off), as in the JAX package."""
    gs = np.array([[[-1, 0, 0, 5, 127, 128, 500]]], np.int32)
    vs = np.zeros((1, 0, 7), np.float32)
    t = _plain(gs, vs, 6, False)
    np.testing.assert_array_equal(t["g.None.count"],
                                  [[2, 0, 0, 0, 0, 1]])
    x = _jax(gs, vs, 6, False)
    np.testing.assert_array_equal(t["g.None.count"], x["g.None.count"])


def test_device_routing(monkeypatch):
    """CPU tensors run the plain version, CUDA tensors the kernel
    launcher (never the plain version), any other device raises."""
    calls = []
    monkeypatch.setattr(TGB, "groupby_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(TGB, "_launch",
                        lambda *a, **k: calls.append("kernel"))
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    TGB.groupby_aggregate_batch(cuda, None, 7)
    TGB.groupby_aggregate_batch(torch.zeros((1, 1, 4), dtype=torch.int32),
                                torch.zeros((1, 0, 4)), 7)
    assert calls == ["kernel", "plain"]
    with pytest.raises(RuntimeError, match="no groupby kernel"):
        TGB.groupby_aggregate_batch(torch.zeros((1, 1, 4), device="meta"),
                                    None, 7)


def test_kernel_layout_helpers():
    """The kernel's [B, C, G_pad] channel layout maps onto the JAX key
    naming; the shared-memory branch covers the bench shapes and the
    65,536-group space takes the global one."""
    assert TGB._g_pad(1001) == 1024 and TGB._g_pad(1) == 128
    assert TGB._channels(2, False) == 3 and TGB._channels(4, True) == 10
    out = torch.arange(2 * 7 * 128, dtype=torch.float32).reshape(2, 7, 128)
    d = TGB._to_dict(out, 3, 100, False)
    assert list(d) == ["g.None.count", "g.0.count", "g.0.sum", "g.1.count",
                       "g.1.sum"]
    assert torch.equal(d["g.1.sum"], out[:, 4, :100])
    assert 3 * 1024 * 4 <= TGB.SMEM_MAX < 65536 * 4


# ---------------------------------------------------------------------------
# single-query groupby_aggregate (kernels B4/B5) and its plain twin
# ---------------------------------------------------------------------------

def _single_inputs(seed, n, G, p_invalid=0.2, empty_every=3):
    """gids with out-of-range ids, invalid rows, and every
    `empty_every`-th group left empty."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-2, G + 3, n).astype(np.int32)
    g[(g >= 0) & (g % empty_every == 1)] = 0
    valid = rng.random(n) > p_invalid
    v = rng.normal(0.0, 50.0, n).astype(np.float32)
    return g, valid, v


def _single_plain(g, valid, v, G, mm=True):
    res = TGB.groupby_aggregate(torch.from_numpy(g), torch.from_numpy(valid),
                                torch.from_numpy(v), G, want_minmax=mm)
    return {k: x.numpy() for k, x in res.items()}


def _single_jax(g, valid, v, G, mm=True):
    res = JGB.groupby_aggregate(jnp.asarray(g), jnp.asarray(valid),
                                jnp.asarray(v), G, want_minmax=mm)
    return {k: np.asarray(x) for k, x in res.items()}


@pytest.mark.parametrize("G,n", [(1, 500), (7, 3000), (300, 5000),
                                 (1001, 9000)])
def test_plain_single_matches_jax_fallback(G, n):
    """Against the JAX CPU segment reductions: counts equal, sums within
    1e-5 of the group's sum of |v|, min/max equal on non-empty groups
    (the fallback leaves +-inf in empty ones; the twin the kernels'
    +-3.4e38)."""
    g, valid, v = _single_inputs(G, n, G)
    t = _single_plain(g, valid, v, G)
    x = _single_jax(g, valid, v, G)
    assert sorted(t) == sorted(x) == ["count", "max", "min", "sum", "sumsq"]
    np.testing.assert_array_equal(t["count"], x["count"])
    ok = valid & (g >= 0) & (g < G)
    gg = np.where(ok, g, G)
    absum = np.bincount(gg, np.abs(v).astype(np.float64), G + 1)[:G]
    sqsum = np.bincount(gg, (v.astype(np.float64)) ** 2, G + 1)[:G]
    assert (np.abs(t["sum"] - x["sum"]) <= 1e-5 * absum + 1e-6).all()
    assert (np.abs(t["sumsq"] - x["sumsq"]) <= 1e-5 * sqsum + 1e-6).all()
    live = t["count"] > 0
    np.testing.assert_array_equal(t["min"][live], x["min"][live])
    np.testing.assert_array_equal(t["max"][live], x["max"][live])
    if G > 1:
        assert (~live).any()
    assert (t["min"][~live] == 3.4e38).all()
    assert (t["max"][~live] == np.float32(-3.4e38)).all()


@pytest.mark.parametrize("G,n", [(7, 3000), (300, 9000)])
def test_plain_single_matches_pallas_interpret(G, n):
    """Against the Pallas B4/B5 in interpret mode (the tolerances of
    tests/test_pallas_interpret.py): counts rtol 1e-6, sums rtol 1e-4 /
    atol 1e-2, min/max rtol 1e-5, empty groups included."""
    g, valid, v = _single_inputs(3 * G, n, G)
    JGB._INTERPRET = True
    jax.clear_caches()
    try:
        x = _single_jax(g, valid, v, G)
    finally:
        JGB._INTERPRET = False
        jax.clear_caches()
    t = _single_plain(g, valid, v, G)
    np.testing.assert_allclose(t["count"], x["count"], rtol=1e-6)
    np.testing.assert_allclose(t["sum"], x["sum"], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(t["sumsq"], x["sumsq"], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(t["min"], x["min"], rtol=1e-5)
    np.testing.assert_allclose(t["max"], x["max"], rtol=1e-5)
    assert (t["count"] == 0).any()


def test_plain_single_nan_and_signed_zero():
    """A NaN value makes its group's min and max NaN, as the JAX CPU
    reductions give; -0.0 and 0.0 compare equal."""
    g = np.array([0, 0, 1, 1, 2, 2], np.int32)
    v = np.array([1.0, np.nan, -0.0, 0.0, 3.0, -2.0], np.float32)
    valid = np.ones(6, bool)
    t = _single_plain(g, valid, v, 3)
    x = _single_jax(g, valid, v, 3)
    for k in ("min", "max", "sum"):
        np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(x[k]))
        ok = ~np.isnan(x[k])
        assert (t[k][ok] == x[k][ok]).all(), k
    assert np.isnan(t["min"][0]) and np.isnan(t["max"][0])


def test_single_without_minmax_and_constant_values():
    """want_minmax=False returns the three sums; a 0-dim value (an APPLY
    constant) broadcasts over the rows."""
    g, valid, _v = _single_inputs(5, 400, 9)
    res = TGB.groupby_aggregate(torch.from_numpy(g), torch.from_numpy(valid),
                                torch.tensor(2.0), 9, want_minmax=False)
    assert sorted(res) == ["count", "sum", "sumsq"]
    np.testing.assert_array_equal(res["sum"].numpy(),
                                  2.0 * res["count"].numpy())


def test_single_device_routing(monkeypatch):
    """Both single-query entries: CPU tensors run their plain twins, CUDA
    tensors the fused kernel's launcher (never a plain twin), any other
    device raises."""
    calls = []
    for name in ("groupby_aggregate_plain", "groupby_aggregate_multi_plain"):
        monkeypatch.setattr(TGB, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(TGB, "_launch_single",
                        lambda *a, **k: calls.append("single kernel"))
    monkeypatch.setattr(TGB, "_launch_multi",
                        lambda *a, **k: calls.append("multi kernel"))
    monkeypatch.setattr(TGB, "_single_dict", lambda *a: {})
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu = torch.zeros(4, dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.bool)
    TGB.groupby_aggregate(cuda, None, None, 7)
    TGB.groupby_aggregate(cpu, ones, torch.zeros(4), 7)
    TGB.groupby_aggregate_multi(cuda, None, [], 7)
    TGB.groupby_aggregate_multi(cpu, ones, [], 7)
    assert calls == ["single kernel", "groupby_aggregate_plain",
                     "multi kernel", "groupby_aggregate_multi_plain"]
    meta = torch.zeros(4, device="meta")
    for fn in (lambda: TGB.groupby_aggregate(meta, None, None, 7),
               lambda: TGB.groupby_aggregate_multi(meta, None, [], 7)):
        with pytest.raises(RuntimeError, match="no groupby kernel"):
            fn()


def test_single_launch_geometry():
    """The fused kernel's geometry: a window of at most 2,048 rows is one
    block (one pass); a larger one one block per 2,048 rows, at most one
    per SM, whose partials a second pass merges.  A warp holds its [C,
    G_pad] histogram, a tag byte per group and 32 staging words: the `*`
    window (1M rows, G = 1,001, base + one operand: 4 channels) is 132
    blocks of 13 warps (2.2 MB of partials), the MIN/MAX request's 6
    channels fit 8 warps; group spaces where fewer than 4 warps fit (G =
    16,384 / 65,536) take the global branch.  A call launches one kernel
    (one block), two (with the merge pass) or three (the global branch's
    init, rows and decode), and counts each."""
    g = TGB._single_geometry
    k = TGB._single_kernels
    assert k(*g(2048, 6, 1024)[::3]) == 1
    assert k(*g(8192, 6, 1024)[::3]) == 2
    assert k(*g(1_000_064, 4, 1024)[::3]) == 2
    assert k(*g(1000, 6, 65536)[::3]) == 3
    assert k(*g(65536, 6, 65536)[::3]) == 3
    assert TGB._single_channels(1, False) == 4
    assert TGB._single_channels(1, True) == 6
    assert TGB._single_channels(3, True, has_base=False) == 15
    assert g(1000, 6, 1024) == (1, 4, 1000, True)
    assert g(2048, 6, 1024) == (1, 8, 2048, True)
    assert g(8192, 6, 1024) == (4, 8, 2048, True)
    assert g(131072, 6, 1024) == (64, 8, 2048, True)
    assert g(1_000_064, 4, 1024) == (132, 13, 7577, True)
    assert g(1_000_064, 4, 128) == (132, 16, 7577, True)
    assert g(0, 6, 1024) == (1, 4, 1, True)
    assert g(1_000_064, 4, 16384) == (132, 8, 7577, False)
    assert g(65536, 6, 65536) == (32, 8, 2048, False)
    # the largest histograms of the shared branch: 4 warps
    assert g(9000, 16, 768) == (5, 4, 1800, True)
    assert g(9000, 16, 896) == (5, 8, 1800, False)
    assert g(9000, 6, 2304)[1:] == (4, 1800, True)
    assert g(9000, 6, 2432)[1:] == (8, 1800, False)


def test_single_lane_args():
    """The launcher's operand columns: a contiguous [n] column is passed
    as it is (step 1); a 0-dim constant or a stride-0 expansion (`_lanes`'
    APPLY constant) as its one element (step 0), never materialised;
    other shapes raise.  The [C, G_pad] channels map onto the JAX keys."""
    dev = torch.device("cpu")
    col = torch.arange(5, dtype=torch.float32)
    t, step = TGB._lane_arg(col, torch.float32, 5, dev, "v")
    assert step == 1 and t.data_ptr() == col.data_ptr()
    for const in (torch.tensor(2.5), torch.tensor(2.5).expand(5)):
        t, step = TGB._lane_arg(const, torch.float32, 5, dev, "v")
        assert step == 0 and t.shape == (1,) and float(t[0]) == 2.5
    t, step = TGB._lane_arg(torch.tensor(True).expand(5), torch.bool, 5,
                            dev, "p")
    assert step == 0 and t.dtype == torch.bool and bool(t[0])
    with pytest.raises(ValueError, match="shape"):
        TGB._lane_arg(torch.zeros(4), torch.float32, 5, dev, "v")
    out = torch.arange(11 * 128, dtype=torch.float32).reshape(11, 128)
    d = TGB._single_dict(out, 2, 100, True)
    assert list(d) == ["g.None.count"] + [
        f"g.{j}.{s}" for j in range(2)
        for s in ("count", "sum", "sumsq", "min", "max")]
    assert torch.equal(d["g.1.min"], out[9, :100])
    assert list(TGB._single_dict(out[:7], 2, 100, False))[-1] == "g.1.sumsq"


# ---------------------------------------------------------------------------
# fused single-query entry `groupby_aggregate_multi` and its plain twin
# ---------------------------------------------------------------------------

def _multi_inputs(seed, n, G, n_ops, const=False, nan=True):
    """gid with out-of-range ids, invalid rows, every third group empty;
    per operand its own presence, normal values with -0.0s (and one NaN
    per operand); with `const` the last operand is a 0-dim constant (an
    APPLY constant) present everywhere."""
    g, valid, _v = _single_inputs(seed, n, G)
    rng = np.random.default_rng(seed + 1)
    ops = []
    for j in range(n_ops):
        if const and j == n_ops - 1:
            ops.append((np.float32(-2.5), np.bool_(True)))
            continue
        v = rng.normal(0.0, 50.0, n).astype(np.float32)
        v[rng.random(n) < 0.05] = -0.0
        p = rng.random(n) > 0.3
        if nan:     # in a counted row
            v[np.flatnonzero(valid & p & (g >= 0) & (g < G))[j]] = np.nan
        ops.append((v, p))
    return g, valid, ops


def _multi_plain(g, valid, ops, G, mm):
    res = TGB.groupby_aggregate_multi(
        torch.from_numpy(g), torch.from_numpy(valid),
        [(torch.tensor(v), torch.tensor(p)) for v, p in ops], G,
        want_minmax=mm)
    return {k: x.numpy() for k, x in res.items()}


def _multi_jax(g, valid, ops, G, mm):
    """The JAX package's entry once for the base and once per operand,
    the constant broadcast to the rows."""
    n = len(g)
    res = {"g.None.count": _single_jax(g, valid, np.zeros(n, np.float32), G,
                                       False)["count"]}
    for j, (v, p) in enumerate(ops):
        st = _single_jax(g, valid & np.broadcast_to(p, (n,)),
                         np.broadcast_to(v, (n,)).astype(np.float32), G, mm)
        res.update({f"g.{j}.{k}": x for k, x in st.items()})
    return res


def _abs_scale(g, valid, ops, G):
    """Per operand the group sums of |v| and v*v (float64), NaNs as 0."""
    n = len(g)
    out = {}
    for j, (v, p) in enumerate(ops):
        ok = valid & np.broadcast_to(p, (n,)) & (g >= 0) & (g < G)
        vv = np.nan_to_num(np.broadcast_to(v, (n,)).astype(np.float64))
        gg = np.where(ok, g, G)
        out[f"g.{j}.sum"] = np.bincount(gg, np.abs(vv), G + 1)[:G]
        out[f"g.{j}.sumsq"] = np.bincount(gg, vv * vv, G + 1)[:G]
    return out


MULTI_CASES = [(1, 0, False), (1, 2, False), (7, 1, False), (7, 3, True),
               (1001, 2, True), (1001, 3, False)]


@pytest.mark.parametrize("G,n_ops,const", MULTI_CASES,
                         ids=[f"G{c[0]}-ops{c[1]}{'-const' * c[2]}"
                              for c in MULTI_CASES])
def test_multi_plain_matches_jax_fallback(G, n_ops, const):
    """groupby_aggregate_multi_plain against the JAX `groupby_aggregate`
    on its CPU segment reductions, operand by operand: counts equal, sums
    within 1e-5 of the group's sum of |v| (of v*v), min/max equal on
    non-empty groups, NaN in the same places (a NaN value makes its
    group's sums, min and max NaN); -0.0 equals 0.0."""
    g, valid, ops = _multi_inputs(10 * G + n_ops, 3000, G, n_ops, const)
    for mm in (False, True):
        t = _multi_plain(g, valid, ops, G, mm)
        x = _multi_jax(g, valid, ops, G, mm)
        assert list(t) == list(TGB._single_dict(
            torch.zeros(TGB._single_channels(n_ops, mm), 128), n_ops, G,
            mm))
        assert sorted(t) == sorted(x)
        scale = _abs_scale(g, valid, ops, G)
        for k in x:
            np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(x[k]),
                                          err_msg=k)
            ok = ~np.isnan(x[k])
            if k.endswith(".count"):
                np.testing.assert_array_equal(t[k], x[k], err_msg=k)
            elif k.endswith(("min", "max")):
                live = ok & (t[k.rsplit(".", 1)[0] + ".count"] > 0)
                np.testing.assert_array_equal(t[k][live], x[k][live],
                                              err_msg=k)
                empty = t[k.rsplit(".", 1)[0] + ".count"] == 0
                assert (np.abs(t[k][empty]) == np.float32(3.4e38)).all()
            else:
                assert (np.abs(t[k][ok] - x[k][ok])
                        <= 1e-5 * scale[k][ok] + 1e-6).all(), k
    assert t["g.None.count"].sum() > 0
    if n_ops and not const:
        assert np.isnan(t["g.0.min"]).any()


@pytest.mark.parametrize("G,n_ops,const", [(7, 2, True), (1001, 1, False)],
                         ids=["G7-ops2-const", "G1001-ops1"])
def test_multi_plain_matches_pallas_interpret(G, n_ops, const):
    """Against the Pallas B4/B5 in interpret mode, operand by operand
    (the tolerances of test_plain_single_matches_pallas_interpret); no
    NaN, which the Pallas sums spread across a 128-group tile through
    their one-hot products."""
    g, valid, ops = _multi_inputs(5 * G, 1500, G, n_ops, const, nan=False)
    JGB._INTERPRET = True
    jax.clear_caches()
    try:
        x = _multi_jax(g, valid, ops, G, True)
    finally:
        JGB._INTERPRET = False
        jax.clear_caches()
    t = _multi_plain(g, valid, ops, G, True)
    assert sorted(t) == sorted(x)
    for k in x:
        if k.endswith(".count"):
            np.testing.assert_allclose(t[k], x[k], rtol=1e-6, err_msg=k)
        elif k.endswith(("sum", "sumsq")):
            np.testing.assert_allclose(t[k], x[k], rtol=1e-4, atol=1e-2,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(t[k], x[k], rtol=1e-5, err_msg=k)
    assert (t["g.None.count"] == 0).any()


# groups of signed zeros: (values in row order); min and max as the JAX
# package gives them, IEEE-754 minimum/maximum order (-0.0 below +0.0)
# whatever the rows' order
SIGNED_ZERO_GROUPS = [
    ([-0.0], -0.0, -0.0),
    ([-0.0, -0.0, -0.0], -0.0, -0.0),
    ([-0.0, 0.0], -0.0, 0.0),
    ([0.0, -0.0], -0.0, 0.0),
    ([0.0, -0.0, 0.0, -0.0], -0.0, 0.0),
    ([0.0, 0.0], 0.0, 0.0),
    ([-0.0, 2.0], -0.0, 2.0),
    ([-3.0, -0.0], -3.0, -0.0),
]


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jax-fallback", "pallas-interpret"])
@pytest.mark.parametrize("entry", ["multi", "single"])
def test_signed_zero_minmax_matches_jax(interpret, entry):
    """A group of only -0.0 reads -0.0 for min and max, one of -0.0 and
    +0.0 min -0.0 and max +0.0 in either row order: the JAX package's
    `groupby_aggregate` (CPU fallback and the Pallas kernel in interpret
    mode) and the port's plain versions, sign bits compared (`==` holds
    -0.0 equal to 0.0).  The card's fused kernel orders the raw bits the
    same way (csrc/groupby.cu `f2code`)."""
    g = np.concatenate([np.full(len(v), i, np.int32)
                        for i, (v, _lo, _hi) in enumerate(SIGNED_ZERO_GROUPS)])
    v = np.concatenate([np.array(v, np.float32)
                        for v, _lo, _hi in SIGNED_ZERO_GROUPS])
    valid = np.ones(len(g), bool)
    G = len(SIGNED_ZERO_GROUPS)
    JGB._INTERPRET = interpret
    jax.clear_caches()
    try:
        x = _single_jax(g, valid, v, G)
    finally:
        JGB._INTERPRET = False
        jax.clear_caches()
    if entry == "multi":
        t = _multi_plain(g, valid, [(v, np.ones(len(g), bool))], G, True)
        t = {k: t[f"g.0.{k}"] for k in ("min", "max")}
    else:
        t = _single_plain(g, valid, v, G)
    lo = np.array([c[1] for c in SIGNED_ZERO_GROUPS], np.float32)
    hi = np.array([c[2] for c in SIGNED_ZERO_GROUPS], np.float32)
    for got in (x, t):
        for key, want in (("min", lo), ("max", hi)):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
            np.testing.assert_array_equal(np.signbit(got[key]),
                                          np.signbit(want), err_msg=key)
