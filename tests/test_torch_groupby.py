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
