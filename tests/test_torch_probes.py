"""The port's probe kernels (`redisearch_tpu_torch/bench/probes.py`)
against the TPU probe scripts of `benchmarks/`, on the CPU.

Each script (gstep_probe, gstep_probe2, grid_floor_probe, kernel_probe)
runs its own `main()` as it stands, under `jax.disable_jit()`, with
`pl.pallas_call` patched: every call runs in interpret mode, each
distinct call (script, kernel, static keywords, input shapes) is
recorded once with its inputs and outputs, and each repeat (the
scripts' timing loops) is answered with the recorded output.
kernel_probe's calls of the JAX B1 (`_kernel`) are answered with zeros
of their out_shape: B1 is pinned by test_torch_intersect.py.  Then each
recorded input goes through the port's wrapper on the CPU (its plain
version) and must give the recorded output: exactly, but gstep's lanes
within 2 (its f32 sum is truncated to int32 after a sum whose order
differs; the TPU script's own check) and kernel_probe's phase scores
within 1e-6 relative (XLA's CPU code may contract BM25's f32 operations
differently; on the card the kernel equals the plain version bit for
bit, as chip_smoke.py holds it).  Cases the probes' inputs do not reach
run the recorded JAX kernels again on changed inputs.  While the
scripts run, `jnp.roll` is numpy's: the same values, where JAX's roll,
run op by op under `disable_jit`, takes about 13 ms a call and the
scripts' timing loops make 624 calls (the fixture took 22 s with it,
16 s without); the rolled metas feed only those loops, whose repeats
are answered from the record.
"""

import contextlib
import functools
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from redisearch_tpu.ops import intersect as JIK
from redisearch_tpu_torch.bench import grid_floor_probe as GF
from redisearch_tpu_torch.bench import probes as P

SCRIPTS = ("gstep_probe", "gstep_probe2", "grid_floor_probe",
           "kernel_probe")
PROBE_B = 16              # grid_floor_probe's B (PROBE_B); G up to 16
GSTEP_B = 64              # gstep_probe's B
VARIANT_WS = ((2048, 8192), (8192, 32768))

#: every distinct pallas_call of the four scripts: (script, kernel,
#: static keywords); each must be recorded
CASES = (
    [("gstep_probe", "kern", (("G", G), ("rows", 64))) for G in (1, 2, 4, 8)]
    + [("gstep_probe2", "kern", (("G", G),)) for G in (1, 4)]
    + [("grid_floor_probe", n, ()) for n in ("cur_kernel", "curany_kernel",
                                              "fused_kernel")]
    + [("grid_floor_probe", "g_kernel", (("G", G),)) for G in (4, 8, 16)]
    + [("grid_floor_probe", "gdma_kernel", (("G", G), ("rows", r)))
       for r in ((24, 72), (72, 264)) for G in (4, 8)]
    + [("kernel_probe", "variant_kernel",
        (("T", 2), ("Ws", Ws), ("k", 16), ("mode", m)))
       for Ws in VARIANT_WS for m in ("empty", "dma", "phase")])


def _case_id(case):
    script, name, kws = case
    return "-".join([script, name] + [f"{k}={v}" for k, v in kws])


def _key(script, kernel):
    kws = ()
    if isinstance(kernel, functools.partial):
        kws = tuple(sorted(kernel.keywords.items()))
        kernel = kernel.func
    return script, kernel.__name__, kws


@pytest.fixture(scope="module")
def captured():
    """{(script, kernel, keywords): {"call", "inputs", "outputs"}} from
    the four scripts' own runs; "call" runs the kernel again in
    interpret mode on new inputs.  Also the scripts' printed reports."""
    real = pl.pallas_call
    rec, state = {}, {}

    def patched(kernel, *a, **kw):
        kw = dict(kw, interpret=True)
        key = _key(state["script"], kernel)

        def call(*args):
            shapes = tuple(np.shape(x) for x in args)
            got = rec.get(key)
            if got is not None and got["shapes"] == shapes:
                return got["jax_out"]
            if key[1] == "_kernel":       # the JAX B1: pinned elsewhere
                out = [jnp.zeros(s.shape, s.dtype) for s in kw["out_shape"]]
            else:
                out = real(kernel, *a, **kw)(*args)
            rec[key] = dict(
                shapes=shapes, jax_out=out,
                call=lambda *xs: real(kernel, *a, **kw)(*xs),
                inputs=[np.asarray(x) for x in args],
                outputs=[np.asarray(o) for o in out])
            return out
        return call

    gstep = importlib.import_module("benchmarks.gstep_probe")
    reports = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", patched)
        mp.setattr(jnp, "roll", _np_roll)
        mp.setattr(JIK, "_INTERPRET", True)
        mp.setattr(gstep, "B", GSTEP_B)
        mp.setenv("PROBE_B", str(PROBE_B))
        jax.clear_caches()
        try:
            with jax.disable_jit():
                for script in SCRIPTS:
                    state["script"] = script
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        importlib.import_module(f"benchmarks.{script}").main()
                    reports[script] = buf.getvalue()
        finally:
            jax.clear_caches()
    rec["reports"] = reports
    return rec


def _np_roll(a, shift, axis=None):
    """jnp.roll's values, by numpy."""
    return jnp.asarray(np.roll(np.asarray(a), shift, axis))


def _rerun(rec, *inputs):
    """The recorded JAX kernel on new inputs, as the script ran it."""
    with jax.disable_jit():
        return [np.asarray(o) for o in rec["call"](
            *[jnp.asarray(x) for x in inputs])]


def _port(case, inputs):
    """The port's wrapper on the recorded inputs (CPU: plain versions)."""
    script, name, kws = case
    kw = dict(kws)
    t = [torch.from_numpy(np.array(x)) for x in inputs]
    if script == "gstep_probe":
        return P.probe_gwin(*t, rows=(kw["rows"],), G=kw["G"])
    if script == "gstep_probe2":
        return P.probe_gcols(*t, G=kw["G"])
    if name == "cur_kernel":
        return P.probe_floor(t[0], layout="cur", fmeta=t[1])
    if name == "curany_kernel":
        return P.probe_floor(t[0], layout="cur", fmeta=t[1],
                             anys=tuple(t[2:]))
    if name in ("fused_kernel", "g_kernel"):
        return P.probe_floor(t[0], G=kw.get("G", 1))
    if name == "gdma_kernel":
        return P.probe_gwin(*t, rows=kw["rows"], G=kw["G"])
    meta, fmeta, *arrays = t
    return P.probe_variant(meta, fmeta.reshape(meta.shape[0], -1), *arrays,
                           Ws=kw["Ws"], k=kw["k"],
                           mode={"dma": "load"}.get(kw["mode"], kw["mode"]))


def _outs(x):
    return [o.numpy() for o in (x if isinstance(x, (tuple, list)) else [x])]


def _assert_matches(case, got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    if case[0] == "gstep_probe":
        # the truncated f32 sum: the TPU script's tolerance
        diff = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))
        assert diff.max() <= 2, diff.max()
    elif case[1] == "variant_kernel":
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[2], want[2])
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_scripts_validate_themselves(captured):
    """gstep and gstep2 check their kernel against numpy: bad=0 at every
    G; every distinct call of the four scripts was recorded."""
    rep = captured["reports"]
    for G in (1, 2, 4, 8):
        assert f"G={G}: bad=0" in rep["gstep_probe"]
    for G in (1, 4):
        assert f"G={G}: bad=0" in rep["gstep_probe2"]
    assert "g8dma Wp= 8192 Wm= 32768" in rep["grid_floor_probe"]
    assert "full" in rep["kernel_probe"]
    keys = {k for k in captured if k != "reports"}
    assert set(CASES) <= keys, set(CASES) - keys
    assert {k[1] for k in keys - set(CASES)} == {"_kernel"}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_jax_probe(captured, case):
    rec = captured[case]
    _assert_matches(case, _outs(_port(case, rec["inputs"])), rec["outputs"])


def test_gstep_live_offsets_and_unaligned_starts(captured):
    """meta[q, 1] past the window (no live lane), at its last lane,
    negative (every lane live); window starts at start % 128 != 0
    (the row is start // 128 in both)."""
    case = CASES[1]                                       # G = 2
    rec = captured[case]
    meta, d, f = (x.copy() for x in rec["inputs"])
    B = meta.shape[0]
    meta[:, 0] += np.arange(B, dtype=np.int32) * 37 % 128
    meta[0::4, 1] = 64 * 128 + 5            # past the 8,192-lane window
    meta[1::4, 1] = 64 * 128 - 1            # the last lane only
    meta[2::4, 1] = -3
    want = _rerun(rec, meta, d, f)
    assert (want[0][0::4] == 0).all()
    _assert_matches(case, _outs(_port(case, (meta, d, f))), want)


def test_gcols_unaligned_starts(captured):
    case = CASES[5]                                       # G = 4
    rec = captured[case]
    meta, d = (x.copy() for x in rec["inputs"])
    meta[:, 0] += 1 + np.arange(meta.shape[0], dtype=np.int32) % 127
    _assert_matches(case, _outs(_port(case, (meta, d))),
                    _rerun(rec, meta, d))


def test_gdma_random_windows(captured):
    """The script's d2 is all zeros, so a wrong column max passes there:
    random d (negative values too) and f, windows at unaligned starts."""
    case = ("grid_floor_probe", "gdma_kernel", (("G", 4), ("rows", (24, 72))))
    rec = captured[case]
    meta, d2, f2 = (x.copy() for x in rec["inputs"])
    rng = np.random.default_rng(3)
    d2 = rng.integers(-2**30, 2**30, d2.shape, dtype=np.int32)
    f2 = rng.normal(size=f2.shape).astype(np.float32)
    meta[:, :2] += rng.integers(0, 128, (meta.shape[0], 2), dtype=np.int32)
    want = _rerun(rec, meta, d2, f2)
    assert len(np.unique(want[0])) > meta.shape[0]
    _assert_matches(case, _outs(_port(case, (meta, d2, f2))), want)


def test_variant_short_pivots_and_offsets(captured):
    """Pivots with fewer than 16 valid lanes (lengths 0-15, or a qmask
    that meets no mask) and window starts at start % 128 != 0.  Slots
    past the valid lanes follow the port's B1 convention, INT32_MAX /
    NEG_INF (ROADMAP §C): the JAX probe repeats its lowest NEG_INF lane
    there, whose doc may be real.  Its scores there are NEG_INF too; the
    valid slots must agree."""
    case = ("kernel_probe", "variant_kernel",
            (("T", 2), ("Ws", VARIANT_WS[0]), ("k", 16), ("mode", "phase")))
    rec = captured[case]
    meta, fmeta, *arrays = (x.copy() for x in rec["inputs"])
    B = meta.shape[0]
    q = np.arange(B)
    meta[:, 0] += (q * 29 % 128).astype(np.int32)      # rr = start % 128
    meta[0::3, 2] = (q[0::3] % 16).astype(np.int32)   # 0-15 lanes in range
    meta[1::6, 4] = 4                                  # no mask meets 4
    want = _rerun(rec, meta, fmeta, *arrays)
    got = _outs(_port(case, (meta, fmeta, *arrays)))
    n_valid = np.where(q % 6 == 1, 0,
                       np.where(q % 3 == 0, q % 16, meta[:, 2]))
    n_valid = np.minimum(n_valid, 16)
    assert (n_valid < 16).sum() > B // 3
    slot = np.arange(128)[None, :]
    held = slot < n_valid[:, None]
    g_docs, g_scores = got[0][:, 0], got[1][:, 0]
    w_docs, w_scores = want[0][:, 0], want[1][:, 0]
    np.testing.assert_array_equal(g_docs[held], w_docs[held])
    np.testing.assert_allclose(g_scores[held], w_scores[held], rtol=1e-6,
                               atol=0)
    neg = np.float32(P.NEG_INF)
    assert (g_docs[~held] == P.INT32_MAX).all()
    assert (g_scores[~held] == neg).all()
    assert (w_scores[~held] == neg).all()
    assert (got[2] == 0).all()


#: grid_floor_probe's calls and the port's arm that stands for each (the
#: gdma rows (24, 72) are (Wp, Wm) = (2048, 8192), (72, 264) (8192, 32768))
GRID_FLOOR_ARMS = (
    [(("grid_floor_probe", n, ()), a) for n, a in (
        ("cur_kernel", "cur"), ("curany_kernel", "curany"),
        ("fused_kernel", "fused"))]
    + [(("grid_floor_probe", "g_kernel", (("G", G),)), f"g{G}")
       for G in (4, 8, 16)]
    + [(("grid_floor_probe", "gdma_kernel", (("G", G), ("rows", r))),
        f"g{G}dma Wp={Wp} Wm={Wm} {arm}")
       for (Wp, Wm), r in zip(VARIANT_WS, ((24, 72), (72, 264)))
       for G in (4, 8) for arm in ("staged", "direct")])


@pytest.mark.parametrize("case,arm", GRID_FLOOR_ARMS,
                         ids=[f"{_case_id(c)}-{a.split()[-1]}"
                              for c, a in GRID_FLOOR_ARMS])
def test_grid_floor_port_reads_probe_b(captured, case, arm, monkeypatch):
    """The port's grid_floor script reads PROBE_B as the TPU script does:
    with PROBE_B = 16 set (G = 4, 8 and 16 a block), its meta is the one
    the TPU script drew (which its timing loop rolls by a row or more
    before the recorded call), and each arm's plain version gives what
    the TPU kernel gave on the recorded meta."""
    monkeypatch.setenv("PROBE_B", str(PROBE_B))
    rec = captured[case]
    (meta, arms), = GF.arms("cpu")
    want = rec["inputs"][0]
    assert meta.shape == want.shape == (PROBE_B, 8)
    assert any(np.array_equal(np.roll(meta.numpy(), i, 0), want)
               for i in range(PROBE_B)), "not the TPU script's meta"
    if case[1] == "gdma_kernel":        # the script's arrays: zeros
        assert not rec["inputs"][1].any() and not rec["inputs"][2].any()
    got = {a.name: a for a in arms}[arm]
    assert got.B == PROBE_B
    _assert_matches(case, _outs(got.plain(torch.from_numpy(want))),
                    rec["outputs"])


@pytest.mark.parametrize("B", [64, 512, 8192])
def test_grid_floor_b_argument_equals_probe_b(B, monkeypatch):
    """`B=` gives what PROBE_B gives, and wins over it; without either
    the TPU script's 512."""
    monkeypatch.delenv("PROBE_B", raising=False)
    assert GF.probe_b() == 512
    monkeypatch.setenv("PROBE_B", str(B))
    env = GF.inputs("cpu")
    arg = GF.inputs("cpu", B=B)
    monkeypatch.setenv("PROBE_B", "32")
    won = GF.inputs("cpu", B=B)
    assert env[0].shape == (B, 8)
    for x, y, z in zip(env, arg, won):
        assert torch.equal(x, y) and torch.equal(x, z)
    names = [[a.name for a in arms] for _m, arms in GF.arms("cpu", B=B)]
    monkeypatch.setenv("PROBE_B", str(B))
    assert names == [[a.name for a in arms] for _m, arms in GF.arms("cpu")]


@pytest.mark.parametrize("which", ["gwin", "gwin2", "gcols", "floor",
                                   "floor-cur"])
def test_b_not_a_multiple_of_g_raises(which):
    meta = torch.zeros((10, 8), dtype=torch.int32)
    d = torch.zeros((600, P.BLK), dtype=torch.int32)
    f = torch.zeros((600, P.BLK), dtype=torch.float32)
    with pytest.raises(ValueError):
        if which == "gwin":
            P.probe_gwin(meta[:, :2], d, f, rows=(64,), G=4)
        elif which == "gwin2":
            P.probe_gwin(meta, d, f, rows=(24, 72), G=3)
        elif which == "gcols":
            P.probe_gcols(meta[:, :2], d, G=4)
        elif which == "floor":
            P.probe_floor(meta, G=16)
        else:
            P.probe_floor(meta, layout="cur", G=2,
                          fmeta=torch.ones((10, 1, 3)))


def test_entry_points_need_a_card(monkeypatch):
    """Without a card the entry points raise, unless the caller passes
    device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.main(["gstep2"])
    gstep2 = importlib.import_module("redisearch_tpu_torch.bench.gstep_probe2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gstep2.main()


@pytest.mark.parametrize("which", sorted(P.SCRIPTS))
def test_port_scripts_run_on_cpu(which, capsys):
    """Each port script at its own sizes on the CPU: every arm against
    its plain version (`bad=0`), nothing timed."""
    res = P.main([which], device="cpu")
    assert res and all(r["bad"] == 0 for r in res)
    out = capsys.readouterr().out
    assert "bad=0" in out and "not measured" in out


def test_compare_flags_nan_lanes():
    """A lane that is NaN in the kernel's output but finite in the plain
    version's is a bad query with an infinite error; NaN on both sides,
    or the same infinity, is equal."""
    ref = torch.zeros((4, 1, P.BLK), dtype=torch.float32)
    out = ref.clone()
    out[2, 0, 7] = float("nan")
    assert P.compare(out, ref) == (1, float("inf"))
    assert P.compare((ref, out), (ref, ref), tol=2) == (1, float("inf"))
    both = ref.clone()
    both[1, 0, 3] = float("nan")
    both[3, 0, 0] = float("-inf")
    assert P.compare(both, both.clone()) == (0, 0.0)
    off = ref.clone()
    off[0, 0, 1] = 3.0
    assert P.compare(off, ref, tol=2) == (1, 3.0)
    assert P.compare(off, ref, tol=3) == (0, 3.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounds_count_distinct_rows(seed):
    """The probes' bytes bounds read each row their windows touch once:
    `rows_touched` against a numpy union of the clamped windows, and
    windows shared by several queries counted once."""
    rng = np.random.default_rng(seed)
    n_rows, B = 300, 40
    meta = torch.from_numpy(rng.integers(-200, 320 * P.BLK, (B, 2),
                                         dtype=np.int32))
    wins = [(0, 24), (1, 72)]
    seen = np.zeros(n_rows, bool)
    for c, R in wins:
        for v in meta[:, c].tolist():
            r0 = min(max(v // P.BLK, 0), n_rows - R)
            seen[r0:r0 + R] = True
    assert P.rows_touched(meta, wins, n_rows) == int(seen.sum())
    same = meta[:1].expand(B, 2).contiguous()
    assert P.rows_touched(same, [(0, 24)], n_rows) == 24
    lanes = torch.tensor([5, 10, 100]), torch.tensor([10, 0, 7])
    assert P.covered(*lanes, 106) == 10 + 6
