"""The Hopper kernel probes: the port's counterparts of the four TPU
probe scripts in `benchmarks/` (gstep_probe.py, gstep_probe2.py,
kernel_probe.py, grid_floor_probe.py), which split the cost of B1's
grid step on the TPU into its floor, its window copies, its phase work
and G queries a step.  `benchmarks/` stays the TPU reference.

    python3 -m redisearch_tpu_torch.bench.probes [gstep|gstep2|kernel|grid_floor|all]
    python3 -m redisearch_tpu_torch.bench.probes gstep2|grid_floor B

runs the port's scripts (`bench/gstep_probe.py`, `gstep_probe2.py`,
`kernel_probe.py`, `grid_floor_probe.py`) on the card: each arm's
output against its plain version (`bad=`), its device us a query (CUDA
events around 20 calls enqueued while the card sleeps) and its wall us
a query (host clock around 8 calls ending in a synchronize, best of 3).
gstep2 and grid_floor also run at another batch B (as B1's 8,192).
Without a card it raises; from Python, `main(device="cpu")` of a script
runs the plain versions and times nothing.

Four kernels in `csrc/probes.cu` cover the scripts' eight Pallas
functions.  Each has its wrapper and its plain torch version here, side
by side.  A wrapper checks device, dtype, shape and contiguity; a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (on
the current stream, outputs from `torch.empty`) or raises.  Each launch
adds one to the kernel's count (`FLOOR_LAUNCHES`, `GWIN_LAUNCHES`,
`GCOLS_LAUNCHES`, `VARIANT_LAUNCHES`: plain ints, callers reset them).
Where the TPU grid assumes B % G == 0, the wrapper raises otherwise.
Window starts are row offsets `start // 128`, clamped into the array, in
both versions.  `probe_floor` and `probe_gcols` launch persistent
blocks: `persistent_grid` sizes the grid from what the card holds at
once (`resident`), and each block walks its share of the B / G query
groups (`walk_queries`), as a TPU core walks its grid's steps one after
another over scratch allocated once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import subprocess
import sys
import time
from typing import Callable

import torch
import torch.nn.functional as F

from .ab import device_ms

BLK = 128
R_EXTRA = 8                 # B1's windows carry W // 128 + R_EXTRA rows
NEG_INF = -3.4e38
INT32_MAX = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
#: dynamic shared memory of the `curany` arm: grid_floor_probe.py's
#: curany_kernel scratch, 4 arrays x (24 + 72) rows x 512 B
CURANY_SMEM = 196_608
GCOLS_ROWS = 32             # gstep_probe2.py's ROWS
VARIANT_MODES = {"empty": 0, "load": 1, "phase": 2}
#: the ring kernels of `ring_info`
RING_KERNELS = {"probe_gwin": 0, "probe_variant": 1, "probe_gcols": 2}
#: the persistent kernels of `resident` ("probe_floor_any": the curany arm)
RESIDENT_KERNELS = {"probe_floor": 0, "probe_floor_any": 1, "probe_gcols": 2}

FLOOR_LAUNCHES = 0
GWIN_LAUNCHES = 0
GCOLS_LAUNCHES = 0
VARIANT_LAUNCHES = 0


def reset_launches() -> None:
    global FLOOR_LAUNCHES, GWIN_LAUNCHES, GCOLS_LAUNCHES, VARIANT_LAUNCHES
    FLOOR_LAUNCHES = GWIN_LAUNCHES = GCOLS_LAUNCHES = VARIANT_LAUNCHES = 0


def launches() -> dict:
    return {"probe_floor": FLOOR_LAUNCHES, "probe_gwin": GWIN_LAUNCHES,
            "probe_gcols": GCOLS_LAUNCHES, "probe_variant": VARIANT_LAUNCHES}


# ---------------------------------------------------------------- checks
def _check(t, name, dtype, device, shape=None, aligned=False):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _check_g(B: int, G: int) -> None:
    if G < 1 or B % G:
        raise ValueError(f"B={B} is not a multiple of G={G}: the grid "
                         f"takes G queries a block")


def _dispatch(t, what: str) -> bool:
    """True where `t` takes the kernel, False for the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no {what} kernel for device {t.device}")
    return True


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        from ..ops import _build
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('probes', rc)})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _win_rows(starts, rows: int, n_rows: int):
    """First row of each window: floor(start / 128) clamped into
    [0, n_rows - rows] (int64)."""
    s = torch.div(starts.to(torch.int64), BLK, rounding_mode="floor")
    return s.clamp(0, n_rows - rows)


def covered(starts, lens, n: int) -> int:
    """How many units of [0, n) the intervals [starts, starts + lens)
    cover together (lens a tensor or an int): the distinct rows (or
    lanes) that a call's windows touch, each read once."""
    s = starts.to(torch.int64).clamp(0, n)
    e = (s + (lens.to(torch.int64) if torch.is_tensor(lens) else lens)
         ).clamp(0, n)
    delta = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
    delta.index_add_(0, s, torch.ones_like(s))
    delta.index_add_(0, e, -torch.ones_like(e))
    return int((delta.cumsum(0)[:n] > 0).sum())


def rows_touched(meta, wins, n_rows: int) -> int:
    """Distinct rows of an [n_rows, 128] array that the windows read:
    `wins` is [(meta column, rows)], each window from the row
    `start // 128` of that column, clamped as the kernels clamp it."""
    starts = torch.cat([_win_rows(meta[:, c], R, n_rows) for c, R in wins])
    lens = torch.cat([torch.full((meta.shape[0],), R, dtype=torch.int64,
                                 device=meta.device) for _c, R in wins])
    return covered(starts, lens, n_rows)


def persistent_grid(B: int, G: int, sms: int, per_sm: int) -> int:
    """Blocks of a persistent launch of B queries, G a group: one a
    group up to what the card holds at once, min(B / G, sms x per_sm);
    0 for B = 0.  Block b walks the groups b, b + grid, ...
    (`walk_queries`).  The TPU runs its grid's steps one after another
    on a core over scratch allocated once; on the card each block pays
    its launch and first load round trip, so these launches start no
    more blocks than run at once and let each walk many groups."""
    _check_g(B, G)
    if sms < 1 or per_sm < 1:
        raise ValueError(f"sms={sms}, per_sm={per_sm}: one at least")
    return min(B // G, sms * per_sm)


def walk_queries(b: int, grid: int, B: int, G: int) -> list:
    """The queries block b of a persistent grid of `grid` blocks writes:
    query j of its walk is query j % G of group b + (j // G) grid."""
    return [g * G + i for g in range(b, B // G, grid) for i in range(G)]


_RESIDENT: dict = {}


def resident(kernel: str, n_groups: int, smem: int = 0) -> tuple:
    """(SMs, blocks of `kernel` an SM holds at once) on the current card:
    "probe_floor", "probe_floor_any" at `smem` dynamic bytes, or
    "probe_gcols" at the ring a launch of n_groups groups gets (its
    stages depend on how many blocks share an SM).  Cached a card."""
    key = (torch.cuda.current_device(), kernel,
           n_groups if kernel == "probe_gcols" else 0, smem)
    got = _RESIDENT.get(key)
    if got is None:
        from ..ops import _build
        out = (ctypes.c_int * 2)()
        rc = _build.load("probes").rs_probe_resident(
            RESIDENT_KERNELS[kernel], n_groups, smem, out)
        _raise_on(rc, f"{kernel} resident")
        got = _RESIDENT[key] = (out[0], out[1])
    return got


def _windows(a, srow, rows: int):
    """a [n_rows, 128] -> [B, rows, 128], the rows from each srow."""
    return a[srow[:, None] + torch.arange(rows, device=a.device)]


# ------------------------------------------------------------ probe_floor
def floor_plain(meta, *, layout: str = "fused", G: int = 1):
    """grid_floor_probe.py's step-floor kernels: meta[q, 0] across 128
    lanes.  layout "cur" (cur_kernel, curany_kernel): three [B, 1, 128]
    outputs, int32 meta[q, 0], f32 zeros, int32 zeros; "fused"
    (fused_kernel, g_kernel): one int32 [B, 3, 128]."""
    B = meta.shape[0]
    _check_g(B, G)
    v = meta[:, :1, None]
    if layout == "cur":
        return (v.expand(B, 1, BLK).contiguous(),
                torch.zeros((B, 1, BLK), dtype=torch.float32,
                            device=meta.device),
                torch.zeros((B, 1, BLK), dtype=torch.int32,
                            device=meta.device))
    return v.expand(B, 3, BLK).contiguous()


def floor_library(meta):
    """One PyTorch call for the floor's function, meta[q, 0] across 384
    lanes (timed beside the kernel, used nowhere else): a thunk."""
    return lambda: meta[:, :1].expand(-1, 3 * BLK).contiguous()


def probe_floor(meta, *, layout: str = "fused", G: int = 1, fmeta=None,
                anys: tuple = ()):
    """The step floor: B queries write meta[q, 0] (int32 [B, C]) in
    `layout` (see `floor_plain`), on persistent blocks of 128 threads
    that walk their groups of G queries, each warp reading the meta of
    its next 32 queries at once before it stores (16 bytes a lane).  Layout
    "cur" takes B1's fmeta block (f32 [B, 1, 3]), which the kernel reads
    as B1's spec copies it; with `anys` (B1's four window arrays,
    unused) it is the curany arm, launched with CURANY_SMEM bytes of
    dynamic shared memory: one block an SM."""
    global FLOOR_LAUNCHES
    if layout not in ("cur", "fused"):
        raise ValueError(f"layout {layout!r}: 'cur' or 'fused'")
    if anys and (layout != "cur" or len(anys) != 4):
        raise ValueError("anys: B1's four window arrays, layout 'cur'")
    if layout == "cur" and G != 1:
        raise ValueError("layout 'cur' runs one query a block")
    B = meta.shape[0]
    _check_g(B, G)
    if not _dispatch(meta, "probe_floor"):
        return floor_plain(meta, layout=layout, G=G)
    from ..ops import _build
    lib = _build.load("probes")
    dev = meta.device
    _check(meta, "meta", torch.int32, dev, (B, None))
    if layout == "cur":
        _check(fmeta, "fmeta", torch.float32, dev, (B, 1, 3))
        for i, a in enumerate(anys):
            _check(a, f"anys[{i}]", a.dtype, dev)
        outs = (torch.empty((B, 1, BLK), dtype=torch.int32, device=dev),
                torch.empty((B, 1, BLK), dtype=torch.float32, device=dev),
                torch.empty((B, 1, BLK), dtype=torch.int32, device=dev))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = torch.empty((B, 3, BLK), dtype=torch.int32, device=dev)
        ptrs = [outs.data_ptr(), None, None]
    any_p = ((ctypes.c_void_p * 4)(*[a.data_ptr() for a in anys])
             if anys else None)
    smem = CURANY_SMEM if anys else 0
    grid = persistent_grid(B, G, *resident(
        "probe_floor_any" if anys else "probe_floor", B // G, smem)) \
        if B else 0
    rc = lib.rs_probe_floor_launch(
        meta.data_ptr(), meta.shape[1],
        fmeta.data_ptr() if layout == "cur" else None, *ptrs,
        int(layout == "fused"), G, B, any_p, smem, grid, _stream(dev))
    _raise_on(rc, "probe_floor")
    FLOOR_LAUNCHES += 1
    return outs


# ------------------------------------------------------------- probe_gwin
def gwin_plain(meta, d, f, *, rows: tuple, G: int = 1):
    """One window a query (rows = (R,); gstep_probe.py's kern): d and f
    rows from meta[q, 0] // 128; out int32 [B, 1, 128] = the sum of d's
    live lanes (flat lane >= meta[q, 1]) plus int32(the f32 sum of f's
    live lanes).  Two (rows = (R0, R1); grid_floor_probe.py's
    gdma_kernel): d windows at meta[q, 0] and meta[q, 1]; out int32
    [B, 3, 128] = the column max of the first plus that of the second
    (int32, wrapping).  The f32 sum's order is torch's: kernels sum in
    their own, and the truncated sums may differ by a few units."""
    B, n_rows = meta.shape[0], d.shape[0]
    _check_g(B, G)
    if len(rows) == 1:
        R = rows[0]
        srow = _win_rows(meta[:, 0], R, n_rows)
        lane = torch.arange(R * BLK, device=d.device).view(1, R, BLK)
        live = lane >= meta[:, 1].view(B, 1, 1)
        s = torch.where(live, _windows(d, srow, R), 0).sum(
            (1, 2), dtype=torch.int64)
        fs = torch.where(live, _windows(f, srow, R), 0.0).sum((1, 2))
        s = (s + fs.to(torch.int32).to(torch.int64)).to(torch.int32)
        return s.view(B, 1, 1).expand(B, 1, BLK).contiguous()
    m = None
    for w, R in enumerate(rows):
        mx = _windows(d, _win_rows(meta[:, w], R, n_rows), R).amax(1)
        m = mx if m is None else m + mx
    return m.view(B, 1, BLK).expand(B, 3, BLK).contiguous()


def probe_gwin(meta, d, f, *, rows: tuple, G: int = 1, staged: bool = True):
    """G queries a block over one or two windows of d (int32 [n, 128])
    and f (f32 [n, 128]); see `gwin_plain`.  `staged`: the windows go
    through a TMA ring in shared memory, tiles of d and f rows, each
    tile two bulk copies that complete on its stage's mbarrier; a
    producer warp runs the ring's S stages ahead across window and
    query boundaries while four consumer warps reduce.  The launch
    shares an SM's shared memory among the B / G blocks it puts there
    and takes the widest tile (64, 32 or 16 rows) of which three stages
    fit, then as many stages as fit (`ring_info`).  Otherwise 16-byte
    loads straight into registers."""
    global GWIN_LAUNCHES
    if len(rows) not in (1, 2) or min(rows) < 1:
        raise ValueError(f"rows {rows}: one or two window heights")
    B, n_rows = meta.shape[0], d.shape[0]
    _check_g(B, G)
    if max(rows) > n_rows:
        raise ValueError(f"a window of {max(rows)} rows exceeds the "
                         f"array ({n_rows} rows)")
    if not _dispatch(meta, "probe_gwin"):
        return gwin_plain(meta, d, f, rows=rows, G=G)
    from ..ops import _build
    lib = _build.load("probes")
    dev = meta.device
    _check(meta, "meta", torch.int32, dev, (B, None))
    if meta.shape[1] < 2:
        raise ValueError("meta: two columns at least")
    _check(d, "d", torch.int32, dev, (None, BLK), aligned=True)
    _check(f, "f", torch.float32, dev, (n_rows, BLK), aligned=True)
    colmax = len(rows) == 2
    out = torch.empty((B, 3 if colmax else 1, BLK), dtype=torch.int32,
                      device=dev)
    rc = lib.rs_probe_gwin_launch(
        meta.data_ptr(), meta.shape[1], d.data_ptr(), f.data_ptr(), n_rows,
        out.data_ptr(), B, G, int(colmax), rows[0], rows[-1], int(staged),
        _stream(dev))
    _raise_on(rc, "probe_gwin")
    GWIN_LAUNCHES += 1
    return out


# ------------------------------------------------------------ probe_gcols
def gcols_plain(meta, d, *, G: int = 1):
    """gstep_probe2.py's kern: a GCOLS_ROWS-row window of d (int32)
    from meta[q, 0] // 128; out f32 [B, 1, 128] = its column sums in
    f32 over 8-row tiles (rows in order within a tile, then the tiles),
    times the f32 whose bits are meta[q, 1]."""
    B = meta.shape[0]
    _check_g(B, G)
    srow = _win_rows(meta[:, 0], GCOLS_ROWS, d.shape[0])
    v = _windows(d, srow, GCOLS_ROWS).to(torch.float32)
    acc = torch.zeros((B, BLK), dtype=torch.float32, device=d.device)
    for t in range(0, GCOLS_ROWS, 8):
        s = v[:, t]
        for r in range(t + 1, t + 8):
            s = s + v[:, r]
        acc = acc + s
    w = meta[:, 1].contiguous().view(torch.float32)
    return (acc * w[:, None]).view(B, 1, BLK)


def gcols_library(meta, d):
    """One PyTorch call for gcols' function (timed beside the kernel,
    used nowhere else): `embedding_bag` sums each query's 32 rows of a
    float32 copy of d, each row times the query's weight.  The row
    numbers, the copy and the weights are made here, outside the thunk
    it returns.  It rounds weight x row before the sum, so it may differ
    from `gcols_plain` by a few units in the last place."""
    srow = _win_rows(meta[:, 0], GCOLS_ROWS, d.shape[0])
    idx = srow[:, None] + torch.arange(GCOLS_ROWS, device=d.device)
    d32 = d.to(torch.float32)
    w = meta[:, 1].contiguous().view(torch.float32)[:, None].expand(
        -1, GCOLS_ROWS).contiguous()
    return lambda: F.embedding_bag(idx, d32, mode="sum",
                                   per_sample_weights=w)


def probe_gcols(meta, d, *, G: int = 1):
    """See `gcols_plain`; meta int32 [B, 2] (start, weight bits), d int32
    [n, 128].  Persistent blocks walk their groups of G queries through a
    TMA ring: a stage holds one query's 16 KB window (one bulk copy), a
    producer warp runs the ring's S stages ahead across queries and
    groups, four consumer warps sum a column a thread (`ring_info`)."""
    global GCOLS_LAUNCHES
    B, n_rows = meta.shape[0], d.shape[0]
    _check_g(B, G)
    if n_rows < GCOLS_ROWS:
        raise ValueError(f"d has {n_rows} rows, fewer than {GCOLS_ROWS}")
    if not _dispatch(meta, "probe_gcols"):
        return gcols_plain(meta, d, G=G)
    from ..ops import _build
    lib = _build.load("probes")
    dev = meta.device
    _check(meta, "meta", torch.int32, dev, (B, 2))
    _check(d, "d", torch.int32, dev, (None, BLK), aligned=True)
    out = torch.empty((B, 1, BLK), dtype=torch.float32, device=dev)
    grid = persistent_grid(B, G, *resident("probe_gcols", B // G)) if B \
        else 0
    rc = lib.rs_probe_gcols_launch(meta.data_ptr(), d.data_ptr(), n_rows,
                                   out.data_ptr(), B, G, grid, _stream(dev))
    _raise_on(rc, "probe_gcols")
    GCOLS_LAUNCHES += 1
    return out


# ---------------------------------------------------------- probe_variant
def variant_rows(Ws) -> list:
    return [W // BLK + R_EXTRA for W in Ws]


def variant_plain(meta, fmeta, doc_ids, freqs, masks, dl, *, Ws: tuple,
                  k: int = 16, mode: str = "phase"):
    """kernel_probe.py's variant_kernel, B1's grid step cut into modes.
    meta int32 [B, 3T] (starts, lens, qmasks), fmeta f32 [B, T + 1]
    (tweights, avgdl), the arrays [n, 128].  Outputs (docs int32, scores
    f32, counts int32), each [B, 1, 128].  "empty" and "load" give
    zeros; "phase" scores the pivot window (slot 0, W0 // 128 + R_EXTRA
    rows from start // 128): lanes in [start % 128, start % 128 + len)
    whose mask meets the qmask, BM25 `2*tf*2.2 / (tf + norm)` with
    `norm = 1.2 * (0.25 + 0.75 * dl / max(avgdl, 1e-9))`, then the top k
    (score desc, lowest lane on ties); slots past the valid lanes hold
    INT32_MAX / NEG_INF (B1's filler).  Counts are zero."""
    B, T = meta.shape[0], len(Ws)
    dev = meta.device
    docs = torch.zeros((B, 1, BLK), dtype=torch.int32, device=dev)
    scores = torch.zeros((B, 1, BLK), dtype=torch.float32, device=dev)
    counts = torch.zeros((B, 1, BLK), dtype=torch.int32, device=dev)
    if mode != "phase":
        return docs, scores, counts
    R = variant_rows(Ws)[0]
    srow = _win_rows(meta[:, 0], R, doc_ids.shape[0])
    win = [_windows(a, srow, R).reshape(B, R * BLK)
           for a in (doc_ids, freqs, masks, dl)]
    pdocs, tf, pfm, pdl = win
    lane = torch.arange(R * BLK, device=dev)[None, :]
    rr = (meta[:, 0] % BLK)[:, None]
    valid = ((lane >= rr) & (lane < rr + meta[:, T:T + 1])
             & ((pfm & meta[:, 2 * T:2 * T + 1]) != 0))
    avgdl = fmeta[:, T:T + 1].clamp_min(1e-9)
    norm = 1.2 * (0.25 + 0.75 * pdl / avgdl)
    score = 2.0 * tf * 2.2 / (tf + norm)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    s_o = torch.where(valid, score, neg)
    d_o = torch.where(valid, pdocs, INT32_MAX)
    vals, idx = torch.sort(s_o, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    top_d = torch.where(vals == neg, INT32_MAX, d_o.gather(1, idx))
    docs.fill_(INT32_MAX)
    scores.fill_(NEG_INF)
    docs[:, 0, :k] = top_d
    scores[:, 0, :k] = vals
    return docs, scores, counts


def probe_variant(meta, fmeta, doc_ids, freqs, masks, dl, *, Ws: tuple,
                  k: int = 16, mode: str = "phase"):
    """One block a query, in `mode` "empty", "load" (every byte of the
    slots' windows through a TMA ring of 8-row tiles: doc, freq and mask
    a slot, doc length for slot 0, three or four bulk copies a tile on
    one mbarrier; a producer warp, four consumer warps) or "phase"
    (load, and BM25 over each pivot tile as it arrives into a running
    top-k: each consumer warp appends the lanes that beat its k-th to a
    shared-memory buffer and keeps its best k by rank when it fills, the
    warps' buffers ranked together at the end); see `variant_plain`.
    T = len(Ws) slots, 1 to 4; k at most 128.  Nothing of the pivot
    outlives its tile, so its width is bounded only by the array."""
    global VARIANT_LAUNCHES
    if mode not in VARIANT_MODES:
        raise ValueError(f"mode {mode!r}: one of {tuple(VARIANT_MODES)}")
    T = len(Ws)
    B, n_rows = meta.shape[0], doc_ids.shape[0]
    rows = variant_rows(Ws)
    if not 1 <= T <= 4 or not 1 <= k <= BLK:
        raise ValueError(f"T={T} outside [1, 4] or k={k} outside [1, 128]")
    if max(rows) > n_rows:
        raise ValueError(f"a window of {max(rows)} rows exceeds the arrays "
                         f"({n_rows} rows)")
    if not _dispatch(meta, "probe_variant"):
        return variant_plain(meta, fmeta, doc_ids, freqs, masks, dl, Ws=Ws,
                             k=k, mode=mode)
    from ..ops import _build
    lib = _build.load("probes")
    dev = meta.device
    _check(meta, "meta", torch.int32, dev, (B, 3 * T))
    _check(fmeta, "fmeta", torch.float32, dev, (B, T + 1))
    for name, a, dt in (("doc_ids", doc_ids, torch.int32),
                        ("freqs", freqs, torch.float32),
                        ("masks", masks, torch.int32),
                        ("dl", dl, torch.float32)):
        _check(a, name, dt, dev, (n_rows, BLK), aligned=True)
    outs = (torch.empty((B, 1, BLK), dtype=torch.int32, device=dev),
            torch.empty((B, 1, BLK), dtype=torch.float32, device=dev),
            torch.empty((B, 1, BLK), dtype=torch.int32, device=dev))
    rc = lib.rs_probe_variant_launch(
        meta.data_ptr(), fmeta.data_ptr(), doc_ids.data_ptr(),
        freqs.data_ptr(), masks.data_ptr(), dl.data_ptr(), n_rows, T,
        (ctypes.c_int * T)(*rows), k, VARIANT_MODES[mode],
        *[o.data_ptr() for o in outs], B, _stream(dev))
    _raise_on(rc, "probe_variant")
    VARIANT_LAUNCHES += 1
    return outs


def ring_info(kernel: str, blocks: int, k: int = 0) -> dict:
    """The TMA ring a launch of `blocks` blocks gets on the current card
    (`kernel` "probe_gwin", the staged arm: B / G blocks;
    "probe_variant": B blocks, the load mode, or with k > 0 the phase
    mode, whose candidate buffers share the block's shared memory;
    "probe_gcols": `blocks` its B / G groups, which size its ring):
    stages, tile rows, dynamic and static shared bytes a block, resident
    blocks an SM, registers and local (spill) bytes a thread."""
    from ..ops import _build
    out = (ctypes.c_int * 7)()
    rc = _build.load("probes").rs_probe_ring_info(RING_KERNELS[kernel],
                                                  blocks, k, out)
    _raise_on(rc, f"{kernel} ring_info")
    return dict(zip(("stages", "tile_rows", "smem_dynamic", "smem_static",
                     "blocks_per_sm", "registers", "local_bytes"), out))


# ------------------------------------------------------------- the runner
@dataclasses.dataclass
class Arm:
    """One arm of a probe script: `run(meta)` calls the wrapper (or B1),
    `plain(meta)` its plain version, on the same inputs; `n_bytes` is
    what the arm moves for B queries (each query's windows read once,
    meta read, outputs written); `tol` the |kernel - plain| a lane may
    differ by (0: exact); `ring` the arguments of `ring_info` for an
    arm that runs a TMA ring; `library(meta)`, where one PyTorch call
    computes the arm's function, returns that call as a thunk (its
    inputs made outside it), to be timed beside the kernel."""
    name: str
    kernel: str
    run: Callable
    plain: Callable
    n_bytes: int
    B: int
    tol: int = 0
    ring: tuple = ()
    library: Callable | None = None


def _outs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def compare(out, ref, tol: int = 0) -> tuple:
    """(queries that differ by more than tol in any lane of any output,
    the largest |out - ref|), outputs compared in float64.  A lane that
    is NaN on one side only differs by inf; NaN on both sides, or the
    same infinity, is equal."""
    bad = None
    err = 0.0
    for o, r in zip(_outs(out), _outs(ref)):
        if o.shape != r.shape:
            raise AssertionError(f"shape {tuple(o.shape)} != "
                                 f"{tuple(r.shape)}")
        o, r = o.to(torch.float64), r.to(torch.float64)
        same = (o == r) | (o.isnan() & r.isnan())
        diff = torch.where(same, 0.0, (o - r).abs().nan_to_num(
            nan=float("inf")))
        diff = diff.reshape(o.shape[0], -1)
        q_bad = (diff > tol).any(1)
        bad = q_bad if bad is None else bad | q_bad
        if diff.numel():
            err = max(err, float(diff.max()))
    return int(bad.sum()), err


def wall_s(fn, metas, iters: int = 8, reps: int = 3) -> float:
    """Host seconds of `iters` calls, each on its own meta, ending in a
    synchronize; the best of `reps` (the TPU scripts' timing)."""
    fn(metas[0])
    torch.cuda.synchronize()
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(metas[(r * iters + i) % len(metas)])
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / iters


def rolled(meta, n: int = 24) -> list:
    """The TPU scripts' timing inputs: meta rolled by 1..n rows."""
    return [torch.roll(meta, i + 1, 0) for i in range(n)]


def bound_us(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e6


def run_arms(arms, meta, dev, timed: bool = True) -> list:
    """Check every arm against its plain version and, on a card, time
    it; print a line an arm and return a dict an arm."""
    metas = rolled(meta) if timed and dev.type == "cuda" else None
    res = []
    for arm in arms:
        bad, err = compare(arm.run(meta), arm.plain(meta), arm.tol)
        r = dict(name=arm.name, kernel=arm.kernel, bad=bad, err=err,
                 bound_us_q=bound_us(arm.n_bytes) / arm.B)
        if metas is not None:
            r["device_us_q"] = device_ms(lambda: arm.run(meta)) * 1e3 / arm.B
            r["wall_us_q"] = wall_s(arm.run, metas) * 1e6 / arm.B
            times = (f"device {r['device_us_q']:9.4f} us/q  "
                     f"wall {r['wall_us_q']:9.4f} us/q")
            if arm.library is not None:
                r["library_us_q"] = device_ms(arm.library(meta)) * 1e3 / arm.B
                times += f"  library {r['library_us_q']:9.4f} us/q"
        else:
            times = "device not measured, wall not measured"
        print(f"{arm.name:32s}: bad={bad}  {times}  bound "
              f"{r['bound_us_q']:.6f} us/q ({arm.n_bytes} B a call)",
              flush=True)
        res.append(r)
    return res


def resolve_device(device=None) -> torch.device:
    """The card, unless the caller names a device; no card raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench scripts run on a CUDA card: none "
                           "is available (pass device='cpu' for the plain "
                           "versions)")
    return torch.device("cuda", 0)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


SCRIPTS = {"gstep": "gstep_probe", "gstep2": "gstep_probe2",
           "kernel": "kernel_probe", "grid_floor": "grid_floor_probe"}
#: the scripts whose batch B is an argument
B_SCRIPTS = ("gstep2", "grid_floor")


def main(argv=None, device=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which not in SCRIPTS and which != "all" or len(argv) > 2 or (
            len(argv) == 2 and (which not in B_SCRIPTS
                                or not argv[1].isdigit())):
        raise SystemExit(__doc__)
    kw = {"B": int(argv[1])} if len(argv) == 2 else {}
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        print(f"card: {card_line()}", flush=True)
    res = []
    for name in SCRIPTS if which == "all" else (which,):
        print(f"--- {name}", flush=True)
        mod = importlib.import_module(
            f"redisearch_tpu_torch.bench.{SCRIPTS[name]}")
        res += mod.main(device=dev, **kw)
    bad = [r["name"] for r in res if r["bad"]]
    if bad:
        raise SystemExit(f"arms that disagree with their plain version: "
                         f"{bad}")
    return res


if __name__ == "__main__":
    # one module state (the launch counts) for this file and the scripts
    from redisearch_tpu_torch.bench import probes
    probes.main()
