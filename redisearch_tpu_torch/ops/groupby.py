"""Device GROUPBY over dictionary-encoded group ids.

Counterpart of `redisearch_tpu/ops/groupby.py`, with its two entries:

* `groupby_aggregate_batch` (kernel B3): per query of a batch, count, sum
  and (optional) sum of squares per group over pre-masked gid slots, the
  serving path of batched FT.AGGREGATE.  Plain twin: `groupby_plain`, the
  segment sums of the JAX CPU fallback (`ops/groupby.py:250-268`).
* `groupby_aggregate` (kernels B4 sums and B5 min/max): one query's
  count/sum/sumsq (and min/max) per group, reached through the window
  program's fused aggregation.  Plain twin: `groupby_aggregate_plain`,
  the segment reductions of the JAX CPU fallback (`:307-320`), with
  +-3.4e38 for empty groups (the Pallas kernels' identities; the JAX CPU
  fallback leaves +-inf there, which no consumer reads).

The plain twins serve CPU tensors (the tests) and are what the CUDA
kernels (`csrc/groupby.cu`) are held against on the card.  A CUDA tensor
launches the kernels or raises; nothing falls back.
"""

from __future__ import annotations

import torch

PG = 128
#: dynamic shared memory a block may opt in to on Hopper (227 KB)
SMEM_MAX = 232448
#: blocks in flight; each walks queries blockIdx, blockIdx + grid, ...
_MAX_GRID = 4096

#: kernel launches made by `groupby_aggregate_batch` (plain int; callers
#: reset it)
LAUNCHES = 0
#: launches of the single-query kernels B4 (sums) and B5 (min/max) by
#: `groupby_aggregate`
SUMS_LAUNCHES = 0
MINMAX_LAUNCHES = 0
#: the empty-group identities of min and max
BIG = 3.4e38

#: reducers the device path can serve (others are the host pipeline)
DEVICE_REDUCERS = {"COUNT", "SUM", "AVG", "MIN", "MAX", "STDDEV"}


def _g_pad(n_groups: int) -> int:
    return ((n_groups + PG - 1) // PG) * PG


def _channels(S: int, want_sumsq: bool) -> int:
    """Output channels: the base count, then per op count, sum
    (, sumsq)."""
    return 1 + (S - 1) * (2 + int(want_sumsq))


def _to_dict(out, S: int, n_groups: int, want_sumsq: bool) -> dict:
    """[B, C, >= n_groups] channels -> the JAX package's stat dict."""
    res = {"g.None.count": out[:, 0, :n_groups]}
    per_op = 2 + int(want_sumsq)
    for j in range(S - 1):
        c = 1 + j * per_op
        res[f"g.{j}.count"] = out[:, c, :n_groups]
        res[f"g.{j}.sum"] = out[:, c + 1, :n_groups]
        if want_sumsq:
            res[f"g.{j}.sumsq"] = out[:, c + 2, :n_groups]
    return res


def groupby_plain(gslots, vals, n_groups: int, want_sumsq: bool = True):
    """Plain torch version of `groupby_aggregate_batch`: per (query,
    slot) segment sums; gids outside [0, G_pad) land in the spill bucket
    at G_pad and are dropped."""
    B, S, n = gslots.shape
    G_pad = _g_pad(n_groups)
    G1 = G_pad + 1
    dev = gslots.device
    C = _channels(S, want_sumsq)
    out = torch.zeros((C, B * G1), dtype=torch.float32, device=dev)
    qoff = (torch.arange(B, device=dev) * G1)[:, None]
    per_op = 2 + int(want_sumsq)
    for s in range(S):
        g = gslots[:, s]
        ok = (g >= 0) & (g < G_pad)
        idx = (qoff + torch.where(ok, g, G_pad)).reshape(-1)
        c = 0 if s == 0 else 1 + (s - 1) * per_op
        out[c].index_add_(0, idx, ok.to(torch.float32).reshape(-1))
        if s > 0:
            v = torch.where(g >= 0, vals[:, s - 1], 0.0).reshape(-1)
            out[c + 1].index_add_(0, idx, v)
            if want_sumsq:
                out[c + 2].index_add_(0, idx, v * v)
    out = out.reshape(C, B, G1).permute(1, 0, 2)
    return _to_dict(out, S, n_groups, want_sumsq)


def _launch(gslots, vals, n_groups: int, want_sumsq: bool):
    from . import _build
    from .intersect import _check
    lib = _build.load("groupby")
    dev = gslots.device
    _check(gslots, "gslots", torch.int32, dev, 3)
    B, S, n = gslots.shape
    _check(vals, "vals", torch.float32, dev, 3)
    if tuple(vals.shape) != (B, S - 1, n):
        raise ValueError(f"vals {tuple(vals.shape)} does not match gslots "
                         f"{tuple(gslots.shape)}")
    if n_groups < 1:
        raise ValueError(f"n_groups={n_groups}")
    G_pad = _g_pad(n_groups)
    C = _channels(S, want_sumsq)
    out = torch.empty((B, C, G_pad), dtype=torch.float32, device=dev)
    if B == 0:
        return _to_dict(out, S, n_groups, want_sumsq)
    use_smem = C * G_pad * 4 <= SMEM_MAX
    grid = min(B, _MAX_GRID)
    rc = lib.rs_groupby_launch(
        gslots.data_ptr(), vals.data_ptr() if S > 1 else 0,
        out.data_ptr(), B, S, n, G_pad, int(want_sumsq), grid,
        int(use_smem), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"groupby kernel launch failed: CUDA error {rc} "
                           f"({_build.error_string('groupby', rc)})")
    global LAUNCHES
    LAUNCHES += 1
    return _to_dict(out, S, n_groups, want_sumsq)


def groupby_aggregate_batch(gslots, vals, n_groups: int,
                            want_sumsq: bool = True) -> dict:
    """Whole-batch GROUPBY: B queries' (pre-masked gid slots, values) ->
    per-query per-group stats.

    gslots: int32 [B, 1 + n_ops, n] — slot 0 masked by the query's base
        validity, slot 1+j by op j's validity and presence (-1 = skip)
    vals: float32 [B, n_ops, n] op values
    Returns {"g.None.count": [B, G], "g.{j}.count" / "g.{j}.sum"
    (/ "g.{j}.sumsq"): [B, G]}, the JAX package's key naming.

    CPU tensors run `groupby_plain`; CUDA tensors launch the kernel
    (`LAUNCHES` counts each launch) or raise.
    """
    if gslots.device.type == "cpu":
        return groupby_plain(gslots, vals, n_groups, want_sumsq)
    if gslots.device.type != "cuda":
        raise RuntimeError(f"no groupby kernel for device {gslots.device}")
    return _launch(gslots, vals, n_groups, want_sumsq)


def _premask(gids, valid, values, n_groups: int):
    """The contract's row mask, applied once: a row outside [0,
    n_groups) or not valid gets gid -1 and value 0.  Returns (g int32
    [n], vm f32 [n]), the single-query kernels' inputs."""
    ok = valid & (gids >= 0) & (gids < n_groups)
    g = torch.where(ok, gids, -1).to(torch.int32).contiguous()
    vm = torch.where(ok, values, 0.0).to(torch.float32).contiguous()
    return g, vm


def sums_plain(g, vm, n_groups: int) -> dict:
    """Plain torch version of kernel B4 on pre-masked rows: segment sums
    with a spill bucket at n_groups for the gid -1 rows."""
    idx = torch.where(g >= 0, g, n_groups).long()
    G1 = n_groups + 1

    def seg_sum(x):
        return torch.zeros(G1, dtype=torch.float32, device=x.device
                           ).index_add_(0, idx, x)[:n_groups]

    return {"count": seg_sum((g >= 0).to(torch.float32)), "sum": seg_sum(vm),
            "sumsq": seg_sum(vm * vm)}


def minmax_plain(g, vm, n_groups: int) -> dict:
    """Plain torch version of kernel B5 on pre-masked rows: segment
    min/max onto the +-3.4e38 identities (NaN propagates)."""
    idx = torch.where(g >= 0, g, n_groups).long()
    G1 = n_groups + 1
    dev = vm.device
    return {"min": torch.full((G1,), BIG, device=dev).scatter_reduce_(
                0, idx, vm, "amin", include_self=True)[:n_groups],
            "max": torch.full((G1,), -BIG, device=dev).scatter_reduce_(
                0, idx, vm, "amax", include_self=True)[:n_groups]}


def groupby_aggregate_plain(gids, valid, values, n_groups: int,
                            want_minmax: bool = True) -> dict:
    """Plain torch version of `groupby_aggregate`: the JAX CPU
    fallback's segment reductions (spill bucket for the masked rows)."""
    g, vm = _premask(gids, valid, values, n_groups)
    out = sums_plain(g, vm, n_groups)
    if want_minmax:
        out.update(minmax_plain(g, vm, n_groups))
    return out


def _single_grid(n: int, G_pad: int) -> int:
    """Blocks of a single-query launch: enough to fill the card's SMs
    (two per SM), at most one per 2,048 rows, and no more than rows per
    group, so that the per-block merge (G_pad atomics a block) stays
    below the rows' own atomics."""
    return max(1, min(-(-n // 2048), 264, -(-n // G_pad)))


def _single_args(g, vm, n_groups: int):
    from .intersect import _check
    dev = g.device
    _check(g, "g", torch.int32, dev, 1)
    _check(vm, "vm", torch.float32, dev, 1)
    if vm.shape != g.shape:
        raise ValueError(f"vm {tuple(vm.shape)} vs g {tuple(g.shape)}")
    if n_groups < 1 or n_groups > 65536:
        raise ValueError(f"n_groups={n_groups}")
    G_pad = _g_pad(n_groups)
    return (dev, g.shape[0], G_pad, int(3 * G_pad * 4 <= SMEM_MAX),
            _single_grid(g.shape[0], G_pad),
            torch.cuda.current_stream(dev).cuda_stream)


def sums_kernel(g, vm, n_groups: int) -> dict:
    """Kernel B4 on pre-masked CUDA rows (one launch, counted in
    SUMS_LAUNCHES): {"count", "sum", "sumsq"} f32 [n_groups]."""
    from . import _build
    dev, n, G_pad, smem, grid, stream = _single_args(g, vm, n_groups)
    out = torch.zeros((3, G_pad), dtype=torch.float32, device=dev)
    rc = _build.load("groupby").rs_gb_sums_launch(
        g.data_ptr(), vm.data_ptr(), out.data_ptr(), n, G_pad, grid, smem,
        stream)
    if rc != 0:
        raise RuntimeError(f"groupby sums kernel launch failed: CUDA error "
                           f"{rc} ({_build.error_string('groupby', rc)})")
    global SUMS_LAUNCHES
    SUMS_LAUNCHES += 1
    return {"count": out[0, :n_groups], "sum": out[1, :n_groups],
            "sumsq": out[2, :n_groups]}


def minmax_kernel(g, vm, n_groups: int) -> dict:
    """Kernel B5 on pre-masked CUDA rows (one launch, counted in
    MINMAX_LAUNCHES): {"min", "max"} f32 [n_groups], +-3.4e38 for empty
    groups, NaN for a group holding a NaN value."""
    from . import _build
    dev, n, G_pad, smem, grid, stream = _single_args(g, vm, n_groups)
    mm = torch.empty((2, G_pad), dtype=torch.float32, device=dev)
    mm[0].fill_(BIG)
    mm[1].fill_(-BIG)
    nan_flag = torch.zeros(G_pad, dtype=torch.int32, device=dev)
    rc = _build.load("groupby").rs_gb_minmax_launch(
        g.data_ptr(), vm.data_ptr(), mm.data_ptr(), nan_flag.data_ptr(), n,
        G_pad, grid, smem, stream)
    if rc != 0:
        raise RuntimeError(f"groupby min/max kernel launch failed: CUDA "
                           f"error {rc} "
                           f"({_build.error_string('groupby', rc)})")
    global MINMAX_LAUNCHES
    MINMAX_LAUNCHES += 1
    mm = torch.where(nan_flag[None, :] != 0, float("nan"), mm)
    return {"min": mm[0, :n_groups], "max": mm[1, :n_groups]}


def _launch_single(gids, valid, values, n_groups: int, want_minmax: bool):
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise TypeError(f"gids: expected int32 [n], got {gids.dtype} "
                        f"{tuple(gids.shape)}")
    if valid.shape != gids.shape:
        raise ValueError(f"valid {tuple(valid.shape)} vs gids "
                         f"{tuple(gids.shape)}")
    g, vm = _premask(gids, valid, values, n_groups)
    out = sums_kernel(g, vm, n_groups)
    if want_minmax:
        out.update(minmax_kernel(g, vm, n_groups))
    return out


def groupby_aggregate(gids, valid, values, n_groups: int,
                      want_minmax: bool = True) -> dict:
    """Per-group COUNT/SUM/SUMSQ (and MIN/MAX) of one query in one pass.

    gids: int32 [n] group id per row (< 0 or >= n_groups: ignored)
    valid: bool [n] row mask (query match and key present)
    values: float32 [n] (or broadcastable) the reduced operand
    Returns f32 [n_groups] tensors "count", "sum", "sumsq" (, "min",
    "max"), the JAX package's keys; an empty group's min/max are
    +3.4e38 / -3.4e38, a group holding a NaN value has NaN min and max.

    CPU tensors run `groupby_aggregate_plain`; CUDA tensors launch B4
    (and B5 for min/max), each counted in SUMS_LAUNCHES /
    MINMAX_LAUNCHES, or raise."""
    if gids.device.type == "cpu":
        return groupby_aggregate_plain(gids, valid, values, n_groups,
                                       want_minmax)
    if gids.device.type != "cuda":
        raise RuntimeError(f"no groupby kernel for device {gids.device}")
    return _launch_single(gids, valid, values, n_groups, want_minmax)
