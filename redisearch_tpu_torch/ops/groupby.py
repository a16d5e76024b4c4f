"""Device GROUPBY over dictionary-encoded group ids.

Counterpart of `redisearch_tpu/ops/groupby.py`, with its two entries:

* `groupby_aggregate_batch` (kernel B3): per query of a batch, count, sum
  and (optional) sum of squares per group over pre-masked gid slots, the
  serving path of batched FT.AGGREGATE.  Plain twin: `groupby_plain`, the
  segment sums of the JAX CPU fallback (`ops/groupby.py:250-268`).
* `groupby_aggregate_multi` (kernels B4 sums and B5 min/max, fused into
  one CUDA kernel): one request's base count and every operand's
  count/sum/sumsq (and min/max) per group in one pass, the window
  program's fused aggregation.  Plain twin:
  `groupby_aggregate_multi_plain`, built from `sums_plain` and
  `minmax_plain`, the segment reductions of the JAX CPU fallback
  (`:307-320`), with +-3.4e38 for empty groups (the Pallas kernels'
  identities; the JAX CPU fallback leaves +-inf there, which no consumer
  reads).  `groupby_aggregate`, the JAX package's one-operand entry,
  runs the same kernel (plain twin `groupby_aggregate_plain`).

The plain twins serve CPU tensors (the tests) and are what the CUDA
kernels (`csrc/groupby.cu`) are held against on the card.  A CUDA tensor
launches the kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

PG = 128
#: dynamic shared memory a block may opt in to on Hopper (227 KB)
SMEM_MAX = 232448
#: blocks in flight; each walks queries blockIdx, blockIdx + grid, ...
_MAX_GRID = 4096

#: kernel launches made by `groupby_aggregate_batch` (plain int; callers
#: reset it)
LAUNCHES = 0
#: kernel launches of the fused single-query group-by (B4 and B5) by
#: `groupby_aggregate_multi` and `groupby_aggregate`: `gb_single_kernel`
#: and, where a call needs them, its merge pass or the global branch's
#: init and decode kernels (`_single_kernels`)
SINGLE_LAUNCHES = 0
#: operands one single-query launcher call takes (csrc/groupby.cu MAX_OPS)
MAX_OPS = 16
_ROWS_PER_BLOCK = 2048    # a window of at most this many rows is one block
_TILE = 256               # rows a warp takes per step (32 lanes x 8)
_MIN_WARPS = 4            # warp histograms the shared branch needs
_MAX_WARPS = 16
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
    min/max onto the +-3.4e38 identities (NaN propagates), with -0.0
    below +0.0 as the JAX package's jnp.minimum / jnp.maximum order them
    (`scatter_reduce_` alone keeps whichever zero comes first)."""
    idx = torch.where(g >= 0, g, n_groups).long()
    G1 = n_groups + 1
    dev = vm.device

    def seg(how, init, x):
        return torch.full((G1,), init, dtype=torch.float32,
                          device=dev).scatter_reduce_(
            0, idx, x, how, include_self=True)[:n_groups]

    zero = vm == 0
    neg0 = seg("amax", 0.0, (zero & torch.signbit(vm)).to(torch.float32))
    pos0 = seg("amax", 0.0, (zero & ~torch.signbit(vm)).to(torch.float32))
    mn, mx = seg("amin", BIG, vm), seg("amax", -BIG, vm)
    return {"min": torch.where(mn == 0, torch.where(neg0 > 0, -0.0, 0.0), mn),
            "max": torch.where(mx == 0, torch.where(pos0 > 0, 0.0, -0.0),
                               mx)}


def groupby_aggregate_plain(gids, valid, values, n_groups: int,
                            want_minmax: bool = True) -> dict:
    """Plain torch version of `groupby_aggregate`: the JAX CPU
    fallback's segment reductions (spill bucket for the masked rows)."""
    g, vm = _premask(gids, valid, values, n_groups)
    out = sums_plain(g, vm, n_groups)
    if want_minmax:
        out.update(minmax_plain(g, vm, n_groups))
    return out


def _single_channels(n_ops: int, want_minmax: bool,
                     has_base: bool = True) -> int:
    """Channels of the fused single-query kernel: the base count (with
    has_base), then per operand count, sum, sumsq (, min, max)."""
    return int(has_base) + n_ops * (3 + 2 * int(want_minmax))


def _single_stats(want_minmax: bool) -> tuple:
    return ("count", "sum", "sumsq") + (("min", "max") if want_minmax
                                        else ())


def _single_dict(out, n_ops: int, n_groups: int, want_minmax: bool) -> dict:
    """[C, >= n_groups] channels -> the JAX package's stat keys."""
    stats = _single_stats(want_minmax)
    rows = out[:, :n_groups].unbind(0)     # one call for every view
    res = {"g.None.count": rows[0]}
    for j in range(n_ops):
        for k, st in enumerate(stats):
            res[f"g.{j}.{st}"] = rows[1 + j * len(stats) + k]
    return res


def groupby_aggregate_multi_plain(gid, valid, operands, n_groups: int,
                                  want_minmax: bool = True) -> dict:
    """Plain torch version of `groupby_aggregate_multi`: the base count
    and each operand's stats through `sums_plain` / `minmax_plain` (the
    JAX CPU fallback's segment reductions, one call per operand)."""
    g, vm = _premask(gid, valid, torch.zeros((), dtype=torch.float32,
                                             device=gid.device), n_groups)
    res = {"g.None.count": sums_plain(g, vm, n_groups)["count"]}
    for j, (vals, pres) in enumerate(operands):
        st = groupby_aggregate_plain(gid, valid & pres, vals, n_groups,
                                     want_minmax)
        res.update({f"g.{j}.{k}": x for k, x in st.items()})
    return res


def _single_geometry(n: int, C: int, G_pad: int, n_sm: int = 132) -> tuple:
    """(blocks, warps, rows per block, shared) of one fused single-query
    launch.  Each warp of the shared branch holds its own [C, G_pad]
    histogram, a tag byte per group and 32 staging words, so the branch
    needs (C * G_pad + G_pad / 4 + 32) * 4 bytes for at least _MIN_WARPS
    warps (within 1 KB less than SMEM_MAX); a larger group space takes
    the global branch (8 warps a block).  A window of at most
    _ROWS_PER_BLOCK rows is one block; a larger one is cut into
    contiguous runs of rows, at most one block per SM, so the partials of
    the shared branch stay under 132 x 57 KB = 7.5 MB.  Warps: one per
    256-row step of a block's rows, at least _MIN_WARPS (they share the
    histograms' set-up and merge), at most as many as fit."""
    fit = (SMEM_MAX - 1024) // ((C * G_pad + G_pad // 4 + 32) * 4)
    shared = fit >= _MIN_WARPS
    blocks = max(1, min(-(-n // _ROWS_PER_BLOCK), n_sm))
    rpb = max(1, -(-n // blocks))
    warps = (min(fit, _MAX_WARPS, max(_MIN_WARPS, -(-rpb // _TILE)))
             if shared else 8)
    return blocks, warps, rpb, shared


def _single_kernels(blocks: int, shared: bool) -> int:
    """Kernels one launcher call starts: `gb_single_kernel` alone (one
    block of the shared branch), with its merge pass (several blocks), or
    between the global branch's init and decode kernels."""
    return 3 if not shared else (1 if blocks == 1 else 2)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lane_arg(x, dtype, n: int, dev, what: str) -> tuple:
    """(tensor, step) of one operand column: a contiguous [n] column has
    step 1; a broadcast constant (0-dim, or [n] expanded with stride 0, as
    `_lanes` leaves an APPLY constant) is passed as its one element with
    step 0, never materialised."""
    if x.dim() == 0 or (x.dim() == 1 and x.shape[0] == n and n > 0
                        and x.stride(0) == 0):
        return x.reshape(-1)[:1].to(device=dev, dtype=dtype).contiguous(), 0
    if tuple(x.shape) != (n,):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, expected ({n},)")
    if x.device != dev:
        raise ValueError(f"{what}: on {x.device}, expected {dev}")
    return x.to(dtype).contiguous(), 1


def _launch_multi(gid, valid, operands, n_groups: int, want_minmax: bool,
                  has_base: bool = True):
    """The fused kernel over the raw columns: one launcher call per
    MAX_OPS operands, the first with the base count, each adding its
    kernels to SINGLE_LAUNCHES.  Returns f32 [C, G_pad], every cell
    written by the kernel."""
    from . import _build
    from .intersect import _check
    dev = gid.device
    _check(gid, "gid", torch.int32, dev, 1)
    _check(valid, "valid", torch.bool, dev, 1)
    n = gid.shape[0]
    if valid.shape != gid.shape:
        raise ValueError(f"valid {tuple(valid.shape)} vs gid "
                         f"{tuple(gid.shape)}")
    if not 1 <= n_groups <= 65536:
        raise ValueError(f"n_groups={n_groups}")
    G_pad = _g_pad(n_groups)
    out = torch.empty((_single_channels(len(operands), want_minmax,
                                        has_base), G_pad),
                      dtype=torch.float32, device=dev)
    lib = _build.load("groupby")
    stream = torch.cuda.current_stream(dev).cuda_stream
    global SINGLE_LAUNCHES
    ch = 0
    for j0 in range(0, max(len(operands), 1), MAX_OPS):
        chunk = operands[j0:j0 + MAX_OPS]
        base = has_base and j0 == 0
        k = len(chunk)
        vals = [_lane_arg(v, torch.float32, n, dev, f"operand {j0 + i} "
                          "values") for i, (v, _p) in enumerate(chunk)]
        pres = [_lane_arg(p, torch.bool, n, dev, f"operand {j0 + i} "
                          "present") for i, (_v, p) in enumerate(chunk)]
        C = _single_channels(k, want_minmax, base)
        blocks, warps, rpb, shared = _single_geometry(n, C, G_pad,
                                                      _n_sm(dev.index))
        part = (torch.empty((blocks, C, G_pad), dtype=torch.int32,
                            device=dev) if shared and blocks > 1 else None)
        ptrs = ctypes.c_void_p * max(k, 1)
        steps = ctypes.c_int * max(k, 1)
        rc = lib.rs_gb_single_launch(
            gid.data_ptr(), valid.data_ptr(),
            ptrs(*[t.data_ptr() for t, _s in pres]),
            ptrs(*[t.data_ptr() for t, _s in vals]),
            steps(*[s for _t, s in pres]), steps(*[s for _t, s in vals]),
            k, n, n_groups, G_pad, int(base), int(want_minmax),
            blocks, warps, rpb, int(shared),
            out[ch].data_ptr(),
            0 if part is None else part.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"single-query groupby kernel launch failed: "
                               f"CUDA error {rc} "
                               f"({_build.error_string('groupby', rc)})")
        SINGLE_LAUNCHES += _single_kernels(blocks, shared)
        ch += C
    return out


def groupby_aggregate_multi(gid, valid, operands, n_groups: int,
                            want_minmax: bool = True) -> dict:
    """One request's GROUPBY: the base count and every operand's
    COUNT/SUM/SUMSQ (and MIN/MAX) per group, in one pass.

    gid: int32 [n] composite group id per row (< 0 or >= n_groups:
        ignored)
    valid: bool [n] the base row mask (query match, FILTER steps)
    operands: [(values f32 [n], present bool [n])], each possibly a
        broadcast constant (0-dim, or expanded with stride 0)
    Returns {"g.None.count", "g.{j}.count" / "g.{j}.sum" / "g.{j}.sumsq"
    (/ "g.{j}.min" / "g.{j}.max")}: f32 [n_groups] each, the JAX
    package's keys.  An empty group's min/max are +3.4e38 / -3.4e38, a
    group holding a NaN value has NaN min and max.

    CPU tensors run `groupby_aggregate_multi_plain`; CUDA tensors launch
    the fused kernel (one launcher call for up to MAX_OPS operands, its
    kernels counted in SINGLE_LAUNCHES) or raise."""
    if gid.device.type == "cpu":
        return groupby_aggregate_multi_plain(gid, valid, operands, n_groups,
                                             want_minmax)
    if gid.device.type != "cuda":
        raise RuntimeError(f"no groupby kernel for device {gid.device}")
    out = _launch_multi(gid, valid, list(operands), n_groups, want_minmax)
    return _single_dict(out, len(operands), n_groups, want_minmax)


def _launch_single(gids, valid, values, n_groups: int, want_minmax: bool):
    present = torch.ones((), dtype=torch.bool, device=gids.device)
    out = _launch_multi(gids, valid, [(values, present)], n_groups,
                        want_minmax, has_base=False)
    return dict(zip(_single_stats(want_minmax),
                    out[:, :n_groups].unbind(0)))


def groupby_aggregate(gids, valid, values, n_groups: int,
                      want_minmax: bool = True) -> dict:
    """Per-group COUNT/SUM/SUMSQ (and MIN/MAX) of one operand: the JAX
    package's entry, over the same fused kernel (without the base count).

    gids: int32 [n] group id per row (< 0 or >= n_groups: ignored)
    valid: bool [n] row mask (query match and key present)
    values: float32 [n] (or a broadcast constant) the reduced operand
    Returns f32 [n_groups] tensors "count", "sum", "sumsq" (, "min",
    "max"), the JAX package's keys, with the identities and NaNs of
    `groupby_aggregate_multi`.

    CPU tensors run `groupby_aggregate_plain`; CUDA tensors launch the
    fused kernel (counted in SINGLE_LAUNCHES) or raise."""
    if gids.device.type == "cpu":
        return groupby_aggregate_plain(gids, valid, values, n_groups,
                                       want_minmax)
    if gids.device.type != "cuda":
        raise RuntimeError(f"no groupby kernel for device {gids.device}")
    return _launch_single(gids, valid, values, n_groups, want_minmax)
