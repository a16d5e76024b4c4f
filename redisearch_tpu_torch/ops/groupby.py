"""Batched device GROUPBY over dictionary-encoded group ids.

Counterpart of `redisearch_tpu/ops/groupby.py` `groupby_aggregate_batch`
(the serving path of batched FT.AGGREGATE).  Per query of a batch:
count, sum and (optional) sum of squares per group over pre-masked gid
slots.

Two implementations of one contract:

* `groupby_plain`: plain torch, the segment-sum twin of the JAX CPU
  fallback (`ops/groupby.py:250-268`), written with `index_add_` and a
  spill bucket at G_pad.  It serves CPU tensors (the tests) and is what
  the CUDA kernel is held against on the card.
* the CUDA kernel `csrc/groupby.cu`, launched by
  `groupby_aggregate_batch` for CUDA tensors.  There is no fallback: a
  CUDA tensor launches the kernel or raises.

The single-query kernels of the JAX module (`_sums_kernel`,
`_minmax_kernel`) are reached only through the general window path and
are not ported yet (ROADMAP B4/B5, after A6).
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
