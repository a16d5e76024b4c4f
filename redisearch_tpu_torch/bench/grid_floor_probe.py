"""The port's counterpart of `benchmarks/grid_floor_probe.py`: the
fixed cost of B1's step, in five arms of the TPU script.

    python3 -m redisearch_tpu_torch.bench.probes grid_floor [B]

  cur      one query a block: meta[q, 0] across the doc lanes, zero
           scores and counts, in B1's three [B, 1, 128] outputs, B1's
           fmeta row read
  curany   cur with B1's four window arrays as unused arguments and the
           196,608 B of shared memory the TPU kernel's scratch takes
  fused    one fused [B, 3, 128] int32 output
  g4..g16  fused, G queries a block
  gdma     G = 4, 8 queries a block at (Wp, Wm) = (2048, 8192) and
           (8192, 32768), each copying a window of d and f of Wp / 128
           + 8 and of Wm / 128 + 8 rows; out: the column max of the
           first d window plus that of the second; `staged` and `direct`

The TPU script's inputs from its seed (B from the environment's
PROBE_B, 512 without it, as the TPU script reads it; meta [B, 8], fmeta
ones, d and f [16406, 128] of zeros); `inputs`, `arms` and `main` also
take B as an argument, which wins over PROBE_B.  Against zeros a wrong
column max passes, so the gdma arms are held against their plain
version on random d and f too (seed 1).  Kernels `probe_floor` (cur,
curany, fused, g) and `probe_gwin` (gdma); all exact.  The floor arms'
library call is `meta[:, :1].expand(-1, 384).contiguous()`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import probes as P

N_ROWS = 2_100_000 // P.BLK
GS = (4, 8, 16)
GDMA_WS = ((2048, 8192), (8192, 32768))
GDMA_GS = (4, 8)


def probe_b(B=None) -> int:
    """B, or PROBE_B from the environment, or the TPU script's 512."""
    return int(os.environ.get("PROBE_B", "512")) if B is None else B


def inputs(dev, seed=None, B=None):
    """(meta, fmeta, d2, f2) on `dev` for B queries (`probe_b`): the TPU
    script's, or with d2 and f2 drawn from `seed` (d2 in [-2^30,
    2^30))."""
    B = probe_b(B)
    meta = (np.random.default_rng(0).integers(0, 64, size=(B, 8),
                                              dtype=np.int32) * 1024)
    if seed is None:
        d2 = torch.zeros((N_ROWS, P.BLK), dtype=torch.int32, device=dev)
        f2 = torch.zeros((N_ROWS, P.BLK), dtype=torch.float32, device=dev)
    else:
        rng = np.random.default_rng(seed)
        d2 = torch.from_numpy(rng.integers(-2**30, 2**30, (N_ROWS, P.BLK),
                                           dtype=np.int32)).to(dev)
        f2 = torch.from_numpy(rng.normal(size=(N_ROWS, P.BLK)).astype(
            np.float32)).to(dev)
    return (torch.from_numpy(meta).to(dev),
            torch.ones((B, 1, 3), dtype=torch.float32, device=dev), d2, f2)


def gdma_arms(meta, d2, f2) -> list:
    B = meta.shape[0]
    out = []
    for Wp, Wm in GDMA_WS:
        rows = (Wp // P.BLK + 8, Wm // P.BLK + 8)
        # the distinct rows of d and f both windows touch, meta, out
        n_bytes = (P.rows_touched(meta, list(enumerate(rows)), N_ROWS)
                   * P.BLK * 8 + B * (32 + 3 * P.BLK * 4))
        for G in GDMA_GS:
            for staged in (True, False):
                out.append(P.Arm(
                    f"g{G}dma Wp={Wp} Wm={Wm} "
                    f"{'staged' if staged else 'direct'}", "probe_gwin",
                    lambda m, G=G, r=rows, s=staged: P.probe_gwin(
                        m, d2, f2, rows=r, G=G, staged=s),
                    lambda m, G=G, r=rows: P.gwin_plain(m, d2, f2, rows=r,
                                                        G=G),
                    n_bytes, B,
                    ring=("probe_gwin", B // G) if staged else ()))
    return out


def arms(dev, seed=None, B=None) -> list:
    """[(meta, arms)]: every arm on the script's inputs for B queries
    (`probe_b`), or on random d and f from `seed`."""
    meta, fmeta, d2, f2 = inputs(dev, seed, B)
    B = meta.shape[0]
    out_b = 3 * P.BLK * 4
    cur_b = B * (8 * 4 + 3 * 4 + out_b)
    fused_b = B * (8 * 4 + out_b)
    floor = [
        P.Arm("cur", "probe_floor",
              lambda m: P.probe_floor(m, layout="cur", fmeta=fmeta),
              lambda m: P.floor_plain(m, layout="cur"), cur_b, B,
              library=P.floor_library),
        P.Arm("curany", "probe_floor",
              lambda m: P.probe_floor(m, layout="cur", fmeta=fmeta,
                                      anys=(d2, f2, d2, f2)),
              lambda m: P.floor_plain(m, layout="cur"), cur_b, B,
              library=P.floor_library),
        P.Arm("fused", "probe_floor", lambda m: P.probe_floor(m),
              lambda m: P.floor_plain(m), fused_b, B,
              library=P.floor_library)]
    floor += [P.Arm(f"g{G}", "probe_floor",
                    lambda m, G=G: P.probe_floor(m, G=G),
                    lambda m, G=G: P.floor_plain(m, G=G), fused_b, B,
                    library=P.floor_library)
              for G in GS]
    return [(meta, floor + gdma_arms(meta, d2, f2))]


def main(device=None, B=None) -> list:
    dev = P.resolve_device(device)
    res = []
    for meta, arms_ in arms(dev, B=B):
        res += P.run_arms(arms_, meta, dev)
    print("random d and f (seed 1), checked only:", flush=True)
    meta, _fmeta, d2, f2 = inputs(dev, seed=1, B=B)
    res += P.run_arms(gdma_arms(meta, d2, f2), meta, dev, timed=False)
    return res


if __name__ == "__main__":
    main()
