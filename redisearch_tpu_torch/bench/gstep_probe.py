"""The port's counterpart of `benchmarks/gstep_probe.py`: G queries a
block, each reducing an 8,192-lane window of d (int32) and f (f32)
copied from a row offset, with the next window's copies in flight.

    python3 -m redisearch_tpu_torch.bench.probes gstep

The TPU script's inputs from its seed (B = 512, d and f [4096, 128],
meta [B, 2]: the window's first lane, a multiple of 1,024, and the
first live lane, below 64), and its arms G = 1, 2, 4, 8, each in two:
`staged` (a TMA ring of bulk copies on mbarriers) and `direct`
(16-byte loads into registers).  Kernel `probe_gwin`; the truncated f32
sums may differ from the plain version's by 2, the TPU script's own
check.
"""

from __future__ import annotations

import numpy as np
import torch

from . import probes as P

B = 512
W = 8192
N_ROWS = 4096
GS = (1, 2, 4, 8)


def inputs(dev):
    """(meta, d, f) on `dev`, drawn as the TPU script draws them."""
    rng = np.random.default_rng(0)
    rows = W // P.BLK
    d = np.arange(N_ROWS * P.BLK, dtype=np.int32).reshape(N_ROWS, P.BLK) % 997
    f = rng.normal(size=(N_ROWS, P.BLK)).astype(np.float32)
    meta = np.zeros((B, 2), np.int32)
    meta[:, 0] = (rng.integers(0, N_ROWS - rows, B) // 8 * 8) * P.BLK
    meta[:, 1] = rng.integers(0, 64, B)
    return tuple(torch.from_numpy(a).to(dev) for a in (meta, d, f))


def arms(dev) -> list:
    """[(meta, arms)] on the script's inputs."""
    meta, d, f = inputs(dev)
    rows = (W // P.BLK,)
    # the distinct rows of d and f the windows touch, meta, out
    n_bytes = (P.rows_touched(meta, [(0, rows[0])], N_ROWS) * P.BLK * 8
               + B * (8 + P.BLK * 4))
    out = []
    for G in GS:
        for staged in (True, False):
            out.append(P.Arm(
                f"G={G} {'staged' if staged else 'direct'}", "probe_gwin",
                lambda m, G=G, s=staged: P.probe_gwin(m, d, f, rows=rows,
                                                      G=G, staged=s),
                lambda m, G=G: P.gwin_plain(m, d, f, rows=rows, G=G),
                n_bytes, B, tol=2,
                ring=("probe_gwin", B // G) if staged else ()))
    return [(meta, out)]


def main(device=None) -> list:
    dev = P.resolve_device(device)
    (meta, arms_), = arms(dev)
    return P.run_arms(arms_, meta, dev)


if __name__ == "__main__":
    main()
