"""The port's counterpart of `benchmarks/gstep_probe2.py`: G queries a
block, each taking the f32 column sums of a 32-row int32 window over
8-row tiles, times an f32 weight whose bits ride in the int32 meta.

    python3 -m redisearch_tpu_torch.bench.probes gstep2

The TPU script's inputs from its seed (B = 64, d [2048, 128] in
[0, 100), meta [B, 2]: the window's first lane, a multiple of 1,024,
and the weight's bits, uniform in [0.5, 2)), and its arms G = 1, 4.
Kernel `probe_gcols`; its sums are exact, so it equals the plain
version bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import probes as P

B = 64
ROWS = P.GCOLS_ROWS
R = 8
N_ROWS = 2048
GS = (1, 4)


def inputs(dev):
    """(meta, d) on `dev`, drawn as the TPU script draws them."""
    rng = np.random.default_rng(0)
    d = rng.integers(0, 100, size=(N_ROWS, P.BLK)).astype(np.int32)
    meta = np.zeros((B, 2), np.int32)
    meta[:, 0] = (rng.integers(0, (N_ROWS - ROWS) // R, B) * R) * P.BLK
    ws = rng.uniform(0.5, 2.0, B).astype(np.float32)
    meta[:, 1] = ws.view(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (meta, d))


def arms(dev) -> list:
    """[(meta, arms)] on the script's inputs."""
    meta, d = inputs(dev)
    # the distinct rows of d the windows touch, meta, out
    n_bytes = (P.rows_touched(meta, [(0, ROWS)], N_ROWS) * P.BLK * 4
               + B * (8 + P.BLK * 4))
    return [(meta, [P.Arm(f"G={G}", "probe_gcols",
                          lambda m, G=G: P.probe_gcols(m, d, G=G),
                          lambda m, G=G: P.gcols_plain(m, d, G=G),
                          n_bytes, B)
                    for G in GS])]


def main(device=None) -> list:
    dev = P.resolve_device(device)
    (meta, arms_), = arms(dev)
    return P.run_arms(arms_, meta, dev)


if __name__ == "__main__":
    main()
