"""The port's counterpart of `benchmarks/kernel_probe.py`: B1's step
cut into modes, beside the port's B1 on the same inputs.

    python3 -m redisearch_tpu_torch.bench.probes kernel

  empty   one block a query reads its meta and fmeta rows and writes
          zero outputs
  load    adds every byte of the slots' windows (doc, freq, mask, and
          doc length for the pivot slot) through a TMA ring of bulk
          copies on mbarriers in shared memory
  phase   adds the pivot window's in-range & qmask test, BM25 and a
          running top-16 as each pivot tile arrives (ties to the lowest
          lane); no member pass
  full    the port's B1 (`ops/intersect.intersect_batch`, slot 0 the
          pivot, slot 1 a required member, k = 16)

The TPU script's inputs from its seed: B = 512, T = 2, (Wp, Wm) =
(2048, 8192) and (8192, 32768), 16 distinct pairs of windows of doc ids
drawn over 1M docs, each query one of them.  Kernel `probe_variant`
(empty, load, phase) and B1 (full), each held against its plain version
exactly.  The four arms' device times split B1's per-query time on this
card into the step floor, the loads, the phase and the member pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import intersect as IK
from . import probes as P

B = 512
T = 2
K = 16
N_DOCS = 1_000_000
WS = ((2048, 8192), (8192, 32768))
GROUPS = ((0, (0,)), (0, (1,)))


def make_windows(rng, Wp, Wm, n_unique=16):
    """The TPU script's make_windows: (meta, fmeta, doc_ids, freqs,
    masks, dl) as numpy, the arrays [rows, 128]."""
    BLK = P.BLK
    rows_total = (n_unique * (Wp + Wm)) // BLK + 4 * n_unique
    doc_ids = np.full((rows_total, BLK), 2**31 - 1, np.int32)
    freqs = np.zeros((rows_total, BLK), np.float32)
    masks = np.zeros((rows_total, BLK), np.int32)
    dl = np.full((rows_total, BLK), 24.0, np.float32)
    meta = np.zeros((B, 6), np.int32)
    fmeta = np.zeros((B, 3), np.float32)
    at = 0
    pool = []
    for u in range(n_unique):
        entry = []
        for W in (Wp, Wm):
            docs = np.sort(rng.choice(N_DOCS, size=W, replace=False)
                           ).astype(np.int32)
            rows_w = W // BLK
            doc_ids[at:at + rows_w] = docs.reshape(rows_w, BLK)
            freqs[at:at + rows_w] = 1.0 + (u % 3)
            masks[at:at + rows_w] = 3
            entry.append((at * BLK, W))
            at += rows_w + 1
        pool.append(entry)
    for b in range(B):
        for t in (0, 1):
            meta[b, t] = pool[b % n_unique][t][0]
            meta[b, 2 + t] = pool[b % n_unique][t][1]
            meta[b, 4 + t] = 3
        fmeta[b] = (2.0, 1.5, 24.0)
    return meta, fmeta, doc_ids, freqs, masks, dl


def b1_bytes(meta, n_lanes: int) -> int:
    """What B1 must move for these queries at least: the distinct live
    pivot postings (doc, freq, mask, doc length), the distinct member
    postings probed, one a pivot posting (doc, freq, mask), meta, fmeta
    and the outputs (docs and scores [B, 128]: one phase's k lanes
    rounded up to 128; counts [B]).  Queries that share a window share
    its bytes."""
    plen = meta[:, 2].to(torch.int64)
    probe = torch.minimum(meta[:, 3].to(torch.int64), plen)
    return (16 * P.covered(meta[:, 0], plen, n_lanes)
            + 12 * P.covered(meta[:, 1], probe, n_lanes)
            + B * (6 + 3) * 4 + B * (2 * P.BLK * 4 + 4))


def arms(dev) -> list:
    """[(meta, arms)], one group a window shape, on the script's
    inputs (one rng across both shapes, as the script draws them)."""
    rng = np.random.default_rng(0)
    groups = []
    for Wp, Wm in WS:
        meta, fmeta, d2, f2, m2, dl2 = (
            torch.from_numpy(a).to(dev)
            for a in make_windows(rng, Wp, Wm))
        Ws = (Wp, Wm)
        rows = P.variant_rows(Ws)
        meta_b = B * (6 + 3) * 4 + 3 * B * P.BLK * 4
        # the distinct rows read: doc, freq and mask of both slots'
        # windows, doc length of the pivot's
        n_rows = d2.shape[0]
        win_b = (3 * P.rows_touched(meta, list(enumerate(rows)), n_rows)
                 + P.rows_touched(meta, [(0, rows[0])], n_rows)
                 ) * P.BLK * 4
        tag = f"Wp={Wp:5d} Wm={Wm:5d}"
        arms_ = []
        for mode in P.VARIANT_MODES:
            arms_.append(P.Arm(
                f"{tag} {mode}", "probe_variant",
                lambda m, mode=mode, a=(fmeta, d2, f2, m2, dl2), Ws=Ws:
                P.probe_variant(m, *a, Ws=Ws, k=K, mode=mode),
                lambda m, mode=mode, a=(fmeta, d2, f2, m2, dl2), Ws=Ws:
                P.variant_plain(m, *a, Ws=Ws, k=K, mode=mode),
                meta_b + (win_b if mode != "empty" else 0), B,
                ring=() if mode == "empty" else
                ("probe_variant", B, K if mode == "phase" else 0)))
        flat = [a.reshape(-1) for a in (d2, f2, m2, dl2)]
        kw = dict(T=T, Ws=Ws, groups=GROUPS, pivot_g=0, k=K)
        arms_.append(P.Arm(
            f"{tag} full", "intersect",
            lambda m, f=flat, fm=fmeta, kw=kw: IK.intersect_batch(
                m, fm, *f, **kw),
            lambda m, f=flat, fm=fmeta, kw=kw: IK.intersect_plain(
                m, fm, *f, **kw),
            b1_bytes(meta, d2.numel()), B))
        groups.append((meta, arms_))
    return groups


def main(device=None) -> list:
    dev = P.resolve_device(device)
    res = []
    for meta, arms_ in arms(dev):
        res += P.run_arms(arms_, meta, dev)
    return res


if __name__ == "__main__":
    main()
