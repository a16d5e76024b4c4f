"""Port of benchmarks/intersect_micro.py: B1's cost a query as one knob
moves (window sizes, k, batch), on one CUDA card.

    python3 -m redisearch_tpu_torch.bench.intersect_micro [--batch B]
        [--point Wp,Wm]...

The script's windows (`make_windows`, seed 0): B queries over a pool of
16 (pivot, member) window pairs of sorted random docs out of 1M, whole
windows live, tf 1-3, mask 3, doc length 24, one spare row between
windows; and its sweep (`SWEEP`): (Wp, Wm) in (8192, 32768),
(8192, 131072), (32768, 131072), (2048, 8192) at k = 16 and k = 1 and
B = 512, then B = 128 and 1,024 at the modal shape (8192, 32768), k 16.
`--batch` and `--point` run one point of each listed shape instead, at
k 16 and 1.

Each point goes through `ops/intersect.py` `intersect_batch` (B1; an
and2: groups ((REQ, (0,)), (REQ, (1,))), pivot group 0) and is held
lane for lane against `intersect_plain` on the same device (docs, scores
bit for bit, counts) before it is timed.  Reported, a line and a record
a point: device us a query (CUDA events around 20 calls enqueued while
the card sleeps, `bench/ab.py` `device_ms`), wall us a query (host
clock around 8 calls ending in a synchronize, best of 3), and two bytes
bounds over 3.35 TB/s: `bound_us_q` counts what each query needs B1 to
move (`workloads.intersect_bytes`, as `chip_smoke.py` counts the main
path's groups; the pool's windows repeat, so the card reads most of
them from L2) and `distinct_bound_us_q` the pool's 16 window pairs read
once.  The last stdout line is one JSON object: `points`, `device`.  It
runs on `cuda:0` and raises without a card; `--device cpu` (the tests'
way) holds the plain version against itself and times nothing.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.bench.ab import device_ms
from redisearch_tpu_torch.bench.probes import bound_us, compare, wall_s
from redisearch_tpu_torch.ops import intersect as IK

BLK = IK.BLK
N_DOCS = 1_000_000
N_UNIQUE = 16
GROUPS = ((IK.REQ, (0,)), (IK.REQ, (1,)))
#: the script's sweep: (B, Wp, Wm, ks), in its order (the windows of a
#: point are drawn from one generator in this order)
SWEEP = ([(512, Wp, Wm, (16, 1)) for Wp, Wm in
          ((8192, 32768), (8192, 131072), (32768, 131072), (2048, 8192))]
         + [(Bx, 8192, 32768, (16,)) for Bx in (128, 1024)])


def make_windows(rng, B, Wp, Wm, n_unique=N_UNIQUE, n_docs=N_DOCS):
    """intersect_micro.py's `make_windows`: numpy (meta [B, 6], fmeta
    [B, 3], doc_ids, freqs, masks, doc lengths), the flat posting arrays
    of whole 128-lane rows."""
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
        for W_ in (Wp, Wm):
            docs = np.sort(rng.choice(n_docs, size=W_, replace=False)
                           ).astype(np.int32)
            rows_w = W_ // BLK
            doc_ids[at:at + rows_w] = docs.reshape(rows_w, BLK)
            freqs[at:at + rows_w] = 1.0 + (u % 3)
            masks[at:at + rows_w] = 3
            entry.append((at * BLK, W_))
            at += rows_w + 1
        pool.append(entry)
    for b in range(B):
        for t in (0, 1):
            meta[b, t] = pool[b % n_unique][t][0]
            meta[b, 2 + t] = pool[b % n_unique][t][1]
            meta[b, 4 + t] = 3
        fmeta[b] = (2.0, 1.5, 24.0)
    return (meta, fmeta, doc_ids.reshape(-1), freqs.reshape(-1),
            masks.reshape(-1), dl.reshape(-1))


def point(args, Wp, Wm, k, dev) -> dict:
    """One point: B1 against its plain version, then (on a card) timed."""
    B = args[0].shape[0]
    kw = dict(T=2, Ws=(Wp, Wm), groups=GROUPS, pivot_g=0, k=k)

    def run(meta=args[0]):
        return IK.intersect_batch(meta, *args[1:], **kw)

    out = run()
    bad, err = compare(out, IK.intersect_plain(*args, **kw))
    if bad:
        raise AssertionError(f"intersect_micro Wp={Wp} Wm={Wm} k={k} B={B}: "
                             f"{bad} queries differ from intersect_plain "
                             f"(max |diff| {err})")
    n_bytes = W.intersect_bytes(args[0], args[1], 2, GROUPS, 0, out)
    # the pool's windows read once, with the meta and the outputs
    distinct = (16 * N_UNIQUE * (Wp + Wm)
                + W.nbytes(args[0], args[1], *out))
    r = {"B": B, "Wp": Wp, "Wm": Wm, "k": k, "bad": bad,
         "matches": int(out[2].sum()),
         "bound_us_q": bound_us(n_bytes) / B,
         "distinct_bound_us_q": bound_us(distinct) / B,
         "device_us_q": None, "wall_us_q": None}
    if dev.type == "cuda":
        r["device_us_q"] = device_ms(run) * 1e3 / B
        r["wall_us_q"] = wall_s(run, [args[0]]) * 1e6 / B
    return r


def sweep(dev, points=SWEEP) -> list:
    rng = np.random.default_rng(0)
    res = []
    for B, Wp, Wm, ks in points:
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in make_windows(rng, B, Wp, Wm))
        for k in ks:
            r = point(args, Wp, Wm, k, dev)
            res.append(r)
            times = ("device not measured, wall not measured"
                     if r["device_us_q"] is None else
                     f"device {r['device_us_q']:9.4f} us/q  wall "
                     f"{r['wall_us_q']:9.4f} us/q")
            print(f"B={B:5d} Wp={Wp:6d} Wm={Wm:6d} k={k:2d}: bad=0  "
                  f"{times}  bound {r['bound_us_q']:.6f} us/q (distinct "
                  f"{r['distinct_bound_us_q']:.6f})", flush=True)
        del args
    return res


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.intersect_micro",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int)
    ap.add_argument("--point", action="append",
                    help="Wp,Wm (repeatable; with --batch)")
    ap.add_argument("--device", default=device,
                    help="cpu: plain versions only, nothing timed (tests)")
    a = ap.parse_args(argv)
    if (a.batch is None) != (a.point is None):
        ap.error("--batch and --point go together")
    pts = SWEEP if a.batch is None else [
        (a.batch, *map(int, p.split(",")), (16, 1)) for p in a.point]
    dev = W.open_device(a.device)
    return W.emit({"points": sweep(dev, pts)}, dev)


if __name__ == "__main__":
    main()
