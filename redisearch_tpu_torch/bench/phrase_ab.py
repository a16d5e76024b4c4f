"""Port of benchmarks/phrase_ab.py: the phrase kernel B2 against B1's
and2 at matched window shapes, and B2 across fill and tf, on one CUDA
card.

    python3 -m redisearch_tpu_torch.bench.phrase_ab [--batch B]
        [--shape Wp,Wm,fill,tf]...

The script's windows (`build`, seed 0, B = 512 queries on one window pair
each): two terms' posting windows of `fill` * W live docs out of 1M
(tf 1, mask 3, doc length 24) and their position-key windows of tf keys
a doc (doc * 64 + 0..tf-1); its four shapes (`SHAPES`): (Wp, Wm, fill,
tf) = (2048, 2048, 0.5, 2), (2048, 8192, 0.5, 2), (8192, 8192, 0.25, 2),
(2048, 2048, 0.5, 4).  A shape runs `ops/intersect.py` `phrase_batch`
(B2) in top-k mode (k 16) and raw mode, and `intersect_batch` (B1) on
the same doc windows as an and2 (the matched shape).  Each is held lane
for lane against its plain version on the same device (`phrase_plain`,
`intersect_plain`: docs, scores bit for bit, counts) before it is timed.

Reported, a line and a record a shape: device us a query of each (CUDA
events around 20 calls enqueued while the card sleeps; the script's
`lax.scan` loop, a way past the TPU link's dispatch cost, is not
needed), the phrase/and2 ratio, and each one's bytes bound over 3.35
TB/s (`workloads.phrase_bytes`, `workloads.intersect_bytes`).  The last
stdout line is one JSON object: `shapes`, `device`.  It runs on `cuda:0`
and raises without a card; `--device cpu` (the tests' way) holds the
plain versions against themselves and times nothing.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from redisearch_tpu_torch.bench import workloads as W
from redisearch_tpu_torch.bench.ab import device_ms
from redisearch_tpu_torch.bench.probes import bound_us, compare
from redisearch_tpu_torch.ops import intersect as IK

BLK = IK.BLK
B = 512
N_DOCS = 1_000_000
STRIDE = 64
K = 16
SHAPES = ((2048, 2048, 0.5, 2), (2048, 8192, 0.5, 2),
          (8192, 8192, 0.25, 2), (2048, 2048, 0.5, 4))
GROUPS = ((IK.REQ, (0,)), (IK.REQ, (1,)))


def build(rng, Wp, Wm, fill, tfm, B=B):
    """phrase_ab.py's `build`: numpy (meta [B, 10]: starts, lens,
    qmasks, position-key starts and lens of the two terms; fmeta [B, 3];
    doc_ids, freqs, masks, doc lengths, poskeys), (Wp, Wm) and the
    position windows (Wp * tf, Wm * tf)."""
    PWp, PWm = Wp * tfm, Wm * tfm
    rows_total = ((Wp + Wm) // BLK + 8)
    pk_total = ((PWp + PWm) // BLK + 8)
    doc_ids = np.full((rows_total * BLK,), 2**31 - 1, np.int32)
    freqs = np.zeros((rows_total * BLK,), np.float32)
    masks = np.zeros((rows_total * BLK,), np.int32)
    dl = np.full((rows_total * BLK,), 24.0, np.float32)
    poskeys = np.full((pk_total * BLK,), 2**31 - 1, np.int32)
    at = pat = 0
    metas = []
    for W_, PW in ((Wp, PWp), (Wm, PWm)):
        live = max(int(W_ * fill), 8)
        docs = np.sort(rng.choice(N_DOCS, size=live,
                                  replace=False)).astype(np.int32)
        doc_ids[at:at + live] = docs
        freqs[at:at + live] = 1.0
        masks[at:at + live] = 3
        plive = live * tfm
        pos = (np.repeat(docs.astype(np.int64) * STRIDE, tfm)
               + np.tile(np.arange(tfm), live))
        poskeys[pat:pat + plive] = np.sort(pos).astype(np.int32)
        metas.append((at, live, 3, pat, plive))
        at += W_
        pat += PW
    meta = np.zeros((B, 10), np.int32)
    for b in range(B):
        for t, (s, l_, qm, ps, pl_) in enumerate(metas):
            meta[b, t] = s
            meta[b, 2 + t] = l_
            meta[b, 4 + t] = qm
            meta[b, 6 + t] = ps
            meta[b, 8 + t] = pl_
    fmeta = np.full((B, 3), 1.0, np.float32)
    fmeta[:, 2] = 24.0
    return ((meta, fmeta, doc_ids, freqs, masks, dl, poskeys), (Wp, Wm),
            (PWp, PWm))


def arms(args, Ws, PWs) -> dict:
    """name -> (the call, its plain version, its bytes fn)."""
    meta, fmeta, d, f, m, dl, pk = args
    imeta = meta[:, :6].contiguous()
    pkw = dict(T=2, Ws=Ws, PWs=PWs, stride=STRIDE, slop=0, k=K)
    ikw = dict(T=2, Ws=Ws, groups=GROUPS, pivot_g=0, k=K)
    return {
        "phrase": (lambda: IK.phrase_batch(*args, **pkw),
                   lambda: IK.phrase_plain(*args, **pkw),
                   lambda o: W.phrase_bytes(meta, fmeta, 2, o)),
        "phrase_raw": (lambda: IK.phrase_batch(*args, raw=True, **pkw),
                       lambda: IK.phrase_plain(*args, raw=True, **pkw),
                       lambda o: W.phrase_bytes(meta, fmeta, 2, o)),
        "and2": (lambda: IK.intersect_batch(imeta, fmeta, d, f, m, dl, **ikw),
                 lambda: IK.intersect_plain(imeta, fmeta, d, f, m, dl, **ikw),
                 lambda o: W.intersect_bytes(imeta, fmeta, 2, GROUPS, 0, o)),
    }


def shape(args, Ws, PWs, dev) -> dict:
    nB = args[0].shape[0]
    r = {}
    for name, (run, plain, nbytes) in arms(args, Ws, PWs).items():
        out = run()
        bad, err = compare(out, plain())
        if bad:
            raise AssertionError(f"phrase_ab {name} W={Ws} PW={PWs}: {bad} "
                                 f"queries differ from the plain version "
                                 f"(max |diff| {err})")
        r[name] = {"bad": bad, "matches": int(out[2].sum()),
                   "bound_us_q": bound_us(nbytes(out)) / nB,
                   "device_us_q": (device_ms(run) * 1e3 / nB
                                   if dev.type == "cuda" else None)}
    if dev.type == "cuda":
        r["ratio"] = r["phrase"]["device_us_q"] / max(
            r["and2"]["device_us_q"], 1e-12)
    return r


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m redisearch_tpu_torch.bench.phrase_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--shape", action="append",
                    help="Wp,Wm,fill,tf (repeatable; default: the four)")
    ap.add_argument("--device", default=device,
                    help="cpu: plain versions only, nothing timed (tests)")
    a = ap.parse_args(argv)
    shapes = SHAPES if not a.shape else [
        (int(p[0]), int(p[1]), float(p[2]), int(p[3]))
        for p in (s.split(",") for s in a.shape)]
    dev = W.open_device(a.device)
    rng = np.random.default_rng(0)
    res = []
    for Wp, Wm, fill, tfm in shapes:
        npargs, Ws, PWs = build(rng, Wp, Wm, fill, tfm, a.batch)
        args = tuple(torch.from_numpy(x).to(dev) for x in npargs)
        r = shape(args, Ws, PWs, dev)
        r.update(Wp=Wp, Wm=Wm, fill=fill, tf=tfm, B=a.batch)
        res.append(r)
        if dev.type == "cuda":
            times = (f"phrase {r['phrase']['device_us_q']:.4f} (raw "
                     f"{r['phrase_raw']['device_us_q']:.4f}) us/q  and2 "
                     f"{r['and2']['device_us_q']:.4f} us/q  ratio "
                     f"{r['ratio']:.2f}x")
        else:
            times = "device not measured"
        print(f"W=({Wp},{Wm}) fill={fill} tf={tfm}: bad=0  {times}  "
              f"bounds phrase {r['phrase']['bound_us_q']:.6f}, and2 "
              f"{r['and2']['bound_us_q']:.6f} us/q", flush=True)
    return W.emit({"shapes": res}, dev)


if __name__ == "__main__":
    main()
