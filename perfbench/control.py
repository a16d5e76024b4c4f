"""The control of `correct`: the plain reference computed in bfloat16,
the precision below the configurations' float32, put in the program's
place and judged by the float64 reference exactly as a run judges the
program: for KNN the distances computed in bfloat16, for text the
float64 BM25STD scores rounded to bfloat16 and ranked so.  A sound limit
fails it.

    python3 -m perfbench.control --workload <cell> --seed <n> [--seed <n>]...

prints one JSON line a seed: the numbers of the control and, as a check
of the comparison itself, of the float64 reference judged against
itself (all 0).  The queries are the cell's own, at its own size: a
sample, drawn from the seed, of the first batches of its traffic.  No
benchmark run runs this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import compare, corpus, harness as H
from .reference import Reference
from .traffic import Traffic


def sample_items(traffic: Traffic, size: int, seed: int) -> list:
    items, b = [], 0
    while len(items) < 4 * size:
        batch = traffic.batch(b)
        items.extend(H._item(batch, j) for j in range(len(batch)))
        b += 1
    rng = np.random.default_rng(corpus.stream_seed(seed, H.SAMPLE_STREAM))
    return [items[i] for i in rng.choice(len(items), size, replace=False)]


def control_numbers(bench: dict, cell: str, seed: int, dev,
                    scale: dict | None = None) -> dict:
    _, cfg, mix, _ = H.cell_files(bench, cell)
    if scale:
        cfg = {**cfg, **{k: v for k, v in scale.items() if k in cfg}}
        mix = {**mix, **{k: v for k, v in scale.items() if k in mix}}
    return control_of(cfg, mix, seed, dev)


def control_of(cfg: dict, mix: dict, seed: int, dev) -> dict:
    """The control's numbers and the reference's own for one
    configuration and mix."""
    ds = corpus.draw(cfg, seed, dev)
    entry = H.load_module("entries", mix["entry"])
    items = sample_items(Traffic(mix, ds, seed), mix["check"], seed)
    ref, ctl = Reference(ds), Reference(ds, "bfloat16")
    out = {}
    for name, side in (("control", ctl), ("reference", ref)):
        out[name] = compare.combine([
            entry.judge(ref, it, entry.expected(side, it, mix), mix)
            for it in items])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    a = ap.parse_args(argv)
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    bench = H.load_bench()
    for seed in a.seed:
        out = control_numbers(bench, a.workload, seed, dev)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "device": str(dev), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
