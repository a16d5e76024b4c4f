"""Tiny sizes for the CPU tests: each cell at a few thousand documents
and small batches, through the program's plain versions."""

import time

import torch

from perfbench import harness as H

SCALE = {"n_docs": 3000, "batch": 32, "check": 48, "warmup_batches": 1}
CELLS = tuple(w["name"] for w in H.load_bench()["workloads"])


def bench() -> dict:
    return H.load_bench()


def run(name, seed=20261018, traced=False, seconds=0.5, bench=None,
        scale=SCALE):
    return H.run_cell(bench or H.load_bench(), name, seed, seconds,
                      traced, torch.device("cpu"), time.perf_counter(),
                      scale=scale)
