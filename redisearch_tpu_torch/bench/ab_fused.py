"""Tree against tree: the window branch's per-request group-by on the card.

    python3 redisearch_tpu_torch/bench/ab_fused.py DIR [DIR ...]

Each DIR is an unpacked checkout of the repo (for a parent against a
change: parent, change, change, parent).  For each, in its own process
that imports `redisearch_tpu_torch` from DIR, this times the per-request
program that `agg/pipeline.py` `_make_fused` builds there, its window
program replaced by a fixed window, so what is timed is the key and
operand gathers and the tree's group-by calls.  Shapes: the `*` request
(an iota window of 1,000,064 rows, groups i % 1,000, sums only) and a
MIN/MAX request at the 2-term match windows (2,048 to 131,072 random
docs); G = 1,001, one operand (integer prices, 99% present), 95% of the
window's rows valid; data from seed 5.  Prints, per tree and shape, the
device ms of one request (CUDA events around 20 requests enqueued while
the card sleeps, so they time the device) and the host's enqueue us of
one request (50 requests, best of 3).  Needs one CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

N_PAD = 1_000_064
G = 1001
# (window rows, want_minmax, what)
SHAPES = [(N_PAD, False, "the * request, sums only"),
          (2048, True, "window 2,048, min/max"),
          (8192, True, "window 8,192, min/max"),
          (32768, True, "window 32,768, min/max"),
          (131072, True, "window 131,072, min/max")]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of fn: CUDA events around `iters` calls
    enqueued behind a `torch.cuda._sleep` that covers the host's
    enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(max(2.0 * host_s, 1e-3), 2.0) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(fn, iters: int = 50) -> float:
    """The host's enqueue time of one call of fn (best of 3)."""
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        best = dt if best is None else min(best, dt)
    return best


def child(label: str):
    """Time this process's `_make_fused` (imported from the tree on
    PYTHONPATH) at SHAPES."""
    import types
    from redisearch_tpu_torch.agg import pipeline as AP
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(5)

    def col(a):
        return torch.as_tensor(a, device=dev)[None]

    seg_args = {"gb_keys": col((np.arange(N_PAD) % 1000).astype(np.int32)),
                "gb_num_vals": col(rng.integers(1, 10_000, N_PAD)
                                   .astype(np.float32)),
                "gb_num_pres": col(rng.random(N_PAD) < 0.99)}
    for n, mm, what in SHAPES:
        if n == N_PAD:
            docs = torch.arange(n, dtype=torch.int32, device=dev)
            cq = types.SimpleNamespace(tree=("leaf", AP.LAll(), 0))
        else:
            docs = torch.as_tensor(np.sort(rng.choice(N_PAD, n, replace=False))
                                   .astype(np.int32), device=dev)
            cq = types.SimpleNamespace(tree=("and", ()))
        out = {"docs": docs,
               "valid": torch.as_tensor(rng.random(n) < 0.95, device=dev),
               "count": torch.tensor(n, device=dev)}
        fused = AP._make_fused(cq, lambda _s, _d, _o=out: _o, G, [G],
                               ["price"], [], ["price"], mm)
        res = fused(seg_args, None)
        if not torch.isfinite(res["g.0.sum"]).all():
            raise AssertionError(f"{what}: non-finite sums")
        dms = device_ms(lambda: fused(seg_args, None))
        hus = host_us(lambda: fused(seg_args, None))
        print(f"ab {label}: {what} (n={n}): device {dms:.4f} ms a request, "
              f"host enqueue {hus:.1f} us a request", flush=True)


def main(dirs):
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        root = os.path.abspath(d)
        env = dict(os.environ, PYTHONPATH=root)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", d], cwd=root, env=env,
                           capture_output=True, text=True, timeout=900)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            raise SystemExit(f"ab {d} failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main(sys.argv[1:])
