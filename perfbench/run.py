"""Run one cell of BENCHMARK.json once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`
(with `--trace 1` also `busy_s` and `window_s`), with `--trace 1`
`breakdown`, and last `checks`: each number compared with the reference
beside its limit.  The same numbers are the last lines of standard error.

It exits with 1 and prints no result where no CUDA card is present or
fewer than the cell asks for, and where a module named `jax`, `jaxlib`,
`flax` or `redisearch_tpu` (top-level names compared whole) is loaded
once the window has closed.  Compile caches stay inside the checkout
(`perfbench/out/cache/`), at fixed paths; the host's thread pools are
held to one thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "out", "cache")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    a = parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    # one process, few threads: the host's cores are shared, and the
    # program's host work is one Python thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    from perfbench import harness as H
    bench = H.load_bench()
    cell = next((w for w in bench["workloads"] if w["name"] == a.workload),
                None)
    if cell is None:
        H.log(f"no cell {a.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        H.log(f"the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present")
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = H.run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                     dev, t_start)
    bad = H.forbidden_modules()
    if bad:
        H.log(f"forbidden modules loaded: {bad}")
        return 1
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
