"""Tree against tree on one CUDA card: a kernel's device time in each.

    python3 redisearch_tpu_torch/bench/ab.py intersect GROUPS SPEC [SPEC ...]
    python3 redisearch_tpu_torch/bench/ab.py groupby DIR [DIR ...]
    python3 redisearch_tpu_torch/bench/ab.py probes SPEC [SPEC ...]

Each DIR is an unpacked checkout of the repo (for a parent against a
change: parent, change, change, parent).  Every DIR is timed in its own
process that imports `redisearch_tpu_torch` from it.  Device ms are CUDA
events around 20 calls enqueued while the card sleeps, so they time the
device alone.

`intersect`: GROUPS is the file `python3 chip_smoke.py --save-groups
GROUPS` writes (every batch group of the main path that the intersection
kernel B1 serves, on both routes and in raw mode).  A SPEC is a DIR, or
DIR#NAME=VALUE: that tree's `csrc/intersect.cu` built with NAME defined
as VALUE first (one of the macros the source leaves open, as
`B1_RAW_SHAPE=256,1,4`).  In each SPEC's process every group goes through
`intersect_batch`, is held lane for lane against that tree's
`intersect_plain` (not where NAME is B1_TIME_PART: those builds take a
part of the kernel out and are wrong by design) and is timed.  A tree
that refuses a group prints "refused".  Prints a line a group (family,
route, batch, window buckets, bytes bound, each SPEC's ms) and the sum a
family.

`probes`: every arm of the port's four probe scripts
(`bench/probes.py`), and grid_floor's and gstep2's again at B1's batch
of 8,192 (`wide_groups`), through each SPEC's `csrc/probes.cu` (a
DIR#NAME=VALUE SPEC defines one of the macros that source leaves open,
as `PROBE_GW_TILE_MAX=32`); each arm is held against its plain version
and timed, and so is the library call of each group's kernels, where
the tree's arms name one ("library (kernel)"); gstep2's kernel also
runs at 8,192 on windows that do not repeat (`gcols_spread_groups`).
Prints a line an arm: each SPEC's device us a query.

`groupby`: the per-request program that `agg/pipeline.py` `_make_fused`
builds in each DIR, its window program replaced by a fixed window, so
what is timed is the key and operand gathers and the tree's group-by
calls.  Shapes: the `*` request (an iota window of 1,000,064 rows,
groups i % 1,000, sums only) and a MIN/MAX request at the 2-term match
windows (2,048 to 131,072 random docs); G = 1,001, one operand (integer
prices, 99% present), 95% of the window's rows valid; data from seed 5.
Prints the device ms and the host's enqueue us (50 requests, best of 3)
of one request a tree and shape.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_PAD = 1_000_064
G = 1001
# groupby: (window rows, want_minmax, what)
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


def use_define(define: str, lib: str = "intersect") -> None:
    """Point this process's build of `lib` at a file that defines NAME
    as VALUE, then includes the tree's `csrc/<lib>.cu`; `_build` builds
    it (under a name of its own) at the first launch."""
    from redisearch_tpu_torch.ops import _build
    name, _, value = define.partition("=")
    src = _build.SRCS[lib]
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + define.encode()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    wrap = os.path.join(_build.BUILD_DIR, f"ab_{lib}_{tag}.cu")
    with open(wrap, "w") as f:   # the tag rebuilds it for an edited source
        f.write(f"// {tag}\n#define {name} {value}\n#include \"{src}\"\n")
    _build.SRCS[lib] = wrap


def intersect_child(groups_path: str, define: str) -> None:
    """Every saved group through this process's tree: one JSON line a
    group."""
    from redisearch_tpu_torch.ops import intersect as IK
    if define:
        use_define(define)
    check = not define.startswith("B1_TIME_PART=")
    dev = torch.device("cuda", 0)
    data = torch.load(groups_path, weights_only=False)
    arrays = {k: v.to(dev) for k, v in data["arrays"].items()}
    for gi, g in enumerate(data["groups"]):
        a = [arrays[k] for k in g["args"]]
        try:
            out = IK.intersect_batch(*a, **g["kw"])
        except ValueError as e:
            print(json.dumps({"group": gi, "refused": str(e)}), flush=True)
            continue
        if check:
            ref = IK.intersect_plain(*a, **g["kw"])
            for o, r, what in zip(out, ref, ("docs", "scores", "counts")):
                if not torch.equal(o, r):
                    raise AssertionError(f"group {gi}: {what} differ from "
                                         f"the plain version")
        ms = device_ms(lambda: IK.intersect_batch(*a, **g["kw"]))
        print(json.dumps({"group": gi, "ms": ms}), flush=True)


#: the probe scripts that run again at B1's batch, and that batch
WIDE_SCRIPTS = ("grid_floor", "gstep2")
WIDE_B = 8192


def wide_groups(mod, dev) -> list:
    """A probe script's [(meta, arms)] at B = WIDE_B: through its `B=`
    argument or, in a tree whose script takes none, with its module's
    B set for the call (the batch such a script draws its inputs for);
    [] where it has neither."""
    try:
        return mod.arms(dev, B=WIDE_B)
    except TypeError:
        if not hasattr(mod, "B"):
            return []
    saved, mod.B = mod.B, WIDE_B
    try:
        return mod.arms(dev)
    finally:
        mod.B = saved


#: probe_gcols at B1's batch on windows that do not repeat: d of 65,536
#: rows (32 MB, stays in L2) and of 262,144 (128 MB, does not)
SPREAD_ROWS = (65536, 262144)


def gcols_spread_groups(PB, dev) -> list:
    """[(tag, (meta, arms))]: probe_gcols at B = WIDE_B, G = 1 and 4, on
    a d of each SPREAD_ROWS rows (ints in [0, 100)) with window starts
    drawn over all of it (seed 0): against the scripts' 2,048-row d,
    whose 8,192 windows start at 252 rows and repeat, no window is read
    again from L1 or from the ring.  Built from `PB` (a tree's
    `bench/probes.py`), so every tree times the same inputs."""
    out = []
    for n in SPREAD_ROWS:
        rng = np.random.default_rng(0)
        d = torch.from_numpy(rng.integers(0, 100, (n, 128),
                                          dtype=np.int32)).to(dev)
        meta = np.zeros((WIDE_B, 2), np.int32)
        meta[:, 0] = rng.integers(0, n - 32, WIDE_B) * 128
        meta[:, 1] = rng.uniform(0.5, 2.0, WIDE_B).astype(
            np.float32).view(np.int32)
        meta = torch.from_numpy(meta).to(dev)
        n_bytes = (PB.rows_touched(meta, [(0, 32)], n) * 512
                   + WIDE_B * (8 + 512))
        arms = [PB.Arm(f"G={G}", "probe_gcols",
                       lambda m, G=G, d=d: PB.probe_gcols(m, d, G=G),
                       lambda m, G=G, d=d: PB.gcols_plain(m, d, G=G),
                       n_bytes, WIDE_B) for G in (1, 4)]
        out.append((f" B={WIDE_B} spread over {n} rows", (meta, arms)))
    return out


def probes_child(define: str) -> None:
    """Every probe arm through this process's tree: one JSON line an
    arm, and one a library call."""
    import importlib
    if define:
        use_define(define, "probes")
    from redisearch_tpu_torch.bench import probes as PB
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for script, mod_name in PB.SCRIPTS.items():
        mod = importlib.import_module(f"redisearch_tpu_torch.bench.{mod_name}")
        groups = [("", g) for g in mod.arms(dev)]
        if script in WIDE_SCRIPTS:
            groups += [(f" B={WIDE_B}", g) for g in wide_groups(mod, dev)]
        if script == "gstep2":
            groups += gcols_spread_groups(PB, dev)
        for tag, (meta, arms) in groups:
            libs = {}
            for arm in arms:
                bad, _err = PB.compare(arm.run(meta), arm.plain(meta),
                                       arm.tol)
                if bad:
                    raise AssertionError(f"{script}{tag} {arm.name}: {bad} "
                                         f"queries differ from the plain "
                                         f"version")
                us = device_ms(lambda: arm.run(meta)) * 1e3 / arm.B
                print(json.dumps({"arm": f"{script}{tag} {arm.name}",
                                  "us_q": us}), flush=True)
                if getattr(arm, "library", None) is not None:
                    libs.setdefault(arm.kernel, arm)
            for kernel, arm in libs.items():
                us = device_ms(arm.library(meta)) * 1e3 / arm.B
                print(json.dumps({"arm": f"{script}{tag} library ({kernel})",
                                  "us_q": us}), flush=True)


def groupby_child() -> None:
    """Time this process's `_make_fused` at SHAPES."""
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
        print(json.dumps({"shape": what, "n": n, "device_ms": dms,
                          "host_us": hus}), flush=True)


def run_child(spec: str, *args: str) -> list:
    """This script's child mode in the tree SPEC names; its JSON lines."""
    tree, _, define = spec.partition("#")
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", *args, define], cwd=root, env=env,
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise SystemExit(f"{spec} failed ({r.returncode}):\n"
                         f"{r.stderr[-4000:]}")
    return [json.loads(line) for line in r.stdout.splitlines()]


def main(argv) -> None:
    if argv[:1] == ["--child"]:
        if argv[1] == "intersect":
            intersect_child(argv[2], argv[3])
        elif argv[1] == "probes":
            probes_child(argv[2])
        else:
            groupby_child()
        return
    if len(argv) < 2 or argv[0] not in ("intersect", "groupby", "probes") or (
            argv[0] == "intersect" and len(argv) < 3):
        raise SystemExit(__doc__)
    print(torch.cuda.get_device_name(0) + "; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    if argv[0] == "groupby":
        for d in argv[1:]:
            for r in run_child(d, "groupby"):
                print(f"ab {d}: {r['shape']} (n={r['n']}): device "
                      f"{r['device_ms']:.4f} ms a request, host enqueue "
                      f"{r['host_us']:.1f} us a request", flush=True)
        return
    if argv[0] == "probes":
        res = [{r["arm"]: r["us_q"] for r in run_child(s, "probes")}
               for s in argv[1:]]
        for arm in dict.fromkeys(a for r in res for a in r):
            print(f"{arm}: " + ", ".join(
                f"{s} " + (f"{r[arm]:.6f}" if arm in r else "absent")
                for s, r in zip(argv[1:], res)) + " us/q", flush=True)
        return
    groups_path, specs = os.path.abspath(argv[1]), argv[2:]
    groups = torch.load(groups_path, weights_only=False)["groups"]
    ms = [{r["group"]: r.get("ms") for r in
           run_child(s, "intersect", groups_path)} for s in specs]
    tot: dict = {}
    for gi, g in enumerate(groups):
        cells = []
        for si, m in enumerate(ms):
            v = m.get(gi)
            cells.append("refused" if v is None else f"{v:.4f}")
            if v is not None:
                tot[g["fam"], si] = tot.get((g["fam"], si), 0.0) + v
        print(f"{g['fam']} {g['path']} B={g['n']} Ws={g['kw']['Ws']} bound "
              f"{g['bound_ms']:.4f}: "
              + ", ".join(f"{s} {c}" for s, c in zip(specs, cells)),
              flush=True)
    for fam in dict.fromkeys(g["fam"] for g in groups):
        print(f"== {fam} all groups: " + ", ".join(
            f"{s} {tot.get((fam, si), 0.0):.4f}"
            for si, s in enumerate(specs)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
