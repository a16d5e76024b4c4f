"""One run of one cell: set-up, the measured window, the traced reading,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is found by its name: `configs/<config>.json` (through
BENCHMARK.json's `file`), `mixes/<traffic>.json`,
`entries/<entry>.py`, `metrics/<metric>.py` and `limits/<cell>.json`.

The window is a closed loop: the next batch is submitted when the
previous one has returned with its results on the host.  A request's
latency is its batch's, from submission to return.  Set-up (imports,
the data's draw, the bulk build, warm-up batches) is timed on the host clock from the start
of the process.  With `trace`, spans are installed for the window and
`torch.profiler` records its first `PROFILE_SECONDS` (at least one
batch).  After the window the program's state is freed and a sample of
the window's answers, drawn from the seed, is judged against the
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import compare, corpus, trace as T
from .reference import Reference
from .traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROFILE_SECONDS = 3.0
#: top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "redisearch_tpu")
SAMPLE_STREAM = 91


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's folder, by file (names
    may hold '-' and '.')."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(bench: dict, name: str, root: str = ROOT) -> tuple:
    """(cell entry, configuration, mix, limits) of a cell."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    return (cell, cfg, corpus.load_json("mixes", cell["traffic"]),
            corpus.load_json("limits", name))


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    `traced` its per-layer ones."""
    def reports(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if reports(m)
            and ("workloads" in m or m["moves"] in names)]


def schema_fields(cfg: dict) -> list:
    from redisearch_tpu_torch.schema import Field, FieldType, VectorParams
    out = []
    for f in cfg["fields"]:
        ty = FieldType[f["type"]]
        kw = {"sortable": f.get("sortable", False)}
        if ty == FieldType.VECTOR:
            kw["vector"] = VectorParams(dim=f["dim"], metric=f["metric"])
        elif ty == FieldType.TEXT:
            kw["weight"] = float(f.get("weight", 1.0))
            kw["nostem"] = bool(f.get("nostem", False))
        out.append(Field(f["name"], ty, **kw))
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line() -> str | None:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def log(*a) -> None:
    print("perfbench:", *a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers (`metrics/*.py`) read
    it."""
    cell: dict
    cfg: dict
    mix: dict
    ds: object
    dev: torch.device
    seconds: float
    traced: bool
    client: object = None
    index: object = None
    index_name: str = ""
    setup_s: float = 0.0
    requests: int = 0
    failed: int = 0
    window_s: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    sizes: list = dataclasses.field(default_factory=list)
    spans: object = None           # trace.Spans of the window
    device: dict | None = None     # trace.device_summary + window_s
    profiled: list = dataclasses.field(default_factory=list)
    distinct: set = dataclasses.field(default_factory=set)
    gc: dict = dataclasses.field(default_factory=dict)  # per generation
    ref: object = None
    peaks: dict = dataclasses.field(default_factory=dict)

    @property
    def batches(self) -> int:
        return len(self.latencies)


class Sample:
    """A uniform sample of the window's requests, drawn from the seed
    (reservoir sampling): each kept request's inputs and answer."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(corpus.stream_seed(seed,
                                                            SAMPLE_STREAM))
        self.items: list = [None] * size
        self.seen = 0

    def offer(self, batch, results, entry) -> None:
        n = len(batch)
        g = np.arange(self.seen, self.seen + n)
        slot = self.rng.integers(0, g + 1)
        early = g < self.size
        slot[early] = g[early]
        for j in np.flatnonzero(slot < self.size).tolist():
            item = _item(batch, j)
            self.items[slot[j]] = (item, entry.answer(results[j], item))
        self.seen += n

    def kept(self) -> list:
        return [x for x in self.items if x is not None]


def _item(batch, j: int) -> dict:
    return {"query": batch.queries[j], "family": batch.families[j],
            "params": batch.params[j] if batch.params else None,
            "vector": batch.vectors[j]}


def setup(run: Run, seed: int) -> None:
    """Draw the data and build the index through the program."""
    from redisearch_tpu_torch.api import Client
    cfg, dev = run.cfg, run.dev
    t0 = time.perf_counter()
    run.ds = corpus.draw(cfg, seed, dev)
    docs = run.ds.docs()
    log(f"data: {len(docs)} documents drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    run.client = Client(device=dev)
    run.index_name = cfg["index"]
    run.index = run.client.ft_create(run.index_name, schema_fields(cfg))
    t0 = time.perf_counter()
    run.index.add_documents(docs)
    sync(dev)
    log(f"ingest: {len(docs)} documents in "
        f"{time.perf_counter() - t0:.1f}s")


class _GcWatch:
    """A `gc.callbacks` entry: seconds and collections of Python's
    cyclic collector by generation, into `into[gen] = [seconds, n]`."""

    def __init__(self, into: dict):
        self.into, self.t0 = into, None

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            acc = self.into.setdefault(info["generation"], [0.0, 0])
            acc[0] += time.perf_counter() - self.t0
            acc[1] += 1
            self.t0 = None


def window(run: Run, traffic: Traffic, entry, sample: Sample) -> None:
    """The measured window: a closed loop of batches for `run.seconds`
    (the last batch ends it), traced when `run.traced`."""
    prof, spans = None, None
    if run.traced:
        spans = T.Spans()
        spans.install()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        t_prof = time.perf_counter()
    gc_watch = _GcWatch(run.gc)
    gc.callbacks.append(gc_watch)
    t_w = time.perf_counter()
    b = 0
    try:
        while True:
            batch = traffic.batch(b)
            t0 = time.perf_counter()
            try:
                results = entry.submit(run, batch)
            except Exception:   # a failed batch is counted, not fatal
                traceback.print_exc()
                results = None
            t1 = time.perf_counter()
            run.latencies.append(t1 - t0)
            run.sizes.append(len(batch))
            run.distinct.update(batch.queries)
            run.requests += len(batch)
            if results is None:
                run.failed += len(batch)
            else:
                sample.offer(batch, results, entry)
            if prof is not None:
                run.profiled.append(batch)
                if t1 - t_prof >= PROFILE_SECONDS or t1 - t_w >= run.seconds:
                    sync(run.dev)
                    run.device = {"window_s": time.perf_counter() - t_prof,
                                  "prof": prof}
                    prof.__exit__(None, None, None)
                    prof = None
            b += 1
            if t1 - t_w >= run.seconds:
                break
    finally:
        run.window_s = time.perf_counter() - t_w
        gc.callbacks.remove(gc_watch)
        if spans is not None:
            spans.remove()
            run.spans = spans


def judge(run: Run, entry, sample: Sample, limits: dict) -> dict:
    """The sample's numbers; each query off a limit (the first three) is
    logged with its served and its expected answer."""
    ref = run.ref
    per_query = []
    shown = 0
    for item, ans in sample.kept():
        nums = entry.judge(ref, item, ans, run.mix)
        per_query.append(nums)
        off = [k for k, v in nums.items() if v > limits.get(k, v)]
        if off and shown < 3:
            shown += 1
            exp = entry.expected(ref, item, run.mix)
            log(f"off limit {off}: {item['query']!r}\n  served   "
                f"{str(ans)[:1500]}\n  expected {str(exp)[:1500]}")
    return compare.combine(per_query)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, dev: torch.device, t_start: float,
             scale: dict | None = None) -> dict:
    """Run the cell once; returns the result line's object.  `scale`
    (tests only) overrides configuration and mix sizes."""
    cell, cfg, mix, limits = cell_files(bench, name)
    if scale:
        cfg = {**cfg, **{k: v for k, v in scale.items() if k in cfg}}
        mix = {**mix, **{k: v for k, v in scale.items() if k in mix}}
    run = Run(cell=cell, cfg=cfg, mix=mix, ds=None, dev=dev,
              seconds=seconds, traced=traced,
              peaks=corpus.load_json("", "peaks"))
    card = card_line() if dev.type == "cuda" else None
    setup(run, seed)
    entry = load_module("entries", mix["entry"])
    traffic = Traffic(mix, run.ds, seed)
    for w in range(mix.get("warmup_batches", 1)):
        entry.submit(run, traffic.batch(w, warm=True))
    sync(dev)
    # every window starts from the same collector state: set-up's own
    # garbage is collected in set-up, not at a point of the window that
    # moves with the host's speed
    gc.collect()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up: {run.setup_s:.1f}s")

    sample = Sample(mix["check"], seed)
    window(run, traffic, entry, sample)
    q = np.quantile(run.latencies, [0, 0.1, 0.5, 0.9, 1])
    log(f"window: {run.requests} requests in {run.batches} batches, "
        f"{run.window_s:.2f}s; batch s min {q[0]:.4f} p10 {q[1]:.4f} "
        f"median {q[2]:.4f} p90 {q[3]:.4f} max {q[4]:.4f}; "
        f"repeated query strings "
        f"{100.0 * (1 - len(run.distinct) / max(run.requests, 1)):.2f}%")
    # the host's speed through the window: batches of each fifth of it
    ends = np.cumsum(run.latencies)
    fifth = np.minimum((5 * ends / max(ends[-1], 1e-9)).astype(int), 4)
    log("batch s median by fifth of the window: " + " ".join(
        f"{np.median(np.asarray(run.latencies)[fifth == i]):.4f}"
        if (fifth == i).any() else "-" for i in range(5)))
    log("collector in the window: " + ", ".join(
        f"generation {g} {n} runs {t:.3f}s" for g, (t, n) in
        sorted(run.gc.items())))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if run.device is not None:
        prof = run.device.pop("prof")
        run.device.update(T.device_summary(
            prof, {n for _, _, n in T.LAYERS}))
        del prof
    run.client = run.index = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run.ref = Reference(run.ds)
    t0 = time.perf_counter()
    numbers = judge(run, entry, sample, limits["limits"])
    numbers["failed_requests"] = run.failed
    log(f"check: {len(sample.kept())} answers judged in "
        f"{time.perf_counter() - t0:.1f}s")
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": numbers.get(k), "limit": lim}
              for k, lim in limits["limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": peak,
              "nvidia_smi": card}
    out = {"correct": correct, "attempted": run.requests,
           "failed": run.failed, "metrics": metrics, "device": device}
    if traced and run.device is not None:
        device["busy_s"] = run.device["busy_s"]
        device["window_s"] = run.device["window_s"]
        out["breakdown"] = {"device_ops": run.device["device_ops"],
                            "idle_gaps": run.device["idle_gaps"]}
    out["checks"] = checks
    return out
