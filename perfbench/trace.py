"""Spans around the program's layers, and the device trace.

Spans are the benchmark's own: in a traced run `Spans.install` wraps the
calls into each layer where the program looks them up (a module's global
name, a class's method), and takes the wrappers out again after the
window.  A span counts host time once per outermost call of its layer
(`execute_batch`'s own wait on its batch handle stays in it), and names
itself to the profiler (`record_function`), so the idle gaps of the
device trace can be laid against what the host was doing.

`device_summary` reads a `torch.profiler` trace: the union of the
device-side intervals (kernels, copies, sets; not the spans' own
annotations on the device timeline) as busy time, the device
operations that took most time, and the idle time by the innermost
span the host was in (a copy of the union in
`redisearch_tpu_torch/bench/workloads.py` `device_busy_us`).
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

#: (module, attribute, span): where the program looks each layer up
LAYERS = (
    ("redisearch_tpu_torch.index.index", "SearchIndex.search_many",
     "search_many"),
    ("redisearch_tpu_torch.index.index", "SearchIndex.prepare", "prepare"),
    ("redisearch_tpu_torch.index.index", "execute_batch", "execute_batch"),
    ("redisearch_tpu_torch.query.engine", "_BatchHandle.result",
     "execute_batch"),
)


class Spans:
    """Host seconds spent inside each layer, over the calls made while
    installed."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._depth = collections.defaultdict(int)
        self._saved = []

    def _wrap(self, name, fn):
        def wrapper(*a, **kw):
            if self._depth[name]:
                return fn(*a, **kw)
            self._depth[name] += 1
            t0 = time.perf_counter()
            try:
                if not torch.autograd._profiler_enabled():
                    return fn(*a, **kw)
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
                self._depth[name] -= 1
        return wrapper

    def install(self) -> None:
        import importlib
        for mod_name, attr, name in LAYERS:
            owner = importlib.import_module(mod_name)
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            fn = getattr(owner, leaf)
            self._saved.append((owner, leaf, fn))
            setattr(owner, leaf, self._wrap(name, fn))

    def remove(self) -> None:
        for owner, leaf, fn in reversed(self._saved):
            setattr(owner, leaf, fn)
        self._saved.clear()


def _merge(spans):
    """Union of (start, end) intervals: [(start, end)] ascending."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(host):
    """The host timeline cut where any span starts or ends:
    [(start, end, label)] ascending, each piece labelled by the innermost
    span covering it (the latest started), "outside spans" where none
    does."""
    cuts = sorted({t for h in host for t in h[:2]})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        cover = [h for h in host if h[0] <= a and b <= h[1]]
        out.append((a, b, max(cover, key=lambda h: (h[0], -h[1]))[2] if cover
                    else "outside spans"))
    return out


def device_summary(prof, span_names, top: int = 10) -> dict:
    """busy seconds, the top device operations by summed seconds, and
    the idle seconds by what the host was doing: each idle gap of the
    device, between the first span's start and the last span's end, is
    split over the innermost spans it overlaps."""
    dev, host = [], []
    by_op = collections.defaultdict(float)
    for ev in prof.events():
        tr = ev.time_range
        if ev.name in span_names:
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                host.append((tr.start, tr.end, ev.name))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end))
            by_op[ev.name[:120]] += tr.elapsed_us() / 1e6
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = collections.defaultdict(float)
    if host:
        lo = min(h[0] for h in host)
        hi = max(h[1] for h in host)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        pieces = _innermost(host)
        starts = [p[0] for p in pieces]
        for a, b in zip(edges[::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(pieces) and pieces[i][0] < b:
                pa, pb, label = pieces[i]
                over = min(b, pb) - max(a, pa)
                if over > 0:
                    gaps[label] += over / 1e6
                i += 1
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in idle]}
