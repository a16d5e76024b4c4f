"""The program's own spans (`redisearch_tpu_torch/utils/trace.py`), as
the per-layer metrics of `metrics/` read them.

The program records its spans while `torch.profiler` records, so in a
`--trace 1` run they cover the profiled batches (`Run.profiled`): the
newest that many batches whose root span `search` was recorded.  A
metric is a mean over those batches of a span's self time (its
durations less the part its child spans cover) or of its calls.  A
program without the recorder, or a run that recorded no root, reads
None."""

from __future__ import annotations

import collections

ROOT = "search"


def _records() -> list:
    try:
        from redisearch_tpu_torch.utils import trace
    except ImportError:      # a program without the recorder
        return []
    return trace.records()


def batches(run) -> dict:
    """{batch id: [records]} of the run's profiled batches whose root
    was recorded."""
    n = len(run.profiled)
    if not n:
        return {}
    recs = _records()
    ids = [r.batch for r in recs if r.name == ROOT and r.parent is None]
    keep = set(ids[-n:])
    out = collections.defaultdict(list)
    for r in recs:
        if r.batch in keep:
            out[r.batch].append(r)
    return dict(out)


def self_ms(run, name: str):
    """Mean self time of `name` a batch, in ms."""
    bs = batches(run)
    if not bs:
        return None
    ns = sum(r.end_ns - r.start_ns - r.child_ns
             for recs in bs.values() for r in recs if r.name == name)
    return ns / len(bs) / 1e6


def calls(run, name: str):
    """Mean calls of `name` a batch."""
    bs = batches(run)
    if not bs:
        return None
    return sum(r.name == name for recs in bs.values() for r in recs
               ) / len(bs)
