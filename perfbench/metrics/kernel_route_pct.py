"""kernel_route_pct: the queries that the intersection kernel (B1, on
its narrow route `kernel` or its wide route `kernel-wide`) or the
phrase kernel (B2, `phrase-kernel`) served, as a share of all the
queries the engine served, over the profiled batches the program
recorded (`program_spans.batches`).

It reads the program's counts `engine.queries.<path>`
(`utils/trace.py` `count`: the engine adds a group's queries to its
executor path's count where it bumps `QUERY_PATH_STATS`).  The engine
serves a query once for each segment, so the share is of (query,
segment) pairs; an index of one segment serves each query once.  None
from a program without counts, and where the batches counted
nothing."""

from perfbench import program_spans

KERNEL_PATHS = ("kernel", "kernel-wide", "phrase-kernel")
PREFIX = "engine.queries."


def served(run) -> dict:
    """{executor path: queries} over the profiled batches, {} where
    nothing was counted."""
    ids = program_spans.batches(run)
    if not ids:
        return {}
    try:
        from redisearch_tpu_torch.utils import trace
    except ImportError:      # a program without the recorder
        return {}
    if not hasattr(trace, "counts"):     # a recorder without counts
        return {}
    out: dict = {}
    for c in trace.counts():
        if c.batch in ids and c.name.startswith(PREFIX):
            path = c.name[len(PREFIX):]
            out[path] = out.get(path, 0) + c.n
    return out


def read(run):
    by_path = served(run)
    total = sum(by_path.values())
    if not total:
        return None
    return 100.0 * sum(by_path.get(p, 0) for p in KERNEL_PATHS) / total
