"""gc_ms: host ms a batch inside Python's cyclic garbage collector during
the window (all generations, timed by `gc.callbacks`): the pauses that
the program's host objects (document table, prepared queries, hits) cost
every batch that meets a collection."""


def read(run):
    if not run.batches:
        return None
    return sum(t for t, _ in run.gc.values()) / run.batches * 1e3
