"""knn_roofline: the least time the card needs for the filtered KNN work
of the profiled batches, as a share of the device's busy time in them.

Per batch, the larger of two terms, counted from the benchmark's own
data (never from the program's arguments):

* operations: 2 x (the rows each query's filter passes) x dim, over the
  bf16 dense peak (989 TFLOP/s: the highest rate of any precision the
  exact path may use);
* bytes: each row that some query of the batch may return read once, at
  2 bytes a value (the bf16 scan copy the program keeps beside the
  float32 vectors), and per query the float32 rows of its k hits (the
  exact rescore), over the memory bandwidth (3.35 TB/s).

Both peaks are `peaks.json`'s (H100 SXM, 700 W).  The denominator is the
union of all device intervals in the profiled batches: in a cell whose
requests are all filtered KNN queries, every kernel on the card is that
work (the filter's compare, the scan, the top-k, the rescore), so
whatever implements it, no honest path reads over 100%.  Cells whose
batches hold other work list no such metric.
"""

import numpy as np

from perfbench.reference import parse


def read(run):
    d = run.device
    if not d or d["busy_s"] <= 0 or not run.profiled:
        return None
    ref, peaks = run.ref, run.peaks
    rows_of: dict = {}
    t_min = 0.0
    for batch in run.profiled:
        flops, nbytes = 0.0, 0.0
        union: dict = {}
        for q in batch.queries:
            node, knn = parse(q)
            if knn is None:
                continue
            key = q[:q.find("=>[")]
            if key not in rows_of:
                rows_of[key] = ref.eval(node)
            rows = rows_of[key]
            k, field, _ = knn
            dim = ref.ds.field(field)["dim"]
            flops += 2.0 * len(rows) * dim
            nbytes += 4.0 * min(k, len(rows)) * dim
            if field not in union:
                union[field] = np.zeros(ref.ds.n, bool)
            union[field][rows] = True
        nbytes += sum(2.0 * int(m.sum()) * ref.ds.field(f)["dim"]
                      for f, m in union.items())
        t_min += max(flops / peaks["bf16_dense_flops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    if t_min <= 0:
        return None
    return 100.0 * t_min / d["busy_s"]
