"""p95_ms: the 95th percentile over all requests of the window of a
request's latency, its batch's time from submission to return with
results on the host (host clock)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    per_request = np.repeat(np.asarray(run.latencies), run.sizes)
    return float(np.percentile(per_request, 95)) * 1e3
