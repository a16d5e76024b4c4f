"""tail_p95_ms: the 95th percentile over all requests of the traced
window of a request's latency, its batch's time from submission to
return with results on the host (host clock).  In the closed loop of
batches of 512 the collector's full collections (about a tenth of the
batches) set it; the profiled first seconds count too."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    per_request = np.repeat(np.asarray(run.latencies), run.sizes)
    return float(np.percentile(per_request, 95)) * 1e3
