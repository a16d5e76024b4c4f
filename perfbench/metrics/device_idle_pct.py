"""device_idle_pct: share of the profiled part of the window in which no
kernel, copy or set ran on the card (the union of the device intervals
of the `torch.profiler` trace)."""


def read(run):
    d = run.device
    if not d or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
