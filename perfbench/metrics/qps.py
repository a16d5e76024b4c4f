"""qps: requests answered in the window over the window's seconds (host
clock; the window ends when its last batch has returned)."""


def read(run):
    if run.window_s <= 0 or run.requests == run.failed:
        return None
    return (run.requests - run.failed) / run.window_s
