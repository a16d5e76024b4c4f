"""execute_ms: host ms a batch inside `execute_batch` (binding, the
executors, the window program, kernel launches and the wait for their
results), from the window's spans."""


def read(run):
    if run.spans is None or not run.batches:
        return None
    return run.spans.seconds["execute_batch"] / run.batches * 1e3
