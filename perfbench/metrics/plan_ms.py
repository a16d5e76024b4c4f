"""plan_ms: host ms a batch inside `SearchIndex.prepare` (parse, plan,
the prepared-query cache), from the window's spans."""


def read(run):
    if run.spans is None or not run.batches:
        return None
    return run.spans.seconds["prepare"] / run.batches * 1e3
