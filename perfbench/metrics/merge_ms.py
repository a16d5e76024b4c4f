"""merge_ms: host ms a batch inside `SearchIndex.search_many` outside its
`prepare` and `execute_batch` spans: the hit loop over the document
table and the sort of each query's hits."""


def read(run):
    if run.spans is None or not run.batches:
        return None
    s = run.spans.seconds
    if not run.spans.calls["search_many"]:
        return None
    return (s["search_many"] - s["prepare"] - s["execute_batch"]
            ) / run.batches * 1e3
