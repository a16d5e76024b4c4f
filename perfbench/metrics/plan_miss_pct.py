"""plan_miss_pct: prepared-query cache misses as a share of the queries
prepared (calls of the program's span `plan.compile` over calls of
`plan.prepare`), over the profiled batches the program recorded
(`program_spans`)."""

from perfbench import program_spans


def read(run):
    prepared = program_spans.calls(run, "plan.prepare")
    if not prepared:
        return None
    return 100.0 * program_spans.calls(run, "plan.compile") / prepared
