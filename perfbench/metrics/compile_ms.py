"""compile_ms: host ms a batch in the planner's parse and lowering of each
prepared-query cache miss (the program's span `plan.compile`, inside
`SearchIndex.prepare`), its self time: a mean over the profiled batches
the program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "plan.compile")
