"""groups_per_batch: executor groups a batch (calls of the program's span
`engine.launch`, one a group of queries sharing a tree structure and
window buckets, each with its own set-up, launches and copies): a mean
over the profiled batches the program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.calls(run, "engine.launch")
