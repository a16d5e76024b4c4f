"""bind_ms: host ms a batch binding each row-cache miss to the segment as a
transport row (`CompiledQuery.bind_row`: the program's span
`engine.bind`), its self time: a mean over the profiled batches the
program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.bind")
