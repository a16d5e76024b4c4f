"""collect_ms: host ms a batch in the copies to the host and the building
of each query's segment result, with underfilled queries run again (the
program's span `engine.collect`), its self time: a mean over the
profiled batches the program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.collect")
