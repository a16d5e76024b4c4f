"""wait_ms: host ms a batch waiting on the card before the first copy to
the host (the program's span `engine.wait`: a synchronise of the current
stream, made only while the program records), its self time: a mean over
the profiled batches the program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.wait")
