"""launch_ms: host ms a batch in each executor group's stacking and
patching of its rows, the choice of its executor, its segment arguments,
and its uploads and launches (the program's span `engine.launch`, one a
group), its self time: a mean over the profiled batches the program
recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.launch")
