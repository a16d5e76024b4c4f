"""hits_ms: host ms a batch in `SearchIndex.search_many`'s hit loop over
the document table and the sort of each query's hits (the program's span
`front.merge`), its self time: a mean over the profiled batches the
program recorded (`program_spans`)."""

from perfbench import program_spans


def read(run):
    return program_spans.self_ms(run, "front.merge")
