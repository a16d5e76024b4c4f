"""stem_build_pct: stemmers built as a share of the prepared-query cache
misses (calls of the program's span `plan.stemmer` over calls of
`plan.compile`), over the profiled batches the program recorded
(`program_spans`).  None from a program that builds a stemmer for every
compiled query and has no such span (no `stemmer_for` in its planner),
and where the batches compiled nothing."""

from perfbench import program_spans


def _has_stemmer_map() -> bool:
    try:
        from redisearch_tpu_torch.query import engine
    except ImportError:
        return False
    return hasattr(engine, "stemmer_for")


def read(run):
    compiled = program_spans.calls(run, "plan.compile")
    if not compiled or not _has_stemmer_map():
        return None
    return 100.0 * program_spans.calls(run, "plan.stemmer") / compiled
