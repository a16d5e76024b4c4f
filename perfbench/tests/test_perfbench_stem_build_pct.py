"""The reader of `stem_build_pct` (calls of the program's span
`plan.stemmer` over calls of `plan.compile`): None where nothing was
recorded, the program has no recorder or its planner has no stemmer map,
and on hand-built record sets (those of `test_perfbench_program_spans`)
each batch's value, over the profiled batches only."""

import sys

import pytest

import test_perfbench_program_spans as S
from perfbench import program_spans

NAME = "stem_build_pct"


@pytest.fixture
def records(monkeypatch):
    held: list = []
    monkeypatch.setattr(program_spans, "_records", lambda: list(held))
    return held


def _with_stemmers(recs: list) -> list:
    """The batch as a planner that builds a stemmer in every compile
    gives it: a `plan.stemmer` inside each `plan.compile`."""
    return recs + [S.Rec("plan.stemmer", "plan.compile", r.batch, r.start_ns,
                         r.start_ns + 1, 0)
                   for r in recs if r.name == "plan.compile"]


def test_reads_none_without_records(records):
    assert S._read(NAME, S._run(3)) is None
    records.extend(S._batch(1, 0, 1))
    assert S._read(NAME, S._run(0)) is None


def test_reads_none_from_a_program_without_the_recorder(monkeypatch):
    import redisearch_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "redisearch_tpu_torch.utils.trace",
                        None)
    assert S._read(NAME, S._run(3)) is None


def test_reads_the_mean_over_the_profiled_batches(records):
    # batch 1 is an earlier run's (not profiled here), with a stemmer
    # built in each compile: left out
    records.extend(_with_stemmers(S._batch(1, 0, 100)) + S._batch(2, 10**12, 1)
                   + S._batch(3, 2 * 10**12, 3))
    assert S._read(NAME, S._run(2)) == 0.0


def test_reads_builds_over_compiles(records):
    records.extend(S._batch(1, 0, 1))
    assert S._read(NAME, S._run(1)) == 0.0
    records.extend(_with_stemmers(S._batch(2, 10**12, 1)))
    assert S._read(NAME, S._run(1)) == pytest.approx(100.0)
    assert S._read(NAME, S._run(2)) == pytest.approx(50.0)


def test_is_none_where_nothing_compiled(records):
    records.extend(r for r in S._batch(1, 0, 1) if r.name != "plan.compile")
    assert S._read("plan_miss_pct", S._run(1)) == 0.0
    assert S._read(NAME, S._run(1)) is None


def test_is_none_from_a_planner_without_the_map(records, monkeypatch):
    """A planner that builds a stemmer in each compile has no span for
    it: its batches would read 0, so the reader reads nothing."""
    from redisearch_tpu_torch.query import engine
    records.extend(S._batch(1, 0, 1))
    assert S._read(NAME, S._run(1)) == 0.0
    monkeypatch.delattr(engine, "stemmer_for")
    assert S._read(NAME, S._run(1)) is None
