"""The readers of the program's spans (`program_spans.py` and the eight
metrics on it): None where nothing was recorded or the program has no
recorder, and on a hand-built record set each batch's value, over the
profiled batches only."""

import collections
import sys
import types

import pytest

from perfbench import harness as H
from perfbench import program_spans

Rec = collections.namedtuple(
    "Rec", "name parent batch start_ns end_ns child_ns")

METRICS = ("compile_ms", "plan_miss_pct", "bind_ms", "launch_ms",
           "groups_per_batch", "wait_ms", "collect_ms", "hits_ms")


def _batch(b: int, t: int, scale: int) -> list:
    """One batch's records, children before their parents as the program
    closes them: 4 prepares (2 compiles), 1 bind, 3 launches, a wait, a
    collect and a merge; times in ns scaled by `scale`."""
    ms = 1_000_000 * scale
    out, at = [], t
    prep_cover = 0
    for j in range(4):
        child = 0
        if j % 2 == 0:
            out.append(Rec("plan.compile", "plan.prepare", b, at, at + 2 * ms,
                           0))
            child = 2 * ms
        out.append(Rec("plan.prepare", "search", b, at, at + 3 * ms, child))
        prep_cover += 3 * ms
        at += 3 * ms
    out.append(Rec("engine.bind", "search", b, at, at + 5 * ms, 0))
    at += 5 * ms
    for _ in range(3):
        out.append(Rec("engine.launch", "search", b, at, at + 7 * ms, 0))
        at += 7 * ms
    for name, d in (("engine.wait", 11), ("engine.collect", 13),
                    ("front.merge", 17)):
        out.append(Rec(name, "search", b, at, at + d * ms, 0))
        at += d * ms
    cover = at - t
    out.append(Rec("search", None, b, t, at + ms, cover))
    return out


def _run(n_profiled: int):
    return types.SimpleNamespace(profiled=[object()] * n_profiled)


def _read(name, run):
    return H.load_module("metrics", name).read(run)


@pytest.fixture
def records(monkeypatch):
    held: list = []
    monkeypatch.setattr(program_spans, "_records", lambda: list(held))
    return held


@pytest.mark.parametrize("name", METRICS)
def test_reads_none_without_records(name, records):
    assert _read(name, _run(3)) is None
    records.extend(_batch(1, 0, 1))
    assert _read(name, _run(0)) is None


@pytest.mark.parametrize("name", METRICS)
def test_reads_none_from_a_program_without_the_recorder(name, monkeypatch):
    import redisearch_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "redisearch_tpu_torch.utils.trace",
                        None)
    assert _read(name, _run(3)) is None


#: each metric on batches 2 and 3 (scale 1 and 3): the mean of its
#: per-batch values
WANT = {"compile_ms": 4 * 2, "plan_miss_pct": 50.0,
        "bind_ms": 5 * 2, "launch_ms": 21 * 2, "groups_per_batch": 3.0,
        "wait_ms": 11 * 2, "collect_ms": 13 * 2, "hits_ms": 17 * 2}


@pytest.mark.parametrize("name", METRICS)
def test_reads_the_mean_over_the_profiled_batches(name, records):
    # batch 1 is an earlier run's (not profiled here), scale 100: left out
    records.extend(_batch(1, 0, 100) + _batch(2, 10**12, 1)
                   + _batch(3, 2 * 10**12, 3))
    assert _read(name, _run(2)) == pytest.approx(WANT[name])


def test_self_time_leaves_out_the_children(records):
    """`plan.prepare` holds `plan.compile`: its self time is 3 ms a call
    less 2 ms for the compiled ones."""
    records.extend(_batch(7, 0, 1))
    assert program_spans.self_ms(_run(1), "plan.prepare") == pytest.approx(
        4 * 3 - 2 * 2)
    assert program_spans.self_ms(_run(1), "search") == pytest.approx(1.0)
    assert set(program_spans.batches(_run(1))) == {7}
