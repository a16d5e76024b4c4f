"""Counts of the port's span recorder (`redisearch_tpu_torch/utils/trace.py`
`count`), on the CPU.

The engine counts each batch's queries by the executor path that served
them (`engine.queries.<path>`, where it bumps `QUERY_PATH_STATS`).  A
count records only inside a recorded batch, with the batch's id and the
innermost open span as its parent; outside one it costs one global
check, about what a span's no-op costs.  Counts share the spans' buffer
but are read apart (`counts()`), so `records()` and every span's self
time are what they were without them."""

import collections
import timeit

import numpy as np
import pytest
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.query import engine
from redisearch_tpu_torch.utils import trace

N_DOCS = 600
PREFIX = "engine.queries."
#: batches of queries on the narrow kernel, the phrase kernel and the
#: window program (a numeric leaf)
BATCHES = {
    "kernel": ["w1 w2", "w1|w3", "w2 -w4", "w1 ~w2", "w3 @cat:{c1}"],
    "mixed": ["w1 w2", '"w1 w2"', "@n:[1 50]", "w2|w5", '"w3 w1"'],
    "window": ["@n:[1 50]", "@n:[100 300]"],
}


@pytest.fixture(scope="module")
def client():
    rng = np.random.default_rng(31)
    words = [f"w{i}" for i in range(8)]
    c = rt.Client(device="cpu")
    c.ft_create("cn", [rt.Field("a", rt.FieldType.TEXT, weight=2.0),
                       rt.Field("b", rt.FieldType.TEXT),
                       rt.Field("cat", rt.FieldType.TAG),
                       rt.Field("n", rt.FieldType.NUMERIC)])
    c._index("cn").add_documents([
        (f"d{i}", {"a": " ".join(rng.choice(words, 3)),
                   "b": " ".join(rng.choice(words, 9)),
                   "cat": f"c{i % 4}", "n": float(i)})
        for i in range(N_DOCS)])
    return c


@pytest.fixture(autouse=True)
def _fresh_buffer():
    trace.clear()
    yield
    trace.clear()


def _serve(client, queries, profiled=True):
    engine.QUERY_PATH_STATS.clear()
    if not profiled:
        return client.ft_search_many("cn", queries, k=5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return client.ft_search_many("cn", queries, k=5)


def _by_path(counts) -> dict:
    out = collections.Counter()
    for c in counts:
        out[c.name[len(PREFIX):]] += c.n
    return dict(out)


def test_nothing_is_counted_outside_a_profiler(client):
    _serve(client, BATCHES["mixed"], profiled=False)
    assert sum(engine.QUERY_PATH_STATS.values()) == len(BATCHES["mixed"])
    trace.count("engine.queries.kernel", 3)
    assert trace.counts() == [] and trace.records() == []


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_a_batch_counts_each_path_it_rode(client, name):
    queries = BATCHES[name]
    _serve(client, queries)
    counts = trace.counts()
    (root,) = [r for r in trace.records() if r.parent is None]
    assert {c.batch for c in counts} == {root.batch}
    assert all(c.name.startswith(PREFIX) and c.n > 0 for c in counts)
    assert all(c.parent == "engine.launch" for c in counts)
    stats = {p: n for p, n in engine.QUERY_PATH_STATS.items() if n}
    assert _by_path(counts) == stats
    assert sum(stats.values()) == len(queries)
    if name != "window":
        assert stats.get("kernel", 0) > 0


def test_the_mixed_batch_rides_three_paths(client):
    _serve(client, BATCHES["mixed"])
    assert _by_path(trace.counts()) == {"kernel": 2, "phrase-kernel": 2,
                                        "window": 1}


def test_two_batches_keep_their_own_counts(client):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        client.ft_search_many("cn", BATCHES["kernel"], k=5)
        client.ft_search_many("cn", BATCHES["window"], k=5)
    roots = [r.batch for r in trace.records() if r.parent is None]
    assert len(roots) == 2
    by_batch = {b: _by_path(c for c in trace.counts() if c.batch == b)
                for b in roots}
    assert by_batch == {roots[0]: {"kernel": len(BATCHES["kernel"])},
                        roots[1]: {"window": len(BATCHES["window"])}}


def test_counts_leave_the_spans_alone(client):
    """`records()` holds spans only, and each span's child cover is the
    durations of the spans it encloses: a count takes none of it."""
    _serve(client, BATCHES["mixed"])
    recs = trace.records()
    assert trace.counts()
    assert not any(r.name.startswith(PREFIX) for r in recs)
    assert all(len(r) == 6 for r in recs)
    for r in recs:
        inner = [c for c in recs if c.batch == r.batch and c is not r
                 and c.parent == r.name
                 and r.start_ns <= c.start_ns <= c.end_ns <= r.end_ns]
        assert r.child_ns == sum(c.end_ns - c.start_ns for c in inner), r


def test_a_full_buffer_drops_counts_like_spans(monkeypatch):
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=4))
    for n in (1, 2, 3):
        with trace.root("search"):
            with trace.span("engine.launch"):
                trace.count("engine.queries.kernel", n)
    # each batch appends its count, its launch and its root, in that
    # order; 9 appended, 4 kept
    assert trace.dropped() == 5
    assert [c.n for c in trace.counts()] == [3]
    assert [r.name for r in trace.records()] == [
        "search", "engine.launch", "search"]


def test_a_count_off_costs_about_a_span_off():
    """Outside a recorded batch: one global check each."""
    assert not trace.recording()

    def best(stmt):
        return min(timeit.repeat(stmt, number=20000, repeat=7,
                                 globals={"trace": trace})) / 20000

    span_s = best("with trace.span('engine.bind'):\n    pass")
    count_s = best("trace.count('engine.queries.kernel', 1)")
    assert count_s <= 1.5 * span_s, (count_s, span_s)
