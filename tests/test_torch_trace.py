"""The port's span recorder (`redisearch_tpu_torch/utils/trace.py`) on
the served search path, on the CPU.

A 3,000-doc index of a NUMERIC date, a TAG label and an 8-d COSINE
vector serves `Client.ft_search_many` batches of filtered KNN queries,
half under a date range never sent before (two window buckets), half
under a label.  Outside a profiler nothing is recorded.  Under
`torch.profiler` (CPU activity) each batch records one `search` root
and, inside it, `plan.prepare` per query, `plan.compile` per
prepared-query cache miss, `engine.bind` per row-cache miss,
`engine.launch` per executor group, `engine.wait` and `engine.collect`
per segment's handle and one `front.merge`, all with the batch's id and
their parent's name; self time is duration less child cover, the
children cover most of `search`, hits are the same either way, the
clock marker lays the spans on the profiler's timeline, and the clock
marker is the one profiler range the program opens.  Threads keep their
own batches, and a full buffer drops its oldest records and counts
them."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.utils import trace

N_DOCS = 3000
K = 5
PROGRAM_SPANS = ("search", "plan.prepare", "plan.compile", "engine.bind",
                 "engine.launch", "engine.wait", "engine.collect",
                 "front.merge")


class _Corpus:
    """The index, its vectors, and the query strings it has seen (the
    prepared-query and row caches make a string seen before a hit)."""

    def __init__(self):
        rng = np.random.default_rng(20)
        self.vecs = rng.normal(size=(N_DOCS, 8)).astype(np.float32)
        self.client = rt.Client(device="cpu")
        self.ix = self.client.ft_create("tr", [
            rt.Field("date", rt.FieldType.NUMERIC),
            rt.Field("label", rt.FieldType.TAG),
            rt.Field("emb", rt.FieldType.VECTOR, vector=rt.VectorParams(
                dim=8, metric="COSINE"))])
        self.ix.add_documents([
            (f"d{i}", {"date": float(i), "label": f"l{i % 7}",
                       "emb": self.vecs[i]}) for i in range(N_DOCS)])
        self.seen: set = set()
        self.fresh = 0

    def batch(self, n_date=6, n_label=6) -> tuple:
        """Queries and params: date ranges never sent before, of widths
        either side of the 2,048-row bucket, and labels (repeats)."""
        qs = []
        for j in range(n_date):
            self.fresh += 1
            lo = self.fresh % 400
            width = 300 + 97 * self.fresh % 700 if j % 2 else 2400
            qs.append(f"(@date:[{lo} {lo + width}])=>[KNN {K} @emb $b]")
        qs += [f"(@label:{{l{j % 7}}})=>[KNN {K} @emb $b]"
               for j in range(n_label)]
        ps = [{"b": self.vecs[(self.fresh * 31 + j) % N_DOCS]}
              for j in range(len(qs))]
        return qs, ps

    def serve(self, qs, ps, profiled=True):
        """`ft_search_many` (under a CPU profiler when `profiled`):
        (results, the profiler or None, the strings new to the index)."""
        new = set(qs) - self.seen
        self.seen |= set(qs)
        if not profiled:
            return self.client.ft_search_many("tr", qs, params=ps, k=K), \
                None, new
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = self.client.ft_search_many("tr", qs, params=ps, k=K)
        return res, prof, new


@pytest.fixture(scope="module")
def corpus():
    return _Corpus()


@pytest.fixture(autouse=True)
def _fresh_buffer():
    trace.clear()
    yield
    trace.clear()


def _counts(recs) -> collections.Counter:
    return collections.Counter(r.name for r in recs)


def _groups(ix, qs, ps) -> int:
    """Distinct group signatures of the batch's `bind_row` templates."""
    seg = ix.segments[0]
    opts = rt.QueryOptions(k=K)
    return len({ent[6:8] for ent in (
        ix.prepare(q, p, opts, 2).bind_row(seg)[1] for q, p in zip(qs, ps))})


def _hits(res) -> list:
    return [(r.total, [(h.key, h.vector_distance) for h in r.hits])
            for r in res]


def test_nothing_is_recorded_outside_a_profiler(corpus):
    qs, ps = corpus.batch()
    corpus.serve(qs, ps, profiled=False)
    assert trace.records() == [] and trace.clock_ns() is None
    # a span outside a recorded batch is the shared no-op
    assert trace.span("engine.bind") is trace.span("front.merge")
    assert not trace.recording()


def test_one_batch_records_each_span_as_often_as_its_work(corpus):
    qs, ps = corpus.batch()
    _res, _prof, new = corpus.serve(qs, ps)
    recs = trace.records()
    n = _counts(recs)
    assert n["search"] == 1
    assert n["plan.prepare"] == len(qs)
    assert n["plan.compile"] == len(new) > 0
    # the views of one string share its row cache: one bind a new string
    assert n["engine.bind"] == len(new)
    assert n["engine.launch"] == _groups(corpus.ix, qs, ps) >= 2
    assert n["engine.wait"] == n["engine.collect"] == 1
    assert n["front.merge"] == 1
    assert set(n) == set(PROGRAM_SPANS)
    assert trace.dropped() == 0


def test_a_repeated_batch_compiles_and_binds_nothing(corpus):
    qs, ps = corpus.batch()
    corpus.serve(qs, ps)
    trace.clear()
    _res, _prof, new = corpus.serve(qs, ps)
    n = _counts(trace.records())
    assert not new
    assert n["plan.compile"] == n["engine.bind"] == 0
    assert n["plan.prepare"] == len(qs)
    assert n["engine.launch"] == _groups(corpus.ix, qs, ps)


def test_every_record_has_its_batch_and_parent(corpus):
    for _ in range(2):
        qs, ps = corpus.batch()
        corpus.serve(qs, ps)
    recs = trace.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["search", "search"]
    assert len({r.batch for r in roots}) == 2
    parent_of = {"plan.prepare": "search", "plan.compile": "plan.prepare",
                 "engine.bind": "search", "engine.launch": "search",
                 "engine.wait": "search", "engine.collect": "search",
                 "front.merge": "search"}
    for root in roots:
        mine = [r for r in recs if r.batch == root.batch]
        assert len(mine) > 1
        for r in mine:
            if r is root:
                continue
            assert r.parent == parent_of[r.name], r
            assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


def _cover_by_containment(recs) -> dict:
    """Each record's child cover found from the records alone: the
    durations of the records of its batch it directly encloses."""
    cover = collections.defaultdict(int)
    for b in {r.batch for r in recs}:
        mine = sorted((r for r in recs if r.batch == b),
                      key=lambda r: (r.start_ns, -r.end_ns))
        stack = []
        for r in mine:
            while stack and stack[-1].end_ns <= r.start_ns:
                stack.pop()
            if stack:
                assert stack[-1].name == r.parent
                cover[stack[-1]] += r.end_ns - r.start_ns
            stack.append(r)
    return cover


def test_self_time_is_duration_less_child_cover(corpus):
    qs, ps = corpus.batch()
    corpus.serve(qs, ps)
    recs = trace.records()
    cover = _cover_by_containment(recs)
    for r in recs:
        assert r.child_ns == cover[r], r
    want = collections.defaultdict(int)
    for r in recs:
        want[r.name] += r.end_ns - r.start_ns - cover[r]
    assert trace.self_ns() == dict(want)
    assert trace.self_ns(recs) == dict(want)
    assert all(v >= 0 for v in want.values())


def test_children_cover_most_of_search(corpus):
    qs, ps = corpus.batch(n_date=24, n_label=24)
    corpus.serve(qs, ps)
    (root,) = [r for r in trace.records() if r.name == "search"]
    assert root.child_ns >= 0.9 * (root.end_ns - root.start_ns), root


def test_hits_are_the_same_recording_or_not(corpus):
    qs, ps = corpus.batch()
    off, _, _ = corpus.serve(qs, ps, profiled=False)
    assert trace.records() == []
    on, _, _ = corpus.serve(qs, ps)
    assert _counts(trace.records())["search"] == 1
    assert _hits(on) == _hits(off)
    assert all(len(r.hits) == K for r in on)


def test_clock_marker_lays_spans_on_the_trace(corpus):
    """Each `search` root, moved by the offset the clock marker gives,
    lies inside the range the test opened around its call, each end
    within 50 us."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            qs, ps = corpus.batch(n_date=2, n_label=2)
            with torch.profiler.record_function(f"test.around{i}"):
                corpus.client.ft_search_many("tr", qs, params=ps, k=K)
    evs = prof.events()
    (clock,) = [e for e in evs if e.name == trace.CLOCK_MARKER]
    offset = clock.time_range.start * 1000 - trace.clock_ns()
    around = {e.name: (e.time_range.start * 1000, e.time_range.end * 1000)
              for e in evs if e.name.startswith("test.around")}
    roots = sorted((r for r in trace.records() if r.name == "search"),
                   key=lambda r: r.start_ns)
    assert len(roots) == 5
    for i, r in enumerate(roots):
        lo, hi = around[f"test.around{i}"]
        assert r.start_ns + offset >= lo - 50_000, (i, lo - r.start_ns
                                                    - offset)
        assert r.end_ns + offset <= hi + 50_000, (i, r.end_ns + offset - hi)


def test_the_clock_marker_is_the_one_range_the_program_opens(corpus):
    """One marker a profiler session, at its first batch; a batch outside
    a profiler readies the next session's."""
    for session in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                qs, ps = corpus.batch()
                corpus.client.ft_search_many("tr", qs, params=ps, k=K)
        annotations = [e.name for e in prof.events() if e.is_user_annotation]
        assert annotations == [trace.CLOCK_MARKER]
        assert not {e.name for e in prof.events()} & set(PROGRAM_SPANS)
        assert _counts(trace.records())["search"] == 2 * (session + 1)
        qs, ps = corpus.batch()
        corpus.serve(qs, ps, profiled=False)


def test_wait_and_collect_once_per_segment_and_one_merge():
    vecs = np.random.default_rng(3).normal(size=(1200, 8)).astype(
        np.float32)
    client = rt.Client(device="cpu")
    client.ft_create("two", [
        rt.Field("date", rt.FieldType.NUMERIC),
        rt.Field("emb", rt.FieldType.VECTOR,
                 vector=rt.VectorParams(dim=8, metric="COSINE"))])
    for i in range(1200):
        client.hset(f"d{i}", {"date": float(i), "emb": vecs[i]})
        if i == 599:
            client.ft_search("two", "@date:[0 1]")     # seals a segment
    qs = [f"(@date:[{lo} {lo + 400}])=>[KNN {K} @emb $b]"
          for lo in (10, 300, 700)]
    ps = [{"b": vecs[j]} for j in (10, 300, 700)]
    off = client.ft_search_many("two", qs, params=ps, k=K)
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = client.ft_search_many("two", qs, params=ps, k=K)
    assert len(client._index("two").segments) == 2
    n = _counts(trace.records())
    assert n["search"] == n["front.merge"] == 1
    assert n["engine.wait"] == n["engine.collect"] == 2
    assert n["engine.launch"] >= 2
    assert _hits(on) == _hits(off)


def test_threads_keep_their_own_batches(monkeypatch):
    """Eight threads (more than the cores of a small host) open batches
    of nested spans at a switch interval of 1 us: every record keeps its
    own thread's batch and parent, and none is lost."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    n_threads, n_batches, errors = 8, 40, []

    def work(t):
        try:
            for b in range(n_batches):
                with trace.root("search"):
                    for j in range(3):
                        with trace.span(f"t{t}.a"):
                            with trace.span(f"t{t}.b"):
                                pass
                    if not trace.recording():
                        errors.append((t, b, "not recording"))
        except Exception as e:   # reported by the main thread
            errors.append((t, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert errors == []
    recs = trace.records()
    assert len(recs) == n_threads * n_batches * 7 and trace.dropped() == 0
    by_batch = collections.defaultdict(list)
    for r in recs:
        by_batch[r.batch].append(r)
    assert len(by_batch) == n_threads * n_batches
    for mine in by_batch.values():
        (root,) = [r for r in mine if r.parent is None]
        t = {r.name.split(".")[0] for r in mine if r is not root}
        assert len(t) == 1, mine
        (t,) = t
        assert _counts(mine) == {"search": 1, f"{t}.a": 3, f"{t}.b": 3}
        assert all(r.parent == (f"{t}.a" if r.name.endswith(".b")
                                else "search") for r in mine if r is not root)
    assert not trace.recording()
    assert trace._open == 0


def test_a_full_buffer_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=5))
    for _ in range(3):
        with trace.root("search"):
            with trace.span("front.merge"):
                pass
    recs = trace.records()
    assert len(recs) == 5 and trace.dropped() == 1
    # each batch keeps its child first (it closes first); the first
    # batch's child went
    assert [r.name for r in recs] == ["search", "front.merge", "search",
                                      "front.merge", "search"]
    assert [r.batch for r in recs] == [recs[0].batch, *[recs[0].batch + 1] * 2,
                                       *[recs[0].batch + 2] * 2]
