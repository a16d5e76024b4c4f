"""The full-text cell's two per-layer metrics, checked by hand.

* `kernel_route_pct` on counts the program's recorder takes
  (`utils/trace.py` `count`): the kernel paths' share of the profiled
  batches' counts, an earlier batch left out; None without counts and
  from a recorder that has none;
* `bm25_roofline` on five hand-made documents: each query's lists as
  the docstring counts them (a union's every list, an intersection's
  shortest required one, a phrase's shortest term with its positions, a
  TAG list at 4 bytes an entry), each list once a batch, over the
  device's busy time; None without device time."""

import collections
import types

import numpy as np
import pytest
import torch

from perfbench import corpus, harness as H
from perfbench.reference import Reference, parse


def _read(name, run):
    return H.load_module("metrics", name).read(run)


# --------------------------------------------------------- kernel_route_pct
@pytest.fixture
def recorder(monkeypatch):
    from redisearch_tpu_torch.utils import trace
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    trace.clear()
    yield trace
    trace.clear()


def _batch(trace, counts: dict) -> None:
    with trace.root("search"):
        for path, n in counts.items():
            with trace.span("engine.launch"):
                trace.count(f"engine.queries.{path}", n)


def test_route_share_over_the_profiled_batches(recorder):
    _batch(recorder, {"window": 100})            # an earlier batch
    _batch(recorder, {"kernel": 6, "window": 2})
    _batch(recorder, {"phrase-kernel": 3, "kernel-wide": 1,
                      "knn-dense": 2})
    run = types.SimpleNamespace(profiled=[object()] * 2)
    assert _read("kernel_route_pct", run) == pytest.approx(100.0 * 10 / 14)
    served = H.load_module("metrics", "kernel_route_pct").served(run)
    assert served == {"kernel": 6, "window": 2, "phrase-kernel": 3,
                      "kernel-wide": 1, "knn-dense": 2}


def test_route_share_reads_none_without_counts(recorder, monkeypatch):
    run = types.SimpleNamespace(profiled=[object()])
    assert _read("kernel_route_pct", run) is None
    with recorder.root("search"):
        pass
    assert _read("kernel_route_pct", run) is None
    _batch(recorder, {"kernel": 4})
    assert _read("kernel_route_pct", run) == 100.0
    monkeypatch.delattr(recorder, "counts")      # a recorder without counts
    assert _read("kernel_route_pct", run) is None


# ------------------------------------------------------------ bm25_roofline
TITLE = ["apple banana", "banana", "cherry date", "date", "apple"]
BODY = ["cherry apple date", "apple apple", "banana cherry",
        "date date date", "banana apple cherry date"]
CATS = [0, 1, 0, 0, 1]


@pytest.fixture(scope="module")
def ref():
    vocab = sorted({w for d in TITLE + BODY for w in d.split()})
    texts = {nm: corpus.Text(
        ids=np.array([vocab.index(w) for d in docs for w in d.split()],
                     np.int32),
        lens=np.array([len(d.split()) for d in docs], np.int32),
        words=np.array(vocab, dtype=object))
        for nm, docs in (("title", TITLE), ("body", BODY))}
    cfg = {"fields": [{"name": "title", "type": "TEXT", "weight": 2.0},
                      {"name": "body", "type": "TEXT"},
                      {"name": "cat", "type": "TAG", "draw": "zipf",
                       "n_values": 2, "a": 0.0, "format": "c%d"}]}
    ds = corpus.Dataset(cfg=cfg, n=5, tags={"cat": np.array(CATS, np.int32)},
                        numeric={}, vectors={},
                        keys=[f"d{i}" for i in range(5)],
                        dev=torch.device("cpu"), texts=texts)
    return Reference(ds)


#: documents holding each word in any field: apple 3, banana 4, cherry
#: 3, date 4; in the title: apple 2; in the body: date 3; occurrences of
#: apple in all fields: 6; documents of c0: 3
@pytest.mark.parametrize("query,want", [
    ("apple", {("term", "apple", None): 24}),
    ("apple banana", {("term", "apple", None): 24}),
    ("apple|date", {("term", "apple", None): 24,
                    ("term", "date", None): 32}),
    ("apple -cherry", {("term", "apple", None): 24}),
    ("banana ~apple", {("term", "banana", None): 32}),
    ('"banana apple"', {("term", "apple", None): 24, ("pos", "apple"): 24}),
    ("date @cat:{c0}", {("tag", "cat", "['c0']"): 12}),
    ("@title:apple", {("term", "apple", ("title",)): 16}),
    ("@title:apple @body:date", {("term", "apple", ("title",)): 16}),
])
def test_lists_of_a_query(ref, query, want):
    lists = H.load_module("metrics", "bm25_roofline").lists
    assert lists(ref, parse(query)[0]) == want


def _run(ref, batches, busy_s):
    return types.SimpleNamespace(
        device={"busy_s": busy_s, "window_s": 1.0},
        profiled=[types.SimpleNamespace(queries=q) for q in batches],
        ref=ref, peaks=corpus.load_json("", "peaks"))


def test_roofline_counts_each_list_once_a_batch(ref):
    batches = [["apple banana", "apple|date", "apple"],          # 24 + 32
               ['"banana apple"', "date @cat:{c0}", "apple"]]    # 48 + 12
    bw = corpus.load_json("", "peaks")["hbm_bytes_per_s"]
    busy = 1e-9
    got = _read("bm25_roofline", _run(ref, batches, busy))
    assert got == pytest.approx(100.0 * (56 + 60) / bw / busy)
    # the floor of these batches' bytes takes all of their busy time
    assert _read("bm25_roofline", _run(ref, batches, 116 / bw)) == \
        pytest.approx(100.0)


def test_roofline_reads_none_without_device_time(ref):
    assert _read("bm25_roofline", _run(ref, [["apple"]], 0.0)) is None
    run = _run(ref, [["apple"]], 1e-9)
    run.device = None
    assert _read("bm25_roofline", run) is None
    assert _read("bm25_roofline", _run(ref, [], 1e-9)) is None


def test_hand_counts_match_the_postings(ref):
    """The counts the cases above take as given."""
    text = ref.text
    docs = collections.Counter({w: len(text.term(w)[0]) for w in
                                ("apple", "banana", "cherry", "date")})
    assert docs == {"apple": 3, "banana": 4, "cherry": 3, "date": 4}
    assert len(text.scoped("apple", ("title",))[0]) == 2
    assert len(text.scoped("date", ("body",))[0]) == 3
    assert sum(d.split().count("apple") for d in TITLE + BODY) == 6
