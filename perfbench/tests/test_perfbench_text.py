"""The full-text side of the yardstick: draws, term slots, the plain
BM25STD reference and the score check.

* BM25STD worked out by hand on five documents;
* the reference against the port's window program on a tiny drawn
  corpus, every bench family: totals, ids, tie order, scores;
* the input on which the narrow kernel route breaks a union's ties by
  phase (ROADMAP C3): the reference ranks d0 ... d9, as the window
  program does, and judges the kernel route's order as tie errors;
* a score planted 1e-3 off fails a `score_err` limit of 1e-5;
* the control (the reference's scores in bfloat16) fails it too;
* every word a configuration can draw is one token that neither
  stemmer changes, so the card (without nltk) and the CPU index the
  same terms."""

import math

import numpy as np
import pytest
import torch

import textcell
from perfbench import compare, control as C, corpus, harness as H
from perfbench.entries import search as E
from perfbench.reference import Reference
from perfbench.traffic import Traffic

CPU = torch.device("cpu")


def _dataset(fields: list, texts: dict, tags: dict | None = None,
             weights: dict | None = None) -> corpus.Dataset:
    """A hand-made dataset: `texts[field]` is each document's text,
    `tags[field]` each document's label number (label i is "c<i>")."""
    vocab = sorted({w for docs in texts.values() for d in docs
                    for w in d.split()})
    col = {}
    for nm, docs in texts.items():
        ids = [vocab.index(w) for d in docs for w in d.split()]
        col[nm] = corpus.Text(ids=np.array(ids, np.int32),
                              lens=np.array([len(d.split()) for d in docs],
                                            np.int32),
                              words=np.array(vocab, dtype=object))
    cfg_fields = [{"name": nm, "type": "TEXT",
                   "weight": (weights or {}).get(nm, 1.0)} for nm in fields]
    tag_cols = {}
    for nm, codes in (tags or {}).items():
        cfg_fields.append({"name": nm, "type": "TAG", "draw": "zipf",
                           "n_values": max(codes) + 1, "a": 0.0,
                           "format": "c%d"})
        tag_cols[nm] = np.array(codes, np.int32)
    n = len(next(iter(texts.values())))
    return corpus.Dataset(cfg={"fields": cfg_fields}, n=n, tags=tag_cols,
                          numeric={}, vectors={},
                          keys=[f"d{i}" for i in range(n)], dev=CPU,
                          texts=col)


# ------------------------------------------------------- BM25STD by hand
FIVE = {"title": ["apple banana", "banana", "cherry date", "date",
                  "apple"],
        "body": ["cherry apple date", "apple apple", "banana cherry",
                 "date date date", "banana apple cherry date"]}
#: documents' lengths (title + body tokens) and their mean
DL = [5, 3, 4, 4, 5]
AVG = 21 / 5


def _bm25(n_t, f, dl):
    idf = math.log(1 + (5 - n_t + 0.5) / (n_t + 0.5))
    return idf * f * 2.2 / (f + 1.2 * (1 - 0.75 + 0.75 * dl / AVG))


#: frequencies weighted by field (title 2, body 1), by document
F = {"apple": {0: 3, 1: 2, 4: 3}, "banana": {0: 2, 1: 2, 2: 1, 4: 1},
     "cherry": {0: 1, 2: 3, 4: 1}, "date": {0: 1, 2: 2, 3: 5, 4: 1}}


def _s(word, d):
    return _bm25(len(F[word]), F[word][d], DL[d])


@pytest.fixture(scope="module")
def five():
    ds = _dataset(["title", "body"], FIVE,
                  tags={"cat": [0, 1, 0, 0, 1]},
                  weights={"title": 2.0})
    return Reference(ds)


@pytest.mark.parametrize("query,want", [
    ("apple", {d: _s("apple", d) for d in (0, 1, 4)}),
    ("@title:apple", {d: _s("apple", d) for d in (0, 4)}),
    ("@body:(apple|date)", {0: _s("apple", 0) + _s("date", 0),
                            1: _s("apple", 1), 3: _s("date", 3),
                            4: _s("apple", 4) + _s("date", 4)}),
    ("apple banana", {d: _s("apple", d) + _s("banana", d)
                      for d in (0, 1, 4)}),
    ("apple|date", {0: _s("apple", 0) + _s("date", 0), 1: _s("apple", 1),
                    2: _s("date", 2), 3: _s("date", 3),
                    4: _s("apple", 4) + _s("date", 4)}),
    ("apple -cherry", {1: _s("apple", 1)}),
    ("apple ~date", {0: _s("apple", 0) + _s("date", 0), 1: _s("apple", 1),
                     4: _s("apple", 4) + _s("date", 4)}),
    ('"apple banana"', {0: _s("apple", 0) + _s("banana", 0)}),
    # d1's title ends with banana and its body starts with apple: no
    # phrase across fields
    ('"banana apple"', {4: _s("banana", 4) + _s("apple", 4)}),
    ("apple @cat:{c0}", {0: _s("apple", 0) + 1.0}),
    ("date", {d: _s("date", d) for d in (0, 2, 3, 4)}),
])
def test_bm25std_by_hand(five, query, want):
    got = five.search(query, None, 3)
    assert got["better"] == "higher" and got["total"] == len(want)
    assert got["rows"].tolist() == sorted(want)
    np.testing.assert_allclose(got["values"],
                               [want[d] for d in sorted(want)], rtol=1e-12)
    order = sorted(want, key=lambda d: (-want[d], d))[:3]
    assert got["ranked"].tolist() == order


def test_equal_scores_rank_by_document(five):
    """d0 and d4 hold date once in a body, at one length: a tie, which
    goes to the lower document."""
    assert _s("date", 0) == _s("date", 4)
    assert five.search("date", None, 4)["ranked"].tolist() == [3, 2, 0, 4]


# -------------------------------------------- against the window program
def _serve(monkeypatch, cfg, mix, seed, batches):
    """The program's answers to the mix's first batches, on the CPU, with
    FT.SEARCH batches on the window program."""
    monkeypatch.setenv("RS_TPU_NO_INTERSECT_KERNEL", "1")
    run = H.Run(cell={"chips": 1}, cfg=cfg, mix=mix, ds=None, dev=CPU,
                seconds=0.0, traced=False)
    H.setup(run, seed)
    traffic = Traffic(mix, run.ds, seed)
    out = []
    for b in range(batches):
        batch = traffic.batch(b)
        res = E.submit(run, batch)
        out += [(H._item(batch, j), E.answer(res[j], H._item(batch, j)))
                for j in range(len(batch))]
    return run.ds, out


@pytest.mark.parametrize("seed", [11, 3900000001])
def test_reference_agrees_with_the_window_program(monkeypatch, seed):
    mix = {**textcell.MIX, "batch": 64}
    ds, served = _serve(monkeypatch, textcell.CONFIG, mix, seed, 3)
    ref = Reference(ds)
    names = [f["name"] for f in mix["families"]]
    seen, ties, cut = set(), 0, 0
    for item, (total, hits) in served:
        total_r, want = E.expected(ref, item, mix)
        assert total == total_r, item["query"]
        assert [k for k, _ in hits] == [k for k, _ in want], item["query"]
        for (_, s), (_, r) in zip(hits, want):
            assert abs(s - r) <= 1e-6 * abs(r), (item["query"], s, r)
        vals = [r for _, r in want]
        ties += len(vals) - len(set(vals))
        cut += total > mix["k"]
        seen.add(names[item["family"]])
    assert seen == set(names)
    assert ties > 0 and cut > 0     # tie order and the cut were exercised


# --------------------------------------------------------- ROADMAP C3
def _c3():
    a = ["alpha gamma delta" if i % 2 else "beta gamma delta"
         for i in range(800)]
    return _dataset(["a", "b"], {"a": a, "b": ["eps zeta omega"] * 800},
                    weights={"a": 2.0})


def test_c3_reference_ranks_lowest_documents_first():
    ref = Reference(_c3())
    got = ref.search("alpha | beta", None, 10)
    assert got["total"] == 800
    assert got["ranked"].tolist() == list(range(10))


def test_c3_window_program_serves_the_reference_order(monkeypatch):
    monkeypatch.setenv("RS_TPU_NO_INTERSECT_KERNEL", "1")
    from redisearch_tpu_torch.api import Client
    ds = _c3()
    client = Client(device=CPU)
    cfg = {"fields": [{"name": "a", "type": "TEXT", "weight": 2},
                      {"name": "b", "type": "TEXT"}]}
    ix = client.ft_create("c3", H.schema_fields(cfg))
    ix.add_documents(ds.docs())
    res = client.ft_search_many("c3", ["alpha | beta"], k=10)[0]
    item = {"query": "alpha | beta", "params": None}
    nums = E.judge(Reference(ds), item, E.answer(res, item), {"k": 10})
    assert [h.key for h in res.hits] == [f"d{i}" for i in range(10)]
    assert nums["tie_order_err"] == 0 and nums["score_err"] <= 1e-6


def test_c3_kernel_route_order_is_a_tie_error():
    ref = Reference(_c3())
    exp = ref.search("alpha | beta", None, 10)
    score = compare.lookup(exp["rows"], exp["values"])
    served = (800, [(f"d{i}", score(i)) for i in range(1, 20, 2)])
    nums = E.judge(ref, {"query": "alpha | beta", "params": None}, served,
                   {"k": 10})
    assert nums["tie_order_err"] == 10
    assert nums["rank_gap"] == 0 and nums["score_err"] == 0


# ---------------------------------------------------------- score check
def test_planted_score_fails_the_limit():
    ds = corpus.draw(textcell.CONFIG, 5, CPU)
    ref = Reference(ds)
    item = {"query": "w000003|w000007", "params": None}
    total, hits = E.expected(ref, item, {"k": 10})
    assert E.judge(ref, item, (total, hits), {"k": 10})["score_err"] == 0
    key, s = hits[4]
    hits[4] = (key, s * (1 + 1e-3))
    nums = E.judge(ref, item, (total, hits), {"k": 10})
    assert nums["score_err"] > 1e-5
    assert nums["score_err"] == pytest.approx(1e-3, rel=1e-9)


@pytest.mark.parametrize("seed", [77, 4600000001])
def test_text_control_fails(seed):
    out = C.control_of(textcell.CONFIG, {**textcell.MIX, "check": 64}, seed,
                       CPU)
    assert all(v == 0 for v in out["reference"].values()), out
    assert out["control"]["score_err"] > 1e-5, out


# ------------------------------------------------------------ the draws
def test_text_draw_is_seeded_and_shaped():
    a = corpus.draw(textcell.CONFIG, 3000000019, CPU)
    b = corpus.draw(textcell.CONFIG, 3000000019, CPU)
    for nm in ("title", "body"):
        assert np.array_equal(a.texts[nm].ids, b.texts[nm].ids)
        assert np.array_equal(a.texts[nm].lens, b.texts[nm].lens)
    assert set(a.texts["title"].lens.tolist()) == {4}
    lens = a.texts["body"].lens
    assert lens.min() >= 8 and lens.max() <= 40 and len(set(lens)) > 10
    doc = a.docs()[7][1]
    t = a.texts["body"]
    off = t.offsets
    assert doc["body"].split() == t.words[t.ids[off[7]:off[8]]].tolist()
    # rank 0 is the commonest word
    counts = np.bincount(t.ids, minlength=len(t.words))
    assert counts.argmax() == 0


def test_term_slots_draw_distinct_words_in_range():
    ds = corpus.draw(textcell.CONFIG, 9, CPU)
    mix = {**textcell.MIX, "batch": 256,
           "families": [{"name": "and3", "query": "<t> <t> <t>"},
                        {"name": "share", "query": "<p> <p>"}]}
    batch = Traffic(mix, ds, 9).batch(0)
    rng = set(ds.texts["body"].words[2:60].tolist())
    for q, fam in zip(batch.queries, batch.families):
        words = q.split()
        assert len(set(words)) == len(words)
        if fam == 0:
            assert set(words) <= rng
    share = [w for q, f in zip(batch.queries, batch.families) if f == 1
             for w in q.split()]
    # by share, the commonest word of the range is drawn most
    assert max(set(share), key=share.count) == "w000000"


@pytest.mark.parametrize("fmt,vocab", [("w%06d", 200_000),
                                       (textcell.CONFIG["fields"][0]["format"],
                                        textcell.CONFIG["fields"][0]["vocab"])])
def test_vocabulary_is_indexed_verbatim(fmt, vocab):
    """No drawn word is split, a stop word, or changed by the fallback
    stemmer that a host without nltk takes (Porter 1980), nor by
    Snowball where nltk is present."""
    from redisearch_tpu_torch.analysis.porter import porter_stem
    from redisearch_tpu_torch.analysis.stemmer import _snowball
    from redisearch_tpu_torch.analysis.tokenizer import Tokenizer
    words = [fmt % i for i in range(vocab)]
    assert [w for w in words if porter_stem(w) != w] == []
    snow = _snowball("english")
    if snow is not None:
        assert [w for w in words if snow(w) != w] == []
    toks = list(Tokenizer().tokenize(" ".join(words)))
    assert [t.tok for t in toks] == words
    assert not any(t.is_stopword for t in toks)
