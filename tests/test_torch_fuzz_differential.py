"""Randomized differential test: the engine vs a naive Python evaluator.

Mirrors the reference's property-based testing strategy (SURVEY §4:
proptest generators in inverted_index/src/test_utils.rs) at the whole-
engine level: generate a random corpus and random queries, compute the
expected matching DOC SET with an obviously-correct brute-force model,
and compare against the compiled window evaluator.

Scoring/order is NOT compared (the model doesn't reimplement BM25) —
membership and totals are, which is where set-algebra bugs live.

Parity file of tests/test_fuzz_differential.py (tests/torch_parity.py): each case runs
on the JAX package, then on the port (`Client(device="cpu")`), must
pass its own assertions on both, and the results of the calls it
makes must be equal: ids, totals, tie order and strings exactly,
scores within rtol 1e-5, atol 1e-6; profile times and INFO byte
sizes are not compared.
"""

from tests.torch_parity import parity, per_side, resolve, rs
import numpy as np
import pytest


Field = rs.Field
FieldType = rs.FieldType

N_DOCS = 300
VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
         "golf", "hotel", "india", "juliet", "kilo", "lima"]
TAGS = ["red", "green", "blue", "yellow"]


@pytest.fixture(scope="module")
def corpus():
    return per_side(lambda: _corpus_make())


def _corpus_make():
    rng = np.random.default_rng(42)
    docs = []
    for i in range(N_DOCS):
        nwords = int(rng.integers(1, 9))
        words = [VOCAB[j] for j in rng.integers(0, len(VOCAB), nwords)]
        doc = {"words": words,
               "tag": TAGS[int(rng.integers(0, len(TAGS)))],
               "num": float(rng.integers(0, 100))}
        docs.append(doc)
    c = rs.Client()
    c.ft_create("fz", [Field("t", FieldType.TEXT),
                       Field("g", FieldType.TAG),
                       Field("n", FieldType.NUMERIC)])
    for i, d in enumerate(docs):
        c.hset(f"d{i}", {"t": " ".join(d["words"]), "g": d["tag"],
                         "n": d["num"]})
    return c, docs


def _model_match(doc, node):
    """Naive evaluator over the doc dict."""
    kind = node[0]
    if kind == "term":
        return node[1] in doc["words"]
    if kind == "and":
        return all(_model_match(doc, k) for k in node[1])
    if kind == "or":
        return any(_model_match(doc, k) for k in node[1])
    if kind == "not":
        return not _model_match(doc, node[1])
    if kind == "opt":
        return True   # optional never filters (score boost only)
    if kind == "tag":
        return doc["tag"] == node[1]
    if kind == "num":
        return node[1] <= doc["num"] <= node[2]
    if kind == "prefix":
        return any(w.startswith(node[1]) for w in doc["words"])
    if kind == "phrase":
        # exact phrase = slop 0 + in-order per the REFERENCE algorithm
        # (non-strict position ordering: a repeated query term may land
        # on the same token, so "lima lima" matches one "lima" —
        # proximity.rs within_range_in_order, span goes to -1)
        from test_fuzz_proximity import within_range_in_order
        ws = doc["words"]
        lists = []
        for t in (node[1], node[2]):
            pl = [j + 1 for j, w in enumerate(ws) if w == t]
            if not pl:
                return False
            lists.append(pl)
        return within_range_in_order(lists, 0)
    raise AssertionError(kind)


def _to_query(node):
    kind = node[0]
    if kind == "term":
        return node[1]
    if kind == "and":
        return "(" + " ".join(_to_query(k) for k in node[1]) + ")"
    if kind == "or":
        return "(" + " | ".join(_to_query(k) for k in node[1]) + ")"
    if kind == "not":
        return "-" + _to_query(node[1])
    if kind == "opt":
        return "~" + _to_query(node[1])
    if kind == "tag":
        return "@g:{%s}" % node[1]
    if kind == "num":
        return "@n:[%g %g]" % (node[1], node[2])
    if kind == "prefix":
        return node[1] + "*"
    if kind == "phrase":
        return '"%s %s"' % (node[1], node[2])
    raise AssertionError(kind)


def _random_node(rng, depth=0):
    kinds = ["term", "tag", "num", "prefix", "phrase"]
    if depth < 2:
        kinds += ["and", "or", "and", "or", "not", "opt"]
    kind = kinds[int(rng.integers(0, len(kinds)))]
    if kind == "term":
        return ("term", VOCAB[int(rng.integers(0, len(VOCAB)))])
    if kind == "tag":
        return ("tag", TAGS[int(rng.integers(0, len(TAGS)))])
    if kind == "num":
        lo = float(rng.integers(0, 90))
        return ("num", lo, lo + float(rng.integers(1, 40)))
    if kind == "prefix":
        w = VOCAB[int(rng.integers(0, len(VOCAB)))]
        return ("prefix", w[:int(rng.integers(2, 4))])
    if kind == "phrase":
        return ("phrase", VOCAB[int(rng.integers(0, len(VOCAB)))],
                VOCAB[int(rng.integers(0, len(VOCAB)))])
    if kind == "not":
        # NOT of a positive child, intersected with a term to keep the
        # query rooted (a bare NOT is valid too — exercised separately)
        return ("and", (("term", VOCAB[int(rng.integers(0, len(VOCAB)))]),
                        ("not", _random_node(rng, 3))))
    if kind == "opt":
        return ("and", (("term", VOCAB[int(rng.integers(0, len(VOCAB)))]),
                        ("opt", _random_node(rng, 3))))
    n = int(rng.integers(2, 4))
    return (kind, tuple(_random_node(rng, depth + 1) for _ in range(n)))


@pytest.mark.parametrize("seed", range(48))
@parity
def test_random_query_membership(corpus, seed):
    c, docs = corpus
    rng = np.random.default_rng(1000 + seed)
    node = _random_node(rng)
    q = _to_query(node)
    expected = {f"d{i}" for i, d in enumerate(docs) if _model_match(d, node)}
    res = c.ft_search("fz", q, num=N_DOCS, verbatim=True)
    got = {h.key for h in res.hits}
    assert got == expected, (
        f"query {q!r}: missing={sorted(expected - got)[:5]} "
        f"spurious={sorted(got - expected)[:5]}")
    assert res.total == len(expected), (q, res.total, len(expected))


@parity
def test_bare_not_matches_complement(corpus):
    c, docs = corpus
    expected = {f"d{i}" for i, d in enumerate(docs)
                if "alpha" not in d["words"]}
    res = c.ft_search("fz", "-alpha", num=N_DOCS, verbatim=True)
    assert {h.key for h in res.hits} == expected
