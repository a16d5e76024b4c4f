"""The planner's stemmers (`query/engine.py` `stemmer_for`): one a
language a process, on the CPU.

Each test runs with nltk importable and with it blocked (None in
`sys.modules` for `nltk` and `nltk.stem.snowball`, where a `Stemmer`
falls back to Porter-1980 for english and the light strippers for the
rest, after a failed import each time one is built).  Fresh date-range
KNN strings through `SearchIndex.prepare` build one `Stemmer` and try
the import once, however many miss the prepared-query cache; a text
query lowers to the same term slots as with a `Stemmer` built for it
alone.  The engine's map and `analysis/stemmer.py`'s Snowball cache are
cleared before and after each test, so no other test of the worker gets
a stemmer built while nltk was blocked."""

import itertools
import sys
import threading

import numpy as np
import pytest

import redisearch_tpu_torch as rt
from redisearch_tpu_torch.analysis import stemmer as stemmer_mod
from redisearch_tpu_torch.analysis.porter import porter_stem
from redisearch_tpu_torch.query import engine

DIM = 8
_FRESH = itertools.count()      # date bounds no earlier test has sent
TEXT = "running generously houses häusern laufen"


def _forget():
    engine.clear_stemmers()
    stemmer_mod._SNOWBALL_CACHE.clear()


@pytest.fixture(params=["present", "blocked"])
def nltk(request, monkeypatch):
    """nltk as the test finds it, or unimportable for its duration."""
    _forget()
    if request.param == "blocked":
        monkeypatch.setitem(sys.modules, "nltk", None)
        monkeypatch.setitem(sys.modules, "nltk.stem.snowball", None)
    yield request.param
    monkeypatch.undo()
    _forget()


@pytest.fixture(scope="module")
def ix():
    vecs = np.random.default_rng(21).normal(size=(64, DIM)).astype(
        np.float32)
    client = rt.Client(device="cpu")
    ix = client.ft_create("st", [
        rt.Field("t", rt.FieldType.TEXT),
        rt.Field("date", rt.FieldType.NUMERIC),
        rt.Field("emb", rt.FieldType.VECTOR, vector=rt.VectorParams(
            dim=DIM, metric="COSINE"))])
    ix.add_documents([(f"d{i}", {"t": TEXT, "date": float(i),
                                 "emb": vecs[i]}) for i in range(64)])
    ix.vecs = vecs
    return ix


def _counting(monkeypatch, module, name) -> list:
    """Replace `module.name` by a wrapper that counts its calls."""
    calls = []
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_fresh_strings_build_one_stemmer(ix, nltk, monkeypatch):
    builds = _counting(monkeypatch, engine, "Stemmer")
    imports = _counting(monkeypatch, stemmer_mod, "_snowball")
    opts = rt.QueryOptions(k=25)
    cqs = []
    for j in range(200):
        lo = next(_FRESH)
        cqs.append(ix.prepare(f"(@date:[{lo} {lo + 10 + j % 7}])"
                              "=>[KNN 25 @emb $b]",
                              {"b": ix.vecs[j % 64]}, opts))
    assert len({id(cq) for cq in cqs}) == 200
    assert builds == [("english",)]
    assert imports == [("english",)]
    assert all(cq._stemmer is cqs[0]._stemmer for cq in cqs)
    fn = cqs[0]._stemmer._fn
    if nltk == "blocked":
        assert fn is porter_stem
    else:
        assert fn is stemmer_mod._SNOWBALL_CACHE["english"]


@pytest.mark.parametrize("language,verbatim", [
    ("english", False), ("German", False), ("klingon", False),
    ("english", True)], ids=["english", "german", "unknown", "verbatim"])
def test_text_query_lowers_as_with_its_own_stemmer(ix, nltk, monkeypatch,
                                                   language, verbatim):
    opts = rt.QueryOptions(language=language, verbatim=verbatim)
    root = ix.parse_query(TEXT, None, 2)
    shared = ix.compile(root, opts)
    again = ix.compile(root, opts)
    with monkeypatch.context() as m:
        m.setattr(engine, "stemmer_for", stemmer_mod.Stemmer)
        own = ix.compile(root, opts)
    assert shared.term_strings == own.term_strings == again.term_strings
    assert shared.term_qmasks == own.term_qmasks
    tokens = TEXT.split()
    if verbatim:
        assert shared._stemmer is None
        assert shared.term_strings == tokens
        return
    assert shared._stemmer is again._stemmer is not own._stemmer
    assert shared._stemmer is engine.stemmer_for(language.upper())
    # the bare stems: each token's own slot and its "+stem" left out
    stems = {t for t in shared.term_strings
             if t not in tokens and not t.startswith("+")}
    if language == "klingon":
        assert not stems
    elif language == "english":
        # Snowball english (Porter2) against the Porter-1980 fallback
        assert {"run", "hous", "generous" if nltk == "present"
                else "gener"} <= stems
    else:
        assert stems


def test_threads_share_one_stemmer_a_language(nltk):
    """Sixteen threads (more than the cores of a small host) ask for four
    languages at once at a switch interval of 1 us: each language's
    threads all get the stemmer the map keeps."""
    langs = ("english", "German", "french", "klingon")
    got, errors = [], []

    def work(t):
        try:
            for j in range(200):
                lang = langs[(t + j) % len(langs)]
                got.append((lang.lower(), engine.stemmer_for(lang)))
        except Exception as e:   # reported by the main thread
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert errors == [] and len(got) == 16 * 200
    kept = {lang.lower(): engine.stemmer_for(lang) for lang in langs}
    assert all(st is kept[lang] for lang, st in got)
