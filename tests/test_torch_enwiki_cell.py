"""The benchmark's full-text configuration (`enwiki-abstract-400k`,
FTSB's enwiki-abstract shape) under its mix (`ftsb-eight-families`), at
small sizes on the CPU, through `perfbench.harness.run_cell`: the port's
normal path (no route switch) against the plain float64 BM25STD
reference (`perfbench/bm25.py`), every answer judged under the cell's
own limits.

At these sizes no posting list passes the narrow route's 32,768-lane
pivot bound, so the narrow intersection kernel and the phrase kernel
carry the batches.  Every word the configuration can draw is indexed
verbatim: neither nltk's Porter nor its Snowball stemmer nor the port's
no-nltk fallback changes it, so a host with nltk and one without index
the same terms."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness as H  # noqa: E402
from redisearch_tpu_torch.query import engine  # noqa: E402

CELL = "enwiki-search-mix"
SCALE = {"n_docs": 4000, "batch": 64, "check": 64, "warmup_batches": 1}


def _config() -> dict:
    return H.cell_files(H.load_bench(), CELL)[1]


@pytest.mark.parametrize("seed,traced", [(23, False),
                                         (4230000000017, True)])
def test_cell_is_correct_on_the_kernel_routes(monkeypatch, seed, traced):
    monkeypatch.delenv("RS_TPU_NO_INTERSECT_KERNEL", raising=False)
    engine.QUERY_PATH_STATS.clear()
    out = H.run_cell(H.load_bench(), CELL, seed, 1.0, traced,
                     torch.device("cpu"), time.perf_counter(), scale=SCALE)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= SCALE["batch"]
    assert set(out["checks"]) == {"failed_requests", "total_err",
                                  "tie_order_err", "rank_gap", "score_err"}
    paths = {p: n for p, n in engine.QUERY_PATH_STATS.items() if n}
    assert paths.get("kernel", 0) > 0 and paths.get("phrase-kernel", 0) > 0
    assert paths.get("kernel-wide", 0) == 0, paths
    if traced:
        # the counts read as the route share; the roofline needs a card
        share = out["metrics"]["kernel_route_pct"]["value"]
        assert 90.0 <= share <= 100.0
        assert "bm25_roofline" not in out["metrics"]


def test_configuration_keeps_the_ftsb_shape():
    cfg = _config()
    f = {x["name"]: x for x in cfg["fields"]}
    assert cfg["n_docs"] == 400_000 and cfg["reduced"] == ["n_docs"]
    assert (f["title"]["tokens"], f["body"]["tokens"]) == (4, 20)
    assert f["title"]["weight"] == 2 and "weight" not in f["body"]
    for nm in ("title", "body"):
        assert (f[nm]["vocab"], f[nm]["a"], f[nm]["format"]) == (
            200_000, 1.25, "w%06d")
        assert not f[nm].get("nostem", False)
    assert (f["cat"]["n_values"], f["cat"]["a"]) == (16, 0.0)


def _nltk_porter():
    from nltk.stem.porter import PorterStemmer
    return PorterStemmer().stem


def _nltk_snowball():
    from nltk.stem.snowball import SnowballStemmer
    return SnowballStemmer("english").stem


def _fallback():
    from redisearch_tpu_torch.analysis.porter import porter_stem
    return porter_stem


def _port_stemmer():
    from redisearch_tpu_torch.analysis.stemmer import Stemmer
    st = Stemmer("english")
    return lambda w: st.stem(w) or w


@pytest.mark.parametrize("make", [_nltk_porter, _nltk_snowball, _fallback,
                                  _port_stemmer],
                         ids=["nltk-porter", "nltk-snowball", "fallback",
                              "port"])
def test_drawn_words_stem_to_themselves(make):
    cfg = _config()
    stem = make()
    for f in cfg["fields"]:
        if f["type"] != "TEXT":
            continue
        words = [f["format"] % i for i in range(f["vocab"])]
        assert [w for w in words if stem(w) != w] == []
