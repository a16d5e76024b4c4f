"""The port's bench runner (`redisearch_tpu_torch/bench/run.py`) on the
CPU: its scoreboard against bench.py's `_assemble`, each of its four
sections at shapes below BENCH_SMOKE's through the command line's path
(`main` with `--device cpu`), and its refusals: no card without
`--device cpu`, a section that raises exits 1 after the scoreboard, a
number whose parity check fails is not printed.  Nothing here is a
device number: the CPU runs the kernels' plain versions."""

import importlib.util
import json
import os

import pytest
import torch

from redisearch_tpu_torch.bench import run as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: below BENCH_SMOKE's shapes: 2,000 docs, batches of 16-64
TINY = R.Shapes(n_docs=2000, text_batch=64, text_iters=2,
                agg_batches=(32, 16), star_batch=4, fknn_n=2000,
                fknn_batches=(32, 64), fknn_iters=2, hybrid_batch=16,
                hybrid_iters=2, knn_n=5000, knn_batch=32, knn_iters=2,
                ann_n=4000, ann_nlist=32, ann_queries=32)


def _bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_ref", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SWEEP = [{"op": "flat", "recall": 1.0, "qps": 31000.5},
         {"op": "ivf8", "recall": 0.91, "qps": 9000.0}]
PROGRESS = [
    ({"bm25__and2": 51234.5, "bm25__phrase": 20480.25,
      "bm25__and2_tag": 40000.0, "bm25__and3": 30000.0,
      "bm25__or2": 12345.6, "bm25__not2": 45000.0, "bm25__opt2": 41000.0,
      "bm25__fields2": 39000.0, "bm25_build_docs_per_s": 24000.0,
      "kernel_hit_pct": 100.0, "agg_groupby_qps": 18500.3,
      "agg_star_qps": 1070.9, "flat_knn_qps": 37928.0,
      "flat_knn_recall": 0.9996, "fknn__fulltext": 410.2,
      "fknn__numeric": 5200.0, "fknn__tag": 5908.6,
      "ann_qps_at_r95": 31000.5, "ann_sweep": SWEEP,
      "hybrid__rrf": 1100.0, "hybrid__linear": 900.0},
     {"text": 0, "fknn": 0, "knn": 0, "ann": 0}),
    ({"bm25__phrase": 20480.25, "bm25__and2_error": "RuntimeError('x')",
      "bm25__or2_error": "boom", "agg_error": "agg failed",
      "agg_star_error": "star failed", "knn_error": "oom",
      "ann_ivf_error": "bad", "fknn__tag": 10.0,
      "text_error": "AssertionError('parity')"},
     {"text": 1, "fknn": 0, "knn": 1}),
    ({}, {"backend": "unavailable"}),
]


@pytest.mark.parametrize("p,rc", PROGRESS, ids=["full", "errors", "empty"])
def test_assemble_matches_bench_py(p, rc, capsys):
    """bench.py's `_assemble` and the port's `assemble`, fed the same
    progress, give the same scoreboard key for key; the port adds only
    its `added` entries under `extra`."""
    _bench_py()._assemble(dict(p), dict(rc))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    added = {"device": {"platform": "cpu"}, "spread": {}, "parity": {}}
    got = json.loads(json.dumps(R.assemble(dict(p), dict(rc), added)))
    assert {k: v for k, v in got["extra"].items() if k not in added} \
        == want["extra"]
    assert {k: got["extra"][k] for k in added} == added
    assert {k: v for k, v in got.items() if k != "extra"} == \
        {k: v for k, v in want.items() if k != "extra"}


def _main(monkeypatch, capsys, argv):
    """The command line at TINY shapes on the CPU (BENCH_SMOKE's path,
    its shapes replaced): (exit code, the last stdout line parsed)."""
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setattr(R, "SMOKE", TINY)
    rc = R.main(["--device", "cpu", "--reps", "2"] + argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


SECTION_KEYS = {
    "text": (["bm25__" + f for f in ("and2", "phrase", "and2_tag", "and3",
                                     "or2", "not2", "opt2", "fields2")]
             + ["agg_groupby_qps", "agg_groupby_qps_b16", "agg_star_qps"],
             ["bm25_phrase_qps", "bm25_and2_tag_qps", "bm25_mix_qps",
              "bm25_build_docs_per_s", "kernel_hit_pct", "agg_groupby_qps",
              "agg_vs_baseline", "agg_star_qps", "agg_star_vs_baseline",
              "agg_groupby_qps_b16", "agg_batch"]),
    "fknn": (["fknn__" + f + s for f in ("fulltext", "numeric", "tag")
              for s in ("", "_b64")] + ["hybrid__rrf", "hybrid__linear"],
             ["filtered_knn_qps", "filtered_knn_vs_baseline",
              "filtered_knn_qps_b64", "hybrid_qps", "hybrid_vs_baseline"]),
    "knn": (["flat_knn_qps"], ["flat_knn_qps", "flat_knn_vs_baseline",
                               "flat_knn_recall"]),
    "ann": (["ann_sweep", "ann_qps_at_r95"], ["ann_qps_at_r95",
                                              "ann_sweep"]),
}


@pytest.mark.parametrize("section", R.SECTIONS)
def test_section_on_the_cpu(section, monkeypatch, capsys):
    """Each section through `main --device cpu --section S` at TINY
    shapes: exit 0, the last stdout line parses, every number of the
    section is there with its spread (2 measurements) and a parity check
    that passed."""
    rc, board = _main(monkeypatch, capsys, ["--section", section])
    assert rc == 0, board
    ex = board["extra"]
    checked, keys = SECTION_KEYS[section]
    assert set(keys) <= set(ex), sorted(ex)
    assert set(checked) <= set(ex["parity"]), sorted(ex["parity"])
    assert ex["device"] == {"platform": "cpu"}
    assert ex["section_s"].keys() == {section}
    assert "section_rc" not in ex and not any(k.endswith("_error")
                                              for k in ex)
    for key in checked:
        if key != "ann_sweep":
            assert ex["spread"][key]["n"] == 2, key
            assert ex["spread"][key]["min"] <= ex["spread"][key]["median"] \
                <= ex["spread"][key]["max"], key
    if section == "text":
        assert board["value"] == ex["spread"]["bm25__and2"]["median"] > 0
        assert ex["kernel_hit_pct"] == 100.0
        assert ex["agg_batch"] == 32
        assert ex["batch"]["agg_groupby_qps_b16"] == 16
    if section == "knn":
        p = ex["parity"]["flat_knn_qps"]
        assert p["recall_at_10"] >= 0.99 and p["max_rel_dist_err"] <= 1e-5
    if section == "ann":
        assert [pt["op"] for pt in ex["ann_sweep"]] == [
            "flat", "ivf8", "ivf32", "ivf128"]
        assert ex["parity"]["ann_sweep"]["recall_at_10"]["ivf128"] >= 0.95


def test_no_card_raises(monkeypatch):
    """Without `--device cpu` the runner wants the card: where there is
    none it raises, before any section runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(R, "SECTION_FNS", {
        s: lambda *a, s=s: ran.append(s) for s in R.SECTIONS})
    with pytest.raises(RuntimeError, match="CUDA"):
        R.main(["--section", "knn"])
    assert ran == []


def test_a_failing_section_exits_1_after_the_scoreboard(monkeypatch,
                                                         capsys):
    """A section that raises is recorded (`<section>_error`, `section_rc`)
    and the others still run; the scoreboard is printed and the run
    exits 1."""
    def boom(*a):
        raise ValueError("section failed")
    monkeypatch.setitem(R.SECTION_FNS, "ann", boom)
    rc, board = _main(monkeypatch, capsys,
                      ["--section", "ann", "--section", "knn"])
    assert rc == 1
    ex = board["extra"]
    assert ex["section_rc"] == {"ann": 1}
    assert "section failed" in ex["ann_error"]
    assert "flat_knn_qps" in ex and "ann_sweep" not in ex


def test_a_failed_parity_check_prints_no_number(monkeypatch, capsys):
    """A number whose parity check fails is not recorded: the FLAT gate
    at a distance tolerance of 0 fails the knn section."""
    monkeypatch.setattr(R, "DIST_RTOL", 0.0)
    rc, board = _main(monkeypatch, capsys, ["--section", "knn"])
    assert rc == 1
    ex = board["extra"]
    assert "flat_knn_qps" not in ex and "flat_knn_qps" not in ex["spread"]
    assert "relative distance error" in ex["knn_error"]
