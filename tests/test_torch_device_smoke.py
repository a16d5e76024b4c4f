"""`redisearch_tpu_torch/bench/device_smoke.py` (the port of
benchmarks/tpu_smoke.py) on the CPU: its digest of the script's query
mix against the script's own digest taken by the JAX package on the CPU
(`JAX_PLATFORMS=cpu python benchmarks/tpu_smoke.py cpu`, in a
subprocess): the same names, totals, keys and hit order, scores and
aggregate values within 1e-4 (the digest's 4-digit rounding).  Then the
comparison `--compare` makes between the card's digest and the CPU's:
it finds each kind of difference, and it refuses to run without a
card."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from redisearch_tpu_torch.bench import device_smoke as DS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_digest():
    return DS.digest("cpu")


def test_digest_equals_tpu_smoke_on_the_cpu(port_digest, capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join("benchmarks", "tpu_smoke.py"), "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout)
    assert set(port_digest) == set(ref) and len(ref) == 15
    for name, want in ref.items():
        got = port_digest[name]
        if name == "agg":
            assert [sorted(r) for r in got] == [sorted(r) for r in want]
            for g, w in zip(got, want):
                assert g["tag"] == w["tag"]
                assert g["n"] == pytest.approx(w["n"], abs=DS.TOL)
                assert g["avg"] == pytest.approx(w["avg"], abs=DS.TOL)
            continue
        assert got["total"] == want["total"], name
        assert [h[0] for h in got["hits"]] == [h[0] for h in want["hits"]]
        for (_k, a), (_k2, b) in zip(got["hits"], want["hits"]):
            assert a == pytest.approx(b, abs=DS.TOL), name
    assert DS.compare(port_digest, ref)[1] == []
    # the command line prints the same digest as its last line
    out = DS.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out)) and out["digest"] == port_digest


def _edits():
    def score(d):
        d["and2"]["hits"][0][1] += 2e-4

    def order(d):
        h = d["or2"]["hits"]
        h[0], h[1] = h[1], h[0]

    def total(d):
        d["knn"]["total"] += 1

    def agg(d):
        d["agg"][1]["avg"] += 1e-3

    def tag(d):
        d["agg"][0]["tag"] = "x"

    def name(d):
        del d["geo"]
    return [score, order, total, agg, tag, name]


@pytest.mark.parametrize("edit", _edits(),
                         ids=["score", "order", "total", "agg", "tag",
                              "name"])
def test_compare_finds_each_difference(port_digest, edit):
    other = copy.deepcopy(port_digest)
    n, diffs = DS.compare(port_digest, other)
    assert diffs == [] and n > 150
    edit(other)
    assert len(DS.compare(port_digest, other)[1]) == 1


def test_compare_runs_only_on_the_card(monkeypatch, capsys):
    with pytest.raises(SystemExit, match="card"):
        DS.main(["--compare", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DS.main(["--compare"])
    assert capsys.readouterr().out == ""
