"""Every cell end to end at tiny sizes on the CPU: the result line has
the contract's shape, and the plain reference agrees with the program."""

import json
import subprocess
import sys

import pytest

import tiny
from perfbench import harness as H

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_agrees(name, traced):
    out = tiny.run(name, traced=traced)
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in H.cell_metrics(tiny.bench(), name, traced)}
    got = set(out["metrics"])
    if traced:
        # the device metrics read nothing without a card
        assert got == want - {"knn_roofline", "device_idle_pct"}
        assert "breakdown" in out and "busy_s" in out["device"]
    else:
        assert got == want
        assert all(m["value"] > 0 for m in out["metrics"].values())
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_main_needs_a_card(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "arxiv-fknn-dense", "--seed", "5000000000",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=H.ROOT,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run fails without a result."""
    import shutil
    shutil.copytree(H.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(f"{H.ROOT}/BENCHMARK.json", tmp_path)
    code = ("import sys, time, torch; from perfbench import harness as H; "
            "H.run_cell(H.load_bench(), 'arxiv-fknn-dense', 1, 0.5, False, "
            "torch.device('cpu'), time.perf_counter(), "
            "scale={'n_docs': 100, 'batch': 4, 'check': 4})")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "redisearch_tpu_torch" in p.stderr
