"""The harness is driven by data, and loads nothing it must not.

* A new configuration, traffic mix, metric and cell, added as new files
  and entries in a copy of the benchmark, run without an edit to any
  file that was there: a filtered-KNN cell, and a full-text cell.
* No module a run loads has the top-level name `jax`, `jaxlib`, `flax`
  or `redisearch_tpu` (names compared whole: the port's own name begins
  with the JAX package's), and none lives under `benchmarks/` or is
  `bench.py`.
* The plain reference and the yardstick modules import nothing of the
  program."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import textcell
from perfbench import harness as H

YARDSTICK = ("reference.py", "bm25.py", "compare.py", "corpus.py",
             "traffic.py")


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _vector_cell(pb):
    """A filtered-KNN configuration: TAG, NUMERIC and VECTOR fields."""
    cfg = json.loads((pb / "configs" / "arxiv-384-filtered-500k.json"
                      ).read_text())
    cfg.update(name="tiny-items", index="items", n_docs=500,
               key_format="i%d",
               fields=[{"name": "kind", "type": "TAG", "draw": "zipf",
                        "n_values": 5, "a": 0.5, "format": "k%d"},
                       {"name": "price", "type": "NUMERIC",
                        "draw": "uniform_int", "lo": 0, "hi": 100},
                       {"name": "vec", "type": "VECTOR", "dim": 16,
                        "metric": "COSINE", "draw": "unit_normal"}])
    mix = {"entry": "search", "batch": 8, "k": 5, "warmup_batches": 1,
           "check": 16,
           "families": [{"name": "and",
                         "query": "(@kind:{<k>} -@price:[<p>])=>[KNN 5 @vec $v]",
                         "vector": {"field": "vec", "param": "v"}}],
           "slots": {"p": {"draw": "int_range", "lo": 0, "hi": 99,
                           "min_width": 5, "max_width": 40},
                     "k": {"draw": "tag", "field": "kind"}}}
    limits = {"failed_requests": 0, "total_err": 0, "tie_order_err": 0,
              "rank_gap": 1e-5, "dist_err": 1e-5}
    return cfg, mix, limits, {}


def _text_cell(pb):
    """A full-text configuration (`textcell.py`): a title of weight 2, a
    body and a TAG field, under the port's eight bench families through
    term slots.  It runs with RS_TPU_NO_INTERSECT_KERNEL=1, which keeps
    FT.SEARCH batches off the narrow intersection-kernel route: that
    route's host merge breaks a union's score ties by phase, not by the
    lowest document (ROADMAP C3), on the CPU as on the card.  The change
    that repairs C3 takes the switch out."""
    limits = {"failed_requests": 0, "total_err": 0, "tie_order_err": 0,
              "rank_gap": 1e-5, "score_err": 1e-5}
    return (dict(textcell.CONFIG), dict(textcell.MIX), limits,
            {"RS_TPU_NO_INTERSECT_KERNEL": "1"})


@pytest.mark.parametrize("make", [_vector_cell, _text_cell],
                         ids=["vector", "text"])
def test_new_cell_from_new_files_only(tmp_path, make):
    shutil.copytree(H.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digest(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"
    cfg, mix, limits, env = make(pb)
    (pb / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (pb / "mixes" / "new-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(run.batches)\n")
    (pb / "limits" / "new-cell.json").write_text(json.dumps(
        {"limits": limits}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "a test",
                             "file": "perfbench/configs/new-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, torch; from perfbench import harness as H; "
            "print(json.dumps(H.run_cell(H.load_bench(), 'new-cell', 3, "
            "0.3, True, torch.device('cpu'), time.perf_counter())))")
    env = {**os.environ, **env,
           "PYTHONPATH": f"{tmp_path}{os.pathsep}{H.ROOT}"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(limits)
    assert out["metrics"]["batches_seen"]["value"] >= 1
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_loads_nothing_forbidden():
    code = r"""
import json, os, sys, time, torch
from perfbench import harness as H
H.run_cell(H.load_bench(), 'arxiv-fknn-dense', 11, 0.3, True,
           torch.device('cpu'), time.perf_counter(),
           scale={'n_docs': 500, 'batch': 8, 'check': 8})
from perfbench import control
files = [getattr(m, '__file__', None) or '' for m in list(sys.modules.values())]
print(json.dumps({"top": sorted({m.split('.')[0] for m in sys.modules}),
                  "files": files}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=H.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert not set(got["top"]) & set(H.FORBIDDEN), got["top"]
    assert "redisearch_tpu_torch" in got["top"]
    bad = [f for f in got["files"]
           if os.path.join(H.ROOT, "benchmarks") in f
           or f == os.path.join(H.ROOT, "bench.py")]
    assert not bad, bad


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(H.HERE, name)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("redisearch_tpu_torch",
                                           *H.FORBIDDEN), (name, m)


def test_reference_process_holds_no_program():
    code = ("import sys, perfbench.reference, perfbench.control; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('redisearch')))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=H.ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
