"""The torch port runs where jax is absent, and never loads it.

A subprocess imports `redisearch_tpu_torch`, builds a 600-doc index on
the CPU (the smallest corpus whose posting windows reach the kernel's
1024 bucket) and serves a `search_many` batch, then reports which
modules it loaded.  Two environments: jax, jaxlib and ml_dtypes blocked
on `sys.meta_path` (the card's machine may have none of them), and jax
importable (the port must still not load it).  Neither may load `jax`
or any `redisearch_tpu.*` module.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc, json, sys

if BLOCK:
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"):
                raise ImportError(f"{name} blocked")
            return None
    sys.meta_path.insert(0, Block())

import redisearch_tpu_torch as rt

client = rt.Client(device="cpu")
ix = client.ft_create("idx", [rt.Field("t", rt.FieldType.TEXT),
                              rt.Field("c", rt.FieldType.TAG)])
ix.add_documents([(f"d{i}", {"t": "alpha beta" if i % 2 else "alpha gamma",
                             "c": "x" if i % 3 else "y"})
                  for i in range(600)])
res = client.ft_search_many("idx", ["alpha beta", "alpha @c:{y}",
                                    "beta|gamma", "gamma -beta"], k=5)
print(json.dumps({
    "totals": [r.total for r in res],
    "keys": [[h.key for h in r.hits] for r in res],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                            "redisearch_tpu")),
}))
"""


@pytest.mark.parametrize("block", [True, False],
                         ids=["jax-blocked", "jax-installed"])
def test_port_serves_without_jax(block):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", f"BLOCK = {block}\n" + SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    assert out["totals"] == [300, 200, 600, 300]
    assert out["keys"][0] == ["d1", "d3", "d5", "d7", "d9"]
    assert out["keys"][1] == ["d0", "d3", "d6", "d9", "d12"]
    assert out["keys"][3] == ["d0", "d2", "d4", "d6", "d8"]
