"""The benchmark of `redisearch_tpu_torch` on NVIDIA H100 cards.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON result line
(see `run.py`).  It imports nothing of the JAX package.
"""
