"""LVQ8 recall on bench.py's ANN corpus, both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_lvq_ann_recall.py

Builds chip_smoke.py's `ann_corpus` (bench.py's bench_ann: 1M x 100
clustered COSINE vectors, seed 7), trains 1,024 centroids with the
port's `train_kmeans`, lays out an LVQ8 host tier on them in both
packages, and prints each package's recall@10 at nprobe 8 for the first
256 queries against an exact float64 top-10 over the original vectors,
and the share of equal ids.  It shows what recall the compression itself
leaves on that corpus (the card's phase 8 reports the port's).  Takes
about a minute and 6 GB of host memory.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from redisearch_tpu.ops import ivf as JI  # noqa: E402
from redisearch_tpu_torch.ops import ivf as TI, lvq as TL  # noqa: E402


def main():
    vecs, Qs = cs.ann_corpus()
    q0 = Qs[0]
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q0 / np.linalg.norm(q0, axis=1, keepdims=True)
    sims = vn.astype(np.float64) @ qn.T.astype(np.float64)
    truth = [set(np.argpartition(-sims[:, i], 10)[:10].tolist())
             for i in range(len(q0))]
    del sims
    cents = TI.train_kmeans(vn, cs.ANN_NLIST, 10)
    del vn
    codes, off, scl = TL.lvq_encode(vecs)
    pres = np.ones(len(vecs), bool)

    def recall(ids):
        return np.mean([len(set(ids[i].tolist()) & truth[i]) / 10
                        for i in range(len(q0))])

    jl = JI.HostIVF.build_lvq(codes, off, scl, pres, "COSINE",
                              centroids=cents)
    _, ji = JI.host_ivf_knn(jl, q0, 10, 8)
    tl = TI.HostIVF.build_lvq(codes, off, scl, pres, "COSINE",
                              centroids=cents)
    _, ti = TI.host_ivf_knn(tl, q0, 10, 8)
    print(f"LVQ8 recall@10 at nprobe 8: JAX package {recall(ji):.4f}, "
          f"port {recall(ti):.4f}; equal ids {(ti == ji).mean():.4f}")


if __name__ == "__main__":
    main()
