"""The arxiv cell draws, sends and judges what it did before the harness
learned text: at the tiny scale of `tiny.py`, its drawn arrays, its
first three batches' queries and params, and the judged numbers (query
by query) of a sample of those batches as the program serves them on
the CPU, each a SHA-256 recorded from the harness of commit d300b9d."""

import hashlib
import json

import numpy as np
import pytest
import torch

import tiny
from perfbench import compare, corpus, harness as H
from perfbench.reference import Reference
from perfbench.traffic import Traffic

CELL = "arxiv-fknn-dense"
#: seed -> (arrays, batches, judged numbers), recorded at d300b9d
RECORDED = {
    20261018: ("48190da806607e0aa71e4eb269244f9111ec0735e1d0fd758d7dc4b1a5bf4891",
                "06e69e681c0d584fa4c484dfb2f27d6099d853964ead964107b8c942d62322d0",
                "a86c847a0f30f1bc1bdb6b64ea588b481f54462372944e09acf3a715ad6667a6"),
    3000000017: ("70de6ffd912281ab9442798290f1167d763c5ef2b7690c0e98285b8755f4712b",
                "5625daad3a0d6a7d90cec2aead8f029374c4cb3abd099d022fb2e9f974174645",
                "92464c219e5cac6e1672d462991c6b40f2ac5097ab1c234e7639d1549a25365d"),
}


def _scaled():
    cell, cfg, mix, limits = H.cell_files(H.load_bench(), CELL)
    cfg = {**cfg, **{k: v for k, v in tiny.SCALE.items() if k in cfg}}
    mix = {**mix, **{k: v for k, v in tiny.SCALE.items() if k in mix}}
    return cell, cfg, mix, limits


def _arrays(ds) -> str:
    h = hashlib.sha256()
    for kind in ("tags", "numeric", "vectors"):
        for name in sorted(getattr(ds, kind)):
            a = getattr(ds, kind)[name]
            a = a.cpu().numpy() if torch.is_tensor(a) else a
            h.update(f"{kind}:{name}:{a.dtype}:{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps(ds.keys).encode())
    return h.hexdigest()


def _batches(traffic) -> str:
    h = hashlib.sha256()
    for b in range(3):
        batch = traffic.batch(b)
        h.update(json.dumps([batch.families, batch.queries]).encode())
        for p in batch.params or []:
            for k in sorted(p or {}):
                h.update(k.encode())
                h.update(np.asarray(p[k]).tobytes())
    return h.hexdigest()


def _judged(monkeypatch, seed) -> str:
    """The sample's numbers, query by query: the program serves the
    first three batches (one thread, so its float sums repeat), the
    sample keeps its share, the reference judges it."""
    cell, cfg, mix, limits = _scaled()
    run = H.Run(cell=cell, cfg=cfg, mix=mix, ds=None,
                dev=torch.device("cpu"), seconds=0.0, traced=False)
    H.setup(run, seed)
    entry = H.load_module("entries", mix["entry"])
    traffic = Traffic(mix, run.ds, seed)
    sample = H.Sample(mix["check"], seed)
    for b in range(3):
        batch = traffic.batch(b)
        sample.offer(batch, entry.submit(run, batch), entry)
    run.ref = Reference(run.ds)
    seen = []
    combine = compare.combine

    def keep(per_query):
        seen.append(per_query)
        return combine(per_query)
    monkeypatch.setattr(compare, "combine", keep)
    H.judge(run, entry, sample, limits["limits"])
    return hashlib.sha256(json.dumps(seen[-1], sort_keys=True).encode()
                          ).hexdigest()


@pytest.mark.parametrize("seed", sorted(RECORDED))
def test_arxiv_cell_reads_the_same(monkeypatch, seed):
    _, cfg, mix, _ = _scaled()
    ds = corpus.draw(cfg, seed, torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = (_arrays(ds), _batches(Traffic(mix, ds, seed)),
               _judged(monkeypatch, seed))
    finally:
        torch.set_num_threads(threads)
    assert got == RECORDED[seed]
