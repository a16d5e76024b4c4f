"""The comparison fails what it must fail: the control (the reference in
bfloat16 in the program's place) and the program with its timed path
broken underneath.  The harness's look for a card is skipped (CPU,
tiny sizes); the rest of a run is the run's own."""

import numpy as np
import pytest

import tiny
from perfbench import control as C
from perfbench import harness as H


def _limits(name):
    return H.cell_files(tiny.bench(), name)[3]["limits"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails(name):
    import torch
    scale = {**tiny.SCALE, "check": 64}
    out = C.control_numbers(tiny.bench(), name, 77, torch.device("cpu"),
                            scale=scale)
    lim = _limits(name)
    assert all(v == 0 for v in out["reference"].values()), out
    assert any(out["control"][k] > lim[k] for k in out["control"]), out


def _patch(monkeypatch, fn):
    """Break every batch's results where the program produces them."""
    from redisearch_tpu_torch.index import index as IX
    orig = IX.execute_batch

    def broken(cqs, seg, k, *a, **kw):
        res = orig(cqs, seg, k, *a, **kw)
        return fn(res)
    monkeypatch.setattr(IX, "execute_batch", broken)


def _half_left_out(res):
    for r in res[len(res) // 2:]:
        r.count = 0
        r.scores = np.full_like(r.scores, -3.4e38)
        if r.knn_dists is not None:
            r.knn_dists = np.full_like(r.knn_dists, 3.4e38)
    return res


def _answer_altered(res):
    for r in res:
        r.scores = r.scores * np.float32(1.01)
        if r.knn_dists is not None:
            r.knn_dists = r.knn_dists + np.float32(1e-3)
    return res


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    _patch(monkeypatch, fault)
    scale = {**tiny.SCALE, "check": 64}
    out = tiny.run(name, scale=scale)
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_on_the_card(card, name):
    """The control on the card, at a size a test run holds (the cell's own
    size: `python3 -m perfbench.control`)."""
    out = C.control_numbers(H.load_bench(), name, 4600000001, card,
                            scale={"n_docs": 100_000, "check": 64})
    lim = _limits(name)
    assert all(v == 0 for v in out["reference"].values()), out
    assert any(out["control"][k] > lim[k] for k in out["control"]), out
