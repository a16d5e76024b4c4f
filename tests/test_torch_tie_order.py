"""Score ties across the intersection kernel's phases, on the CPU.

A union's terms are intersected in phases, one per pivot term; each
phase's top-k lanes are doc-ascending within a score.  The port merges
the phases of both kernel routes ("kernel" and "kernel-wide") by score,
lowest doc on ties, as its window program, single `search` and the JAX
package's `search` order them.  The JAX package's kernel branch merges
in phase order (a doc of phase 0 before a lower doc of phase 1 at an
equal score): a divergence from a fault on the JAX side, pinned here.

The input: 800 documents, `a` = "alpha gamma delta" for odd i and "beta
gamma delta" for even i (weight 2), `b` = "eps zeta omega".  Every
document scores the same for `alpha | beta`; alpha's phase holds the
odd ones."""

import numpy as np
import pytest

import redisearch_tpu as rs
import redisearch_tpu_torch as rt
from redisearch_tpu.query import engine as JE
from redisearch_tpu_torch.query import engine as TE

N = 800
QUERY = "alpha | beta"


def _docs():
    return [(f"d{i}", {"a": "alpha gamma delta" if i % 2
                       else "beta gamma delta", "b": "eps zeta omega"})
            for i in range(N)]


def _index(pkg, **kw):
    ix = pkg.SearchIndex(pkg.Schema(name="c3", fields=[
        pkg.Field("a", pkg.FieldType.TEXT, weight=2.0),
        pkg.Field("b", pkg.FieldType.TEXT)]), **kw)
    ix.add_documents(_docs())
    ix.commit()
    return ix


@pytest.fixture(scope="module")
def pair():
    return _index(rs), _index(rt, device="cpu")


def _keys(res):
    return [h.key for h in res.hits]


@pytest.mark.parametrize("k", [1, 10, 25])
def test_narrow_route_serves_the_lowest_docs(pair, k):
    jix, tix = pair
    want = _keys(jix.search(QUERY, num=k))
    assert want == [f"d{i}" for i in range(k)]
    TE.QUERY_PATH_STATS.clear()
    (got,) = tix.search_many([QUERY], k=k)
    assert TE.QUERY_PATH_STATS == {"kernel": 1}
    assert got.total == N
    assert _keys(got) == want
    scores = [h.score for h in got.hits]
    assert len(set(scores)) == 1


def test_narrow_route_agrees_with_single_search(pair):
    """The port's `search` (window program) and its batch on the kernel
    serve the same order, for the tie and for queries around it."""
    _jix, tix = pair
    queries = [QUERY, "beta | alpha", "alpha | beta | gamma",
               "gamma | alpha", "alpha | eps"]
    TE.QUERY_PATH_STATS.clear()
    batch = tix.search_many(queries, k=10)
    assert TE.QUERY_PATH_STATS == {"kernel": len(queries)}
    for q, got in zip(queries, batch):
        one = tix.search(q, num=10)
        assert got.total == one.total, q
        assert _keys(got) == _keys(one), q
        np.testing.assert_allclose([h.score for h in got.hits],
                                   [h.score for h in one.hits], rtol=1e-6)


def test_jax_kernel_branch_keeps_its_phase_order(pair):
    """The pinned divergence: the JAX package's batch on its kernel
    branch serves alpha's phase (the odd docs) first."""
    jix, _tix = pair
    JE.QUERY_PATH_STATS.clear()
    (got,) = jix.search_many([QUERY], k=10)
    assert JE.QUERY_PATH_STATS.get("kernel") == 1
    assert _keys(got) == [f"d{i}" for i in range(1, 20, 2)]
