"""FT.SEARCH batches through the program's front door,
`Client.ft_search_many`: parsing, planning, the executors and kernels,
and the merge of hits with their documents."""

from __future__ import annotations

from .. import compare
from ..reference import parse


def submit(run, batch) -> list:
    return run.client.ft_search_many(run.index_name, batch.queries,
                                     params=batch.params, k=run.mix["k"])


def answer(res, item: dict) -> tuple:
    """What is judged of one result: total and (key, value) of each hit,
    the value a KNN query's distance or any other query's score."""
    if parse(item["query"])[1] is not None:
        return (res.total, [(h.key, h.vector_distance) for h in res.hits])
    return (res.total, [(h.key, h.score) for h in res.hits])


def expected(ref, item: dict, mix: dict) -> tuple:
    """The reference's answer in `answer`'s form (for the control: the
    reference in its lower precision, put in the program's place)."""
    exp = ref.search(item["query"], item["params"], mix["k"])
    value = compare.lookup(exp["rows"], exp["values"])
    return (exp["total"], [(ref.ds.keys[r], value(r))
                           for r in exp["ranked"].tolist()])


def judge(ref, item: dict, ans: tuple, mix: dict) -> dict:
    exp = ref.search(item["query"], item["params"], mix["k"])
    total, hits = ans
    out = compare.ranked(ref, compare.lookup(exp["rows"], exp["values"]),
                         exp["ranked"].tolist(), hits, exp["better"])
    out["total_err"] = int(total != exp["total"])
    return out
